"""The plain reference of the water configurations: multipolar PME (lmax <= 2)
with optional Thole polarization, Tang-Toennies and the water bonded terms,
in any float dtype (float64 for the check,
float32 with TF32 for its control).

It takes only the inputs the benchmark makes (positions, box, the per-atom
parameters and the molecule layout of ``benchmark/systems/water.py``) and
works out again what the program derives from them: the pair list (brute
force, at the list cutoff), the topological scales, the local frames, the
Ewald parameters and influence grid, the local multipoles and, for the
polarizable model, induced dipoles converged by its own PCG. The pair terms
are summed over blocks of pairs, each differentiated on its own, so that the
largest box fits beside nothing else on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .bonded import harmonic_angle_energy, harmonic_bond_energy
from .constants import ANGSTROM_TO_BOHR, DIELECTRIC, HARTREE_TO_KJMOL
from .ewald import setup_ewald_parameters, setup_ewald_parameters_fft
from .frames import local_frames_components
from .harmonics import (
    cart_dipole_to_harm,
    convert_cart2harm,
    rot_local2global_components,
)
from .influence import ck_1
from .realspace import (
    induced_coefficients,
    min_image_components,
    pair_damping_width,
    pair_energy_induced,
    pair_energy_perm,
    perm_coefficients,
    qi_pair_components,
)
from .recip import influence_weights, recip_energy
from .selfenergy import pme_self_energy, polarization_penalty

PAIR_BLOCK = 1 << 20      # pairs per differentiated block
SEARCH_ELEMENTS = 1 << 25  # (rows x atoms) per block of the pair search
# a[A/ps^2] = F[kJ/mol/A] / m[g/mol] * ACC; Boltzmann's constant in kJ/mol/K
ACC = 100.0
K_B = 0.00831446261815324


def tt_pair_energy(r, mscale, a_i, a_j, b_i, b_j, q_i, q_j, c_i, c_j):
    """Tang-Toennies damped Born-Mayer + charge-charge + C6 pair energy
    (a in Hartree, b in 1/Bohr, r in Angstrom, kJ/mol)."""
    a = torch.sqrt(a_i * a_j)
    b = torch.sqrt(b_i * b_j)
    br = b * (r * ANGSTROM_TO_BOHR)
    exp_br = torch.exp(-br)
    poly = sum(br ** k / math.factorial(k) for k in range(7))
    e = (HARTREE_TO_KJMOL * a * exp_br
         - HARTREE_TO_KJMOL * exp_br * (1.0 + br) * q_i * q_j / br
         + exp_br * poly * c_i * c_j / r ** 6)
    return e * mscale


class WaterReference:
    """Energies, forces and converged dipoles of one water configuration.

    ``system``: the numpy arrays of ``benchmark/systems/water.py``;
    ``model``: the configuration file's ``model`` object."""

    def __init__(self, system, model, device, dtype=torch.float64):
        self.model = model
        self.device = torch.device(device)
        self.dtype = dtype
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,  # noqa: E731
                                      device=self.device)
        self.box = t(system["box"])
        self.n = system["positions"].shape[0]
        self.lmax = int(model["lmax"])
        self.pol_model = bool(model["polarizable"])
        self.q_cart = t(system["q_cart"])
        self.axis_types = torch.as_tensor(system["axis_types"],
                                          device=self.device).long()
        self.axis_indices = torch.as_tensor(system["axis_indices"],
                                            device=self.device).long()
        self.pol = t(system["pol"])
        self.tholes = t(system["tholes"])
        self.m_scales = t(model["m_scales"])
        self.p_scales = t(model["p_scales"]) if self.pol_model else None
        self.tt = [t(system[k]) for k in ("tt_a", "tt_b", "tt_q", "tt_c6")]
        self.bonded = [torch.as_tensor(system["bond_idx"], device=self.device),
                       t(system["bond_r0"]), t(system["bond_k"]),
                       torch.as_tensor(system["angle_idx"], device=self.device),
                       t(system["angle_theta0"]), t(system["angle_k"])]
        self.molecule = torch.as_tensor(system["molecule"], device=self.device)
        self.is_heavy = torch.as_tensor(system["is_heavy"], device=self.device)
        box_np = np.asarray(system["box"], dtype=np.float64)
        setup = (setup_ewald_parameters_fft if model["mesh"] == "fft_friendly"
                 else setup_ewald_parameters)
        self.kappa, k1, k2, k3 = setup(model["rc_A"], model["ethresh"], box_np)
        self.grid = ((k1, k2, k3) if model["mesh"] == "fft_friendly"
                     else tuple(int(k) for k in model["mesh"]))
        self.weight = influence_weights(self.box, self.grid, self.kappa, ck_1)
        self.q_local = convert_cart2harm(self.q_cart, self.lmax)

    # ------------------------------------------------------------------
    def pair_list(self, positions, cutoff):
        """(i, j) of every pair i < j closer than ``cutoff`` (minimum image),
        by a blocked brute-force search."""
        pos = positions.to(self.dtype)
        rows = max(1, SEARCH_ELEMENTS // self.n)
        cut2 = cutoff * cutoff
        out_i, out_j = [], []
        col = torch.arange(self.n, device=self.device)
        for a in range(0, self.n, rows):
            p_i = pos[a:a + rows]
            b = p_i.shape[0]
            dx, dy, dz = min_image_components(
                p_i[:, None, :].expand(b, self.n, 3).reshape(-1, 3),
                pos[None].expand(b, self.n, 3).reshape(-1, 3), self.box)
            r2 = (dx * dx + dy * dy + dz * dz).reshape(b, self.n)
            row = torch.arange(a, a + b, device=self.device)
            hit = (r2 < cut2) & (col[None, :] > row[:, None])
            ii, jj = hit.nonzero(as_tuple=True)
            out_i.append(ii + a)
            out_j.append(jj)
        return torch.cat(out_i), torch.cat(out_j)

    def _topology_scale(self, scales, i, j):
        """scales[d - 1] for the topological distance d within a water (O-H
        1, H-H 2), the last entry for atoms of different molecules."""
        same = self.molecule[i] == self.molecule[j]
        dist = torch.where(self.is_heavy[i] | self.is_heavy[j], 1, 2)
        last = scales.shape[0] - 1
        idx = torch.where(same, dist - 1, torch.full_like(dist, last))
        return scales[idx]

    # ------------------------------------------------------------------
    def _pair_block(self, pos, qg, uh, i, j):
        """Real-space (+ Tang-Toennies) energy of the pairs (i, j)."""
        mask = torch.ones_like(i, dtype=torch.bool)
        mscale = self._topology_scale(self.m_scales, i, j)
        r, qi_i, qi_j, ui, uj = qi_pair_components(pos, self.box, qg, i, j,
                                                   mask, self.lmax, uh)
        coef = perm_coefficients(r, mscale, self.kappa, self.lmax)
        e = pair_energy_perm(qi_i, qi_j, coef, self.lmax)
        if self.pol_model:
            pscale = self._topology_scale(self.p_scales, i, j)
            dmp = pair_damping_width(self.pol[i], self.pol[j])
            icoef = induced_coefficients(r, self.tholes[i], self.tholes[j],
                                         dmp, pscale, self.kappa, self.lmax)
            e = e + pair_energy_induced(qi_i, qi_j, ui, uj, icoef, self.lmax)
        a, b, q, c = self.tt
        e = e + tt_pair_energy(r, mscale, a[i], a[j], b[i], b[j], q[i], q[j],
                               c[i], c[j])
        return e.sum()

    def energy_grads(self, positions, pairs, u=None, need_pos=True):
        """(energy, dE/dpositions or None, dE/du or None) at induced dipoles
        ``u`` (Cartesian, (N, 3)) over the pair list ``pairs``."""
        pos = positions.detach().to(self.dtype).requires_grad_(need_pos)
        u_leaf = (None if u is None
                  else u.detach().to(self.dtype).requires_grad_(True))
        with torch.enable_grad():
            ql = self.q_local
            frames = local_frames_components(pos, self.box, self.axis_types,
                                             self.axis_indices)
            qg = rot_local2global_components(ql, frames, self.lmax)
            uh = None if u_leaf is None else cart_dipole_to_harm(u_leaf)
            # the pair sum, block by block, on leaves of its own
            leaves = [pos.detach().requires_grad_(True),
                      qg.detach().requires_grad_(True)]
            if uh is not None:
                leaves.append(uh.detach().requires_grad_(True))
            e_pairs = torch.zeros((), dtype=self.dtype, device=self.device)
            g_pairs = [torch.zeros_like(x) for x in leaves]
            i_all, j_all = pairs
            for k in range(0, i_all.shape[0], PAIR_BLOCK):
                e_b = self._pair_block(*leaves[:2],
                                       leaves[2] if uh is not None else None,
                                       i_all[k:k + PAIR_BLOCK],
                                       j_all[k:k + PAIR_BLOCK])
                for g, d in zip(g_pairs, torch.autograd.grad(e_b, leaves)):
                    g.add_(d)
                e_pairs = e_pairs + e_b.detach()
            q_tot = qg
            if uh is not None:
                q_tot = torch.cat([qg[:, :1], qg[:, 1:4] + uh, qg[:, 4:]],
                                  dim=1)
            e_rest = recip_energy(pos, self.box, q_tot, self.grid, self.kappa,
                                  self.lmax, self.weight)
            e_rest = e_rest + pme_self_energy(q_tot, self.kappa, self.lmax)
            if u_leaf is not None:
                e_rest = e_rest + polarization_penalty(u_leaf, self.pol)
            bi, r0, kb, ai, th0, ka = self.bonded
            e_rest = (e_rest + harmonic_bond_energy(pos, self.box, bi, r0, kb)
                      + harmonic_angle_energy(pos, self.box, ai, th0, ka))
            surrogate = (e_rest + (qg * g_pairs[1]).sum()
                         + (pos * g_pairs[0]).sum())
            if uh is not None:
                surrogate = surrogate + (uh * g_pairs[2]).sum()
            wrt = ([pos] if need_pos else []) + ([u_leaf] if u_leaf is not None
                                                 else [])
            grads = list(torch.autograd.grad(surrogate, wrt))
        g_pos = grads.pop(0) if need_pos else None
        g_u = grads.pop(0) if u_leaf is not None else None
        return e_rest.detach() + e_pairs, g_pos, g_u

    def solve_dipoles(self, positions, pairs, max_iter=200):
        """Induced dipoles at the energy's minimum in u, by PCG on the exact
        operator (A v = field(v) - field(0)) from zero, to a field residual
        of 1e-7 (float64; 1e-5 otherwise) times the starting one, or until
        it stops falling."""
        tol = 1e-7 if self.dtype == torch.float64 else 1e-5
        b = self.energy_grads(positions, pairs,
                              torch.zeros((self.n, 3), dtype=self.dtype,
                                          device=self.device),
                              need_pos=False)[2]
        diag = (torch.clamp(self.pol, min=1e-8) / DIELECTRIC)[:, None]
        x = torch.zeros_like(b)
        r = -b
        z = r * diag
        p = z
        rz = torch.sum(r * z)
        r_first = float(torch.max(torch.abs(r)))
        best = r_first
        for _ in range(max_iter):
            ap = self.energy_grads(positions, pairs, p, need_pos=False)[2] - b
            alpha = rz / torch.sum(p * ap)
            x = x + alpha * p
            r = r - alpha * ap
            resid = float(torch.max(torch.abs(r)))
            if resid <= tol * r_first or resid > 10.0 * best:
                break
            best = min(best, resid)
            z = r * diag
            rz_new = torch.sum(r * z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        return x

    def evaluate(self, positions, cutoff):
        """(energy, forces, dipoles or None) at ``positions``, the pair list
        found at ``cutoff``."""
        pairs = self.pair_list(positions, cutoff)
        u = self.solve_dipoles(positions, pairs) if self.pol_model else None
        e, g, _ = self.energy_grads(positions, pairs, u)
        return e, -g, u


def langevin_step(ref, x, v, f, noise, masses, dt, temperature, friction,
                  cutoff):
    """One BAOAB step from the state (x, v, f) with the given noise draw:
    (x', v', f', dipoles at x')."""
    dt_ = ref.dtype
    x, v, f, noise, m = (t.detach().to(dt_) for t in (x, v, f, noise, masses))
    m = m[:, None]
    c1 = math.exp(-friction * dt)
    sigma = torch.sqrt(K_B * temperature * (1.0 - c1 ** 2) / m * ACC)
    v = v + 0.5 * dt * ACC * f / m
    x = x + 0.5 * dt * v
    v = c1 * v + sigma * noise
    x = x + 0.5 * dt * v
    _, f_new, u = ref.evaluate(x, cutoff)
    v = v + 0.5 * dt * ACC * f_new / m
    return x, v, f_new, u
