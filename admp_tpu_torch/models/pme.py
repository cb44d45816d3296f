"""Multipolar electrostatic PME with optional Thole polarization
(admp_tpu/models/pme.py, plain precision).

The class keeps admp_tpu's public surface: the constructor arguments,
``refresh_calculators``, ``get_energy`` / ``get_forces`` / ``get_metrics`` /
``optimize_Uind``, the ``U_ind`` / ``lconverg`` / ``n_cycle`` state and
writable ``kappa`` / ``K1..K3`` (rebuild with ``refresh_calculators``). As
there, ``get_forces`` returns (energy, dE/dpositions).

The polarizable step follows admp_tpu's Feynman-Hellmann (FH) path
(models/pme.py:969-1000): r0 = -field(u0) from ``torch.autograd.grad`` on
detached inputs with no graph kept, warm-started PCG whose every matvec is
one ``torch.autograd.grad`` of the u-quadratic energy with respect to v, and
the final energy evaluated at a detached u* and differentiated with respect
to the positions. With ``exact_adjoint=True`` (the default ``SCFConfig()``,
the fitting profile) u* carries the implicit-function adjoint of
scf/solver.ImplicitSolve instead, on the plain path and on the kernels alike:
r0 = -field(u0) keeps its graph, so the backward differentiates the pair
kernel's backward (K3 for ``'pol'``), and the adjoint differentiates the
matvec with respect to its parameters (K3 for ``'uu'``). Gradients with
respect to Q_local, pol, tholes, mScales and pScales flow through
``get_energy`` on either path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from admp_tpu_torch.ops import realspace
from admp_tpu_torch.ops.cuda import use_kernel
from admp_tpu_torch.ops.cuda.pairs import pair_energies
from admp_tpu_torch.ops.ewald import (
    lane_align_k3,
    setup_ewald_parameters,
    setup_ewald_parameters_fft,
)
from admp_tpu_torch.ops.exclusions import lookup_topology_distance, scale_for_distance
from admp_tpu_torch.ops.frames import local_frames_components
from admp_tpu_torch.ops.harmonics import cart_dipole_to_harm, rot_local2global_components
from admp_tpu_torch.ops.influence import ck_1
from admp_tpu_torch.ops.neighborlist import NeighborList
from admp_tpu_torch.ops.reciprocal import make_pme_recip
from admp_tpu_torch.ops.selfenergy import pme_self_energy, polarization_penalty
from admp_tpu_torch.scf import solver
from admp_tpu_torch.settings import EngineConfig
from admp_tpu_torch.utils.accmath import compensated_sum, masked_compensated_sum
from admp_tpu_torch.utils.constants import DIELECTRIC
from admp_tpu_torch.utils.linalg3 import inv3x3


def _pair_indices(pairs, n):
    raw_i, raw_j = pairs[:, 0], pairs[:, 1]
    mask = raw_i < raw_j
    return torch.clamp(raw_i, max=n - 1), torch.clamp(raw_j, max=n - 1), mask


def _pair_scalars(kappa, box):
    """The pair kernel's 19 scalars: kappa, box (9), inv(box) (9)."""
    k = torch.as_tensor(kappa, dtype=box.dtype, device=box.device).reshape(1)
    return torch.cat([k, box.reshape(9), inv3x3(box).reshape(9)])


def pme_real_energy(positions, box, pairs, q_global, u_ind_harm, pol, tholes,
                    m_scales, p_scales, covalent_map, kappa, lmax: int,
                    lpol: bool, compensated: bool = False,
                    pair_kernel: str = "auto"):
    """Real-space multipolar Ewald energy over a padded pair list (pairs with
    i >= j are padding). ``pair_kernel`` picks the CUDA pair kernel or the
    plain component path (ops/cuda.use_kernel)."""
    n = positions.shape[0]
    i, j, mask = _pair_indices(pairs, n)
    nbond = lookup_topology_distance(covalent_map, i, j)
    mscale = scale_for_distance(m_scales, nbond)

    if use_kernel(pair_kernel, positions, "pair_kernel"):
        # the kernel takes the two gathered rows of one packed atom table
        dtype = positions.dtype
        cols = [positions, q_global[:, : (lmax + 1) ** 2]]
        scl_rows = [mscale.to(dtype), mask.to(dtype)]
        if lpol:
            cols += [u_ind_harm, pol.to(dtype)[:, None],
                     tholes.to(dtype)[:, None]]
            scl_rows.append(scale_for_distance(p_scales, nbond).to(dtype))
        packed = torch.cat(cols, dim=1)
        e = pair_energies(
            packed.index_select(0, i), packed.index_select(0, j),
            torch.stack(scl_rows), _pair_scalars(kappa, box), lmax,
            "pol" if lpol else "perm", method="cuda")
        return compensated_sum(e) if compensated else e.sum()

    r, qi_i, qi_j, ui, uj = realspace.qi_pair_components(
        positions, box, q_global, i, j, mask, lmax,
        u_ind_harm if lpol else None)
    coef = realspace.perm_coefficients(r, mscale, kappa, lmax)
    e = realspace.pair_energy_perm(qi_i, qi_j, coef, lmax)
    if lpol:
        pscale = scale_for_distance(p_scales, nbond)
        dmp = realspace.pair_damping_width(pol[i], pol[j])
        icoef = realspace.induced_coefficients(
            r, tholes[i], tholes[j], dmp, pscale, kappa, lmax)
        e = e + realspace.pair_energy_induced(qi_i, qi_j, ui, uj, icoef, lmax)
    if compensated:
        return masked_compensated_sum(e, mask)
    return torch.where(mask, e, torch.zeros_like(e)).sum()


def pme_real_uu_energy(positions, box, pairs, u_ind_harm, pol, tholes,
                       p_scales, covalent_map, kappa,
                       pair_kernel: str = "auto"):
    """Real-space induced-induced energy only (the u-quadratic slice of the
    polarizable pair energy), for the SCF matvec."""
    n = positions.shape[0]
    i, j, mask = _pair_indices(pairs, n)
    pscale = scale_for_distance(p_scales,
                                lookup_topology_distance(covalent_map, i, j))
    if use_kernel(pair_kernel, positions, "pair_kernel"):
        dtype = positions.dtype
        packed = torch.cat([positions, u_ind_harm, pol.to(dtype)[:, None],
                            tholes.to(dtype)[:, None]], dim=1)
        e = pair_energies(
            packed.index_select(0, i), packed.index_select(0, j),
            torch.stack([pscale.to(dtype), mask.to(dtype)]),
            _pair_scalars(kappa, box), 1, "uu", method="cuda")
        return e.sum()

    dx, dy, dz, r, rinv, _, _ = realspace.pair_displacement_components(
        positions, box, i, j, mask)
    ug_i, ug_j = u_ind_harm[i], u_ind_harm[j]
    e = realspace.uu_pair_energy(
        dx, dy, dz, r, rinv, (ug_i[:, 1], ug_i[:, 2], ug_i[:, 0]),
        (ug_j[:, 1], ug_j[:, 2], ug_j[:, 0]), pol[i], pol[j], tholes[i],
        tholes[j], pscale, kappa)
    return torch.where(mask, e, torch.zeros_like(e)).sum()


def make_induced_quadratic_energy(covalent_map, kappa, grid_shape,
                                  config: EngineConfig, static_box=None):
    """E_uu(v): the exactly-u-quadratic part of the polarizable energy, whose
    v-gradient is A v. Terms: real-space udud, |S(u)|^2 on an lmax=1 mesh,
    the u self energy and the polarization penalty."""
    recip_uu = make_pme_recip(
        ck_1, kappa, grid_shape, 1, DIELECTRIC,
        spread_method=config.spread_method,
        compensated=config.compensated_sums, static_box=static_box,
        spread_order=config.spread_order,
    )

    def energy_uu(positions, box, pairs, u_ind_cart, pol, tholes, p_scales):
        u_harm = cart_dipole_to_harm(u_ind_cart)
        e = pme_real_uu_energy(positions, box, pairs, u_harm, pol, tholes,
                               p_scales, covalent_map, kappa,
                               config.pair_kernel)
        q_u = torch.cat([u_harm.new_zeros(u_harm.shape[0], 1), u_harm], dim=-1)
        e = e + recip_uu(positions, box, q_u)
        e = e + pme_self_energy(q_u, kappa, 1)
        e = e + polarization_penalty(u_ind_cart, pol)
        return e

    return energy_uu


def energy_pme(positions, box, pairs, q_local, u_ind_cart, pol, tholes,
               m_scales, p_scales, d_scales, covalent_map, axis_types,
               axis_indices, pme_recip_fn, kappa, lmax: int, lpol: bool,
               config: EngineConfig | None = None,
               return_terms: bool = False):
    """Total multipolar PME energy: real + reciprocal + self
    (+ polarization). ``u_ind_cart`` are Cartesian induced dipoles;
    ``d_scales`` is accepted for API parity and unused, as in admp_tpu."""
    del d_scales
    config = config or EngineConfig()
    if lmax > 0:
        frame_comps = local_frames_components(positions, box, axis_types,
                                              axis_indices)
        q_global = rot_local2global_components(q_local, frame_comps, lmax)
    else:
        q_global = q_local
    lmax_eff = lmax
    u_harm = None
    q_tot = q_global
    if lpol:
        if lmax == 0:
            # promote charges so induced dipoles have slots
            q_global = torch.cat(
                [q_global, q_global.new_zeros(q_global.shape[0], 3)], dim=-1)
            lmax_eff = 1
        u_harm = cart_dipole_to_harm(u_ind_cart)
        q_tot = torch.cat([q_global[:, :1], q_global[:, 1:4] + u_harm,
                           q_global[:, 4:]], dim=-1)
    e_real = pme_real_energy(
        positions, box, pairs, q_global, u_harm, pol, tholes, m_scales,
        p_scales, covalent_map, kappa, lmax_eff, lpol,
        compensated=config.compensated_sums, pair_kernel=config.pair_kernel)
    if lpol and lmax == 0:
        # the engine spreads charges only; the dipoles go on their own mesh
        e_recip = pme_recip_fn(positions, box, q_global[:, :1], u_harm)
    else:
        e_recip = pme_recip_fn(positions, box, q_tot)
    e_self = pme_self_energy(q_tot, kappa, lmax_eff)
    e_pol = None
    if lpol:
        e_pol = polarization_penalty(u_ind_cart, pol)
        e_self = e_self + e_pol
    # compensated float32 sums come back in float64 (utils/accmath): add the
    # ~1e6-magnitude terms there and round the total once
    work_dtype = positions.dtype
    total = (e_real + e_recip + e_self).to(work_dtype)
    if return_terms:
        terms = {"e_real": e_real, "e_recip": e_recip, "e_self": e_self}
        if e_pol is not None:
            terms["e_pol_penalty"] = e_pol
        return total, {k: v.to(work_dtype) for k, v in terms.items()}
    return total


class ADMPPmeForce:
    """Multipolar PME calculator with admp_tpu's public surface.

    ``device`` and ``dtype`` say where and in what type the force works;
    inputs are moved there. The kernels run for ``dtype=torch.float32`` on a
    CUDA device (EngineConfig.pair_kernel / spread_method ``'auto'``).
    """

    def __init__(self, box, axis_type, axis_indices, covalent_map, rc,
                 ethresh, lmax, lpol=False, config: EngineConfig | None = None,
                 device="cpu", dtype=torch.float32):
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        self.dtype = dtype
        box_np = np.asarray(box.detach().cpu() if torch.is_tensor(box) else box,
                            dtype=np.float64)
        self.axis_type = self._index_tensor(axis_type)
        self.axis_indices = self._index_tensor(axis_indices)
        self.covalent_map = self._index_tensor(covalent_map)
        self.n_atoms = int(self.covalent_map.shape[0])
        self.rc = rc
        self.ethresh = ethresh
        self.lmax = int(lmax)
        self.lpol = bool(lpol)
        if self.config.resolve_fft_friendly():
            kappa, k1, k2, k3 = setup_ewald_parameters_fft(rc, ethresh, box_np)
        else:
            kappa, k1, k2, k3 = setup_ewald_parameters(rc, ethresh, box_np)
        if self.config.resolve_lane_align():
            k3 = lane_align_k3(k3)
        self.kappa = kappa
        self.K1, self.K2, self.K3 = k1, k2, k3
        self.scf_config = self.config.scf
        self._static_box = (self._float(box_np) if self.config.cache_influence
                            else None)
        self.U_ind = torch.zeros((self.n_atoms, 3), device=self.device,
                                 dtype=dtype)
        self.lconverg = None
        self.n_cycle = None
        if self.lpol:
            self.get_energy = self._pol_energy
            self.get_forces = self._pol_forces
            self.get_metrics = self._pol_metrics
        else:
            self.get_energy = self._fixed_energy
            self.get_forces = self._fixed_forces
            self.get_metrics = self._fixed_metrics
        self.refresh_calculators()

    # ------------------------------------------------------------------
    def _index_tensor(self, x):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x))
        return x.to(self.device).long()

    def _float(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x))
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _accept_pairs(self, pairs):
        """A NeighborList is unwrapped to its pair tensor; the pair order
        does not matter to the port, so nothing is resolved or cached."""
        if isinstance(pairs, NeighborList):
            pairs = pairs.pairs
        if isinstance(pairs, np.ndarray):
            pairs = torch.from_numpy(np.array(pairs))
        return torch.as_tensor(pairs, device=self.device).long()

    def refresh_calculators(self):
        """(Re)build the reciprocal engines from kappa and K1..K3."""
        cfg = self.config
        self._kappa = self.kappa
        self.pme_recip = make_pme_recip(
            ck_1, self.kappa, (self.K1, self.K2, self.K3), self.lmax,
            DIELECTRIC, spread_method=cfg.spread_method,
            compensated=cfg.compensated_sums, static_box=self._static_box,
            spread_order=cfg.spread_order,
        )
        if self.lpol:
            scf = self.scf_config
            mv_config = cfg
            if scf.matvec_spread_order is not None:
                mv_config = dataclasses.replace(
                    cfg, spread_order=scf.matvec_spread_order)
            div = max(int(scf.matvec_grid_div), 1)

            def reduce_k(k, keep_aligned=False):
                if div == 1 or (keep_aligned and k % 128 == 0):
                    return k
                kd = max(-(-k // div), 32)
                kd = kd + (kd % 2)
                return min(kd, k)

            mv_grid = (reduce_k(self.K1), reduce_k(self.K2),
                       reduce_k(self.K3, keep_aligned=True))
            self.matvec_grid = mv_grid
            self.energy_uu = make_induced_quadratic_energy(
                self.covalent_map, self.kappa, mv_grid, mv_config,
                static_box=self._static_box)

    # ------------------------------------------------------------------
    # fixed-multipole path
    # ------------------------------------------------------------------
    def _fixed_terms(self, positions, box, pairs, Q_local, mScales,
                     return_terms=False):
        return energy_pme(
            self._float(positions), self._float(box),
            self._accept_pairs(pairs), self._float(Q_local), None, None,
            None, self._float(mScales), None, None, self.covalent_map,
            self.axis_type, self.axis_indices, self.pme_recip, self._kappa,
            self.lmax, False, self.config, return_terms=return_terms)

    def _fixed_energy(self, positions, box, pairs, Q_local, mScales):
        return self._fixed_terms(positions, box, pairs, Q_local, mScales)

    def _fixed_forces(self, positions, box, pairs, Q_local, mScales):
        pos = self._float(positions).detach().requires_grad_(True)
        with torch.enable_grad():
            energy = self._fixed_terms(pos, box, pairs, Q_local, mScales)
            (grad,) = torch.autograd.grad(energy, pos)
        return energy.detach(), grad

    def _fixed_metrics(self, positions, box, pairs, Q_local, mScales):
        with torch.no_grad():
            total, terms = self._fixed_terms(positions, box, pairs, Q_local,
                                             mScales, return_terms=True)
        return dict(terms, e_total=total)

    # ------------------------------------------------------------------
    # polarizable path
    # ------------------------------------------------------------------
    def _inputs(self, positions, box, pairs, Q_local, pol, tholes, mScales,
                pScales, dScales):
        f = self._float
        return dict(positions=f(positions), box=f(box),
                    pairs=self._accept_pairs(pairs), Q_local=f(Q_local),
                    pol=f(pol), tholes=f(tholes), mScales=f(mScales),
                    pScales=f(pScales), dScales=f(dScales))

    def energy_fn(self, inp, u_ind, return_terms=False):
        """Total energy at induced dipoles ``u_ind`` (the admp_tpu
        ``energy_fn``)."""
        return energy_pme(
            inp["positions"], inp["box"], inp["pairs"], inp["Q_local"],
            u_ind, inp["pol"], inp["tholes"], inp["mScales"], inp["pScales"],
            inp["dScales"], self.covalent_map, self.axis_type,
            self.axis_indices, self.pme_recip, self._kappa, self.lmax, True,
            self.config, return_terms=return_terms)

    def field(self, u, inp, create_graph=False):
        """dE/du at ``u``: one torch.autograd.grad of the total energy."""
        u_req = u.detach().requires_grad_(True)
        with torch.enable_grad():
            e = self.energy_fn(inp, u_req)
            (g,) = torch.autograd.grad(e, u_req, create_graph=create_graph)
        return g

    _MATVEC_KEYS = ("positions", "box", "pol", "tholes", "pScales")

    def _matvec_fn(self, pairs):
        def matvec(v, theta, create_graph):
            positions, box, pol, tholes, p_scales = theta
            v_req = v.detach().requires_grad_(True)
            with torch.enable_grad():
                e = self.energy_uu(positions, box, pairs, v_req, pol, tholes,
                                   p_scales)
                (g,) = torch.autograd.grad(e, v_req, create_graph=create_graph)
            return g

        return matvec

    def _energy_and_aux(self, inp, U_init, return_terms=False):
        """Energy at the converged dipoles (with the autograd graph to any
        input that requires grad) and (u*, converged, n_iter)."""
        u0 = (self.U_ind if U_init is None else self._float(U_init)).detach()
        matvec_fn = self._matvec_fn(inp["pairs"])
        theta = [inp[k] for k in self._MATVEC_KEYS]
        if self.scf_config.exact_adjoint:
            r0 = -self.field(u0, inp, create_graph=True)
            u_star, conv, n_it = solver.solve_implicit(
                r0, u0, inp["pol"], matvec_fn, self.scf_config, theta)
        else:
            # FH cut: the solve contributes no gradient
            inp_d = {k: v.detach() for k, v in inp.items()}
            theta_d = [t.detach() for t in theta]
            r0 = -self.field(u0, inp_d)
            u_star, conv, n_it, _ = solver.solve(
                lambda v: matvec_fn(v, theta_d, False), r0, u0, inp["pol"],
                self.scf_config)
        out = self.energy_fn(inp, u_star, return_terms=return_terms)
        return out, (u_star.detach(), conv, n_it)

    def _pol_energy(self, positions, box, pairs, Q_local, pol, tholes,
                    mScales, pScales, dScales, U_init=None):
        inp = self._inputs(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales)
        energy, (u, conv, n_it) = self._energy_and_aux(inp, U_init)
        self.U_ind, self.lconverg, self.n_cycle = u, conv, n_it
        return energy

    def _pol_forces(self, positions, box, pairs, Q_local, pol, tholes,
                    mScales, pScales, dScales, U_init=None):
        inp = self._inputs(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales)
        inp["positions"] = inp["positions"].detach().requires_grad_(True)
        with torch.enable_grad():
            energy, (u, conv, n_it) = self._energy_and_aux(inp, U_init)
            (grad,) = torch.autograd.grad(energy, inp["positions"])
        self.U_ind, self.lconverg, self.n_cycle = u, conv, n_it
        return energy.detach(), grad

    def _pol_metrics(self, positions, box, pairs, Q_local, pol, tholes,
                     mScales, pScales, dScales, U_init=None):
        """Term energies at the converged dipoles plus SCF diagnostics."""
        inp = self._inputs(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales)
        inp = {k: v.detach() for k, v in inp.items()}
        (total, terms), (u, conv, n_it) = self._energy_and_aux(
            inp, U_init, return_terms=True)
        terms = {k: v.detach() for k, v in terms.items()}
        return dict(terms, e_total=total.detach(), scf_converged=conv,
                    scf_iters=n_it)

    def optimize_Uind(self, positions, box, pairs, Q_local, pol, tholes,
                      mScales, pScales, dScales, U_init=None):
        """Converge the induced dipoles only; returns (U, converged,
        n_iterations). Starts from zero unless ``U_init`` is given."""
        inp = self._inputs(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales)
        inp = {k: v.detach() for k, v in inp.items()}
        if U_init is None:
            U_init = torch.zeros_like(self.U_ind)
        _, aux = self._energy_and_aux(inp, U_init)
        return aux
