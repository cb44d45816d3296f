"""The water configurations: their inputs, made from the configuration file
and the seed, and the system under test built from them.

Inputs (``make_system``): a jittered lattice of rigid-geometry waters in
random orientations, the per-atom parameters of the water model, its bonds
and angles, and the Maxwell velocities; numpy only. The program and the
reference both take these arrays, and neither makes its own. Every seed gives
the same atoms, box and parameters; the seed moves the molecules (jitter and
orientation) and draws the velocities.

The system under test (``WaterProgram``): the program's force objects built
from those inputs through its public API, as a user's script composes them
(admp_tpu_torch/examples/run_npt.py): multipolar PME (``ADMPPmeForce``;
polarizable under ``SCFConfig.md()`` where the configuration says so),
Tang-Toennies (``generate_pairwise_interaction``), the water bonded terms,
and the cell list at the list cutoff (``neighbor_list_cell``, refreshed by
``refresh_neighbor_list``).
"""

from __future__ import annotations

import numpy as np
import torch

ZTHENX, BISECTOR = 0, 1  # the frame types of the program's ops/frames
K_B = 0.00831446261815324  # kJ/mol/K
ACC = 100.0  # a[A/ps^2] = F[kJ/mol/A] / m[g/mol] * ACC


def _rotations(rng, n):
    """n random rotation matrices from normal quaternions."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def make_system(config, seed, temperature):
    """The numpy arrays of one configuration at ``seed``, velocities at
    ``temperature`` K (float64; the
    positions and velocities already rounded to the configuration's
    float32, so that both sides start from the same numbers)."""
    lat, wat = config["lattice"], config["water"]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    n_side, spacing = int(lat["n_side"]), float(lat["spacing_A"])
    nmol = n_side ** 3
    n = 3 * nmol
    half = np.deg2rad(wat["angle_HOH_deg"]) / 2.0
    r_oh = wat["r_OH_A"]
    tmpl = np.array([[0.0, 0.0, 0.0],
                     [r_oh * np.sin(half), 0.0, r_oh * np.cos(half)],
                     [-r_oh * np.sin(half), 0.0, r_oh * np.cos(half)]])
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    centers = (grid + 0.5) * spacing + rng.uniform(
        -lat["jitter_A"], lat["jitter_A"], (nmol, 3))
    rot = _rotations(rng, nmol)
    positions = (np.einsum("mij,aj->mai", rot, tmpl)
                 + centers[:, None, :]).reshape(n, 3)
    box = np.eye(3) * n_side * spacing

    def per_atom(key):
        return np.tile([wat[key + "_O"], wat[key + "_H"], wat[key + "_H"]],
                       nmol).astype(np.float64)

    q_cart = np.zeros((n, 10))
    q_cart[:, 0] = per_atom("charge")
    q_cart[0::3, 3] = wat["dipole_z_O"]
    q_cart[0::3, 4] = wat["quad_xx_O"]
    q_cart[0::3, 5] = wat["quad_yy_O"]
    q_cart[0::3, 6] = wat["quad_zz_O"]
    o = 3 * np.arange(nmol)
    axis_indices = np.full((n, 3), -1, dtype=np.int64)
    axis_indices[o, 0], axis_indices[o, 1] = o + 1, o + 2
    axis_indices[o + 1, 0], axis_indices[o + 1, 1] = o, o + 2
    axis_indices[o + 2, 0], axis_indices[o + 2, 1] = o, o + 1
    masses = per_atom("mass")
    v = rng.standard_normal((n, 3)) * np.sqrt(
        K_B * temperature * ACC / masses)[:, None]
    bond_idx = np.stack([np.repeat(o, 2),
                         np.stack([o + 1, o + 2], 1).reshape(-1)], 1)
    return dict(
        positions=positions.astype(np.float32).astype(np.float64),
        velocities=v.astype(np.float32).astype(np.float64),
        box=box,
        masses=masses,
        q_cart=q_cart,
        axis_types=np.tile([BISECTOR, ZTHENX, ZTHENX], nmol),
        axis_indices=axis_indices,
        pol=per_atom("pol"),
        tholes=per_atom("thole"),
        tt_a=per_atom("tt_a"),
        tt_b=per_atom("tt_b"),
        tt_q=per_atom("tt_q"),
        tt_c6=per_atom("sqrt_c6"),
        bonds=[(int(a), int(b)) for a, b in bond_idx],
        bond_idx=bond_idx,
        bond_r0=np.full(2 * nmol, wat["bond_r0_A"]),
        bond_k=np.full(2 * nmol, wat["bond_k_kJmol_A2"]),
        angle_idx=np.stack([o + 1, o, o + 2], 1),
        angle_theta0=np.full(nmol, wat["angle_theta0_rad"]),
        angle_k=np.full(nmol, wat["angle_k_kJmol_rad2"]),
        molecule=np.repeat(np.arange(nmol), 3),
        is_heavy=np.tile([True, False, False], nmol),
    )


class WaterProgram:
    """``force_fn(positions, aux) -> (energy, forces, aux)`` at the current
    pair list, as the program's integrators take it; ``refresh(positions)``
    rebuilds the list at its capacity (and anew on overflow)."""

    def __init__(self, system, config, list_cutoff, device):
        import dataclasses

        from admp_tpu_torch import (
            ADMPPmeForce,
            EngineConfig,
            SCFConfig,
            convert_cart2harm,
            generate_pairwise_interaction,
            neighbor_list_cell,
            tt_damping_qq_c6_kernel,
        )
        from admp_tpu_torch.io.topology import build_covalent_map_from_bonds
        from admp_tpu_torch.ops.exclusions import build_sparse_exclusions

        model = config["model"]
        dtype = getattr(torch, config["dtype"])
        self.device = device = torch.device(device)
        n = system["positions"].shape[0]
        c = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,  # noqa: E731
                                      device=device)
        self.box = c(system["box"])
        self.positions = c(system["positions"])
        self.velocities = c(system["velocities"])
        self.masses = c(system["masses"])
        if model["exclusions"] == "sparse":
            covalent = build_sparse_exclusions(system["bonds"], n, 6)
        else:
            covalent = build_covalent_map_from_bonds(system["bonds"], n, 6)
        fft = model["mesh"] == "fft_friendly"
        cfg = EngineConfig(cache_influence=bool(model["cache_influence"]),
                           fft_friendly_grid=fft, pairs_i_sorted=True)
        if model["polarizable"]:
            cfg = dataclasses.replace(cfg, scf=SCFConfig.md())
        self.pme = ADMPPmeForce(
            system["box"], system["axis_types"], system["axis_indices"],
            covalent, model["rc_A"], model["ethresh"], lmax=model["lmax"],
            lpol=bool(model["polarizable"]), config=cfg, device=device,
            dtype=dtype)
        if not fft:
            self.pme.K1, self.pme.K2, self.pme.K3 = model["mesh"]
            self.pme.refresh_calculators()
        self.grid = (self.pme.K1, self.pme.K2, self.pme.K3)
        self.m_scales = c(model["m_scales"])
        if model["polarizable"]:
            self.pol_args = (c(system["pol"]), c(system["tholes"]),
                             self.m_scales, c(model["p_scales"]),
                             c(model["d_scales"]))
        self.q_local = convert_cart2harm(c(system["q_cart"]), model["lmax"])
        self.tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                                covalent, device=device)
        self.tt_args = [c(system[k]) for k in ("tt_a", "tt_b", "tt_q",
                                               "tt_c6")]
        self.bonded = (
            torch.as_tensor(system["bond_idx"], device=device),
            c(system["bond_r0"]), c(system["bond_k"]),
            torch.as_tensor(system["angle_idx"], device=device),
            c(system["angle_theta0"]), c(system["angle_k"]))
        self.nl = neighbor_list_cell(self.positions, self.box, list_cutoff)
        if bool(self.nl.did_overflow):
            raise RuntimeError("the cell list overflowed at allocation")

    def energy(self, positions):
        """PME + Tang-Toennies + the bonded terms, as run_npt sums them."""
        from admp_tpu_torch.ops.bonded import (
            harmonic_angle_energy,
            harmonic_bond_energy,
        )

        pairs, box = self.nl.pairs, self.box
        if self.pme.lpol:
            e = self.pme.get_energy(positions, box, pairs, self.q_local,
                                    *self.pol_args)
        else:
            e = self.pme.get_energy(positions, box, pairs, self.q_local,
                                    self.m_scales)
        e = e + self.tt(positions, box, pairs, self.m_scales, *self.tt_args)
        bi, r0, kb, ai, th0, ka = self.bonded
        return (e + harmonic_bond_energy(positions, box, bi, r0, kb)
                + harmonic_angle_energy(positions, box, ai, th0, ka))

    def force_fn(self, positions, aux):
        x = positions.detach().requires_grad_(True)
        with torch.enable_grad():
            e = self.energy(x)
            (g,) = torch.autograd.grad(e, x)
        return e.detach(), -g, aux

    def refresh(self, positions):
        from admp_tpu_torch import refresh_neighbor_list

        self.nl = refresh_neighbor_list(self.nl, positions, self.box)

    def dipoles(self):
        """The induced dipoles of the last force call (None without
        polarization)."""
        return self.pme.U_ind if self.pme.lpol else None

    def scf_iterations(self):
        """PCG iterations of the last force call (None without
        polarization)."""
        return self.pme.n_cycle if self.pme.lpol else None
