"""Bonded (valence) terms: harmonic bonds and angles (admp_tpu/ops/bonded.py).

OpenMM conventions: E = k/2 (r - r0)^2 and E = k/2 (theta - theta0)^2, with k
and lengths in the engine's Angstrom and kJ/mol (k in kJ/mol/nm^2 divides by
100 for A^2). Displacements take the minimum image, so a bond may cross the
box.
"""

from __future__ import annotations

import numpy as np
import torch

from admp_tpu_torch.ops.pbc import pbc_shift
from admp_tpu_torch.utils import profiling
from admp_tpu_torch.utils.linalg3 import inv3x3


@profiling.traced("bonded")
def harmonic_bond_energy(positions, box, bond_idx, r0, k):
    """Sum of k/2 (|r_i - r_j| - r0)^2 over bonds.

    bond_idx: (B, 2) int atom indices; r0, k: (B,) equilibrium lengths (A)
    and force constants (kJ/mol/A^2)."""
    box_inv = inv3x3(box)
    bond_idx = bond_idx.long()
    dr = pbc_shift(positions[bond_idx[:, 0]] - positions[bond_idx[:, 1]], box,
                   box_inv)
    r = torch.sqrt(torch.sum(dr * dr, dim=-1))
    return torch.sum(0.5 * k * (r - r0) ** 2)


@profiling.traced("bonded")
def harmonic_angle_energy(positions, box, angle_idx, theta0, k):
    """Sum of k/2 (theta - theta0)^2 over angle triplets (i, j, k), j the
    central atom.

    angle_idx: (A, 3) int indices; theta0, k: (A,) equilibrium angles (rad)
    and constants (kJ/mol/rad^2)."""
    box_inv = inv3x3(box)
    angle_idx = angle_idx.long()
    v1 = pbc_shift(positions[angle_idx[:, 0]] - positions[angle_idx[:, 1]],
                   box, box_inv)
    v2 = pbc_shift(positions[angle_idx[:, 2]] - positions[angle_idx[:, 1]],
                   box, box_inv)
    cosang = torch.sum(v1 * v2, dim=-1) / (
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1))
    theta = torch.arccos(torch.clamp(cosang, -1.0 + 1e-12, 1.0 - 1e-12))
    return torch.sum(0.5 * k * (theta - theta0) ** 2)


def water_bonded_terms(n_mol: int):
    """Index and parameter arrays (numpy) of the MPID water bonded terms, in
    A and kJ/mol: (bond_idx, r0, k_bond, angle_idx, theta0, k_angle) for
    waters laid out (O, H, H)."""
    o = 3 * np.arange(n_mol)
    bond_idx = np.stack([np.repeat(o, 2),
                         np.stack([o + 1, o + 2], 1).reshape(-1)],
                        1).astype(np.int32)
    angle_idx = np.stack([o + 1, o, o + 2], 1).astype(np.int32)
    r0 = np.full(2 * n_mol, 0.9572)
    k_bond = np.full(2 * n_mol, 376560.0 / 100.0)  # kJ/mol/nm^2 -> A^2
    theta0 = np.full(n_mol, 1.82421813418)
    k_angle = np.full(n_mol, 460.24)
    return bond_idx, r0, k_bond, angle_idx, theta0, k_angle
