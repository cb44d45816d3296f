"""Short-range pairwise interactions and the Tang-Toennies kernel
(admp_tpu/ops/shortrange.py) over padded pair lists with masks.

Plain PyTorch: admp_tpu computes these in XLA, not in a Pallas kernel.
``pairs_i_sorted`` is accepted and ignored, as in EngineConfig: the backward
of ``index_select`` is right for any pair order.
"""

from __future__ import annotations

import torch

from admp_tpu_torch.ops.cuda import resolve_device
from admp_tpu_torch.ops.exclusions import (
    as_covalent_map,
    lookup_topology_distance,
    scale_for_distance,
)
from admp_tpu_torch.ops.realspace import min_image_components
from admp_tpu_torch.utils import profiling
from admp_tpu_torch.utils.constants import ANGSTROM_TO_BOHR, HARTREE_TO_KJMOL


def distribute_scalar(params, index):
    """The parameter rows of ``index`` (the reference's distributors; one
    gather serves every shape)."""
    return params[index]


distribute_v3 = distribute_scalar
distribute_multipoles = distribute_scalar
distribute_dispcoeff = distribute_scalar


def pair_r2(positions, box, pairs):
    """(mask, i, j, r2): real pairs (i < j), gather-safe indices, and the
    squared minimum-image distances, 1 on masked pairs."""
    n = positions.shape[0]
    raw_i, raw_j = pairs[:, 0], pairs[:, 1]
    mask = raw_i < raw_j
    i = torch.clamp(raw_i, max=n - 1)
    j = torch.clamp(raw_j, max=n - 1)
    dx, dy, dz = min_image_components(positions.index_select(0, i),
                                      positions.index_select(0, j), box)
    r2 = dx * dx + dy * dy + dz * dz
    return mask, i, j, torch.where(mask, r2, torch.ones_like(r2))


def expand_pairs(positions, box, pairs, covalent_map, scales):
    """(mask, i, j, r, mscale) of a padded pair list (padding (n, n)).

    ``scales`` is indexed by topological distance - 1, and distance 0 (not
    bonded) wraps to the last entry, as the reference's ``mScales[nbonds -
    1]`` does; masked pairs get r = 1."""
    mask, i, j, r2 = pair_r2(positions, box, pairs)
    nbond = lookup_topology_distance(covalent_map, i, j)
    return mask, i, j, torch.sqrt(r2), scale_for_distance(scales, nbond)


def generate_pairwise_interaction(pair_int_kernel, covalent_map,
                                  static_args=None,
                                  pairs_i_sorted: bool = False,
                                  device="cuda"):
    """(positions, box, pairs, mScales, *atomic_params) -> energy.

    ``pair_int_kernel(r, mscale, p0_i, p0_j, p1_i, p1_j, ...)`` gives the
    per-pair energies; each per-atom parameter array adds its gathered (i, j)
    pair of arguments, in order. The covalent map, dense or a
    SparseExclusions, is moved to ``device`` once (the card unless the
    caller asks for the CPU).
    ``static_args`` and ``pairs_i_sorted`` are accepted for the reference's
    signature and unused, as there."""
    del static_args, pairs_i_sorted
    covalent_map = as_covalent_map(covalent_map, resolve_device(device))

    @profiling.traced("shortrange")
    def pair_int(positions, box, pairs, m_scales, *atomic_params):
        mask, i, j, r, mscale = expand_pairs(positions, box, pairs,
                                             covalent_map, m_scales)
        # one row gather per side for all parameter columns
        packed = torch.stack(atomic_params, dim=-1)
        g_i, g_j = packed.index_select(0, i), packed.index_select(0, j)
        gathered = []
        for k in range(len(atomic_params)):
            gathered += [g_i[:, k], g_j[:, k]]
        energies = pair_int_kernel(r, mscale, *gathered)
        return torch.where(mask, energies, torch.zeros_like(energies)).sum()

    return pair_int


def tt_damping_qq_c6_kernel(r, mscale, a_i, a_j, b_i, b_j, q_i, q_j, c_i, c_j):
    """Tang-Toennies damped Born-Mayer + charge-charge + C6 pair energy:
    combining rules sqrt(a_i a_j), sqrt(b_i b_j), q_i q_j, c_i c_j; a in
    Hartree, b in 1/Bohr, r in Angstrom, energies in kJ/mol."""
    a = torch.sqrt(a_i * a_j)
    b = torch.sqrt(b_i * b_j)
    c = c_i * c_j
    q = q_i * q_j
    br = b * (r * ANGSTROM_TO_BOHR)
    br2 = br * br
    br3 = br2 * br
    br4 = br3 * br
    br5 = br4 * br
    br6 = br5 * br
    exp_br = torch.exp(-br)
    poly = (1.0 + br + br2 / 2.0 + br3 / 6.0 + br4 / 24.0 + br5 / 120.0
            + br6 / 720.0)
    e = (HARTREE_TO_KJMOL * a * exp_br
         - HARTREE_TO_KJMOL * exp_br * (1.0 + br) * q / br
         + exp_br * poly * c / r**6)
    return e * mscale
