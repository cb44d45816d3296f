"""Fixed-capacity dense neighbor list (admp_tpu/ops/neighborlist.py, dense
strategy). The cell list waits (ROADMAP.md queue 1, S1); at a few thousand
atoms the O(N^2) mask is cheap on the card.

Pairs are an (C, 2) int64 tensor, padded with (n, n), sorted by their i
column (the upper-triangle mask is compacted in row-major order).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from admp_tpu_torch.utils.linalg3 import inv3x3


@dataclasses.dataclass
class NeighborList:
    """``pairs[k] = (i, j)`` with i < j for real entries and (n, n) for
    padding; ``did_overflow`` is a bool tensor that says the capacity was
    exceeded and the list must be reallocated."""

    pairs: torch.Tensor
    did_overflow: torch.Tensor
    capacity: int
    cutoff: float


def _dense_pairs(positions, box, cutoff, capacity):
    n = positions.shape[0]
    frac = positions @ inv3x3(box)
    ds = frac[:, None, :] - frac[None, :, :]
    ds = ds - torch.floor(ds + 0.5)
    dr = ds @ box
    r2 = torch.sum(dr * dr, dim=-1)
    within = torch.triu(r2 < cutoff * cutoff, diagonal=1)
    hits = within.nonzero()  # row-major: sorted by i
    n_found = hits.shape[0]
    pairs = torch.full((capacity, 2), n, dtype=torch.long,
                       device=positions.device)
    take = min(n_found, capacity)
    pairs[:take] = hits[:take]
    overflow = torch.tensor(n_found > capacity, device=positions.device)
    return pairs, overflow, n_found


def _check_minimum_image(box, cutoff):
    half_min = float(torch.min(torch.abs(torch.diagonal(box)))) / 2.0
    if cutoff > half_min:
        warnings.warn(
            f"cutoff {cutoff} exceeds half the box ({half_min}): the minimum-"
            "image convention is ambiguous and multipolar energies become "
            "discontinuous as pairs cross images; enlarge the box or shrink rc."
        )


def neighbor_list_dense(positions, box, cutoff, capacity=None, padding=1.25):
    """Allocate a dense neighbor list on the positions' device. Without a
    ``capacity`` it is sized from the current configuration with
    ``padding`` headroom, rounded up to a multiple of 1024."""
    _check_minimum_image(box, cutoff)
    with torch.no_grad():
        if capacity is None:
            _, _, n_real = _dense_pairs(positions, box, cutoff, 0)
            capacity = int(-(-int(n_real * padding) // 1024) * 1024)
        pairs, overflow, _ = _dense_pairs(positions, box, cutoff, capacity)
    return NeighborList(pairs, overflow, capacity, float(cutoff))
