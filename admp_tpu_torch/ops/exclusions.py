"""Topological-exclusion lookups on a dense (N, N) covalent map
(admp_tpu/ops/exclusions.py). The sparse per-atom tables wait
(ROADMAP.md queue 1, S1)."""

from __future__ import annotations

import torch


def lookup_topology_distance(covalent, i, j):
    """Topological distance of pairs (i, j) from a dense (N, N) map;
    0 means not excluded."""
    return covalent[i, j]


def scale_for_distance(scales, nbond):
    """Scale by topological distance: ``scales[nbond - 1]`` with distance 0
    (non-bonded) and distances beyond the table taking the last entry."""
    last = scales.shape[0] - 1
    idx = torch.where(nbond == 0, torch.full_like(nbond, last),
                      torch.clamp(nbond - 1, max=last))
    return scales[idx]
