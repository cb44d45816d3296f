"""Topological-exclusion lookups (admp_tpu/ops/exclusions.py).

Two representations of the topological distances are accepted everywhere
(:func:`lookup_topology_distance`): a dense (N, N) int map, and
:class:`SparseExclusions`, fixed-width per-atom lists of the bond-graph
neighbours within ``max_depth`` bonds and their distances. The sparse table
is what a large system needs: a dense map of 98,304 atoms would hold 9.7e9
entries.
"""

from __future__ import annotations

from collections import defaultdict, deque

import numpy as np
import torch


def _int32(x):
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(torch.int32)


class SparseExclusions:
    """Fixed-width per-atom exclusion table: ``idx`` (N, W) int32 neighbour
    serials padded with N, ``dist`` (N, W) int32 their topological distances
    (0 on padding). ``packed = idx * 16 + dist`` lets a pair lookup gather
    one row instead of two (distances are <= 15)."""

    def __init__(self, idx, dist, n_atoms: int):
        self.idx, self.dist = _int32(idx), _int32(dist)
        self.n_atoms = int(n_atoms)
        self.packed = self.idx * 16 + self.dist

    def to(self, device) -> "SparseExclusions":
        return SparseExclusions(self.idx.to(device), self.dist.to(device),
                                self.n_atoms)

    def lookup(self, i, j):
        """Topological distance of pairs (i, j); 0 if not excluded."""
        rows = self.packed[i]  # (P, W)
        match = torch.div(rows, 16, rounding_mode="floor") == j[..., None]
        return torch.where(match, rows % 16,
                           torch.zeros_like(rows)).sum(-1).long()


def build_sparse_exclusions(bonds, n_atoms: int, max_depth: int = 6,
                            width: int | None = None) -> SparseExclusions:
    """Breadth-first search of the bond graph up to ``max_depth`` bonds into
    fixed-width per-atom lists, on the host, row for row as admp_tpu builds
    them.
    """
    if not 0 <= max_depth <= 15:
        raise ValueError(
            f"max_depth={max_depth} must be <= 15 (distances are packed into "
            "4 bits beside the neighbour index for a one-gather lookup)")
    adj = defaultdict(list)
    for i, j in bonds:
        adj[i].append(j)
        adj[j].append(i)
    rows = []
    for start in range(n_atoms):
        seen = {start: 0}
        queue = deque([start])
        found = []
        while queue:
            cur = queue.popleft()
            d = seen[cur]
            if d >= max_depth:
                continue
            for nxt in adj[cur]:
                if nxt not in seen:
                    seen[nxt] = d + 1
                    found.append((nxt, d + 1))
                    queue.append(nxt)
        rows.append(found)
    width = max(width or 0, max((len(r) for r in rows), default=0), 1)
    idx = np.full((n_atoms, width), n_atoms, dtype=np.int32)
    dist = np.zeros((n_atoms, width), dtype=np.int32)
    for a, found in enumerate(rows):
        for k, (b, d) in enumerate(found):
            idx[a, k] = b
            dist[a, k] = d
    return SparseExclusions(torch.from_numpy(idx), torch.from_numpy(dist),
                            n_atoms)


def as_covalent_map(covalent, device):
    """The map on ``device``: a SparseExclusions moved there, or a dense
    (N, N) map (array or tensor) as an int64 tensor."""
    if isinstance(covalent, SparseExclusions):
        return covalent.to(device)
    if not torch.is_tensor(covalent):
        covalent = torch.from_numpy(np.array(covalent))
    return covalent.to(device).long()


def lookup_topology_distance(covalent, i, j):
    """Topological distance of pairs (i, j) from a dense (N, N) map or a
    SparseExclusions; 0 means not excluded."""
    if isinstance(covalent, SparseExclusions):
        return covalent.lookup(i, j)
    return covalent[i, j]


def scale_for_distance(scales, nbond):
    """Scale by topological distance: ``scales[nbond - 1]`` with distance 0
    (non-bonded) and distances beyond the table taking the last entry."""
    last = scales.shape[0] - 1
    idx = torch.where(nbond == 0, torch.full_like(nbond, last),
                      torch.clamp(nbond - 1, max=last))
    return scales[idx]


def exclusion_pair_list(covalent, pad_multiple: int = 128):
    """(E, 2) int64 list of every topological pair (i < j, distance > 0),
    padded with (n, n) rows to a multiple of ``pad_multiple``, on the host.
    The topology is fixed for a run, so an exclusion pass can use it beside
    any neighbour list."""
    if isinstance(covalent, SparseExclusions):
        n = covalent.n_atoms
        idx = covalent.idx.cpu().numpy()
        dist = covalent.dist.cpu().numpy()
        a = np.repeat(np.arange(n), idx.shape[1])
        b = idx.reshape(-1)
        keep = (dist.reshape(-1) > 0) & (b < n) & (a < b)
        pairs = np.stack([a[keep], b[keep]], axis=1)
    else:
        cm = (covalent.cpu().numpy() if torch.is_tensor(covalent)
              else np.asarray(covalent))
        n = cm.shape[0]
        iu, ju = np.triu_indices(n, k=1)
        keep = cm[iu, ju] > 0
        pairs = np.stack([iu[keep], ju[keep]], axis=1)
    cap = -(-max(len(pairs), 1) // pad_multiple) * pad_multiple
    out = np.full((cap, 2), n, dtype=np.int64)
    out[: len(pairs)] = pairs
    return torch.from_numpy(out)
