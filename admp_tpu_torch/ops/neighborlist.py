"""Fixed-capacity neighbor lists (admp_tpu/ops/neighborlist.py): the dense
O(N^2) list and the cell list, on the positions' device.

Pairs are an (C, 2) int64 tensor, (i, j) with i < j for real entries and
padded with (n, n). Both strategies emit i-sorted lists (non-decreasing i,
padding last; ``NeighborList.i_sorted``). The cell list takes admp_tpu's
adopted methods as its code: candidates from a per-cell neighbourhood table
(admp_tpu's ``CAND_METHOD='cell'``) and the two-stage compaction with a
per-row sort (``COMPACT_METHOD='sort'``); the module-level switches between
them and the branches that lost their A/B are not ported.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from admp_tpu_torch.utils import comm, profiling
from admp_tpu_torch.utils.linalg3 import inv3x3


@dataclasses.dataclass
class NeighborList:
    """``pairs[k] = (i, j)`` with i < j for real entries and (n, n) for
    padding; ``did_overflow`` is a bool tensor that says a capacity was
    exceeded and the list must be reallocated. ``i_sorted``: the i column
    is non-decreasing. A cell list also keeps its cell grid ``n_cells``
    and per-cell capacity ``cell_capacity`` (None for a dense list)."""

    pairs: torch.Tensor
    did_overflow: torch.Tensor
    capacity: int
    cutoff: float
    i_sorted: bool = False
    n_cells: tuple | None = None
    cell_capacity: int | None = None


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
    return NeighborList(pairs, overflow, capacity, float(cutoff),
                        i_sorted=True)


def update_neighbor_list(nlist: NeighborList, positions, box):
    """The dense list again at its fixed capacity (check ``did_overflow``)."""
    with torch.no_grad():
        pairs, overflow, _ = _dense_pairs(positions, box, nlist.cutoff,
                                          nlist.capacity)
    return NeighborList(pairs, overflow, nlist.capacity, nlist.cutoff,
                        i_sorted=True)


@profiling.traced("nl.refresh")
def refresh_neighbor_list(nlist: NeighborList, positions, box):
    """Refresh a dense or cell list and never hand back a truncated one:
    rebuild at the stored capacities, and allocate anew when a capacity
    overflows or, for a cell list, when the box moved the cell grid (the
    counter ``nl.rebuilds``)."""
    if nlist.n_cells is None:
        nl = update_neighbor_list(nlist, positions, box)
        if profiling.host_sync("nl.overflow", bool, nl.did_overflow):
            profiling.count("nl.rebuilds")
            return neighbor_list_dense(positions, box, nlist.cutoff)
        return nl
    if _cell_grid(box, nlist.cutoff) != tuple(nlist.n_cells):
        profiling.count("nl.rebuilds")
        return neighbor_list_cell(positions, box, nlist.cutoff,
                                  sort_i=nlist.i_sorted)
    with torch.no_grad():
        pairs, overflow = _cell_pairs(positions, box, nlist.cutoff,
                                      nlist.n_cells, nlist.cell_capacity,
                                      nlist.capacity, nlist.i_sorted)
    if profiling.host_sync("nl.overflow", bool, overflow):
        profiling.count("nl.rebuilds")
        return neighbor_list_cell(positions, box, nlist.cutoff,
                                  sort_i=nlist.i_sorted)
    return dataclasses.replace(nlist, pairs=pairs, did_overflow=overflow)


# ---------------------------------------------------------------------------
# cell list
# ---------------------------------------------------------------------------


def _cell_grid(box, cutoff):
    """Cells per axis, each at least ``cutoff`` wide."""
    if torch.is_tensor(box):
        box = profiling.host_sync("nl.cell_grid", torch.Tensor.cpu,
                                  box.detach())
    lengths = np.abs(np.diag(np.asarray(box, np.float64)))
    return tuple(int(c) for c in np.maximum((lengths // cutoff).astype(int), 1))


# The half stencil: the own cell (slot 0, deduplicated by i < j) and the 13
# displacements with (dx, dy, dz) lexicographically positive. Under the
# periodic wrap with >= 3 cells per axis each unordered cell pair is visited
# once, so every combination across two cells is a distinct pair.
_HALF_STENCIL = np.array(
    [[0, 0, 0]] + [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)],
    dtype=np.int64)  # (14, 3)

# per-row partner capacity of the two-stage compaction (water at rc = 4 has
# ~13 half-neighbours per atom on average and ~40 at most; overflow is
# reported)
_ROW_K = 64


def _cell_ids(positions, box, n_cells):
    ncx, ncy, ncz = n_cells
    frac = positions @ inv3x3(box)
    frac = frac - torch.floor(frac)
    cx = torch.clamp((frac[:, 0] * ncx).long(), max=ncx - 1)
    cy = torch.clamp((frac[:, 1] * ncy).long(), max=ncy - 1)
    cz = torch.clamp((frac[:, 2] * ncz).long(), max=ncz - 1)
    return (cx * ncy + cy) * ncz + cz


def _cell_candidates(positions, box, cutoff, n_cells, cell_capacity,
                     rows=None):
    """(good, cand, bucket_overflow): the (n, 14 cell_capacity) candidate
    partners of every atom from the half stencil and the mask of those that
    are real in-cutoff pairs, each counted once.

    Atoms are sorted into cell order; each cell's window of the sorted arrays
    fills one row of an id table and a coordinate table, and every cell
    gathers its 14 stencil rows once, so an atom takes one wide row of its
    cell. ``rows`` (m,): the i-atoms to take, in that order, instead of
    every atom; an entry n is a padding row with no partner."""
    n = positions.shape[0]
    dev = positions.device
    ncx, ncy, ncz = n_cells
    n_cell_total = ncx * ncy * ncz
    box_inv = inv3x3(box)
    cell_id = _cell_ids(positions, box, n_cells)
    order = torch.argsort(cell_id, stable=True)
    sorted_cells = cell_id[order]
    c_iota = torch.arange(n_cell_total, device=dev)
    starts = torch.searchsorted(sorted_cells, c_iota)
    counts = torch.searchsorted(sorted_cells, c_iota + 1) - starts
    bucket_overflow = torch.any(counts > cell_capacity)
    slots = torch.arange(cell_capacity, device=dev)
    take = torch.clamp(starts[:, None] + slots[None], max=n - 1)
    # slots past a cell's count alias the next cells' atoms: id n drops them
    ids = torch.where(slots[None] < counts[:, None], order[take],
                      torch.full_like(take, n))  # (ncell, cap)
    coords = positions[order][take]  # (ncell, cap, 3)

    cc = c_iota
    cell_xyz = torch.stack([cc // (ncy * ncz), (cc // ncz) % ncy, cc % ncz], -1)
    neigh = cell_xyz[:, None, :] + profiling.host_sync(
        "nl.stencil", torch.as_tensor, _HALF_STENCIL, device=dev)
    neigh_id = ((torch.remainder(neigh[..., 0], ncx) * ncy
                 + torch.remainder(neigh[..., 1], ncy)) * ncz
                + torch.remainder(neigh[..., 2], ncz))  # (ncell, 14)
    if rows is None:
        i_ids = torch.arange(n, device=dev)
        row_cell, row_pos = cell_id, positions
    else:
        r_safe = torch.clamp(rows, max=n - 1)
        i_ids, row_cell, row_pos = rows, cell_id[r_safe], positions[r_safe]
    cand = ids[neigh_id].reshape(n_cell_total, -1)[row_cell]  # (m, S)
    pts = coords[neigh_id].reshape(n_cell_total, -1, 3)[row_cell]  # (m, S, 3)
    dx = pts[..., 0] - row_pos[:, 0:1]
    dy = pts[..., 1] - row_pos[:, 1:2]
    dz = pts[..., 2] - row_pos[:, 2:3]
    s1 = dx * box_inv[0, 0] + dy * box_inv[1, 0] + dz * box_inv[2, 0]
    s2 = dx * box_inv[0, 1] + dy * box_inv[1, 1] + dz * box_inv[2, 1]
    s3 = dx * box_inv[0, 2] + dy * box_inv[1, 2] + dz * box_inv[2, 2]
    s1 = s1 - torch.floor(s1 + 0.5)
    s2 = s2 - torch.floor(s2 + 0.5)
    s3 = s3 - torch.floor(s3 + 0.5)
    wx = s1 * box[0, 0] + s2 * box[1, 0] + s3 * box[2, 0]
    wy = s1 * box[0, 1] + s2 * box[1, 1] + s3 * box[2, 1]
    wz = s1 * box[0, 2] + s2 * box[1, 2] + s3 * box[2, 2]
    r2 = wx * wx + wy * wy + wz * wz
    i_ids = i_ids[:, None]
    # own cell (the first cell_capacity slots): i < j; other cells: i != j
    own = (torch.arange(cand.shape[1], device=dev) < cell_capacity)[None]
    dedupe = torch.where(own, cand > i_ids, cand != i_ids)
    good = dedupe & (cand < n) & (i_ids < n) & (r2 < cutoff * cutoff)
    return good, cand, bucket_overflow


def _cell_pairs(positions, box, cutoff, n_cells, cell_capacity, capacity,
                sort_i=True):
    """(pairs (capacity, 2), overflow): the cell-list search at static
    shapes, compacted by ``_compact_rows``. Each pair comes out as
    (min, max); with ``sort_i`` one stable sort of the i column restores
    the global order that the swap broke (padding sorts last)."""
    n = positions.shape[0]
    good, cand, bucket_overflow = _cell_candidates(positions, box, cutoff,
                                                   n_cells, cell_capacity)
    pairs, overflow = _compact_rows(good, cand, n, capacity)
    if sort_i:
        pairs = pairs[torch.argsort(pairs[:, 0], stable=True)]
    return pairs, overflow | bucket_overflow


def _compact_rows(good, cand, n, capacity, rows=None):
    """(pairs (capacity, 2), overflow) of the candidate rows' good entries,
    row by row; row r's i-atom is ``rows[r]`` (r itself when None). Two
    stages: each row's partner ids, invalid slots set to n, are sorted and
    cut to _ROW_K; the rows then go to the flat list by their offsets
    (cumsum), the slot -> row map by a scatter of the row starts and a
    running maximum. Each pair comes out as (min, max), padding (n, n)."""
    dev = good.device
    m = good.shape[0]
    k_row = min(_ROW_K, cand.shape[1])
    rowcnt = good.sum(dim=1)
    n_found = rowcnt.sum()
    cj = torch.sort(torch.where(good, cand, torch.full_like(cand, n)),
                    dim=1).values[:, :k_row]
    offs = torch.cat([rowcnt.new_zeros(1), torch.cumsum(rowcnt, 0)])
    mark = torch.zeros(capacity, dtype=torch.long, device=dev).scatter_reduce(
        0, torch.clamp(offs[:-1], max=capacity - 1),
        torch.arange(m, device=dev), reduce="amax")
    r = torch.cummax(mark, 0).values
    p_iota = torch.arange(capacity, device=dev)
    k = p_iota - offs[r]
    valid = p_iota < offs[-1]
    r_safe = torch.clamp(r, max=m - 1)
    jj_raw = cj.reshape(-1)[r_safe * k_row + torch.clamp(k, 0, k_row - 1)]
    i_raw = r if rows is None else rows[r_safe]
    fill = torch.full_like(r, n)
    ii = torch.where(valid, torch.minimum(i_raw, jj_raw), fill)
    jj = torch.where(valid, torch.maximum(i_raw, jj_raw), fill)
    overflow = (n_found > capacity) | torch.any(rowcnt > k_row)
    return torch.stack([ii, jj], dim=-1), overflow


def _host_pair_count(positions, box, cutoff, n_cells) -> int:
    """The exact number of unordered in-cutoff pairs, in numpy on the host,
    by the half stencil: it sizes the capacity at allocation."""
    n = positions.shape[0]
    box_inv = np.linalg.inv(box)
    frac = positions @ box_inv
    frac -= np.floor(frac)
    ncx, ncy, ncz = n_cells
    cx, cy, cz = (np.minimum((frac[:, d] * nc).astype(np.int64), nc - 1)
                  for d, nc in enumerate(n_cells))
    cid = (cx * ncy + cy) * ncz + cz
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    counts = np.bincount(cid, minlength=ncx * ncy * ncz)
    cap = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    buckets = np.full((ncx * ncy * ncz, cap), n, dtype=np.int64)
    buckets[sorted_cid, np.arange(n) - starts[sorted_cid]] = order
    pos_pad = np.vstack([positions, np.zeros((1, 3))])
    my_cell = np.stack([cx, cy, cz], axis=-1)
    i_ids = np.arange(n)[:, None]
    total = 0
    for si, off in enumerate(_HALF_STENCIL):
        nb = my_cell + off[None, :]
        nid = ((nb[:, 0] % ncx) * ncy + nb[:, 1] % ncy) * ncz + nb[:, 2] % ncz
        cand = buckets[nid]
        s = (pos_pad[cand] - positions[:, None, :]) @ box_inv
        s -= np.floor(s + 0.5)
        w = s @ box
        r2 = np.einsum("nkc,nkc->nk", w, w)
        ok = (cand > i_ids) if si == 0 else (cand != i_ids)
        total += int((ok & (cand < n) & (r2 < cutoff * cutoff)).sum())
    return total


def neighbor_list_cell(positions, box, cutoff, capacity=None,
                       cell_capacity=None, padding=1.25, sort_i=True):
    """Allocate a cell list on the positions' device. Cells are at least
    ``cutoff`` wide; with fewer than 3 per axis the half stencil would visit
    a cell twice, and the dense list is returned instead.

    Without a ``cell_capacity`` it is sized from the largest cell
    occupancy, and without a ``capacity`` from the host pair count, with
    ``padding`` headroom, in buckets of max(1024, 2^(bits - 4)). An
    overflow doubles both and searches again, up to 8 times."""
    n_cells = _cell_grid(box, cutoff)
    if min(n_cells) < 3:
        return neighbor_list_dense(positions, box, cutoff, capacity, padding)
    pos_np = positions.detach().cpu().numpy().astype(np.float64)
    box_np = box.detach().cpu().numpy().astype(np.float64)
    if cell_capacity is None:
        frac = pos_np @ np.linalg.inv(box_np)
        frac -= np.floor(frac)
        cid = [np.minimum((frac[:, d] * n_cells[d]).astype(int), n_cells[d] - 1)
               for d in range(3)]
        flat = (cid[0] * n_cells[1] + cid[1]) * n_cells[2] + cid[2]
        max_occ = int(np.bincount(flat).max())
        cell_capacity = max(int(np.ceil(max_occ * padding)) + 2, 8)
    if capacity is None:
        want = int(_host_pair_count(pos_np, box_np, float(cutoff), n_cells)
                   * padding)
        bucket = max(1024, 1 << max(want.bit_length() - 4, 10))
        capacity = -(-want // bucket) * bucket
    with torch.no_grad():
        for _ in range(8):
            pairs, overflow = _cell_pairs(positions, box, cutoff, n_cells,
                                          cell_capacity, capacity, sort_i)
            if not bool(overflow):
                break
            cell_capacity *= 2
            capacity *= 2
    return NeighborList(pairs, overflow, capacity, float(cutoff),
                        i_sorted=bool(sort_i), n_cells=n_cells,
                        cell_capacity=cell_capacity)


# ---------------------------------------------------------------------------
# sharded (slab-decomposed) pair search
# ---------------------------------------------------------------------------


def sharded_cell_pairs(positions, box, cutoff, n_cells, cell_capacity,
                       capacity_per_device, group=None):
    """Cell-list pair search decomposed over the ranks of ``group``
    (admp_tpu/ops/neighborlist.py:529-643), run on every rank.

    Rank r owns a contiguous slab of cells along the leading cell axis and
    emits the pairs whose i-atom lies in it: a (capacity_per_device, 2)
    block, pairs (min, max) padded with (n, n), which concatenated over the
    ranks is the padded pair list the sharded energies take
    (parallel/sharded.py). Positions are replicated; the candidates are
    taken only for the slab's atoms, contiguous in cell-sorted order (cell
    ids sort by the leading axis first), so a rank's work scales as N/P.

    ``n_cells[0]`` must be divisible by the group's size. Returns
    (pairs_local, overflow), the flag summed over the ranks: a cell, the
    slab's atom capacity (2x the mean + 64), a row's partners or the block
    overflowed."""
    n = positions.shape[0]
    ncx, ncy, ncz = n_cells
    n_dev, rank = dist.get_world_size(group), dist.get_rank(group)
    if ncx % n_dev:
        raise ValueError(f"{ncx} cells along x do not divide over {n_dev} "
                         "ranks")
    slab_cx = ncx // n_dev
    slab_cap = -(-2 * n // n_dev // 8) * 8 + 64
    dev = positions.device
    with torch.no_grad():
        cell_id = _cell_ids(positions, box, n_cells)
        slab_of = torch.div(cell_id, ncy * ncz * slab_cx,
                            rounding_mode="floor")
        order = torch.argsort(cell_id, stable=True)
        start = torch.searchsorted(
            cell_id[order].contiguous(),
            torch.tensor([rank * slab_cx * ncy * ncz], device=dev))
        padded = torch.cat([order, torch.full((slab_cap,), n, device=dev)])
        ids = padded[start + torch.arange(slab_cap, device=dev)]
        in_slab = slab_of[torch.clamp(ids, max=n - 1)] == rank
        rows = torch.where((ids < n) & in_slab, ids, torch.full_like(ids, n))
        slab_overflow = torch.sum(slab_of == rank) > slab_cap
        good, cand, bucket_overflow = _cell_candidates(
            positions, box, cutoff, n_cells, cell_capacity, rows)
        pairs, overflow = _compact_rows(good, cand, n, capacity_per_device,
                                        rows)
        overflow = overflow | bucket_overflow | slab_overflow
    return pairs, comm.psum(overflow.to(torch.int32), group) > 0
