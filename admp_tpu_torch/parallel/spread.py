"""Distributed B-spline spreading with halo exchange at slab boundaries
(admp_tpu/parallel/spread.py).

The spread is domain-decomposed over the mesh's leading axis. Rank r owns
the x-rows [r K1/P, (r+1) K1/P) and the atom block [r N/P, (r+1) N/P):

1. each rank evaluates its atoms' spread payload: the base mesh index, the
   fractional offsets u0 and the separable-term coefficients alpha
   (ops/reciprocal.atom_spread_alpha), a few scalars per atom, not the
   order^3 stencil;
2. atoms are binned by the slab that owns their base x-row and sent there
   with one fixed-capacity all_to_all per payload type;
3. each rank evaluates the stencils of the atoms it received and
   accumulates them into its (K1/P + order-1, K2, K3) slab, the only
   grid-sized allocation;
4. the (order-1)-row halo is folded into the next rank on the ring with
   ppermute (ceil((order-1)/(K1/P)) hops when slabs are narrower than the
   stencil); the ring is the periodic x-wrap.

Gradients run back through the same collectives (utils/comm.py), and the
spread's backward is the gather at the same indices.

The single-channel slab spread runs on the port's K4 (ops/cuda/spread.py,
``SpreadFn``; its backward K6) for float32 CUDA tensors, as admp_tpu's runs
its Pallas slab kernel: its stencil x-rows are slab-relative and never pass
width + halo - 1, so a periodic spread onto a (width + halo, K2, K3) grid,
fed the synthetic m_u0' = base + order/2, is the non-periodic halo-buffer
scatter. The multi-channel (dispersion) spread is ``index_add_``, as it is
an XLA scatter in admp_tpu. admp_tpu's TPU-only parts stay behind: the VMEM
picker ``_pallas_spread_slabs``, the kernel's slab buckets and their
``_cap_scale``, and the scatter fallback on bucket overflow; K4 has no
buckets.

Capacity: the per-(source, target) bin holds min(n_loc, ceil(n_loc x
cap_factor / P) + 8) atoms. A denser bin cannot be taken without a host read
inside the step, so it poisons the slab with NaN and raises the returned
flag, as in admp_tpu: the energy and forces go NaN, loudly. Liquids are
near-uniform in x; an atom order that is not spatially spread (a lattice in
x-major order) needs ``cap_factor = P``, where the cap reaches n_loc.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from admp_tpu_torch.ops import bsplines
from admp_tpu_torch.ops.cuda import SPREAD_METHODS, spread as spread_ops
from admp_tpu_torch.ops.cuda import use_kernel
from admp_tpu_torch.ops.reciprocal import (
    atom_spread_alpha,
    mesh_coordinates,
    spread_points_separable,
)
from admp_tpu_torch.utils.comm import all_to_all, ppermute, psum


def _bin_by_slab(owner, n_dev: int, cap: int):
    """Group local atom indices by target slab: (P, cap) gather indices, a
    validity mask, and an overflow flag (any bin denser than cap)."""
    n = owner.shape[0]
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order].contiguous()
    dev_iota = torch.arange(n_dev, dtype=owner.dtype, device=owner.device)
    starts = torch.searchsorted(sorted_owner, dev_iota)
    ends = torch.searchsorted(sorted_owner, dev_iota + 1)
    overflow = torch.any(ends - starts > cap)
    take = starts[:, None] + torch.arange(cap, device=owner.device)[None, :]
    valid = take < ends[:, None]
    take = torch.clamp(take, max=n - 1)
    return order[take], valid, overflow


def _halo_fold(buf, width: int, halo: int, group, axis: int = 0):
    """Fold the halo rows [width, width + halo) of ``axis`` into the next
    rank's rows [0, halo): a ppermute by +1, admp_tpu's ring
    [(i, i + 1 mod P)] (its ``_ring_perm``). When slabs are narrower than
    the stencil (width < halo) one hop leaves residual halo, so fold
    ceil(halo / width) times; the ring wrap makes the x-periodicity
    exact."""
    n_folds = -(-halo // max(width, 1))
    for _ in range(n_folds):
        tail = buf.narrow(axis, width, halo)
        recv = ppermute(tail.movedim(axis, 0), 1, group).movedim(0, axis)
        head = buf.narrow(axis, 0, width)
        buf = torch.cat([head, torch.zeros_like(tail)], dim=axis)
        buf = torch.cat([buf.narrow(axis, 0, halo) + recv,
                         buf.narrow(axis, halo, width)], dim=axis)
    return buf


def _local_slab_spread(base_r, q_points, dev, width, halo, k2, k3, order,
                       spread_method):
    """Accumulate the received stencil values into this rank's halo-padded
    (width + halo, k2, k3) slab: K4 for float32 CUDA tensors under 'auto'
    (forced by 'cuda' and 'cuda2d': a halo slab is never tiled),
    ``index_add_`` under 'torch' and for any other tensor under 'auto'."""
    half = order // 2
    lx = base_r[:, 0] - dev * width
    m_u0_slab = torch.stack([lx + half, base_r[:, 1] + half,
                             base_r[:, 2] + half], dim=-1)
    method = "cuda" if spread_method == "cuda2d" else spread_method
    route = ("cuda" if use_kernel(method, q_points, "spread_method",
                                  SPREAD_METHODS) else "torch")
    grid = (width + halo, int(k2), int(k3))
    q = q_points.reshape(q_points.shape[0], 1, order ** 3)
    return spread_ops.spread_route(m_u0_slab, q, grid, order, route)[0]


def _redistribute(grid_shape, order, n_dev, cap_factor, group, m_u0,
                  floats):
    """Bin this rank's atoms by owner slab and exchange them: returns
    (base_r (P cap, 3) int32 received base indices, floats_r (P cap, F)
    received float payload, overflow flag, replicated)."""
    k1, k2, k3 = (int(k) for k in grid_shape)
    half = order // 2
    width = k1 // n_dev
    n_loc = m_u0.shape[0]
    base = torch.stack([torch.remainder(m_u0[:, 0] - half, k1),
                        torch.remainder(m_u0[:, 1] - half, k2),
                        torch.remainder(m_u0[:, 2] - half, k3)],
                       dim=-1).to(torch.int32)
    owner = torch.div(base[:, 0], width, rounding_mode="floor")
    cap = min(n_loc, int(-(-n_loc * cap_factor // n_dev)) + 8)
    take, valid, overflow = _bin_by_slab(owner, n_dev, cap)
    overflow = psum(overflow.to(torch.int32), group) > 0

    vmask = valid[..., None]
    # index_select: its backward is index_add_ (an index's backward is an
    # index_put that sorts its indices, ~150 ms at 98k atoms on the card)
    flat = take.reshape(-1)
    floats_b = floats.index_select(0, flat).reshape(n_dev, cap, -1)
    base_b = base.index_select(0, flat).reshape(n_dev, cap, 3)
    floats_b = torch.where(vmask, floats_b, torch.zeros_like(floats_b))
    base_b = torch.where(vmask, base_b, torch.zeros_like(base_b))
    # invalid rows get an owner-consistent x spread over the slab's rows, so
    # their zero-weight stencils stay inside the destination slab
    dev_ids = torch.arange(n_dev, dtype=torch.int32, device=base.device)
    slot = torch.arange(cap, dtype=torch.int32, device=base.device)
    pad_x = dev_ids[:, None] * width + slot[None, :] % width
    base_b = torch.cat([torch.where(valid, base_b[..., 0], pad_x)[..., None],
                        base_b[..., 1:]], dim=-1)
    floats_r = all_to_all(floats_b, 0, 0, group).reshape(n_dev * cap, -1)
    base_r = all_to_all(base_b, 0, 0, group).reshape(n_dev * cap, 3)
    return base_r, floats_r, overflow


def _poison(slab, overflow):
    return torch.where(overflow, torch.full_like(slab, float("nan")), slab)


def sharded_spread_halo(positions, box, q_harm, grid_shape, lmax: int,
                        group=None, order: int = 6, cap_factor: float = 3.0,
                        precision: str | None = None,
                        spread_method: str = "auto"):
    """Halo-exchange spread of harmonic multipoles, run on every rank of
    ``group``.

    positions, q_harm: the full replicated arrays; this rank spreads the
    atom block [r N/P, (r+1) N/P). A caller that differentiates through
    them passes them (and the box) through ``comm.pvary`` first, as the
    sharded energies do, so the backward sums the ranks' parts.
    grid_shape: (K1, K2, K3) with K1 % P == 0.
    spread_method: the slab spread's route (``_local_slab_spread``).

    Returns (slab, overflow): this rank's (K1/P, K2, K3) slab (the layout
    parallel/fft.rfft3d_pencil takes) and a replicated bool tensor; when it
    is True the slab is NaN (a bin held more than its capacity: raise
    ``cap_factor``)."""
    k1, k2, k3 = (int(k) for k in grid_shape)
    n_dev, dev = dist.get_world_size(group), dist.get_rank(group)
    width = k1 // n_dev
    halo = order - 1
    n_loc = positions.shape[0] // n_dev
    pos_loc = positions[dev * n_loc:(dev + 1) * n_loc]
    q_loc = q_harm[dev * n_loc:(dev + 1) * n_loc]

    m_u0, u0, alpha = atom_spread_alpha(pos_loc, box, q_loc, grid_shape,
                                        lmax, order, precision)
    # one float payload per atom: u0 (3) and alpha (T), one all_to_all
    base_r, payload, overflow = _redistribute(
        grid_shape, order, n_dev, cap_factor, group, m_u0,
        torch.cat([u0, alpha.to(u0.dtype)], dim=-1))
    q_points = spread_points_separable(payload[:, :3], payload[:, 3:], lmax,
                                       order).to(q_harm.dtype)
    buf = _local_slab_spread(base_r, q_points, dev, width, halo, k2, k3,
                             order, spread_method)
    buf = _halo_fold(buf, width, halo, group)
    return _poison(buf[:width], overflow), overflow


def sharded_spread_halo_multi(positions, box, coeffs, grid_shape,
                              group=None, order: int = 6,
                              cap_factor: float = 3.0):
    """Multi-channel (lmax 0) halo-exchange spread: the C6/C8/C10
    dispersion coefficients (N, C) share one redistribution and one stencil
    geometry; ``index_add_``, as admp_tpu's XLA scatter.

    Returns ((C, K1/P, K2, K3) slab, overflow), channel axis leading, the
    layout the pencil FFT takes channel by channel."""
    k1, k2, k3 = (int(k) for k in grid_shape)
    n_dev, dev = dist.get_world_size(group), dist.get_rank(group)
    width = k1 // n_dev
    halo = order - 1
    half = order // 2
    n_loc = positions.shape[0] // n_dev
    n_ch = coeffs.shape[-1]
    pos_loc = positions[dev * n_loc:(dev + 1) * n_loc]
    c_loc = coeffs[dev * n_loc:(dev + 1) * n_loc]

    m_u0, u0, _ = mesh_coordinates(pos_loc, box, grid_shape, order)
    base_r, payload, overflow = _redistribute(
        grid_shape, order, n_dev, cap_factor, group, m_u0,
        torch.cat([u0, c_loc.to(u0.dtype)], dim=-1))
    u0_r, c_r = payload[:, :3], payload[:, 3:]
    a = u0_r.shape[0]
    m = bsplines.spline_values(u0_r, order)
    txy = (m[:, :, None, 0] * m[:, None, :, 1]).reshape(a, order * order)
    theta = (txy[:, :, None] * m[:, None, :, 2]).reshape(a, order ** 3)
    lx = base_r[:, 0] - dev * width
    m_u0_slab = torch.stack([lx + half, base_r[:, 1] + half,
                             base_r[:, 2] + half], dim=-1)
    buf = spread_ops.spread_torch(
        m_u0_slab, theta[:, None, :] * c_r[:, :, None].to(theta.dtype),
        (width + halo, k2, k3), order)
    # one ppermute per hop moves all channels
    buf = _halo_fold(buf, width, halo, group, axis=1)
    return _poison(buf[:, :width], overflow), overflow
