"""PME spread (K4) and its adjoint gather (K6), and the tiled pair for large
meshes (K5, K7), in CUDA.

Replaces admp_tpu/ops/pallas/spread.py ``_make_spread_kernel`` (:210, via
``_make_spread_dma_kernel`` :349 and ``spread_blocks`` :537) and
``_make_gather_kernel`` (:890, via ``gather_blocks`` :1361), which on the
TPU at K3 % 128 == 0 hands over to the XLA row gather ``_row_gather_impl``
(:1291). Source: admp_tpu_torch/csrc/spread.cu.

Both work by stencil rows: one lane per row (atom, x, y) wraps the row once
for every channel, and each warp takes its rows' values in rounds of 32
consecutive values. The spread accumulates each atom's order^3 stencil
values, for C channels, onto the periodic (C, K1, K2, K3) mesh by f32
atomics (float4 windows of a row's values where K3 % 4 == 0), into a mesh
that its C entry zeroes on the stream first. The gather reads the
cotangent mesh at the same indices and writes its span of the output; it
is exact, equal bit for bit to the plain gather. Neither has admp_tpu's
slab buckets, capacities or scatter fallback; atomics take their place.
Bound on the card by the atomic and memory traffic of N order^3 C values;
the mesh stays in L2. At 3000 atoms a call's device work is shorter than a
PyTorch op's host work, so the launchers keep their own host work lean
(below).

``SpreadFn`` and ``GatherFn`` are each other's backward, as admp_tpu pairs
its custom_vjps (spread.py:1343-1397), so derivatives of any order stay on
the kernels.

The port's paths run them at (order 6, C=1) for the electrostatic energy
mesh and at (order 4 or 6, C=3) for the dispersion C6/C8/C10 mesh
(admp_tpu's ``spread_blocks_multi`` :629); ``launch_spread.by_shape`` and
``launch_gather.by_shape`` count the launches per (order, C). They serve the
meshes that fit the card's L2 cache; under 'auto' a larger order-6 mesh (the
98k-atom box at 256^3 and 320^3) goes to the tiled pair below instead
(ops/reciprocal.resolve_spread_method).

K5 and K7 (csrc/spread_tiled.cu) replace admp_tpu's 2-D blocked spread
``_pallas_spread2d_impl`` (:718) and its windowed gather
``_make_gather_kernel_mxu`` (:949). ``tile_bins`` bins the atoms by the mesh
tile of their wrapped base index, in plain PyTorch shared by the kernels and
their plain versions ``spread_tiled_torch`` / ``gather_tiled_torch``, which
accumulate and read per tile over the same bins. K5 is owner-computes: one
block per core tile stages the atoms whose bases lie in the tile's halo'd
window, from every source bin in one pass, with asynchronous copies into
shared memory, and sums them in a fixed order (no atomics, the same mesh on
every run). K7 reads the stencil rows of the sorted slots in bin order, one
lane per row as K6 reads an atom's, and writes each slot's values to its
atom's row; it reads the slot count from the offsets on the card. The
launchers refuse bins made for another order, tile or grid.
``SpreadTiledFn`` and ``GatherTiledFn`` are each other's backward
(admp_tpu's ``spread_blocks_2d_multi`` and ``gather_blocks_2d``,
:1400-1473); on a CPU tensor they take the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from admp_tpu_torch.ops.cuda import SPREAD_METHODS, build, use_kernel
from admp_tpu_torch.ops.cuda.entries import entry as _entry
from admp_tpu_torch.ops.cuda.entries import raw_stream as _raw_stream
from admp_tpu_torch.utils.devconst import device_values

ORDERS = (4, 6)
CHANNELS = (1, 3)
SHAPES = tuple((o, c) for o in ORDERS for c in CHANNELS)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def flat_stencil_indices(m_u0, grid_shape, order: int):
    """(N, order^3) flat periodic mesh indices of each atom's stencil, points
    ordered (x, y, z) with z fastest."""
    k1, k2, k3 = grid_shape
    m = m_u0.long()
    offsets = torch.arange(-(order // 2), order // 2, device=m.device)
    i1 = torch.remainder(m[:, 0:1] + offsets[None], k1)
    i2 = torch.remainder(m[:, 1:2] + offsets[None], k2)
    i3 = torch.remainder(m[:, 2:3] + offsets[None], k3)
    flat = (i1[:, :, None, None] * k2 + i2[:, None, :, None]) * k3 \
        + i3[:, None, None, :]
    return flat.reshape(m.shape[0], order ** 3)


def spread_torch(m_u0, q_points, grid_shape, order: int):
    """(N, C, order^3) stencil values -> (C, K1, K2, K3) mesh by index_add."""
    n, n_ch = q_points.shape[:2]
    kcube = grid_shape[0] * grid_shape[1] * grid_shape[2]
    flat = flat_stencil_indices(m_u0, grid_shape, order)
    idx = flat[None] + (torch.arange(n_ch, device=flat.device)
                        * kcube)[:, None, None]
    vals = q_points.transpose(0, 1)  # (C, N, order^3)
    mesh = q_points.new_zeros(n_ch * kcube)
    mesh = mesh.index_add(0, idx.reshape(-1), vals.reshape(-1))
    return mesh.reshape(n_ch, *grid_shape)


def gather_torch(m_u0, mesh, grid_shape, order: int):
    """(C, K1, K2, K3) mesh -> (N, C, order^3) values at each atom's stencil."""
    n_ch = mesh.shape[0]
    flat = flat_stencil_indices(m_u0, grid_shape, order)
    out = mesh.reshape(n_ch, -1)[:, flat]  # (C, N, order^3)
    return out.transpose(0, 1)


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------

# The launchers' host work is lean (ops/cuda/entries.py): one pass of checks
# (the error that names a failure is worked out only then, by _refusal); the
# C entry point and the raw current stream from entries; torch.empty with its
# sizes as arguments (K4's C entry zeroes its mesh on the stream, where
# torch.zeros would add a fill launch); the call; the counts. torch.empty
# and the C entry's call (ctypes and the launch) take about a third of the
# call each (PERF.md).

_P = ctypes.c_void_p
_F32, _I32 = torch.float32, torch.int32


def _fits(idx, x, dev, order):
    """Whether every spread kernel takes x and the bases ``idx`` as they
    are: order 4 or 6, x contiguous float32 on CUDA device ``dev``
    (x.get_device()), idx contiguous (N, 3) int32 on the same device."""
    return (dev >= 0 and order in ORDERS and x.dtype is _F32
            and idx.dtype is _I32 and x.is_contiguous()
            and idx.is_contiguous() and idx.shape[1:] == (3,)
            and idx.get_device() == dev)


def _refusal(idx, x, name, order, shape_error):
    """The ValueError that names the first thing a spread kernel cannot take,
    in the order: order, types, contiguity, shapes (the bases', then
    ``shape_error``, the launcher's own message or None), device."""
    if order not in ORDERS:
        return ValueError(f"order={order}: the kernels take {ORDERS}")
    if x.dtype != _F32:
        return ValueError(f"{name}: needs float32, got {x.dtype}")
    if idx.dtype != _I32:
        return ValueError(f"bases: need int32, got {idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        return ValueError(f"{name} and the bases: need contiguous tensors")
    if idx.ndim != 2 or idx.shape[1] != 3:
        return ValueError(f"bases: shape {tuple(idx.shape)}, expected (N, 3)")
    if shape_error:
        return ValueError(shape_error)
    if not x.is_cuda:
        return ValueError(f"{name}: needs a CUDA tensor, got {x.device}")
    return ValueError(f"{name}: on {x.device}, the bases on {idx.device}")


def _q_shape_error(q_points, idx, grid_shape, order):
    """None if q_points is (N, C in CHANNELS, order^3) beside N bases and the
    mesh has three sizes, else the message that says so."""
    shape = q_points.shape
    if (len(shape) == 3 and shape[1] in CHANNELS and shape[2] == order ** 3
            and idx.shape[:1] == shape[:1] and len(grid_shape) == 3):
        return None
    return (f"q_points: shape {tuple(shape)} beside {idx.shape[0]} bases, "
            f"expected (N, C in {CHANNELS}, {order ** 3}) and three mesh "
            f"sizes, got {grid_shape}")


def _mesh_shape_error(mesh, grid_shape):
    """None if mesh is (C in CHANNELS, *grid_shape), else the message."""
    shape = mesh.shape
    if (len(shape) == 4 and shape[0] in CHANNELS
            and shape[1:] == tuple(grid_shape)):
        return None
    return (f"mesh: shape {tuple(shape)}, expected (C in {CHANNELS}, "
            f"*{tuple(grid_shape)})")


def launch_spread(m_u0, q_points, grid_shape, order: int):
    """K4: (N, C, order^3) stencil values -> (C, K1, K2, K3) mesh. The C
    entry zeroes the mesh on the current stream, then launches K4 (at N = 0
    it only zeroes it)."""
    dev = q_points.get_device()
    shape_error = _q_shape_error(q_points, m_u0, grid_shape, order)
    if shape_error or not _fits(m_u0, q_points, dev, order):
        raise _refusal(m_u0, q_points, "q_points", order, shape_error)
    n, n_ch, _ = q_points.shape
    k1, k2, k3 = (int(k) for k in grid_shape)
    mesh = torch.empty(n_ch, k1, k2, k3, dtype=_F32, device=q_points.device)
    status = _entry("admp_spread")(
        _P(m_u0.data_ptr()), _P(q_points.data_ptr()), _P(mesh.data_ptr()), n,
        n_ch, order, k1, k2, k3, _P(_raw_stream(dev)))
    if status:
        build.check(status, f"spread (order {order}, {n_ch} channels)")
    if n:
        launch_spread.launches += 1
        launch_spread.by_shape[order, n_ch] += 1
    return mesh


launch_spread.launches = 0
launch_spread.by_shape = dict.fromkeys(SHAPES, 0)  # launches per (order, C)


def launch_gather(m_u0, mesh, grid_shape, order: int):
    """K6: (C, K1, K2, K3) mesh -> (N, C, order^3) stencil values."""
    dev = mesh.get_device()
    shape_error = _mesh_shape_error(mesh, grid_shape)
    if shape_error or not _fits(m_u0, mesh, dev, order):
        raise _refusal(m_u0, mesh, "mesh", order, shape_error)
    n_ch, k1, k2, k3 = mesh.shape
    n = m_u0.shape[0]
    out = torch.empty(n, n_ch, order ** 3, dtype=_F32, device=mesh.device)
    if n:
        status = _entry("admp_gather")(
            _P(m_u0.data_ptr()), _P(mesh.data_ptr()), _P(out.data_ptr()), n,
            n_ch, order, k1, k2, k3, _P(_raw_stream(dev)))
        if status:
            build.check(status, f"gather (order {order}, {n_ch} channels)")
        launch_gather.launches += 1
        launch_gather.by_shape[order, n_ch] += 1
    return out


launch_gather.launches = 0
launch_gather.by_shape = dict.fromkeys(SHAPES, 0)  # launches per (order, C)


class SpreadFn(torch.autograd.Function):
    """Spread on K4; its backward is GatherFn (K6)."""

    @staticmethod
    def forward(ctx, m_u0, q_points, grid_shape, order):
        ctx.save_for_backward(m_u0)
        ctx.grid_shape, ctx.order = grid_shape, order
        return launch_spread(m_u0, q_points, grid_shape, order)

    @staticmethod
    def backward(ctx, g_mesh):
        (m_u0,) = ctx.saved_tensors
        g_q = GatherFn.apply(m_u0, g_mesh.contiguous(), ctx.grid_shape,
                             ctx.order)
        return None, g_q, None, None


class GatherFn(torch.autograd.Function):
    """Gather on K6; its backward is SpreadFn (K4)."""

    @staticmethod
    def forward(ctx, m_u0, mesh, grid_shape, order):
        ctx.save_for_backward(m_u0)
        ctx.grid_shape, ctx.order = grid_shape, order
        return launch_gather(m_u0, mesh, grid_shape, order)

    @staticmethod
    def backward(ctx, g_out):
        (m_u0,) = ctx.saved_tensors
        g_mesh = SpreadFn.apply(m_u0, g_out.contiguous(), ctx.grid_shape,
                                ctx.order)
        return None, g_mesh, None, None




# ---------------------------------------------------------------------------
# The tiled pair (K5, K7): binning, plain versions, launchers
# ---------------------------------------------------------------------------

# core tile (x, y, z) of csrc/spread_tiled.cu; the kernels refuse another
TILE = (8, 8, 32)


class TileBins:
    """Atoms binned by the mesh tile of their wrapped base index.

    ``base`` (N, 3) int32: b = (m_u0 - order/2) mod K, in bin order;
    ``perm`` (N,) int32: the atom in each sorted slot (a stable sort, so
    atoms of one bin keep their order); ``offsets`` (n_tiles + 1,) int32:
    where each bin starts; ``n_tiles``: tiles per axis."""

    def __init__(self, base, perm, offsets, n_tiles, tile, order):
        self.base, self.perm, self.offsets = base, perm, offsets
        self.n_tiles, self.tile, self.order = n_tiles, tile, order


def tile_bins(m_u0, grid_shape, tile=TILE, order: int = 6) -> TileBins:
    """Bin atoms by the tile of their base index, wrapped as admp_tpu wraps
    it (spread.py:733-742); no capacity and no read-back."""
    dev = m_u0.device
    k = device_values(grid_shape, torch.int64, dev)
    t = device_values(tile, torch.int64, dev)
    base = torch.remainder(m_u0.long() - order // 2, k)
    nt = tuple(-(-kk // tt) for kk, tt in zip(grid_shape, tile))
    tb = torch.div(base, t, rounding_mode="floor")
    tid = (tb[:, 0] * nt[1] + tb[:, 1]) * nt[2] + tb[:, 2]
    tid_sorted, perm = torch.sort(tid, stable=True)
    offsets = torch.searchsorted(
        tid_sorted, torch.arange(nt[0] * nt[1] * nt[2] + 1, device=dev))
    return TileBins(base[perm].to(torch.int32).contiguous(),
                    perm.to(torch.int32), offsets.to(torch.int32), nt,
                    tuple(tile), order)


def _tile_windows(bins: TileBins, grid_shape):
    """(slot (N,), local (N, order^3), window (B, R), B) for the B bins that
    hold atoms: each sorted atom's bin slot, its stencil's flat offsets in
    a halo'd tile window of R = prod(tile + order - 1) points, and the
    periodic flat mesh index of every window point."""
    order, tile, nt = bins.order, bins.tile, bins.n_tiles
    dev = bins.base.device
    ext = [t + order - 1 for t in tile]
    base = bins.base.long()
    t = device_values(tile, torch.int64, dev)
    tb = torch.div(base, t, rounding_mode="floor")
    tid = (tb[:, 0] * nt[1] + tb[:, 1]) * nt[2] + tb[:, 2]
    tiles, slot = torch.unique_consecutive(tid, return_inverse=True)
    loc = base - tb * t  # (N, 3) in [0, tile)
    d = torch.arange(order, device=dev)
    l1, l2, l3 = (loc[:, a:a + 1] + d for a in range(3))
    local = ((l1[:, :, None, None] * ext[1] + l2[:, None, :, None]) * ext[2]
             + l3[:, None, None, :]).reshape(-1, order ** 3)
    c1 = torch.div(tiles, nt[1] * nt[2], rounding_mode="floor") * tile[0]
    c2 = torch.remainder(torch.div(tiles, nt[2], rounding_mode="floor"),
                         nt[1]) * tile[1]
    c3 = torch.remainder(tiles, nt[2]) * tile[2]
    k1, k2, k3 = grid_shape
    g1 = torch.remainder(c1[:, None] + torch.arange(ext[0], device=dev), k1)
    g2 = torch.remainder(c2[:, None] + torch.arange(ext[1], device=dev), k2)
    g3 = torch.remainder(c3[:, None] + torch.arange(ext[2], device=dev), k3)
    window = ((g1[:, :, None, None] * k2 + g2[:, None, :, None]) * k3
              + g3[:, None, None, :]).reshape(tiles.shape[0], -1)
    return slot, local, window


def spread_tiled_torch(bins: TileBins, q_points, grid_shape, order: int):
    """K5's plain version: each bin's stencil values accumulated into its
    halo'd tile window, the windows then folded onto the periodic mesh."""
    n, n_ch = q_points.shape[:2]
    kcube = grid_shape[0] * grid_shape[1] * grid_shape[2]
    mesh = q_points.new_zeros(n_ch, kcube)
    if n == 0:
        return mesh.reshape(n_ch, *grid_shape)
    slot, local, window = _tile_windows(bins, grid_shape)
    r = window.shape[1]
    flat = (slot[:, None] * r + local).reshape(-1)
    vals = q_points[bins.perm.long()].transpose(0, 1).reshape(n_ch, -1)
    acc = q_points.new_zeros(n_ch, window.numel()).index_add_(1, flat, vals)
    mesh = mesh.index_add_(1, window.reshape(-1), acc)
    return mesh.reshape(n_ch, *grid_shape)


def gather_tiled_torch(bins: TileBins, mesh, grid_shape, order: int):
    """K7's plain version: each bin's halo'd tile window staged from the
    mesh, each atom's order^3 values read there and put back in atom order
    (a pure selection, equal bit for bit to ``gather_torch``)."""
    n_ch = mesh.shape[0]
    n = bins.perm.shape[0]
    out = mesh.new_empty(n, n_ch, order ** 3)
    if n == 0:
        return out
    slot, local, window = _tile_windows(bins, grid_shape)
    staged = mesh.reshape(n_ch, -1)[:, window]  # (C, B, R)
    vals = staged.reshape(n_ch, -1)[:, slot[:, None] * window.shape[1] + local]
    out[bins.perm.long()] = vals.transpose(0, 1)
    return out


def _bins_grid_error(bins: TileBins, grid_shape):
    """None if the bins' shapes fit a launch on ``grid_shape`` (their tiles
    per axis, n_tiles + 1 offsets, a permutation as long as the bases), else
    the message. Shapes and Python ints only: no host sync."""
    nt = tuple(-(-int(k) // t) for k, t in zip(grid_shape, TILE))
    if bins.n_tiles != nt:
        return (f"bins made for {bins.n_tiles} tiles per axis; the grid "
                f"{tuple(grid_shape)} has {nt}")
    want = nt[0] * nt[1] * nt[2] + 1
    if bins.offsets.shape != (want,):
        return (f"bins: offsets of shape {tuple(bins.offsets.shape)}, "
                f"expected ({want},)")
    if bins.perm.shape != bins.base.shape[:1]:
        return (f"bins: perm of shape {tuple(bins.perm.shape)} beside "
                f"{bins.base.shape[0]} bases")
    return None


def _bins_fit(bins: TileBins, order, dev, grid_shape):
    """Whether the bins were made for this order, the kernels' tile and
    ``grid_shape``, with their permutation and offsets int32 on CUDA device
    ``dev``."""
    perm, offsets = bins.perm, bins.offsets
    return (bins.order == order and bins.tile == TILE
            and _bins_grid_error(bins, grid_shape) is None
            and perm.dtype is _I32 and offsets.dtype is _I32
            and perm.get_device() == dev and offsets.get_device() == dev)


def _bins_refusal(bins: TileBins, x, name, order, shape_error, grid_shape):
    """_refusal for a tiled launcher, after the bins' order and tile, then
    their fit to the grid."""
    if not (bins.order == order and bins.tile == TILE):
        return ValueError(f"bins of order {bins.order}, tile {bins.tile}; "
                          f"the kernel takes order {order}, tile {TILE}")
    grid_error = _bins_grid_error(bins, grid_shape)
    if grid_error:
        return ValueError(grid_error)
    if shape_error or not _fits(bins.base, x, x.get_device(), order):
        return _refusal(bins.base, x, name, order, shape_error)
    return ValueError("bins: int32 tensors on the mesh's device")


def launch_spread_tiled(bins: TileBins, q_points, grid_shape, order: int):
    """K5: (N, C, order^3) stencil values -> (C, K1, K2, K3) mesh."""
    dev = q_points.get_device()
    shape_error = _q_shape_error(q_points, bins.base, grid_shape, order)
    if shape_error or not (_fits(bins.base, q_points, dev, order)
                           and _bins_fit(bins, order, dev, grid_shape)):
        raise _bins_refusal(bins, q_points, "q_points", order, shape_error,
                            grid_shape)
    n_ch = q_points.shape[1]
    k1, k2, k3 = (int(k) for k in grid_shape)
    mesh = torch.empty(n_ch, k1, k2, k3, dtype=_F32, device=q_points.device)
    status = _entry("admp_spread_tiled")(
        _P(bins.base.data_ptr()), _P(bins.perm.data_ptr()),
        _P(bins.offsets.data_ptr()), _P(q_points.data_ptr()),
        _P(mesh.data_ptr()), n_ch, order, k1, k2, k3, *TILE,
        _P(_raw_stream(dev)))
    if status:
        build.check(status, f"tiled spread (order {order}, {n_ch} channels)")
    launch_spread_tiled.launches += 1
    launch_spread_tiled.by_shape[order, n_ch] += 1
    return mesh


launch_spread_tiled.launches = 0
launch_spread_tiled.by_shape = dict.fromkeys(SHAPES, 0)


def launch_gather_tiled(bins: TileBins, mesh, grid_shape, order: int):
    """K7: (C, K1, K2, K3) mesh -> (N, C, order^3) stencil values."""
    dev = mesh.get_device()
    shape_error = _mesh_shape_error(mesh, grid_shape)
    if shape_error or not (_fits(bins.base, mesh, dev, order)
                           and _bins_fit(bins, order, dev, grid_shape)):
        raise _bins_refusal(bins, mesh, "mesh", order, shape_error,
                            grid_shape)
    n_ch, k1, k2, k3 = mesh.shape
    n = bins.base.shape[0]
    out = torch.empty(n, n_ch, order ** 3, dtype=_F32, device=mesh.device)
    if n:
        status = _entry("admp_gather_tiled")(
            _P(bins.base.data_ptr()), _P(bins.perm.data_ptr()),
            _P(bins.offsets.data_ptr()), _P(mesh.data_ptr()),
            _P(out.data_ptr()), n_ch, order, k1, k2, k3, *TILE,
            _P(_raw_stream(dev)))
        if status:
            build.check(status,
                        f"tiled gather (order {order}, {n_ch} channels)")
        launch_gather_tiled.launches += 1
        launch_gather_tiled.by_shape[order, n_ch] += 1
    return out


launch_gather_tiled.launches = 0
launch_gather_tiled.by_shape = dict.fromkeys(SHAPES, 0)


class SpreadTiledFn(torch.autograd.Function):
    """Spread on K5 (its plain version for a CPU tensor); its backward is
    GatherTiledFn over the same bins."""

    @staticmethod
    def forward(ctx, q_points, bins, grid_shape, order):
        ctx.bins, ctx.grid_shape, ctx.order = bins, grid_shape, order
        if q_points.is_cuda:
            return launch_spread_tiled(bins, q_points, grid_shape, order)
        return spread_tiled_torch(bins, q_points, grid_shape, order)

    @staticmethod
    def backward(ctx, g_mesh):
        g_q = GatherTiledFn.apply(g_mesh.contiguous(), ctx.bins,
                                  ctx.grid_shape, ctx.order)
        return g_q, None, None, None


class GatherTiledFn(torch.autograd.Function):
    """Gather on K7 (its plain version for a CPU tensor); its backward is
    SpreadTiledFn over the same bins."""

    @staticmethod
    def forward(ctx, mesh, bins, grid_shape, order):
        ctx.bins, ctx.grid_shape, ctx.order = bins, grid_shape, order
        if mesh.is_cuda:
            return launch_gather_tiled(bins, mesh, grid_shape, order)
        return gather_tiled_torch(bins, mesh, grid_shape, order)

    @staticmethod
    def backward(ctx, g_out):
        g_mesh = SpreadTiledFn.apply(g_out.contiguous(), ctx.bins,
                                     ctx.grid_shape, ctx.order)
        return g_mesh, None, None, None


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def spread_route(m_u0, q_points, grid_shape, order: int, route: str):
    """(N, C, order^3) -> (C, K1, K2, K3) on a resolved route: ``'cuda'``
    (K4/K6), ``'cuda2d'`` (K5/K7 on a CUDA tensor, their plain versions on
    a CPU one) or ``'torch'`` (``index_add_``)."""
    grid_shape = tuple(int(k) for k in grid_shape)
    if route == "cuda":
        return SpreadFn.apply(m_u0.to(torch.int32).contiguous(),
                              q_points.contiguous(), grid_shape, order)
    if route == "cuda2d":
        bins = tile_bins(m_u0, grid_shape, TILE, order)
        return SpreadTiledFn.apply(q_points.contiguous(), bins, grid_shape,
                                   order)
    if route == "torch":
        return spread_torch(m_u0, q_points, grid_shape, order)
    raise ValueError(f"route={route!r}: 'cuda', 'cuda2d' or 'torch'")


def spread(m_u0, q_points, grid_shape, order: int, method: str = "auto"):
    """(N, C, order^3) -> (C, K1, K2, K3) by ``method`` (ops/cuda.use_kernel):
    ``'auto'`` takes K4 for a float32 CUDA tensor, ``'cuda'`` K4,
    ``'cuda2d'`` K5, ``'torch'`` the plain version."""
    if not use_kernel(method, q_points, "spread_method", SPREAD_METHODS):
        return spread_route(m_u0, q_points, grid_shape, order, "torch")
    return spread_route(m_u0, q_points, grid_shape, order,
                        "cuda2d" if method == "cuda2d" else "cuda")
