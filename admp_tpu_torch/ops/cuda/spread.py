"""PME spread (K4) and its adjoint gather (K6), in CUDA.

Replaces admp_tpu/ops/pallas/spread.py ``_make_spread_kernel`` (:210, via
``_make_spread_dma_kernel`` :349 and ``spread_blocks`` :537) and
``_make_gather_kernel`` (:890, via ``gather_blocks`` :1361), which on the
TPU at K3 % 128 == 0 hands over to the XLA row gather ``_row_gather_impl``
(:1291). Source: admp_tpu_torch/csrc/spread.cu.

The spread accumulates each atom's order^3 stencil values, for C channels,
onto the periodic (C, K1, K2, K3) mesh: one thread per (atom, stencil point),
one f32 atomicAdd per channel. The gather reads the cotangent mesh at the same
indices: exact, equal bit for bit to the plain gather. Neither has admp_tpu's
slab buckets, capacities or scatter fallback; atomics take their place. Bound
on the card by the atomic and memory traffic of N order^3 C values; the mesh
stays in L2.

``SpreadFn`` and ``GatherFn`` are each other's backward, as admp_tpu pairs
its custom_vjps (spread.py:1343-1397), so derivatives of any order stay on
the kernels.

The port's paths run them at (order 6, C=1) for the electrostatic energy
mesh and at (order 4 or 6, C=3) for the dispersion C6/C8/C10 mesh
(admp_tpu's ``spread_blocks_multi`` :629); ``launch_spread.by_shape`` and
``launch_gather.by_shape`` count the launches per (order, C).
"""

from __future__ import annotations

import ctypes

import torch

from admp_tpu_torch.ops.cuda import build, use_kernel

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

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("spread")
    if not getattr(lib, "_admp_typed", False):
        for fn in (lib.admp_spread, lib.admp_gather):
            fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
            fn.restype = _I
        lib._admp_typed = True
    return lib


def _check(m_u0, x, name, grid_shape, order):
    if order not in ORDERS:
        raise ValueError(f"order={order}: the kernel takes {ORDERS}")
    if len(grid_shape) != 3:
        raise ValueError(f"grid_shape {grid_shape}: three sizes")
    if (not m_u0.is_cuda or m_u0.dtype != torch.int32
            or not m_u0.is_contiguous() or m_u0.ndim != 2
            or m_u0.shape[1] != 3):
        raise ValueError("m_u0: needs a contiguous (N, 3) int32 CUDA tensor")
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous float32 CUDA tensor")
    if x.device != m_u0.device:
        raise ValueError(f"{name}: on {x.device}, m_u0 on {m_u0.device}")


def launch_spread(m_u0, q_points, grid_shape, order: int):
    """K4: (N, C, order^3) stencil values -> (C, K1, K2, K3) mesh."""
    _check(m_u0, q_points, "q_points", grid_shape, order)
    n, n_ch = q_points.shape[0], q_points.shape[1]
    if n_ch not in CHANNELS or tuple(q_points.shape) != (n, n_ch, order ** 3) \
            or m_u0.shape[0] != n:
        raise ValueError(f"q_points: shape {tuple(q_points.shape)}, expected "
                         f"(N, C in {CHANNELS}, {order ** 3})")
    mesh = torch.zeros((n_ch, *grid_shape), device=q_points.device,
                       dtype=torch.float32)
    if n == 0:
        return mesh
    status = _lib().admp_spread(
        m_u0.data_ptr(), q_points.data_ptr(), mesh.data_ptr(), n, n_ch, order,
        *grid_shape, torch.cuda.current_stream(mesh.device).cuda_stream)
    build.check(status, f"spread (order {order}, {n_ch} channels)")
    launch_spread.launches += 1
    launch_spread.by_shape[order, n_ch] += 1
    return mesh


launch_spread.launches = 0
launch_spread.by_shape = dict.fromkeys(SHAPES, 0)  # launches per (order, C)


def launch_gather(m_u0, mesh, grid_shape, order: int):
    """K6: (C, K1, K2, K3) mesh -> (N, C, order^3) stencil values."""
    _check(m_u0, mesh, "mesh", grid_shape, order)
    n_ch = mesh.shape[0]
    if n_ch not in CHANNELS or tuple(mesh.shape[1:]) != tuple(grid_shape):
        raise ValueError(f"mesh: shape {tuple(mesh.shape)}, expected "
                         f"(C in {CHANNELS}, {tuple(grid_shape)})")
    n = m_u0.shape[0]
    out = torch.empty((n, n_ch, order ** 3), device=mesh.device,
                      dtype=torch.float32)
    if n == 0:
        return out
    status = _lib().admp_gather(
        m_u0.data_ptr(), mesh.data_ptr(), out.data_ptr(), n, n_ch, order,
        *grid_shape, torch.cuda.current_stream(mesh.device).cuda_stream)
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


def spread(m_u0, q_points, grid_shape, order: int, method: str = "auto"):
    """(N, C, order^3) -> (C, K1, K2, K3): the kernel or the plain version,
    by ``method`` (see ops/cuda.use_kernel)."""
    grid_shape = tuple(int(k) for k in grid_shape)
    if use_kernel(method, q_points, "spread_method"):
        return SpreadFn.apply(m_u0.to(torch.int32).contiguous(),
                              q_points.contiguous(), grid_shape, order)
    return spread_torch(m_u0, q_points, grid_shape, order)
