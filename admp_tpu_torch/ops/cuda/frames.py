"""Local frames and the rotation of the multipoles into them (K8), in CUDA.

Replaces, on the card, the plain chain of ``ops/frames.global_multipoles``:
``local_frames_components`` and ``rot_local2global_components``
(admp_tpu/ops/frames.py and ops/harmonics.py; admp_tpu has no Pallas kernel
here, XLA fuses the chain on the TPU). Source: admp_tpu_torch/csrc/frames.cu.

Run op by op on the card, the chain is ~360 launches over every site in the
forward and as many again in autograd's backward, and the backward of its
anchor gathers (``positions[at]``) is a deterministic index-put that adds
duplicate rows one after another. Every site without a y anchor stores -1,
which the chain wraps to site n-1 and gathers for all sites, so the
backward adds N zero rows into that one row: 17 ms a step on the 98,304-site
box. K8 is one thread per site: the forward reads the site's position, its
axis type and only the anchors that type uses, builds the frame in
registers (each thread inverts the box, as ``inv3x3`` does) and writes the
(N, (lmax + 1)^2) global multipoles; the backward recomputes the frame and
runs its reverse by hand into the gradients of the local multipoles, of the
positions (atomics: the summation order varies from run to run) and of the
box, with the part through its inverse folded in (per thread block, summed
here in a fixed order, as the pair kernels return their scalars). Built
without FMA contraction and taking the chain's operations in their order,
the forward is the plain float32 chain's result on the card bit for bit.

Autograd: ``FramesFn`` (forward ``frames_fwd``) has the backward
``FramesBwdFn`` (forward ``frames_bwd``), whose own backward recomputes the
plain chain and differentiates its VJP (``frames_vjp_torch``), so the layer
is differentiable to any order, as force matching needs; only the fitting
path runs that recomputation. The launchers keep their host work lean, as
the pair and spread launchers do (ops/cuda/entries.py), and count each
launch (``launches``, and the counter ``frames.kernel`` while a profiler
records).
"""

from __future__ import annotations

import ctypes

import torch

from admp_tpu_torch.ops.cuda import build
from admp_tpu_torch.ops.cuda.entries import entry as _entry
from admp_tpu_torch.ops.cuda.entries import raw_stream as _raw_stream
from admp_tpu_torch.ops.harmonics import rot_local2global_components
from admp_tpu_torch.utils import profiling

N_BOX = 9  # the box's gradient

_P = ctypes.c_void_p
_F32 = torch.float32
_I64 = torch.int64
_block_size = []  # sites per thread block, read from the library once


# ---------------------------------------------------------------------------
# Plain PyTorch version of the backward, and of its backward
# ---------------------------------------------------------------------------


def global_multipoles_torch(positions, box, q_local, axis_types,
                            axis_indices, lmax: int):
    """The plain chain K8 replaces: ``rot_local2global_components`` of
    ``local_frames_components``."""
    from admp_tpu_torch.ops.frames import local_frames_components

    frames = local_frames_components(positions, box, axis_types, axis_indices)
    return rot_local2global_components(q_local, frames, lmax)


def _leaves(tensors):
    """Inputs to differentiate the recomputed chain at: a view of each
    tensor that carries gradients (its history stays attached, so the
    result is differentiable again, and no path from the recomputation
    leads into the graph the tensor came from), a new leaf of the others."""
    return [t.view_as(t) if t.requires_grad else t.detach().requires_grad_(True)
            for t in tensors]


def frames_vjp_torch(g, positions, box, q_local, axis_types, axis_indices,
                     lmax: int, create_graph: bool = False):
    """Plain version of K8's backward: the gradients of sum(g * q_global)
    with respect to (positions, box, q_local), by autograd of the plain
    chain (None where one has no path to the output)."""
    with torch.enable_grad():
        xs = _leaves((positions, box, q_local))
        out = global_multipoles_torch(*xs, axis_types, axis_indices, lmax)
        return torch.autograd.grad(out, xs, grad_outputs=g,
                                   create_graph=create_graph,
                                   allow_unused=True)


def frames_vjp_vjp_torch(g, positions, box, q_local, axis_types,
                         axis_indices, lmax: int, h_pos, h_box, h_q):
    """The VJP of ``frames_vjp_torch``'s outputs at cotangents (h_pos,
    h_box, h_q), any of them None: the cotangents of (g, positions, box,
    q_local), None where there is none. Differentiable again when grad mode
    is on (a backward asked for a graph)."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = _leaves((g, positions, box, q_local))
        firsts = frames_vjp_torch(*xs, axis_types, axis_indices, lmax,
                                  create_graph=True)
        terms = [(f * h).sum() for f, h in zip(firsts, (h_pos, h_box, h_q))
                 if f is not None and h is not None]
        if not terms:
            return (None,) * 4
        return torch.autograd.grad(sum(terms), xs, create_graph=create,
                                   allow_unused=True)


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------


def _fits(dev, n, lmax, tensors):
    """Whether the kernels take the inputs as they are: lmax 0..2 and
    ``tensors`` ((tensor, shape, dtype)) contiguous, of their shapes and
    dtypes, on CUDA device ``dev`` (positions.get_device())."""
    if not 0 <= lmax <= 2 or dev < 0:
        return False
    return all(t.dtype is dt and t.shape == shape and t.is_contiguous()
               and t.get_device() == dev for t, shape, dt in tensors)


def _refuse(positions, lmax, tensors):
    """Raise the ValueError that names the first thing the kernels cannot
    take in ``tensors`` (``_inputs``)."""
    if not 0 <= lmax <= 2:
        raise ValueError(f"lmax={lmax}: the kernel takes 0..2")
    for name, (t, shape, dt) in zip(_NAMES, tensors):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous {dt} CUDA tensor")
        if t.device != positions.device:
            raise ValueError(f"{name}: on {t.device}, positions on "
                             f"{positions.device}")
    raise ValueError(f"frames inputs (lmax={lmax}): not taken")


_NAMES = ("positions", "box", "q_local", "axis_types", "axis_indices", "g")


def _inputs(positions, box, q_local, axis_types, axis_indices, lmax, *g):
    n, h = positions.shape[0], (lmax + 1) ** 2
    return ((positions, (n, 3), _F32), (box, (3, 3), _F32),
            (q_local, (n, h), _F32),
            (axis_types, (n,), _I64), (axis_indices, (n, 3), _I64),
            *((t, (n, h), _F32) for t in g))


def launch_frames_fwd(positions, box, q_local, axis_types, axis_indices,
                      lmax: int):
    """K8's forward: the (N, (lmax + 1)^2) global multipoles."""
    dev = positions.get_device()
    n = positions.shape[0]
    ins = _inputs(positions, box, q_local, axis_types, axis_indices, lmax)
    if not _fits(dev, n, lmax, ins):
        _refuse(positions, lmax, ins)
    out = torch.empty((n, (lmax + 1) ** 2), dtype=_F32,
                      device=positions.device)
    status = _entry("admp_frames_fwd")(
        *(_P(t.data_ptr()) for t in (positions, box, q_local, axis_types,
                                     axis_indices, out)),
        n, lmax, _P(_raw_stream(dev)))
    if status:
        build.check(status, f"frames forward (lmax={lmax})")
    launch_frames_fwd.launches += 1
    profiling.count("frames.kernel")
    return out


launch_frames_fwd.launches = 0


def launch_frames_bwd(positions, box, q_local, axis_types, axis_indices, g,
                      lmax: int, want_pos=True, want_box=True, want_q=True):
    """K8's backward at the cotangent ``g`` of the global multipoles:
    (d_positions, d_box, d_q_local), each None unless asked for."""
    dev = positions.get_device()
    n = positions.shape[0]
    ins = _inputs(positions, box, q_local, axis_types, axis_indices, lmax, g)
    if not _fits(dev, n, lmax, ins):
        _refuse(positions, lmax, ins)
    d_pos = torch.empty_like(positions) if want_pos else None
    d_q = torch.empty_like(q_local) if want_q else None
    blocks = None
    if want_box:
        if not _block_size:
            _block_size.append(_entry("admp_frames_block_size")())
        blocks = torch.empty((-(-n // _block_size[0]), N_BOX), dtype=_F32,
                             device=positions.device)
    status = _entry("admp_frames_bwd")(
        *(_P(t.data_ptr()) for t in (positions, box, q_local, axis_types,
                                     axis_indices, g)),
        *(_P(None if t is None else t.data_ptr())
          for t in (d_pos, d_q, blocks)),
        n, lmax, _P(_raw_stream(dev)))
    if status:
        build.check(status, f"frames backward (lmax={lmax})")
    launch_frames_bwd.launches += 1
    profiling.count("frames.kernel")
    # the blocks' sums in a fixed order: deterministic
    d_box = None if blocks is None else blocks.sum(dim=0).view(3, 3)
    return d_pos, d_box, d_q


launch_frames_bwd.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class FramesBwdFn(torch.autograd.Function):
    """K8's backward as a differentiable function of (g, positions, box,
    q_local): its backward recomputes the plain chain and differentiates
    its VJP (``frames_vjp_vjp_torch``)."""

    @staticmethod
    def forward(ctx, g, positions, box, q_local, axis_types, axis_indices,
                lmax, wants):
        ctx.save_for_backward(g, positions, box, q_local, axis_types,
                              axis_indices)
        ctx.lmax = lmax
        ctx.set_materialize_grads(False)
        g = g if g.is_contiguous() else g.contiguous()
        return launch_frames_bwd(positions, box, q_local, axis_types,
                                 axis_indices, g, lmax, *wants)

    @staticmethod
    def backward(ctx, h_pos, h_box, h_q):
        *x, axis_types, axis_indices = ctx.saved_tensors
        return (*frames_vjp_vjp_torch(*x, axis_types, axis_indices, ctx.lmax,
                                      h_pos, h_box, h_q),
                None, None, None, None)


class FramesFn(torch.autograd.Function):
    """The global multipoles on K8: forward ``frames_fwd``, backward
    ``FramesBwdFn`` (``frames_bwd``), which returns only the gradients
    asked for."""

    @staticmethod
    def forward(ctx, positions, box, q_local, axis_types, axis_indices, lmax):
        ctx.save_for_backward(positions, box, q_local, axis_types,
                              axis_indices)
        ctx.lmax = lmax
        return launch_frames_fwd(positions, box, q_local, axis_types,
                                 axis_indices, lmax)

    @staticmethod
    def backward(ctx, g):
        d_pos, d_box, d_q = FramesBwdFn.apply(
            g, *ctx.saved_tensors, ctx.lmax, ctx.needs_input_grad[:3])
        return d_pos, d_box, d_q, None, None, None


def _index(t, device):
    """An index tensor as K8 reads it: contiguous int64 on ``device``."""
    if t.dtype is not _I64 or t.device != device or not t.is_contiguous():
        t = t.to(device=device, dtype=_I64).contiguous()
    return t


def kernel_global_multipoles(positions, box, q_local, axis_types,
                             axis_indices, lmax: int):
    """``ops/frames.global_multipoles`` on K8 (float32 CUDA tensors)."""
    h = (lmax + 1) ** 2
    if q_local.shape[-1] != h:
        q_local = q_local[:, :h]
    dev = positions.device
    return FramesFn.apply(
        positions.contiguous(), box.contiguous(), q_local.contiguous(),
        _index(axis_types, dev), _index(axis_indices, dev), lmax)
