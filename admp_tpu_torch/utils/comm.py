"""Collectives of the sharded layer on torch.distributed, and their byte
tally (admp_tpu/utils/comm.py).

Every rank of a process group runs the same program on its own share of the
work (SPMD). A tensor is *replicated* over the group when every rank holds
the same value of one logical quantity (the positions, the total energy), and
*varying* when each rank holds its own part (the energy of its pair block,
its slab of the mesh). The collectives move values between the two, each a
``torch.autograd.Function`` whose backward is its transpose, itself a
collective, so derivatives of any order (the exact implicit adjoint
differentiates a gradient) run across the ranks:

  psum        varying -> replicated, all_reduce;   backward: pvary
  pvary       replicated -> varying, identity;     backward: psum
  all_to_all  varying -> varying, tiled;           backward: the reverse one
  ppermute    varying -> varying, ring shift;      backward: the inverse shift
  all_gather  varying -> replicated, tiled;        backward: this rank's block

These are JAX's rules for shard_map. The sharded energies of
parallel/sharded.py pass every replicated input through ``pvary`` where it
enters a rank's own work and sum the ranks' parts with ``psum``; the terms
every rank computes whole (self energies, the polarization penalty) stay
outside both, so their gradients are counted once. (The backward of
``torch.distributed.nn.functional.all_reduce`` all-reduces the cotangent: on
a replicated total it counts the gradient once per rank.)

The tally: admp_tpu walks a traced jaxpr (comm.py:76-124); the port has no
trace, so it counts at these wrappers, forward and backward alike: the bytes
entering each collective on this rank, under admp_tpu's primitive names.
Inside ``CommTally.loop_iteration()`` (one PCG matvec) they go to the
per-iteration tally. Every call is counted, those of a convergence check
too (admp_tpu's walker skips a while loop's condition, comm.py:91).

Backends: NCCL, and gloo with CPU or CUDA tensors (several ranks on one
card, which NCCL refuses). ``ppermute`` is an ``all_to_all_single`` with one
nonzero split, which both backends take for CUDA tensors where gloo's
send/recv takes CPU tensors only. Complex tensors travel as their real
views.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

# the tallies recording now (CommTally.recording); a module-level stack, not
# a context variable, because autograd runs CUDA backwards on its own thread
_RECORDING: list = []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _count(prim: str, nbytes: int) -> None:
    for tally in _RECORDING:
        tally.add(prim, nbytes)


class CommTally:
    """Bytes entering each collective on this rank: ``static`` outside any
    loop iteration, ``loop`` inside ``loop_iteration()`` (one PCG matvec,
    forward and adjoint solves alike), ``loop_iters`` their count."""

    def __init__(self):
        self.static: dict = {}
        self.loop: dict = {}
        self.loop_iters = 0
        self._depth = 0

    def add(self, prim: str, nbytes: int) -> None:
        bucket = self.loop if self._depth else self.static
        bucket[prim] = bucket.get(prim, 0) + int(nbytes)

    @contextlib.contextmanager
    def recording(self):
        """Count the collectives of this process while inside."""
        _RECORDING.append(self)
        try:
            yield self
        finally:
            _RECORDING.remove(self)

    @contextlib.contextmanager
    def loop_iteration(self):
        """One iteration of a solver loop (nested ones count once)."""
        if not self._depth:
            self.loop_iters += 1
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def report(self) -> dict:
        """admp_tpu's tally layout: {'static': {prim: bytes},
        'per_while_iter': {prim: bytes per iteration}, 'total_static': int},
        and 'while_iters', the iterations counted."""
        n = max(self.loop_iters, 1)
        return {"static": dict(self.static),
                "per_while_iter": {k: v // n for k, v in self.loop.items()},
                "total_static": sum(self.static.values()),
                "while_iters": self.loop_iters}


@contextlib.contextmanager
def loop_iteration():
    """Mark one solver iteration in every tally recording now."""
    with contextlib.ExitStack() as stack:
        for tally in list(_RECORDING):
            stack.enter_context(tally.loop_iteration())
        yield


def format_report(title: str, tally: dict, notes: str = "") -> str:
    lines = [f"== {title} =="]
    for k, v in sorted(tally["static"].items()):
        lines.append(f"  {k:>14}: {v:>12,} B/step/device")
    total = tally["total_static"]
    lines.append(f"  {'TOTAL':>14}: {total:>12,} B/step/device")
    if tally["per_while_iter"]:
        for k, v in sorted(tally["per_while_iter"].items()):
            lines.append(f"  {k:>14}: {v:>12,} B/while-iter/device")
    if notes:
        lines.append(f"  note: {notes}")
    return "\n".join(lines)


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


# ---------------------------------------------------------------------------
# psum / pvary
# ---------------------------------------------------------------------------


def _all_reduce(tensors, group):
    """Sum each tensor over the group: one all_reduce per dtype, the
    tensors of a dtype flattened into one buffer."""
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for k, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(k)
    for idx in by_dtype.values():
        parts = [_real(tensors[k].contiguous()).reshape(-1) for k in idx]
        flat = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        _count("psum", _nbytes(flat))
        dist.all_reduce(flat, group=group)
        pieces = torch.split(flat, [p.numel() for p in parts])
        for k, piece in zip(idx, pieces):
            t = tensors[k]
            piece = piece.reshape(_real(t).shape)
            out[k] = torch.view_as_complex(piece) if t.is_complex() else piece
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(_all_reduce(xs, group))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_PVary.apply(ctx.group, *gs))


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        need = [k for k, n in enumerate(ctx.needs_input_grad[1:]) if n]
        out = [None] * len(gs)
        if need:
            summed = _Psum.apply(ctx.group, *(gs[k] for k in need))
            for k, s in zip(need, summed):
                out[k] = s
        return (None, *out)


def psum(x, group=None):
    """The sum of x over the group's ranks (varying -> replicated); its
    backward hands the replicated cotangent to every rank unchanged."""
    return _Psum.apply(group, x)[0]


def pvary(group, *xs):
    """Replicated -> varying: the identity, whose backward sums the ranks'
    cotangents (psum). Returns a tuple of the tensors; None, and a tensor
    that does not require grad, come back as they are (through the Function
    it would come out requiring grad, and every op after it would keep a
    backward: an index of the 5 scales by 1.7M pairs took 148 ms of the
    98k step's backward on the card)."""
    live = [k for k, x in enumerate(xs)
            if x is not None and x.requires_grad]
    out = list(xs)
    if live:
        for k, y in zip(live, _PVary.apply(group, *(xs[k] for k in live))):
            out[k] = y
    return tuple(out)


# ---------------------------------------------------------------------------
# all_to_all, ppermute, all_gather
# ---------------------------------------------------------------------------


def _all_to_all(x, split_axis: int, concat_axis: int, group):
    """admp_tpu's tiled all_to_all: x's ``split_axis`` cut into P blocks,
    block j sent to rank j, the blocks received from ranks 0..P-1
    concatenated along ``concat_axis``. all_to_all_single splits dim 0
    only, so the split axis goes first, contiguous, and the blocks are put
    back in place after."""
    p = dist.get_world_size(group)
    size = x.shape[split_axis]
    if size % p:
        raise ValueError(f"all_to_all: axis {split_axis} of {size} is not "
                         f"divisible by {p} ranks")
    xs = x.movedim(split_axis, 0)
    rest = xs.shape[1:]
    send = _real(xs.reshape(p, size // p, *rest).contiguous())
    recv = torch.empty_like(send)
    _count("all_to_all", _nbytes(send))
    dist.all_to_all_single(recv, send, group=group)
    if x.is_complex():
        recv = torch.view_as_complex(recv)
    # recv[i]: rank i's block, (size/P, *rest) with the split axis first
    y = recv.movedim(1, split_axis + 1)  # (P, *x.shape with size/P)
    y = y.movedim(0, concat_axis)  # P just before the concat axis
    shape = list(y.shape)
    c = concat_axis
    return y.reshape(shape[:c] + [shape[c] * shape[c + 1]] + shape[c + 2:])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.args = (split_axis, concat_axis, group)
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, group = ctx.args
        return (_AllToAll.apply(g, concat_axis, split_axis, group), None,
                None, None)


def all_to_all(x, split_axis: int, concat_axis: int, group=None):
    """Tiled all_to_all (jax.lax.all_to_all(..., tiled=True)); its backward
    is the all_to_all with the two axes swapped."""
    return _AllToAll.apply(x, split_axis, concat_axis, group)


def _ppermute(x, shift: int, group):
    """x from rank r to rank (r + shift) mod P: an all_to_all_single whose
    only nonzero splits are the destination's and the source's."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    send = _real(x.contiguous())
    recv = torch.empty_like(send)
    rows = send.shape[0]
    out_splits, in_splits = [0] * p, [0] * p
    in_splits[(r + shift) % p] = rows
    out_splits[(r - shift) % p] = rows
    _count("ppermute", _nbytes(send))
    dist.all_to_all_single(recv, send, out_splits, in_splits, group=group)
    return torch.view_as_complex(recv) if x.is_complex() else recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, group):
        ctx.shift, ctx.group = shift, group
        return _ppermute(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return _PPermute.apply(g, -ctx.shift, ctx.group), None, None


def ppermute(x, shift: int = 1, group=None):
    """Ring shift (jax.lax.ppermute over [(i, (i + shift) % P)]): every
    rank sends x to rank + shift and returns what rank - shift sent."""
    return _PPermute.apply(x, shift, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        send = _real(x.contiguous())
        parts = [torch.empty_like(send)
                 for _ in range(dist.get_world_size(group))]
        _count("all_gather", _nbytes(send))
        dist.all_gather(parts, send, group=group)
        out = torch.cat(parts)
        return torch.view_as_complex(out) if x.is_complex() else out

    @staticmethod
    def backward(ctx, g):
        return _OwnBlock.apply(g, ctx.group), None


class _OwnBlock(torch.autograd.Function):
    """This rank's block of a replicated tensor along axis 0 (the transpose
    of all_gather)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        p, r = dist.get_world_size(group), dist.get_rank(group)
        n = x.shape[0] // p
        return x[r * n:(r + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group), None


def all_gather(x, group=None):
    """The ranks' x concatenated along axis 0, rank 0 first (replicated);
    its backward takes this rank's block of the cotangent."""
    return _AllGather.apply(x, group)
