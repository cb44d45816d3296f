"""Profiling and observability (admp_tpu/utils/profiling.py): wall-clock
timing read only after the device is synchronized, a ``torch.profiler``
trace of a block, and the spans and counters the program records while a
profiler records.

Tracing is on exactly while a torch profiler records
(``torch.autograd.profiler._is_profiler_enabled``). Off, a span or counter
site costs that one attribute read: no profiler range, no timer, no
autograd node. On, each span adds to an in-memory registry, keyed by name:
its count, its host time stamped with ``time.time_ns()`` (the clock of the
profiler's events), its self time (the time less the part its child spans
cover) and the spans it was opened under, its parents.

- A leaf span (``span(name)``, ``traced(name)``) is also a profiler range
  named ``admp::<name>``, on the host's timeline only (a function range,
  as an operator's; a ``record_function`` range would also be drawn on the
  device's timeline, where it reads as device activity). Leaves do not
  nest, but for ``host.sync`` inside a layer's span, so they stay the
  trace's top-level ranges, and what the host did while the card sat idle
  is named after them.
- A composite span (``composite=True``: an MD step, an energy call, an SCF
  solve, a PCG iteration, a fitting step) is in the registry only; a range
  around it would hide its leaves' names.
- A leaf function run by ``traced`` whose tensors carry gradients also
  times its backward, as the span ``<name>.bwd`` with the forward's parent.
  An identity autograd Function on the function's outputs (views: no
  kernel) opens it when their gradient arrives, and hooks on the function's
  autograd nodes that feed its inputs close it once the last of those that
  the backward runs has run. The backward's engine runs a region's nodes
  one after another, so the span covers them and nothing else. Nothing is
  placed on the inputs: their gradients are summed in the order an
  untraced run sums them, and the numbers are bit for bit the same. A
  derivative of a backward runs through no marker and records no span.

``snapshot()`` reads the registry and ``reset()`` clears it; ``trace(dir)``
writes both the Chrome trace and the registry of its block.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

_LOCK = threading.Lock()
_SPANS = {}  # name -> _Stat
_COUNTERS = {}  # name -> int
# open spans, innermost last; one stack for the forward and the autograd
# engine's thread, which take turns (the forward waits in the backward)
_OPEN = []
_OFF = contextlib.nullcontext()


class _Stat:
    __slots__ = ("count", "total_ns", "self_ns", "parents", "last_ns")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = 0
        self.parents = {}
        self.last_ns = None


class _Open:
    """One open span: pushed on the stack, timed, and with ``rng`` a
    profiler range."""

    __slots__ = ("name", "parent", "rng", "child_ns", "closed", "t0")

    def __init__(self, name, parent, leaf):
        self.name, self.parent = name, parent
        self.child_ns, self.closed = 0, False
        self.rng = None
        if leaf:
            # a function range, as an operator's: a record_function range
            # is also drawn on the device's timeline, as device activity
            self.rng = torch._C._profiler._RecordFunctionFast("admp::" + name)
            self.rng.__enter__()
        self.t0 = time.time_ns()
        with _LOCK:
            _OPEN.append(self)

    def close(self):
        t1 = time.time_ns()
        dur = t1 - self.t0
        with _LOCK:
            self.closed = True
            for k in range(len(_OPEN) - 1, -1, -1):
                if _OPEN[k] is self:
                    del _OPEN[k]
                    break
            stat = _SPANS.get(self.name)
            if stat is None:
                stat = _SPANS[self.name] = _Stat()
            stat.count += 1
            stat.total_ns += dur
            stat.self_ns += dur - self.child_ns
            parent = self.parent.name if self.parent is not None else None
            stat.parents[parent] = stat.parents.get(parent, 0) + 1
            stat.last_ns = (self.t0, t1)
            # the time is covered for the nearest ancestor still open (a
            # backward may run after the forward's parent closed)
            up = self.parent
            while up is not None and up.closed:
                up = up.parent
            if up is not None:
                up.child_ns += dur
        if self.rng is not None:
            self.rng.__exit__(None, None, None)


def _top():
    return _OPEN[-1] if _OPEN else None


class _Span:
    __slots__ = ("name", "leaf", "open")

    def __init__(self, name, leaf):
        self.name, self.leaf = name, leaf

    def __enter__(self):
        self.open = _Open(self.name, _top(), self.leaf)
        return self

    def __exit__(self, *exc):
        self.open.close()
        return False


def span(name: str, composite: bool = False):
    """``with span(name):`` a leaf span (a registry span and a profiler
    range ``admp::<name>``) or a composite one (the registry only) while
    tracing is on; a no-op otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, not composite)


def traced(name: str, composite: bool = False):
    """Decorator: the function runs inside ``span(name, composite)``; a
    leaf also times its backward as ``<name>.bwd`` where its tensor
    arguments carry gradients (module docstring)."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            return _call(name, composite, fn, args, kwargs)

        return run

    return wrap


def _call(name, composite, fn, args, kwargs):
    top = _top()
    inputs = [] if composite or not torch.is_grad_enabled() else [
        a for a in (*args, *kwargs.values())
        if torch.is_tensor(a) and a.requires_grad]
    first = _probe(inputs[0]) if inputs else None
    with _Span(name, not composite):
        out = fn(*args, **kwargs)
    if not inputs:
        return out
    # placing the markers is the tracing's own cost: a span of its own,
    # outside the leaf's
    with _Span("trace.markers", True):
        return _time_backward(name + ".bwd", top, out, inputs, first)


def _probe(x):
    """The sequence number of an autograd node made now (a view: no
    kernel); every node made later has a larger one."""
    return x.view_as(x).grad_fn._sequence_nr()


def _sequence_nr(node):
    """A node's sequence number, or None where the node does not give it
    (a custom Function's node, in some torch versions)."""
    try:
        return node._sequence_nr()
    except (AttributeError, RuntimeError):
        return None


class _Backward:
    """The backward span of one call of a leaf function."""

    __slots__ = ("name", "parent", "pending", "open")

    def __init__(self, name, parent):
        self.name, self.parent = name, parent
        self.pending, self.open = 0, None

    def begin(self, feeding):
        if self.open is not None:
            self.open.close()
            self.open = None
        if not _autograd_profiler._is_profiler_enabled:
            return
        self.pending = sum(1 for node in feeding
                           if torch._C._will_engine_execute_node(node))
        if self.pending:
            self.open = _Open(self.name, self.parent, True)

    def node_done(self, grad_inputs, grad_outputs):
        if self.open is None:
            return
        self.pending -= 1
        if self.pending == 0:
            self.open.close()
            self.open = None


class _Output(torch.autograd.Function):
    """``apply(bwd, feeding, *xs)``: views of ``xs`` whose backward begins
    ``bwd`` (a _Backward) over the nodes in the list ``feeding`` and passes
    the gradients on unchanged."""

    @staticmethod
    def forward(ctx, bwd, feeding, *xs):
        # the nodes live on this node, which the hooks on them do not
        # reach: no reference cycle through the C++ graph
        ctx.bwd, ctx.feeding = bwd, feeding
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.bwd.begin(ctx.feeding)
        return (None, None, *grads)


def _time_backward(name, parent, out, inputs, first):
    """``out`` (a tensor or a tuple) with its tensors that carry gradients
    marked, so that the backward of the region from ``inputs`` to them is
    timed as the span ``name``, a child of ``parent``. ``first``: a
    sequence number below every autograd node the region made."""
    outs = out if isinstance(out, tuple) else (out,)
    at = [k for k, o in enumerate(outs) if torch.is_tensor(o) and o.requires_grad]
    if not at:
        return out
    last = _probe(outs[at[0]])
    stops = {torch.autograd.graph.get_gradient_edge(x).node for x in inputs}
    feeding = _feeding_nodes([outs[k].grad_fn for k in at], stops, first,
                             last)
    bwd = _Backward(name, parent)
    for node in feeding:
        node.register_hook(bwd.node_done)
    marked = _Output.apply(bwd, feeding, *(outs[k] for k in at))
    if not isinstance(out, tuple):
        return marked[0]
    out = list(out)
    for k, m in zip(at, marked):
        out[k] = m
    return tuple(out)


def _inside(node, stops, first, last):
    """Whether ``node`` was made by the region: not an input's node, and
    made between sequence numbers ``first`` and ``last`` (a node that does
    not give its number counts as the region's; an input's gradient
    accumulator gives the largest number)."""
    if node is None or node in stops:
        return False
    seq = _sequence_nr(node)
    return seq is None or first < seq < last


def _feeding_nodes(roots, stops, first, last):
    """The region's autograd nodes with an edge out of it, found from the
    outputs' nodes ``roots`` through the region's nodes."""
    seen, feeding = set(), []
    todo = [g for g in roots if _inside(g, stops, first, last)]
    while todo:
        node = todo.pop()
        if node in seen:
            continue
        seen.add(node)
        leaves = False
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if not _inside(nxt, stops, first, last):
                leaves = True
            elif nxt not in seen:
                todo.append(nxt)
        if leaves:
            feeding.append(node)
    return feeding


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def host_sync(site: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a call that waits for the device (a
    read-back, or a copy from the host's pageable memory): while tracing is
    on, inside the leaf span ``host.sync`` and counted as
    ``host.syncs.<site>``."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn(*args, **kwargs)
    count("host.syncs." + site)
    with _Span("host.sync", True):
        return fn(*args, **kwargs)


def snapshot() -> dict:
    """The registry: ``{"spans": {name: {count, total_ms, self_ms, parents,
    last_ns}}, "counters": {name: n}}``. ``parents`` counts the instances
    by the span open around them (null: none); ``last_ns`` holds the last
    instance's start and end on the profiler's clock."""
    with _LOCK:
        spans = {name: dict(count=s.count, total_ms=s.total_ns * 1e-6,
                            self_ms=s.self_ns * 1e-6,
                            parents=dict(s.parents),
                            last_ns=list(s.last_ns))
                 for name, s in _SPANS.items()}
        return dict(spans=spans, counters=dict(_COUNTERS))


def reset():
    """Clear the registry."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()


def _synchronize(out):
    """Wait for every CUDA device the result of a timed call lives on."""
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    for x in leaves:
        if torch.is_tensor(x) and x.is_cuda:
            torch.cuda.synchronize(x.device)


def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
    """Median wall-clock seconds per call of ``fn(*args)``; each call's
    timer is read after ``torch.cuda.synchronize()`` on the devices its
    tensor results live on."""
    for _ in range(warmup):
        _synchronize(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _synchronize(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written to ``log_dir/trace.json`` in the Chrome trace format
    (chrome://tracing, Perfetto), and the block's spans and counters to
    ``log_dir/spans.json`` (``snapshot()``; the registry is cleared when
    the block starts)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(snapshot(), f, indent=1, sort_keys=True)
