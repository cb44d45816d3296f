"""Profiling and observability helpers (admp_tpu/utils/profiling.py):
wall-clock timing read only after the device is synchronized, a
``torch.profiler`` trace, and per-term energy breakdowns for structured
metrics lines.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


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
    (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def energy_breakdown(terms: dict) -> dict:
    """Evaluate a dict of named thunks into floats (a structured metrics
    line)."""
    return {name: float(thunk()) for name, thunk in terms.items()}
