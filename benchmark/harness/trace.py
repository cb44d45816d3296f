"""The traced sub-window: torch.profiler over whole steps, reduced to the
device's busy time (the union of its activity intervals), kernels by
function name, the top device operations and the idle gaps by what the host
was doing meanwhile."""

from __future__ import annotations

import bisect
import re
import time

import torch

_FN = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*[<(]")


def kernel_function(name):
    """The function name of a device activity's (demangled) name:
    'void (anonymous namespace)::pair_bwd_kernel<1, 2>(float const*, ...)'
    gives 'pair_bwd_kernel'."""
    name = name.replace("(anonymous namespace)::", "")
    m = _FN.search(name)
    return m.group(1) if m else name.split()[-1] if name.split() else name


class Window:
    """``with Window(device) as w: <steps>``: profiles the steps between two
    synchronizations; ``w.summary()`` reduces the trace."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def summary(self, top=10):
        return summarize(self.prof.events(), self.wall_s, top)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events, wall_s, top=10):
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == cuda]
    merged = _union([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in merged)
    by_fn, by_name, kernels = {}, {}, 0
    for name, s, e in dev:
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
        fn = kernel_function(name)
        by_fn[fn] = by_fn.get(fn, 0.0) + (e - s) * 1e-6
        short = name[:120]
        by_name[short] = by_name.get(short, 0.0) + (e - s) * 1e-6
    # idle gaps between device activity, named by the host's top-level op
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == cpu and e.cpu_parent is None)
    starts = [h[0] for h in host]
    gaps = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        k = bisect.bisect_right(starts, end) - 1
        what = (host[k][2] if k >= 0 and host[k][1] >= end
                else "host between ops")
        gaps[what] = gaps.get(what, 0.0) + (nxt - end) * 1e-6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                            key=lambda kv: -kv[1])[:top]
    return dict(wall_s=wall_s, busy_s=busy_us * 1e-6, kernels=kernels,
                by_fn=by_fn, device_ops=rank(by_name), idle_gaps=rank(gaps))
