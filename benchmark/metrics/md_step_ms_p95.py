"""md_step_ms_p95: the 95th percentile of every step's time in the window,
each between the CUDA events recorded at consecutive step ends (no
synchronization inside the window)."""

from benchmark.loops.langevin import percentile


def read(ctx):
    times = ctx["window"]["step_ms"]
    return percentile(times, 95) if times else None
