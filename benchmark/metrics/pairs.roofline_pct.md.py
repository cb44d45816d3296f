"""pairs.roofline_pct.md: the least time of an MD step's real-space pair
work (counts/pairs.py, from the cell's shapes and the traced steps' PCG
iterations), over the device time of the kernels named in
pairs.roofline_pct.md.d/, in %. None where those kernels ran for no time."""

from benchmark.counts import pairs
from benchmark.harness.core import kernel_names


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["steps"]:
        return None
    names = kernel_names(ctx["bench"], ctx["metric"])
    dev_s = sum(s for fn, s in t["by_fn"].items() if fn in names)
    if dev_s <= 0:
        return None
    iters = t["pcg_iters"]
    mean_iters = sum(iters) / len(iters) if iters else 0.0
    work_s = pairs.step_bound_s(ctx["shapes"], mean_iters) * t["steps"]
    return 100.0 * work_s / dev_s
