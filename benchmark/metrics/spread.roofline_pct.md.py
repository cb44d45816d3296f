"""spread.roofline_pct.md: the least time of an MD step's order-6
energy-mesh spreads and gathers (counts/spread.py, from the cell's shapes),
over the device time of the kernels named in spread.roofline_pct.md.d/, in
%. None where those kernels ran for no time."""

from benchmark.counts import spread
from benchmark.harness.core import kernel_names


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["steps"]:
        return None
    names = kernel_names(ctx["bench"], ctx["metric"])
    dev_s = sum(s for fn, s in t["by_fn"].items() if fn in names)
    if dev_s <= 0:
        return None
    return 100.0 * spread.step_bound_s(ctx["shapes"]) * t["steps"] / dev_s
