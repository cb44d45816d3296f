"""device.idle_pct.md: 100 minus the union of the device's activity
intervals over the traced sub-window's wall time."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
