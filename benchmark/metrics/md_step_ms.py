"""md_step_ms: the window's wall time over the MD steps completed in it,
neighbor-list refreshes included (host clock, the window ending in a
synchronization)."""


def read(ctx):
    w = ctx["window"]
    return 1e3 * w["seconds"] / w["steps"] if w["steps"] else None
