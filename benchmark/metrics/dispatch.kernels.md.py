"""dispatch.kernels.md: device kernels per MD step in the traced
sub-window (memory copies and fills not counted)."""


def read(ctx):
    t = ctx.get("trace")
    return t["kernels"] / t["steps"] if t and t["steps"] else None
