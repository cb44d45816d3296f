"""host.syncs.md: host syncs per traced MD step: the sum of the program's
``host.syncs.<site>`` counters (each a call that waits for the device: a
read-back, or a copy from the host's pageable memory, counted by
``admp_tpu_torch.utils.profiling.host_sync``) over the traced sub-window,
over its steps. 0.0 where the registry holds no such counter; None without
a traced window or against a program without the registry."""

from benchmark.harness.spans import registry

PREFIX = "host.syncs."


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("steps"):
        return None
    reg = registry()
    if reg is None:
        return None
    n = sum(v for k, v in reg.get("counters", {}).items()
            if k.startswith(PREFIX))
    return n / t["steps"]
