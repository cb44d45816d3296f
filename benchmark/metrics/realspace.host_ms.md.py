"""realspace.host_ms.md: host ms per traced MD step in the real-space pair
passes (ops/realspace, the K1/K2 launches of ops/cuda/pairs): the
program's spans ``realspace`` and ``realspace.bwd``. None against a
program without spans."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, ("realspace", "realspace.bwd"))
