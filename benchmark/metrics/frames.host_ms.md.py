"""frames.host_ms.md: host ms per traced MD step in ops/frames, the local
frames and the rotation of the multipoles: the program's spans ``frames``
and ``frames.bwd``. None against a program without spans."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, ("frames", "frames.bwd"))
