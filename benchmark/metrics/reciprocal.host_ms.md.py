"""reciprocal.host_ms.md: host ms per traced MD step in the reciprocal
energy (ops/reciprocal: spread, FFT, convolution, gather; the K4-K7
launches of ops/cuda/spread): the program's spans ``reciprocal`` and
``reciprocal.bwd``. None against a program without spans."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, ("reciprocal", "reciprocal.bwd"))
