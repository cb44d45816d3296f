"""shortrange.host_ms.md: host ms per traced MD step in the short-range
pair terms (ops/shortrange) and the bonded terms (ops/bonded): the
program's spans ``shortrange``, ``bonded`` and their ``.bwd``. None
against a program without spans."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, ("shortrange", "shortrange.bwd", "bonded",
                         "bonded.bwd"))
