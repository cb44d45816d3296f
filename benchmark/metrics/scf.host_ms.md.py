"""scf.host_ms.md: host ms per traced MD step in the SCF's solve (the
warm-start field pass and the PCG iterations, their host-checked residuals
included): the program's composite span ``scf.solve``. None against a
program without that span."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, ("scf.solve",))
