"""md.self_ms.md: host ms per traced MD step in the MD loop outside every
layer's span: the self time of the program's ``md.step`` spans (the force
call's glue, the autograd engine's nodes outside any layer) and the
``md.integrate`` spans (the BAOAB arithmetic). None against a program
without spans."""

from benchmark.harness.spans import host_ms


def read(ctx):
    return host_ms(ctx, ("md.step", "md.integrate"), "self_ms")
