"""scf.pcg_iters.md: PCG iterations per MD step of the SCF solver
(``ADMPPmeForce.n_cycle`` after each step), over the traced sub-window."""


def read(ctx):
    iters = ctx.get("trace", {}).get("pcg_iters") or []
    return sum(iters) / len(iters) if iters else None
