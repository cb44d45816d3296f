"""The work of the order-6 energy-mesh spread and gather, from the cell's
shapes alone: N atoms with H = (lmax + 1)^2 harmonic channels spread onto a
(K1, K2, K3) mesh of C = 1 channel through order^3 stencils, and the gather of
the mesh's gradient back to the atoms.

Spread: each atom's position and multipoles read once, the mesh written once,
one addition per stencil point. Gather: the mesh read once (at most the
points the stencils touch), each atom's position read and its H + 3 gradient
values written once, a multiply-add per stencil point. An MD step spreads and
gathers once per energy pass on this mesh: once at fixed multipoles, twice for
a polarizable Feynman-Hellmann step (the field at the warm start and the
energy at the converged dipoles). The SCF's order-4 matvec mesh is not in
this count.
"""

from __future__ import annotations

import math

from .peaks import bound_s


def spread_work(n_atoms, lmax, order, grid, channels=1):
    h = (lmax + 1) ** 2
    k = math.prod(grid) * channels
    return n_atoms * (3 + h) * 4 + k * 4, n_atoms * order ** 3 * channels


def gather_work(n_atoms, lmax, order, grid, channels=1):
    h = (lmax + 1) ** 2
    k = min(math.prod(grid), n_atoms * order ** 3) * channels
    return (k * 4 + n_atoms * 3 * 4 + n_atoms * (h + 3) * 4,
            2 * n_atoms * order ** 3 * channels)


def step_bound_s(shapes):
    """The least seconds of one MD step's energy-mesh spreads and gathers
    (``shapes``: n_atoms, lmax, grid, polarizable)."""
    passes = 2 if shapes["polarizable"] else 1
    args = (shapes["n_atoms"], shapes["lmax"], 6, shapes["grid"])
    return passes * (bound_s(*spread_work(*args))[0]
                     + bound_s(*gather_work(*args))[0])
