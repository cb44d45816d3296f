"""The work of a polarizable MD step's passes over the energy mesh, where the
SCF's matvec runs on that mesh (``matvec_spread_order`` None or 6,
``matvec_grid_div`` 1), from the cell's shapes alone.

A Feynman-Hellmann step (``exact_adjoint=False``) takes two full-multipole
passes, the field at the warm start and the energy at the converged dipoles,
each the spread and gather of ``counts/spread.py`` at the cell's lmax; and one
dipole pass per PCG iteration, the matvec. A dipole pass spreads each atom's
three induced-dipole components through its order^3 stencil onto the
(K1, K2, K3) mesh and gathers the mesh's gradient back: its least bytes are
each atom's position and dipole read once and the mesh written once, then the
mesh read once (at most the points the stencils touch), each position read
and the three dipole gradients written once; its operations an addition per
stencil point, then a multiply-add. The matvec takes no position gradient.
"""

from __future__ import annotations

import math

from .peaks import bound_s
from .spread import gather_work, spread_work

ORDER = 6


def dipole_pass_work(n_atoms, order, grid):
    """[(bytes, operations)] of one dipole spread and its gather."""
    k = math.prod(grid)
    touched = min(k, n_atoms * order ** 3)
    spread = (n_atoms * (3 + 3) * 4 + k * 4, n_atoms * order ** 3)
    gather = (touched * 4 + n_atoms * 3 * 4 + n_atoms * 3 * 4,
              2 * n_atoms * order ** 3)
    return [spread, gather]


def full_pass_work(n_atoms, lmax, order, grid):
    """[(bytes, operations)] of one full-multipole spread and its gather."""
    return [spread_work(n_atoms, lmax, order, grid),
            gather_work(n_atoms, lmax, order, grid)]


def step_bound_s(shapes, pcg_iters):
    """The least seconds of one step's energy-mesh spreads and gathers
    (``shapes``: n_atoms, lmax, grid) at ``pcg_iters`` PCG iterations."""
    n, grid = shapes["n_atoms"], shapes["grid"]
    full = sum(bound_s(*w)[0]
               for w in full_pass_work(n, shapes["lmax"], ORDER, grid))
    dipole = sum(bound_s(*w)[0] for w in dipole_pass_work(n, ORDER, grid))
    return 2.0 * full + pcg_iters * dipole
