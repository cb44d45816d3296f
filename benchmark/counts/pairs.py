"""The work of the real-space pair passes, from the cell's shapes alone.

A pass is one energy and its gradient over the pairs of the list, of one
kind: ``'perm'`` (permanent multipoles to lmax), ``'pol'`` (the same with the
induced dipoles and Thole damping) or ``'uu'`` (induced-induced only, the
SCF's matvec). Its least bytes: each atom's row of the pass (positions,
multipoles, dipoles, polarizability, Thole width) read once, the pair list
read once as int32 pairs, the gradient rows and the energy written once. Its
operations: the forward energy's, counted on the host from the reference's
plain pair functions (``opcount``) per pair; the gradient is counted as no
more than that, so the count stays a lower bound.

The passes of one MD step follow the model: a fixed-multipole step is one
'perm' pass; a polarizable Feynman-Hellmann step (SCFConfig.md()) takes a
'pol' pass for the field at the warm start, a 'uu' pass per PCG iteration and
a 'pol' pass for the energy and forces at the converged dipoles.
"""

from __future__ import annotations

import functools

import torch

from .opcount import count_ops
from .peaks import bound_s

_N_SAMPLE = 512  # pairs of the host count


def row_width(kind, lmax):
    n_harm = (lmax + 1) ** 2
    return {"perm": 3 + n_harm, "pol": 3 + n_harm + 3 + 2,
            "uu": 3 + 3 + 2}[kind]


@functools.lru_cache(maxsize=None)
def ops_per_pair(kind, lmax):
    """Forward operations per pair of the reference's plain pair energy."""
    from benchmark.reference import realspace as rs

    gen = torch.Generator().manual_seed(0)
    n = 64
    f64 = torch.float64
    pos = torch.rand((n, 3), generator=gen, dtype=f64) * 12.0
    box = torch.eye(3, dtype=f64) * 12.0
    q = torch.randn((n, (lmax + 1) ** 2), generator=gen, dtype=f64)
    u = torch.randn((n, 3), generator=gen, dtype=f64)
    pol = torch.rand(n, generator=gen, dtype=f64) + 0.5
    thole = torch.rand(n, generator=gen, dtype=f64) + 0.5
    i = torch.randint(0, n // 2, (_N_SAMPLE,), generator=gen)
    j = torch.randint(n // 2, n, (_N_SAMPLE,), generator=gen)
    mask = torch.ones(_N_SAMPLE, dtype=torch.bool)
    scale = torch.ones(_N_SAMPLE, dtype=f64)
    kappa = 0.7

    def perm():
        r, qi, qj, _, _ = rs.qi_pair_components(pos, box, q, i, j, mask, lmax)
        return rs.pair_energy_perm(qi, qj, rs.perm_coefficients(
            r, scale, kappa, lmax), lmax).sum()

    def pol_pair():
        r, qi, qj, ui, uj = rs.qi_pair_components(pos, box, q, i, j, mask,
                                                  lmax, u)
        e = rs.pair_energy_perm(qi, qj, rs.perm_coefficients(
            r, scale, kappa, lmax), lmax)
        dmp = rs.pair_damping_width(pol[i], pol[j])
        ic = rs.induced_coefficients(r, thole[i], thole[j], dmp, scale,
                                     kappa, lmax)
        return (e + rs.pair_energy_induced(qi, qj, ui, uj, ic, lmax)).sum()

    def uu():
        dx, dy, dz, r, rinv, _, _ = rs.pair_displacement_components(
            pos, box, i, j, mask)
        ui, uj = u[i], u[j]
        return rs.uu_pair_energy(
            dx, dy, dz, r, rinv, (ui[:, 1], ui[:, 2], ui[:, 0]),
            (uj[:, 1], uj[:, 2], uj[:, 0]), pol[i], pol[j], thole[i],
            thole[j], scale, kappa).sum()

    fn = {"perm": perm, "pol": pol_pair, "uu": uu}[kind]
    return count_ops(fn) / _N_SAMPLE


def pass_work(kind, lmax, n_atoms, n_pairs):
    """(bytes, operations) of one energy-and-gradient pass."""
    w = row_width(kind, lmax)
    n_bytes = 2 * n_atoms * w * 4 + n_pairs * 2 * 4 + 4
    return n_bytes, 2.0 * ops_per_pair(kind, lmax) * n_pairs


def step_passes(polarizable, pcg_iters):
    """[(kind, passes)] of one MD step (module docstring)."""
    if polarizable:
        return [("pol", 2.0), ("uu", float(pcg_iters))]
    return [("perm", 1.0)]


def step_bound_s(shapes, pcg_iters):
    """The least seconds of one MD step's pair work, each pass at its own
    bound (``shapes``: n_atoms, n_pairs, lmax, polarizable)."""
    total = 0.0
    for kind, k in step_passes(shapes["polarizable"], pcg_iters):
        total += k * bound_s(*pass_work(kind, shapes["lmax"],
                                        shapes["n_atoms"],
                                        shapes["n_pairs"]))[0]
    return total
