"""Real-space dispersion Ewald pair energy, C6/C8/C10 with the incomplete-
gamma screening (admp_tpu/ops/dispersion.py). admp_tpu's ``exp_accurate``
(a TPU-lowerable exp) is ``torch.exp`` here."""

from __future__ import annotations

import torch


def g_screening(x2, pmax: int):
    """(g6[, g8[, g10]]): the screening polynomials times exp(-x^2)."""
    x4 = x2 * x2
    exp_x2 = torch.exp(-x2)
    g6 = 1.0 + x2 + 0.5 * x4
    out = [g6]
    if pmax >= 8:
        g8 = g6 + x4 * x2 / 6.0
        out.append(g8)
    if pmax >= 10:
        out.append(g8 + x4 * x4 / 24.0)
    return tuple(g * exp_x2 for g in out)


def dispersion_pair_energy(r2, c_i, c_j, mscale, kappa, pmax: int):
    """e = sum_p (mscale + g_p - 1) c_p,i c_p,j / r^p per pair; ``r2`` is
    sanitized on masked pairs, ``c_i``/``c_j`` are (..., n_p) square-root
    coefficients with columns (C6, C8, C10). For an excluded pair
    (mscale = 0) the screened term g_p - 1 cancels most of the bare one."""
    x2 = kappa * kappa * r2
    g = g_screening(x2, pmax)
    r6 = r2 * r2 * r2
    e = (mscale + g[0] - 1.0) * c_i[..., 0] * c_j[..., 0] / r6
    if pmax >= 8:
        r8 = r6 * r2
        e = e + (mscale + g[1] - 1.0) * c_i[..., 1] * c_j[..., 1] / r8
    if pmax >= 10:
        r10 = r8 * r2
        e = e + (mscale + g[2] - 1.0) * c_i[..., 2] * c_j[..., 2] / r10
    return e
