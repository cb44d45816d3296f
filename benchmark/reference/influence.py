"""Reciprocal-space influence functions C(k^2) (admp_tpu/ops/influence.py).

Each dispersion kernel carries its analytic k = 0 limit as ``at_zero``, so
that the gamma point, which dispersion PME includes, is evaluated without a
0/0 or a sqrt(0) in the gradient. Electrostatics excludes it
(``ck_1.at_zero`` is None).
"""

from __future__ import annotations

import math

import torch

from .constants import SQRT_PI


def ck_1(ksq, kappa, volume):
    """Coulomb 1/r influence: 2 pi / (V k^2) exp(-k^2 / 4 kappa^2). The gamma
    point is excluded."""
    return 2.0 * math.pi / volume / ksq * torch.exp(-ksq / 4.0 / kappa**2)


ck_1.at_zero = None


def _x_terms(ksq, kappa):
    x2 = ksq / 4.0 / kappa**2
    x = torch.sqrt(x2)
    return x, x2, torch.exp(-x2), torch.special.erfc(x)


def ck_6(ksq, kappa, volume):
    """r^-6 influence (C6)."""
    x, x2, exp_x2, erfc_x = _x_terms(ksq, kappa)
    f = (1.0 - 2.0 * x2) * exp_x2 + 2.0 * x2 * x * SQRT_PI * erfc_x
    return SQRT_PI * math.pi / 2.0 / volume * kappa**3 * f / 3.0


ck_6.at_zero = lambda kappa, volume: (
    SQRT_PI * math.pi / 2.0 / volume * kappa**3 / 3.0)


def ck_8(ksq, kappa, volume):
    """r^-8 influence (C8)."""
    x, x2, exp_x2, erfc_x = _x_terms(ksq, kappa)
    x4 = x2 * x2
    f = (3.0 - 2.0 * x2 + 4.0 * x4) * exp_x2 - 4.0 * x4 * x * SQRT_PI * erfc_x
    return SQRT_PI * math.pi / 2.0 / volume * kappa**5 * f / 45.0


ck_8.at_zero = lambda kappa, volume: (
    SQRT_PI * math.pi / 2.0 / volume * kappa**5 * 3.0 / 45.0)


def ck_10(ksq, kappa, volume):
    """r^-10 influence (C10)."""
    x, x2, exp_x2, erfc_x = _x_terms(ksq, kappa)
    x4 = x2 * x2
    x6 = x4 * x2
    f = ((15.0 - 6.0 * x2 + 4.0 * x4 - 8.0 * x6) * exp_x2
         + 8.0 * x6 * x * SQRT_PI * erfc_x)
    return SQRT_PI * math.pi / 2.0 / volume * kappa**7 * f / 1260.0


ck_10.at_zero = lambda kappa, volume: (
    SQRT_PI * math.pi / 2.0 / volume * kappa**7 * 15.0 / 1260.0)
