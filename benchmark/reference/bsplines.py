"""Cardinal B-splines of orders 6 and 4 with first and second derivatives
(admp_tpu/ops/bsplines.py).

The fractional offset u0 of an atom lies in [order/2, order/2 + 1), so the
stencil point k has its argument in [k, k+1): each piece is evaluated once per
dimension with no selects.
"""

from __future__ import annotations

from math import comb, factorial

import numpy as np
import torch

ORDER = 6


def _piece_coeffs(order: int = ORDER) -> np.ndarray:
    """(order, order) array: row k = power-basis coeffs of B_order on [k, k+1)."""
    coeffs = np.zeros((order, order))
    for k in range(order):
        acc = np.zeros(order)
        for j in range(k + 1):
            sign = (-1.0) ** j * comb(order, j)
            for p in range(order):
                acc[p] += (
                    sign * comb(order - 1, p) * (-float(j)) ** (order - 1 - p)
                )
        coeffs[k] = acc / float(factorial(order - 1))
    return coeffs


def _tables(order):
    c = _piece_coeffs(order)
    c1 = c[:, 1:] * np.arange(1, order)
    c2 = c1[:, 1:] * np.arange(1, order - 1)
    return c, c1, c2


_TABLES = {6: _tables(6), 4: _tables(4)}

# The order-6 piece tables (B, B', B'') and the third-derivative table: the
# double-single reciprocal engine (ops/dsrecip.py) evaluates them with
# DS-split coefficients, and its hand-written adjoint differentiates each
# channel once more (admp_tpu/ops/dsrecip.py:48-52).
_C, _C1, _C2 = _TABLES[6]
_C3 = _C2[:, 1:] * np.arange(1, ORDER - 2)

# B6 at the integer knots 1..5 and B4 at 1..3 (Euler spline factors)
B6_KNOTS = np.array([1.0, 26.0, 66.0, 26.0, 1.0]) / 120.0
B4_KNOTS = np.array([1.0, 4.0, 1.0]) / 6.0


def _eval_pieces(u0, coeff_table):
    """(..., 3) offsets -> (..., order, 3): piece k at u = u0 + k - order/2."""
    order = coeff_table.shape[0]
    outs = []
    for k in range(order):
        u = u0 + (k - order / 2.0)
        c = coeff_table[k]
        acc = torch.full_like(u, float(c[-1]))
        for p in range(len(c) - 2, -1, -1):
            acc = acc * u + float(c[p])
        outs.append(acc)
    return torch.stack(outs, dim=-2)


def spline_values(u0, order: int = ORDER):
    return _eval_pieces(u0, _TABLES[order][0])


def spline_derivs(u0, order: int = ORDER):
    return _eval_pieces(u0, _TABLES[order][1])


def spline_derivs2(u0, order: int = ORDER):
    return _eval_pieces(u0, _TABLES[order][2])


def euler_spline_theta(kpts_int_axis, n_axis):
    """theta(k) = 11/20 + (13/30) cos(2 pi k/N) + (1/60) cos(4 pi k/N)."""
    b = B6_KNOTS
    ang = 2.0 * np.pi * kpts_int_axis / n_axis
    return b[2] + 2.0 * b[1] * torch.cos(ang) + 2.0 * b[0] * torch.cos(2.0 * ang)


def euler_spline_theta4(kpts_int_axis, n_axis):
    """theta(k) = 4/6 + (2/6) cos(2 pi k/N)."""
    b = B4_KNOTS
    ang = 2.0 * np.pi * kpts_int_axis / n_axis
    return b[1] + 2.0 * b[0] * torch.cos(ang)
