"""Compensated summation (admp_tpu/utils/accmath.py).

The real-space, self-energy and Parseval sums accumulate ~1e5-magnitude terms
into a ~1e2 result; plain f32 summation loses the Ewald cancellation there.

admp_tpu sums with an error-free TwoSum tree (error O(n eps^2)). The port keeps
that tree for float64 input. For float32 input it accumulates in float64: the
card has native f64, the error is O(n eps64), below the tree's O(n eps32^2),
and it is one reduction instead of the tree's ~8 ops per level over log2(n)
levels. The float64 result is returned as it is, not rounded to float32: the
terms it feeds (real space ~ +9e5, self ~ -1e6 kJ/mol on a 3000-atom water
box) cancel to ~ -3e3, and rounding each to float32 first would put a
1/16 kJ/mol grid on the total (models/pme.energy_pme rounds the total once).
The backward is admp_tpu's explicit one, the plain-sum broadcast (the error
terms' exact derivative is zero), in the input's dtype.
"""

from __future__ import annotations

import torch


def two_sum(a, b):
    """Error-free transform: a + b = s + err exactly (Knuth TwoSum)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def _twosum_tree(x):
    hi = x.reshape(-1)
    lo = torch.zeros_like(hi)
    while hi.shape[0] > 1:
        n = hi.shape[0]
        if n % 2:
            pad = hi.new_zeros(1)
            hi = torch.cat([hi, pad])
            lo = torch.cat([lo, pad])
            n += 1
        half = n // 2
        s, e = two_sum(hi[:half], hi[half:])
        hi = s
        lo = lo[:half] + lo[half:] + e
    if hi.shape[0] == 0:
        return x.new_zeros(())
    return hi[0] + lo[0]


class _CompensatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        if x.dtype == torch.float32:
            return x.to(torch.float64).sum()
        return _twosum_tree(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).expand(ctx.shape)


def compensated_sum(x):
    """Sum of all elements of ``x`` with an error far below the working
    precision's rounding; float32 input gives a float64 result (see the
    module docstring)."""
    return _CompensatedSum.apply(x)


def masked_compensated_sum(x, mask):
    """compensated_sum(where(mask, x, 0))."""
    return compensated_sum(torch.where(mask, x, torch.zeros_like(x)))
