"""Numerically safe helpers for masked fixed-shape computation
(admp_tpu/utils/safety.py).

Padding lanes (neighbor-list padding, self pairs) are carried through and
masked out of the final sum. ``torch.where(mask, good, bad)`` still sends a
NaN gradient from the bad branch, so the input of the singular operation is
sanitized first (the double where).
"""

from __future__ import annotations

import torch


def safe_inv(x, mask=None, eps=1e-8):
    """1/x that never divides by ~0, capped at 1/eps; masked-out lanes
    return 0."""
    big = torch.as_tensor(1.0 / eps, dtype=x.dtype, device=x.device)
    x_safe = torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)
    out = 1.0 / x_safe
    if mask is not None:
        out = torch.where(mask, out, torch.zeros_like(out))
    return torch.minimum(out, big)


def masked_norm(vec, mask, axis=-1, fill=1.0):
    """Euclidean norm along ``axis``; lanes where ``mask`` is False get
    ``fill``, with an exactly zero gradient."""
    sq = torch.sum(vec * vec, dim=axis)
    fill_t = torch.full_like(sq, fill)
    sq_safe = torch.where(mask, sq, fill_t * fill_t)
    return torch.where(mask, torch.sqrt(sq_safe), fill_t)


def safe_normalize(vec, axis=-1, eps=1e-12):
    """Normalize vectors, mapping ~zero vectors to zero instead of NaN."""
    sq = torch.sum(vec * vec, dim=axis, keepdim=True)
    small = sq < eps
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    return torch.where(small, torch.zeros_like(vec), vec / torch.sqrt(sq_safe))


def clamp_min(x, lo):
    """max(x, lo) with the gradient of the branch taken."""
    return torch.where(x < lo, torch.as_tensor(lo, dtype=x.dtype,
                                               device=x.device), x)


def clamp_max(x, hi):
    """min(x, hi) with the gradient of the branch taken."""
    return torch.where(x > hi, torch.as_tensor(hi, dtype=x.dtype,
                                               device=x.device), x)
