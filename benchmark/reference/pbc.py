"""Periodic-boundary-condition primitives (admp_tpu/ops/pbc.py)."""

from __future__ import annotations

import torch

from .linalg3 import inv3x3


def pbc_shift(dr, box, box_inv=None):
    """Minimum-image wrap of (..., 3) displacements; box rows are lattice
    vectors. Each fractional component ends in [-0.5, 0.5)."""
    if box_inv is None:
        box_inv = inv3x3(box)
    ds = dr @ box_inv
    ds = ds - torch.floor(ds + 0.5)
    return ds @ box


def wrap_positions(positions, box, box_inv=None):
    """Wrap absolute positions into the primary cell (fractional in [0, 1))."""
    if box_inv is None:
        box_inv = inv3x3(box)
    s = positions @ box_inv
    s = s - torch.floor(s)
    return s @ box
