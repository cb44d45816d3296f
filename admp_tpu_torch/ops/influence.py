"""Reciprocal-space influence function of electrostatics
(admp_tpu/ops/influence.py: ck_1). The dispersion kernels ck_6..ck_10 wait
(ROADMAP.md queue 1, S3)."""

from __future__ import annotations

import math

import torch


def ck_1(ksq, kappa, volume):
    """Coulomb 1/r influence: 2 pi / (V k^2) exp(-k^2 / 4 kappa^2). The gamma
    point is excluded."""
    return 2.0 * math.pi / volume / ksq * torch.exp(-ksq / 4.0 / kappa**2)
