"""Ewald/PME parameter heuristics (admp_tpu/ops/ewald.py), host-side numpy."""

from __future__ import annotations

import numpy as np


def next_fft_friendly(n: int) -> int:
    """Smallest 5-smooth integer >= n."""
    m = int(n)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def setup_ewald_parameters(rc: float, ethresh: float, box) -> tuple:
    """kappa = sqrt(-log(2 ethresh)) / rc and
    K_i = ceil(2 kappa L_i / (3 ethresh^(1/5))) from the box diagonal.
    Returns (kappa, K1, K2, K3)."""
    box = np.asarray(box)
    kappa = float(np.sqrt(-np.log(2.0 * ethresh)) / rc)
    ks = [int(np.ceil(2.0 * kappa * box[i, i] / 3.0 / ethresh**0.2))
          for i in range(3)]
    return (kappa, ks[0], ks[1], ks[2])


def setup_ewald_parameters_fft(rc: float, ethresh: float, box) -> tuple:
    """As setup_ewald_parameters with 5-smooth mesh sizes."""
    kappa, k1, k2, k3 = setup_ewald_parameters(rc, ethresh, box)
    return (kappa, next_fft_friendly(k1), next_fft_friendly(k2),
            next_fft_friendly(k3))


def lane_align_k3(k3: int, max_stretch: float = 4.0 / 3.0) -> int:
    """K3 rounded up to a multiple of 128 when the stretch stays within
    ``max_stretch`` (an explicit ``lane_align_grid=True`` only)."""
    k3 = int(k3)
    if k3 % 128 == 0:
        return k3
    aligned = -(-k3 // 128) * 128
    return aligned if aligned <= k3 * max_stretch else k3
