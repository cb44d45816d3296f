"""Shared inputs for the tests that hold admp_tpu_torch against admp_tpu.

Every input is made with numpy from a fixed seed and handed to both packages
(JAX arrays and torch tensors); results come back as numpy for comparison.
"""

import numpy as np
import torch

from admp_tpu.systems import water_system


def rel_err(a, b):
    """Relative RMSE of ``a`` against the reference ``b``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / (np.sqrt(np.mean(b ** 2)) + 1e-300))


def assert_close(a, b, rel=1e-10, abs_=1e-12):
    """Elementwise: |a - b| <= abs_ + rel * max|b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    tol = abs_ + rel * float(np.max(np.abs(b), initial=0.0))
    err = float(np.max(np.abs(a - b), initial=0.0))
    assert err <= tol, (err, tol)


def t64(x):
    return torch.as_tensor(np.array(x, np.float64))


def water(n_side=3, seed=4):
    """A liquid-density MPID water box (3 n_side^3 atoms) and its local
    harmonic multipoles."""
    s = water_system(n_side=n_side, spacing=3.1, jitter=0.12, seed=seed)
    from admp_tpu.ops.harmonics import _cart2harm_matrix

    s["q_local"] = s["q_cart"] @ _cart2harm_matrix(2).T
    return s


def dense_pairs(positions, box, cutoff):
    """i-sorted i<j pairs within ``cutoff`` (minimum image), padded with
    (n, n) to a multiple of 128."""
    n = positions.shape[0]
    inv = np.linalg.inv(box)
    ds = (positions @ inv)[:, None] - (positions @ inv)[None]
    ds -= np.floor(ds + 0.5)
    r2 = np.sum((ds @ box) ** 2, axis=-1)
    ii, jj = np.nonzero(np.triu(r2 < cutoff * cutoff, k=1))
    cap = -(-(len(ii) + 1) // 128) * 128
    pairs = np.full((cap, 2), n, dtype=np.int64)
    pairs[: len(ii), 0], pairs[: len(ii), 1] = ii, jj
    return pairs
