"""The spread launchers' one-pass validation (admp_tpu_torch/ops/cuda/spread.py).

Each launcher (K4 ``launch_spread``, K6 ``launch_gather``, K5
``launch_spread_tiled``, K7 ``launch_gather_tiled``) raises ValueError before
it builds or launches anything on what its kernel cannot take: a CPU tensor,
float64, a non-contiguous tensor, a wrong shape, an order or a channel count
it has no template for, and bases that are not (N, 3) int32. The error names
the first failure, in the order order, type, contiguity, shape, device, so
each case shows here on the CPU; the tiled launchers check their bins first
(their order and tile, then their fit to the grid: tiles per axis, the
length of offsets and perm). The kernels themselves, and a device mismatch,
are held on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from admp_tpu_torch.ops.cuda import spread as S

GRID = (16, 12, 40)
LAUNCHERS = ("spread", "gather", "spread_tiled", "gather_tiled")


def _inputs(order=6, n_ch=1, n=20):
    rng = np.random.default_rng(2)
    m_u0 = torch.as_tensor(np.stack([rng.integers(0, k, n) for k in GRID],
                                    1).astype(np.int32))
    q = torch.as_tensor(rng.normal(size=(n, n_ch, order ** 3)),
                        dtype=torch.float32)
    mesh = torch.as_tensor(rng.normal(size=(n_ch,) + GRID),
                           dtype=torch.float32)
    return m_u0, q, mesh


def _launch(launcher, m_u0, q, mesh, order):
    """The launcher on the spread's stencil values or the gather's mesh."""
    x = q if launcher.startswith("spread") else mesh
    fn = getattr(S, f"launch_{launcher}")
    if launcher.endswith("tiled"):
        return fn(S.tile_bins(m_u0, GRID, S.TILE, order), x, GRID, order)
    return fn(m_u0, x, GRID, order)


def _strided(x):
    """x's values in a non-contiguous tensor of the same shape."""
    wide = x.new_empty(*x.shape[:-1], 2 * x.shape[-1])
    wide[..., ::2] = x
    return wide[..., ::2]


CASES = {
    # case: (what changes, the words the error carries)
    "cpu": (lambda m, q, g: (m, q, g, 6), "CUDA tensor"),
    "float64": (lambda m, q, g: (m, q.double(), g.double(), 6), "float32"),
    "non_contiguous": (lambda m, q, g: (m, _strided(q), _strided(g), 6),
                       "contiguous"),
    "wrong_shape": (lambda m, q, g: (m, q[:, :, :100].contiguous(),
                                     g[:, :8].contiguous(), 6), "shape"),
    "order_5": (lambda m, q, g: (m, q[:, :, :125].contiguous(), g, 5),
                "order=5"),
    "two_channels": (lambda m, q, g: (m, q.repeat(1, 2, 1), g.repeat(2, 1, 1, 1),
                                      6), r"C in \(1, 3\)"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("launcher", LAUNCHERS)
def test_launcher_refuses_what_its_kernel_cannot_take(launcher, case):
    change, words = CASES[case]
    m_u0, q, mesh, order = change(*_inputs())
    before = getattr(S, f"launch_{launcher}").launches
    with pytest.raises(ValueError, match=words):
        _launch(launcher, m_u0, q, mesh, order)
    assert getattr(S, f"launch_{launcher}").launches == before


@pytest.mark.parametrize("bases,words", [("int64", "int32"),
                                         ("two_columns", r"expected \(N, 3\)")])
@pytest.mark.parametrize("launcher", ["spread", "gather"])
def test_launcher_refuses_bases_its_kernel_cannot_take(launcher, bases, words):
    m_u0, q, mesh = _inputs()
    m_u0 = m_u0.long() if bases == "int64" else m_u0[:, :2].contiguous()
    with pytest.raises(ValueError, match=words):
        _launch(launcher, m_u0, q, mesh, 6)


@pytest.mark.parametrize("launcher", ["spread_tiled", "gather_tiled"])
def test_tiled_launcher_refuses_bins_of_another_order(launcher):
    m_u0, q, mesh = _inputs(order=4)
    fn = getattr(S, f"launch_{launcher}")
    x = q if launcher.startswith("spread") else mesh
    with pytest.raises(ValueError, match="bins of order 6"):
        fn(S.tile_bins(m_u0, GRID, S.TILE, 6), x, GRID, 4)


def _bins_of_another_grid(m_u0):
    # (32, 12, 40) has 4 tiles along x where GRID has 2
    return S.tile_bins(m_u0, (32, 12, 40), S.TILE, 6)


def _truncated_offsets(m_u0):
    bins = S.tile_bins(m_u0, GRID, S.TILE, 6)
    bins.offsets = bins.offsets[:-1]
    return bins


def _short_perm(m_u0):
    bins = S.tile_bins(m_u0, GRID, S.TILE, 6)
    bins.perm = bins.perm[1:]
    return bins


BAD_BINS = {
    # case: (the bins, the words the error carries)
    "another_grid": (_bins_of_another_grid, "tiles per axis"),
    "truncated_offsets": (_truncated_offsets, "offsets of shape"),
    "short_perm": (_short_perm, "perm of shape"),
}


@pytest.mark.parametrize("case", sorted(BAD_BINS))
@pytest.mark.parametrize("launcher", ["spread_tiled", "gather_tiled"])
def test_tiled_launcher_refuses_bins_of_another_grid(launcher, case):
    """Bins of the same order and tile but made for another grid, or whose
    offsets or permutation have the wrong length, are refused before the
    device check, so on the CPU too, and nothing launches."""
    make, words = BAD_BINS[case]
    m_u0, q, mesh = _inputs()
    fn = getattr(S, f"launch_{launcher}")
    x = q if launcher.startswith("spread") else mesh
    before = fn.launches
    with pytest.raises(ValueError, match=words):
        fn(make(m_u0), x, GRID, 6)
    assert fn.launches == before
