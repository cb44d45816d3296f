"""The tiled spread pair's plain versions (K5, K7 of ops/cuda/spread.py)
against admp_tpu's 2-D blocked Pallas kernels and the port's plain spread.

* ``spread_tiled_torch`` against ``spread_blocks_2d`` / ``spread_blocks_2d_multi``
  in interpret mode at float32 (1e-5 max|mesh|: summation order).
* ``gather_tiled_torch`` against ``_pallas_gather2d_impl(variant="mxu")`` in
  interpret mode, bit for bit.
* Both against ``spread_torch`` / ``gather_torch`` at (order, C) (6, 1) and
  (4, 3), on grids the tile divides, does not divide, and that are smaller
  than a tile plus its halo, and with fewer points on an axis than the
  stencil (1e-12 max|mesh| at float64; the gather bit for bit).
* ``tile_bins`` is a stable permutation with consistent offsets.
* The 'auto' route is a pure function of the type, device type, order, mesh
  bytes and L2 size; ``'cuda2d'`` is a spread method only.
* ``SpreadTiledFn`` / ``GatherTiledFn`` on CPU tensors (their plain
  versions) pass gradcheck and gradgradcheck and are each other's adjoint.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.ops.pallas import spread as jsp
from admp_tpu_torch import EngineConfig
from admp_tpu_torch.ops import reciprocal as tr
from admp_tpu_torch.ops.cuda import spread as S

L2_H100 = 50 * 1024 * 1024


def _bases(grid, n, rng):
    return np.stack([rng.integers(0, k, n) for k in grid], 1).astype(np.int32)


@pytest.mark.parametrize("order,n_ch", [(6, 1), (4, 3)])
def test_tiled_spread_matches_pallas_2d_interpret(order, n_ch):
    rng = np.random.default_rng(7)
    grid, n = (32, 32, 32), 160
    m_u0 = _bases(grid, n, rng)
    q = rng.normal(size=(n, n_ch, order ** 3)).astype(np.float32)
    if n_ch == 1:
        want = np.asarray(jsp.spread_blocks_2d(
            jnp.asarray(m_u0), jnp.asarray(q.reshape(n, 6, 6, 6)), grid, 4, 4,
            True))[None]
    else:
        want = np.asarray(jsp.spread_blocks_2d_multi(
            jnp.asarray(m_u0), jnp.asarray(q), grid, order, 4, 4, True))
    bins = S.tile_bins(torch.as_tensor(m_u0), grid, S.TILE, order)
    got = S.spread_tiled_torch(bins, torch.as_tensor(q), grid, order).numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("grid,nx,ny", [((64, 32, 32), 8, 4),
                                        ((32, 32, 32), 4, 2)])
def test_tiled_gather_matches_pallas_mxu_gather_bitwise(grid, nx, ny):
    rng = np.random.default_rng(5)
    n = 300
    m_u0 = _bases(grid, n, rng)
    g = rng.standard_normal((1,) + grid).astype(np.float32)
    want, overflow = jsp._pallas_gather2d_impl(
        jnp.asarray(m_u0), jnp.asarray(g), grid, nx, ny, interpret=True,
        order=6, variant="mxu")
    assert not bool(overflow)
    bins = S.tile_bins(torch.as_tensor(m_u0), grid, S.TILE, 6)
    got = S.gather_tiled_torch(bins, torch.as_tensor(g), grid, 6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(got.shape))


# a grid the tile (8, 8, 32) divides, two it does not, one smaller than a
# tile plus its halo on every axis, one with axes shorter than the stencil
GRIDS = [(16, 16, 64), (25, 18, 45), (20, 27, 50), (6, 10, 12), (5, 4, 7)]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("order,n_ch", [(6, 1), (4, 3)])
def test_tiled_plain_versions_match_plain_spread(grid, order, n_ch):
    rng = np.random.default_rng(sum(grid) + order)
    n = 200
    # bases beyond [0, K): mesh_coordinates does not wrap drifted positions
    m_u0 = torch.as_tensor(np.stack([rng.integers(-9, k + 9, n)
                                     for k in grid], 1).astype(np.int32))
    q = torch.as_tensor(rng.normal(size=(n, n_ch, order ** 3)))
    bins = S.tile_bins(m_u0, grid, S.TILE, order)
    want = S.spread_torch(m_u0, q, grid, order)
    got = S.spread_tiled_torch(bins, q, grid, order)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    g = torch.as_tensor(rng.normal(size=(n_ch,) + grid))
    assert torch.equal(S.gather_tiled_torch(bins, g, grid, order),
                       S.gather_torch(m_u0, g, grid, order))


@pytest.mark.parametrize("grid,order", [((16, 16, 64), 6), ((25, 18, 45), 4),
                                        ((5, 4, 7), 6)])
def test_tile_bins_is_a_stable_permutation(grid, order):
    rng = np.random.default_rng(3)
    n = 500
    m_u0 = torch.as_tensor(np.stack([rng.integers(-9, k + 9, n)
                                     for k in grid], 1).astype(np.int32))
    bins = S.tile_bins(m_u0, grid, S.TILE, order)
    perm = bins.perm.long()
    assert torch.equal(torch.sort(perm).values, torch.arange(n))
    want_base = torch.remainder(m_u0.long() - order // 2,
                                torch.tensor(grid))[perm]
    assert torch.equal(bins.base.long(), want_base)
    nt = bins.n_tiles
    assert nt == tuple(-(-k // t) for k, t in zip(grid, S.TILE))
    off = bins.offsets.long()
    assert off.shape == (nt[0] * nt[1] * nt[2] + 1,)
    assert int(off[0]) == 0 and int(off[-1]) == n
    assert bool((off[1:] >= off[:-1]).all())
    tb = torch.div(want_base, torch.tensor(S.TILE), rounding_mode="floor")
    tid = (tb[:, 0] * nt[1] + tb[:, 1]) * nt[2] + tb[:, 2]
    for t in range(len(off) - 1):
        lo, hi = int(off[t]), int(off[t + 1])
        assert bool((tid[lo:hi] == t).all())
        assert bool((perm[lo + 1:hi] > perm[lo:hi - 1]).all())  # stable


def test_auto_route_is_a_pure_function_of_its_inputs():
    route = tr.auto_spread_route
    f32, f64 = torch.float32, torch.float64
    mesh = lambda *k: 4 * int(np.prod(k))  # noqa: E731
    # the port's meshes against the H100's 50 MB L2
    assert route(f32, "cuda", 6, mesh(96, 96, 128), L2_H100) == "cuda"
    assert route(f32, "cuda", 6, mesh(128, 128, 128), L2_H100) == "cuda"
    assert route(f32, "cuda", 6, mesh(3, 128, 128, 128), L2_H100) == "cuda"
    assert route(f32, "cuda", 6, mesh(256, 256, 256), L2_H100) == "cuda2d"
    assert route(f32, "cuda", 6, mesh(320, 320, 320), L2_H100) == "cuda2d"
    assert route(f32, "cuda", 6, L2_H100, L2_H100) == "cuda"
    assert route(f32, "cuda", 6, L2_H100 + 4, L2_H100) == "cuda2d"
    assert route(f32, "cuda", 6, mesh(320, 320, 320), 10 ** 9) == "cuda"
    # order 4 (the matvec mesh), float64 and the CPU stay plain
    assert route(f32, "cuda", 4, mesh(320, 320, 320), L2_H100) == "torch"
    assert route(f64, "cuda", 6, mesh(320, 320, 320), L2_H100) == "torch"
    assert route(f32, "cpu", 6, mesh(320, 320, 320), L2_H100) == "torch"

    x = torch.zeros(3, 3)
    assert tr.resolve_spread_method("auto", x, 6, (320,) * 3) == "torch"
    assert tr.resolve_spread_method("torch", x, 6, (320,) * 3) == "torch"
    for forced in ("cuda", "cuda2d"):
        with pytest.raises(ValueError, match="CUDA"):
            tr.resolve_spread_method(forced, x, 6, (32,) * 3)
    with pytest.raises(ValueError, match="expected one of"):
        tr.resolve_spread_method("pallas2d", x, 6, (32,) * 3)
    assert EngineConfig(spread_method="cuda2d").spread_method == "cuda2d"
    with pytest.raises(ValueError, match="pair_kernel"):
        EngineConfig(pair_kernel="cuda2d")


def test_tiled_functions_are_adjoint_and_twice_differentiable():
    rng = np.random.default_rng(11)
    grid, order, n = (5, 6, 7), 4, 4
    m_u0 = torch.as_tensor(_bases(grid, n, rng))
    bins = S.tile_bins(m_u0, grid, S.TILE, order)
    q = torch.as_tensor(rng.normal(size=(n, 1, order ** 3)),
                        ).requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(1,) + grid)).requires_grad_(True)

    def spread(x):
        return S.SpreadTiledFn.apply(x, bins, grid, order)

    def gather(x):
        return S.GatherTiledFn.apply(x, bins, grid, order)

    lhs = float((spread(q) * g).sum().detach())
    rhs = float((q * gather(g)).sum().detach())
    assert lhs == pytest.approx(rhs, rel=1e-12)
    assert torch.autograd.gradcheck(spread, (q,))
    assert torch.autograd.gradcheck(gather, (g,))
    assert torch.autograd.gradgradcheck(lambda x: spread(x) ** 2, (q,))
    assert torch.autograd.gradgradcheck(lambda x: gather(x) ** 2, (g,))
