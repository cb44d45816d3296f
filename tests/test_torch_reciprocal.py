"""admp_tpu_torch reciprocal space against admp_tpu.

* The spread's plain version against the Pallas slab spread K4 in interpret
  mode at float32 (1e-5 max|mesh|: summation order) and against the XLA
  scatter at float64 (1e-12).
* The gather's plain version against the Pallas windowed gather K6
  (interpret mode) and the XLA row gather, exactly, at float64.
* Mesh coordinates, the mixing matrix, the separable stencil, k-space grids,
  the influence weights and make_pme_recip energies and gradients at
  float64 (1e-10 relative), including the cached-influence box guard.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.ops import reciprocal as jr
from admp_tpu.ops.influence import ck_1 as j_ck1
from admp_tpu.ops.pallas import spread as jsp
from admp_tpu_torch.ops import reciprocal as tr
from admp_tpu_torch.ops.cuda import spread as tsp
from admp_tpu_torch.ops.influence import ck_1 as t_ck1
from torch_port_cases import assert_close, t64, water

BOX = np.array([[9.3, 0.3, -0.2], [0.1, 9.1, 0.2], [-0.2, 0.1, 9.6]])


def _stencils(n=60, k=(20, 22, 24), order=6, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    m_u0 = np.stack([rng.integers(-3, kk + 3, n) for kk in k], 1).astype(np.int32)
    q = rng.normal(size=(n, order ** 3)).astype(dtype)
    return m_u0, q


def test_spread_matches_interpret_kernel_f32():
    grid = (24, 24, 24)
    m_u0, q = _stencils(n=150, k=grid, dtype=np.float32)
    want = np.asarray(jsp.spread_blocks(jnp.asarray(m_u0),
                                        jnp.asarray(q.reshape(-1, 6, 6, 6)),
                                        grid, 4, True))
    got = tsp.spread(torch.as_tensor(m_u0), torch.as_tensor(q)[:, None],
                     grid, 6)[0].numpy()
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("order,k", [(6, (20, 22, 24)), (4, (16, 18, 20))])
def test_spread_matches_xla_scatter_f64(order, k):
    m_u0, q = _stencils(k=k, order=order)
    if order == 6:
        want = jsp._xla_scatter(jnp.asarray(m_u0), jnp.asarray(q), k)
    else:
        want = jsp._xla_scatter_multi(jnp.asarray(m_u0),
                                      jnp.asarray(q[:, None]), k, order)[0]
    got = tsp.spread(torch.as_tensor(m_u0), t64(q)[:, None], k, order)[0]
    assert_close(got, want, rel=1e-12, abs_=0.0)


def test_spread_three_channels_f64():
    k, order = (16, 18, 20), 6
    rng = np.random.default_rng(1)
    m_u0, _ = _stencils(k=k)
    q = rng.normal(size=(m_u0.shape[0], 3, order ** 3))
    want = jsp._xla_scatter_multi(jnp.asarray(m_u0), jnp.asarray(q), k, order)
    assert_close(tsp.spread(torch.as_tensor(m_u0), t64(q), k, order), want,
                 rel=1e-12, abs_=0.0)


@pytest.mark.parametrize("grid", [(20, 22, 24), (16, 16, 128)])
def test_gather_matches_kernel_and_row_gather_exactly(grid):
    m_u0, _ = _stencils(k=grid)
    rng = np.random.default_rng(2)
    g_mesh = rng.normal(size=(1, *grid))
    # K3 % 128 == 0 takes the XLA row gather, otherwise the Pallas gather
    want = np.asarray(jsp.gather_blocks(jnp.asarray(m_u0), jnp.asarray(g_mesh),
                                        grid, 6, 4, True))
    got = tsp.gather_torch(torch.as_tensor(m_u0), t64(g_mesh), grid, 6).numpy()
    np.testing.assert_array_equal(got, want)
    rows = np.asarray(jsp._row_gather_impl(jnp.asarray(m_u0),
                                           jnp.asarray(g_mesh), grid, 6))
    np.testing.assert_array_equal(got, rows)


def test_spread_gather_are_adjoint():
    grid = (12, 14, 16)
    m_u0, q = _stencils(n=40, k=grid)
    rng = np.random.default_rng(3)
    g = rng.normal(size=(1, *grid))
    m_t = torch.as_tensor(m_u0)
    lhs = float(torch.sum(tsp.spread(m_t, t64(q)[:, None], grid, 6) * t64(g)))
    rhs = float(torch.sum(tsp.gather_torch(m_t, t64(g), grid, 6)[:, 0] * t64(q)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_spread_pipeline(lmax):
    s = water(n_side=2, seed=2)
    grid, n_h = (18, 20, 22), (lmax + 1) ** 2
    pos, q = s["positions"], s["q_local"][:, :n_h]
    jm, ju, jd = jr.mesh_coordinates(jnp.asarray(pos), jnp.asarray(BOX), grid)
    tm, tu, td = tr.mesh_coordinates(t64(pos), t64(BOX), grid)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert_close(tu, ju)
    assert_close(td, jd)
    assert_close(tr.spread_mixing_matrix(td, lmax),
                 jr.spread_mixing_matrix(jd, lmax))
    _, _, ja = jr.atom_spread_alpha(jnp.asarray(pos), jnp.asarray(BOX),
                                    jnp.asarray(q), grid, lmax)
    _, _, ta = tr.atom_spread_alpha(t64(pos), t64(BOX), t64(q), grid, lmax)
    assert_close(ta, ja)
    assert_close(tr.spread_points_separable(tu, ta, lmax),
                 jr.spread_points_separable(ju, ja, lmax))
    assert_close(tr.spread_to_mesh(t64(pos), t64(BOX), t64(q), grid, lmax),
                 jr.spread_to_mesh(jnp.asarray(pos), jnp.asarray(BOX),
                                   jnp.asarray(q), grid, lmax))


@pytest.mark.parametrize("order", [4, 6])
def test_k_space_and_influence(order):
    grid = (15, 16, 18)
    jk, jt = jr.k_space_grids(jnp.asarray(BOX), grid, jnp.float64, True, order)
    tk, tt = tr.k_space_grids(t64(BOX), grid, torch.float64, order)
    assert_close(tk, jk)
    assert_close(tt, jt)
    jw, _ = jr.influence_weights(jnp.asarray(BOX), grid, 0.7, j_ck1, False,
                                 order, jnp.float64)
    assert_close(tr.influence_weights(t64(BOX), grid, 0.7, t_ck1, order), jw)


@pytest.mark.parametrize("lmax,order,cached", [(0, 6, False), (1, 6, False),
                                               (2, 6, False), (2, 6, True),
                                               (1, 4, True)])
def test_make_pme_recip_energy_and_gradients(lmax, order, cached):
    s = water(n_side=2, seed=6)
    grid, n_h = (16, 18, 20), (lmax + 1) ** 2
    pos, q = s["positions"], s["q_local"][:, :n_h]
    kw = dict(prefactor=1389.35455846, compensated=True, spread_order=order)
    jf = jr.make_pme_recip(j_ck1, 0.7, False, grid, lmax,
                           static_box=jnp.asarray(BOX) if cached else None,
                           spread_method="scatter", **kw)
    tf = tr.make_pme_recip(t_ck1, 0.7, grid, lmax,
                           static_box=t64(BOX) if cached else None,
                           spread_method="auto", **kw)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        ej, gj = jax.value_and_grad(jf, argnums=(0, 1, 2))(
            jnp.asarray(pos), jnp.asarray(BOX), jnp.asarray(q))
    leaves = [t64(v).requires_grad_(True) for v in (pos, BOX, q)]
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        et = tf(*leaves)
        gt = torch.autograd.grad(et, leaves)
    assert_close(et.detach(), ej)
    for a, b in zip(gt, gj):
        assert_close(a, b)
    if cached:
        # the guard: zero box gradient from the influence term, loudly
        assert any("cache_influence" in str(w.message) for w in tw)
        assert any("cache_influence" in str(w.message) for w in jw)
    else:
        assert float(torch.max(torch.abs(gt[1]))) > 0.0


def test_recip_induced_dipoles_on_their_own_mesh():
    s = water(n_side=2, seed=8)
    grid = (16, 16, 18)
    rng = np.random.default_rng(4)
    u = rng.normal(0, 0.05, (s["positions"].shape[0], 3))
    jf = jr.make_pme_recip(j_ck1, 0.7, False, grid, 0, spread_method="scatter")
    tf = tr.make_pme_recip(t_ck1, 0.7, grid, 0)
    args = (s["positions"], BOX, s["q_local"][:, :1], u)
    assert_close(tf(*[t64(a) for a in args]),
                 jf(*[jnp.asarray(a) for a in args]))
