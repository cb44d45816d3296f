"""admp_tpu_torch's dispersion PME against admp_tpu at float64.

* ck_6/8/10 with their k = 0 limits and the dispersion self energy (1e-12
  relative).
* The real-space pair energy over 1000 random pairs, masked and excluded
  ones among them (1e-12 of max|e|).
* spread_to_mesh_multi at orders 4 and 6 against admp_tpu's XLA scatter on a
  192-atom box and a (24, 24, 32) grid (1e-12 of max|mesh|), and the plain
  three-channel spread and gather under gradcheck.
* make_disp_pme_recip with and without a static box (1e-10 relative energy,
  position and c_list gradients).
* ADMPDispPmeForce: energy, forces, dE/dc_list, metrics and the pmax_recip
  truncation (1e-10 relative energy, 1e-9 relative RMSE), and its carry-
  across from admp_tpu (convert.disp_force_from_jax), which copies.
* The float32 floor of the dispersion energy and forces on the CPU against
  float64, stated in the assertion bounds.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import ADMPDispPmeForce as JDisp
from admp_tpu.ops import reciprocal as jr
from admp_tpu.ops.dispersion import dispersion_pair_energy as j_pair
from admp_tpu.ops.influence import ck_6 as j6, ck_8 as j8, ck_10 as j10
from admp_tpu.ops.selfenergy import dispersion_self_energy as j_self
from admp_tpu.settings import EngineConfig as JEngine
from admp_tpu_torch import ADMPDispPmeForce, EngineConfig
from admp_tpu_torch.convert import convert_state, disp_force_from_jax
from admp_tpu_torch.ops import reciprocal as tr
from admp_tpu_torch.ops.cuda import spread as tsp
from admp_tpu_torch.ops.dispersion import dispersion_pair_energy as t_pair
from admp_tpu_torch.ops.influence import ck_6 as t6, ck_8 as t8, ck_10 as t10
from admp_tpu_torch.ops.selfenergy import dispersion_self_energy as t_self
from torch_port_cases import assert_close, dense_pairs, rel_err, t64, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
RC, ETHRESH, KAPPA = 4.0, 1e-4, 0.657065221219616
GRID = (24, 24, 32)
J_CK = (j6, j8, j10)
T_CK = (t6, t8, t10)


def test_influence_kernels_and_self_energy():
    rng = np.random.default_rng(0)
    ksq = np.concatenate([rng.uniform(1e-6, 1e-2, 50), rng.uniform(0.01, 30, 200)])
    vol = 1234.5
    for jf, tf in zip(J_CK, T_CK):
        assert_close(tf(t64(ksq), 0.7, vol), jf(jnp.asarray(ksq), 0.7, vol),
                     rel=1e-12, abs_=0.0)
        assert abs(tf.at_zero(0.7, vol) - jf.at_zero(0.7, vol)) <= 1e-12 * abs(
            jf.at_zero(0.7, vol))
        # the k -> 0 limit is the kernel's own
        assert abs(float(tf(t64([1e-14]), 0.7, vol)) - tf.at_zero(0.7, vol)) \
            <= 1e-6 * tf.at_zero(0.7, vol)
    c = rng.uniform(1, 100, (40, 3))
    for pmax in (6, 8, 10):
        assert_close(t_self(t64(c), KAPPA, pmax), j_self(jnp.asarray(c), KAPPA, pmax),
                     rel=1e-12, abs_=0.0)


@pytest.mark.parametrize("pmax", [6, 8, 10])
def test_dispersion_pair_energy(pmax):
    rng = np.random.default_rng(pmax)
    n = 1000
    r2 = rng.uniform(0.8, 16.0, n)
    r2[:100] = 1.0  # masked pairs carry r2 = 1
    c_i, c_j = rng.uniform(5, 130, (n, 3)), rng.uniform(5, 130, (n, 3))
    mscale = rng.choice([0.0, 0.5, 1.0], n)  # excluded pairs cancel
    want = j_pair(*(jnp.asarray(x) for x in (r2, c_i, c_j, mscale)), KAPPA, pmax)
    got = t_pair(*(t64(x) for x in (r2, c_i, c_j, mscale)), KAPPA, pmax)
    assert_close(got, want, rel=1e-12, abs_=0.0)


@pytest.mark.parametrize("order", [4, 6])
def test_spread_to_mesh_multi(order):
    s = water(n_side=4, seed=3)
    pos, box, c = s["positions"], s["box"], s["c_list"]
    want = jr.spread_to_mesh_multi(jnp.asarray(pos), jnp.asarray(box),
                                   jnp.asarray(c), GRID, order, "scatter")
    got = tr.spread_to_mesh_multi(t64(pos), t64(box), t64(c), GRID, order)
    assert got.shape == (3, *GRID)
    assert_close(got, want, rel=1e-12, abs_=0.0)


def test_plain_three_channel_spread_and_gather_gradcheck():
    """The plain versions SpreadFn and GatherFn stand for on the CPU, at
    (C=3, order 4): first and second derivatives by finite differences."""
    grid = (4, 5, 6)
    rng = np.random.default_rng(1)
    m_u0 = torch.as_tensor(rng.integers(-2, 7, (2, 3)), dtype=torch.int32)
    q = t64(rng.normal(size=(2, 3, 64))).requires_grad_(True)
    mesh = t64(rng.normal(size=(3, *grid))).requires_grad_(True)
    spread = lambda x: tsp.spread(m_u0, x, grid, 4) ** 2  # noqa: E731
    gather = lambda x: tsp.gather_torch(m_u0, x, grid, 4) ** 2  # noqa: E731
    assert torch.autograd.gradcheck(spread, (q,))
    assert torch.autograd.gradgradcheck(spread, (q,))
    assert torch.autograd.gradcheck(gather, (mesh,))
    assert torch.autograd.gradgradcheck(gather, (mesh,))


@pytest.mark.parametrize("order,cached", [(4, False), (4, True), (6, False)])
def test_make_disp_pme_recip(order, cached):
    s = water(n_side=4, seed=5)
    pos, box, c = s["positions"], s["box"], s["c_list"]
    jf = jr.make_disp_pme_recip(J_CK, KAPPA, GRID,
                                jnp.asarray(box) if cached else None, order,
                                "scatter")
    tf = tr.make_disp_pme_recip(T_CK, KAPPA, GRID,
                                t64(box) if cached else None, order)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the box guard of the cached engine
        ej, gj = jax.value_and_grad(jf, argnums=(0, 1, 2))(
            jnp.asarray(pos), jnp.asarray(box), jnp.asarray(c))
        leaves = [t64(v).requires_grad_(True) for v in (pos, box, c)]
        et = tf(*leaves)
        gt = torch.autograd.grad(et, leaves)
    assert abs(float(et.detach()) - float(ej)) <= 1e-10 * abs(float(ej))
    # positions, box (with the influence term unless cached: then zero in
    # both) and c_list
    for a, b in zip(gt, gj):
        assert_close(a, b, rel=1e-9, abs_=0.0)
    # convolve_energy_multi is the same energy from the mesh
    meshes = tr.spread_to_mesh_multi(t64(pos), t64(box), t64(c), GRID, order)
    e2 = tr.convolve_energy_multi(meshes, t64(box), KAPPA, T_CK, True,
                                  order=order)
    assert abs(float(e2) - float(ej)) <= 1e-10 * abs(float(ej))


def _forces(pmax=10, pmax_recip=None, order=4, seed=4):
    s = water(n_side=4, seed=seed)
    cfg = JEngine(cache_influence=True, disp_ethresh=2e-4,
                  disp_spread_order=order, pmax_recip=pmax_recip)
    jf = JDisp(jnp.asarray(s["box"]), s["covalent_map"], RC, ETHRESH, pmax,
               config=cfg)
    jf.kappa = KAPPA
    jf.refresh_calculators()
    tf = disp_force_from_jax(jf, s["box"], device="cpu")
    s["pairs"] = dense_pairs(s["positions"], s["box"], RC)
    return s, jf, tf


@pytest.mark.parametrize("pmax,pmax_recip,order", [(10, None, 4), (10, None, 6),
                                                   (8, None, 4), (10, 6, 4)])
def test_disp_force_energy_forces_and_c_gradient(pmax, pmax_recip, order):
    s, jf, tf = _forces(pmax, pmax_recip, order)
    assert (tf.kappa, tf.K1, tf.K2, tf.K3) == (jf.kappa, jf.K1, jf.K2, jf.K3)
    assert tf._pmax_recip == jf._pmax_recip
    args = [s[k] for k in ("positions", "box", "pairs", "c_list")] + [SCALES]
    ej, gj = jf.get_forces(*[jnp.asarray(a) for a in args])
    et, gt = tf.get_forces(*[t64(a) if k != 2 else torch.as_tensor(a)
                             for k, a in enumerate(args)])
    assert abs(float(et) - float(ej)) <= 1e-10 * abs(float(ej))
    assert rel_err(gt, gj) < 1e-9
    # dE/dc_list through get_energy
    gcj = jax.grad(lambda c: jf.get_energy(*[jnp.asarray(a) for a in args[:3]],
                                           c, jnp.asarray(SCALES)))(
        jnp.asarray(s["c_list"]))
    c_t = t64(s["c_list"]).requires_grad_(True)
    (gct,) = torch.autograd.grad(
        tf.get_energy(t64(s["positions"]), t64(s["box"]),
                      torch.as_tensor(s["pairs"]), c_t, t64(SCALES)), c_t)
    assert rel_err(gct, gcj) < 1e-9
    mj = jf.get_metrics(*[jnp.asarray(a) for a in args])
    mt = tf.get_metrics(*[t64(a) if k != 2 else torch.as_tensor(a)
                          for k, a in enumerate(args)])
    for k in ("e_disp_real", "e_disp_recip", "e_disp_self", "e_disp_total"):
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-10 * abs(float(mj[k])), k


def test_disp_force_writable_grid_update_env_and_box_guard():
    s, jf, tf = _forces()
    args = [s[k] for k in ("positions", "box", "pairs", "c_list")] + [SCALES]
    for f in (jf, tf):
        f.update_env("K3", 30)
        f.update_env("kappa", 0.7)
    ej = jf.get_energy(*[jnp.asarray(a) for a in args])
    et = tf.get_energy(*[torch.as_tensor(a) for a in args])
    assert abs(float(et) - float(ej)) <= 1e-10 * abs(float(ej))
    # the cached influence grids give a zero box gradient, loudly
    box = t64(s["box"]).requires_grad_(True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        e = tf.get_energy(t64(s["positions"]), box, torch.as_tensor(s["pairs"]),
                          t64(s["c_list"]), t64(SCALES))
        torch.autograd.grad(e, box)
    assert any("cache_influence" in str(x.message) for x in w)


def test_carry_across_copies():
    """Port-side in-place updates never write into admp_tpu's arrays."""
    s, jf, tf = _forces()
    c_np = np.array(s["c_list"])
    c_jax = jnp.asarray(c_np)
    st = convert_state(device="cpu", c_list=c_np, tt_a=s["tt_a"], tt_b=s["tt_b"],
                       tt_q=s["tt_q"])
    st2 = convert_state(device="cpu", c_list=c_jax)
    for t in (st["c_list"], st2["c_list"], st["tt_a"]):
        t.mul_(2.0)
    np.testing.assert_array_equal(c_np, s["c_list"])
    np.testing.assert_array_equal(np.asarray(c_jax), s["c_list"])
    assert torch.equal(st["tt_b"], t64(s["tt_b"]))
    # the force's covalent map is its own too
    tf.covalent_map.zero_()
    assert np.asarray(jf.covalent_map).any()


def test_float32_floor_against_float64():
    """The f32 dispersion step on the CPU against f64. The floor measured
    here: energy 1.7e-6 relative, forces 6.3e-5 relative RMSE; the real
    term carries ~5e-4 of its own, from (mscale + g_p - 1) of the excluded
    intramolecular pairs. Bounds: 1e-5 and 2e-4."""
    s = water(n_side=4, seed=4)
    pairs = torch.as_tensor(dense_pairs(s["positions"], s["box"], RC))
    out = {}
    for dtype in (torch.float32, torch.float64):
        f = ADMPDispPmeForce(s["box"], s["covalent_map"], RC, ETHRESH, 10,
                             config=EngineConfig(cache_influence=True,
                                                 disp_spread_order=4,
                                                 disp_ethresh=2e-4),
                             device="cpu", dtype=dtype)
        out[dtype] = f.get_forces(s["positions"], s["box"], pairs,
                                  s["c_list"], SCALES)
    (e32, g32), (e64, g64) = out[torch.float32], out[torch.float64]
    assert abs(float(e32) - float(e64)) <= 1e-5 * abs(float(e64))
    assert rel_err(g32, g64) < 2e-4
