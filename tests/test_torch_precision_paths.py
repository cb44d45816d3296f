"""The precision modes on the two paths of the port that
test_torch_precision.py does not ladder: the polarizable MD step and the
large-system shape, each against admp_tpu at float32 on f32-representable
inputs, and both packages against the port's float64 path of the same
configuration (test_torch_precision.py holds that path against admp_tpu's
to 1e-9).

* The polarizable MD profile (SCFConfig.md(): Feynman-Hellmann forces at
  field_tol 0.3, the order-4 half-resolution matvec mesh, dipoles carried
  from step to step) under 'f64-all' (high_accuracy() with every pair in
  float64) and under spread_precision='f64', over two drift steps on
  water_system(n_side=2) (24 atoms, 8^3, kappa 0.7, dense pairs within 4 A).
  Each step: the same PCG iterations as admp_tpu; energy, forces and
  induced dipoles within TOL_PORT_VS_JAX of admp_tpu's (the gap between
  the two packages' f32 pipelines on this box, measured, doubled); each
  package's forces within TOL_VS_F64 of float64.
* The 98k path's shape at 3 waters per side (81 atoms): SparseExclusions,
  i-sorted cell-list pairs (rc 3 A: three cells per axis), the 5-smooth
  grid, charges that follow each water's O-H stretches (forces through the
  geometry and Q_local), under high_accuracy(), at two configurations:
  energy and forces within admp_tpu's at the bounds test_torch_precision.py
  sets for the modes below the f32 floor (forces 2e-6, energy 1e-6;
  measured 2.5e-7 and 6.3e-7), and within 5e-6 (forces) and 1e-6 (energy)
  of float64 (measured 3.6e-7 and 1.8e-7; the plain f32 route's forces sit
  5.4e-4-6.1e-4 off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import ADMPPmeForce as JForce
from admp_tpu import neighbor_list_cell as j_cell
from admp_tpu.ops.exclusions import build_sparse_exclusions as j_sparse
from admp_tpu.settings import EngineConfig as JEngine
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch import neighbor_list_cell
from admp_tpu_torch.convert import force_from_jax
from admp_tpu_torch.examples.fluctuating_multipoles import fluctuating_q_local
from admp_tpu_torch.systems import water_system as t_water_system
from test_torch_large import _j_fluctuating
from torch_port_cases import dense_pairs, rel_err, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
KAPPA, K = 0.7, 8
F32 = torch.float32

# polarizable MD profile: admp_tpu's configurations
MD_MODES = {
    "f64-all": lambda: JEngine.high_accuracy(realspace_precision="f64-all",
                                             scf=JSCF.md()),
    "spread-f64": lambda: JEngine(spread_precision="f64", scf=JSCF.md()),
}
# port vs admp_tpu at float32, forces and induced dipoles, relative RMSE:
# 'f64-all' at test_torch_precision.py's bound for the modes below the f32
# floor (measured 7.6e-8); 'spread-f64' twice the largest gap measured over
# the two steps (2.3e-6)
TOL_PORT_VS_JAX = {"f64-all": 2e-6, "spread-f64": 5e-6}
F32_EPS = float(np.finfo(np.float32).eps)
# each package at float32 against float64, forces and dipoles, relative
# RMSE: admp_tpu's bound for 'f64-all' (tests/test_precision.py); under
# 'spread-f64' the f32 real space stays (measured 1.2e-6-2.0e-6, the plain
# f32 route 1.8e-4-2.9e-4 on the same steps)
TOL_VS_F64 = {"f64-all": 5e-6, "spread-f64": 1e-5}


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


@pytest.fixture(scope="module")
def water24():
    s = water(n_side=2, seed=0)
    s["pairs"] = dense_pairs(s["positions"], s["box"], 4.0)
    for k in ("positions", "box", "q_local", "pol", "tholes"):
        s[k] = _f32(s[k])
    s["drift"] = 0.005 * np.random.default_rng(1).standard_normal(
        s["positions"].shape)
    return s


def _pol_args(s, pos, lib, dtype):
    arrays = [pos, s["box"]]
    rest = [s["q_local"], s["pol"], s["tholes"], SCALES, SCALES, SCALES]
    if lib == "jax":
        d = jnp.float64 if dtype == torch.float64 else jnp.float32
        return ([jnp.asarray(a, d) for a in arrays] + [jnp.asarray(s["pairs"])]
                + [jnp.asarray(a, d) for a in rest])
    return ([torch.tensor(a, dtype=dtype) for a in arrays]
            + [torch.tensor(s["pairs"])]
            + [torch.tensor(a, dtype=dtype) for a in rest])


@pytest.mark.parametrize("mode", sorted(MD_MODES))
def test_polarizable_md_profile_two_drift_steps(water24, mode):
    s = water24
    jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                s["covalent_map"], 3.0, 1e-3, lmax=2, lpol=True,
                config=MD_MODES[mode]())
    jf.kappa = KAPPA
    jf.K1 = jf.K2 = jf.K3 = K
    jf.refresh_calculators()
    tf = force_from_jax(jf, s["box"], device="cpu", dtype=F32)
    ref = force_from_jax(jf, s["box"], device="cpu", dtype=torch.float64)
    # the half-resolution matvec grid stays at 8^3 (at least 32 per axis,
    # at most the energy grid)
    assert tf.matvec_grid == ref.matvec_grid == (K, K, K)
    pos = s["positions"]
    for step in range(2):
        ej, gj = jf.get_forces(*_pol_args(s, pos, "jax", F32))
        et, gt = tf.get_forces(*_pol_args(s, pos, "torch", F32))
        e64, g64 = ref.get_forces(*_pol_args(s, pos, "torch",
                                             torch.float64))
        gj, gt, g64 = (np.asarray(g, np.float64) for g in (gj, gt, g64))
        assert tf.lconverg and bool(jf.lconverg), step
        assert tf.n_cycle == int(jf.n_cycle) == ref.n_cycle, step
        # energy: the port's error against float64 within 1.5x admp_tpu's
        # plus two f32 units of the total (both round it to float32; under
        # 'spread-f64' admp_tpu's sits 9e-4 kJ/mol off, the port's 6e-4)
        de_t, de_j = abs(float(et) - float(e64)), abs(float(ej) - float(e64))
        assert de_t <= 1.5 * de_j + 2 * F32_EPS * abs(float(e64)), (
            step, de_t, de_j)
        assert rel_err(gt, gj) < TOL_PORT_VS_JAX[mode], (step, rel_err(gt,
                                                                       gj))
        assert rel_err(tf.U_ind, np.asarray(jf.U_ind)) < TOL_PORT_VS_JAX[
            mode], step
        err_t, err_j = rel_err(gt, g64), rel_err(gj, g64)
        assert err_t < TOL_VS_F64[mode] and err_j < TOL_VS_F64[mode], (
            step, err_t, err_j)
        assert rel_err(tf.U_ind, ref.U_ind) < TOL_VS_F64[mode], step
        pos = _f32(pos + s["drift"])


@pytest.fixture(scope="module")
def sparse81():
    """81 atoms, sparse exclusions (bonds (3m, 3m+1), (3m, 3m+2), depth 6)
    and i-sorted cell-list pairs within 3 A, in both packages."""
    s = t_water_system(n_side=3, spacing=3.104, jitter=0.1, seed=0,
                       exclusions="sparse")
    for k in ("positions", "box", "q_cart"):
        s[k] = _f32(s[k])
    n = s["positions"].shape[0]
    rc = 3.0
    jl = j_cell(jnp.asarray(s["positions"], jnp.float32),
                jnp.asarray(s["box"], jnp.float32), rc)
    tl = neighbor_list_cell(torch.tensor(s["positions"], dtype=F32),
                            torch.tensor(s["box"], dtype=F32), rc)
    assert tl.i_sorted and not bool(tl.did_overflow)
    assert tl.n_cells == (3, 3, 3)
    np.testing.assert_array_equal(tl.pairs.numpy(), np.asarray(jl.pairs))
    bonds = [(3 * m, 3 * m + h) for m in range(n // 3) for h in (1, 2)]
    return dict(s=s, rc=rc, pairs=tl.pairs, bonds=bonds,
                drift=0.005 * np.random.default_rng(2).standard_normal(
                    s["positions"].shape))


def test_sparse_cell_list_fluctuating_high_accuracy(sparse81):
    c = sparse81
    s = c["s"]
    n = s["positions"].shape[0]
    jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                j_sparse(c["bonds"], n, max_depth=6), c["rc"], 1e-4, lmax=2,
                config=JEngine.high_accuracy(fft_friendly_grid=True,
                                             pairs_i_sorted=True))
    tf = force_from_jax(jf, s["box"], device="cpu", dtype=F32)
    ref = force_from_jax(jf, s["box"], device="cpu", dtype=torch.float64)
    assert tf._excl_pairs.shape[0] == 128  # n pairs of 3 per water, padded
    j_q = _j_fluctuating(jnp.asarray(s["q_cart"], jnp.float32), n)
    box_j = jnp.asarray(s["box"], jnp.float32)
    pairs_j = jnp.asarray(c["pairs"].numpy())
    step = jax.jit(jax.value_and_grad(lambda p: jf.get_energy(
        p, box_j, pairs_j, j_q(p), jnp.asarray(SCALES, jnp.float32))))

    def port_step(force, pos, dtype):
        p = torch.tensor(pos, dtype=dtype).requires_grad_(True)
        e = force.get_energy(p, torch.tensor(s["box"], dtype=dtype),
                             c["pairs"], fluctuating_q_local(
                                 p, torch.tensor(s["q_cart"], dtype=dtype)),
                             torch.tensor(SCALES, dtype=dtype))
        (g,) = torch.autograd.grad(e, p)
        return float(e.detach()), g.numpy().astype(np.float64)

    for pos in (s["positions"], _f32(s["positions"] + c["drift"])):
        e_j, g_j = step(jnp.asarray(pos, jnp.float32))
        e_t, g_t = port_step(tf, pos, F32)
        e_64, g_64 = port_step(ref, pos, torch.float64)
        g_j = np.asarray(g_j, np.float64)
        assert abs(e_t - float(e_j)) <= 1e-6 * abs(float(e_j))
        assert rel_err(g_t, g_j) < 2e-6, rel_err(g_t, g_j)
        assert abs(e_t - e_64) <= 1e-6 * abs(e_64)
        assert rel_err(g_t, g_64) < 5e-6, rel_err(g_t, g_64)
        assert rel_err(g_j, g_64) < 5e-6, rel_err(g_j, g_64)
