"""The port's slice end to end against admp_tpu's ADMPPmeForce at float64 on
water_system(n_side=3): fixed multipoles, and the polarizable step with the
MD SCF profile over three warm-started drift steps (energy 1e-9 relative;
force and induced-dipole RMSE 1e-8 relative; identical PCG iteration
counts), plus the dense neighbor list and the conversion helpers
(convert.py). The exact-adjoint profile is in test_torch_pme_adjoint.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import ADMPPmeForce as JForce
from admp_tpu import neighbor_list_dense as j_nl
from admp_tpu.settings import EngineConfig as JEngine
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch import EngineConfig, SCFConfig, neighbor_list_dense
from admp_tpu_torch.convert import convert_state, force_from_jax
from admp_tpu_torch.models.pme import ADMPPmeForce
from admp_tpu_torch.systems import water_system as t_water_system
from torch_port_cases import dense_pairs, rel_err, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
RC, ETHRESH = 4.0, 1e-4


def _setup(lpol, lmax=2, scf=None, seed=4, cache=True):
    s = water(n_side=3, seed=seed)
    cfg = JEngine(cache_influence=cache, scf=scf or JSCF.md())
    jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                s["covalent_map"], RC, ETHRESH, lmax=lmax, lpol=lpol,
                config=cfg)
    tf = force_from_jax(jf, s["box"], dtype=torch.float64)
    s["pairs"] = dense_pairs(s["positions"], s["box"], RC)
    n_h = (lmax + 1) ** 2
    st = convert_state(
        positions=s["positions"], box=s["box"], pairs=s["pairs"],
        q_local=s["q_local"][:, :n_h], pol=s["pol"], tholes=s["tholes"],
        m_scales=SCALES, p_scales=SCALES, d_scales=SCALES)
    return s, jf, tf, st


def _j_pol_args(s, pos, lmax=2):
    n_h = (lmax + 1) ** 2
    return [jnp.asarray(x) for x in (pos, s["box"], s["pairs"],
                                     s["q_local"][:, :n_h], s["pol"],
                                     s["tholes"], SCALES, SCALES, SCALES)]


def _t_pol_args(st, pos):
    return [torch.as_tensor(pos)] + [st[k] for k in (
        "box", "pairs", "q_local", "pol", "tholes", "m_scales", "p_scales",
        "d_scales")]


@pytest.mark.parametrize("lmax", [1, 2])
def test_fixed_multipoles_match(lmax):
    s, jf, tf, st = _setup(False, lmax=lmax)
    n_h = (lmax + 1) ** 2
    j_args = [jnp.asarray(x) for x in (s["positions"], s["box"], s["pairs"],
                                       s["q_local"][:, :n_h], SCALES)]
    t_args = [st[k] for k in ("positions", "box", "pairs", "q_local",
                              "m_scales")]
    ej, gj = jf.get_forces(*j_args)
    et, gt = tf.get_forces(*t_args)
    assert abs(float(et) - float(ej)) <= 1e-9 * abs(float(ej))
    assert rel_err(gt, gj) < 1e-8
    mj, mt = jf.get_metrics(*j_args), tf.get_metrics(*t_args)
    for k in ("e_real", "e_recip", "e_self", "e_total"):
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-9 * abs(float(mj[k])), k
    assert abs(float(tf.get_energy(*t_args)) - float(ej)) <= 1e-9 * abs(float(ej))


def test_polarizable_md_profile_three_drift_steps():
    s, jf, tf, st = _setup(True)
    rng = np.random.default_rng(1)
    drift = 0.005 * rng.standard_normal(s["positions"].shape)
    pos = s["positions"].copy()
    for step in range(3):
        ej, gj = jf.get_forces(*_j_pol_args(s, pos))
        et, gt = tf.get_forces(*_t_pol_args(st, pos))
        assert abs(float(et) - float(ej)) <= 1e-9 * abs(float(ej)), step
        assert rel_err(gt, gj) < 1e-8, step
        assert rel_err(tf.U_ind, jf.U_ind) < 1e-8, step
        assert tf.n_cycle == int(jf.n_cycle), step
        assert tf.lconverg is True and bool(jf.lconverg), step
        assert tf.n_cycle > 0
        pos = pos + drift


def test_polarizable_metrics_and_optimize_uind():
    s, jf, tf, st = _setup(True, seed=6)
    mj = jf.get_metrics(*_j_pol_args(s, s["positions"]))
    mt = tf.get_metrics(*_t_pol_args(st, s["positions"]))
    for k in ("e_real", "e_recip", "e_self", "e_pol_penalty", "e_total"):
        assert abs(float(mt[k]) - float(mj[k])) <= 1e-9 * abs(float(mj[k])), k
    assert mt["scf_iters"] == int(mj["scf_iters"])
    # get_metrics leaves the state alone; optimize_Uind starts from zero,
    # like the first get_energy
    ut, ct, nt = tf.optimize_Uind(*_t_pol_args(st, s["positions"]))
    assert float(tf.U_ind.abs().max()) == 0.0
    tf.get_energy(*_t_pol_args(st, s["positions"]))
    assert rel_err(ut, tf.U_ind) < 1e-12 and ct and nt == mt["scf_iters"]


def test_charges_only_polarizable():
    """lmax = 0 with induced dipoles: the charges are promoted to lmax = 1."""
    s, jf, tf, st = _setup(True, lmax=0, seed=3)
    ej, gj = jf.get_forces(*_j_pol_args(s, s["positions"], lmax=0))
    et, gt = tf.get_forces(*_t_pol_args(st, s["positions"]))
    assert abs(float(et) - float(ej)) <= 1e-9 * abs(float(ej))
    assert rel_err(gt, gj) < 1e-8


def test_neighbor_list_dense_matches():
    s = water(n_side=3, seed=8)
    jn = j_nl(jnp.asarray(s["positions"]), jnp.asarray(s["box"]), RC)
    tn = neighbor_list_dense(torch.as_tensor(s["positions"]),
                             torch.as_tensor(s["box"]), RC)
    assert tn.capacity == jn.capacity
    np.testing.assert_array_equal(tn.pairs.numpy(), np.asarray(jn.pairs))
    assert not bool(tn.did_overflow)
    small = neighbor_list_dense(torch.as_tensor(s["positions"]),
                                torch.as_tensor(s["box"]), RC, capacity=64)
    assert bool(small.did_overflow) and small.pairs.shape == (64, 2)


def test_systems_copy_matches():
    a = t_water_system(n_side=2, spacing=3.1, jitter=0.12, seed=5)
    b = water(n_side=2, seed=5)
    del b["q_local"]
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k])


def test_convert_state_and_writable_grid():
    st = convert_state(device="cpu", dtype=torch.float32, positions=np.eye(3),
                       pairs=np.array([[0, 1]], np.int32), kappa=np.float32(0.5),
                       K3=np.int64(96))
    assert st["positions"].dtype == torch.float32
    assert st["pairs"].dtype == torch.int64
    assert st["kappa"] == 0.5 and st["K3"] == 96
    with pytest.raises(ValueError, match="unknown field"):
        convert_state(charges=np.zeros(3))
    # K1..K3 and kappa are writable, as on admp_tpu's force
    s, jf, tf, st = _setup(False, cache=False)
    jf.K3 = tf.K3 = 32
    jf.refresh_calculators()
    tf.refresh_calculators()
    j_args = [jnp.asarray(x) for x in (s["positions"], s["box"], s["pairs"],
                                       s["q_local"], SCALES)]
    t_args = [st[k] for k in ("positions", "box", "pairs", "q_local",
                              "m_scales")]
    ej, et = jf.get_energy(*j_args), tf.get_energy(*t_args)
    assert abs(float(et) - float(ej)) <= 1e-9 * abs(float(ej))


def test_unimplemented_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(recip_precision="f64")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(realspace_precision="f64-near")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SCFConfig(method="jacobi")
    with pytest.raises(ValueError):
        EngineConfig(pair_kernel="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SCFConfig(adjoint_warmstart=True)
    # the exact adjoint (default SCFConfig()) on the kernel path is ported
    s = water(n_side=2)
    force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                         s["covalent_map"], RC, ETHRESH, 2, lpol=True,
                         config=EngineConfig(pair_kernel="cuda"))
    assert force.scf_config.exact_adjoint
