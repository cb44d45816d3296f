"""The two SCF options of SCFConfig beyond warm-started PCG, against
admp_tpu at float64 on the CPU (water_system(n_side=3), rc 4 A, ethresh
1e-4): the damped Jacobi iteration (method='jacobi'), its dipoles after a
fixed number of iterations within 1e-9; and the warm-started implicit
adjoint (adjoint_warmstart=True), forces over two get_forces calls within
1e-8 relative RMSE and the carried W_adj within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import ADMPPmeForce as JForce
from admp_tpu.settings import EngineConfig as JEngine
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch.convert import force_from_jax
from torch_port_cases import dense_pairs, rel_err, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
RC, ETHRESH = 4.0, 1e-4


def _setup(scf, seed=4):
    s = water(n_side=3, seed=seed)
    jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                s["covalent_map"], RC, ETHRESH, lmax=2, lpol=True,
                config=JEngine(cache_influence=True, scf=scf))
    tf = force_from_jax(jf, s["box"], device="cpu", dtype=torch.float64)
    s["pairs"] = dense_pairs(s["positions"], s["box"], RC)
    return s, jf, tf


def _args(s, pos, as_torch):
    vals = (pos, s["box"], s["pairs"], s["q_local"], s["pol"], s["tholes"],
            SCALES, SCALES, SCALES)
    if as_torch:
        return [torch.tensor(np.asarray(v)) for v in vals]
    return [jnp.asarray(v) for v in vals]


@pytest.mark.parametrize("exact_adjoint", [False, True],
                         ids=["feynman_hellmann", "exact_adjoint"])
def test_jacobi_iterates_match(exact_adjoint):
    """A fixed count of Jacobi iterations (field_tol out of reach), from
    zero and then warm from the first call's dipoles."""
    scf = JSCF(method="jacobi", max_iter=4, field_tol=1e-12,
               exact_adjoint=exact_adjoint)
    s, jf, tf = _setup(scf)
    assert tf.scf_config.method == "jacobi"
    drift = np.random.default_rng(0).normal(0, 0.01, s["positions"].shape)
    for pos in (s["positions"], s["positions"] + drift):
        if exact_adjoint:
            e_j = jf.get_energy(*_args(s, pos, False))
            e_t = tf.get_energy(*_args(s, pos, True))
        else:
            e_j, g_j = jf.get_forces(*_args(s, pos, False))
            e_t, g_t = tf.get_forces(*_args(s, pos, True))
            assert rel_err(g_t.numpy(), np.asarray(g_j)) < 1e-8
        assert abs(float(e_t.detach()) - float(e_j)) <= 1e-9 * abs(float(e_j))
        assert rel_err(tf.U_ind.numpy(), np.asarray(jf.U_ind)) < 1e-9
        assert tf.n_cycle == int(jf.n_cycle) == 4
        assert bool(tf.lconverg) == bool(jf.lconverg) is False


def test_adjoint_warmstart_matches():
    scf = JSCF(adjoint_warmstart=True)
    s, jf, tf = _setup(scf)
    assert tf.scf_config.adjoint_warmstart
    cold = force_from_jax(jf, s["box"], device="cpu", dtype=torch.float64,
                          adjoint_warmstart=False)
    drift = np.random.default_rng(1).normal(0, 0.01, s["positions"].shape)
    for pos in (s["positions"], s["positions"] + drift):
        e_j, g_j = jf.get_forces(*_args(s, pos, False))
        e_t, g_t = tf.get_forces(*_args(s, pos, True))
        _, g_c = cold.get_forces(*_args(s, pos, True))
        assert abs(float(e_t) - float(e_j)) <= 1e-9 * abs(float(e_j))
        assert rel_err(g_t.numpy(), np.asarray(g_j)) < 1e-8
        assert rel_err(g_t.numpy(), g_c.numpy()) < 1e-8
        assert rel_err(tf.U_ind.numpy(), np.asarray(jf.U_ind)) < 1e-8
        assert rel_err(tf.W_adj.numpy(), np.asarray(jf.W_adj)) < 1e-6
        assert float(tf.W_adj.abs().max()) > 0.0
        assert float(cold.W_adj.abs().max()) == 0.0
