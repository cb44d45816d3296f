"""The public surface that admp_tpu exposes and the port now matches, held
against admp_tpu at float64 on the CPU within 1e-10: the harmonics
conversions and rotations, the frame constructors, the safe masked
helpers, ADMPPmeForce.update_env and its compatibility keywords, and the
top-level exports; plus the profiling helpers on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admp_tpu
import admp_tpu_torch
from admp_tpu import ADMPPmeForce as JForce
from admp_tpu.ops import frames as jf
from admp_tpu.ops import harmonics as jh
from admp_tpu.utils import safety as js
from admp_tpu_torch import ADMPPmeForce, EngineConfig, SCFConfig
from admp_tpu_torch.convert import convert_state, force_from_jax
from admp_tpu_torch.ops import frames as tf
from admp_tpu_torch.ops import harmonics as th
from admp_tpu_torch.utils import profiling, safety as ts
from torch_port_cases import assert_close, dense_pairs, t64, water

RNG = np.random.default_rng(17)
BOX = np.array([[9.3, 0.4, -0.2], [0.1, 8.7, 0.3], [-0.3, 0.2, 9.9]])
SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])


def _rotations(n):
    q, _ = np.linalg.qr(RNG.normal(size=(n, 3, 3)))
    return q


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_convert_harm2cart(lmax):
    q = RNG.normal(size=(7, (lmax + 1) ** 2))
    assert_close(th.convert_harm2cart(t64(q), lmax),
                 jh.convert_harm2cart(jnp.asarray(q), lmax), rel=1e-10)


@pytest.mark.parametrize("lmax", [0, 1, 2])
@pytest.mark.parametrize("name", ["rot_global2local", "rot_local2global"])
def test_rotations(lmax, name):
    q = RNG.normal(size=(6, (lmax + 1) ** 2))
    rot = _rotations(6)
    got = getattr(th, name)(t64(q), t64(rot), lmax)
    assert_close(got, getattr(jh, name)(jnp.asarray(q), jnp.asarray(rot),
                                        lmax), rel=1e-10)
    # the two rotations are each other's inverse on the traceless subspace
    back = th.rot_local2global(th.rot_global2local(t64(q), t64(rot), lmax),
                               t64(rot), lmax)
    assert_close(back, q, rel=1e-10)


def test_dipole_and_quadrupole_forms():
    u = RNG.normal(size=(5, 3))
    rot = _rotations(5)
    assert_close(th.harm_dipole_to_cart(t64(u)),
                 jh.harm_dipole_to_cart(jnp.asarray(u)), rel=1e-10)
    assert_close(th.rot_dipole_global2local(t64(u), t64(rot)),
                 jh.rot_dipole_global2local(jnp.asarray(u),
                                            jnp.asarray(rot)), rel=1e-10)
    q2 = RNG.normal(size=(4, 5))
    t = th.quad_harm_to_tensor(t64(q2))
    assert_close(t, jh.quad_harm_to_tensor(jnp.asarray(q2)), rel=1e-10)
    assert_close(th.quad_tensor_to_harm(t),
                 jh.quad_tensor_to_harm(jnp.asarray(t.numpy())), rel=1e-10)
    assert_close(th.quad_tensor_to_harm(t), q2, rel=1e-10)


def test_frame_constructors():
    s = water(n_side=2, seed=6)
    pos = s["positions"] + RNG.normal(0, 0.02, s["positions"].shape)
    # every axis type, anchors -1 where absent
    types = np.arange(len(pos)) % 6
    idx = np.asarray(s["axis_indices"]).copy()
    idx[types == 4, 1] = -1
    idx[np.isin(types, (2, 3)), 2] = (idx[np.isin(types, (2, 3)), 0] + 3) % len(pos)
    want = jf.construct_local_frames(jnp.asarray(pos), jnp.asarray(BOX),
                                     types, idx)
    got = tf.construct_local_frames(t64(pos), t64(BOX), types, idx)
    assert got.shape == (len(pos), 3, 3)
    assert_close(got, want, rel=1e-10)
    make = tf.make_frame_constructor(types, idx)
    assert_close(make(t64(pos), t64(BOX)), want, rel=1e-10)
    assert_close(jf.make_frame_constructor(types, idx)(
        jnp.asarray(pos), jnp.asarray(BOX)), got.numpy(), rel=1e-10)


def test_build_quasi_internal():
    r1 = RNG.normal(size=(8, 3))
    r2 = RNG.normal(size=(8, 3))
    r2[:3, 1:] = r1[:3, 1:]  # the degenerate seed: same y and z
    dr = r1 - r2
    norm = np.linalg.norm(dr, axis=-1)
    got = tf.build_quasi_internal(t64(r1), t64(r2), t64(dr), t64(norm))
    want = jf.build_quasi_internal(*(jnp.asarray(x) for x in (r1, r2, dr,
                                                               norm)))
    assert_close(got, want, rel=1e-10)


def test_safety_helpers_and_their_gradients():
    x = np.array([-2.0, -1e-9, 0.0, 3e-9, 0.5, 4.0])
    mask = np.array([True, True, False, True, True, False])
    vec = RNG.normal(size=(6, 3))
    vec[2] = 0.0
    cases = [
        ("safe_inv", lambda m, a: m.safe_inv(a, mask=_b(m, mask))),
        ("masked_norm", lambda m, a: m.masked_norm(_v(m, vec) * a[:, None],
                                                   _b(m, mask))),
        ("safe_normalize", lambda m, a: m.safe_normalize(_v(m, vec)
                                                         * a[:, None])),
        ("clamp_min", lambda m, a: m.clamp_min(a, 0.1)),
        ("clamp_max", lambda m, a: m.clamp_max(a, 0.1)),
    ]
    for name, fn in cases:
        want = fn(js, jnp.asarray(x))
        xt = t64(x).requires_grad_(True)
        got = fn(ts, xt)
        assert_close(got.detach(), want, rel=1e-10)
        g_j = jax.grad(lambda a: jnp.sum(fn(js, a)))(jnp.asarray(x))
        (g_t,) = torch.autograd.grad(got.sum(), xt)
        assert_close(g_t, g_j, rel=1e-10)


def _b(mod, mask):
    return jnp.asarray(mask) if mod is js else torch.as_tensor(mask)


def _v(mod, vec):
    return jnp.asarray(vec) if mod is js else t64(vec)


def test_update_env_and_compatibility_keywords():
    s = water(n_side=3, seed=2)
    jforce = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                    s["covalent_map"], 4.0, 1e-4, 2,
                    spread_method="scatter", fft_friendly_grid=False)
    jforce.update_env("kappa", 0.61)
    jforce.update_env("K1", 40)
    tforce = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                          s["covalent_map"], 4.0, 1e-4, 2,
                          fft_friendly_grid=False, spread_method="torch",
                          device="cpu", dtype=torch.float64)
    assert tforce.config.spread_method == "torch"
    tforce.update_env("kappa", 0.61)
    tforce.update_env("K1", 40)
    assert (tforce._kappa, tforce.K1) == (0.61, 40)
    pairs = dense_pairs(s["positions"], s["box"], 4.0)
    args = (s["positions"], s["box"], pairs, s["q_local"], SCALES)
    e_j = jforce.get_energy(*(jnp.asarray(a) for a in args))
    e_t = tforce.get_energy(*(t64(a) if a.dtype.kind == "f" else
                              torch.as_tensor(a) for a in args))
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    # scf_config: alone it makes the config, beside one it replaces its SCF
    scf = SCFConfig(method="jacobi", max_iter=3)
    f1 = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                      s["covalent_map"], 4.0, 1e-4, 2, lpol=True,
                      scf_config=scf, device="cpu")
    f2 = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                      s["covalent_map"], 4.0, 1e-4, 2, lpol=True,
                      scf_config=scf, config=EngineConfig(spread_order=4),
                      device="cpu")
    assert f1.scf_config == f2.scf_config == scf
    assert f2.config.spread_order == 4
    # spread_precision: the compatibility keyword reaches the config
    f3 = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                      s["covalent_map"], 4.0, 1e-4, 2, spread_precision="f64",
                      device="cpu")
    assert f3.config.spread_precision == "f64"
    # convert_state and force_from_jax still carry a force across
    tf2 = force_from_jax(jforce, s["box"], device="cpu", dtype=torch.float64,
                         spread_method="torch")
    st = convert_state(device="cpu", positions=s["positions"])
    assert tf2.K1 == 40 and st["positions"].dtype == torch.float64


def test_top_level_exports():
    for name in ("BAR_TO_KJMOL_A3", "DIELECTRIC", "setup_ewald_parameters",
                 "MDState", "make_langevin_step", "make_mc_barostat",
                 "make_nve_step", "run_langevin", "run_nve",
                 "convert_harm2cart", "rot_global2local", "rot_local2global"):
        assert name in admp_tpu_torch.__all__ and name in admp_tpu.__all__
        a, b = getattr(admp_tpu_torch, name), getattr(admp_tpu, name)
        if isinstance(a, float):
            assert a == b, name
    assert "Hamiltonian" in admp_tpu_torch.__all__
    assert admp_tpu_torch.setup_ewald_parameters(4.0, 1e-5, np.eye(3) * 31.04) \
        == tuple(admp_tpu.setup_ewald_parameters(4.0, 1e-5, np.eye(3) * 31.04))
    from admp_tpu_torch.utils import DIELECTRIC, masked_norm, safe_inv  # noqa
    assert DIELECTRIC == admp_tpu.DIELECTRIC


def test_profiling_helpers(tmp_path):
    x = torch.ones(1000, dtype=torch.float64)
    t = profiling.time_fn(lambda a: (a * 2).sum(), x, iters=3, warmup=1)
    assert 0.0 <= t < 1.0
    with profiling.trace(str(tmp_path / "tr")):
        (x * 3).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert (tmp_path / "tr" / "spans.json").stat().st_size > 0
