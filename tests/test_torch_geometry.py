"""admp_tpu_torch geometry and multipole algebra against admp_tpu, float64:
harmonics, frames, pbc, B-splines, exclusions, Ewald parameters, influence,
self energy, 3x3 algebra and compensated sums (1e-10 relative / 1e-12
absolute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.ops import bsplines as jb
from admp_tpu.ops import ewald as je
from admp_tpu.ops import exclusions as jx
from admp_tpu.ops import frames as jf
from admp_tpu.ops import harmonics as jh
from admp_tpu.ops import influence as ji
from admp_tpu.ops import pbc as jp
from admp_tpu.ops import selfenergy as js
from admp_tpu.utils import accmath as ja
from admp_tpu.utils import linalg3 as jl
from admp_tpu_torch.ops import bsplines as tb
from admp_tpu_torch.ops import ewald as te
from admp_tpu_torch.ops import exclusions as tx
from admp_tpu_torch.ops import frames as tf
from admp_tpu_torch.ops import harmonics as th
from admp_tpu_torch.ops import influence as ti
from admp_tpu_torch.ops import pbc as tp
from admp_tpu_torch.ops import selfenergy as ts
from admp_tpu_torch.utils import accmath as ta
from admp_tpu_torch.utils import linalg3 as tl
from torch_port_cases import assert_close, t64, water

RNG = np.random.default_rng(11)
BOX = np.array([[9.3, 0.4, -0.2], [0.1, 8.7, 0.3], [-0.3, 0.2, 9.9]])


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_convert_cart2harm(lmax):
    theta = RNG.normal(size=(7, 10))
    assert_close(th.convert_cart2harm(t64(theta), lmax),
                 jh.convert_cart2harm(jnp.asarray(theta), lmax))


def test_dipole_orders():
    u = RNG.normal(size=(5, 3))
    assert_close(th.cart_dipole_to_harm(t64(u)),
                 jh.cart_dipole_to_harm(jnp.asarray(u)))


@pytest.mark.parametrize("lmax", [1, 2])
def test_rotate_harm_components(lmax):
    q = RNG.normal(size=(9, 6))
    f = RNG.normal(size=(9, 6))
    got = th.rotate_harm_components(tuple(t64(q[k]) for k in range(9)),
                                    tuple(t64(f[k]) for k in range(9)), lmax)
    want = jh.rotate_harm_components(tuple(jnp.asarray(q[k]) for k in range(9)),
                                     tuple(jnp.asarray(f[k]) for k in range(9)),
                                     lmax)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_close(a, b)


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_frames_and_local2global(lmax):
    s = water(n_side=2, seed=3)
    # exercise every axis type, including ZOnly/ThreeFold/ZBisect/NoAxis
    types = np.arange(s["positions"].shape[0]) % 6
    idx = s["axis_indices"].copy()
    idx[:, 2] = np.roll(np.arange(idx.shape[0]), 5)
    want = jf.local_frames_components(
        jnp.asarray(s["positions"]), jnp.asarray(s["box"]),
        jnp.asarray(types), jnp.asarray(idx))
    got = tf.local_frames_components(t64(s["positions"]), t64(s["box"]),
                                     torch.as_tensor(types),
                                     torch.as_tensor(idx))
    for a, b in zip(got, want):
        assert_close(a, b)
    n_h = (lmax + 1) ** 2
    assert_close(
        th.rot_local2global_components(t64(s["q_local"][:, :n_h]), got, lmax),
        jh.rot_local2global_components(jnp.asarray(s["q_local"][:, :n_h]),
                                       want, lmax))


def test_pbc():
    dr = RNG.normal(scale=8.0, size=(20, 3))
    assert_close(tp.pbc_shift(t64(dr), t64(BOX)),
                 jp.pbc_shift(jnp.asarray(dr), jnp.asarray(BOX)))
    assert_close(tp.wrap_positions(t64(dr), t64(BOX)),
                 jp.wrap_positions(jnp.asarray(dr), jnp.asarray(BOX)))


def test_linalg3():
    assert_close(tl.inv3x3(t64(BOX)), jl.inv3x3(jnp.asarray(BOX)))
    assert_close(tl.det3x3(t64(BOX)), jl.det3x3(jnp.asarray(BOX)))


@pytest.mark.parametrize("order", [4, 6])
@pytest.mark.parametrize("which", ["spline_values", "spline_derivs",
                                   "spline_derivs2"])
def test_bsplines(order, which):
    u0 = order / 2 + RNG.uniform(size=(13, 3))
    assert_close(getattr(tb, which)(t64(u0), order),
                 getattr(jb, which)(jnp.asarray(u0), order))


def test_euler_factors():
    k = np.arange(-16, 17, dtype=np.float64)
    assert_close(tb.euler_spline_theta(t64(k), 33),
                 jb.euler_spline_theta(jnp.asarray(k), 33))
    assert_close(tb.euler_spline_theta4(t64(k), 33),
                 jb.euler_spline_theta4(jnp.asarray(k), 33))


def test_exclusions():
    s = water(n_side=2, seed=1)
    cov = s["covalent_map"]
    i = RNG.integers(0, cov.shape[0], 50)
    j = RNG.integers(0, cov.shape[0], 50)
    i[:6], j[:6] = [0, 0, 1, 3, 4, 5], [1, 2, 2, 4, 5, 3]  # bonded pairs
    nb_t = tx.lookup_topology_distance(torch.as_tensor(cov), torch.as_tensor(i),
                                       torch.as_tensor(j))
    nb_j = jx.lookup_topology_distance(jnp.asarray(cov), jnp.asarray(i),
                                       jnp.asarray(j))
    np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
    scales = np.array([0.1, 0.2, 0.3, 0.9, 1.0])
    nbond = np.arange(0, 9)  # beyond the table: clamped to the last entry
    assert_close(tx.scale_for_distance(t64(scales), torch.as_tensor(nbond)),
                 jx.scale_for_distance(jnp.asarray(scales), jnp.asarray(nbond)))


@pytest.mark.parametrize("rc,ethresh", [(4.0, 1e-4), (6.0, 5e-4)])
def test_ewald_parameters(rc, ethresh):
    box = np.diag([31.04, 29.5, 33.3])
    assert te.setup_ewald_parameters(rc, ethresh, box) == \
        je.setup_ewald_parameters(rc, ethresh, box)
    assert te.setup_ewald_parameters_fft(rc, ethresh, box) == \
        je.setup_ewald_parameters_fft(rc, ethresh, box)
    for k in (96, 100, 129, 170, 256):
        assert te.lane_align_k3(k) == je.lane_align_k3(k)


def test_influence_ck1():
    ksq = RNG.uniform(0.1, 20.0, size=(40,))
    assert_close(ti.ck_1(t64(ksq), 0.73, 950.0),
                 ji.ck_1(jnp.asarray(ksq), 0.73, 950.0))


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_self_energy_and_penalty(lmax):
    q = RNG.normal(size=(30, 9))
    assert_close(ts.pme_self_energy(t64(q), 0.73, lmax),
                 js.pme_self_energy(jnp.asarray(q), 0.73, lmax))
    u = RNG.normal(size=(30, 3))
    pol = np.abs(RNG.normal(size=30))
    pol[::3] = 0.0  # zero-polarizability sites take the 1e-8 floor
    assert_close(ts.polarization_penalty(t64(u), t64(pol)),
                 js.polarization_penalty(jnp.asarray(u), jnp.asarray(pol)),
                 rel=1e-10, abs_=0.0)


@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_compensated_sum(n):
    x = RNG.normal(scale=1e5, size=n)
    xt = t64(x).requires_grad_(True)
    got = ta.compensated_sum(xt)
    assert_close(got.detach(), ja.compensated_sum(jnp.asarray(x)))
    (g,) = torch.autograd.grad(3.0 * got, xt)
    assert_close(g, np.full(n, 3.0))
    # float32 input: float64 accumulation, float32 gradient
    x32 = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    s32 = ta.compensated_sum(x32)
    assert s32.dtype == torch.float64
    assert abs(float(s32.detach()) - float(np.sum(x.astype(np.float32), dtype=np.float64))) < 1e-6
    (g32,) = torch.autograd.grad(s32, x32)
    assert g32.dtype == torch.float32
    mask = torch.as_tensor(x > 0)
    assert_close(ta.masked_compensated_sum(t64(x), mask),
                 ja.masked_compensated_sum(jnp.asarray(x), jnp.asarray(x > 0)))
