"""The double-single arithmetic (admp_tpu_torch/utils/ds.py) and the DS
reciprocal engine (admp_tpu_torch/ops/dsrecip.py) against numpy float64 and
against admp_tpu's on the same inputs.

Bounds: the DS primitives meet admp_tpu's own (tests/test_ds.py) against
float64 and agree with admp_tpu.utils.ds to 1e-13 relative (npow: 1e-10, the
bound admp_tpu's npow itself meets; the port's is within 1e-13 of float64).
The engine at lmax 0, 1, 2 agrees with admp_tpu's DS engine to 1e-12 in the
energy and 2e-7 relative RMSE in the gradients, and with the port's float64
reciprocal engine to 1e-10 / 5e-7 (5e-10 in the energy on the 8 x 8 x 128
grid); its second derivatives (autograd through the recomputed pieces and
the hand adjoint) agree with admp_tpu's to 5e-5 (positions) and 1e-5
(multipoles) relative RMSE and with the float64 engine's to 1e-4
(plain-f32 accuracy, as admp_tpu's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfc as erfc64

from admp_tpu.ops.dsrecip import make_ds_pme_recip as j_make_ds
from admp_tpu.utils import ds as jds
from admp_tpu_torch.ops import dsrecip as tdr
from admp_tpu_torch.ops.influence import ck_1
from admp_tpu_torch.ops.reciprocal import make_pme_recip
from admp_tpu_torch.utils import ds as tds
from admp_tpu_torch.utils.constants import DIELECTRIC
from torch_port_cases import rel_err


def _rel(got, ref):
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))


def _t64(a):
    return tds.to_f64(a).numpy()


def _operands():
    rng = np.random.RandomState(0)
    a = rng.randn(2000) * np.exp(rng.randn(2000) * 3)
    b = rng.randn(2000) * np.exp(rng.randn(2000) * 3)
    return a, b


_ERFC_X = np.concatenate([np.linspace(1e-6, 0.468, 500),
                          np.linspace(0.469, 3.99, 1500),
                          np.linspace(4.0, 7.0, 500)])
_EXP_X = np.linspace(-60.0, 3.0, 3000)

# (name, f(mod, A, B), float64 reference, bound against float64, bound
# against admp_tpu)
_PRIMS = {
    "mul": (lambda m, A, B: m.mul(A, B), lambda a, b: a * b, 1e-13, 1e-13),
    "div": (lambda m, A, B: m.div(A, B), lambda a, b: a / b, 1e-13, 1e-13),
    "npow": (lambda m, A, B: m.npow(A, 5), lambda a, b: a ** 5, 1e-10, 1e-10),
}


@pytest.mark.parametrize("name", sorted(_PRIMS))
def test_ds_binary_ops(name):
    f, ref_fn, bound, bound_j = _PRIMS[name]
    a, b = _operands()
    got = _t64(f(tds, tds.from_f64(a), tds.from_f64(b)))
    want = jds.to_f64(f(jds, jds.from_f64(a), jds.from_f64(b)))
    assert _rel(got, ref_fn(a, b)) < bound
    assert _rel(got, want) < bound_j


def test_ds_add_and_sqrt():
    a, b = _operands()
    got = _t64(tds.add(tds.from_f64(a), tds.from_f64(b)))
    # relative to the operands: a + b may cancel to ~0
    assert np.max(np.abs(got - (a + b))
                  / np.maximum(np.abs(a), np.abs(b))) < 1e-13
    want = jds.to_f64(jds.add(jds.from_f64(a), jds.from_f64(b)))
    assert np.max(np.abs(got - want)
                  / np.maximum(np.abs(a), np.abs(b))) < 1e-13
    r = np.abs(a)
    got = _t64(tds.sqrt(tds.from_f64(r)))
    assert _rel(got, np.sqrt(r)) < 1e-13
    assert _rel(got, jds.to_f64(jds.sqrt(jds.from_f64(r)))) < 1e-13
    assert float(tds.to_f64(tds.sqrt(tds.from_f64(np.zeros(2))))[0]) == 0.0


@pytest.mark.parametrize("name", ["exp", "erfc"])
def test_ds_exp_erfc(name):
    x, ref = ((_EXP_X, np.exp(_EXP_X)) if name == "exp"
              else (_ERFC_X, erfc64(_ERFC_X)))
    got = _t64(getattr(tds, name)(tds.from_f64(x)))
    want = jds.to_f64(getattr(jds, name)(jds.from_f64(x)))
    assert _rel(got, ref) < 1e-10
    assert _rel(got, want) < 1e-13


def test_ds_sum_pairs_exact():
    rng = np.random.RandomState(1)
    a = rng.randn(4097) * np.exp(rng.randn(4097) * 4)
    s = float(tds.to_f64(tds.sum_pairs(tds.from_f64(a))))
    assert abs(s - a.sum()) / np.abs(a).sum() < 1e-14
    assert s == float(jds.to_f64(jds.sum_pairs(jds.from_f64(a))))
    # along one axis of a 2-D tensor, odd length
    m = rng.randn(5, 7)
    got = _t64(tds.sum_pairs(tds.from_f64(m), dim=1))
    assert np.max(np.abs(got - m.sum(1))) < 1e-13 * np.abs(m).sum()


def test_ds_fft3_matches_numpy():
    rng = np.random.RandomState(2)
    m = rng.randn(8, 16, 32).astype(np.float32)
    re, im = tdr.ds_fft3(tds.ds(torch.tensor(m)),
                         tds.ds(torch.zeros(8, 16, 32)))
    ref = np.fft.fftn(m.astype(np.float64))
    err = np.abs(_t64(re) + 1j * _t64(im) - ref)
    assert err.max() / np.abs(ref).max() < 1e-13
    # the leading- and last-axis transforms are its one-axis pieces
    lr, li = tdr.ds_fft_lead(tds.ds(torch.tensor(m)),
                             tds.ds(torch.zeros(8, 16, 32)), 8)
    ref0 = np.fft.fft(m.astype(np.float64), axis=0)
    assert np.abs(_t64(lr) + 1j * _t64(li) - ref0).max() < 1e-13 * np.abs(
        ref0).max()
    with pytest.raises(ValueError, match="power-of-two"):
        tdr.ds_fft_last(tds.ds(torch.zeros(4, 6)), tds.ds(torch.zeros(4, 6)))


def test_ds_rfft3_irfft3_roundtrip_and_hermitian_path():
    rng = np.random.RandomState(3)
    k = 16
    m64 = rng.randn(k, k, k)
    s_re, s_im = tdr.ds_rfft3(tds.from_f64(m64))
    ref = np.fft.rfftn(m64)
    assert np.abs(_t64(s_re) + 1j * _t64(s_im) - ref).max() < (
        1e-13 * np.abs(ref).max())
    out = _t64(tdr.ds_irfft3(s_re, s_im))
    assert np.abs(out - k ** 3 * m64).max() / (k ** 3 * np.abs(m64).max()) \
        < 1e-13
    # a real-symmetric w times S: the half-spectrum inverse equals the
    # full-spectrum route (hermitian fill + ds_fft3)
    kz = np.minimum(np.arange(k // 2 + 1), k - np.arange(k // 2 + 1))
    kk = np.minimum(np.arange(k), k - np.arange(k))
    w = tds.from_f64(np.exp(-0.05 * (kk[:, None, None] ** 2
                                     + kk[None, :, None] ** 2
                                     + kz[None, None, :] ** 2)))
    t_re, t_im = tds.mul(w, s_re), tds.mul(w, s_im)
    fr, fi = tdr._hermitian_fill(t_re, t_im, k)
    p_re, _ = tdr.ds_fft3(fr, tds.neg(fi))
    want = _t64(p_re)
    got = _t64(tdr.ds_irfft3(t_re, t_im))
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13
    # and both are admp_tpu's transforms of the same input
    from admp_tpu.ops.dsrecip import ds_rfft3 as j_rfft3

    j_re, j_im = j_rfft3(jds.from_f64(m64))
    assert np.abs(_t64(s_re) - jds.to_f64(j_re)).max() < (
        1e-13 * np.abs(ref).max())
    assert np.abs(_t64(s_im) - jds.to_f64(j_im)).max() < (
        1e-13 * np.abs(ref).max())


def _recip_case(lmax, n=48, k=16, seed=0):
    """Random f32 inputs in a 14 A cube; ``k`` a grid size or a grid."""
    rng = np.random.RandomState(seed)
    box = np.eye(3, dtype=np.float32) * 14.0
    pos = (rng.rand(n, 3) * 14.0).astype(np.float32)
    q = rng.randn(n, (lmax + 1) ** 2).astype(np.float32)
    return pos, box, q, (k, k, k) if isinstance(k, int) else tuple(k)


# (8, 8, 128): K3 >= 128, where admp_tpu's adjoint takes its lane-aligned
# row gather (ops/pallas/spread._row_gather_impl) and the port its flat one.
# There both packages' DS energies sit 3.26e-10 from float64, bit for bit
# alike (the residual scatter's rounding on a 0.11 A z spacing): the energy
# bound against float64 is 5e-10 for that case, admp_tpu's 1e-10 elsewhere.
@pytest.mark.parametrize("lmax,n,k", [(0, 24, 8), (1, 32, 8), (2, 40, 8),
                                      (2, 24, (8, 8, 128))])
def test_ds_recip_vs_admp_tpu_and_f64(lmax, n, k):
    pos, box, q, grid = _recip_case(lmax, n, k)
    e64_bound = 1e-10 if isinstance(k, int) else 5e-10
    kappa = 0.6
    je = j_make_ds(kappa, grid, lmax)
    # op by op, as test_ds_recip_second_derivatives runs it: the two share
    # their compiled operations
    with jax.disable_jit():
        e_j = float(je(jnp.asarray(pos), jnp.asarray(box), jnp.asarray(q)))
        g_j = jax.grad(lambda p, qq: je(p, jnp.asarray(box), qq),
                       argnums=(0, 1))(jnp.asarray(pos), jnp.asarray(q))

    te = tdr.make_ds_pme_recip(kappa, grid, lmax)
    tp = torch.tensor(pos, requires_grad=True)
    tq = torch.tensor(q, requires_grad=True)
    e_t = te(tp, torch.tensor(box), tq)
    assert e_t.dtype == torch.float64
    gp, gq = torch.autograd.grad(e_t, (tp, tq))
    e_t = float(e_t.detach())
    assert abs(e_t - e_j) <= 1e-12 * abs(e_j)
    assert rel_err(gp, g_j[0]) < 2e-7
    assert rel_err(gq, g_j[1]) < 2e-7

    # the port's own float64 reciprocal engine at the same inputs
    ref = make_pme_recip(ck_1, kappa, grid, lmax, DIELECTRIC,
                         spread_method="torch")
    p64 = torch.tensor(pos, dtype=torch.float64, requires_grad=True)
    q64 = torch.tensor(q, dtype=torch.float64, requires_grad=True)
    e64 = ref(p64, torch.tensor(box, dtype=torch.float64), q64)
    rp, rq = torch.autograd.grad(e64, (p64, q64))
    e64 = float(e64.detach())
    assert abs(e_t - e64) <= e64_bound * abs(e64)
    assert rel_err(gp, rp) < 5e-7
    assert rel_err(gq, rq) < 5e-7


def test_ds_recip_second_derivatives():
    """d/d(x, q) of grad_x E . v, the second derivatives that the
    polarizable exact adjoint takes through the engine: autograd through the
    recomputed forward pieces and the hand adjoint, against admp_tpu's on
    the same inputs and against autograd of the port's float64 engine.

    admp_tpu's are taken forward over reverse (jax.jvp of its gradient along
    (v, 0)): the same products H_xx v and H_qx v that its exact adjoint takes
    reverse over reverse, and like those they differentiate the custom_vjp's
    rules as traced code; reverse over reverse costs about five times as much
    on the CPU. Both packages' second derivatives carry plain-f32 accuracy
    (autograd through error-free transforms): on these inputs the port's are
    1.5e-5 (positions) and 2.4e-7 (multipoles) from float64, admp_tpu's
    3.3e-6 and 2.7e-6, and the two 1.5e-5 and 2.7e-6 apart. The bounds hold
    them to that f32 agreement; a residual whose dependence on the inputs
    were lost would leave a whole term out."""
    lmax = 2
    pos, box, q, grid = _recip_case(lmax, 40, 8)
    v = np.random.RandomState(5).randn(*pos.shape).astype(np.float32)
    te = tdr.make_ds_pme_recip(0.6, grid, lmax)
    tp = torch.tensor(pos, requires_grad=True)
    tq = torch.tensor(q, requires_grad=True)
    (g,) = torch.autograd.grad(te(tp, torch.tensor(box), tq), tp,
                               create_graph=True)
    hp, hq = torch.autograd.grad((g * torch.tensor(v)).sum(), (tp, tq))

    je = j_make_ds(0.6, grid, lmax)
    jb = jnp.asarray(box)
    grad = jax.grad(lambda p, qq: je(p, jb, qq), argnums=(0, 1))
    jq = jnp.asarray(q)
    with jax.disable_jit():
        jhp, jhq = jax.jvp(grad, (jnp.asarray(pos), jq),
                           (jnp.asarray(v), jnp.zeros_like(jq)))[1]
    assert rel_err(hp, jhp) < 5e-5
    assert rel_err(hq, jhq) < 1e-5

    ref = make_pme_recip(ck_1, 0.6, grid, lmax, DIELECTRIC,
                         spread_method="torch")
    p64 = torch.tensor(pos, dtype=torch.float64, requires_grad=True)
    q64 = torch.tensor(q, dtype=torch.float64, requires_grad=True)
    (g64,) = torch.autograd.grad(
        ref(p64, torch.tensor(box, dtype=torch.float64), q64), p64,
        create_graph=True)
    rp, rq = torch.autograd.grad(
        (g64 * torch.tensor(v, dtype=torch.float64)).sum(), (p64, q64))
    assert rel_err(hp, rp) < 1e-4
    assert rel_err(hq, rq) < 1e-4
    assert rel_err(jhp, rp) < 1e-4
    assert rel_err(jhq, rq) < 1e-4


def test_ds_static_box_cache_is_exact():
    pos, box, q, grid = _recip_case(2, 48, 16)
    dyn = tdr.make_ds_pme_recip(0.6, grid, 2)
    cst = tdr.make_ds_pme_recip(0.6, grid, 2, static_box=torch.tensor(box))
    grads = []
    for eng in (dyn, cst):
        tp = torch.tensor(pos, requires_grad=True)
        e = eng(tp, torch.tensor(box), torch.tensor(q))
        grads.append((float(e), torch.autograd.grad(e, tp)[0]))
    assert grads[0][0] == grads[1][0]
    assert torch.equal(grads[0][1], grads[1][1])


def test_ds_box_gradient_warns_and_zeros():
    eng = tdr.make_ds_pme_recip(0.6, (8, 8, 8), 0)
    pos = torch.full((4, 3), 2.0)
    pos[:, 0] += torch.arange(4.0)
    box = (torch.eye(3) * 8.0).requires_grad_(True)
    with pytest.warns(UserWarning, match="box gradients"):
        (g,) = torch.autograd.grad(eng(pos, box, torch.ones(4, 1)), box)
    assert torch.equal(g, torch.zeros_like(g))


def test_ds_non_power_of_two_grid_raises():
    with pytest.raises(ValueError, match="power-of-two"):
        tdr.make_ds_pme_recip(0.6, (16, 16, 24), 2)


def test_ds_quantized_scatter_is_order_independent():
    """The quantized pass of the fixed-point scatter adds multiples of one
    power-of-two quantum below 2^24 quanta: any order of the atoms (any
    order of atomic adds) gives the same bits."""
    pos, box, q, grid = _recip_case(2, 48, 16)
    perm = np.random.RandomState(7).permutation(pos.shape[0])

    def quantized(p, qq):
        m_u0, u0, binv = tdr._ds_mesh_coords(torch.tensor(p),
                                             torch.tensor(box), grid)
        mix = tdr._ds_mixing_matrix(binv, grid, 2)
        qp = tdr._ds_q_points(tdr._ds_alpha(torch.tensor(qq), mix, 2),
                              tdr.ds_spline_tables(u0)[:3], 2)
        q1, _ = tdr._fp_quantize(*qp)
        flat = tdr._flat_stencil(m_u0, grid).reshape(-1)
        return torch.zeros(int(np.prod(grid))).index_add(
            0, flat, q1.reshape(-1))

    mesh1 = quantized(pos, q)
    mesh2 = quantized(pos[perm], q[perm])
    assert torch.equal(mesh1, mesh2)
    assert float(mesh1.abs().max()) > 0
