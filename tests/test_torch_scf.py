"""admp_tpu_torch SCF solver against admp_tpu/scf/solver.py at float64: PCG
(host-checked loop), fixed-count PCG and the adjoint solve give the same
iterates and iteration counts on an SPD system; the implicit adjoint gives
the analytic gradient."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.scf import solver as js
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch.scf import solver as ts
from admp_tpu_torch.settings import SCFConfig
from admp_tpu_torch.utils.constants import DIELECTRIC
from torch_port_cases import assert_close, t64


def _system(n=24, seed=0):
    """SPD A whose diagonal carries the polarization penalty 1/pol, as the
    induced-dipole system does (zero-pol sites are floored at 1e-8)."""
    rng = np.random.default_rng(seed)
    pol = rng.uniform(0.2, 1.5, n)
    pol[::4] = 0.0
    m = rng.normal(size=(3 * n, 3 * n))
    penalty = np.repeat(DIELECTRIC / 1e3 / np.maximum(pol, 1e-8), 3)
    a = m @ m.T / (3 * n) + np.diag(penalty)
    b = rng.normal(size=(n, 3))
    x0 = 0.1 * rng.normal(size=(n, 3))
    return a, b, x0, pol


def _pieces(a, b, x0, pol, lib):
    if lib == "jax":
        arr, mv = jnp.asarray, lambda v: (jnp.asarray(a) @ v.reshape(-1)).reshape(v.shape)
    else:
        arr, mv = t64, lambda v: (t64(a) @ v.reshape(-1)).reshape(v.shape)
    diag = arr(np.maximum(pol, 1e-8)[:, None] / DIELECTRIC * 1e3)
    mask = arr((pol > 1e-3).astype(np.float64)[:, None])
    x0a = arr(x0)
    r0 = arr(b) - mv(x0a)
    return mv, r0, (lambda r: r * diag), x0a, mask


@pytest.mark.parametrize("tol", [1e-2, 1e-6])
def test_pcg_matches(tol):
    a, b, x0, pol = _system()
    jx, jc, jn, jrr = js._pcg(*_pieces(a, b, x0, pol, "jax")[:4], 50, tol,
                              _pieces(a, b, x0, pol, "jax")[4])
    tx, tc, tn, trr = ts.pcg(*_pieces(a, b, x0, pol, "torch")[:4], 50, tol,
                             _pieces(a, b, x0, pol, "torch")[4])
    assert tn == int(jn) and tc == bool(jc)
    assert_close(tx, jx)
    # the residual is a cancellation of terms up to |A| |x| ~ 1e8 (the
    # zero-pol penalty diagonal): compare it on that scale
    assert_close(trr, jrr, rel=0.0, abs_=1e-8)


def test_pcg_fixed_matches():
    a, b, x0, pol = _system(seed=1)
    jp = _pieces(a, b, x0, pol, "jax")
    tp = _pieces(a, b, x0, pol, "torch")
    jx, jc, jn, _ = js._pcg_fixed(*jp[:4], 3, 1e-3, jp[4])
    tx, tc, tn, _ = ts.pcg_fixed(*tp[:4], 3, 1e-3, tp[4])
    assert tn == int(jn) == 3 and tc == bool(jc)
    assert_close(tx, jx)


def test_adjoint_solve_matches():
    a, b, _, pol = _system(seed=2)
    jp = _pieces(a, b, np.zeros_like(b), pol, "jax")
    tp = _pieces(a, b, np.zeros_like(b), pol, "torch")
    diag = np.maximum(pol, 1e-8)[:, None] / DIELECTRIC
    jw = js._adjoint_pcg(jp[0], jnp.asarray(diag), jnp.asarray(b), JSCF())
    tw = ts.adjoint_solve(tp[0], t64(diag), t64(b), SCFConfig())
    assert_close(tw, jw, rel=1e-9)
    assert_close((t64(a) @ tw.reshape(-1)).reshape(b.shape), b, rel=1e-6)


def test_preconditioner_floor():
    pol = t64([0.0, 0.5, 1e-4, 2.0])
    diag, mask = ts.preconditioner(pol, SCFConfig())
    assert_close(diag[:, 0], np.maximum(pol.numpy(), 1e-8) / DIELECTRIC)
    np.testing.assert_array_equal(mask[:, 0].numpy(), [0, 1, 0, 1])


def test_implicit_adjoint_gradient():
    """u* = A(t)^-1 b with A(t) = A0 + t^2 I: dL/dt for L = c . u* is
    -(A^-1 c) . (2 t u*)."""
    a, b, _, pol = _system(n=10, seed=3)
    pol = np.ones_like(pol)
    rng = np.random.default_rng(5)
    c = rng.normal(size=b.shape)
    a_t = t64(a)

    def matvec_fn(v, theta, create_graph):
        (t,) = theta
        return (a_t @ v.reshape(-1)).reshape(v.shape) + t * t * v

    t = t64(0.7).requires_grad_(True)
    u0 = torch.zeros(b.shape, dtype=torch.float64)
    r0 = t64(b) - matvec_fn(u0, [t], True)
    cfg = SCFConfig(field_tol=1e-12, max_iter=200, adjoint_tol=1e-12)
    u, conv, n_it, _ = ts.solve_implicit(r0, u0, t64(pol), matvec_fn, cfg,
                                         [t])
    assert conv and n_it > 0
    (g,) = torch.autograd.grad(torch.sum(u * t64(c)), t)
    full = a + 0.49 * np.eye(a.shape[0])
    u_ref = np.linalg.solve(full, b.reshape(-1))
    w = np.linalg.solve(full, c.reshape(-1))
    assert_close(u.detach().reshape(-1), u_ref, rel=1e-9)
    assert abs(float(g) - (-2 * 0.7 * w @ u_ref)) < 1e-8 * abs(float(g))
