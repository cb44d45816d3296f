"""admp_tpu_torch.scf.make_induced_dipole_solver against admp_tpu's factory
(admp_tpu/scf/solver.py:251) at float64 on the CPU, on a toy SPD field and
on the polarizable PME field of a 24-atom water box, at external_r0 False
and True and exact_adjoint True and False: u* within 1e-9 relative (max
norm; the same PCG iterates in both), the same convergence flag and
iteration count, and the gradient of a non-constant loss of u* with
respect to every floating input within 1e-8 relative of admp_tpu's (the
adjoint solves stop at the same relative tolerance). Under
Feynman-Hellmann admp_tpu's solve returns zero gradients and the port's u*
carries none. Without matvec_fn, external_r0 raises ValueError."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import ADMPPmeForce as JForce
from admp_tpu.scf import make_induced_dipole_solver as j_factory
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch import ADMPPmeForce, SCFConfig
from admp_tpu_torch.scf import make_induced_dipole_solver
from admp_tpu_torch.utils.constants import DIELECTRIC
from torch_port_cases import assert_close, dense_pairs, water

TOL_U, TOL_GRAD = 1e-9, 1e-8
N_TOY = 8


def _toy():
    rng = np.random.default_rng(3)
    d = rng.uniform(2.0, 3.0, N_TOY)
    s = rng.normal(0.0, 0.2, (N_TOY, N_TOY))
    s = (s + s.T) / 2
    np.fill_diagonal(s, 0.0)
    b = rng.normal(size=(N_TOY, 3))
    inputs = {"d": d, "s": s, "b": b}
    # pol = DIELECTRIC / d: the Jacobi preconditioner is then A's diagonal
    return inputs, DIELECTRIC / d, rng.normal(size=(N_TOY, 3))


def _toy_field(u, inp):
    return inp["d"][:, None] * u + inp["s"] @ u - inp["b"]


def _toy_matvec(v, inp):
    return inp["d"][:, None] * v + inp["s"] @ v


@pytest.fixture(scope="module")
def pme_case():
    """The 24-atom water box (water_system(n_side=2)), lmax 2, polarizable,
    both packages' field dE/du and their inputs."""
    s = water(n_side=2, seed=1)
    rc = 3.0
    pairs = dense_pairs(s["positions"], s["box"], rc)
    args = (s["box"], s["axis_types"], s["axis_indices"], s["covalent_map"],
            rc, 1e-3)
    jf = JForce(*args, lmax=2, lpol=True)
    tf = ADMPPmeForce(*args, lmax=2, lpol=True, device="cpu",
                      dtype=torch.float64)
    sc = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
    inputs = dict(positions=s["positions"], box=s["box"], pairs=pairs,
                  Q_local=s["q_local"], pol=s["pol"], tholes=s["tholes"],
                  mScales=sc, pScales=sc, dScales=sc)

    def t_field(u, inp):
        return tf.field(u, inp, create_graph=torch.is_grad_enabled())

    # compiled once for every case of the module: admp_tpu's solver calls
    # it inside its while loops and takes its VJP
    @jax.jit
    def j_field(u, inp):
        return jf.grad_U_fn(inp["positions"], inp["box"], inp["pairs"],
                            inp["Q_local"], u, inp["pol"], inp["tholes"],
                            inp["mScales"], inp["pScales"], inp["dScales"])

    rng = np.random.default_rng(5)
    return dict(inputs=inputs, pol=s["pol"], weight=rng.normal(
        size=s["positions"].shape), j_field=j_field, t_field=t_field)


def _exact_matvec(field):
    """matvec(v) = field(v) - field(0): the exact operator, as a matvec_fn."""
    return lambda v, inp: field(v, inp) - field(0.0 * v, inp)


def _run_both(j_field, t_field, j_mv, t_mv, inputs, pol, weight, external,
              exact):
    """u*, (converged, n_iter) and dL/dinputs from both packages, for
    L = sum(weight * u*) + sum(u*^2)."""
    cfg = dict(field_tol=1e-5, max_iter=60, exact_adjoint=exact)
    j_solve = j_factory(j_field, JSCF(**cfg), matvec_fn=j_mv,
                        external_r0=external)
    t_solve = make_induced_dipole_solver(t_field, SCFConfig(**cfg),
                                         matvec_fn=t_mv, external_r0=external)
    floats = [k for k, v in inputs.items()
              if np.asarray(v).dtype.kind == "f"]
    u_init = np.zeros_like(weight)

    def j_loss(fl):
        inp = {k: (fl[k] if k in fl else jnp.asarray(v))
               for k, v in inputs.items()}
        u0 = jnp.asarray(u_init)
        if external:
            r0 = -j_field(u0, inp)
            u, aux = j_solve(inp, u0, jnp.asarray(pol), r0, jnp.zeros_like(u0))
        else:
            u, aux = j_solve(inp, u0, jnp.asarray(pol))
        loss = jnp.sum(jnp.asarray(weight) * u) + jnp.sum(u * u)
        return loss, (u, aux[0], aux[1])

    j_fl = {k: jnp.asarray(inputs[k]) for k in floats}
    (_, (j_u, j_conv, j_it)), j_g = jax.value_and_grad(
        j_loss, has_aux=True)(j_fl)

    t_inp = {k: torch.tensor(np.asarray(v)) for k, v in inputs.items()}
    for k in floats:
        t_inp[k].requires_grad_(True)
    u0 = torch.tensor(u_init)
    if external:
        r0 = -t_field(u0, t_inp)
        t_u, (t_conv, t_it, _w) = t_solve(t_inp, u0, torch.tensor(pol), r0,
                                          torch.zeros_like(u0))
    else:
        t_u, (t_conv, t_it) = t_solve(t_inp, u0, torch.tensor(pol))
    loss = torch.sum(torch.tensor(weight) * t_u) + torch.sum(t_u * t_u)
    if loss.requires_grad:
        t_g = torch.autograd.grad(loss, [t_inp[k] for k in floats],
                                  allow_unused=True)
    else:  # Feynman-Hellmann: u* carries no graph
        t_g = [None] * len(floats)
    assert_close(t_u.detach().numpy(), np.asarray(j_u), rel=TOL_U)
    assert (bool(t_conv), int(t_it)) == (bool(j_conv), int(j_it))
    assert bool(t_conv)
    for k, g in zip(floats, t_g):
        want = np.asarray(j_g[k])
        if not exact:
            assert g is None or not torch.any(g != 0), k
            assert not np.any(want != 0), k
            continue
        got = np.zeros_like(want) if g is None else g.numpy()
        assert_close(got, want, rel=TOL_GRAD, abs_=1e-14)
    return int(t_it)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("external", [False, True])
def test_toy_field(external, exact):
    inputs, pol, weight = _toy()
    n_it = _run_both(
        lambda u, i: _toy_field(u, i), lambda u, i: _toy_field(u, i),
        _toy_matvec if external else None,
        _toy_matvec if external else None, inputs, pol, weight, external,
        exact)
    assert n_it > 2  # the solve did work


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("external", [False, True])
def test_pme_field(pme_case, external, exact):
    c = pme_case
    _run_both(c["j_field"], c["t_field"],
              _exact_matvec(c["j_field"]) if external else None,
              _exact_matvec(c["t_field"]) if external else None,
              c["inputs"], c["pol"], c["weight"], external, exact)


def test_jacobi_and_tuple_inputs():
    """method='jacobi' iterates on b = -field(0); inputs as a tuple."""
    inputs, pol, _ = _toy()
    keys = ("d", "s", "b")
    cfg = dict(method="jacobi", field_tol=1e-6, max_iter=200)
    j_solve = j_factory(lambda u, i: _toy_field(u, dict(zip(keys, i))),
                        JSCF(**cfg))
    t_solve = make_induced_dipole_solver(
        lambda u, i: _toy_field(u, dict(zip(keys, i))), SCFConfig(**cfg))
    j_in = tuple(jnp.asarray(inputs[k]) for k in keys)
    t_in = tuple(torch.tensor(inputs[k], requires_grad=True) for k in keys)
    def j_loss(i):
        u, aux = j_solve(i, jnp.zeros((N_TOY, 3)), jnp.asarray(pol))
        return jnp.sum(u ** 2), (u, aux)

    j_g, (j_u, (j_conv, j_it)) = jax.grad(j_loss, has_aux=True)(j_in)
    u0 = torch.zeros(N_TOY, 3, dtype=torch.float64)
    t_u, (t_conv, t_it) = t_solve(t_in, u0, torch.tensor(pol))
    t_g = torch.autograd.grad(torch.sum(t_u ** 2), t_in)
    assert_close(t_u.detach().numpy(), np.asarray(j_u), rel=TOL_U)
    assert (bool(t_conv), int(t_it)) == (bool(j_conv), int(j_it))
    for got, want in zip(t_g, j_g):
        assert_close(got.numpy(), np.asarray(want), rel=TOL_GRAD)


def test_external_r0_needs_matvec_fn():
    with pytest.raises(ValueError, match="external_r0 requires matvec_fn"):
        make_induced_dipole_solver(_toy_field, external_r0=True)
    with pytest.raises(ValueError, match="external_r0 requires matvec_fn"):
        j_factory(_toy_field, external_r0=True)
