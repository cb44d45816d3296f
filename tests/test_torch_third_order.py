"""Force matching through the exact implicit adjoint: the third derivative
that admp_tpu takes under ``SCFConfig.adjoint_fixed_iters``, on the port's
plain route, at float64 on the CPU.

* ``energy_force_loss`` (force matching alone) on the polarizable PME of
  water(n_side=2, seed=8), rc 4 A, ethresh 1e-4, lmax 2: its gradients with
  respect to Q_local, pol and tholes against admp_tpu's XLA route under
  ``SCFConfig(adjoint_fixed_iters=K)`` and ``SCFConfig(fixed_iters=K,
  adjoint_fixed_iters=K)``, within 1e-9 relative (max norm): the same
  algorithm in float64. admp_tpu runs in two subprocesses started together,
  since its compile of the unrolled double backward takes most of a minute
  each;
* the same gradient against a central difference of the port's loss along a
  seeded direction, with the forward and the adjoint solves converged
  (1e-7: the implicit adjoint is the loss's derivative only at convergence);
  and the same through the XML/PDB front end (Hamiltonian's polarizable
  potential), which refuses it under its default SCFConfig(), as admp_tpu;
* ``make_induced_dipole_solver`` on a dense SPD field, the classic and the
  external-r0 solve, the gradient of a loss built from a first gradient
  (create_graph) against admp_tpu's factory, 1e-9;
* K3b's plain version ``pair_third_torch`` (reverse mode three times)
  against forward over forward over reverse mode of ``pair_energies_torch``
  (torch.func) at float64 for 'pol' lmax 0-2 and 'uu', 1e-10, with the
  directions kept off the zero-polarizability columns
  (``hvp_directions``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.scf import make_induced_dipole_solver as j_factory
from admp_tpu.settings import SCFConfig as JSCF
from admp_tpu_torch import ADMPPmeForce, EngineConfig, SCFConfig, energy_force_loss
from admp_tpu_torch.ops.cuda import pairs as P
from admp_tpu_torch.scf import make_induced_dipole_solver
from admp_tpu_torch.utils.constants import DIELECTRIC
from torch_port_cases import assert_close, dense_pairs, t64, water

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
K = 2  # the unrolled adjoint's iterations against admp_tpu
SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
PARAMS = ("q", "pol", "tholes")


def _case():
    """The box, its pairs and the target forces (seeded)."""
    s = water(n_side=2, seed=8)
    pairs = dense_pairs(s["positions"], s["box"], 4.0)
    f_ref = 0.1 * np.random.default_rng(0).standard_normal(
        s["positions"].shape)
    return s, pairs, f_ref


def j_gradients(k, fixed, out):
    """admp_tpu's loss gradient on its XLA route (run in a subprocess):
    saves {q, pol, tholes} to the .npz ``out``."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from admp_tpu import fitting
    from admp_tpu.models.pme import ADMPPmeForce as JForce
    from admp_tpu.settings import EngineConfig as JEngine

    s, pairs, f_ref = _case()
    scf = JSCF(adjoint_fixed_iters=k, fixed_iters=k if fixed else None)
    jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                s["covalent_map"], 4.0, 1e-4, 2, lpol=True,
                config=JEngine(scf=scf))
    sc = jnp.asarray(SCALES)

    def potential(positions, box, pairs_, params):
        return jf.get_energy(positions, box, pairs_, params["q"],
                             params["pol"], params["tholes"], sc, sc, sc)

    batch = [tuple(jnp.asarray(x) for x in (s["positions"], s["box"], pairs,
                                            0.0, f_ref))]
    params = {"q": jnp.asarray(s["q_local"]), "pol": jnp.asarray(s["pol"]),
              "tholes": jnp.asarray(s["tholes"])}
    grads = jax.grad(fitting.energy_force_loss(potential, energy_weight=0.0))(
        params, batch)
    np.savez(out, **{k_: np.asarray(v) for k_, v in grads.items()})


@pytest.fixture(scope="module")
def admp_grads(tmp_path_factory):
    """admp_tpu's gradients under both configurations, computed in two
    subprocesses started together; (fixed: bool) -> {name: array}."""
    d = tmp_path_factory.mktemp("third")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, TESTS, os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for fixed in (False, True):
        out = str(d / f"fixed{int(fixed)}.npz")
        code = ("import test_torch_third_order as t; "
                f"t.j_gradients({K}, {fixed}, {out!r})")
        procs[fixed] = (out, subprocess.Popen(
            [sys.executable, "-c", code], cwd=TESTS, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    got = {}
    for fixed, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        got[fixed] = dict(np.load(out))
    return got


def _port_loss(scf, energy_weight=0.0):
    """(loss(params), params0): the port's force-matching loss on the plain
    route at float64, cold-started SCF on every call."""
    s, pairs, f_ref = _case()
    force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                         s["covalent_map"], 4.0, 1e-4, 2, lpol=True,
                         config=EngineConfig(scf=scf), device="cpu",
                         dtype=torch.float64)
    sc = t64(SCALES)

    def potential(positions, box, pairs_, params):
        return force.get_energy(positions, box, pairs_, params["q"],
                                params["pol"], params["tholes"], sc, sc, sc,
                                U_init=torch.zeros_like(positions))

    batch = [(t64(s["positions"]), t64(s["box"]), torch.as_tensor(pairs),
              torch.tensor(0.0, dtype=torch.float64), t64(f_ref))]
    loss = energy_force_loss(potential, energy_weight=energy_weight)
    params0 = {"q": t64(s["q_local"]), "pol": t64(s["pol"]),
               "tholes": t64(s["tholes"])}
    return (lambda params: loss(params, batch)), params0


def _port_grads(scf):
    loss, p0 = _port_loss(scf)
    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    return dict(zip(PARAMS, torch.autograd.grad(loss(params),
                                                list(params.values()))))


@pytest.mark.parametrize("fixed", [False, True])
def test_force_matching_gradients_match_admp_tpu(admp_grads, fixed):
    """The third derivative through the unrolled adjoint, with the forward
    host-checked (its u* takes the implicit rule again) or unrolled too."""
    got = _port_grads(SCFConfig(adjoint_fixed_iters=K,
                                fixed_iters=K if fixed else None))
    want = admp_grads[fixed]
    for name in PARAMS:
        assert_close(got[name].numpy(), want[name], rel=1e-9, abs_=0.0)
    assert float(np.abs(want["q"]).max()) > 10.0  # the loss moves with q


def test_force_matching_gradient_matches_central_difference():
    """With both solves converged (field_tol 1e-9; 20 adjoint iterations on
    a 72-unknown system), the gradient is the loss's derivative: a
    Richardson-extrapolated central difference along a seeded relative
    direction (zero-pol sites stay zero) agrees within 1e-7."""
    scf = SCFConfig(field_tol=1e-9, max_iter=100, adjoint_fixed_iters=20)
    loss, p0 = _port_loss(scf)
    rng = np.random.default_rng(11)
    d = {k: t64(rng.standard_normal(v.shape)) * v for k, v in p0.items()}
    params = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    grads = torch.autograd.grad(loss(params), list(params.values()))
    analytic = sum(float((g * d[k]).sum()) for g, k in zip(grads, p0))

    def at(t):
        return float(loss({k: v + t * d[k] for k, v in p0.items()}).detach())

    h = 1e-4
    d1 = (at(h) - at(-h)) / (2 * h)
    d2 = (at(h / 2) - at(-h / 2)) / h
    fd = (4 * d2 - d1) / 3
    assert abs(fd - analytic) <= 1e-7 * abs(analytic), (fd, analytic)


def test_hamiltonian_polarizable_potential_force_matching(tmp_path):
    """Hamiltonian's polarizable potential (the MPID water XML, a PDB of
    water_system(n_side=2)): under the generators' default SCFConfig() a
    force-matching gradient raises, naming adjoint_fixed_iters, as
    admp_tpu's while_loop refuses it; with the generator's force given
    adjoint_fixed_iters (``scf_config``, ``refresh_calculators``) it
    differentiates, and with both solves converged it is the derivative of
    the loss along a seeded direction (central difference, 1e-7)."""
    from admp_tpu_torch import Hamiltonian
    from admp_tpu_torch.systems import water_system, write_water_inputs

    s = water_system(n_side=2, spacing=3.104, jitter=0.12, seed=0)
    xml, pdb = write_water_inputs(tmp_path, s["positions"], s["box"])
    ham = Hamiltonian(xml, device="cpu", dtype=torch.float64)
    gen = ham.getGenerators()[1]
    gen.ref_dip = ""
    pot = ham.createPotential(pdb, nonbondedCutoff=4.0)[1]
    pos, box = t64(s["positions"]), t64(s["box"])
    pairs = torch.as_tensor(dense_pairs(s["positions"], s["box"], 4.0))
    f_ref = t64(0.1 * np.random.default_rng(2).standard_normal(pos.shape))
    batch = [(pos, box, pairs, torch.tensor(0.0, dtype=torch.float64),
              f_ref)]
    loss = energy_force_loss(pot, energy_weight=0.0)
    p0 = {k: v.detach().clone() for k, v in gen.params.items()}
    names = ("Q_local", "pol", "tholes")

    def with_grad():
        params = dict(p0)
        for k in names:
            params[k] = p0[k].clone().requires_grad_(True)
        return params

    params = with_grad()
    with pytest.raises(RuntimeError, match="adjoint_fixed_iters"):
        torch.autograd.grad(loss(params, batch), [params[k] for k in names])

    gen.pme_force.scf_config = SCFConfig(field_tol=1e-9, max_iter=100,
                                         adjoint_fixed_iters=20)
    gen.pme_force.refresh_calculators()
    params = with_grad()
    grads = torch.autograd.grad(loss(params, batch),
                                [params[k] for k in names])
    rng = np.random.default_rng(13)
    d = {k: t64(rng.standard_normal(p0[k].shape)) * p0[k] for k in names}
    analytic = sum(float((g * d[k]).sum()) for g, k in zip(grads, names))

    def at(t):
        moved = dict(p0)
        moved.update({k: p0[k] + t * d[k] for k in names})
        return float(loss(moved, batch))

    h = 1e-4
    d1 = (at(h) - at(-h)) / (2 * h)
    d2 = (at(h / 2) - at(-h / 2)) / h
    fd = (4 * d2 - d1) / 3
    assert abs(fd - analytic) <= 1e-7 * abs(analytic), (fd, analytic)


N_TOY = 8


def _toy():
    rng = np.random.default_rng(3)
    d = rng.uniform(2.0, 3.0, N_TOY)
    s = rng.normal(0.0, 0.2, (N_TOY, N_TOY))
    s = (s + s.T) / 2
    np.fill_diagonal(s, 0.0)
    b = rng.normal(size=(N_TOY, 3))
    w = rng.normal(size=(N_TOY, 3))
    return {"d": d, "s": s, "b": b}, DIELECTRIC / d, w


def _toy_field(u, inp):
    return inp["d"][:, None] * u + inp["s"] @ u - inp["b"]


def _toy_matvec(v, inp):
    return inp["d"][:, None] * v + inp["s"] @ v


@pytest.mark.parametrize("external", [False, True])
def test_solver_factory_second_backward_matches_admp_tpu(external):
    """L2 = sum(G^2), G = dL1/d(d, s, b) with create_graph, L1 = sum(w u*) +
    sum(u*^3): the gradient of L2 takes the solve's backward's backward.
    Against admp_tpu's factory (its custom_vjp backward differentiated by
    JAX), the classic solve and the external-r0 one, 1e-9."""
    inputs, pol, w = _toy()
    cfg = dict(field_tol=1e-6, max_iter=60, adjoint_fixed_iters=5)
    mv = _toy_matvec if external else None
    j_solve = j_factory(_toy_field, JSCF(**cfg), matvec_fn=mv,
                        external_r0=external)
    t_solve = make_induced_dipole_solver(_toy_field, SCFConfig(**cfg),
                                         matvec_fn=mv, external_r0=external)
    u_init = np.zeros((N_TOY, 3))

    def j_l1(inp):
        u0 = jnp.asarray(u_init)
        if external:
            u, _ = j_solve(inp, u0, jnp.asarray(pol), -_toy_field(u0, inp),
                           jnp.zeros_like(u0))
        else:
            u, _ = j_solve(inp, u0, jnp.asarray(pol))
        return jnp.sum(jnp.asarray(w) * u) + jnp.sum(u ** 3)

    def j_l2(inp):
        g = jax.grad(j_l1)(inp)
        return sum(jnp.sum(v ** 2) for v in g.values())

    want = jax.grad(j_l2)({k: jnp.asarray(v) for k, v in inputs.items()})

    inp = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    u0 = torch.tensor(u_init)
    if external:
        u, _ = t_solve(inp, u0, torch.tensor(pol), -_toy_field(u0, inp),
                       torch.zeros_like(u0))
    else:
        u, _ = t_solve(inp, u0, torch.tensor(pol))
    l1 = torch.sum(torch.tensor(w) * u) + torch.sum(u ** 3)
    g = torch.autograd.grad(l1, list(inp.values()), create_graph=True)
    got = torch.autograd.grad(sum(torch.sum(v ** 2) for v in g),
                              list(inp.values()))
    for k, v in zip(inp, got):
        assert_close(v.numpy(), np.asarray(want[k]), rel=1e-9, abs_=1e-14)


def _third_inputs(kind, lmax):
    """Pair tables of 'pol' or 'uu' on a 192-atom box, float64, and K3b's
    directions (c, h) off the zero-polarizability columns."""
    from test_torch_kernels_cuda import _tables

    tables = [t.double() for t in _tables(torch.device("cpu"), kind, lmax)]
    x, ct = tables[:4], tables[4]
    cs = [c.double() for c in P.hvp_directions(x, kind, seed=5)]
    hs = [c.double() for c in P.hvp_directions(x, kind, seed=6)]
    hs.append(t64(np.random.default_rng(7).standard_normal(ct.shape[0])))
    return x, ct, cs, hs


@pytest.mark.parametrize("kind,lmax", [("pol", 0), ("pol", 1), ("pol", 2),
                                       ("uu", 1)])
def test_pair_third_torch_matches_forward_over_hvp(kind, lmax):
    """<pair_third_torch(x, ct, c; h), v> = d/dt <h, K3(x + t v_x, ct + t
    v_ct, c + t v_c)>: reverse mode three times against forward over
    forward over reverse, for every input of K3 at once, at float64."""
    x, ct, cs, hs = _third_inputs(kind, lmax)
    ins = [*x, ct, *cs]
    rng = np.random.default_rng(9)
    vs = [t64(rng.standard_normal(t.shape)) for t in ins]
    # the mask row is not differentiable; K3's output along it is zero
    vs[2][1] = 0.0
    vs[7][1] = 0.0

    def energies(*tables):
        return P.pair_energies_torch(*tables, lmax, kind)

    def k3_dot_h(*a):
        """<h, (ct H c, J c)>, K3's outputs by forward over reverse."""
        tables, ct_, c = a[:4], a[4], a[5:]
        grad = torch.func.grad(lambda *t: (energies(*t) * ct_).sum(),
                               argnums=(0, 1, 2, 3))
        _, hc = torch.func.jvp(grad, tables, c)
        _, jc = torch.func.jvp(energies, tables, c)
        return sum((o * h).sum() for o, h in zip((*hc, jc), hs))

    _, fwd = torch.func.jvp(k3_dot_h, tuple(ins), tuple(vs))
    rev = P.pair_third_torch(*x, ct, *cs, *hs, lmax, kind)
    dot = sum(float((r * v).sum()) for r, v in zip(rev, vs))
    assert abs(dot - float(fwd)) <= 1e-10 * abs(float(fwd)), (dot, float(fwd))
    assert all(bool(torch.isfinite(r).all()) for r in rev)
