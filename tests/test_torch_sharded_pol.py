"""The port's sharded polarizable factories on 4 gloo ranks against
admp_tpu's on 4 of conftest's virtual devices, in float64, on
tests/test_sharding.py's 192-atom water box at 16^3 and kappa 0.62:
``make_sharded_pol_energy`` (PCG, exact implicit adjoint, SCFConfig(
max_iter=40, field_tol=1e-3)) energy, forces, induced dipoles and the
iterations of every rank, and the polarizable ``make_sharded_ff_energy``,
held against admp_tpu's sharded polarizable energy + its sharded
Tang-Toennies - dispersion PME (its definition); admp_tpu's bounds
(tests/test_sharding.py): energies rtol 1e-9, forces and dipoles atol 1e-8.
The port's sharded Feynman-Hellmann and Jacobi solves against its own
single-device ones, and the cheap matvec against the field difference of
the full sharded energy (rtol 1e-8, as admp_tpu's test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from admp_tpu.ops.shortrange import tt_damping_qq_c6_kernel
from admp_tpu.parallel import (
    make_sharded_disp_energy,
    make_sharded_pairwise_energy,
    make_sharded_pol_energy,
)
from admp_tpu.settings import SCFConfig
from admp_tpu_torch.parallel.launch import start
from tests import torch_sharded_cases as cases
from tests.test_torch_sharded_energy import DISP_KAPPA, GRID, KAPPA, N_DEV
from tests.test_torch_sharded_energy import water_inputs


@pytest.fixture(scope="module")
def port():
    inp = water_inputs()
    n = inp["sys"]["positions"].shape[0]
    inp["v"] = np.random.default_rng(3).normal(size=(n, 3)) * 0.01
    # the ranks run while admp_tpu compiles its side
    return inp, start(cases.pol_cases, N_DEV, args=(inp,), timeout=600)


@pytest.fixture(scope="module")
def ref(port):
    inp = port[0]
    s = inp["sys"]
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("model",))
    j = lambda k: jnp.asarray(s[k])  # noqa: E731
    pos, box = j("positions"), j("box")
    pairs = jnp.asarray(inp["pairs"], jnp.int32)
    q, m = jnp.asarray(inp["q_local"]), jnp.asarray(inp["m_scales"])
    energy_aux = make_sharded_pol_energy(
        mesh, "model", grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=s["axis_types"], axis_indices=s["axis_indices"],
        covalent_map=s["covalent_map"],
        scf_config=SCFConfig(max_iter=40, field_tol=1e-3))
    (e, (u, conv, n_iter)), g = jax.jit(jax.value_and_grad(
        energy_aux, has_aux=True))(
            pos, box, pairs, q, j("pol"), j("tholes"), m, m,
            jnp.zeros(pos.shape))
    assert bool(conv)
    disp = make_sharded_disp_energy(mesh, "model", grid_shape=GRID,
                                    kappa=DISP_KAPPA, pmax=10,
                                    covalent_map=s["covalent_map"])
    tt = make_sharded_pairwise_energy(mesh, "model", tt_damping_qq_c6_kernel,
                                      s["covalent_map"])

    def rest(p):
        e_tt = tt(p, box, pairs, m, j("tt_a"), j("tt_b"), j("tt_q"),
                  j("c_list")[:, 0])
        return e_tt - disp(p, box, pairs, j("c_list"), m)

    e_rest, g_rest = jax.jit(jax.value_and_grad(rest))(pos)
    return dict(pol=dict(energy=float(e), forces=np.asarray(g),
                         u=np.asarray(u), n_iter=int(n_iter)),
                rest=(float(e_rest), np.asarray(g_rest)))


@pytest.fixture(scope="module")
def ranks(port, ref):
    return port[1].results()


def test_polarizable_energy_forces_dipoles_match_admp_tpu(ref, ranks):
    want = ref["pol"]
    for r in ranks:
        got = r["pol"]
        assert got["converged"]
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-9)
        np.testing.assert_allclose(got["u"], want["u"], atol=1e-8)
        np.testing.assert_allclose(got["forces"], want["forces"], atol=1e-8)


def test_every_rank_takes_admp_tpus_iterations(ref, ranks):
    for name in ("pol", "ff_pol"):
        assert {r[name]["n_iter"] for r in ranks} == {ref["pol"]["n_iter"]}


def test_polarizable_full_force_field_matches_admp_tpu(ref, ranks):
    e_rest, g_rest = ref["rest"]
    for r in ranks:
        got = r["ff_pol"]
        np.testing.assert_allclose(got["energy"],
                                   ref["pol"]["energy"] + e_rest, rtol=1e-9)
        np.testing.assert_allclose(got["u"], ref["pol"]["u"], atol=1e-8)
        np.testing.assert_allclose(got["forces"],
                                   ref["pol"]["forces"] + g_rest, atol=1e-8)


@pytest.mark.parametrize("name", ["fh", "jacobi"])
def test_other_solves_match_the_single_device_port(ranks, name):
    for r in ranks:
        got, want = r[name], r[name + "_single"]
        assert got["n_iter"] == want["n_iter"]
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-9)
        np.testing.assert_allclose(got["u"], want["u"], atol=1e-8)
        np.testing.assert_allclose(got["forces"], want["forces"], atol=1e-8)


def test_cheap_matvec_equals_the_field_difference(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["matvec"], r["field_diff"], rtol=1e-8,
                                   atol=1e-10)
