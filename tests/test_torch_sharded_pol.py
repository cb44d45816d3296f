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
the full sharded energy (rtol 1e-8, as admp_tpu's test).

The EngineConfig keywords ``spread_precision='f64'`` and
``compensated_sums=False`` on ``make_sharded_pol_energy`` (the keywords'
reach in both packages: tests/test_torch_sharded_energy.py). The spread
keyword reaches both of the solve's operators, the field's energy mesh and
the matvec's dipole mesh; compensated sums only the real-space pair sum of
the energy, and neither the matvec's u-quadratic energy nor the field (the
sum's backward is the plain broadcast), so with and without them the port
takes the same iterations to the same dipoles and forces, bit for bit, and
only the energy moves.

* At float64 each run is held against admp_tpu's default result above at
  its bounds, and equals the port's own default forces and dipoles bit for
  bit (under the float64 weights its energy too).
* At float32 admp_tpu's polarizable sharded factory is compiled once,
  forward only, under ``spread_precision='f64'`` (compensated sums on), in
  a process of its own beside the float64 compile: its gradient's compile
  takes over a minute on a CPU, beyond the suite's budget. The port's run takes its 6 iterations to its energy within
  TOL_E_JAX['pme'] (half a float32 unit of the largest PME term; measured
  3.4e-4 kJ/mol) and its dipoles within 2e-6 (measured 8.2e-7). Every
  float32 run is also held against the port's single-device polarizable
  force of the same config (the same 6 PCG iterations; energy within
  TOL_E32, forces and dipoles as the fixed factories: 2e-6 with float64
  spread weights, measured 2.8e-7, 5e-5 at the f32 floor, measured 1.8e-5)
  and against float64 at the same rounded inputs (forces 1e-5 with float64
  spread weights, measured 2.0e-6; 1e-3 at the f32 floor, 2.2e-4). The
  compensated energies sit 7.8e-4-3.3e-3 kJ/mol from float64 (sharded and
  single-device), the uncompensated 6.7e-3 (sharded) and 1.06e-2 (single
  device): TOL_E32 lies between them, and both uncompensated runs must miss
  it."""

from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

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
from admp_tpu.settings import EngineConfig, SCFConfig
from admp_tpu_torch.parallel.launch import start
from tests import torch_sharded_cases as cases
from tests.test_torch_sharded_energy import DISP_KAPPA, GRID, KAPPA, N_DEV
from tests.test_torch_sharded_energy import TOL_E32, TOL_E_JAX, TOL_KW_F64
from tests.test_torch_sharded_energy import TOL_KW_SINGLE
from tests.test_torch_sharded_energy import water_inputs
from tests.torch_port_cases import rel_err


@pytest.fixture(scope="module")
def port():
    inp = water_inputs()
    n = inp["sys"]["positions"].shape[0]
    inp["v"] = np.random.default_rng(3).normal(size=(n, 3)) * 0.01
    # the ranks run while admp_tpu compiles its side
    return inp, start(cases.pol_cases, N_DEV, args=(inp,), timeout=600)


SCF = SCFConfig(max_iter=40, field_tol=1e-3)


def _pol_topo(s):
    return dict(grid_shape=GRID, kappa=KAPPA, lmax=2,
                axis_types=s["axis_types"], axis_indices=s["axis_indices"],
                covalent_map=s["covalent_map"], scf_config=SCF)


def admp_pol32_spread_f64(inp):
    """admp_tpu's sharded polarizable energy at float32 (inputs rounded)
    under spread_precision='f64', forward only (module docstring), on
    N_DEV of the virtual devices: energy, dipoles and iterations. It runs
    in a process of its own, beside the float64 compile, so it sets what
    conftest sets."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    s = inp["sys"]
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("model",))
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    m = f32(inp["m_scales"])
    e, (u, conv, n_iter) = jax.jit(make_sharded_pol_energy(
        mesh, "model", config=EngineConfig(scf=SCF, spread_precision="f64"),
        **_pol_topo(s)))(
            f32(s["positions"]), f32(s["box"]),
            jnp.asarray(inp["pairs"], jnp.int32), f32(inp["q_local"]),
            f32(s["pol"]), f32(s["tholes"]), m, m,
            jnp.zeros(s["positions"].shape, jnp.float32))
    assert bool(conv)
    return dict(energy=float(e), u=np.asarray(u, np.float64),
                n_iter=int(n_iter))


@pytest.fixture(scope="module")
def ref(port):
    inp = port[0]
    s = inp["sys"]
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("model",))
    j = lambda k: jnp.asarray(s[k])  # noqa: E731
    pos, box = j("positions"), j("box")
    pairs = jnp.asarray(inp["pairs"], jnp.int32)
    q, m = jnp.asarray(inp["q_local"]), jnp.asarray(inp["m_scales"])
    # admp_tpu's float32 run compiles in a process of its own meanwhile
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        pol32 = pool.submit(admp_pol32_spread_f64, inp)
        energy_aux = make_sharded_pol_energy(mesh, "model", **_pol_topo(s))
        (e, (u, conv, n_iter)), g = jax.jit(jax.value_and_grad(
            energy_aux, has_aux=True))(
                pos, box, pairs, q, j("pol"), j("tholes"), m, m,
                jnp.zeros(pos.shape))
        pol32 = pol32.result()
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
                pol32_spread_f64=pol32,
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


@pytest.mark.parametrize("name", sorted(cases.KEYWORDS))
def test_precision_keywords_at_float64_match_admp_tpu(ref, ranks, name):
    want = ref["pol"]
    for r in ranks:
        got = r[f"pol64_{name}"]
        assert got["converged"] and got["n_iter"] == want["n_iter"]
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-9)
        np.testing.assert_allclose(got["u"], want["u"], atol=1e-8)
        np.testing.assert_allclose(got["forces"], want["forces"], atol=1e-8)
        own = r["pol"]
        assert np.array_equal(got["forces"], own["forces"])
        assert np.array_equal(got["u"], own["u"])
        assert name == "uncompensated" or got["energy"] == own["energy"]


def test_spread_f64_at_float32_matches_admp_tpu(ref, ranks):
    want = ref["pol32_spread_f64"]
    for r in ranks:
        got = r["pol32_spread_f64"]
        assert got["converged"] and got["n_iter"] == want["n_iter"]
        assert abs(got["energy"] - want["energy"]) <= TOL_E_JAX["pme"], (
            got["energy"], want["energy"])
        assert rel_err(got["u"], want["u"]) < 2e-6, rel_err(got["u"],
                                                             want["u"])


@pytest.mark.parametrize("name", sorted(cases.KEYWORDS32))
def test_precision_keywords_at_float32(ranks, name):
    for r in ranks:
        got, single = r[f"pol32_{name}"], r[f"pol_single32_{name}"]
        ref64 = r["pol64r_default"]
        assert got["converged"]
        assert got["n_iter"] == single["n_iter"] == ref64["n_iter"]
        for k in ("forces", "u"):
            assert rel_err(got[k], single[k]) < TOL_KW_SINGLE[name], k
            assert rel_err(got[k], ref64[k]) < TOL_KW_F64[name], k
        if name != "uncompensated":
            for e in (got["energy"], single["energy"]):
                assert abs(e - ref64["energy"]) <= TOL_E32["pol"], (
                    e, ref64["energy"])


def test_compensated_sums_move_only_the_energy(ranks):
    for r in ranks:
        c, u = r["pol32_default"], r["pol32_uncompensated"]
        assert c["n_iter"] == u["n_iter"] and c["energy"] != u["energy"]
        assert np.array_equal(c["u"], u["u"])
        assert np.array_equal(c["forces"], u["forces"])
        # the plain f32 sums miss the compensated runs' bound
        e_64 = r["pol64r_default"]["energy"]
        for e in (u["energy"], r["pol_single32_uncompensated"]["energy"]):
            assert abs(e - e_64) > TOL_E32["pol"], (e, e_64)
