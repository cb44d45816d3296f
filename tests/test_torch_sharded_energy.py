"""The port's sharded energy factories (parallel/sharded.py) on 4 gloo ranks
against admp_tpu's on 4 of conftest's virtual devices, in float64, on
tests/test_sharding.py's 192-atom water box (water_arrays(n_side=4,
seed=5)) at 16^3 and kappa 0.62, cutoff pairs: fixed-multipole PME with the
dense map, with SparseExclusions and with cached influence; dispersion PME
at spread orders 6 and 4; the pair-sharded Tang-Toennies term; the full
force field; and the batch energy on a 2 x 2 data x model split with its
gradient to Q_local. admp_tpu's own bounds (tests/test_sharding.py):
energies rtol 1e-9, forces atol 1e-9.

admp_tpu's compiles are most of this file's time, so two references are
taken from results admp_tpu already holds equal: its sharded PME with
SparseExclusions equals its dense one (tests/test_sharding.py asserts it
to 1e-12), and its ``make_sharded_ff_energy`` is, by its definition, its
sharded PME + Tang-Toennies - dispersion PME on the same pairs; the port's
full force field is held against that sum.

The EngineConfig keywords ``spread_precision='f64'`` and
``compensated_sums`` on make_sharded_pme_energy and make_sharded_ff_energy
(make_sharded_pol_energy: test_torch_sharded_pol.py), each set away from
its default (compensated sums are on by default in both packages):

* At float64 neither changes the forces: the spread weights are float64
  already (the port's factories give bitwise the default result, and
  admp_tpu's ``atom_spread_alpha(precision='f64')`` bitwise its default
  weights), and ``compensated_sums=False`` moves only the energy, within
  rounding. Each run is held against admp_tpu's default results above, at
  their bounds.
* At float32 (inputs rounded to float32 in both packages, the float64
  reference at the same rounded inputs) admp_tpu's sharded PME is compiled
  once, under ``spread_precision='f64'`` with compensated sums (the
  default), with the rest of the full force field, in a process of its own
  beside the float64 compiles. The float64 weights move the PME forces from
  the f32 floor (2.6e-4 from float64) to 1.9e-6; the port's sit within
  2.0e-6 of admp_tpu's (bound 5e-6), the full force field's within 3.9e-5
  (bound 1e-4: its dispersion mesh keeps float32 weights, the keyword does
  not reach the dispersion factory in either package). PME energies against
  admp_tpu within half a float32 unit of the largest PME term (measured
  5.7e-6 kJ/mol): admp_tpu adds its ~5e4 kJ/mol terms in float32, so its
  total moves in steps of 3.9e-3 kJ/mol. The full force field's within the
  dispersion's f32 floor besides (measured 2.7e-2 kJ/mol: the port's float32
  dispersion and Tang-Toennies sit 4.2e-2 from float64, admp_tpu's 1.5e-2,
  at 3.6e3 kJ/mol terms).
* ``compensated_sums`` changes the real-space pair sum of the PME term
  only (not the dispersion, Tang-Toennies, the sharded Parseval sum or the
  self energy, in either package), so the energy and not the forces: the
  port's forces with and without it are bitwise equal. Its compensated
  float32 PME energies sit 7.9e-4-9.2e-4 kJ/mol from float64, sharded and
  single-device, with either spread weights; the sharded uncompensated one
  4.0e-3. TOL_E32 lies between the two: the compensated runs meet it and
  the sharded uncompensated run must miss it. The single-device
  uncompensated total lands 6.8e-5 from float64 (its pair-sum error
  happens to cancel the rest of the f32 error), so it is held to nothing
  but the sharded result. The full force field's float32 energy sits
  4.1e-2-4.6e-2 from float64 under every keyword: the dispersion and
  Tang-Toennies terms, which no keyword reaches.
* Under every keyword the sharded factories agree with the port's
  single-device force of the same config: forces within 2e-6 under the
  float64 weights (measured 1.9e-7) and 5e-5 at the f32 floor (2.0e-5:
  two f32 summation orders); and with float64 at the same inputs: forces
  1e-5 under the float64 weights (1.9e-6), 1e-3 at the f32 floor
  (2.6e-4)."""

from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from admp_tpu import convert_cart2harm
from admp_tpu.ops.exclusions import build_sparse_exclusions
from admp_tpu.ops.shortrange import tt_damping_qq_c6_kernel
from admp_tpu.parallel import (
    make_sharded_batch_energy,
    make_sharded_disp_energy,
    make_sharded_pairwise_energy,
    make_sharded_pme_energy,
)
from admp_tpu.ops.reciprocal import atom_spread_alpha
from admp_tpu.settings import EngineConfig
from admp_tpu_torch import EngineConfig as TEngine
from admp_tpu_torch.parallel.launch import start
from tests import torch_sharded_cases as cases
from tests.torch_port_cases import dense_pairs, rel_err
from tests.watergen import water_arrays

N_DEV = 4
GRID = (16, 16, 16)
KAPPA, DISP_KAPPA = 0.62, 0.7
M_SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
RC = 5.0
# the largest PME term of the box at float64 (the self energy), kJ/mol
E_SCALE = 5.3e4
# float32, port vs admp_tpu under spread_precision='f64' (compensated sums
# on), forces (relative RMSE), by factory (module docstring)
TOL_KW_VS_JAX = {"pme": 5e-6, "ff": 1e-4}
# float32 energies, kJ/mol: the port vs admp_tpu under the same keywords
# (PME: half a float32 unit of E_SCALE; the full force field adds the
# dispersion's f32 floor, 1e-5 of its largest term, the 3.6e3 kJ/mol
# reciprocal, as test_torch_dispersion.py bounds it), and a compensated
# run vs float64 at the same inputs, by factory (the polarizable one:
# test_torch_sharded_pol.py)
TOL_E_JAX = {"pme": 2e-3, "ff": 1e-5 * 3.6e3}
TOL_E32 = {"pme": 2e-3, "pol": 5e-3}
# float32, sharded vs the single-device force of the same config, and vs
# float64 at the same inputs (forces and dipoles, relative RMSE)
TOL_KW_SINGLE = {"spread_f64": 2e-6, "default": 5e-5, "uncompensated": 5e-5}
TOL_KW_F64 = {"spread_f64": 1e-5, "default": 1e-3, "uncompensated": 1e-3}


def water_inputs():
    """The 192-atom box, its harmonic multipoles and pairs within RC padded
    to a multiple of 128, as numpy (shared with the polarizable tests)."""
    s = water_arrays(n_side=4, spacing=3.1, jitter=0.12, seed=5)
    q_local = np.asarray(convert_cart2harm(jnp.asarray(s["q_cart"]), 2))
    pairs = dense_pairs(s["positions"], s["box"], RC)
    return dict(sys=s, q_local=q_local, pairs=pairs, m_scales=M_SCALES,
                grid=GRID, kappa=KAPPA, disp_kappa=DISP_KAPPA)


@pytest.fixture(scope="module")
def port():
    inp = water_inputs()
    s = inp["sys"]
    n = s["positions"].shape[0]
    bonds = ([(3 * k, 3 * k + 1) for k in range(n // 3)]
             + [(3 * k, 3 * k + 2) for k in range(n // 3)])
    sparse = build_sparse_exclusions(bonds, n, max_depth=4)
    inp["sparse"] = dict(idx=np.asarray(sparse.idx),
                         dist=np.asarray(sparse.dist), n_atoms=n)
    # the ranks run while admp_tpu compiles its side
    return inp, start(cases.energy_cases, N_DEV, args=(inp,), timeout=600)


def admp_32_spread_f64(inp):
    """admp_tpu at float32, inputs rounded to float32, on N_DEV of the
    virtual devices: the sharded PME under spread_precision='f64' and the
    rest of the full force field (Tang-Toennies - dispersion PME), which
    no keyword reaches; (energy, forces) each, in one compile. It runs in a
    process of its own, beside the float64 compiles, so it sets what
    conftest sets."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    s = inp["sys"]
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("model",))
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    box, m, c = f32(s["box"]), f32(M_SCALES), f32(s["c_list"])
    pairs = jnp.asarray(inp["pairs"], jnp.int32)
    pme = make_sharded_pme_energy(
        mesh, "model", config=EngineConfig(spread_precision="f64"),
        covalent_map=s["covalent_map"], grid_shape=GRID, kappa=KAPPA, lmax=2,
        axis_types=s["axis_types"], axis_indices=s["axis_indices"])
    disp = make_sharded_disp_energy(mesh, "model", grid_shape=GRID,
                                    kappa=DISP_KAPPA, pmax=10,
                                    covalent_map=s["covalent_map"])
    tt = make_sharded_pairwise_energy(mesh, "model", tt_damping_qq_c6_kernel,
                                      s["covalent_map"])

    def rest(p):
        e_tt = tt(p, box, pairs, m, f32(s["tt_a"]), f32(s["tt_b"]),
                  f32(s["tt_q"]), c[:, 0])
        return e_tt - disp(p, box, pairs, c, m)

    out = jax.jit(lambda p: dict(
        pme32_spread_f64=jax.value_and_grad(pme)(p, box, pairs,
                                                 f32(inp["q_local"]), m),
        rest32=jax.value_and_grad(rest)(p)))(f32(s["positions"]))
    return {k: tuple(np.asarray(x) for x in v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ref(port):
    inp = port[0]
    s = inp["sys"]
    mesh = Mesh(np.array(jax.devices()[:N_DEV]), ("model",))
    j = lambda k: jnp.asarray(s[k])  # noqa: E731
    pos, box = j("positions"), j("box")
    pairs = jnp.asarray(inp["pairs"], jnp.int32)
    q, m = jnp.asarray(inp["q_local"]), jnp.asarray(M_SCALES)
    topo = dict(axis_types=s["axis_types"], axis_indices=s["axis_indices"])
    vg = lambda fn, *args: jax.jit(jax.value_and_grad(fn))(  # noqa: E731
        pos, *args)
    out = {}
    common = dict(grid_shape=GRID, kappa=KAPPA, lmax=2, **topo)
    # admp_tpu's float32 runs compile in a process of its own meanwhile
    pool = ProcessPoolExecutor(1, mp_context=get_context("spawn"))
    pool_32 = pool.submit(admp_32_spread_f64, inp)
    pool.shutdown(wait=False)
    out["pme"] = vg(make_sharded_pme_energy(
        mesh, "model", covalent_map=s["covalent_map"], **common),
        box, pairs, q, m)
    out["pme_cached"] = (jax.jit(make_sharded_pme_energy(
        mesh, "model", covalent_map=s["covalent_map"],
        config=EngineConfig(cache_influence=True), static_box=s["box"],
        **common))(pos, box, pairs, q, m), None)
    for order in (6, 4):
        out[f"disp{order}"] = vg(make_sharded_disp_energy(
            mesh, "model", grid_shape=GRID, kappa=DISP_KAPPA, pmax=10,
            covalent_map=s["covalent_map"], spread_order=order),
            box, pairs, j("c_list"), m)
    out["tt"] = vg(make_sharded_pairwise_energy(
        mesh, "model", tt_damping_qq_c6_kernel, s["covalent_map"]),
        box, pairs, m, j("tt_a"), j("tt_b"), j("tt_q"), j("c_list")[:, 0])
    out["pme_sparse"] = out["pme"]
    out["ff"] = tuple(a + b - c for a, b, c in zip(
        out["pme"], out["tt"], out["disp6"]))
    mesh22 = Mesh(np.array(jax.devices()[:N_DEV]).reshape(2, 2),
                  ("data", "model"))
    energy_b = make_sharded_batch_energy(
        mesh22, "data", "model", covalent_map=s["covalent_map"], **common)
    batch = jnp.stack([pos, pos + 0.01])
    pairs_b = jnp.stack([pairs, pairs])

    def weighted(qq):
        e = energy_b(batch, box, pairs_b, qq, m)
        return jnp.sum(e * jnp.array([1.0, -0.5])), e

    (_, e_b), g_q = jax.jit(jax.value_and_grad(weighted, has_aux=True))(q)
    out["batch"] = (e_b, g_q)
    out.update(pool_32.result())
    out["ff32_spread_f64"] = tuple(a + b for a, b in zip(
        out["pme32_spread_f64"], out["rest32"]))
    return {k: tuple(None if v is None else np.asarray(v) for v in val)
            for k, val in out.items()}


@pytest.fixture(scope="module")
def ranks(port, ref):
    return port[1].results()


@pytest.mark.parametrize("name", ["pme", "pme_sparse", "disp6", "disp4",
                                  "tt", "ff"])
def test_energy_and_forces_match_admp_tpu(ref, ranks, name):
    e_ref, g_ref = ref[name]
    for r in ranks:
        e, g = r[name]
        np.testing.assert_allclose(e, float(e_ref), rtol=1e-9)
        np.testing.assert_allclose(g, g_ref, atol=1e-9)


def test_cached_influence_energy_matches_admp_tpu(ref, ranks):
    for r in ranks:
        np.testing.assert_allclose(r["pme_cached"],
                                   float(ref["pme_cached"][0]), rtol=1e-9)
        np.testing.assert_allclose(r["pme_cached"], r["pme"][0], rtol=1e-9)


def test_sparse_exclusions_give_the_dense_result(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["pme_sparse"][0], r["pme"][0],
                                   rtol=1e-12)


def test_batch_energy_on_a_data_model_split_matches_admp_tpu(ref, ranks):
    e_ref, g_ref = ref["batch"]
    for r in ranks:
        e, g = r["batch"]
        assert e.shape == (2,)
        np.testing.assert_allclose(e, e_ref, rtol=1e-9)
        np.testing.assert_allclose(g, g_ref, atol=1e-9)


def test_keywords_change_nothing_at_float64():
    """The premise of holding the float64 keyword runs against admp_tpu's
    default results: compensated sums are both packages' default, and the
    float64 spread weights of a float64 input are the default ones."""
    assert TEngine(compensated_sums=True) == TEngine()
    assert EngineConfig(compensated_sums=True) == EngineConfig()
    inp = water_inputs()
    s = inp["sys"]
    args = (jnp.asarray(s["positions"]), jnp.asarray(s["box"]),
            jnp.asarray(inp["q_local"]), GRID, 2)
    for a, b in zip(atom_spread_alpha(*args),
                    atom_spread_alpha(*args, precision="f64")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("factory", ["pme", "ff"])
@pytest.mark.parametrize("name", sorted(cases.KEYWORDS))
def test_precision_keywords_at_float64_match_admp_tpu(ref, ranks, name,
                                                      factory):
    e_ref, g_ref = ref[factory]
    for r in ranks:
        e, g = r[f"{factory}64_{name}"]
        np.testing.assert_allclose(e, float(e_ref), rtol=1e-9)
        np.testing.assert_allclose(g, g_ref, atol=1e-9)
        # the port's own default forces bit for bit; under the float64
        # weights its energy too
        e0, g0 = r[factory]
        assert np.array_equal(g, g0)
        assert name == "uncompensated" or e == e0


@pytest.mark.parametrize("factory", ["pme", "ff"])
def test_precision_keywords_at_float32_match_admp_tpu(ref, ranks, factory):
    e_j, g_j = (np.asarray(x, np.float64)
                for x in ref[f"{factory}32_spread_f64"])
    for r in ranks:
        e_64, g_64 = r[f"{factory}64r_default"]
        e, g = r[f"{factory}32_spread_f64"]
        assert rel_err(g, g_j) < TOL_KW_VS_JAX[factory], rel_err(g, g_j)
        err, err_j = rel_err(g, g_64), rel_err(g_j, g_64)
        assert err <= 1.5 * err_j + 1e-8, (err, err_j)
        assert abs(e - float(e_j)) <= TOL_E_JAX[factory], (e, float(e_j))
        if factory == "pme":
            assert abs(e - e_64) <= TOL_E32["pme"], (e, e_64)


@pytest.mark.parametrize("name", sorted(cases.KEYWORDS32))
def test_precision_keywords_match_single_device_and_float64(ranks, name):
    for r in ranks:
        e, g = r[f"pme32_{name}"]
        e_s, g_s = r[f"single32_{name}"]
        e_64, g_64 = r["pme64r_default"]
        assert rel_err(g, g_s) < TOL_KW_SINGLE[name], rel_err(g, g_s)
        assert rel_err(g, g_64) < TOL_KW_F64[name], rel_err(g, g_64)
        if name == "uncompensated":
            # two plain f32 sums in different orders
            assert abs(e - e_s) <= 1e-6 * E_SCALE, (e, e_s)
        else:
            assert abs(e - e_s) <= TOL_E32["pme"], (e, e_s)
            assert abs(e - e_64) <= TOL_E32["pme"], (e, e_64)
            assert abs(e_s - e_64) <= TOL_E32["pme"], (e_s, e_64)


def test_compensated_sums_change_the_energy_not_the_forces(ranks):
    for r in ranks:
        for factory in ("pme", "ff"):
            e_c, g_c = r[f"{factory}32_default"]
            e_u, g_u = r[f"{factory}32_uncompensated"]
            assert e_c != e_u, factory
            assert np.array_equal(g_c, g_u), factory
        # the compensated sum meets TOL_E32 against float64, the plain one
        # misses it
        e_64 = r["pme64r_default"][0]
        assert abs(r["pme32_default"][0] - e_64) <= TOL_E32["pme"]
        assert abs(r["pme32_uncompensated"][0] - e_64) > TOL_E32["pme"]
