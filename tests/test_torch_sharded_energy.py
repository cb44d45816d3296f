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
full force field is held against that sum."""

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
from admp_tpu.settings import EngineConfig
from admp_tpu_torch.parallel.launch import start
from tests import torch_sharded_cases as cases
from tests.torch_port_cases import dense_pairs
from tests.watergen import water_arrays

N_DEV = 4
GRID = (16, 16, 16)
KAPPA, DISP_KAPPA = 0.62, 0.7
M_SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
RC = 5.0


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
