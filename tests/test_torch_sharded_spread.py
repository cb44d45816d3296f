"""The port's pencil FFT, halo-exchange spreads and sharded cell-list pairs
on 4 gloo ranks against admp_tpu's on 4 of conftest's virtual devices, in
float64: the FFT blocks against jnp.fft.fftn too (1e-10), the spread slabs
and their position and multipole gradients (1e-10 of their largest value),
the three-channel slabs at orders 6 and 4, an overflowing bin (NaN slab,
the flag on every rank), and the pairs of each rank as sets. The slab
spread's route on CPU tensors: 'cuda' refuses them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from admp_tpu.ops.neighborlist import sharded_cell_pairs
from admp_tpu.parallel import fft3d_pencil, rfft3d_pencil
from admp_tpu.parallel.spread import (
    sharded_spread_halo,
    sharded_spread_halo_multi,
)
from admp_tpu_torch.parallel.launch import start
from tests import torch_sharded_cases as cases
from tests.watergen import water_arrays

N_DEV = 4
GRID = (16, 16, 16)
CELL = dict(cutoff=3.0, n_cells=(8, 8, 8), cell_capacity=16, capacity=4096)


def _inputs():
    rng = np.random.default_rng(11)
    n = 256
    lattice = water_arrays(n_side=4, spacing=3.1, jitter=0.12, seed=5)
    cells = water_arrays(n_side=8, spacing=3.1, jitter=0.12, seed=9)
    return dict(
        fft_x=rng.normal(size=GRID), grid=GRID,
        pos=rng.uniform(0, 16.0, (n, 3)), box=np.eye(3) * 16.0,
        q9=rng.standard_normal((n, 9)), c3=rng.uniform(0.5, 2.0, (n, 3)),
        lattice_pos=lattice["positions"], lattice_box=lattice["box"],
        lattice_q=rng.standard_normal((lattice["positions"].shape[0], 9)),
        tight_cap=0.05,
        cell_pairs=dict(positions=cells["positions"], box=cells["box"],
                        **CELL))


@pytest.fixture(scope="module")
def port():
    inp = _inputs()
    # the ranks run while admp_tpu compiles its side
    return inp, start(cases.fft_spread_cases, N_DEV, args=(inp,),
                      timeout=600)


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:N_DEV]), ("model",))


@pytest.fixture(scope="module")
def ref(port, mesh4):
    inp, _ = port
    out = {}
    x = jnp.asarray(inp["fft_x"])
    for name, fn in (("fft3d", fft3d_pencil), ("rfft3d", rfft3d_pencil)):
        out[name] = np.asarray(jax.jit(jax.shard_map(
            lambda s, fn=fn: fn(s, "model"), mesh=mesh4,
            in_specs=P("model"), out_specs=P(None, "model"),
            check_vma=False))(x))

    def spread(p, b, q, cap=3.0):
        return sharded_spread_halo(p, b, q, GRID, 2, "model", N_DEV,
                                   cap_factor=cap, spread_method="scatter")

    sm = lambda f, outs: jax.shard_map(  # noqa: E731
        f, mesh=mesh4, in_specs=(P(), P(), P()), out_specs=outs,
        check_vma=False)
    pos, box, q9 = (jnp.asarray(inp[k]) for k in ("pos", "box", "q9"))
    slab_fn = sm(lambda p, b, q: spread(p, b, q)[0], P("model", None, None))
    out["slab"] = np.asarray(jax.jit(slab_fn)(pos, box, q9))
    out["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda p, q: jnp.sum(slab_fn(p, box, q) ** 2), argnums=(0, 1)))(
            pos, q9)]
    c3 = jnp.asarray(inp["c3"])
    for order in (6, 4):
        out[f"multi{order}"] = np.asarray(jax.jit(sm(
            lambda p, b, c, order=order: sharded_spread_halo_multi(
                p, b, c, GRID, "model", N_DEV, order)[0],
            P(None, "model", None, None)))(pos, box, c3))
    out["tight_overflow"] = bool(jax.jit(sm(
        lambda p, b, q: spread(p, b, q, inp["tight_cap"])[1], P()))(
            *(jnp.asarray(inp[k]) for k in ("lattice_pos", "lattice_box",
                                            "lattice_q"))))
    cp = inp["cell_pairs"]
    fn = jax.shard_map(
        lambda p, b: sharded_cell_pairs(p, b, CELL["cutoff"], CELL["n_cells"],
                                        CELL["cell_capacity"],
                                        CELL["capacity"], "model"),
        mesh=mesh4, in_specs=(P(), P()), out_specs=(P("model", None), P()))
    pairs, flag = jax.jit(fn)(jnp.asarray(cp["positions"]),
                              jnp.asarray(cp["box"]))
    out["cell_pairs"] = np.asarray(pairs)
    out["cell_pairs_overflow"] = bool(flag)
    return out


@pytest.fixture(scope="module")
def ranks(port, ref):
    return port[1].results()


def test_pencil_ffts_match_fftn_and_admp_tpu(port, ref, ranks):
    inp, _ = port
    full = {"fft3d": np.fft.fftn(inp["fft_x"]),
            "rfft3d": np.fft.rfftn(inp["fft_x"])}
    for name in ("fft3d", "rfft3d"):
        got = np.concatenate([r[name] for r in ranks], axis=1)
        np.testing.assert_allclose(got, full[name], atol=1e-10)
        np.testing.assert_allclose(got, ref[name], atol=1e-10)


def test_halo_spread_slabs_match_admp_tpu(ref, ranks):
    got = np.concatenate([r["slab"] for r in ranks])
    scale = np.abs(ref["slab"]).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref["slab"], atol=1e-10 * scale)
    assert not any(r["overflow"] for r in ranks)


def test_halo_spread_gradients_match_admp_tpu(ref, ranks):
    for name, want in zip(("slab_grad_pos", "slab_grad_q"), ref["grads"]):
        scale = np.abs(want).max()
        for r in ranks:
            np.testing.assert_allclose(r[name], want, atol=1e-10 * scale)


@pytest.mark.parametrize("order", [6, 4])
def test_multi_channel_slabs_match_admp_tpu(ref, ranks, order):
    got = np.concatenate([r[f"multi{order}"] for r in ranks], axis=1)
    want = ref[f"multi{order}"]
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())
    assert not any(r[f"multi{order}_overflow"] for r in ranks)


def test_overflowing_bin_poisons_the_slab_and_raises_the_flag(ref, ranks):
    assert ref["tight_overflow"]
    for r in ranks:
        assert r["tight_overflow"]
        assert np.isnan(r["tight_slab"]).all()


def test_sharded_cell_pairs_match_admp_tpu_per_rank(port, ref, ranks):
    n = port[0]["cell_pairs"]["positions"].shape[0]
    cap = CELL["capacity"]
    assert not ref["cell_pairs_overflow"]
    total = 0
    for rank, r in enumerate(ranks):
        want = ref["cell_pairs"][rank * cap:(rank + 1) * cap]
        want = set(map(tuple, want[want[:, 0] < n].tolist()))
        got = set(map(tuple, r["cell_pairs"][r["cell_pairs"][:, 0] < n]
                      .tolist()))
        assert got == want, (rank, len(got), len(want))
        assert not r["cell_pairs_overflow"]
        total += len(got)
    assert total > 0


def test_slab_spread_route_refuses_cpu_tensors_under_cuda():
    from admp_tpu_torch.parallel.spread import _local_slab_spread

    base = torch.zeros(4, 3, dtype=torch.int32)
    q = torch.ones(4, 6, 6, 6, dtype=torch.float32)
    for method in ("auto", "torch"):
        slab = _local_slab_spread(base, q, 0, 4, 5, 8, 8, 6, method)
        assert slab.shape == (9, 8, 8)
        assert float(slab.sum()) == pytest.approx(4 * 216)
    for method in ("cuda", "cuda2d"):
        with pytest.raises(ValueError, match="CUDA"):
            _local_slab_spread(base, q, 0, 4, 5, 8, 8, 6, method)
