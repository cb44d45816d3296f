"""admp_tpu_torch/utils/comm.py on 4 gloo ranks on the CPU: every collective
forward and backward (the transposes: a replicated total's gradient counted
once), a second derivative through psum and pvary, the byte tally, and the
tally of the rfft pencil and the halo spread equal to admp_tpu's
``collective_bytes`` on 4 of conftest's virtual devices (the numbers
tests/test_sharding.py:743-792 pins, at P = 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from admp_tpu.parallel.fft import rfft3d_pencil
from admp_tpu.parallel.spread import sharded_spread_halo
from admp_tpu.utils import comm as jax_comm
from admp_tpu_torch.parallel.launch import launch
from admp_tpu_torch.utils import comm
from tests import torch_sharded_cases as cases

N_DEV = 4
K = 32


def _inputs():
    rng = np.random.default_rng(0)
    n = 384
    return dict(
        c=rng.normal(size=(2, 4)),
        a2a_x=rng.normal(size=(N_DEV, 4, 8, 3)),
        a2a_w=rng.normal(size=(N_DEV, 16, 2, 3)),
        ppermute_w=rng.normal(size=(N_DEV, 2, 4)),
        gather_c=rng.normal(size=(2 * N_DEV, 4)),
        k=K, fft_x=np.zeros((K, K, K)),
        pos=rng.uniform(0, 20.0, (n, 3)), box=np.eye(3) * 20.0,
        q9=rng.standard_normal((n, 9)))


@pytest.fixture(scope="module")
def run():
    inp = _inputs()
    return inp, launch(cases.comm_cases, N_DEV, args=(inp,), timeout=600)


def _x(rank):
    return np.arange(8.0).reshape(2, 4) + 10 * rank


def test_psum_sums_and_passes_the_cotangent(run):
    inp, out = run
    total = sum(_x(r) for r in range(N_DEV))
    for r in out:
        np.testing.assert_array_equal(r["psum"], total)
        np.testing.assert_array_equal(r["psum_grad"], inp["c"])


def test_pvary_sums_the_ranks_cotangents(run):
    inp, out = run
    # sum over ranks of (rank + 1): the gradient of a replicated input
    for r in out:
        np.testing.assert_allclose(r["pvary_grad"], 10.0 * np.ones((2, 4)))


def test_second_derivative_through_psum_and_pvary(run):
    inp, out = run
    # f(a) = 10 |a|^2: f' = 20 a, f'' v = 20 v
    for r in out:
        np.testing.assert_allclose(r["first"], 20.0 * inp["c"], rtol=1e-14)
        np.testing.assert_allclose(r["second"], 20.0 * inp["c"], rtol=1e-14)


def test_all_to_all_layout_and_backward(run):
    inp, out = run
    x, w = inp["a2a_x"], inp["a2a_w"]
    for rank, r in enumerate(out):
        # split axis 1 (8 -> 2 per rank), concatenate axis 0 by source
        want = np.concatenate([x[src][:, 2 * rank:2 * rank + 2]
                               for src in range(N_DEV)])
        np.testing.assert_array_equal(r["a2a"], want)
        # backward: the reverse all_to_all of the cotangents
        grad = np.concatenate([w[dst][4 * rank:4 * rank + 4]
                               for dst in range(N_DEV)], axis=1)
        np.testing.assert_array_equal(r["a2a_grad"], grad)
        assert r["a2a_complex_roundtrip"]


def test_ppermute_ring_and_inverse_shift(run):
    inp, out = run
    for rank, r in enumerate(out):
        np.testing.assert_array_equal(r["ppermute"], _x((rank - 1) % N_DEV))
        np.testing.assert_array_equal(r["ppermute_grad"],
                                      inp["ppermute_w"][(rank + 1) % N_DEV])


def test_all_gather_and_own_block_backward(run):
    inp, out = run
    want = np.concatenate([_x(r) for r in range(N_DEV)])
    for rank, r in enumerate(out):
        np.testing.assert_array_equal(r["all_gather"], want)
        np.testing.assert_array_equal(r["all_gather_grad"],
                                      inp["gather_c"][2 * rank:2 * rank + 2])


def test_tally_counts_bytes_and_loop_iterations(run):
    _, out = run
    t = out[0]["tally"]
    assert t["static"] == {"psum": 64, "all_to_all": 4 * 8 * 3 * 8,
                           "ppermute": 64, "all_gather": 64}
    assert t["total_static"] == sum(t["static"].values())
    assert t["while_iters"] == 3
    assert t["per_while_iter"] == {"psum": 64 + 32}


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:N_DEV]), ("model",))


def test_rfft_pencil_bytes_equal_collective_bytes(run, mesh4):
    _, out = run
    fft_fn = jax.shard_map(
        lambda x: rfft3d_pencil(x, "model"), mesh=mesh4,
        in_specs=(P("model", None, None),),
        out_specs=P(None, "model", None), check_vma=False)
    t = jax_comm.collective_bytes(fft_fn, jnp.zeros((K, K, K)))
    cplx_b = 2 * jnp.zeros(()).dtype.itemsize
    want = cplx_b * (K // N_DEV) * K * (K // 2 + 1)
    assert t["static"]["all_to_all"] == want
    for r in out:
        assert r["fft_tally"]["static"] == t["static"]
        assert r["fft_tally"]["total_static"] == t["total_static"]


def test_halo_spread_bytes_equal_collective_bytes(run, mesh4):
    inp, out = run
    spread_fn = jax.shard_map(
        lambda p, b, q: sharded_spread_halo(p, b, q, (K, K, K), 2, "model",
                                            N_DEV)[0],
        mesh=mesh4, in_specs=(P(), P(), P()),
        out_specs=P("model", None, None), check_vma=False)
    t = jax_comm.collective_bytes(spread_fn, jnp.asarray(inp["pos"]),
                                  jnp.asarray(inp["box"]),
                                  jnp.asarray(inp["q9"]))
    n_loc = inp["pos"].shape[0] // N_DEV
    cap = min(n_loc, int(-(-n_loc * 3.0 // N_DEV)) + 8)
    float_b, int_b = 8, 4
    assert t["static"]["all_to_all"] == N_DEV * cap * (
        (3 + 10) * float_b + 3 * int_b)
    width, halo = K // N_DEV, 5
    assert t["static"]["ppermute"] == -(-halo // width) * halo * K * K * 8
    for r in out:
        # all_to_all, ppermute and the overflow flag's psum, byte for byte
        assert r["spread_tally"]["static"] == t["static"]


def test_format_report_matches_admp_tpu(run):
    _, out = run
    tally = out[0]["tally"]
    args = ("tally", tally, "notes")
    assert comm.format_report(*args) == jax_comm.format_report(*args)


def test_launch_reraises_a_rank_failure_and_stops_the_rest():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch(cases.failing_rank, 3, timeout=120)
