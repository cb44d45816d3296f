"""admp_tpu_torch's large-system path against admp_tpu at float64.

* Pair chunking (``pair_chunk``) against the unchunked real-space sum:
  energy 1e-12 relative, position gradient 1e-10 absolute; atom chunking
  (``atom_chunk``) of the plain spread against the unchunked mesh and
  admp_tpu's chunked one: 1e-12 absolute, gradient 1e-9 absolute; and
  make_pme_recip's chunk rule wired through.
* The fluctuating-multipole step of examples/fluctuating_multipoles.py
  (charges that follow each water's O-H stretches, forces through the
  geometry and the generated Q_local) on a 192-atom box with sparse
  exclusions, cell-list pairs and the 5-smooth grid: energy 1e-10 relative,
  forces 1e-8 of max|F|, on the plain route and again on the tiled route's
  plain versions (K5/K7's binning, autograd pairing and per-tile plain
  versions, with ``resolve_spread_method`` made to answer 'cuda2d') at a
  grid the tile does not divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import ADMPPmeForce as JForce
from admp_tpu import convert_cart2harm as j_cart2harm
from admp_tpu import neighbor_list_cell as j_cell
from admp_tpu.ops import reciprocal as jr
from admp_tpu.ops.exclusions import build_sparse_exclusions as j_sparse
from admp_tpu.settings import EngineConfig as JEngine
from admp_tpu_torch import EngineConfig, convert_cart2harm, neighbor_list_cell
from admp_tpu_torch.models.pme import ADMPPmeForce, pme_real_energy
from admp_tpu_torch.ops import reciprocal as tr
from admp_tpu_torch.ops.cuda import spread as S
from admp_tpu_torch.ops.exclusions import build_sparse_exclusions
from admp_tpu_torch.ops.frames import local_frames_components
from admp_tpu_torch.ops.harmonics import rot_local2global_components
from admp_tpu_torch.ops.influence import ck_1
from admp_tpu_torch.systems import water_system as t_water_system
from torch_port_cases import dense_pairs, t64, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
R0, COUPLING = 0.9572, 0.4


def _global_multipoles(s, pos, box):
    frames = local_frames_components(pos, box,
                                     torch.as_tensor(s["axis_types"]),
                                     torch.as_tensor(s["axis_indices"]))
    return rot_local2global_components(t64(s["q_local"]), frames, 2)


@pytest.mark.parametrize("exclusions", ["dense", "sparse"])
@pytest.mark.parametrize("compensated", [False, True])
def test_pair_chunked_real_space(exclusions, compensated):
    s = water(n_side=3, seed=55)
    n = s["positions"].shape[0]
    pairs = torch.as_tensor(dense_pairs(s["positions"], s["box"], 4.0))
    box = t64(s["box"])
    cov = (torch.as_tensor(s["covalent_map"]).long() if exclusions == "dense"
           else build_sparse_exclusions(
               [(3 * m, 3 * m + h) for m in range(n // 3) for h in (1, 2)],
               n, 6))

    def energy(pos, chunk):
        qg = _global_multipoles(s, pos, box)
        return pme_real_energy(pos, box, pairs, qg, None, None, None,
                               t64(SCALES), None, cov, 0.7, 2, False,
                               compensated=compensated, pair_chunk=chunk)

    pos = t64(s["positions"]).requires_grad_(True)
    e_full, e_chunk = energy(pos, None), energy(pos, 64)
    assert e_chunk.item() == pytest.approx(e_full.item(), rel=1e-12)
    (g_full,) = torch.autograd.grad(e_full, pos)
    (g_chunk,) = torch.autograd.grad(e_chunk, pos)
    np.testing.assert_allclose(g_chunk.numpy(), g_full.numpy(), rtol=0,
                               atol=1e-10)


def test_atom_chunked_spread(monkeypatch):
    s = water(n_side=3, seed=55)
    box = t64(s["box"])
    grid = (18, 18, 18)
    pos = t64(s["positions"]).requires_grad_(True)
    qg = _global_multipoles(s, pos, box).detach()
    full = tr.spread_to_mesh(pos, box, qg, grid, 2)
    chunked = tr.spread_to_mesh(pos, box, qg, grid, 2, atom_chunk=16)
    np.testing.assert_allclose(chunked.detach().numpy(),
                               full.detach().numpy(), rtol=0, atol=1e-12)
    want = jr.spread_to_mesh(jnp.asarray(s["positions"]), jnp.asarray(s["box"]),
                             jnp.asarray(qg.numpy()), grid, 2, atom_chunk=16)
    np.testing.assert_allclose(chunked.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-12)
    (g_full,) = torch.autograd.grad((full ** 2).sum(), pos)
    (g_chunk,) = torch.autograd.grad((chunked ** 2).sum(), pos)
    np.testing.assert_allclose(g_chunk.numpy(), g_full.numpy(), rtol=0,
                               atol=1e-9)

    # make_pme_recip chunks the plain spread above its threshold
    recip = tr.make_pme_recip(ck_1, 0.7, grid, 2, 138.935456)
    e_full = recip(pos, box, qg)
    monkeypatch.setattr(tr, "ATOM_CHUNK", 16)
    monkeypatch.setattr(tr, "ATOM_CHUNK_ABOVE", 32)
    calls = []
    plain = S.spread_torch
    monkeypatch.setattr(S, "spread_torch",
                        lambda *a: calls.append(1) or plain(*a))
    e_chunk = recip(pos, box, qg)
    assert len(calls) == -(-pos.shape[0] // 16)
    assert e_chunk.item() == pytest.approx(e_full.item(), rel=1e-12)


def _j_fluctuating(q_cart0, n):
    """examples/fluctuating_multipoles.py:75-91, as it stands there."""
    nmol = n // 3
    r0 = R0
    coupling = COUPLING

    def fluctuating_q_local(positions):
        o = positions[0::3]
        h1 = positions[1::3]
        h2 = positions[2::3]
        d1 = jnp.linalg.norm(h1 - o, axis=-1) - r0
        d2 = jnp.linalg.norm(h2 - o, axis=-1) - r0
        dq1 = coupling * d1
        dq2 = coupling * d2
        q = q_cart0.reshape(nmol, 3, -1)
        q = q.at[:, 0, 0].add(dq1 + dq2)
        q = q.at[:, 1, 0].add(-dq1)
        q = q.at[:, 2, 0].add(-dq2)
        return j_cart2harm(q.reshape(n, -1), 2)

    return fluctuating_q_local


def t_fluctuating(positions, q_cart0):
    """The same generator in the port: each water's O and H charges shift
    by coupling x the O-H stretches, then Cartesian -> harmonic."""
    n = positions.shape[0]
    o, h1, h2 = positions[0::3], positions[1::3], positions[2::3]
    dq1 = COUPLING * (torch.linalg.norm(h1 - o, dim=-1) - R0)
    dq2 = COUPLING * (torch.linalg.norm(h2 - o, dim=-1) - R0)
    q = q_cart0.reshape(n // 3, 3, -1)
    dq = torch.stack([dq1 + dq2, -dq1, -dq2], dim=1)
    q = torch.cat([q[..., :1] + dq[..., None], q[..., 1:]], dim=-1)
    return convert_cart2harm(q.reshape(n, -1), 2)


@pytest.mark.parametrize("route", ["torch", "cuda2d"])
def test_fluctuating_multipole_step_matches(route, monkeypatch):
    s = t_water_system(n_side=4, spacing=3.104, jitter=0.1, seed=0,
                       exclusions="sparse")
    n = s["positions"].shape[0]
    bonds = [(3 * m, 3 * m + h) for m in range(n // 3) for h in (1, 2)]
    rng = np.random.default_rng(0)
    p0 = s["positions"]
    p1 = p0 + 0.005 * rng.standard_normal(p0.shape)

    jl = j_cell(jnp.asarray(p0), jnp.asarray(s["box"]), 4.0)
    tl = neighbor_list_cell(t64(p0), t64(s["box"]), 4.0)
    assert not bool(tl.did_overflow) and tl.i_sorted
    np.testing.assert_array_equal(tl.pairs.numpy(), np.asarray(jl.pairs))

    jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                j_sparse(bonds, n, max_depth=6), 4.0, 1e-4, lmax=2,
                config=JEngine(fft_friendly_grid=True, pairs_i_sorted=True))
    tf = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                      s["covalent_map"], 4.0, 1e-4, lmax=2,
                      config=EngineConfig(fft_friendly_grid=True,
                                          pairs_i_sorted=True,
                                          spread_method="torch"),
                      device="cpu", dtype=torch.float64)
    assert (tf.K1, tf.K2, tf.K3) == (jf.K1, jf.K2, jf.K3)
    assert tf.kappa == pytest.approx(float(jf.kappa), rel=1e-15)
    if route == "cuda2d":
        # a grid the (8, 8, 32) tile does not divide, on both sides
        for f in (jf, tf):
            f.K1, f.K2, f.K3 = 20, 27, 25
            f.refresh_calculators()
        monkeypatch.setattr(tr, "resolve_spread_method",
                            lambda *a, **k: "cuda2d")
        calls = {"spread": 0, "gather": 0}
        for name, fn in (("spread", S.spread_tiled_torch),
                         ("gather", S.gather_tiled_torch)):
            def counted(*a, name=name, fn=fn):
                calls[name] += 1
                return fn(*a)
            monkeypatch.setattr(S, f"{name}_tiled_torch", counted)

    j_q = _j_fluctuating(jnp.asarray(s["q_cart"]), n)
    box_j, pairs_j = jnp.asarray(s["box"]), jnp.asarray(jl.pairs)
    step = jax.jit(jax.value_and_grad(lambda p: jf.get_energy(
        p, box_j, pairs_j, j_q(p), jnp.asarray(SCALES))))
    q_cart0 = t64(s["q_cart"])
    for pos in (p0, p1):
        e_j, g_j = step(jnp.asarray(pos))
        p = t64(pos).requires_grad_(True)
        e_t = tf.get_energy(p, t64(s["box"]), tl, t_fluctuating(p, q_cart0),
                            t64(SCALES))
        (g_t,) = torch.autograd.grad(e_t, p)
        assert e_t.item() == pytest.approx(float(e_j), rel=1e-10)
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                                   atol=1e-8 * np.abs(g_j).max())
    if route == "cuda2d":
        assert calls["spread"] == 2 and calls["gather"] == 2
