"""admp_tpu_torch's short-range pair interactions against admp_tpu at float64:
the Tang-Toennies kernel over 1000 random pairs with masked and excluded
ones among them (1e-12 of max|e|), expand_pairs and its topological-distance
wrap (exact), and generate_pairwise_interaction(tt_damping_qq_c6_kernel)
energy and forces on water_system(n_side=4) (1e-10 relative energy, 1e-9
relative RMSE)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.ops import shortrange as js
from admp_tpu_torch import TT_damping_qq_c6_kernel, distribute_dispcoeff
from admp_tpu_torch.ops import shortrange as ts
from torch_port_cases import assert_close, dense_pairs, rel_err, t64, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])


def test_tt_kernel_per_pair():
    rng = np.random.default_rng(0)
    n = 1000
    r = rng.uniform(0.9, 4.0, n)
    r[:100] = 1.0  # masked pairs carry r = 1
    mscale = rng.choice([0.0, 0.5, 1.0], n)
    a = rng.uniform(0.01, 500, (2, n))
    b = rng.uniform(1.5, 2.5, (2, n))
    q = rng.uniform(-0.8, 0.8, (2, n))
    c = rng.uniform(5, 40, (2, n))
    args = (r, mscale, a[0], a[1], b[0], b[1], q[0], q[1], c[0], c[1])
    want = js.tt_damping_qq_c6_kernel(*(jnp.asarray(x) for x in args))
    got = ts.tt_damping_qq_c6_kernel(*(t64(x) for x in args))
    assert_close(got, want, rel=1e-12, abs_=0.0)
    assert TT_damping_qq_c6_kernel is ts.tt_damping_qq_c6_kernel


def test_expand_pairs_and_the_distance_wrap():
    s = water(n_side=3, seed=2)
    pairs = dense_pairs(s["positions"], s["box"], 4.0)
    scales = np.array([0.1, 0.2, 0.3, 0.4, 0.9])
    want = js.expand_pairs(*(jnp.asarray(x) for x in (
        s["positions"], s["box"], pairs, s["covalent_map"], scales)))
    got = ts.expand_pairs(t64(s["positions"]), t64(s["box"]),
                          torch.as_tensor(pairs),
                          torch.as_tensor(s["covalent_map"]).long(), t64(scales))
    for a, b in zip(got, want):
        assert_close(a, b, rel=1e-15, abs_=0.0)
    mask, _, _, _, mscale = got
    # non-bonded pairs (distance 0) take the last entry
    assert float(mscale[mask].max()) == 0.9
    assert distribute_dispcoeff(t64(s["c_list"]), torch.tensor([3, 0]))[0, 0] \
        == s["c_list"][3, 0]


@pytest.mark.parametrize("seed", [4, 7])
def test_tt_interaction_energy_and_forces(seed):
    s = water(n_side=4, seed=seed)
    pairs = dense_pairs(s["positions"], s["box"], 4.0)
    params = [s["tt_a"], s["tt_b"], s["tt_q"], s["c_list"][:, 0]]
    jf = js.generate_pairwise_interaction(js.tt_damping_qq_c6_kernel,
                                          s["covalent_map"])
    tf = ts.generate_pairwise_interaction(ts.tt_damping_qq_c6_kernel,
                                          s["covalent_map"], device="cpu")
    ej, gj = jax.value_and_grad(jf)(
        *(jnp.asarray(x) for x in (s["positions"], s["box"], pairs, SCALES,
                                   *params)))
    pos = t64(s["positions"]).requires_grad_(True)
    et = tf(pos, t64(s["box"]), torch.as_tensor(pairs), t64(SCALES),
            *(t64(p) for p in params))
    (gt,) = torch.autograd.grad(et, pos)
    assert abs(float(et.detach()) - float(ej)) <= 1e-10 * abs(float(ej))
    assert rel_err(gt, gj) < 1e-9
