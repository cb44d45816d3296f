"""admp_tpu_torch's sparse exclusion tables against admp_tpu.

* The sparse lookup equals the dense map for every pair of a 192-atom box.
* ``build_sparse_exclusions`` gives admp_tpu's (idx, dist) arrays, array for
  array, and refuses a depth its 4-bit packing cannot hold.
* ``exclusion_pair_list`` gives admp_tpu's list for both map types.
* ``convert.force_from_jax`` / ``disp_force_from_jax`` and ``convert_state``
  carry a sparse admp_tpu map across; the port's energy with it equals the
  port's energy with the dense map (1e-12 relative) and admp_tpu's (1e-10
  relative), at float64; the Tang-Toennies and polarizable paths take the
  sparse map too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu import ADMPDispPmeForce as JDisp
from admp_tpu import ADMPPmeForce as JForce
from admp_tpu.ops import exclusions as jx
from admp_tpu_torch import (
    ADMPPmeForce,
    EngineConfig,
    SCFConfig,
    generate_pairwise_interaction,
    tt_damping_qq_c6_kernel,
)
from admp_tpu_torch.convert import convert_state, disp_force_from_jax, force_from_jax
from admp_tpu_torch.ops import exclusions as tx
from admp_tpu_torch.systems import water_system as t_water_system
from torch_port_cases import dense_pairs, water

SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
RC = 4.0


def _bonds(n):
    return [(3 * m, 3 * m + h) for m in range(n // 3) for h in (1, 2)]


def test_sparse_lookup_matches_dense_for_every_pair():
    s = water(n_side=4, seed=11)
    n = s["positions"].shape[0]
    sparse = tx.build_sparse_exclusions(_bonds(n), n, max_depth=6)
    i = torch.arange(n).repeat_interleave(n)
    j = torch.arange(n).repeat(n)
    dense = torch.as_tensor(s["covalent_map"]).long()
    got = tx.lookup_topology_distance(sparse, i, j)
    assert torch.equal(got, dense[i, j])
    assert torch.equal(got, tx.lookup_topology_distance(dense, i, j))
    # the port's water_system builds the same table
    ts = t_water_system(n_side=4, spacing=3.1, jitter=0.12, seed=11,
                        exclusions="sparse")["covalent_map"]
    assert torch.equal(ts.idx, sparse.idx) and torch.equal(ts.dist, sparse.dist)


@pytest.mark.parametrize("depth", [1, 2, 6, 15])
def test_build_matches_admp_tpu(depth):
    rng = np.random.default_rng(depth)
    n = 60
    # a chain with branches and a ring, so rows have different widths
    bonds = [(k, k + 1) for k in range(n - 1)] + [(0, 9), (20, 35)]
    bonds += [(int(a), int(b)) for a, b in rng.integers(0, n, (8, 2)) if a != b]
    want = jx.build_sparse_exclusions(bonds, n, max_depth=depth)
    got = tx.build_sparse_exclusions(bonds, n, max_depth=depth)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert got.n_atoms == want.n_atoms == n
    with pytest.raises(ValueError, match="15"):
        tx.build_sparse_exclusions(bonds, n, max_depth=16)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_exclusion_pair_list_matches_admp_tpu(kind):
    s = water(n_side=3, seed=2)
    n = s["positions"].shape[0]
    if kind == "dense":
        j_map, t_map = s["covalent_map"], torch.as_tensor(s["covalent_map"])
    else:
        j_map = jx.build_sparse_exclusions(_bonds(n), n, 6)
        t_map = tx.build_sparse_exclusions(_bonds(n), n, 6)
    want = np.asarray(jx.exclusion_pair_list(j_map))
    got = tx.exclusion_pair_list(t_map)
    np.testing.assert_array_equal(got.numpy(), want)
    # 27 waters, 3 intramolecular pairs each, padded to 128 with (n, n)
    assert int((got[:, 0] < n).sum()) == 81 and got.shape == (128, 2)


def _pme_case():
    s = water(n_side=3, seed=12)
    n = s["positions"].shape[0]
    pairs = dense_pairs(s["positions"], s["box"], RC)
    j_sparse = jx.build_sparse_exclusions(_bonds(n), n, 6)
    return s, pairs, j_sparse


def test_force_from_jax_carries_a_sparse_map():
    s, pairs, j_sparse = _pme_case()
    jf = JForce(jnp.asarray(s["box"]), s["axis_types"], s["axis_indices"],
                j_sparse, RC, 1e-3, 2)
    j_args = [jnp.asarray(x) for x in (s["positions"], s["box"], pairs,
                                       s["q_local"], SCALES)]
    e_j = float(jf.get_energy(*j_args))
    tf = force_from_jax(jf, s["box"], device="cpu", dtype=torch.float64)
    assert isinstance(tf.covalent_map, tx.SparseExclusions)
    assert tf.n_atoms == s["positions"].shape[0]
    dense = force_from_jax(jf, s["box"], device="cpu", dtype=torch.float64)
    dense.covalent_map = torch.as_tensor(s["covalent_map"]).long()
    dense.refresh_calculators()
    t_args = [torch.as_tensor(x) for x in (s["positions"], s["box"], pairs,
                                           s["q_local"], SCALES)]
    e_t = float(tf.get_energy(*t_args))
    assert e_t == pytest.approx(float(dense.get_energy(*t_args)), rel=1e-12)
    assert e_t == pytest.approx(e_j, rel=1e-10)
    st = convert_state(device="cpu", covalent_map=j_sparse,
                       positions=s["positions"])
    assert torch.equal(st["covalent_map"].packed, tf.covalent_map.packed)


def test_disp_force_and_pair_interaction_take_a_sparse_map():
    s, pairs, j_sparse = _pme_case()
    jf = JDisp(jnp.asarray(s["box"]), j_sparse, RC, 1e-3, 10)
    j_args = [jnp.asarray(x) for x in (s["positions"], s["box"], pairs,
                                       s["c_list"], SCALES)]
    e_j = float(jf.get_energy(*j_args))
    tf = disp_force_from_jax(jf, s["box"], device="cpu", dtype=torch.float64)
    assert isinstance(tf.covalent_map, tx.SparseExclusions)
    t_args = [torch.as_tensor(x) for x in (s["positions"], s["box"], pairs,
                                           s["c_list"], SCALES)]
    e_t = float(tf.get_energy(*t_args))
    assert e_t == pytest.approx(e_j, rel=1e-10)
    tf.covalent_map = torch.as_tensor(s["covalent_map"]).long()
    assert e_t == pytest.approx(float(tf.get_energy(*t_args)), rel=1e-12)

    params = [torch.as_tensor(s[k]) for k in ("tt_a", "tt_b", "tt_q")]
    params.append(torch.as_tensor(s["c_list"][:, 0]))
    energies = [generate_pairwise_interaction(
        tt_damping_qq_c6_kernel, cov, device="cpu")(*t_args[:3],
                                                     t_args[4], *params)
        for cov in (tx.SparseExclusions(np.asarray(j_sparse.idx),
                                        np.asarray(j_sparse.dist),
                                        j_sparse.n_atoms),
                    s["covalent_map"])]
    assert float(energies[0]) == pytest.approx(float(energies[1]), rel=1e-12)


def test_polarizable_step_takes_a_sparse_map():
    """make_induced_quadratic_energy and the SCF on a sparse map: the same
    energy, forces and PCG count as on the dense map."""
    s, pairs, _ = _pme_case()
    n = s["positions"].shape[0]
    args = [torch.as_tensor(x) for x in (
        s["positions"], s["box"], pairs, s["q_local"], s["pol"], s["tholes"],
        SCALES, SCALES, SCALES)]
    out = []
    for cov in (tx.build_sparse_exclusions(_bonds(n), n, 6),
                s["covalent_map"]):
        f = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"], cov,
                         RC, 1e-3, 2, lpol=True,
                         config=EngineConfig(scf=SCFConfig.md()),
                         device="cpu", dtype=torch.float64)
        out.append(f.get_forces(*args) + (f.n_cycle,))
    (e_s, g_s, n_s), (e_d, g_d, n_d) = out
    assert n_s == n_d
    assert float(e_s) == pytest.approx(float(e_d), rel=1e-12)
    np.testing.assert_allclose(g_s.numpy(), g_d.numpy(), rtol=0,
                               atol=1e-10 * float(g_d.abs().max()))
