"""admp_tpu_torch's cell list against admp_tpu's, exactly: the same pair set,
capacities and cell grid, i-sorted with (min, max) pairs and padding last,
no overflow, on clustered water boxes (n_side 4 and 5, as
tests/test_neighborlist.py:74 builds them); refresh_neighbor_list after a
drift and after a box change; the overflow retry; the dense fallback below
3 cells per axis."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.ops import neighborlist as jn
from admp_tpu_torch import neighbor_list_cell, refresh_neighbor_list
from torch_port_cases import t64, water


def _set(pairs, n):
    p = np.asarray(pairs)
    return {tuple(x) for x in p[p[:, 0] < n]}


def _check_contract(nl, n):
    p = nl.pairs.numpy()
    assert nl.i_sorted and np.all(np.diff(p[:, 0]) >= 0)
    real = p[p[:, 0] < n]
    assert np.all(real[:, 0] < real[:, 1])
    assert np.all(p[len(real):] == n)  # padding (n, n) sorts last
    assert not bool(nl.did_overflow)


@pytest.mark.parametrize("n_side,cutoff", [(4, 3.0), (4, 4.0), (5, 3.0),
                                           (5, 4.0)])
def test_cell_list_matches_admp_tpu(n_side, cutoff):
    s = water(n_side=n_side, seed=9)
    n = s["positions"].shape[0]
    want = jn.neighbor_list_cell(jnp.asarray(s["positions"]),
                                 jnp.asarray(s["box"]), cutoff)
    got = neighbor_list_cell(t64(s["positions"]), t64(s["box"]), cutoff)
    assert got.n_cells == want.n_cells and min(got.n_cells) >= 3
    assert (got.capacity, got.cell_capacity) == (want.capacity,
                                                 want.cell_capacity)
    assert _set(got.pairs, n) == _set(want.pairs, n)
    assert len(_set(got.pairs, n)) == int((got.pairs[:, 0] < n).sum())
    _check_contract(got, n)
    unsorted = neighbor_list_cell(t64(s["positions"]), t64(s["box"]), cutoff,
                                  sort_i=False)
    assert not unsorted.i_sorted
    assert _set(unsorted.pairs, n) == _set(got.pairs, n)


def test_refresh_after_drift_and_box_change():
    s = water(n_side=5, seed=3)
    n = s["positions"].shape[0]
    rng = np.random.default_rng(0)
    nl = neighbor_list_cell(t64(s["positions"]), t64(s["box"]), 4.0)
    moved = s["positions"] + 0.3 * rng.standard_normal(s["positions"].shape)
    fresh = refresh_neighbor_list(nl, t64(moved), t64(s["box"]))
    assert (fresh.capacity, fresh.n_cells) == (nl.capacity, nl.n_cells)
    want = jn.refresh_neighbor_list(
        jn.neighbor_list_cell(jnp.asarray(s["positions"]),
                              jnp.asarray(s["box"]), 4.0),
        jnp.asarray(moved), jnp.asarray(s["box"]))
    assert _set(fresh.pairs, n) == _set(want.pairs, n)
    _check_contract(fresh, n)
    # a larger box moves the cell grid: the list is allocated anew
    big = s["box"] * 1.3
    grown = refresh_neighbor_list(nl, t64(moved * 1.3), t64(big))
    assert grown.n_cells != nl.n_cells
    assert _set(grown.pairs, n) == _set(
        jn.neighbor_list_cell(jnp.asarray(moved * 1.3), jnp.asarray(big),
                              4.0).pairs, n)


def test_overflow_retries_and_dense_fallback():
    s = water(n_side=4, seed=9)
    n = s["positions"].shape[0]
    full = neighbor_list_cell(t64(s["positions"]), t64(s["box"]), 3.0)
    tight = neighbor_list_cell(t64(s["positions"]), t64(s["box"]), 3.0,
                               capacity=64, cell_capacity=2)
    assert tight.capacity > 64 and tight.cell_capacity > 2
    assert _set(tight.pairs, n) == _set(full.pairs, n)
    _check_contract(tight, n)
    # below 3 cells per axis: the dense list, as in admp_tpu
    small = water(n_side=2, seed=1)
    nl = neighbor_list_cell(t64(small["positions"]), t64(small["box"]), 2.5)
    assert nl.n_cells is None
    want = jn.neighbor_list_dense(jnp.asarray(small["positions"]),
                                  jnp.asarray(small["box"]), 2.5)
    assert _set(nl.pairs, 24) == _set(want.pairs, 24)
    moved = torch.as_tensor(small["positions"] + 0.05)
    assert _set(refresh_neighbor_list(nl, moved, t64(small["box"])).pairs,
                24) == _set(nl.pairs, 24)
