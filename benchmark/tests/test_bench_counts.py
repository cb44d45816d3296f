"""The work counts against hand counts at tiny shapes."""

from __future__ import annotations

import pytest
import torch

from benchmark.counts import opcount, pairs, peaks, spread


def test_count_ops_counts_elementwise_and_skips_moves():
    a, b = torch.ones(10), torch.ones(10)
    assert opcount.count_ops(lambda: a * b + a) == 20
    assert opcount.count_ops(lambda: torch.cat([a, b]).reshape(4, 5)) == 0
    assert opcount.count_ops(lambda: (a * b).sum()) == 20


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == (1.0, "bytes")
    assert peaks.bound_s(0, 67e12) == (1.0, "operations")
    t, what = peaks.bound_s(3.35e12, 2 * 67e12)
    assert (t, what) == (2.0, "operations")


@pytest.mark.parametrize("kind,lmax,width", [("perm", 2, 12), ("pol", 2, 17),
                                             ("uu", 2, 8), ("perm", 0, 4)])
def test_pair_pass_bytes_by_hand(kind, lmax, width):
    n_bytes, ops = pairs.pass_work(kind, lmax, 10, 100)
    assert n_bytes == 2 * 10 * width * 4 + 100 * 8 + 4
    assert ops == 2 * 100 * pairs.ops_per_pair(kind, lmax)


def test_pair_ops_grow_with_the_model():
    per = {k: pairs.ops_per_pair(k, 2) for k in ("uu", "perm", "pol")}
    assert 0 < per["uu"] < per["perm"] < per["pol"]
    assert pairs.ops_per_pair("perm", 1) < per["perm"]


def test_pair_step_passes():
    assert pairs.step_passes(False, 7) == [("perm", 1.0)]
    assert pairs.step_passes(True, 3) == [("pol", 2.0), ("uu", 3.0)]
    shapes = dict(polarizable=True, lmax=2, n_atoms=10, n_pairs=100)
    one = peaks.bound_s(*pairs.pass_work("pol", 2, 10, 100))[0]
    uu = peaks.bound_s(*pairs.pass_work("uu", 2, 10, 100))[0]
    assert pairs.step_bound_s(shapes, 3) == pytest.approx(2 * one + 3 * uu)


def test_spread_and_gather_by_hand():
    # 2 atoms, lmax 1 (4 harmonics), order 4, a 4^3 mesh
    assert spread.spread_work(2, 1, 4, (4, 4, 4)) == (2 * 7 * 4 + 64 * 4,
                                                      2 * 64)
    # the gather reads at most the points the stencils touch
    assert spread.gather_work(1, 1, 4, (8, 8, 8)) == (64 * 4 + 12 + 28,
                                                      2 * 64)
    shapes = dict(n_atoms=2, lmax=1, grid=(4, 4, 4), polarizable=True)
    one = (peaks.bound_s(*spread.spread_work(2, 1, 6, (4, 4, 4)))[0]
           + peaks.bound_s(*spread.gather_work(2, 1, 6, (4, 4, 4)))[0])
    assert spread.step_bound_s(shapes) == pytest.approx(2 * one)
