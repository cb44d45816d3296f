"""The reader of host.syncs.md (metrics/host.syncs.md.py): the sum of the
program's ``host.syncs.*`` counters over the traced steps, 0.0 from a
registry without them, None without a traced window or a registry; and a
traced run of each cell on the tiny CPU bench, where the fixed step syncs
nowhere and the polarizable step only at its SCF residuals, one read per
PCG iteration and one more."""

from __future__ import annotations

import pytest
from tiny import run_tiny

from benchmark.harness import core

NAME = "host.syncs.md"


def _read(ctx):
    return core.load_reader(core.BENCH, NAME).read(ctx)


def _traced(steps):
    return dict(trace=dict(steps=steps), window=dict(steps=30))


def _registry(monkeypatch, counters):
    from admp_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: dict(
        spans={}, counters=counters))


def test_a_registry_without_sync_counters_reads_zero(monkeypatch):
    _registry(monkeypatch, {"pairs.indexed": 40, "frames.kernel": 40})
    assert _read(_traced(20)) == 0.0


def test_it_reads_the_sum_of_the_sync_counters_per_step(monkeypatch):
    _registry(monkeypatch, {"host.syncs.scf.residual": 60,
                            "host.syncs.nl.overflow": 1,
                            "pairs.indexed": 160})
    assert _read(_traced(20)) == 61 / 20


@pytest.mark.parametrize("ctx", [dict(window=dict(steps=30)),
                                 dict(trace=dict(steps=0))],
                         ids=["untraced", "no_steps"])
def test_without_a_traced_window_it_reads_none(monkeypatch, ctx):
    _registry(monkeypatch, {"host.syncs.scf.residual": 3})
    assert _read(ctx) is None


def test_without_the_registry_it_reads_none(monkeypatch):
    from admp_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert _read(_traced(20)) is None


@pytest.mark.parametrize("cell", ["fixed98k.md", "polfull98k.md"])
def test_a_traced_run_reads_the_syncs_of_its_step(tiny_bench, cell):
    from admp_tpu_torch.utils import profiling

    profiling.reset()
    res = run_tiny(tiny_bench, cell, trace=1)
    profiling.reset()
    m = res["metrics"]
    assert m[NAME]["unit"] == "syncs/step"
    if cell == "fixed98k.md":
        assert m[NAME]["value"] == 0.0
    else:
        assert m[NAME]["value"] == m["scf.pcg_iters.md"]["value"] + 1
    assert res["correct"]
