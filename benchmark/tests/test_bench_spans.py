"""The readers of the program's spans (metrics/*.host_ms.md.py,
md.self_ms.md.py): a traced run of fixed98k.md on the tiny CPU bench
reports each, finite and >= 0, in ms per step; against a program without
the span registry each reads None and raises nothing."""

from __future__ import annotations

import math

import pytest
from tiny import run_tiny

from benchmark.harness import core

SPAN_METRICS = ("md.self_ms.md", "frames.host_ms.md", "realspace.host_ms.md",
                "reciprocal.host_ms.md", "shortrange.host_ms.md")


def test_a_traced_run_reports_the_span_metrics(tiny_bench):
    from admp_tpu_torch.utils import profiling

    profiling.reset()
    res = run_tiny(tiny_bench, "fixed98k.md", trace=1)
    profiling.reset()
    for name in SPAN_METRICS:
        m = res["metrics"][name]
        assert math.isfinite(m["value"]) and m["value"] >= 0, name
        assert m["unit"] == "ms/step"
    assert res["correct"]


def test_an_untraced_run_reports_none_of_them(tiny_bench):
    res = run_tiny(tiny_bench, "fixed98k.md", trace=0)
    assert not set(SPAN_METRICS) & set(res["metrics"])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_without_the_registry_a_reader_reads_none(monkeypatch, name):
    from admp_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    ctx = dict(trace=dict(steps=20), window=dict(steps=30))
    assert core.load_reader(core.BENCH, name).read(ctx) is None
