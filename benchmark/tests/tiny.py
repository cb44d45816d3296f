"""Helpers of the benchmark's tests: a copy of the benchmark's data files at
a size the CPU holds (4^3 waters, small meshes, a few steps), and a CPU run
of a cell through the harness."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MESH = {"water-pol-3k": [32, 32, 32], "water-fixed-98k": "fft_friendly"}
# the polarizable cell whose files stay beside BENCHMARK.json's cells
# until its step's host-bound spread fits a bound (PERF.md, Open questions)
POL3K = dict(name="pol3k.md", config="water-pol-3k", traffic="langevin",
             chips=1, why="3,000-atom polarizable MD")


def make_tiny_bench(dst):
    """A benchmark folder at ``dst``: the real metrics, limits and traffic
    mixes, and every configuration cut to 4^3 waters with a small mesh."""
    dst = pathlib.Path(dst)
    for sub in ("metrics", "limits", "traffic"):
        shutil.copytree(BENCH / sub, dst / sub)
    (dst / "configs").mkdir()
    for f in (BENCH / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["lattice"]["n_side"] = 4
        c["model"]["mesh"] = TINY_MESH.get(c["name"], [32, 32, 32])
        (dst / "configs" / f.name).write_text(json.dumps(c))
    for f in (dst / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(warmup_steps=2, segment_steps=3, check_within_steps=4,
                 check_window_steps=2, trace_start_step=1, trace_steps=2)
        f.write_text(json.dumps(t))
    return dst


def run_tiny(bench, workload, seed=3, seconds=0.5, trace=0, spec=None):
    from benchmark.harness import core

    spec = spec or core.load_spec(ROOT)
    cell = (POL3K if workload == POL3K["name"]
            else core.find_cell(spec, workload))
    return core.run_cell(spec, cell, seed, seconds, trace,
                         torch.device("cpu"), bench=bench)
