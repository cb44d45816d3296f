"""The harness finds configurations, traffic mixes, metrics and kernel names
by the names BENCHMARK.json gives, so that a later change adds them as new
files and edits none."""

from __future__ import annotations

import json
import shutil

from tiny import POL3K, ROOT, run_tiny

from benchmark.harness import core


def test_every_cell_finds_its_files():
    spec = core.load_spec(ROOT)
    for cell in spec["workloads"] + [POL3K]:
        config = core.load_json(core.BENCH, "configs", cell["config"])
        traffic = core.load_json(core.BENCH, "traffic", cell["traffic"])
        limits = core.load_json(core.BENCH, "limits", cell["name"])
        assert config["name"] == cell["config"]
        assert (core.BENCH / "loops" / f"{traffic['loop']}.py").exists()
        assert (core.BENCH / "systems" / f"{config['system']}.py").exists()
        assert (core.BENCH / "reference"
                / f"{config['reference']}.py").exists()
        assert limits
        for group in ("end_to_end", "per_layer"):
            for m in core.cell_metrics(spec, cell, group):
                assert hasattr(core.load_reader(core.BENCH, m["name"]),
                               "read")
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()


def test_new_files_are_picked_up(tiny_bench):
    """A configuration, a traffic mix, a metric with its reader and a
    kernel-name file, each added as a new file, reach a run."""
    spec = core.load_spec(ROOT)
    (tiny_bench / "configs" / "water-pol-copy.json").write_text(
        (tiny_bench / "configs" / "water-pol-3k.json").read_text())
    t = json.loads((tiny_bench / "traffic" / "langevin.json").read_text())
    t["temperature_K"] = 280.0
    (tiny_bench / "traffic" / "langevin-cool.json").write_text(json.dumps(t))
    shutil.copy(tiny_bench / "limits" / "pol3k.md.json",
                tiny_bench / "limits" / "copy.cool.json")
    (tiny_bench / "metrics" / "extra.steps.md.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['steps'])\n")
    d = tiny_bench / "metrics" / "pairs.roofline_pct.md.d"
    (d / "later_kernel.txt").write_text("# a later kernel\nnew_pair_kernel\n")
    assert "new_pair_kernel" in core.kernel_names(tiny_bench,
                                                  "pairs.roofline_pct.md")
    assert "pair_bwd_kernel" in core.kernel_names(tiny_bench,
                                                  "pairs.roofline_pct.md")
    cell = dict(name="copy.cool", config="water-pol-copy",
                traffic="langevin-cool", chips=1, why="a test cell")
    spec["workloads"].append(cell)
    spec["end_to_end"].append(dict(name="extra.steps.md", unit="steps",
                                   better="higher", bound=0.01,
                                   source="host_clock",
                                   workloads=["copy.cool"]))
    import torch

    res = core.run_cell(spec, cell, 4, 0.3, 0, torch.device("cpu"),
                        bench=tiny_bench)
    assert res["metrics"]["extra.steps.md"]["value"] == res["attempted"]
    assert set(res["checks"]) == {"force_rmse", "force_max", "velocity_rmse",
                                  "dipole_rmse"}


def test_cell_metrics_follow_the_workloads_keys():
    spec = core.load_spec(ROOT)
    cell = core.find_cell(spec, "fixed98k.md")
    names = {m["name"] for m in core.cell_metrics(spec, cell, "per_layer")}
    assert "pairs.roofline_pct.md" in names
    spec["per_layer"].append(dict(name="other.md", workloads=["other"]))
    e2e = {m["name"] for m in core.cell_metrics(spec, cell, "end_to_end")}
    assert {"setup_s", "md_step_ms"} <= e2e
    assert "other.md" not in {m["name"] for m in core.cell_metrics(
        spec, cell, "per_layer")}


def test_a_traced_run_reports_its_per_layer_metrics(tiny_bench):
    spec = core.load_spec(ROOT)
    spec["per_layer"].append(dict(
        name="scf.pcg_iters.md", unit="iters/step", better="lower",
        source="program_counter", layer="scf/solver", moves="md_step_ms",
        workloads=["pol3k.md"]))
    res = run_tiny(tiny_bench, "pol3k.md", trace=1, spec=spec)
    # on the CPU no device kernel runs: the rooflines find nothing to read
    assert "pairs.roofline_pct.md" not in res["metrics"]
    assert res["metrics"]["scf.pcg_iters.md"]["value"] >= 0
    assert "busy_s" in res["device"] and "window_s" in res["device"]
