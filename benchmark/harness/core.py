"""One run of one cell: find the cell, its configuration, traffic and
metrics by name, drive the cell's loop on the card, read the metrics, judge
the outputs and print the result line.

Everything that belongs to one configuration, traffic mix or metric lives in
a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the sizes; its ``system`` names
  ``systems/<system>.py`` (inputs and system under test) and its
  ``reference`` names ``reference/<reference>.py``;
- ``traffic/<traffic>.json``: the loop's parameters; its ``loop`` names
  ``loops/<loop>.py``;
- ``metrics/<metric>.py``: ``read(ctx)`` returns the metric or None when
  it finds nothing to read; a roofline metric's kernel names are the lines
  of the files in ``metrics/<metric>.d/``;
- ``limits/<cell>.json``: the limit of each number the check compares.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import pathlib
import re
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "admp_tpu")


def load_spec(root):
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def find_cell(spec, name):
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load_json(bench, kind, name):
    return json.loads((pathlib.Path(bench) / kind / f"{name}.json")
                      .read_text())


def load_cell(cell, bench=BENCH):
    """(configuration, traffic mix, limits, loop module) of ``cell``."""
    config = load_json(bench, "configs", cell["config"])
    traffic = load_json(bench, "traffic", cell["traffic"])
    limits = load_json(bench, "limits", cell["name"])
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    return config, traffic, limits, loop


def cell_metrics(spec, cell, group):
    """The ``group`` ('end_to_end' or 'per_layer') metrics whose
    ``workloads`` list this cell; an end-to-end metric without the list is
    every cell's."""
    default = [cell["name"]] if group == "end_to_end" else []
    return [m for m in spec[group]
            if cell["name"] in m.get("workloads", default)]


def load_reader(bench, metric):
    """metrics/<metric>.py as a module (the name may hold dots)."""
    path = pathlib.Path(bench) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_names(bench, metric):
    """The kernel function names in every file of metrics/<metric>.d/, one
    per line, '#' starting a comment."""
    names = set()
    d = pathlib.Path(bench) / "metrics" / f"{metric}.d"
    for f in sorted(d.glob("*")) if d.is_dir() else []:
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                names.add(line)
    return names


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec, cell, seed, seconds, trace, device, bench=BENCH,
             t_process=None):
    """Drive the cell once; returns the result dict (without printing)."""
    config, traffic, limits, loop = load_cell(cell, bench)
    out = loop.run(config=config, traffic=traffic, limits=limits, seed=seed,
                   seconds=seconds, trace=trace, device=device,
                   t_process=t_process)
    group = "per_layer" if trace else "end_to_end"
    ctx = dict(out["ctx"], bench=pathlib.Path(bench), config=config,
               traffic=traffic, cell=cell)
    metrics = {}
    for m in cell_metrics(spec, cell, group):
        ctx["metric"] = m["name"]
        value = load_reader(bench, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = dict(correct=out["correct"], attempted=out["attempted"],
                  failed=out["failed"], metrics=metrics, device=out["device"])
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result


def format_checks(checks):
    return [f"{k}: {v['value']:.6g} (limit {v['limit']:.6g})"
            for k, v in checks.items()]


def main(args, t_process):
    import torch

    spec = load_spec(BENCH.parent)
    cell = find_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_process=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"refused: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in format_checks(result["checks"]):
        print(line, file=sys.stderr)
    bad = [k for k, m in result["metrics"].items()
           if not math.isfinite(m["value"])]
    for k in bad:  # a metric that is not a number is no result
        del result["metrics"][k]
        result["correct"] = False
    print(json.dumps(result), flush=True)
    return 0
