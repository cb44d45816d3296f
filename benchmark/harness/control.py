"""The readings that the limits of the output check are set from, on the card
at the cell's own size, several seeds in one process:

    python3 -m benchmark.harness.control --workload fixed98k.md \\
        --seeds 101 102 103 --seconds 3 [--control]

For each seed a short window of the cell's own loop, then the check's
numbers of the program (the lower readings) and, with ``--control``, of the
control: the reference in float32 with TF32 matmuls put in the program's
place on the same states and noise (the upper readings). One JSON line per
seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark.harness import core


def readings(workload, seeds, seconds, device, control, bench=core.BENCH,
             root=None):
    """[(seed, program checks, control checks or None, correct)]."""
    cell = core.find_cell(core.load_spec(root or bench.parent), workload)
    config, traffic, limits, loop = core.load_cell(cell, bench)
    out = []
    for seed in seeds:
        r = loop.run(config=config, traffic=traffic, limits=limits,
                     seed=seed, seconds=seconds, trace=False, device=device,
                     control=control)
        out.append((seed, r["checks"], r["control_checks"], r["correct"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed, prog, ctl, ok in readings(args.workload, args.seeds,
                                        args.seconds, torch.device("cuda", 0),
                                        args.control):
        print(json.dumps(dict(seed=seed, correct=ok, program=prog,
                              control=ctl)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
