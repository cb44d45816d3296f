"""Run one cell of the benchmark of admp_tpu_torch once, on the card:

    python3 benchmark/run.py --workload fixed98k.md --seed 7 --seconds 30 --trace 0

Prints the cell's metrics as one JSON line (the end-to-end metrics with
--trace 0, the per-layer ones with --trace 1), after the numbers the output
check compared, each beside its limit, on standard error. Exits with a
nonzero code and prints no result without a CUDA device.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout: only the first run
    # of a cell in a checkout builds (the program's nvcc libraries go to
    # admp_tpu_torch/_build/, keyed by their sources)
    cache = ROOT / "benchmark" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core

    return core.main(args, T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
