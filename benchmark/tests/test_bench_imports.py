"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "admp_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "numpy", "torch", "collections"}
    for path in (BENCH / "reference").glob("*.py"):
        assert set(_imports(path)) <= allowed, path


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import tiny, pathlib, tempfile\n"
        "from benchmark.harness import core\n"
        "d = tiny.make_tiny_bench(pathlib.Path(tempfile.mkdtemp()) / 'b')\n"
        "tiny.run_tiny(d, 'fixed98k.md', seconds=0.2)\n"
        "print(core.forbidden_modules())\n"
    ) % (str(ROOT), str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fixed98k.md",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
