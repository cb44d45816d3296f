"""admp_tpu_torch imports without JAX, Triton, nvcc or a GPU, and builds
nothing when it is imported."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHECK = """
import sys
import admp_tpu_torch
import admp_tpu_torch.convert, admp_tpu_torch.models.pme
import admp_tpu_torch.fitting, admp_tpu_torch.checkpoint
import admp_tpu_torch.ops.cuda.pairs, admp_tpu_torch.ops.cuda.spread
from admp_tpu_torch.ops.cuda import build
assert 'jax' not in sys.modules, 'jax imported'
assert 'admp_tpu' not in sys.modules, 'admp_tpu imported'
assert 'triton' not in sys.modules, 'triton imported'
assert 'optax' not in sys.modules, 'optax imported'
assert 'orbax' not in sys.modules, 'orbax imported'
assert build._loaded == {}, 'a kernel library was loaded at import'
print('ok')
"""


def test_import_without_jax():
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
