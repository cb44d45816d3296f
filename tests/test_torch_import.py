"""admp_tpu_torch imports without JAX, Triton, nvcc or a GPU, and builds
nothing when it is imported: the sharded layer (parallel/, utils/comm.py)
and the entry points (entry.py) too."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHECK = """
import sys
import admp_tpu_torch
import admp_tpu_torch.convert, admp_tpu_torch.models.pme
import admp_tpu_torch.models.dispersion, admp_tpu_torch.ops.shortrange
import admp_tpu_torch.ops.neighborlist, admp_tpu_torch.ops.dispersion
import admp_tpu_torch.fitting, admp_tpu_torch.checkpoint
import admp_tpu_torch.ops.cuda.pairs, admp_tpu_torch.ops.cuda.spread
import admp_tpu_torch.ops.exclusions, admp_tpu_torch.ops.reciprocal
import admp_tpu_torch.systems
import admp_tpu_torch.md, admp_tpu_torch.api, admp_tpu_torch.ops.bonded
import admp_tpu_torch.io, admp_tpu_torch.io.pdb, admp_tpu_torch.io.ffxml
import admp_tpu_torch.io.topology, admp_tpu_torch.utils.safety
import admp_tpu_torch.utils.profiling, admp_tpu_torch.contrib
import admp_tpu_torch.parallel, admp_tpu_torch.parallel.launch
import admp_tpu_torch.parallel.spread, admp_tpu_torch.utils.comm
import admp_tpu_torch.entry
from admp_tpu_torch import make_sharded_pol_energy, sharded_cell_pairs
from admp_tpu_torch.ops.cuda import build
try:
    import admp_tpu_torch.contrib.openmm
except ImportError as exc:
    # without openmm the adapter refuses and names the native front end
    assert 'admp_tpu_torch.api.Hamiltonian' in str(exc), exc
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
