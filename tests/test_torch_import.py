"""admp_tpu_torch imports without JAX, Triton, nvcc or a GPU, and builds
nothing when it is imported: the sharded layer (parallel/, utils/comm.py),
the entry points (entry.py), the user's scripts (examples/) and the
subpackages' exports too. Every public function and class of admp_tpu
(outside ops/pallas/) has a port of the same name, but for the seven that
do not carry over, and every subpackage exports what admp_tpu's does. The
port's tests run on one intra-op thread."""

import ast
import os
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
import admp_tpu_torch.examples, admp_tpu_torch.examples.run_water
import admp_tpu_torch.examples.run_npt, admp_tpu_torch.examples.fit_params
import admp_tpu_torch.examples.fluctuating_multipoles
from admp_tpu_torch import make_sharded_pol_energy, sharded_cell_pairs
from admp_tpu_torch.models import (ADMPDispPmeForce, ADMPPmeForce,
                                   energy_disp_pme, energy_pme,
                                   pme_real_energy)
from admp_tpu_torch.scf import make_induced_dipole_solver
from admp_tpu_torch.systems import write_water_pdb
from admp_tpu_torch.ops import reciprocal, shortrange
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


def test_port_tests_run_on_one_thread():
    """The port's test support holds each worker, and each process a test
    starts, to one intra-op thread."""
    import torch
    import torch_port_cases  # noqa: F401

    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert os.environ["MKL_NUM_THREADS"] == "1"
    out = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"


# public admp_tpu functions with no port of the same name (ROADMAP, "Not to
# port"): JAX-only machinery, or covered under other names
NOT_PORTED = {
    "spline_values4",    # bsplines.spline_values(u0, 4)
    "spread_weights",    # computed through reciprocal.atom_spread_alpha
    "take_rows_sorted",  # the pair-gather backward is index_add_
    "default_dtype",     # JAX's x64 switch
    "maybe_jit",         # jax.jit
    "exp_accurate",      # torch.exp is accurate on the card
    "collective_bytes",  # the jaxpr walker; CommTally counts at the wrappers
    "energy_breakdown",  # a metrics-line helper that nothing read
}


def _public_defs(package):
    """{name: module} of the public top-level functions and classes of a
    package, outside ops/pallas/."""
    root = ROOT / package
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith("ops/pallas/"):
            continue
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                out.setdefault(node.name, rel)
    return out


def _exports(init):
    """A package __init__'s __all__, read from its AST."""
    for node in ast.parse(init.read_text()).body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            return {ast.literal_eval(e) for e in node.value.elts}
    return set()


def test_public_name_parity():
    ported = _public_defs("admp_tpu_torch")
    missing = {k: v for k, v in _public_defs("admp_tpu").items()
               if k not in ported and k not in NOT_PORTED}
    assert not missing, missing
    assert NOT_PORTED.isdisjoint(ported)


def test_subpackage_exports():
    for init in sorted((ROOT / "admp_tpu").rglob("__init__.py")):
        rel = init.relative_to(ROOT / "admp_tpu")
        if rel.as_posix().startswith("ops/pallas/"):
            continue
        want = _exports(init)
        got = _exports(ROOT / "admp_tpu_torch" / rel)
        assert want <= got, (rel.as_posix(), sorted(want - got))
