"""The port's fit_params (admp_tpu_torch.examples.fit_params) against
admp_tpu's examples/fit_params.py at float64 on the CPU, both with FF_XML
set to the MPID water XML that admp_tpu_torch.systems.write_water_inputs
writes.

admp_tpu's script runs unmodified in subprocesses (it sets JAX's platform
and x64 when imported): its main() in one and multi_config(n_epochs=2) in
another, started together, the scratch directory it names redirected into
pytest's temporary directory.
Its multi_config takes ~10 s per fitting step on the CPU here, so it is
held at 2 epochs (1, then 1 resumed from the checkpoint), where its own
loss assert cannot yet hold; the port's default 20-epoch run is held to
that assert on its own. The printed numbers agree to their printed digits
(half a unit of the last digit, plus 1e-9 relative): the dispersion
energy, dE/dmScales and dE/dC6[:3], the C6 relative error before and after
150 steps and the final loss; the multi-config losses and max|dq|, with
the steps equal.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from admp_tpu_torch.examples import fit_params as t_fit
from admp_tpu_torch.systems import write_water_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTI_EPOCHS = 2
FLOAT = r"(-?\d+\.\d+(?:e[-+]\d+)?)"

# admp_tpu's script, imported from examples/: FF_XML set, /tmp/admp_fit_example
# redirected to argv[2]
JAX_RUNNER = """
import pathlib, sys
sys.path.insert(0, "examples")
import fit_params as f
real = pathlib.Path
f.pathlib = type("P", (), {"Path": staticmethod(
    lambda p: real(str(p).replace("/tmp/admp_fit_example", sys.argv[2])))})
f.FF_XML = sys.argv[1]
if sys.argv[3] == "main":
    f.main()
else:
    try:
        f.multi_config(n_epochs=int(sys.argv[3]))
    except AssertionError:
        print("multi-config assert failed")
"""


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    from admp_tpu_torch.systems import water_system

    s = water_system(n_side=1)
    return write_water_inputs(tmp_path_factory.mktemp("ff"), s["positions"],
                              s["box"])[0]


@pytest.fixture(scope="module")
def jax_text(xml, tmp_path_factory):
    """admp_tpu's printed lines of main() and of multi_config, two
    processes started together before the port runs; part -> text()."""
    procs = {}
    for part, arg in (("main", "main"), ("multi", str(MULTI_EPOCHS))):
        scratch = tmp_path_factory.mktemp(part)
        procs[part] = subprocess.Popen(
            [sys.executable, "-c", JAX_RUNNER, xml, str(scratch), arg],
            cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def text(part):
        out, err = procs[part].communicate(timeout=900)
        assert procs[part].returncode == 0, err[-3000:]
        return out

    yield text
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture
def port_xml(xml, monkeypatch):
    monkeypatch.setattr(t_fit, "FF_XML", xml)


def _printed(text, pattern):
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return m.group(1)


def _same(got, printed):
    """got within half a unit of the printed number's last digit."""
    mant = printed.split("e")[0]
    digits = len(mant.split(".")[1]) if "." in mant else 0
    exp = int(printed.split("e")[1]) if "e" in printed else 0
    value = float(printed)
    unit = 10.0 ** (exp - digits)
    assert abs(got - value) <= 0.5 * unit + 1e-9 * abs(value), (got, value)


def _array(text, label):
    """A numpy array printed after ``label`` (possibly over two lines)."""
    m = re.search(re.escape(label) + r"\s*\[([^\]]*)\]", text)
    assert m, (label, text)
    return [float(x) for x in m.group(1).split()]


def test_main(jax_text, port_xml):
    got = t_fit.main(cpu=True, log=lambda *a: None)
    text = jax_text("main")
    _same(got["e_disp"], _printed(text, r"dispersion potential: " + FLOAT))
    for key, label in (("dE_dmScales", "dE/dmScales:"),
                       ("dE_dC6", "dE/dC6 (first 3):")):
        want = _array(text, label)
        assert len(want) == len(got[key])
        np.testing.assert_allclose(got[key], want, rtol=1e-7, atol=1e-300)
    _same(got["rel0"], _printed(text, r"C6 relative error: " + FLOAT))
    _same(got["rel1"], _printed(text, r"C6 relative error: \S+ -> " + FLOAT))
    assert got["steps"] == int(_printed(text, r"after (\d+) steps"))
    _same(got["final_loss"], _printed(text, r"final loss " + FLOAT))


def test_multi_config_first_steps(jax_text, port_xml):
    lines = []
    got = t_fit.multi_config(n_epochs=MULTI_EPOCHS, cpu=True,
                             log=lines.append, check=False)
    text = jax_text("multi")
    line = [x for x in lines if x.startswith("multi-config fit (B=")]
    assert len(line) == 1
    want = re.search(r"multi-config fit \(B=\d+, \d+ atoms\): loss (\S+) -> "
                     r"(\S+), max\|dq\| (\S+) -> (\S+), resumed at step "
                     r"(\d+)", text)
    have = re.search(r"loss (\S+) -> (\S+), max\|dq\| (\S+) -> (\S+), "
                     r"resumed at step (\d+)", line[0])
    assert want and have
    for a, b in zip(have.groups()[:4], want.groups()[:4]):
        _same(float(a.rstrip(",")), b.rstrip(","))
    assert have.group(5) == want.group(5)
    assert got["steps"] == MULTI_EPOCHS
    # the loss assert needs more epochs than these: admp_tpu's fails here,
    # and the port's, on the same numbers, would too
    assert "multi-config assert failed" in text
    assert not got["l1"] < 0.2 * got["l0"]


def test_multi_config_default_run_holds_its_assert(port_xml):
    got = t_fit.multi_config(cpu=True, log=lambda *a: None)
    assert got["steps"] == 20 and got["r1_steps"] == 10
    assert got["l1"] < 0.2 * got["l0"]
    assert got["dq1"] < got["dq0"]
    assert all(np.isfinite(got["losses"]))

