"""The port's user scripts (admp_tpu_torch.examples) against admp_tpu's own
scripts under examples/, at float64 on the CPU.

admp_tpu's scripts run unmodified, each in a subprocess
(JAX_PLATFORMS=cpu, JAX_ENABLE_X64=1), all started together when the module
starts; their printed numbers are parsed and held against the dict the
port's ``run`` returns, to the printed digits (half a unit of the last
printed digit, plus 1e-9 relative):

- run_water --nmol 27 (81 atoms) plain, --polarizable (the SCF iteration
  count within 1) and --pdb/--xml (the MPID water XML and PDB that
  admp_tpu_torch.systems.write_water_inputs writes): the PME, dispersion and
  Tang-Toennies energies;
- fluctuating_multipoles --n-side 4 (192 atoms): E and |F| rms, and its
  sharded branch on 2 gloo ranks (parallel/launch) against the script with
  --sharded on 2 virtual CPU devices (grid and pairs padded to 2 in both);
- run_npt --nmol 27: the script's energy closure and first forces against
  the same closure built from admp_tpu's public API (1e-10 relative energy,
  1e-9 relative RMSE forces); one run of --steps 5 --segments 2 ends
  finite; one volume move by the barostat's largest compression changes
  the pair count, and the refreshed list holds the pairs of a fresh cell
  list, with the same energy (1e-10 relative).

Also write_water_pdb byte for byte against admp_tpu's.
"""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from admp_tpu_torch.examples import fluctuating_multipoles as t_fluct
from admp_tpu_torch.examples import run_npt as t_npt
from admp_tpu_torch.examples import run_water as t_water
from admp_tpu_torch.parallel.launch import launch
from admp_tpu_torch.systems import write_water_inputs
from torch_port_cases import rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMOL, N_SIDE = 27, 4
FLOAT = r"(-?\d+\.\d+)"


def _script(args, devices=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    if devices:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{devices}")
    return subprocess.Popen([sys.executable] + args, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def inputs_dir(tmp_path_factory):
    """The MPID water XML and a PDB of water_system(n_side=3) (the
    synthetic box run_water makes at --nmol 27)."""
    from admp_tpu_torch.systems import water_system

    s = water_system(n_side=3, spacing=3.104, jitter=0.12, seed=0)
    return write_water_inputs(tmp_path_factory.mktemp("ff"), s["positions"],
                              s["box"])


@pytest.fixture(scope="module")
def npt_ref(tmp_path_factory):
    return str(tmp_path_factory.mktemp("npt") / "ref.npz")


@pytest.fixture(scope="module")
def jax_scripts(inputs_dir, npt_ref):
    """admp_tpu's scripts (and run_npt's closure), started together; name ->
    Popen."""
    xml, pdb = inputs_dir
    water = ["examples/run_water.py", "--nmol", str(NMOL), "--cpu", "--f64"]
    fluct = ["examples/fluctuating_multipoles.py", "--n-side", str(N_SIDE),
             "--cpu"]
    procs = {"water": _script(water),
             "water_pol": _script(water + ["--polarizable"]),
             "water_pdb": _script(water + ["--pdb", pdb, "--xml", xml]),
             "fluct": _script(fluct),
             "fluct_sharded": _script(fluct + ["--sharded"], devices=2),
             "npt_closure": _script(["-c", NPT_CLOSURE, str(NMOL), npt_ref])}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _output(procs, name):
    out, err = procs[name].communicate(timeout=900)
    assert procs[name].returncode == 0, err[-3000:]
    return out


def _printed(text, pattern):
    """The number the pattern's group matches, and its printed digits."""
    m = re.search(pattern, text)
    assert m, (pattern, text)
    s = m.group(1)
    return float(s), len(s.split(".")[1]) if "." in s else 0


def _same(got, printed):
    value, digits = printed
    assert abs(got - value) <= 0.5 * 10.0 ** -digits + 1e-9 * abs(value), (
        got, value)


@pytest.mark.parametrize("case", ["water", "water_pol", "water_pdb"])
def test_run_water(jax_scripts, inputs_dir, case):
    xml, pdb = inputs_dir
    kw = dict(nmol=NMOL, cpu=True, f64=True, time_iters=0,
              polarizable=case == "water_pol", log=lambda *a: None)
    if case == "water_pdb":
        kw.update(pdb=pdb, xml=xml)
    got = t_water.run(**kw)
    text = _output(jax_scripts, case)
    assert not got["overflow"] and got["n_atoms"] == 3 * NMOL
    for key, label in (("e_pme", "electrostatic PME:"),
                       ("e_disp", "dispersion PME:"),
                       ("e_tt", "Tang-Toennies:")):
        _same(got[key], _printed(text, label + r"\s+" + FLOAT))
    for key in ("f_pme", "f_disp", "f_tt"):
        assert bool(torch.isfinite(got[key]).all())
    if case == "water_pol":
        m = re.search(r"SCF converged=(\w+) iters=(\d+)", text)
        assert got["converged"] and m.group(1) == "True"
        assert abs(got["n_iter"] - int(m.group(2))) <= 1


def test_run_water_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_water.run(nmol=8)


def test_fluctuating_multipoles(jax_scripts):
    got = t_fluct.run(N_SIDE, cpu=True, dtype=torch.float64, time_steps=0,
                      log=lambda *a: None)
    text = _output(jax_scripts, "fluct")
    assert got["route"] == "torch" and got["grid"] == (40, 40, 40)
    _same(got["e"], _printed(text, r"E = " + FLOAT))
    _same(got["f_rms"], _printed(text, r"\|F\| rms = " + FLOAT))


def test_fluctuating_multipoles_sharded_two_ranks(jax_scripts):
    ranks = launch(t_fluct.sharded_rank, 2,
                   args=(N_SIDE, 4.0, True, "torch", torch.float64, 0))
    text = _output(jax_scripts, "fluct_sharded")
    e, f_rms = _printed(text, r"E = " + FLOAT), _printed(
        text, r"\|F\| rms = " + FLOAT)
    for r in ranks:
        _same(r["e"], e)
        _same(r["f_rms"], f_rms)
    # every rank holds the whole (replicated) gradient
    np.testing.assert_array_equal(ranks[0]["f"], ranks[1]["f"])


# examples/run_npt.py:57-101's energy closure from admp_tpu's public API,
# its first energy and gradient written to the file argv[2]
NPT_CLOSURE = """
import sys
import jax.numpy as jnp
import numpy as np
import jax
from admp_tpu import (ADMPPmeForce, convert_cart2harm,
                      generate_pairwise_interaction, neighbor_list_cell,
                      tt_damping_qq_c6_kernel)
from admp_tpu.ops.bonded import (harmonic_angle_energy, harmonic_bond_energy,
                                 water_bonded_terms)
from admp_tpu.settings import EngineConfig
from admp_tpu.systems import water_system

nmol = int(sys.argv[1])
s = water_system(n_side=round(nmol ** (1 / 3)), spacing=3.104, jitter=0.05,
                 seed=0)
positions, box = jnp.asarray(s["positions"]), jnp.asarray(s["box"])
pairs = jnp.asarray(neighbor_list_cell(positions, box, 5.0).pairs)
q_local = convert_cart2harm(jnp.asarray(s["q_cart"]), 2)
m_scales = jnp.array([0.0, 0.0, 0.0, 1.0, 1.0])
c_list = jnp.asarray(s["c_list"])
tt_a, tt_b, tt_q = (jnp.asarray(s[k]) for k in ("tt_a", "tt_b", "tt_q"))
b_idx, r0, k_b, a_idx, th0, k_a = (
    jnp.asarray(x) for x in water_bonded_terms(positions.shape[0] // 3))
pme = ADMPPmeForce(box, s["axis_types"], s["axis_indices"],
                   s["covalent_map"], 4.0, 1e-4, lmax=2,
                   config=EngineConfig(cache_influence=False))
tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel, s["covalent_map"])

def energy(pos, bx, prs):
    e = pme.get_energy(pos, bx, prs, q_local, m_scales)
    e = e + tt(pos, bx, prs, m_scales, tt_a, tt_b, tt_q, c_list[:, 0])
    e = e + harmonic_bond_energy(pos, bx, b_idx, r0, k_b)
    return e + harmonic_angle_energy(pos, bx, a_idx, th0, k_a)

e, g = jax.value_and_grad(energy)(positions, box, pairs)
np.savez(sys.argv[2], e=np.asarray(e), g=np.asarray(g))
"""


def test_run_npt_closure_matches_admp_tpu(jax_scripts, npt_ref):
    _output(jax_scripts, "npt_closure")
    ref = np.load(npt_ref)
    m = t_npt.build(NMOL, "cpu", torch.float64, "auto")
    e_t, f_t, _ = t_npt.force_fn(m["energy"], m["box"], m["nl"].pairs)(
        m["positions"], None)
    assert abs(float(e_t) - float(ref["e"])) <= 1e-10 * abs(float(ref["e"]))
    assert rel_err(-f_t.numpy(), ref["g"]) < 1e-9


def test_run_npt_runs_to_a_finite_end():
    out = t_npt.run(NMOL, steps=5, segments=2, cpu=True,
                    dtype=torch.float64, log=lambda *a: None)
    assert len(out["segments"]) == 2
    for seg in out["segments"]:
        assert all(math.isfinite(seg[k]) for k in ("e", "volume", "t_inst"))
        assert seg["volume"] > 0 and seg["t_inst"] > 0
    assert bool(torch.isfinite(out["state"].positions).all())


def _pair_set(nl, n):
    p = nl.pairs[nl.pairs[:, 0] < n].tolist()
    return {tuple(sorted(x)) for x in p}


def test_volume_move_changes_the_pair_count():
    m = t_npt.build(NMOL, "cpu", torch.float64, "torch")
    n, nl = m["n_atoms"], m["nl"]
    factor = math.exp(-0.02 / 3.0)  # the barostat's largest compression
    pos, box, refreshed, fresh = t_npt.volume_move(m, m["positions"],
                                                   m["box"], nl, factor)
    before, after = t_npt.n_pairs(nl, n), t_npt.n_pairs(refreshed, n)
    assert after != before
    assert not bool(refreshed.did_overflow)
    assert _pair_set(refreshed, n) == _pair_set(fresh, n)
    e_r = float(m["energy"](pos, box, refreshed.pairs))
    e_f = float(m["energy"](pos, box, fresh.pairs))
    assert abs(e_r - e_f) <= 1e-10 * abs(e_f)


def test_write_water_pdb_bytes(tmp_path):
    from admp_tpu.systems import water_lattice, write_water_pdb as j_write
    from admp_tpu_torch.systems import write_water_pdb

    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=2)
    j_write(tmp_path / "j.pdb", positions, box)
    write_water_pdb(tmp_path / "t.pdb", positions, box)
    write_water_pdb(tmp_path / "t2.pdb", torch.tensor(positions),
                    torch.tensor(box))
    want = (tmp_path / "j.pdb").read_bytes()
    assert (tmp_path / "t.pdb").read_bytes() == want
    assert (tmp_path / "t2.pdb").read_bytes() == want
