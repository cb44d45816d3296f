"""The reference against the program's plain path in float64 at 192 atoms:
energies, forces and converged dipoles of both configurations, and one BAOAB
step against the program's own Langevin step on the same noise."""

from __future__ import annotations

import json

import pytest
import torch

from tiny import make_tiny_bench


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_bench(tmp_path_factory.mktemp("ref") / "bench")


def _setup(tiny, name, seed=3):
    from benchmark.systems import water

    c = json.loads((tiny / "configs" / f"{name}.json").read_text())
    c["dtype"] = "float64"
    s = water.make_system(c, seed, 300.0)
    prog = water.WaterProgram(s, c, 5.0, "cpu")
    if prog.pme.lpol:
        from admp_tpu_torch import SCFConfig

        # the program's SCF converged far below the MD profile's tolerance
        prog.pme.scf_config = SCFConfig(field_tol=1e-9, exact_adjoint=False,
                                        max_iter=500)
        prog.pme.refresh_calculators()
    return c, s, prog


@pytest.mark.parametrize("name", ["water-pol-3k", "water-fixed-98k"])
def test_reference_matches_plain_path_f64(tiny, name):
    from benchmark.reference.water import WaterReference

    c, s, prog = _setup(tiny, name)
    e, f, _ = prog.force_fn(prog.positions, None)
    ref = WaterReference(s, c["model"], "cpu")
    e_r, f_r, u_r = ref.evaluate(torch.as_tensor(s["positions"]), 5.0)
    assert abs(float(e) - float(e_r)) < 1e-9 * abs(float(e_r)) + 1e-9
    assert float(torch.linalg.norm(f - f_r) / torch.linalg.norm(f_r)) < 1e-8
    if prog.pme.lpol:
        du = torch.linalg.norm(prog.pme.U_ind - u_r) / torch.linalg.norm(u_r)
        assert float(du) < 1e-8


def test_reference_pair_list_is_every_pair_within_cutoff(tiny):
    from benchmark.reference.water import WaterReference

    c, s, prog = _setup(tiny, "water-fixed-98k")
    ref = WaterReference(s, c["model"], "cpu")
    i, j = ref.pair_list(torch.as_tensor(s["positions"]), 5.0)
    got = set(zip(i.tolist(), j.tolist()))
    n = s["positions"].shape[0]
    want = {(a, b) for a, b in prog.nl.pairs.tolist() if a < n}
    assert got == want


def test_reference_step_matches_program_step(tiny):
    from admp_tpu_torch import MDState, make_langevin_step

    from benchmark.reference.water import WaterReference, langevin_step

    c, s, prog = _setup(tiny, "water-pol-3k")
    step = make_langevin_step(prog.force_fn, prog.masses, 2e-4, 300.0, 10.0)
    _, f0, _ = prog.force_fn(prog.positions, None)
    state = MDState(prog.positions, prog.velocities, f0, None)
    gen = torch.Generator().manual_seed(5)
    saved = gen.get_state()
    out = step(state, gen)
    gen.set_state(saved)
    noise = torch.randn(state.velocities.shape, generator=gen,
                        dtype=state.velocities.dtype)
    ref = WaterReference(s, c["model"], "cpu")
    x, v, f, u = langevin_step(ref, state.positions, state.velocities, f0,
                               noise, prog.masses, 2e-4, 300.0, 10.0, 5.0)
    assert float((out.positions - x).abs().max()) < 1e-12
    # the program's list was built at the step's start, the reference's at
    # its end: the pairs that crossed the 5 A cutoff between them (erfc of
    # ~3.6 there) move the forces by ~1e-6
    assert float(torch.linalg.norm(out.velocities - v)
                 / torch.linalg.norm(v)) < 1e-7
    assert float(torch.linalg.norm(out.forces - f)
                 / torch.linalg.norm(f)) < 1e-5
