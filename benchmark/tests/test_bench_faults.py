"""A run with the timed path broken underneath reads ``correct: false``: the
harness's look for a card skipped, the rest of a run driven on the CPU at
192 atoms against the cells' own limits, once for each fault an MD cell can
have (one card: no exchange between chips to leave out), and for a drift
that moves the positions 10% too far: the check reads positions only through
the forces and velocities at them."""

from __future__ import annotations

import math

import pytest
import torch

from tiny import run_tiny


def _unchanged_step(monkeypatch):
    import admp_tpu_torch

    monkeypatch.setattr(admp_tpu_torch, "make_langevin_step",
                        lambda *a, **k: (lambda state, gen: state))


def _half_the_pairs(monkeypatch):
    from benchmark.systems import water

    energy = water.WaterProgram.energy

    def half(self, positions):
        nl = self.nl
        pairs = nl.pairs.clone()
        pairs[pairs.shape[0] // 2:] = positions.shape[0]
        self.nl = type(nl)(pairs, nl.did_overflow, nl.capacity, nl.cutoff,
                           nl.i_sorted, nl.n_cells, nl.cell_capacity)
        try:
            return energy(self, positions)
        finally:
            self.nl = nl

    monkeypatch.setattr(water.WaterProgram, "energy", half)


def _one_force_altered(monkeypatch):
    from benchmark.systems import water

    force_fn = water.WaterProgram.force_fn

    def altered(self, positions, aux):
        e, f, aux = force_fn(self, positions, aux)
        f = f.clone()
        f[7] = -f[7]
        return e, f, aux

    monkeypatch.setattr(water.WaterProgram, "force_fn", altered)


def _drift_too_long(monkeypatch):
    import admp_tpu_torch
    from admp_tpu_torch.md import _ACC, K_B, MDState

    def make(force_fn, masses, dt, temperature, friction):
        m = masses[:, None]
        c1 = math.exp(-friction * dt)
        sigma = torch.sqrt(K_B * temperature * (1.0 - c1 ** 2) / m * _ACC)
        drift = 1.1 * 0.5 * dt  # md.py's 0.5 * dt, 10% long

        def step(state, gen):
            v = state.velocities + 0.5 * dt * _ACC * state.forces / m
            x = state.positions + drift * v
            v = c1 * v + sigma * torch.randn(v.shape, generator=gen,
                                             dtype=v.dtype, device=v.device)
            x = x + drift * v
            _, f_new, aux = force_fn(x, state.aux)
            return MDState(x, v + 0.5 * dt * _ACC * f_new / m, f_new, aux)

        return step

    monkeypatch.setattr(admp_tpu_torch, "make_langevin_step", make)


FAULTS = {"state_unchanged": _unchanged_step,
          "drift_ten_percent_long": _drift_too_long,
          "half_the_pairs_left_out": _half_the_pairs,
          "one_force_altered": _one_force_altered}


@pytest.mark.parametrize("workload", ["pol3k.md", "fixed98k.md"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_not_correct(tiny_bench, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    res = run_tiny(tiny_bench, workload, seconds=0.3)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", ["pol3k.md", "fixed98k.md"])
def test_sound_run_reads_correct(tiny_bench, workload):
    res = run_tiny(tiny_bench, workload, seconds=0.3)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert torch.isfinite(torch.tensor([c["value"] for c in
                                        res["checks"].values()])).all()
