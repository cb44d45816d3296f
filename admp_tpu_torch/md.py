"""Molecular dynamics on the card: velocity-Verlet NVE, BAOAB Langevin NVT and
an isotropic Monte-Carlo barostat (admp_tpu/md.py), in the same units.

Units: kJ/mol, Angstrom, ps; masses in g/mol, velocities in A/ps, so
a [A/ps^2] = F [kJ/mol/A] / m [g/mol] * 100.

admp_tpu runs a segment inside one ``lax.scan``. Here a segment is a Python
loop over steps whose per-step kinetic energies stay on the device and are
stacked at the end: a segment adds no host sync of its own (the force field
may sync, e.g. the host-checked SCF loop). Randomness comes from an
explicit ``torch.Generator`` on the positions' device, passed where admp_tpu
passes a PRNG key.

Neighbor-list discipline, as in admp_tpu: the force field sees a fixed pair
list inside a segment; build it with a skin (list cutoff = rc + ~1 A) and
refresh it between segments (``refresh_neighbor_list``).
"""

from __future__ import annotations

import json
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from admp_tpu_torch.utils import profiling
from admp_tpu_torch.utils.linalg3 import det3x3

# a [A/ps^2] = F [kJ/mol/A] / m [g/mol] * _ACC
_ACC = 100.0
# Boltzmann's constant in kJ/mol/K
K_B = 0.00831446261815324
# pressure conversion into the engine's kJ/mol/A^3
BAR_TO_KJMOL_A3 = 6.02214076e-5


class MDState(NamedTuple):
    positions: torch.Tensor
    velocities: torch.Tensor
    forces: torch.Tensor
    aux: Any = None


def _kinetic(masses, v):
    return 0.5 * torch.sum(masses[:, None] * v * v) / _ACC


def make_nve_step(force_fn, masses, dt: float):
    """Velocity-Verlet step(state) -> state. ``force_fn(positions, aux) ->
    (energy, forces, aux')``."""
    m = masses[:, None]

    @profiling.traced("md.step", composite=True)
    def step(state: MDState):
        with profiling.span("md.integrate"):
            v_half = state.velocities + 0.5 * dt * _ACC * state.forces / m
            x_new = state.positions + dt * v_half
        _, f_new, aux = force_fn(x_new, state.aux)
        with profiling.span("md.integrate"):
            v_new = v_half + 0.5 * dt * _ACC * f_new / m
        return MDState(x_new, v_new, f_new, aux)

    return step


def make_langevin_step(force_fn, masses, dt: float, temperature: float,
                       friction: float):
    """BAOAB Langevin step(state, generator) -> state (NVT); temperature in
    K, friction in 1/ps. The noise is drawn from ``generator``, a
    torch.Generator on the positions' device."""
    m = masses[:, None]
    c1 = math.exp(-friction * dt)
    sigma = torch.sqrt(K_B * temperature * (1.0 - c1 ** 2) / m * _ACC)

    @profiling.traced("md.step", composite=True)
    def step(state: MDState, generator):
        with profiling.span("md.integrate"):
            v = state.velocities + 0.5 * dt * _ACC * state.forces / m
            x = state.positions + 0.5 * dt * v
            noise = torch.randn(v.shape, generator=generator, dtype=v.dtype,
                                device=v.device)
            v = c1 * v + sigma * noise
            x = x + 0.5 * dt * v
        _, f_new, aux = force_fn(x, state.aux)
        with profiling.span("md.integrate"):
            v = v + 0.5 * dt * _ACC * f_new / m
        return MDState(x, v, f_new, aux)

    return step


def run_langevin(force_fn, masses, dt, temperature, friction, state: MDState,
                 n_steps: int, generator):
    """An NVT Langevin segment of ``n_steps``; returns the final state and
    the (n_steps,) kinetic energies."""
    step = make_langevin_step(force_fn, masses, dt, temperature, friction)
    kes = []
    for _ in range(n_steps):
        state = step(state, generator)
        kes.append(_kinetic(masses, state.velocities))
    return state, torch.stack(kes)


def run_nve(force_fn, masses, dt, state: MDState, n_steps: int,
            report_every=0):
    """An NVE segment of ``n_steps``; returns the final state and the
    (n_steps,) kinetic energies. ``report_every`` is accepted for
    admp_tpu's signature and unused, as there."""
    del report_every
    step = make_nve_step(force_fn, masses, dt)
    kes = []
    for _ in range(n_steps):
        state = step(state)
        kes.append(_kinetic(masses, state.velocities))
    return state, torch.stack(kes)


def run_nve_metrics(force_fn, masses, dt, state: MDState, n_steps: int,
                    metrics_fn=None):
    """An NVE segment with per-step metrics: ``metrics_fn(state) ->
    dict[str, scalar]`` after each step (e.g. a force object's
    ``get_metrics``), plus ``e_kinetic``. Returns (final state, dict of
    (n_steps,) tensors) for :func:`format_metrics_lines`."""
    step = make_nve_step(force_fn, masses, dt)
    recs = []
    for _ in range(n_steps):
        state = step(state)
        rec = {"e_kinetic": _kinetic(masses, state.velocities)}
        if metrics_fn is not None:
            rec.update(metrics_fn(state))
        recs.append(rec)
    metrics = {k: torch.stack([torch.as_tensor(r[k]) for r in recs])
               for k in recs[0]} if recs else {}
    return state, metrics


def make_mc_barostat(energy_fn, molecules, pressure, temperature,
                     max_dlnv: float = 0.02):
    """Isotropic Monte-Carlo barostat (NPT when alternated with an NVT
    integrator): propose ln V' = ln V + u, u uniform in
    [-max_dlnv, max_dlnv), scale the molecular centres of mass affinely
    (internal geometry rigid), accept with probability
    min(1, exp(-beta [dU + P dV] + (n_mol + 1) ln(V'/V))).

    ``energy_fn(positions, box, *energy_args) -> scalar`` must take a new box
    on every call (build engines with ``cache_influence=False``);
    ``molecules`` is the (N,) molecule id per atom, 0..M-1. Returns
    step(positions, box, generator, *energy_args) -> (positions', box',
    accepted, energy'), all tensors: nothing is read back to the host."""
    mol = torch.as_tensor(np.asarray(molecules), dtype=torch.long)
    n_mol = int(mol.max()) + 1
    beta = 1.0 / (K_B * temperature)
    mol_on = {}  # the molecule ids on each device the step has seen

    def com_scale(positions, factor, mol_d):
        ones = torch.ones(positions.shape[0], dtype=positions.dtype,
                          device=positions.device)
        counts = positions.new_zeros(n_mol).index_add_(0, mol_d, ones)
        com = positions.new_zeros(n_mol, 3).index_add_(0, mol_d, positions)
        com = com / counts[:, None]
        return positions + (factor - 1.0) * com[mol_d]

    def step(positions, box, generator, *energy_args):
        mol_d = mol_on.get(positions.device)
        if mol_d is None:
            mol_d = mol_on[positions.device] = mol.to(positions.device)
        u1, u2 = torch.rand(2, generator=generator, dtype=positions.dtype,
                            device=positions.device)
        v_old = torch.abs(det3x3(box))
        dlnv = max_dlnv * (2.0 * u1 - 1.0)
        v_new = v_old * torch.exp(dlnv)
        factor = (v_new / v_old) ** (1.0 / 3.0)
        pos_new = com_scale(positions, factor, mol_d)
        box_new = box * factor
        with torch.no_grad():
            e_old = energy_fn(positions, box, *energy_args)
            e_new = energy_fn(pos_new, box_new, *energy_args)
        arg = (-beta * (e_new - e_old + pressure * (v_new - v_old))
               + (n_mol + 1) * dlnv)
        accept = torch.log(u2) < arg
        return (torch.where(accept, pos_new, positions),
                torch.where(accept, box_new, box), accept,
                torch.where(accept, e_new, e_old))

    return step


def format_metrics_lines(metrics, every: int = 1):
    """Per-step metrics (a dict of (n_steps,) arrays or tensors) as one JSON
    record per line."""
    arrays = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
              for k, v in metrics.items()}
    keys = sorted(arrays)
    n = len(arrays[keys[0]])
    lines = []
    for i in range(0, n, every):
        rec = {"step": i}
        for k in keys:
            v = arrays[k][i]
            rec[k] = bool(v) if v.dtype == np.bool_ else float(v)
        lines.append(json.dumps(rec))
    return lines
