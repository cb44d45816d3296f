"""The port's MD (admp_tpu_torch/md.py) and bonded terms
(admp_tpu_torch/ops/bonded.py) against admp_tpu's at float64 on the CPU:
bonded energies and gradients within 1e-10 (bonds that wrap the box too),
velocity-Verlet NVE and zero-temperature Langevin trajectories within 1e-9
on a cheap force (bonded + Tang-Toennies), the same metrics records; and
the port's own statistical checks of the thermostat and the MC barostat,
mirroring tests/test_md_fitting.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admp_tpu.md as jmd
from admp_tpu import generate_pairwise_interaction as j_pairwise
from admp_tpu import tt_damping_qq_c6_kernel as j_tt
from admp_tpu.ops import bonded as jb
from admp_tpu.systems import water_system
from admp_tpu_torch import md
from admp_tpu_torch import generate_pairwise_interaction as t_pairwise
from admp_tpu_torch import tt_damping_qq_c6_kernel as t_tt
from admp_tpu_torch.convert import md_state_from_jax
from admp_tpu_torch.ops import bonded as tb
from torch_port_cases import assert_close, dense_pairs

K_B = 0.00831446261815324
M_SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])


def _system(n_side=2, seed=21, spacing=3.1):
    s = water_system(n_side=n_side, spacing=spacing, jitter=0.1, seed=seed)
    n = s["positions"].shape[0]
    s["masses"] = np.tile([15.999, 1.008, 1.008], n // 3)
    s["bonded"] = jb.water_bonded_terms(n // 3)
    return s


def _wrap(positions, box):
    """Atoms wrapped into the cell one by one: molecules on the boundary
    are split, so their bonds cross it."""
    frac = positions @ np.linalg.inv(box)
    return (frac - np.floor(frac)) @ box


def _j_energy(s, pairs):
    b_idx, r0, kb, a_idx, th0, ka = (jnp.asarray(x) for x in s["bonded"])
    tt = j_pairwise(j_tt, s["covalent_map"])
    box = jnp.asarray(s["box"])
    args = [jnp.asarray(s[k]) for k in ("tt_a", "tt_b", "tt_q")]
    c6 = jnp.asarray(s["c_list"])[:, 0]

    def energy(p):
        e = tt(p, box, jnp.asarray(pairs), jnp.asarray(M_SCALES), *args, c6)
        e = e + jb.harmonic_bond_energy(p, box, b_idx, r0, kb)
        return e + jb.harmonic_angle_energy(p, box, a_idx, th0, ka)

    return energy


def _t_energy(s, pairs):
    b_idx, r0, kb, a_idx, th0, ka = (torch.as_tensor(x) for x in s["bonded"])
    tt = t_pairwise(t_tt, s["covalent_map"], device="cpu")
    box = torch.tensor(s["box"])
    args = [torch.tensor(s[k]) for k in ("tt_a", "tt_b", "tt_q")]
    c6 = torch.tensor(s["c_list"])[:, 0]
    pairs_t, sc = torch.tensor(pairs), torch.tensor(M_SCALES)

    def energy(p):
        e = tt(p, box, pairs_t, sc, *args, c6)
        e = e + tb.harmonic_bond_energy(p, box, b_idx, r0, kb)
        return e + tb.harmonic_angle_energy(p, box, a_idx, th0, ka)

    return energy


def _j_force_fn(energy):
    vg = jax.value_and_grad(energy)

    def force_fn(p, aux):
        e, g = vg(p)
        return e, -g, aux

    return force_fn


def _t_force_fn(energy):
    def force_fn(p, aux):
        x = p.detach().requires_grad_(True)
        with torch.enable_grad():
            e = energy(x)
            (g,) = torch.autograd.grad(e, x)
        return e.detach(), -g, aux

    return force_fn


def test_water_bonded_terms_match():
    for a, b in zip(jb.water_bonded_terms(5), tb.water_bonded_terms(5)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("wrapped", [False, True])
def test_bonded_energy_and_gradient(wrapped):
    s = _system(seed=3)
    rng = np.random.default_rng(0)
    pos = s["positions"] + rng.normal(0, 0.05, s["positions"].shape)
    if wrapped:  # molecule centres moved onto the cell faces, then wrapped
        pos = _wrap(pos + 1.55, s["box"])
    b_idx, r0, kb, a_idx, th0, ka = s["bonded"]
    cases = (
        (jb.harmonic_bond_energy, tb.harmonic_bond_energy, b_idx, r0, kb),
        (jb.harmonic_angle_energy, tb.harmonic_angle_energy, a_idx, th0, ka))
    for jf, tf, idx, x0, k in cases:
        e_j, g_j = jax.value_and_grad(jf)(
            jnp.asarray(pos), jnp.asarray(s["box"]), jnp.asarray(idx),
            jnp.asarray(x0), jnp.asarray(k))
        p = torch.tensor(pos, requires_grad=True)
        e_t = tf(p, torch.tensor(s["box"]), torch.as_tensor(idx),
                 torch.tensor(x0), torch.tensor(k))
        (g_t,) = torch.autograd.grad(e_t, p)
        assert abs(float(e_t.detach()) - float(e_j)) <= 1e-10 * abs(float(e_j))
        assert_close(g_t.numpy(), np.asarray(g_j), rel=1e-10)
    if wrapped:  # the wrap split at least one molecule across the box
        d = pos[b_idx[:, 0]] - pos[b_idx[:, 1]]
        assert np.max(np.linalg.norm(d, axis=1)) > 0.5 * s["box"][0, 0]


def _start(s, pairs, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(0, 0.2, s["positions"].shape)
    f0 = -np.asarray(jax.grad(_j_energy(s, pairs))(jnp.asarray(s["positions"])))
    return jmd.MDState(jnp.asarray(s["positions"]), jnp.asarray(v0),
                       jnp.asarray(f0), None)


def test_run_nve_matches():
    s = _system()
    pairs = dense_pairs(s["positions"], s["box"], 3.0)
    j_state = _start(s, pairs)
    masses = jnp.asarray(s["masses"])
    j_final, j_kes = jmd.run_nve(_j_force_fn(_j_energy(s, pairs)), masses,
                                 5e-4, j_state, 10)
    t_state = md_state_from_jax(j_state, device="cpu")
    t_final, t_kes = md.run_nve(_t_force_fn(_t_energy(s, pairs)),
                                torch.tensor(s["masses"]), 5e-4, t_state, 10)
    for a, b in zip(t_final[:3], j_final[:3]):
        assert_close(a.numpy(), np.asarray(b), rel=1e-9)
    assert_close(t_kes.numpy(), np.asarray(j_kes), rel=1e-9)
    assert float(torch.max(torch.abs(t_final.positions
                                     - t_state.positions))) > 1e-3


def test_langevin_step_at_zero_temperature_matches():
    s = _system(seed=4)
    pairs = dense_pairs(s["positions"], s["box"], 3.0)
    j_state = _start(s, pairs, seed=1)
    j_step = jmd.make_langevin_step(_j_force_fn(_j_energy(s, pairs)),
                                    jnp.asarray(s["masses"]), 5e-4, 0.0, 10.0)
    t_step = md.make_langevin_step(_t_force_fn(_t_energy(s, pairs)),
                                   torch.tensor(s["masses"]), 5e-4, 0.0, 10.0)
    t_state = md_state_from_jax(j_state, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for k in range(3):
        j_state = j_step(j_state, jax.random.PRNGKey(k))
        t_state = t_step(t_state, gen)
    for a, b in zip(t_state[:3], j_state[:3]):
        assert_close(a.numpy(), np.asarray(b), rel=1e-9)


def test_nve_metrics_records_match():
    s = _system(seed=6)
    pairs = dense_pairs(s["positions"], s["box"], 3.0)
    j_energy, t_energy = _j_energy(s, pairs), _t_energy(s, pairs)
    j_state = _start(s, pairs, seed=2)
    _, j_rec = jmd.run_nve_metrics(
        _j_force_fn(j_energy), jnp.asarray(s["masses"]), 5e-4, j_state, 4,
        lambda st: {"e_pot": j_energy(st.positions),
                    "hot": jnp.max(jnp.abs(st.velocities)) > 0.5})
    _, t_rec = md.run_nve_metrics(
        _t_force_fn(t_energy), torch.tensor(s["masses"]), 5e-4,
        md_state_from_jax(j_state, device="cpu"), 4,
        lambda st: {"e_pot": t_energy(st.positions).detach(),
                    "hot": torch.max(torch.abs(st.velocities)) > 0.5})
    j_lines = jmd.format_metrics_lines(j_rec, every=2)
    t_lines = md.format_metrics_lines(t_rec, every=2)
    assert len(t_lines) == len(j_lines) == 2
    for a, b in zip(t_lines, j_lines):
        ra, rb = json.loads(a), json.loads(b)
        assert ra.keys() == rb.keys() == {"step", "e_kinetic", "e_pot", "hot"}
        assert ra["step"] == rb["step"] and ra["hot"] is rb["hot"]
        for k in ("e_kinetic", "e_pot"):
            assert abs(ra[k] - rb[k]) <= 1e-9 * abs(rb[k])
    # the same metrics arrays give the same lines
    same = {k: np.asarray(v) for k, v in j_rec.items()}
    assert md.format_metrics_lines(same) == jmd.format_metrics_lines(same)


def test_langevin_thermostat_equilibrates():
    """As tests/test_md_fitting.py's: from rest, the kinetic temperature
    rises to the bath's (bonded + Tang-Toennies water here)."""
    s = _system(n_side=3, seed=23)
    pairs = dense_pairs(s["positions"], s["box"], 3.5)
    energy = _t_energy(s, pairs)
    force_fn = _t_force_fn(energy)
    n = s["positions"].shape[0]
    p0 = torch.tensor(s["positions"])
    state = md.MDState(p0, torch.zeros_like(p0), force_fn(p0, None)[1], None)
    final, kes = md.run_langevin(force_fn, torch.tensor(s["masses"]), 5e-4,
                                 300.0, 10.0, state, 400,
                                 torch.Generator().manual_seed(0))
    temps = kes.numpy() / (1.5 * n * K_B)
    assert temps[0] < 50.0
    assert 120.0 < temps[-100:].mean() < 600.0
    assert bool(torch.isfinite(final.positions).all())


def test_mc_barostat_ideal_gas_volume():
    """Zero potential energy: ln-V sampling equilibrates the volume to
    <V> = (n_mol + 2) kT / P."""
    n_mol, temperature, pressure = 32, 300.0, 0.02
    target = (n_mol + 2) * K_B * temperature / pressure
    rng = np.random.default_rng(0)
    positions = torch.tensor(rng.uniform(0, 10.0, (3 * n_mol, 3)))
    box = torch.eye(3, dtype=torch.float64) * 10.0
    step = md.make_mc_barostat(lambda p, b: p.new_zeros(()),
                               np.repeat(np.arange(n_mol), 3), pressure,
                               temperature, max_dlnv=0.08)
    gen = torch.Generator().manual_seed(1)
    vols, accepts = [], []
    for it in range(3000):
        positions, box, acc, _ = step(positions, box, gen)
        accepts.append(acc)
        if it >= 500:
            vols.append(torch.det(box))
    mean_v = float(torch.stack(vols).abs().mean())
    assert int(torch.stack(accepts).sum()) > 0.2 * 3000
    assert abs(mean_v - target) / target < 0.2, (mean_v, target)


def test_mc_barostat_preserves_internal_geometry():
    s = water_system(n_side=2, spacing=3.0, jitter=0.1, seed=3)
    n = s["positions"].shape[0]
    positions = torch.tensor(s["positions"])
    box = torch.tensor(s["box"])
    step = md.make_mc_barostat(lambda p, b: p.new_zeros(()),
                               np.repeat(np.arange(n // 3), 3), 0.01, 300.0,
                               max_dlnv=0.3)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        pos2, box2, acc, _ = step(positions, box, gen)
        if bool(acc):
            break
    assert bool(acc)
    d_before = (positions[1::3] - positions[0::3]).numpy()
    d_after = (pos2[1::3] - pos2[0::3]).numpy()
    np.testing.assert_allclose(d_after, d_before, atol=1e-10)
    assert not torch.allclose(box2, box)
    # a rejected move leaves positions and box as they were
    reject = md.make_mc_barostat(lambda p, b: -1e6 * torch.det(b),
                                 np.repeat(np.arange(n // 3), 3), 0.01,
                                 300.0, max_dlnv=0.3)
    for _ in range(5):
        p3, b3, acc3, _ = reject(positions, box, gen)
        if not bool(acc3):
            assert torch.equal(p3, positions) and torch.equal(b3, box)
