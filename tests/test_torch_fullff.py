"""The full force field of the port against admp_tpu at float64: bench.py's
build_nonpol_workload recipe (multipolar PME lmax 2, non-polarizable, kappa
pinned; dispersion PME pmax 10, disp_ethresh 2e-4, order-4 spread, the same
kappa; Tang-Toennies over (tt_a, tt_b, tt_q, c_list[:, 0]); i-sorted cell-list
pairs; cached influence) on water_system(n_side=4), with the grids cut to
(32, 32, 32) to fit the box.

* The energy and the forces of the sum at the first step and after one
  drift step (p + drift + 0 f): 1e-10 relative energy, 1e-9 relative RMSE.
* energy_force_loss over c_list (admp_tpu's goal 3, parameter derivatives):
  the loss and its c_list gradient (1e-9), and one fitting.fit step.
* The float32 floor of the full step on the CPU against float64, stated in
  the assertion bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import admp_tpu
from admp_tpu.fitting import energy_force_loss as j_loss
from admp_tpu.settings import EngineConfig as JEngine
from admp_tpu_torch import (
    ADMPDispPmeForce,
    ADMPPmeForce,
    EngineConfig,
    convert_cart2harm,
    energy_force_loss,
    fit,
    generate_pairwise_interaction,
    neighbor_list_cell,
    tt_damping_qq_c6_kernel,
)
from admp_tpu_torch.fitting import adam
from torch_port_cases import rel_err, t64, water

RC, ETHRESH, KAPPA, K = 4.0, 1e-4, 0.657065221219616, 32
SCALES = np.array([0.0, 0.0, 0.0, 1.0, 1.0])


def _jax_ff(s):
    """bench.py's total_energy (build_nonpol_workload), grids cut to K."""
    box = jnp.asarray(s["box"])
    pme = admp_tpu.ADMPPmeForce(
        box, s["axis_types"], s["axis_indices"], s["covalent_map"], RC,
        ETHRESH, lmax=2,
        config=JEngine(cache_influence=True, pairs_i_sorted=True))
    disp = admp_tpu.ADMPDispPmeForce(
        box, s["covalent_map"], RC, ETHRESH, pmax=10,
        config=JEngine(disp_ethresh=2e-4, disp_spread_order=4,
                       cache_influence=True, pairs_i_sorted=True))
    for f in (pme, disp):
        f.kappa = KAPPA
        f.K1 = f.K2 = f.K3 = K
        f.refresh_calculators()
    tt = admp_tpu.generate_pairwise_interaction(
        admp_tpu.tt_damping_qq_c6_kernel, s["covalent_map"],
        pairs_i_sorted=True)
    q_local = admp_tpu.convert_cart2harm(jnp.asarray(s["q_cart"]), 2)
    a, b, q = (jnp.asarray(s[k]) for k in ("tt_a", "tt_b", "tt_q"))
    sc = jnp.asarray(SCALES)

    def total(pos, pairs, c):
        e = pme.get_energy(pos, box, pairs, q_local, sc)
        e = e + disp.get_energy(pos, box, pairs, c, sc)
        return e + tt(pos, box, pairs, sc, a, b, q, c[:, 0])

    return total


def _torch_ff(s, dtype=torch.float64):
    """The same recipe in the port, on the CPU."""
    kw = dict(device="cpu", dtype=dtype)
    pme = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                       s["covalent_map"], RC, ETHRESH, lmax=2,
                       config=EngineConfig(cache_influence=True), **kw)
    disp = ADMPDispPmeForce(
        s["box"], s["covalent_map"], RC, ETHRESH, pmax=10,
        config=EngineConfig(disp_ethresh=2e-4, disp_spread_order=4,
                            cache_influence=True), **kw)
    for f in (pme, disp):
        f.kappa = KAPPA
        f.K1 = f.K2 = f.K3 = K
        f.refresh_calculators()
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                       s["covalent_map"], device="cpu")
    box = torch.tensor(s["box"], dtype=dtype)
    q_local = convert_cart2harm(torch.tensor(s["q_cart"], dtype=dtype), 2)
    a, b, q = (torch.tensor(s[k], dtype=dtype) for k in ("tt_a", "tt_b", "tt_q"))
    sc = torch.tensor(SCALES, dtype=dtype)

    def total(pos, pairs, c):
        e = pme.get_energy(pos, box, pairs, q_local, sc)
        e = e + disp.get_energy(pos, box, pairs, c, sc)
        return e + tt(pos, box, pairs, sc, a, b, q, c[:, 0])

    return total


def _torch_step(total, pos, pairs, c):
    pos = pos.detach().requires_grad_(True)
    e = total(pos, pairs, c)
    (g,) = torch.autograd.grad(e, pos)
    return e.detach(), g


def test_full_force_field_step_and_drift():
    s = water(n_side=4, seed=11)
    nl = neighbor_list_cell(t64(s["positions"]), t64(s["box"]), RC)
    assert nl.i_sorted and not bool(nl.did_overflow)
    pairs_np = nl.pairs.numpy()
    drift = 0.005 * np.random.default_rng(1).standard_normal(
        s["positions"].shape)
    j_step = jax.value_and_grad(_jax_ff(s))
    t_total = _torch_ff(s)
    pj, pt = jnp.asarray(s["positions"]), t64(s["positions"])
    c_j, c_t = jnp.asarray(s["c_list"]), t64(s["c_list"])
    for step in range(2):
        ej, fj = j_step(pj, jnp.asarray(pairs_np), c_j)
        et, ft = _torch_step(t_total, pt, nl.pairs, c_t)
        assert abs(float(et) - float(ej)) <= 1e-10 * abs(float(ej)), step
        assert rel_err(ft, fj) < 1e-9, step
        pj = pj + jnp.asarray(drift) + 0.0 * fj
        pt = pt + t64(drift) + 0.0 * ft


def test_force_matching_over_c_list():
    """energy_force_loss of the full force field over c_list: the loss and
    dloss/dc_list against admp_tpu, then one fit step that lowers it."""
    s = water(n_side=3, seed=2)
    nl = neighbor_list_cell(t64(s["positions"]), t64(s["box"]), RC)
    pairs = nl.pairs
    rng = np.random.default_rng(3)
    f_ref = rng.normal(0, 20, s["positions"].shape)
    e_ref = -50.0
    entry = (s["positions"], s["box"], pairs.numpy(), e_ref, f_ref)
    c0 = 1.03 * s["c_list"]

    j_total = _jax_ff(s)
    jl = j_loss(lambda pos, box, prs, p: j_total(pos, prs, p["c"]))
    lj, gj = jax.value_and_grad(jl)({"c": jnp.asarray(c0)},
                                    [tuple(jnp.asarray(x) for x in entry)])
    t_total = _torch_ff(s)
    tl = energy_force_loss(lambda pos, box, prs, p: t_total(pos, prs, p["c"]))
    batch = [tuple(t64(x) if k != 2 else torch.as_tensor(x)
                   for k, x in enumerate(entry))]
    c_t = t64(c0).requires_grad_(True)
    lt = tl({"c": c_t}, batch)
    (gt,) = torch.autograd.grad(lt, c_t)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-10 * abs(float(lj))
    assert rel_err(gt, gj["c"]) < 1e-9
    res = fit(tl, {"c": t64(c0)}, [batch, batch], optimizer=adam(1e-2),
              log_every=0)
    assert res.steps == 2
    assert res.history[1]["loss"] < res.history[0]["loss"]


def test_float32_floor_against_float64():
    """The f32 full step on the CPU against f64. Measured here: energy
    1.6e-5 relative (0.07 kJ/mol of 4468; the electrostatic real and self
    terms of ~5.6e4 cancel to -17, and the f32 reciprocal term is off by
    0.065), forces 1.3e-4 relative RMSE. Bounds: 1e-4 and 5e-4."""
    s = water(n_side=4, seed=11)
    out = {}
    for dtype in (torch.float32, torch.float64):
        pos = torch.tensor(s["positions"], dtype=dtype)
        nl = neighbor_list_cell(pos, torch.tensor(s["box"], dtype=dtype), RC)
        out[dtype] = _torch_step(_torch_ff(s, dtype), pos, nl.pairs,
                                 torch.tensor(s["c_list"], dtype=dtype))
    (e32, g32), (e64, g64) = out[torch.float32], out[torch.float64]
    assert abs(float(e32) - float(e64)) <= 1e-4 * abs(float(e64))
    assert rel_err(g32, g64) < 5e-4
