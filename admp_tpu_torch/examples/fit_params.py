"""Force-field parameter gradients and fitting loops (admp_tpu's
examples/fit_params.py).

``main``: load an MPID force-field XML through the Hamiltonian front end,
evaluate its dispersion potential on a 24-atom water box, take its exact
gradients with respect to the parameter dict, then recover a C6 started 30%
off from energy and force targets (150 Adam steps on log C6).
``multi_config``: a batched fit of the PME multipoles over B perturbed
configurations (energy and force matching, stack_batch), checkpointed and
resumed halfway.

``FF_XML`` names the force field: the reference's
examples/openmm_api/forcefield.xml, looked for in data/ beside this file
(not in the repository yet); set it to any MPID water XML. Both run in
float64, as admp_tpu's script enables x64.

    python -m admp_tpu_torch.examples.fit_params
    python -m admp_tpu_torch.examples.fit_params --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import tempfile

import numpy as np
import torch

from admp_tpu_torch.examples import device_label, script_device, tensor

FF_XML = str(pathlib.Path(__file__).parent / "data" / "forcefield.xml")
M_SCALES = (0.0, 0.0, 0.0, 1.0, 1.0)


def _plain(ham):
    """Switch the Hamiltonian's force objects to the plain versions."""
    for gen in ham.getGenerators():
        f = getattr(gen, "pme_force", None) or gen.disp_pme_force
        f.config = dataclasses.replace(f.config, pair_kernel="torch",
                                       spread_method="torch")
        f.refresh_calculators()


def main(cpu=False, method="auto", dtype=torch.float64, log=print):
    """The parameter gradients and the C6 fit; returns the printed numbers.
    ``method='torch'`` runs the potentials on the plain versions."""
    from admp_tpu_torch.api import Hamiltonian
    from admp_tpu_torch.fitting import adam, energy_force_loss, fit
    from admp_tpu_torch.ops.neighborlist import neighbor_list_dense
    from admp_tpu_torch.systems import water_lattice, write_water_pdb

    device = script_device(cpu)
    label = device_label(device)
    log(f"device: {label}")
    positions, box = water_lattice(n_side=2, spacing=3.1, jitter=0.1, seed=2)
    ham = Hamiltonian(FF_XML, device=device, dtype=dtype)
    ham.getGenerators()[1].ref_dip = ""
    with tempfile.TemporaryDirectory() as tmp:
        pdb = pathlib.Path(tmp) / "small.pdb"
        write_water_pdb(pdb, positions, box)
        pots = ham.createPotential(str(pdb), nonbondedCutoff=4.0)
    if method == "torch":
        _plain(ham)
    disp_pot, disp_gen = pots[0], ham.getGenerators()[0]
    pos, box_t = tensor(positions, device, dtype), tensor(box, device, dtype)
    pairs = neighbor_list_dense(pos, box_t, 4.0).pairs

    # --- parameter gradients (the reference demo's) ------------------------
    true_params = {k: v.detach() for k, v in disp_gen.params.items()}
    leaves = {k: v.clone().requires_grad_(v.is_floating_point())
              for k, v in true_params.items()}
    with torch.enable_grad():
        energy = disp_pot(pos, box_t, pairs, leaves)
        wanted = [k for k, v in leaves.items() if v.requires_grad]
        grads = dict(zip(wanted, torch.autograd.grad(
            energy, [leaves[k] for k in wanted], allow_unused=True)))
    out = dict(device=label, e_disp=float(energy.detach()),
               dE_dmScales=grads["mScales"].cpu().numpy(),
               dE_dC6=grads["C6"].cpu().numpy()[:3])
    log(f"dispersion potential: {out['e_disp']:.6f} kJ/mol")
    log(f"dE/dmScales: {out['dE_dmScales']}")
    log(f"dE/dC6 (first 3): {out['dE_dC6']}")

    # --- fitting loop: recover a perturbed C6 ------------------------------
    x = pos.detach().requires_grad_(True)
    with torch.enable_grad():
        target_e = disp_pot(x, box_t, pairs, true_params)
        (target_negf,) = torch.autograd.grad(target_e, x)
    batch = [(pos, box_t, pairs, target_e.detach(), -target_negf)]

    # optimize log(C6): Adam's steps are scale-free, so raw updates on the
    # ~1e-3-magnitude C6 values would overshoot into negative values; a log
    # parameterization makes each step a bounded multiplicative change
    def pot_logc6(positions, box, pairs, fit_params):
        params = dict(true_params)
        params["C6"] = torch.exp(fit_params["logC6"])
        return disp_pot(positions, box, pairs, params)

    start = {"logC6": torch.log(true_params["C6"] * 1.3)}  # 30% off
    loss_fn = energy_force_loss(pot_logc6, energy_weight=1e-6,
                                force_weight=1e-4)
    result = fit(loss_fn, start, [batch], optimizer=adam(1e-2),
                 n_epochs=150, log_every=50, log_fn=log)
    c6 = true_params["C6"]
    rel0 = float(torch.max(torch.abs(torch.exp(start["logC6"]) / c6 - 1.0)))
    rel1 = float(torch.max(torch.abs(
        torch.exp(result.params["logC6"]) / c6 - 1.0)))
    out.update(rel0=rel0, rel1=rel1, steps=len(result.history),
               final_loss=result.history[-1]["loss"],
               losses=[h["loss"] for h in result.history],
               step_ms=[h["dt"] * 1e3 for h in result.history])
    log(f"C6 relative error: {rel0:.3f} -> {rel1:.4f} after "
        f"{len(result.history)} steps (final loss "
        f"{result.history[-1]['loss']:.3e})")
    if rel1 >= rel0 / 3:
        raise AssertionError("fitting failed to reduce parameter error")
    log("fit OK")
    return out


def multi_config(n_side=2, n_configs=3, n_epochs=20, cpu=False,
                 method="auto", dtype=torch.float64, log=print, check=True):
    """Multi-configuration batched fit with checkpoint/resume: B perturbed
    water configurations stacked into one loss (stack_batch), the PME
    multipoles recovered from energy and force targets, half the epochs,
    then a fresh ``fit`` that resumes from the checkpoint. n_side=10 is the
    3000-atom workload on the card; the default keeps the CPU run short.
    ``check=False`` returns without the loss assert (a run of a few
    epochs)."""
    from admp_tpu_torch import ADMPPmeForce, EngineConfig, convert_cart2harm
    from admp_tpu_torch.fitting import (
        adam,
        energy_force_loss,
        fit,
        stack_batch,
    )
    from admp_tpu_torch.ops.neighborlist import neighbor_list_dense
    from admp_tpu_torch.systems import water_system

    device = script_device(cpu)
    label = device_label(device)
    log(f"device: {label}")
    c = lambda x: tensor(x, device, dtype)  # noqa: E731
    s = water_system(n_side=n_side, spacing=3.104, jitter=0.1, seed=5)
    pos, box = c(s["positions"]), c(s["box"])
    # rc stays under half the (small) box; ethresh 1e-3 keeps grids small
    rc = min(3.0, 0.45 * float(s["box"][0][0]))
    pairs = neighbor_list_dense(pos, box, rc).pairs
    m_scales = c(M_SCALES)
    q_true = convert_cart2harm(c(s["q_cart"]), 2)
    force = ADMPPmeForce(
        s["box"], s["axis_types"], s["axis_indices"], s["covalent_map"], rc,
        1e-3, lmax=2,
        config=EngineConfig(pair_kernel=method, spread_method=method),
        device=device, dtype=dtype)

    def potential(positions, box, pairs_, params):
        return force.get_energy(positions, box, pairs_, params["q"], m_scales)

    # B slightly perturbed configurations with target energies and forces
    rng = np.random.default_rng(0)
    entries = []
    for _ in range(n_configs):
        p_b = pos + c(rng.normal(0, 0.02, tuple(pos.shape)))
        x = p_b.detach().requires_grad_(True)
        with torch.enable_grad():
            e_b = force.get_energy(x, box, pairs, q_true, m_scales)
            (g_b,) = torch.autograd.grad(e_b, x)
        entries.append((p_b, box, pairs, e_b.detach(), -g_b))
    batch = stack_batch(entries)

    loss_fn = energy_force_loss(potential, energy_weight=1e-4,
                                force_weight=1.0)
    start = {"q": q_true * 1.05}
    with tempfile.TemporaryDirectory() as ckpt:
        # half the epochs, checkpointing; then a fresh call resumes
        r1 = fit(loss_fn, start, [batch], optimizer=adam(2e-3),
                 n_epochs=n_epochs // 2, checkpoint_dir=ckpt,
                 checkpoint_every=5, log_every=0, log_fn=log)
        r2 = fit(loss_fn, start, [batch], optimizer=adam(2e-3),
                 n_epochs=n_epochs // 2, checkpoint_dir=ckpt,
                 checkpoint_every=5, log_every=0, log_fn=log)
    if r2.steps != n_epochs:
        raise AssertionError((r2.steps, n_epochs))
    l0, l1 = r1.history[0]["loss"], r2.history[-1]["loss"]
    dq0 = float(torch.max(torch.abs(start["q"] - q_true)))
    dq1 = float(torch.max(torch.abs(r2.params["q"] - q_true)))
    n = pos.shape[0]
    log(f"multi-config fit (B={n_configs}, {n} atoms): loss {l0:.3e} -> "
        f"{l1:.3e}, max|dq| {dq0:.4f} -> {dq1:.4f}, resumed at step "
        f"{r1.steps}")
    if check:
        if not l1 < 0.2 * l0:
            raise AssertionError((l1, l0))
        log("multi-config fit OK")
    return dict(device=label, n_atoms=n, l0=l0, l1=l1, dq0=dq0, dq1=dq1,
                r1_steps=r1.steps, steps=r2.steps,
                losses=[h["loss"] for h in r1.history + r2.history],
                step_ms=[h["dt"] * 1e3 for h in r1.history + r2.history])


def run(cpu=False, method="auto", dtype=torch.float64, log=print):
    """Both parts, as the script runs them."""
    return dict(main=main(cpu, method, dtype, log),
                multi_config=multi_config(cpu=cpu, method=method,
                                          dtype=dtype, log=log))


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    run(ap.parse_args(argv).cpu)


if __name__ == "__main__":
    cli()
