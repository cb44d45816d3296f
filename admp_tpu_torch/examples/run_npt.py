"""NPT water: Langevin NVT segments alternated with Monte-Carlo barostat
volume moves (admp_tpu's examples/run_npt.py).

The energy closure takes the box as an argument, so the PME influence grid
follows each volume change (cache_influence=False); the neighbor list is
built with a 1 A skin, kept inside each segment and refreshed at its
capacity between segments, and again after an accepted volume move.
Randomness comes from one torch.Generator seeded 0, where admp_tpu splits
one PRNG key: the trajectory is the same in kind, not step for step.

    python -m admp_tpu_torch.examples.run_npt --nmol 1000 --steps 20
    python -m admp_tpu_torch.examples.run_npt --nmol 64 --cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from admp_tpu_torch.examples import device_label, script_device, tensor

RC = 4.0
SKIN = 1.0
M_SCALES = (0.0, 0.0, 0.0, 1.0, 1.0)
DT, FRICTION = 0.0002, 10.0    # ps, 1/ps
K_B = 0.00831446261815324      # kJ/mol/K


def build(nmol=64, device="cuda", dtype=torch.float32, method="auto"):
    """The script's system: round(nmol^(1/3))^3 waters, fixed multipoles
    (lmax 2), Tang-Toennies and the bonded water terms, the cell list at
    rc + skin. Returns a dict with ``energy(positions, box, pairs)``."""
    from admp_tpu_torch import (
        ADMPPmeForce,
        EngineConfig,
        convert_cart2harm,
        generate_pairwise_interaction,
        neighbor_list_cell,
        tt_damping_qq_c6_kernel,
        water_system,
    )
    from admp_tpu_torch.ops.bonded import (
        harmonic_angle_energy,
        harmonic_bond_energy,
        water_bonded_terms,
    )

    device = torch.device(device)
    n_side = round(nmol ** (1 / 3))
    s = water_system(n_side=n_side, spacing=3.104, jitter=0.05, seed=0)
    n = s["positions"].shape[0]
    c = lambda x: tensor(x, device, dtype)  # noqa: E731
    positions, box = c(s["positions"]), c(s["box"])
    nl = neighbor_list_cell(positions, box, RC + SKIN)
    q_local = convert_cart2harm(c(s["q_cart"]), 2)
    m_scales = c(M_SCALES)
    tt_args = [c(s[k]) for k in ("tt_a", "tt_b", "tt_q")] + [
        c(s["c_list"])[:, 0]]
    b_idx, r0, k_bond, a_idx, theta0, k_angle = water_bonded_terms(n // 3)
    b_idx, a_idx = (torch.as_tensor(x, device=device) for x in (b_idx, a_idx))
    r0, k_bond, theta0, k_angle = (c(x) for x in (r0, k_bond, theta0,
                                                  k_angle))
    # NPT: the influence grid must follow the box
    pme = ADMPPmeForce(
        s["box"], s["axis_types"], s["axis_indices"], s["covalent_map"], RC,
        1e-4, lmax=2,
        config=EngineConfig(cache_influence=False, pair_kernel=method,
                            spread_method=method),
        device=device, dtype=dtype)
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                       s["covalent_map"], device=device)

    def energy(pos, bx, prs):
        e = pme.get_energy(pos, bx, prs, q_local, m_scales)
        e = e + tt(pos, bx, prs, m_scales, *tt_args)
        # intramolecular springs keep the flexible molecules bound
        e = e + harmonic_bond_energy(pos, bx, b_idx, r0, k_bond)
        return e + harmonic_angle_energy(pos, bx, a_idx, theta0, k_angle)

    return dict(positions=positions, box=box, nl=nl, energy=energy, pme=pme,
                n_atoms=n, masses=c(np.tile([15.999, 1.008, 1.008], n // 3)),
                molecules=np.repeat(np.arange(n // 3), 3))


def force_fn(energy, box, pairs):
    """force_fn(positions, aux) -> (energy, forces, aux) at a fixed box and
    pair list, as md.py's integrators take it."""
    def fn(p, aux):
        x = p.detach().requires_grad_(True)
        with torch.enable_grad():
            e = energy(x, box, pairs)
            (g,) = torch.autograd.grad(e, x)
        return e.detach(), -g, aux

    return fn


def n_pairs(nl, n_atoms):
    """The real (not padding) entries of a neighbor list."""
    return int((nl.pairs[:, 0] < n_atoms).sum())


def run(nmol=64, steps=100, segments=5, temperature=300.0, pressure_bar=1.0,
        cpu=False, method="auto", dtype=torch.float32, log=print):
    """The script's run; returns the starting energy and forces and, per
    segment, E, V, T_inst, the barostat's verdict and the pair counts."""
    from admp_tpu_torch import (
        BAR_TO_KJMOL_A3,
        MDState,
        make_mc_barostat,
        refresh_neighbor_list,
        run_langevin,
    )

    device = script_device(cpu)
    label = device_label(device)
    log(f"device: {label}")
    m = build(nmol, device, dtype, method)
    n, energy = m["n_atoms"], m["energy"]
    box, nl = m["box"], m["nl"]
    log(f"{n} atoms, box {float(box[0, 0]):.2f} A, target {pressure_bar} bar "
        f"/ {temperature} K")
    barostat = make_mc_barostat(energy, m["molecules"],
                                pressure_bar * BAR_TO_KJMOL_A3, temperature)
    gen = torch.Generator(device=device).manual_seed(0)
    p0 = m["positions"]
    e0, f0, _ = force_fn(energy, box, nl.pairs)(p0, None)
    out = dict(device=label, n_atoms=n, e0=float(e0), f0=f0, segments=[],
               system=m)
    state = MDState(p0, torch.zeros_like(p0), f0, None)
    accepts = 0
    t_start = time.perf_counter()
    for seg in range(segments):
        state, kes = run_langevin(force_fn(energy, box, nl.pairs), m["masses"],
                                  DT, temperature, FRICTION, state, steps, gen)
        # refresh at fixed capacity: the segment's diffusion (and an accepted
        # volume move below) eats into the skin
        nl = refresh_neighbor_list(nl, state.positions, box)
        pairs_before = n_pairs(nl, n)
        pos, box, acc, e = barostat(state.positions, box, gen, nl.pairs)
        accepted = bool(acc)
        accepts += accepted
        if accepted:
            nl = refresh_neighbor_list(nl, pos, box)
        forces = force_fn(energy, box, nl.pairs)(pos, None)[1]
        state = state._replace(positions=pos, forces=forces)
        vol = abs(float(torch.det(box.double())))
        t_inst = 2.0 * float(kes[-1]) / (3.0 * n * K_B)
        out["segments"].append(dict(
            e=float(e), volume=vol, t_inst=t_inst, accepted=accepted,
            pairs=(pairs_before, n_pairs(nl, n))))
        log(f"segment {seg}: E = {float(e):10.3f} kJ/mol  V = {vol:9.1f} "
            f"A^3  T_inst = {t_inst:6.1f} K  barostat "
            f"{'accept' if accepted else 'reject'}")
    wall = time.perf_counter() - t_start
    out.update(accepts=accepts, wall_s=wall, state=state, box=box, nl=nl)
    log(f"# {accepts}/{segments} volume moves accepted, {wall:.1f}s total "
        f"[{label}]")
    return out


def volume_move(m, positions, box, nl, factor):
    """A volume move by the box scale ``factor`` (the molecules' centres of
    mass scaled, as the barostat moves them), the list refreshed at its
    capacity, and a fresh cell list at the new box: (positions', box',
    refreshed list, fresh list)."""
    from admp_tpu_torch import neighbor_list_cell, refresh_neighbor_list

    mol = torch.as_tensor(m["molecules"], device=positions.device)
    counts = torch.bincount(mol).to(positions.dtype)
    com = positions.new_zeros(counts.shape[0], 3).index_add_(0, mol, positions)
    com = com / counts[:, None]
    pos = positions + (factor - 1.0) * com[mol]
    box = box * factor
    return (pos, box, refresh_neighbor_list(nl, pos, box),
            neighbor_list_cell(pos, box, nl.cutoff))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nmol", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100, help="MD steps/segment")
    ap.add_argument("--segments", type=int, default=5)
    ap.add_argument("--temperature", type=float, default=300.0)
    ap.add_argument("--pressure-bar", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    run(args.nmol, args.steps, args.segments, args.temperature,
        args.pressure_bar, args.cpu)


if __name__ == "__main__":
    main()
