"""Flagship example: the full MPID water force field, energies and forces
(admp_tpu's examples/run_water.py).

With --pdb/--xml it loads a PDB and an MPID force-field XML; otherwise it
makes a liquid-density box of --nmol waters. Prints each term's energy
(electrostatic PME, with polarization under --polarizable; dispersion PME;
Tang-Toennies) and the time of one PME energy+force step, beside the device.

    python -m admp_tpu_torch.examples.run_water --nmol 1000 --polarizable
    python -m admp_tpu_torch.examples.run_water --nmol 27 --cpu --f64
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from admp_tpu_torch.examples import device_label, script_device, tensor

M_SCALES = (0.0, 0.0, 0.0, 1.0, 1.0)


def load_system(pdb=None, xml=None, nmol=216):
    """The system's numpy arrays: from ``pdb``/``xml`` (with the synthetic
    box's dispersion and Tang-Toennies parameters tiled per water, as
    admp_tpu's script does), else ``water_system`` of round(nmol^(1/3))^3
    waters."""
    from admp_tpu_torch.systems import water_system

    if pdb and xml:
        from admp_tpu_torch.io import load_mpid_system

        s = load_mpid_system(pdb, xml)
        ref = water_system(n_side=1)
        nmol = s.n_atoms // 3
        out = dict(positions=s.positions, box=s.box, axis_types=s.axis_types,
                   axis_indices=s.axis_indices, covalent_map=s.covalent_map,
                   q_cart=s.q_cart, pol=s.pol, tholes=s.tholes,
                   c_list=np.tile(ref["c_list"][:3], (nmol, 1)))
        for k in ("tt_a", "tt_b", "tt_q"):
            out[k] = np.tile(ref[k][:3], nmol)
        return out
    n_side = round(nmol ** (1 / 3))
    return water_system(n_side=n_side, spacing=3.104, jitter=0.12, seed=0)


def run(pdb=None, xml=None, nmol=216, rc=4.0, ethresh=1e-4,
        polarizable=False, f64=False, cpu=False, method="auto", log=print,
        time_iters=5):
    """The script's run; returns its printed numbers, the forces, and the
    force objects ``pme`` (with its arguments ``e_args``) and ``disp``.
    ``method`` is the pair kernel and spread route of every force object;
    ``time_iters=0`` skips the timed steps."""
    from admp_tpu_torch import (
        ADMPDispPmeForce,
        ADMPPmeForce,
        EngineConfig,
        convert_cart2harm,
        generate_pairwise_interaction,
        neighbor_list_cell,
        tt_damping_qq_c6_kernel,
    )
    from admp_tpu_torch.utils.profiling import time_fn

    device = script_device(cpu)
    dtype = torch.float64 if f64 else torch.float32
    label = device_label(device)
    log(f"device: {label}")
    s = load_system(pdb, xml, nmol)
    c = lambda x: tensor(x, device, dtype)  # noqa: E731
    positions, box = s["positions"], s["box"]
    n = positions.shape[0]
    log(f"system: {n} atoms, box diag {np.round(np.diag(box), 3)}")

    pos, box_t = c(positions), c(box)
    nlist = neighbor_list_cell(pos, box_t, rc)
    overflow = bool(nlist.did_overflow)
    log(f"pairs: capacity {nlist.capacity}, overflow {overflow}")
    pairs = nlist.pairs
    q_local = convert_cart2harm(c(s["q_cart"]), 2)
    m_scales = c(M_SCALES)
    kw = dict(device=device, dtype=dtype)
    pme = ADMPPmeForce(
        box, s["axis_types"], s["axis_indices"], s["covalent_map"], rc,
        ethresh, lmax=2, lpol=polarizable,
        config=EngineConfig(pair_kernel=method, spread_method=method), **kw)
    disp = ADMPDispPmeForce(
        box, s["covalent_map"], rc, ethresh, pmax=10,
        config=EngineConfig(pair_kernel=method, spread_method=method), **kw)
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                       s["covalent_map"], device=device)

    if polarizable:
        e_args = (pos, box_t, pairs, q_local, c(s["pol"]), c(s["tholes"]),
                  m_scales, m_scales, m_scales)
    else:
        e_args = (pos, box_t, pairs, q_local, m_scales)

    out = dict(device=label, n_atoms=n, capacity=nlist.capacity,
               overflow=overflow, grid=(pme.K1, pme.K2, pme.K3), pme=pme,
               disp=disp, e_args=e_args)
    t0 = time.perf_counter()
    e_pme, f_pme = pme.get_forces(*e_args)
    e_pme = float(e_pme)  # waits for the step
    log(f"electrostatic PME: {e_pme:14.4f} kJ/mol "
        f"(first call {time.perf_counter() - t0:.1f}s)")
    out.update(e_pme=e_pme, f_pme=f_pme)
    if polarizable:
        out.update(converged=bool(pme.lconverg), n_iter=int(pme.n_cycle))
        log(f"  SCF converged={out['converged']} iters={out['n_iter']}")

    c_list = c(s["c_list"])
    e_disp, f_disp = disp.get_forces(pos, box_t, pairs, c_list, m_scales)
    out.update(e_disp=float(e_disp), f_disp=f_disp)
    log(f"dispersion PME:    {out['e_disp']:14.4f} kJ/mol")
    x = pos.detach().requires_grad_(True)
    with torch.enable_grad():
        e_tt = tt(x, box_t, pairs, m_scales, c(s["tt_a"]), c(s["tt_b"]),
                  c(s["tt_q"]), c_list[:, 0])
        (f_tt,) = torch.autograd.grad(e_tt, x)
    out.update(e_tt=float(e_tt.detach()), f_tt=f_tt)
    log(f"Tang-Toennies:     {out['e_tt']:14.4f} kJ/mol")

    if time_iters:
        dt = time_fn(lambda p: pme.get_forces(*((p,) + e_args[1:]))[1], pos,
                     iters=time_iters)
        out["ms_step"] = dt * 1e3
        log(f"PME energy+force step: {dt * 1e3:.2f} ms [{label}]")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pdb")
    ap.add_argument("--xml")
    ap.add_argument("--nmol", type=int, default=216)
    ap.add_argument("--rc", type=float, default=4.0)
    ap.add_argument("--ethresh", type=float, default=1e-4)
    ap.add_argument("--polarizable", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
