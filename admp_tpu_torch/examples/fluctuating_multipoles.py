"""Geometry-dependent ("fluctuating") multipoles at scale, with sharded PME
(admp_tpu's examples/fluctuating_multipoles.py).

A box of water with sparse exclusions, whose charges follow each water's
O-H stretches (a toy charge-transfer response), so that the forces flow
through the multipoles into the positions. With --sharded and more than one
card, one rank per card runs the FFT grid and the pair list sharded over
the cards (NCCL); with one card, or on the CPU, the box runs on one device,
as admp_tpu shards only over more than one device.

    python -m admp_tpu_torch.examples.fluctuating_multipoles --n-side 32
    python -m admp_tpu_torch.examples.fluctuating_multipoles --n-side 8 --cpu
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from admp_tpu_torch.examples import device_label, script_device, tensor

R0_OH = 0.9572    # A
COUPLING = 0.4    # e / A charge-transfer response
M_SCALES = (0.0, 0.0, 0.0, 1.0, 1.0)
ETHRESH = 1e-4
ROUTES = {"cuda": "K4/K6 (csrc/spread.cu)",
          "cuda2d": "K5/K7 tiled (csrc/spread_tiled.cu)",
          "torch": "index_add_ (plain)"}


def build(n_side=8, rc=4.0, device="cuda", dtype=torch.float32, log=print):
    """The box: ``water_system`` of n_side^3 waters without its dense map,
    the sparse exclusions of its O-H bonds, and the cell list at ``rc``."""
    from admp_tpu_torch import neighbor_list_cell, water_system
    from admp_tpu_torch.ops.exclusions import build_sparse_exclusions

    s = water_system(n_side=n_side, spacing=3.104, jitter=0.1, seed=0,
                     exclusions=None)
    n = s["positions"].shape[0]
    log(f"{n} atoms, box {s['box'][0, 0]:.1f} A")
    # sparse exclusions: no dense (N, N) map at this scale
    bonds = [(3 * m, 3 * m + h) for m in range(n // 3) for h in (1, 2)]
    exclusions = build_sparse_exclusions(bonds, n, max_depth=6)
    c = lambda x: tensor(x, device, dtype)  # noqa: E731
    positions, box = c(s["positions"]), c(s["box"])
    t0 = time.perf_counter()
    nlist = neighbor_list_cell(positions, box, rc)
    overflow = bool(nlist.did_overflow)
    log(f"neighbor list: {nlist.capacity} capacity, overflow={overflow} "
        f"({time.perf_counter() - t0:.1f}s)")
    return dict(sys=s, exclusions=exclusions, nlist=nlist, overflow=overflow,
                positions=positions, box=box, q_cart=c(s["q_cart"]),
                m_scales=c(M_SCALES), rc=rc)


def fluctuating_q_local(positions, q_cart0):
    """Each water's O and H charges shift by COUPLING x its O-H stretches
    about R0_OH; Cartesian -> harmonic (lmax 2). Out of place, so that the
    forces flow through Q_local into the positions."""
    from admp_tpu_torch import convert_cart2harm

    n = positions.shape[0]
    o, h1, h2 = positions[0::3], positions[1::3], positions[2::3]
    dq1 = COUPLING * (torch.linalg.norm(h1 - o, dim=-1) - R0_OH)
    dq2 = COUPLING * (torch.linalg.norm(h2 - o, dim=-1) - R0_OH)
    q = q_cart0.reshape(n // 3, 3, -1)
    dq = torch.stack([dq1 + dq2, -dq1, -dq2], dim=1)
    q = torch.cat([q[..., :1] + dq[..., None], q[..., 1:]], dim=-1)
    return convert_cart2harm(q.reshape(n, -1), 2)


def sharded_energy(box_sys, group=None, method="auto"):
    """The --sharded branch, inside a process group of P ranks: the heuristic
    grid with K1 and K2 rounded up to P, the pairs padded to P, and
    make_sharded_pme_energy over ``group``. Returns (energy(positions),
    grid)."""
    import torch.distributed as dist

    from admp_tpu_torch import EngineConfig
    from admp_tpu_torch.ops.ewald import setup_ewald_parameters
    from admp_tpu_torch.parallel import make_sharded_pme_energy

    s, pairs = box_sys["sys"], box_sys["nlist"].pairs
    n_dev = dist.get_world_size(group)
    n = s["positions"].shape[0]
    kappa, k1, k2, k3 = setup_ewald_parameters(box_sys["rc"], ETHRESH,
                                               s["box"])
    k1 = -(-k1 // n_dev) * n_dev
    k2 = -(-k2 // n_dev) * n_dev
    pad = torch.full((-pairs.shape[0] % n_dev, 2), n, dtype=pairs.dtype,
                     device=pairs.device)
    pairs_p = torch.cat([pairs, pad])
    # lattice-ordered atoms crowd a rank's block into few slabs: bins of at
    # least P times the uniform share hold them
    config = EngineConfig(pair_kernel=method, spread_method=method,
                          halo_cap_factor=max(3.0, float(n_dev)))
    energy_fixed = make_sharded_pme_energy(
        group, grid_shape=(k1, k2, k3), kappa=kappa, lmax=2,
        axis_types=s["axis_types"], axis_indices=s["axis_indices"],
        covalent_map=box_sys["exclusions"], config=config,
        device=box_sys["positions"].device)

    def energy(positions):
        return energy_fixed(positions, box_sys["box"], pairs_p,
                            fluctuating_q_local(positions,
                                                box_sys["q_cart"]),
                            box_sys["m_scales"])

    return energy, (k1, k2, k3)


def run(n_side=8, rc=4.0, cpu=False, k=0, sharded=False, method="auto",
        dtype=torch.float32, log=print, time_steps=3, box_sys=None):
    """The script's run; returns its printed numbers, the gradient ``f`` and
    the box (``box_sys``, which a later call may pass back in). With
    ``sharded`` it runs inside the initialized default process group, at
    any size."""
    from admp_tpu_torch import ADMPPmeForce, EngineConfig
    from admp_tpu_torch.ops.reciprocal import resolve_spread_method

    device = script_device(cpu)
    if sharded:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise ValueError("sharded=True runs inside a process group")
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    label = device_label(device)
    log(f"device: {label}")
    if box_sys is None:
        box_sys = build(n_side, rc, device, dtype, log)
    s = box_sys["sys"]
    out = dict(device=label, n_atoms=s["positions"].shape[0],
               capacity=box_sys["nlist"].capacity,
               overflow=box_sys["overflow"], box_sys=box_sys)
    if sharded:
        energy, grid = sharded_energy(box_sys, method=method)
    else:
        force = ADMPPmeForce(
            s["box"], s["axis_types"], s["axis_indices"],
            box_sys["exclusions"], rc, ETHRESH, lmax=2,
            # the cell list emits i-sorted pairs
            config=EngineConfig(fft_friendly_grid=True, pairs_i_sorted=True,
                                pair_kernel=method, spread_method=method),
            device=device, dtype=dtype)
        if k:
            force.K1 = force.K2 = force.K3 = k
            force.refresh_calculators()
        out["force"] = force
        grid = (force.K1, force.K2, force.K3)
        pairs = box_sys["nlist"].pairs

        def energy(positions):
            return force.get_energy(
                positions, box_sys["box"], pairs,
                fluctuating_q_local(positions, box_sys["q_cart"]),
                box_sys["m_scales"])

        route = resolve_spread_method(force.config.spread_method,
                                      box_sys["positions"], 6, grid)
        out["route"] = route
        log(f"grid {grid}, spread path ({method}, {str(dtype)[6:]} on "
            f"{device.type}): {ROUTES[route]}")
    out["grid"] = grid

    def step(positions):
        x = positions.detach().requires_grad_(True)
        with torch.enable_grad():
            e = energy(x)
            (g,) = torch.autograd.grad(e, x)
        return float(e.detach()), g  # the float waits for the step

    t0 = time.perf_counter()
    e, f = step(box_sys["positions"])
    log(f"E = {e:.4f} kJ/mol  (first call {time.perf_counter() - t0:.1f}s)")
    times = []
    for _ in range(time_steps):
        t0 = time.perf_counter()
        e, f = step(box_sys["positions"])
        times.append(time.perf_counter() - t0)
    out.update(e=e, f=f, times_ms=[t * 1e3 for t in times])
    if times:
        out["ms_step"] = float(np.median(times)) * 1e3
        log(f"energy+force (incl. fluctuating multipoles): "
            f"{out['ms_step']:.1f} ms/step [{label}]")
    out["f_rms"] = float(torch.sqrt(torch.mean(f ** 2)))
    log(f"|F| rms = {out['f_rms']:.4f} kJ/mol/A")
    return out


def sharded_rank(rank, world_size, n_side, rc, cpu, method, dtype,
                 time_steps):
    """One rank of the sharded run (parallel/launch.py): on the card of its
    rank unless ``cpu``; returns its numbers, the gradient as numpy."""
    if not cpu:
        torch.cuda.set_device(rank)
    log = print if rank == 0 else (lambda *a: None)
    out = run(n_side, rc, cpu, sharded=True, method=method, dtype=dtype,
              log=log, time_steps=time_steps)
    return dict(e=out["e"], f=out["f"].cpu().numpy(), f_rms=out["f_rms"],
                grid=out["grid"], times_ms=out["times_ms"],
                device=out["device"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-side", type=int, default=8)
    ap.add_argument("--rc", type=float, default=4.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--k", type=int, default=0,
                    help="override the FFT grid (0 = ethresh heuristic)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard over all visible cards")
    args = ap.parse_args(argv)
    script_device(args.cpu)
    n_cards = 0 if args.cpu else torch.cuda.device_count()
    if args.sharded and n_cards > 1:
        from admp_tpu_torch.examples.fluctuating_multipoles import (
            sharded_rank as rank_fn,  # by its import path, for the ranks
        )
        from admp_tpu_torch.parallel.launch import launch

        launch(rank_fn, n_cards, args=(args.n_side, args.rc, False, "auto",
                                       torch.float32, 3), backend="nccl")
        return
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(str(msg))

    run(args.n_side, args.rc, args.cpu, args.k, log=log)
    if args.n_side >= 32 and not args.cpu:
        out = pathlib.Path(__file__).parent / "fluctuating_98k_gpu.out"
        out.write_text("\n".join(lines) + "\n")
        print(f"# wrote {out}")


if __name__ == "__main__":
    main()
