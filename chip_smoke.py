"""Run the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase failure is caught):
  0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no CUDA device -> exit 1 before anything is printed as a result;
  1. build the five CUDA kernels from admp_tpu_torch/csrc into
     admp_tpu_torch/_build (nvcc, one process per source, concurrently);
  2. each kernel against its plain PyTorch version at the main path's shapes
     (the pair HVP K3 for kinds pol, uu and perm, every output);
  3. the MD path: the polarizable multipolar PME energy+force step of
     1000 waters (3000 atoms, lmax=2, rc 4 A, ethresh 1e-4, K3=128, the MD
     SCF profile), one cold step and 10 warm drift steps, plus one
     fixed-multipole step; launch counts; the first step against the plain
     path in f32 and in f64 on the card;
  3b. the exact-adjoint path (default SCFConfig(): implicit adjoint,
     field_tol 10, order-6 full-resolution matvec mesh): one cold and 10 warm
     drift steps, launch counts (K3 for pol and uu), the first step against
     the plain path in f32 and f64;
  3c. parameter gradients dE/dQ_local, dE/dpol, dE/dtholes on the kernels
     against the plain path in f64;
  3d. the trainer: 3 fitting.fit steps of energy matching on the exact-adjoint
     polarizable model (Q_local, pol, tholes) and of energy_force_loss on the
     fixed-multipole model (Q_local), B=2 each, kernel path against plain f32;
     launch counts (K3 for perm);
  4. timing: ms/step of the MD step (median of 3 x 10 steps, CUDA events) and
     of the exact-adjoint step, ms per fitting step, and each kernel beside
     its plain version.
Each path's launch counts are set to 0 just before it runs and read just
after. The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Long logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

N_SIDE, SPACING, JITTER, SEED = 10, 3.104, 0.12, 0
RC, ETHRESH, LMAX, K3 = 4.0, 1e-4, 2, 128
DRIFT = 0.005
N_STEPS = 10
N_REPEATS = 3
N_FIT_STEPS = 3
# Adam's step: the default 1e-3 overshoots the 5% start (the fixed-model
# force loss overshot at 1e-4 on the card), so the loss would not fall
FIT_LR = 1e-5

# tolerances (ISSUE: per-kernel f32 vs the plain version on the card)
# per pair, relative (native erfcf/expf, FMA), with an absolute floor of
# 1e-6 of the largest pair energy where a pair's terms cancel
TOL_PAIR_E = 1e-5
TOL_PAIR_GRAD = 1e-5    # relative RMSE of every gradient output
TOL_SPREAD = 1e-5       # x max|mesh| (atomic summation order)
TOL_STEP_E = 1e-5       # first step, kernel vs plain f32, relative energy
TOL_STEP_F = 1e-4       # first step, kernel vs plain f32, force rel. RMSE
TOL_F64 = 1e-3          # kernel f32 forces vs plain f64 forces, rel. RMSE
# the pair HVP against the plain version in f64 on the same inputs: relative
# RMSE of every output within max(TOL_HVP, 2 x the plain f32 version's),
# with a floor of 1e-6 max|x|. Second derivatives in f32 carry the
# algorithm's own floor, above 1e-4 in places (the quasi-internal frame of a
# pair along x amplifies rounding; the virial sums 50k pairs): the plain f32
# version shows it on the same inputs (PERF.md, Findings)
TOL_HVP = 1e-4
TOL_ADJ_F = 2e-4        # exact adjoint, first step, kernel vs plain f32 forces
TOL_FIT = 1e-2          # fitting losses, kernel vs plain f32, each step


def log(msg):
    print(msg, flush=True)


def rel_rmse(a, b):
    a = a.double()
    b = b.double()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / (torch.sqrt(torch.mean(b ** 2)) + 1e-30))


def require(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def cuda_time_ms(fn, n=20, warmup=3):
    """(ms per call on the card's timeline between CUDA events over n
    back-to-back calls, which includes any host enqueue gap; ms per call of
    device kernel time alone, from torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return start.elapsed_time(stop) / n, device_us / 1e3 / n


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------


def build_workload(device):
    """The bench.py polarizable workload (build_pol_workload) in the port."""
    from admp_tpu_torch import convert_cart2harm, neighbor_list_dense, water_system
    from admp_tpu_torch.ops.ewald import setup_ewald_parameters

    s = water_system(n_side=N_SIDE, spacing=SPACING, jitter=JITTER, seed=SEED)
    _, k1, k2, _ = setup_ewald_parameters(RC, ETHRESH, s["box"])
    f32 = dict(device=device, dtype=torch.float32)
    positions = torch.tensor(s["positions"], **f32)
    box = torch.tensor(s["box"], **f32)
    nl = neighbor_list_dense(positions, box, RC)
    require(not bool(nl.did_overflow), "neighbor list overflow")
    q_local = convert_cart2harm(torch.tensor(s["q_cart"], **f32), 2)
    rng = np.random.default_rng(1)
    drift = torch.tensor(DRIFT * rng.standard_normal(s["positions"].shape),
                         **f32)
    return dict(sys=s, positions=positions, box=box, pairs=nl.pairs,
                q_local=q_local, pol=torch.tensor(s["pol"], **f32),
                tholes=torch.tensor(s["tholes"], **f32),
                scales=torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], **f32),
                drift=drift, grid=(k1, k2, K3))


def make_force(w, lpol, device, dtype, method, fixed_iters=None, scf=None):
    """The workload's force; the MD SCF profile unless ``scf`` is given."""
    import dataclasses

    from admp_tpu_torch import ADMPPmeForce, EngineConfig, SCFConfig

    s = w["sys"]
    if scf is None:
        scf = dataclasses.replace(SCFConfig.md(), fixed_iters=fixed_iters)
    cfg = EngineConfig(cache_influence=True, scf=scf,
                       pair_kernel=method, spread_method=method)
    force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                         s["covalent_map"], RC, ETHRESH, lmax=LMAX, lpol=lpol,
                         config=cfg, device=device, dtype=dtype)
    force.K3 = K3
    force.refresh_calculators()
    return force


def pol_args(w, positions, dtype):
    c = lambda t: t.to(dtype)  # noqa: E731
    return (c(positions), c(w["box"]), w["pairs"], c(w["q_local"]),
            c(w["pol"]), c(w["tholes"]), c(w["scales"]), c(w["scales"]),
            c(w["scales"]))


# ---------------------------------------------------------------------------
# phase 2: per-kernel checks at the main path's shapes
# ---------------------------------------------------------------------------


def pair_inputs(w, kind):
    """Gathered pair tables at the main path's shapes (3000 atoms, the full
    pair capacity), as models/pme builds them."""
    from admp_tpu_torch.models.pme import _pair_indices, _pair_scalars
    from admp_tpu_torch.ops.exclusions import lookup_topology_distance, scale_for_distance
    from admp_tpu_torch.ops.frames import local_frames_components
    from admp_tpu_torch.ops.harmonics import rot_local2global_components

    s = w["sys"]
    dev = w["positions"].device
    pos, box = w["positions"], w["box"]
    n = pos.shape[0]
    cov = torch.as_tensor(s["covalent_map"], device=dev).long()
    i, j, mask = _pair_indices(w["pairs"], n)
    nbond = lookup_topology_distance(cov, i, j)
    mscale = scale_for_distance(w["scales"], nbond)
    rng = np.random.default_rng(2)
    u = torch.tensor(rng.normal(0, 0.05, (n, 3)), device=dev,
                     dtype=torch.float32)
    u_harm = torch.stack([u[:, 2], u[:, 0], u[:, 1]], dim=1)
    pol, tholes = w["pol"][:, None], w["tholes"][:, None]
    if kind == "uu":
        packed = torch.cat([pos, u_harm, pol, tholes], dim=1)
        scl = torch.stack([mscale, mask.float()])
        lmax = 1
    else:
        frames = local_frames_components(
            pos, box, torch.as_tensor(s["axis_types"], device=dev),
            torch.as_tensor(s["axis_indices"], device=dev))
        qg = rot_local2global_components(w["q_local"], frames, LMAX)
        cols, rows = [pos, qg], [mscale, mask.float()]
        if kind == "pol":
            cols += [u_harm, pol, tholes]
            rows.append(mscale)
        packed = torch.cat(cols, dim=1)
        scl = torch.stack(rows)
        lmax = LMAX
    return (packed.index_select(0, i).contiguous(),
            packed.index_select(0, j).contiguous(), scl.contiguous(),
            _pair_scalars(0.7296, box).contiguous(), lmax)


def check_pairs(w, record):
    from admp_tpu_torch.ops.cuda import pairs as P

    for kind in ("pol", "uu", "perm"):
        g_i, g_j, scl, scal, lmax = pair_inputs(w, kind)
        e_k = P.launch_pair_fwd(g_i, g_j, scl, scal, lmax, kind)
        e_p = P.pair_energies_torch(g_i, g_j, scl, scal, lmax, kind)
        e_64 = P.pair_energies_torch(g_i.double(), g_j.double(), scl.double(),
                                     scal.double(), lmax, kind)
        torch.cuda.synchronize()
        # a pair's f32 rounding is set by its largest term, not by its sum:
        # where the terms cancel the relative error of the sum means
        # nothing, so the per-pair scale has a floor of 1e-6 max|e|
        e_max = float(e_p.abs().max())
        # e_rel < TOL_PAIR_E <=> |e_k - e_p| < TOL_PAIR_E |e_p| + 1e-6 max|e|
        e_rel = TOL_PAIR_E * float(
            ((e_k - e_p).abs()
             / (TOL_PAIR_E * e_p.abs() + 1e-6 * e_max)).max())
        e_abs = float((e_k - e_p).abs().max())
        log(f"pair {kind:4s}: max|e| {e_max:.4e}; max |e - e_f64| kernel "
            f"{float((e_k.double() - e_64).abs().max()):.3e}, plain f32 "
            f"{float((e_p.double() - e_64).abs().max()):.3e}")
        rng = np.random.default_rng(3)
        ct = torch.tensor(rng.uniform(0.5, 1.5, g_i.shape[0]),
                          device=g_i.device, dtype=torch.float32)
        outs_k = P.launch_pair_bwd(g_i, g_j, scl, scal, ct, lmax, kind)
        leaves = [t.clone().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
        e_leaf = P.pair_energies_torch(*leaves, lmax, kind)
        outs_p = torch.autograd.grad((e_leaf * ct).sum(), leaves)
        torch.cuda.synchronize()
        names = ("d_gi", "d_gj", "d_scl", "d_scal")
        # the mask row has no gradient; compare the differentiable rows
        errs = {}
        for nm, a, b in zip(names, outs_k, outs_p):
            if nm == "d_scl":
                rows = [0, 2] if kind == "pol" else [0]
                a, b = a[rows], b[rows]
            errs[nm] = rel_rmse(a, b)
        g_abs = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
        log(f"pair {kind:4s} C={g_i.shape[0]} F={g_i.shape[1]}: energy max "
            f"rel err {e_rel:.3e} (abs {e_abs:.3e}); grad rel RMSE "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        require(e_rel < TOL_PAIR_E, f"pair {kind} energies {e_rel}")
        for nm, v in errs.items():
            require(v < TOL_PAIR_GRAD, f"pair {kind} {nm} {v}")
        if kind == "pol":
            record["pair_fwd"]["max_abs_err"] = e_abs
            record["pair_bwd"]["max_abs_err"] = g_abs
            record["_pair_inputs"] = (g_i, g_j, scl, scal, lmax, ct)


def hvp_ok(k, p32, p64):
    """(relative RMSE of the kernel and of the plain f32 version against
    the plain f64 version, pass): rms(k - p64) <= max(TOL_HVP, 2 x the plain
    f32 relative RMSE) rms(p64) + 1e-6 max|p64|."""
    k, p32, p64 = k.double(), p32.double(), p64.double()
    rms = lambda x: float(torch.sqrt(torch.mean(x ** 2)))  # noqa: E731
    rms_b = rms(p64) + 1e-30
    err_k, err_32 = rms(k - p64) / rms_b, rms(p32 - p64) / rms_b
    ok = (rms(k - p64) <= max(TOL_HVP, 2 * err_32) * rms_b
          + 1e-6 * float(p64.abs().max()))
    return err_k, err_32, ok


def check_hvp(w, record):
    """K3 against pair_hvp_torch (float64 and float32, same inputs) at the
    main path's shapes, with nonzero cotangents on every output
    (P.hvp_directions)."""
    from admp_tpu_torch.ops.cuda import pairs as P

    names = ("d_gi", "d_gj", "d_scl", "d_scal", "d_ct")
    for kind in ("pol", "uu", "perm"):
        g_i, g_j, scl, scal, lmax = pair_inputs(w, kind)
        x = (g_i, g_j, scl, scal)
        rng = np.random.default_rng(3)
        ct = torch.tensor(rng.uniform(0.5, 1.5, g_i.shape[0]),
                          device=g_i.device, dtype=torch.float32)
        cs = P.hvp_directions(x, kind, seed=5)
        out_k = P.launch_pair_hvp(*x, ct, *cs, lmax, kind)
        out_64 = P.pair_hvp_torch(*(t.double() for t in (*x, ct, *cs)), lmax,
                                  kind)
        out_32 = P.pair_hvp_torch(*x, ct, *cs, lmax, kind)
        torch.cuda.synchronize()
        errs = {nm: hvp_ok(*t) for nm, *t in zip(names, out_k, out_32,
                                                 out_64)}
        log(f"pair HVP {kind:4s} C={g_i.shape[0]} F={g_i.shape[1]}: rel RMSE "
            "vs plain f64, kernel / plain f32: "
            + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in errs.items())
            + "; kernel vs plain f32: " + ", ".join(
                f"{nm} {rel_rmse(a, b):.3e}"
                for nm, a, b in zip(names, out_k, out_32)))
        for nm, a in zip(names, out_k):
            require(bool(torch.isfinite(a).all()), f"pair HVP {kind} {nm} "
                    "not finite")
        for nm, (err_k, err_32, ok) in errs.items():
            require(ok, f"pair HVP {kind} {nm} {err_k} (plain f32 {err_32})")
        if kind == "pol":
            record["pair_hvp"]["max_abs_err"] = max(
                float((a - b).abs().max()) for a, b in zip(out_k, out_32))
            record["_hvp_inputs"] = (x, ct, cs, lmax)


def spread_inputs(w):
    """The energy mesh's stencil values (order 6, one channel)."""
    from admp_tpu_torch.ops.reciprocal import atom_spread_alpha, spread_points_separable

    m_u0, u0, alpha = atom_spread_alpha(w["positions"], w["box"],
                                        w["q_local"], w["grid"], LMAX, 6)
    q = spread_points_separable(u0, alpha, LMAX, 6)
    return m_u0.contiguous(), q.reshape(q.shape[0], 1, 216).contiguous()


def check_spread(w, record):
    from admp_tpu_torch.ops.cuda import spread as S

    grid = w["grid"]
    m_u0, q = spread_inputs(w)
    mesh_k = S.launch_spread(m_u0, q, grid, 6)
    mesh_p = S.spread_torch(m_u0, q, grid, 6)
    torch.cuda.synchronize()
    err = float((mesh_k - mesh_p).abs().max())
    scale = float(mesh_p.abs().max())
    log(f"spread order 6 N={m_u0.shape[0]} grid={grid}: max abs err {err:.3e}"
        f" = {err / scale:.3e} x max|mesh|")
    require(err <= TOL_SPREAD * scale, f"spread {err / scale}")
    rng = np.random.default_rng(4)
    g_mesh = torch.tensor(rng.standard_normal((1, *grid)), device=q.device,
                          dtype=torch.float32)
    out_k = S.launch_gather(m_u0, g_mesh, grid, 6)
    out_p = S.gather_torch(m_u0, g_mesh, grid, 6)
    torch.cuda.synchronize()
    gerr = float((out_k - out_p).abs().max())
    log(f"gather order 6: bitwise equal {bool(torch.equal(out_k, out_p))}")
    require(torch.equal(out_k, out_p), "gather differs from plain gather")
    record["spread"]["max_abs_err"] = err
    record["gather"]["max_abs_err"] = gerr
    record["_spread_inputs"] = (m_u0, q, g_mesh)


# ---------------------------------------------------------------------------
# phase 3/4: the main path
# ---------------------------------------------------------------------------


def run_steps(force, w, positions, n_steps, dtype=torch.float32):
    """n_steps warm-started steps with drift, consuming the forces; returns
    the final positions and per-step (energy, n_iter, converged)."""
    out = []
    p = positions
    for _ in range(n_steps):
        e, g = force.get_forces(*pol_args(w, p, dtype))
        p = p + w["drift"] + 0.0 * g
        out.append((e, force.n_cycle, force.lconverg))
    return p, out


def main_path(w, record):
    dev = w["positions"].device
    force = make_force(w, True, dev, torch.float32, "auto")
    fixed = make_force(w, False, dev, torch.float32, "auto")
    log(f"grid {force.K1, force.K2, force.K3}, matvec grid "
        f"{force.matvec_grid}, kappa {force.kappa:.6f}, pairs "
        f"{w['pairs'].shape[0]}")
    reset_counts()
    e0, g0 = force.get_forces(*pol_args(w, w["positions"], torch.float32))
    cold = (force.n_cycle, force.lconverg)
    u_cold = force.U_ind
    _, steps = run_steps(force, w, w["positions"], N_STEPS)
    e_fix, g_fix = fixed.get_forces(w["positions"], w["box"], w["pairs"],
                                    w["q_local"], w["scales"])
    launches = read_counts()
    log(f"launches on the main path: {launches}")
    log(f"cold step: E {float(e0):.6f} kJ/mol, {cold[0]} PCG iterations, "
        f"converged {cold[1]}")
    log("warm steps: iterations " + str([s[1] for s in steps])
        + ", energies " + str([round(float(s[0]), 4) for s in steps]))
    log(f"fixed-multipole step: E {float(e_fix):.6f} kJ/mol")
    require(all(launches[k] > 0 for k in ("pair_fwd", "pair_bwd", "spread",
                                          "gather")),
            "a kernel never launched")
    require(cold[1] and all(s[2] for s in steps), "SCF did not converge")
    require(cold[0] <= 10, f"cold iterations {cold[0]} > 10")
    require(all(s[1] <= 3 for s in steps), "warm iterations > 3")
    require(all(bool(torch.isfinite(s[0])) for s in steps)
            and bool(torch.isfinite(e0)) and bool(torch.isfinite(e_fix)),
            "non-finite energy")
    require(bool(torch.isfinite(g0).all()) and bool(torch.isfinite(g_fix).all())
            and tuple(g0.shape) == tuple(w["positions"].shape),
            "forces not finite or of the wrong shape")
    for k in ("pair_fwd", "pair_bwd", "spread", "gather"):
        record[k]["launches"] = launches[k]

    # the first step against the plain path, f32 and f64, on the card
    plain32 = make_force(w, True, dev, torch.float32, "torch")
    e_p, g_p = plain32.get_forces(*pol_args(w, w["positions"], torch.float32))
    plain64 = make_force(w, True, dev, torch.float64, "torch")
    e_64, g_64 = plain64.get_forces(*pol_args(w, w["positions"],
                                              torch.float64))
    de = abs(float(e0) - float(e_p)) / abs(float(e_p))
    df = rel_rmse(g0, g_p)
    df64 = rel_rmse(g0, g_64)
    du64 = rel_rmse(u_cold, plain64.U_ind)
    log(f"first step kernel f32 vs plain f32: energy rel {de:.3e}, force rel "
        f"RMSE {df:.3e}, iterations {cold[0]} vs {plain32.n_cycle}")
    log(f"first step kernel f32 vs plain f64: energy {float(e0):.6f} vs "
        f"{float(e_64):.6f}, force rel RMSE {df64:.3e}, U_ind rel RMSE "
        f"{du64:.3e}, iterations {cold[0]} vs {plain64.n_cycle}")
    require(de < TOL_STEP_E, f"kernel vs plain f32 energy {de}")
    require(df < TOL_STEP_F, f"kernel vs plain f32 forces {df}")
    require(df64 < TOL_F64, f"kernel f32 vs plain f64 forces {df64}")
    return force, plain32


def reset_counts():
    from admp_tpu_torch.ops.cuda import pairs as P, spread as S

    for c in (P.launch_pair_fwd, P.launch_pair_bwd, P.launch_pair_hvp,
              S.launch_spread, S.launch_gather):
        c.launches = 0
    P.launch_pair_hvp.by_kind = dict.fromkeys(P.KINDS, 0)


def read_counts():
    from admp_tpu_torch.ops.cuda import pairs as P, spread as S

    torch.cuda.synchronize()
    return {"pair_fwd": P.launch_pair_fwd.launches,
            "pair_bwd": P.launch_pair_bwd.launches,
            "pair_hvp": P.launch_pair_hvp.launches,
            "spread": S.launch_spread.launches,
            "gather": S.launch_gather.launches,
            "pair_hvp_by_kind": dict(P.launch_pair_hvp.by_kind)}


def adjoint_path(w, record):
    """Phases 3b and 3c: the exact-adjoint step (default SCFConfig()) and
    the parameter gradients, on the kernels and against the plain path."""
    from admp_tpu_torch import SCFConfig

    dev = w["positions"].device
    scf = SCFConfig()
    force = make_force(w, True, dev, torch.float32, "auto", scf=scf)
    log(f"exact adjoint: {scf}; matvec grid {force.matvec_grid}")
    reset_counts()
    e0, g0 = force.get_forces(*pol_args(w, w["positions"], torch.float32))
    cold = (force.n_cycle, force.lconverg)
    _, steps = run_steps(force, w, w["positions"], N_STEPS)
    counts = read_counts()
    log(f"phase 3b launches: {counts}")
    log(f"exact adjoint cold step: E {float(e0):.6f} kJ/mol, {cold[0]} PCG "
        f"iterations, converged {cold[1]}; warm iterations "
        f"{[s[1] for s in steps]}")
    require(all(counts[k] > 0 for k in ("pair_fwd", "pair_bwd", "pair_hvp",
                                        "spread", "gather")),
            "a kernel never launched on the exact-adjoint path")
    require(counts["pair_hvp_by_kind"]["pol"] > 0
            and counts["pair_hvp_by_kind"]["uu"] > 0,
            "K3 did not run for both pol and uu")
    require(cold[1] and all(s[2] for s in steps), "SCF did not converge")
    require(all(bool(torch.isfinite(s[0])) for s in steps)
            and bool(torch.isfinite(e0)) and bool(torch.isfinite(g0).all())
            and tuple(g0.shape) == tuple(w["positions"].shape),
            "exact adjoint: non-finite energy or forces")
    record["pair_hvp"]["launches"] = counts["pair_hvp"]

    plain32 = make_force(w, True, dev, torch.float32, "torch", scf=scf)
    e_p, g_p = plain32.get_forces(*pol_args(w, w["positions"], torch.float32))
    plain64 = make_force(w, True, dev, torch.float64, "torch", scf=scf)
    e_64, g_64 = plain64.get_forces(*pol_args(w, w["positions"],
                                              torch.float64))
    de = abs(float(e0) - float(e_p)) / abs(float(e_p))
    df, df64 = rel_rmse(g0, g_p), rel_rmse(g0, g_64)
    log(f"exact adjoint first step: kernel f32 vs plain f32 energy rel "
        f"{de:.3e}, force rel RMSE {df:.3e} (iterations {cold[0]} vs "
        f"{plain32.n_cycle}); vs plain f64 force rel RMSE {df64:.3e}, plain "
        f"f32 vs f64 {rel_rmse(g_p, g_64):.3e}")
    require(de < TOL_STEP_E, f"exact adjoint energy {de}")
    require(df < TOL_ADJ_F, f"exact adjoint forces vs plain f32 {df}")
    require(df64 < TOL_F64, f"exact adjoint forces vs plain f64 {df64}")

    # 3c: dE/d(Q_local, pol, tholes) through get_energy, cold-started
    names = ("Q_local", "pol", "tholes")
    grads = {}
    for name, f in (("kernel", force), ("plain32", plain32),
                    ("plain64", plain64)):
        dtype = torch.float64 if name == "plain64" else torch.float32
        args = list(pol_args(w, w["positions"], dtype))
        params = [args[k].clone().requires_grad_(True) for k in (3, 4, 5)]
        args[3:6] = params
        u0 = torch.zeros_like(w["positions"], dtype=dtype)
        energy = f.get_energy(*args, U_init=u0)
        grads[name] = torch.autograd.grad(energy, params)
    for k, nm in enumerate(names):
        g_k, g_32, g_ref = (grads[n][k] for n in ("kernel", "plain32",
                                                  "plain64"))
        err_k, err_32 = rel_rmse(g_k, g_ref), rel_rmse(g_32, g_ref)
        log(f"dE/d{nm}: kernel f32 vs plain f64 rel RMSE {err_k:.3e}, plain "
            f"f32 vs plain f64 {err_32:.3e}")
        require(bool(torch.isfinite(g_k).all()), f"dE/d{nm} not finite")
        require(err_k <= 2 * err_32 + 1e-6, f"dE/d{nm} {err_k} > 2 x {err_32}")
    return force, plain32


def fitting_path(w, record):
    """Phase 3d: fitting.fit on two losses, kernel path against plain f32;
    returns the per-step times (ms) of each run."""
    from admp_tpu_torch import SCFConfig, energy_force_loss, fit, stack_batch
    from admp_tpu_torch.fitting import adam

    dev = w["positions"].device
    pos, drift = w["positions"], w["drift"]
    configs = [pos + drift, pos + 2 * drift]
    sc = w["scales"]
    ref64 = make_force(w, True, dev, torch.float64, "torch", scf=SCFConfig())
    e_ref = [float(ref64.get_energy(
        *pol_args(w, p, torch.float64),
        U_init=torch.zeros_like(p, dtype=torch.float64)).detach())
             for p in configs]
    fixed64 = make_force(w, False, dev, torch.float64, "torch")
    targets = []
    for p in configs:
        e, g = fixed64.get_forces(p.double(), w["box"].double(), w["pairs"],
                                  w["q_local"].double(), sc.double())
        targets.append((p, w["box"], w["pairs"], e.float(), -g.float()))
    fixed_batch = stack_batch(targets)
    true = {"q": w["q_local"], "pol": w["pol"], "tholes": w["tholes"]}

    def run(method):
        pol_force = make_force(w, True, dev, torch.float32, method,
                               scf=SCFConfig())
        fixed_force = make_force(w, False, dev, torch.float32, method)

        def energy_loss(params, batch):
            return torch.mean(torch.stack([
                (pol_force.get_energy(p, w["box"], w["pairs"], params["q"],
                                      params["pol"], params["tholes"], sc,
                                      sc, sc) - e) ** 2 for p, e in batch]))

        def potential(positions, box, pairs, params):
            return fixed_force.get_energy(positions, box, pairs, params["q"],
                                          sc)

        start = {k: 1.05 * v for k, v in true.items()}
        r_pol = fit(energy_loss, start, [list(zip(configs, e_ref))]
                    * N_FIT_STEPS, optimizer=adam(FIT_LR), log_every=0)
        r_fix = fit(energy_force_loss(potential), {"q": start["q"]},
                    [fixed_batch] * N_FIT_STEPS, optimizer=adam(FIT_LR),
                    log_every=0)
        return r_pol, r_fix

    reset_counts()
    runs = {"kernel": run("auto")}
    counts = read_counts()
    runs["plain32"] = run("torch")
    log(f"phase 3d launches (kernel run): {counts}")
    require(counts["pair_hvp_by_kind"]["perm"] > 0, "K3 did not run for perm")
    require(all(counts[k] > 0 for k in ("pair_fwd", "pair_bwd", "pair_hvp",
                                        "spread", "gather")),
            "a kernel never launched on the fitting path")
    record["pair_hvp"]["launches"] += counts["pair_hvp"]
    times = {}
    for k, label in enumerate(("energy matching, polarizable exact adjoint",
                               "energy_force_loss, fixed multipoles")):
        lk = [h["loss"] for h in runs["kernel"][k].history]
        lp = [h["loss"] for h in runs["plain32"][k].history]
        times[label] = {m: [1e3 * h["dt"] for h in runs[m][k].history]
                        for m in runs}
        log(f"fit ({label}): kernel losses {lk}, plain f32 losses {lp}")
        require(all(np.isfinite(lk)) and all(np.isfinite(lp)),
                f"fit {label}: non-finite loss")
        require(lk[-1] < lk[0], f"fit {label}: the loss did not fall")
        require(all(abs(a - b) <= TOL_FIT * abs(b) for a, b in zip(lk, lp)),
                f"fit {label}: kernel and plain losses differ")
    return times


def time_steps(force, w, dtype=torch.float32):
    """Median ms/step over N_REPEATS runs of N_STEPS warm steps, CUDA events
    around each run (the runs end in a synchronize)."""
    run_steps(force, w, w["positions"], 2, dtype)  # warm-up
    times, iters = [], []
    for _ in range(N_REPEATS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        _, out = run_steps(force, w, w["positions"], N_STEPS, dtype)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / N_STEPS)
        iters += [s[1] for s in out]
    return statistics.median(times), times, iters


def profile_steps(force, w, n_steps=3):
    """Device busy share and the top device kernels over n_steps warm steps
    (torch.profiler); the table goes to chiprun_out/chip_smoke/."""
    from torch.profiler import ProfilerActivity, profile

    run_steps(force, w, w["positions"], 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(force, w, w["positions"], n_steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / n_steps
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=25)
    (OUT_DIR / "profile.txt").write_text(table)
    top = sorted(prof.key_averages(), key=lambda a: -a.device_time_total)
    top = [a for a in top if a.device_time_total > 0][:8]
    return wall, device_ms, len(events) / n_steps, [
        (a.key[:60], a.device_time_total / 1e3 / n_steps, a.count // n_steps)
        for a in top]


def time_kernels(record):
    from admp_tpu_torch.ops.cuda import pairs as P, spread as S

    g_i, g_j, scl, scal, lmax, ct = record.pop("_pair_inputs")
    leaves = [t.clone().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
    e = (P.pair_energies_torch(*leaves, lmax, "pol") * ct).sum()
    m_u0, q, g_mesh = record.pop("_spread_inputs")
    grid = tuple(g_mesh.shape[1:])
    x, hct, cs, hl = record.pop("_hvp_inputs")
    calls = {
        "pair_fwd": (
            lambda: P.launch_pair_fwd(g_i, g_j, scl, scal, lmax, "pol"),
            lambda: P.pair_energies_torch(g_i, g_j, scl, scal, lmax, "pol")),
        "pair_bwd": (
            lambda: P.launch_pair_bwd(g_i, g_j, scl, scal, ct, lmax, "pol"),
            lambda: torch.autograd.grad(e, leaves, retain_graph=True)),
        "pair_hvp": (
            lambda: P.launch_pair_hvp(*x, hct, *cs, hl, "pol"),
            lambda: P.pair_hvp_torch(*x, hct, *cs, hl, "pol")),
        "spread": (lambda: S.launch_spread(m_u0, q, grid, 6),
                   lambda: S.spread_torch(m_u0, q, grid, 6)),
        "gather": (lambda: S.launch_gather(m_u0, g_mesh, grid, 6),
                   lambda: S.gather_torch(m_u0, g_mesh, grid, 6)),
    }
    for name, (kernel, plain) in calls.items():
        r = record[name]
        r["ms"], r["device_ms"] = cuda_time_ms(kernel)
        r["plain_ms"], r["plain_device_ms"] = cuda_time_ms(plain)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from admp_tpu_torch.ops.cuda import build

    dev = torch.device("cuda:0")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = build.build()
    log(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, text in logs.items():
        (OUT_DIR / f"ptxas_{name}.log").write_text(text)
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    record = {
        "pair_fwd": dict(source="admp_tpu_torch/csrc/pairs.cu",
                         replaces="admp_tpu/ops/pallas/pairs.py:330"),
        "pair_bwd": dict(source="admp_tpu_torch/csrc/pairs.cu",
                         replaces="admp_tpu/ops/pallas/pairs.py:343"),
        "pair_hvp": dict(source="admp_tpu_torch/csrc/pair_hvp.cu",
                         replaces="admp_tpu/ops/pallas/pairs.py:445"),
        "spread": dict(source="admp_tpu_torch/csrc/spread.cu",
                       replaces="admp_tpu/ops/pallas/spread.py:210"),
        "gather": dict(source="admp_tpu_torch/csrc/spread.cu",
                       replaces="admp_tpu/ops/pallas/spread.py:890"),
    }
    t0 = time.perf_counter()
    w = build_workload(dev)
    log(f"workload: {w['positions'].shape[0]} atoms, "
        f"{w['pairs'].shape[0]} pair slots, built in "
        f"{time.perf_counter() - t0:.1f} s")
    check_pairs(w, record)
    check_hvp(w, record)
    check_spread(w, record)
    log("phase 2: every kernel agrees with its plain version")

    force, plain32 = main_path(w, record)
    log("phase 3: main path ok")
    adj, adj_plain = adjoint_path(w, record)
    log("phases 3b, 3c: exact-adjoint path and parameter gradients ok")
    fit_times = fitting_path(w, record)
    log("phase 3d: trainer ok")

    ms, times, iters = time_steps(force, w)
    ms_plain, times_plain, _ = time_steps(plain32, w)
    # the same steps with a fixed PCG count: no host read of the residual
    fixed3 = make_force(w, True, dev, torch.float32, "auto", fixed_iters=3)
    fixed3.U_ind = force.U_ind
    ms_fixed, times_fixed, _ = time_steps(fixed3, w)
    syncs = statistics.mean(iters) + 1
    log(f"phase 4 [{card}]: kernel path {ms:.3f} ms/step (median of "
        f"{N_REPEATS} x {N_STEPS} steps: {[round(t, 3) for t in times]}), "
        f"plain path {ms_plain:.3f} ms/step ({[round(t, 3) for t in times_plain]});"
        f" warm PCG iterations {sorted(set(iters))}, mean host syncs/step "
        f"in the PCG loop {syncs:.2f}; kernel path with fixed_iters=3 (no "
        f"sync in the loop) {ms_fixed:.3f} ms/step "
        f"({[round(t, 3) for t in times_fixed]})")
    ms_adj, times_adj, iters_adj = time_steps(adj, w)
    ms_adj_plain, times_adj_plain, _ = time_steps(adj_plain, w)
    log(f"phase 4 [{card}]: exact-adjoint step (SCFConfig()): kernel path "
        f"{ms_adj:.3f} ms/step ({[round(t, 3) for t in times_adj]}), plain "
        f"path {ms_adj_plain:.3f} ms/step "
        f"({[round(t, 3) for t in times_adj_plain]}); warm PCG iterations "
        f"{sorted(set(iters_adj))}")
    for label, t in fit_times.items():
        log(f"phase 4 [{card}]: fit step ({label}): kernel "
            f"{statistics.median(t['kernel'][1:]):.3f} ms/step "
            f"({[round(v, 3) for v in t['kernel']]}), plain f32 "
            f"{statistics.median(t['plain32'][1:]):.3f} ms/step "
            f"({[round(v, 3) for v in t['plain32']]}); the first step "
            "includes the cold SCF")
    wall, device_ms, n_kernels, top = profile_steps(force, w)
    log(f"profile (3 warm steps, profiler on): {wall:.3f} ms/step wall, "
        f"{device_ms:.3f} ms/step device busy ({100 * device_ms / wall:.1f}%),"
        f" {n_kernels:.0f} device kernels/step; top by device time:")
    for key, ms_k, count in top:
        log(f"  {ms_k:8.4f} ms/step  x{count:<4d} {key}")
    time_kernels(record)
    for name, r in record.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms/call ({r['device_ms']:.4f} ms "
            f"device), plain {r['plain_ms']:.4f} ms/call "
            f"({r['plain_device_ms']:.4f} ms device)")

    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=r["launches"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"])
               for name, r in record.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
