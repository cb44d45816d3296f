"""Run the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase failure is caught):
  0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no CUDA device -> exit 1 before anything is printed as a result;
  1. build the seven CUDA kernels (four libraries) from admp_tpu_torch/csrc
     into admp_tpu_torch/_build (nvcc, one process per source, concurrently);
  2. each kernel against its plain PyTorch version at the main path's shapes
     (the pair HVP K3 for kinds pol, uu and perm, every output), and the
     tiled spread and gather (K5, K7) at the 98k-atom shapes: (order 6, C=1)
     at 320^3 and 256^3 on the step's stencils, (4, 3) at 320^3 on random
     ones, and K5 on one crowded tile (more atoms than its stage holds) at
     (6, 1) and (4, 3), each K5 mesh the same on a second launch; K6 also on
     stencil rows that wrap at K3;
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
  3e. the full force field (bench.py's build_nonpol_workload): multipolar
     PME (lmax 2, non-polarizable, K=128^3, kappa pinned) + dispersion PME
     (pmax 10, disp_ethresh 2e-4, order-4 three-channel spread, K=128^3) +
     Tang-Toennies over cell-list pairs; one cold step and 10 drift steps,
     launch counts per (order, C); the first step and dE/dc_list against the
     plain path in f32 and f64; 2 fitting.fit steps of energy_force_loss
     over c_list against plain f32;
  3f. the large system (examples/fluctuating_multipoles.py --n-side 32):
     98,304 atoms, sparse exclusions, cell-list pairs, fixed multipoles that
     follow each water's O-H stretches (forces through Q_local too), the
     5-smooth 320^3 grid; one cold step and 10 drift steps on 'auto' (K5/K7
     and K1/K2 perm 11 launches each, K4/K6 none); the first step against
     the plain path in f32 and f64, again at --k 256, and under
     spread_method='cuda' (K4/K6);
  4. timing: ms/step of the MD step (median of 3 x 10 steps, CUDA events), of
     the exact-adjoint step and of the full-force-field step, ms per fitting
     step, ms/step of the 98k step on K5/K7, on K4/K6 and plain at 320^3 and
     256^3 (median of 3 x 5 steps), one profiler window each of the MD,
     full-force-field and 98k steps, and each kernel beside its plain
     version, its bound on the card and, where one exists, the one PyTorch
     call that computes the same function (at the 98k shapes too), and the
     host us per call of K6's and K5's launchers.

    python3 chip_smoke.py --launchers DIR

prints only that last line, for the admp_tpu_torch in DIR (another commit's
checkout), so that two launchers compare in one run on the card, and

    python3 chip_smoke.py --kernels DIR

only the device times of K5 and K6 built from this tree's sources and from
DIR's, on the same inputs in one process.
Phase 2 also holds the three-channel spread and gather (K4, K6 at C=3) on the
dispersion stencil at orders 4 and 6.
Each path's launch counts are set to 0 just before it runs and read just
after. The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Long logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import ctypes
import functools
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

# the full force field of bench.py's build_nonpol_workload
KAPPA_FF, K_FF = 0.657065221219616, 128
PMAX, DISP_ETHRESH, DISP_ORDER = 10, 2e-4, 4
N_FF_FIT_STEPS = 2
# Adam's step on c_list (entries 7-134, started 5% off): large enough that
# the force-matching loss falls in f32
FF_FIT_LR = 0.1

# the large system of examples/fluctuating_multipoles.py --n-side 32: its
# charge-transfer response (e / A) to O-H stretches about r0 (A), the
# example's --k grid
N98_SIDE, N98_JITTER = 32, 0.1
R0_OH, COUPLING = 0.9572, 0.4
K98, K98_ALT = 320, 256
# K5's crowded case: atoms in one tile, ~40 times what its stage holds
N_CROWD = 2000
N98_TIME_STEPS = 5
# its first step, kernel f32 against plain f32 and f64. Energy: |dE| over
# the largest of its terms (the total is a small residue of ~3e7 kJ/mol
# terms), against f64 within max(TOL_E98, 2 x the plain f32 path's own),
# since the f32 floor is ~1e-6 there (f32 mesh coordinates at 320 points
# per axis; the plain f32 path sits at 1.02e-6). Forces: against plain f32
# within TOL_STEP_F98, a fraction of the 4.9e-4 f32 floor against f64 that
# two f32 summation orders differ by at this size (1.16e-4 measured)
TOL_E98 = 1e-6
TOL_STEP_F98 = 2e-4

# the card's published peaks (H100 SXM, at the full 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


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


def cuda_time_ms(fn, n=None, warmup=3):
    """(ms per call on the card's timeline between CUDA events over n
    back-to-back calls, which includes any host enqueue gap; ms per call of
    device kernel time alone, from torch.profiler). n defaults to 200 for a
    call that takes under 50 us with its synchronize (its time is mostly the
    host's, which varies), else 20. A profile that caught no kernel is taken
    again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if n is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        n = 200 if time.perf_counter() - t0 < 5e-5 else 20
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    device_us = 0.0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        if device_us > 0:
            break
    return start.elapsed_time(stop) / n, device_us / 1e3 / n


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------


def build_workload(device):
    """The bench.py polarizable workload (build_pol_workload) in the port,
    with the full force field's dispersion coefficients and cell-list pairs
    (build_nonpol_workload) on the same box."""
    from admp_tpu_torch import convert_cart2harm, neighbor_list_cell, neighbor_list_dense
    from admp_tpu_torch import water_system
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
    cell = neighbor_list_cell(positions, box, RC)
    require(not bool(cell.did_overflow) and cell.i_sorted,
            "cell list overflow or not i-sorted")
    return dict(sys=s, positions=positions, box=box, pairs=nl.pairs,
                q_local=q_local, pol=torch.tensor(s["pol"], **f32),
                tholes=torch.tensor(s["tholes"], **f32),
                scales=torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], **f32),
                drift=drift, grid=(k1, k2, K3),
                c_list=torch.tensor(s["c_list"], **f32), ff_pairs=cell.pairs)


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
    # every third atom moved to the last z plane: its stencil rows wrap at K3
    m_wrap = m_u0.clone()
    m_wrap[::3, 2] = grid[2] - 1
    wrap_k = S.launch_gather(m_wrap, g_mesh, grid, 6)
    wrap_p = S.gather_torch(m_wrap, g_mesh, grid, 6)
    torch.cuda.synchronize()
    gerr = float((out_k - out_p).abs().max())
    log(f"gather order 6: bitwise equal {bool(torch.equal(out_k, out_p))}, "
        f"on rows that wrap at K3 {bool(torch.equal(wrap_k, wrap_p))}")
    require(torch.equal(out_k, out_p), "gather differs from plain gather")
    require(torch.equal(wrap_k, wrap_p),
            "gather differs from plain gather on rows that wrap at K3")
    record["spread"]["max_abs_err"] = err
    record["gather"]["max_abs_err"] = gerr
    record["_spread_inputs"] = (m_u0, q, g_mesh)


def disp_stencil(w, order):
    """The dispersion mesh's stencil values (C=3) of the 3000-atom box on
    the (128, 128, 128) grid, as ADMPDispPmeForce builds them."""
    from admp_tpu_torch.ops.reciprocal import multi_stencil

    m_u0, q = multi_stencil(w["positions"], w["box"], w["c_list"],
                            (K_FF,) * 3, order)
    return m_u0.contiguous(), q.contiguous()


def check_spread_c3(w, record):
    """K4 and K6 at C=3 on the dispersion stencil, orders 4 and 6."""
    from admp_tpu_torch.ops.cuda import spread as S

    grid = (K_FF,) * 3
    for order in (4, 6):
        m_u0, q = disp_stencil(w, order)
        mesh_k = S.launch_spread(m_u0, q, grid, order)
        mesh_p = S.spread_torch(m_u0, q, grid, order)
        torch.cuda.synchronize()
        err = float((mesh_k - mesh_p).abs().max())
        scale = float(mesh_p.abs().max())
        rng = np.random.default_rng(6)
        g_mesh = torch.tensor(rng.standard_normal((3, *grid)), device=q.device,
                              dtype=torch.float32)
        out_k = S.launch_gather(m_u0, g_mesh, grid, order)
        out_p = S.gather_torch(m_u0, g_mesh, grid, order)
        torch.cuda.synchronize()
        same = bool(torch.equal(out_k, out_p))
        log(f"spread C=3 order {order} N={m_u0.shape[0]} grid={grid}: max abs "
            f"err {err:.3e} = {err / scale:.3e} x max|mesh|; gather bitwise "
            f"equal {same}")
        require(err <= TOL_SPREAD * scale, f"spread C=3 order {order} "
                f"{err / scale}")
        require(same, f"gather C=3 order {order} differs from plain gather")
        if order == DISP_ORDER:
            record["spread_c3"]["max_abs_err"] = err
            record["gather_c3"]["max_abs_err"] = float(
                (out_k - out_p).abs().max())
            record["_spread_c3_inputs"] = (m_u0, q, g_mesh, order)


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
              S.launch_spread, S.launch_gather, S.launch_spread_tiled,
              S.launch_gather_tiled):
        c.launches = 0
    P.launch_pair_hvp.by_kind = dict.fromkeys(P.KINDS, 0)
    for c in (S.launch_spread, S.launch_gather, S.launch_spread_tiled,
              S.launch_gather_tiled):
        c.by_shape = dict.fromkeys(S.SHAPES, 0)


def read_counts():
    from admp_tpu_torch.ops.cuda import pairs as P, spread as S

    torch.cuda.synchronize()
    return {"pair_fwd": P.launch_pair_fwd.launches,
            "pair_bwd": P.launch_pair_bwd.launches,
            "pair_hvp": P.launch_pair_hvp.launches,
            "spread": S.launch_spread.launches,
            "gather": S.launch_gather.launches,
            "pair_hvp_by_kind": dict(P.launch_pair_hvp.by_kind),
            "spread_by_shape": dict(S.launch_spread.by_shape),
            "gather_by_shape": dict(S.launch_gather.by_shape),
            "spread_tiled_by_shape": dict(S.launch_spread_tiled.by_shape),
            "gather_tiled_by_shape": dict(S.launch_gather_tiled.by_shape)}


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


def make_ff(w, device, dtype, method):
    """The full force field of bench.py's build_nonpol_workload in the port:
    (total(positions, c_list) -> energy, the dispersion force)."""
    from admp_tpu_torch import (
        ADMPDispPmeForce,
        ADMPPmeForce,
        EngineConfig,
        generate_pairwise_interaction,
        tt_damping_qq_c6_kernel,
    )

    s = w["sys"]
    pme = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                       s["covalent_map"], RC, ETHRESH, lmax=LMAX,
                       config=EngineConfig(cache_influence=True,
                                           pair_kernel=method,
                                           spread_method=method),
                       device=device, dtype=dtype)
    disp = ADMPDispPmeForce(s["box"], s["covalent_map"], RC, ETHRESH, PMAX,
                            config=EngineConfig(disp_ethresh=DISP_ETHRESH,
                                                disp_spread_order=DISP_ORDER,
                                                cache_influence=True,
                                                spread_method=method),
                            device=device, dtype=dtype)
    for f in (pme, disp):
        f.kappa = KAPPA_FF
        f.K1 = f.K2 = f.K3 = K_FF
        f.refresh_calculators()
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                       s["covalent_map"], device=device)
    c = lambda x: torch.as_tensor(x, device=device, dtype=dtype)  # noqa: E731
    box, q_local, sc = c(w["box"]), c(w["q_local"]), c(w["scales"])
    tt_a, tt_b, tt_q = c(s["tt_a"]), c(s["tt_b"]), c(s["tt_q"])
    pairs = w["ff_pairs"]

    def total(positions, c_list):
        e = pme.get_energy(positions, box, pairs, q_local, sc)
        e = e + disp.get_energy(positions, box, pairs, c_list, sc)
        return e + tt(positions, box, pairs, sc, tt_a, tt_b, tt_q,
                      c_list[:, 0])

    return total, disp


def ff_step(total, positions, c_list):
    pos = positions.detach().requires_grad_(True)
    with torch.enable_grad():
        e = total(pos, c_list)
        (g,) = torch.autograd.grad(e, pos)
    return e.detach(), g


def run_ff(total, w, n_steps, dtype=torch.float32):
    """n_steps full-force-field steps with drift, consuming the forces."""
    p, c_list = w["positions"].to(dtype), w["c_list"].to(dtype)
    energies = []
    for _ in range(n_steps):
        e, g = ff_step(total, p, c_list)
        p = p + w["drift"].to(dtype) + 0.0 * g
        energies.append(e)
    return energies


def ff_path(w, record):
    """Phase 3e: the full force field on the kernels and against the plain
    path; returns the kernel and plain f32 step functions."""
    from admp_tpu_torch import energy_force_loss, fit
    from admp_tpu_torch.fitting import adam

    dev = w["positions"].device
    kern, disp = make_ff(w, dev, torch.float32, "auto")
    log(f"full force field: electrostatic and dispersion grid {(K_FF,) * 3}, "
        f"kappa {KAPPA_FF}, dispersion heuristic grid of disp_ethresh "
        f"{DISP_ETHRESH} overridden, pmax {PMAX} (reciprocal channels "
        f"{disp._pmax_recip}), spread order {DISP_ORDER}, pairs "
        f"{w['ff_pairs'].shape[0]} (cell list)")
    reset_counts()
    energies = run_ff(kern, w, 1 + N_STEPS)
    counts = read_counts()
    log(f"phase 3e launches: {counts}")
    log("full force field steps: energies "
        + str([round(float(e), 4) for e in energies]))
    c3 = (DISP_ORDER, 3)
    require(counts["spread_by_shape"][c3] > 0
            and counts["gather_by_shape"][c3] > 0,
            "the C=3 spread or gather never launched")
    require(counts["spread_by_shape"][6, 1] > 0
            and counts["gather_by_shape"][6, 1] > 0
            and counts["pair_fwd"] > 0 and counts["pair_bwd"] > 0,
            "an electrostatic kernel never launched")
    require(all(bool(torch.isfinite(e)) for e in energies),
            "full force field: non-finite energy")
    record["spread_c3"]["launches"] = counts["spread_by_shape"][c3]
    record["gather_c3"]["launches"] = counts["gather_by_shape"][c3]

    plain32, _ = make_ff(w, dev, torch.float32, "torch")
    plain64, _ = make_ff(w, dev, torch.float64, "torch")
    c32, c64 = w["c_list"], w["c_list"].double()
    e0, g0 = ff_step(kern, w["positions"], c32)
    e_p, g_p = ff_step(plain32, w["positions"], c32)
    e_64, g_64 = ff_step(plain64, w["positions"].double(), c64)
    require(bool(torch.isfinite(g0).all())
            and tuple(g0.shape) == tuple(w["positions"].shape),
            "full force field: forces not finite or of the wrong shape")
    de = abs(float(e0) - float(e_p)) / abs(float(e_p))
    df, df64 = rel_rmse(g0, g_p), rel_rmse(g0, g_64)
    log(f"full force field first step: E {float(e0):.6f} (kernel f32), "
        f"{float(e_p):.6f} (plain f32), {float(e_64):.6f} (plain f64) kJ/mol;"
        f" kernel vs plain f32 energy rel {de:.3e}, force rel RMSE {df:.3e};"
        f" vs plain f64 force rel RMSE {df64:.3e}, plain f32 vs f64 "
        f"{rel_rmse(g_p, g_64):.3e}")
    require(de < TOL_STEP_E, f"full force field energy {de}")
    require(df < TOL_STEP_F, f"full force field forces vs plain f32 {df}")
    require(df64 < TOL_F64, f"full force field forces vs plain f64 {df64}")

    grads = {}
    for name, total, c0 in (("kernel", kern, c32), ("plain32", plain32, c32),
                            ("plain64", plain64, c64)):
        c_req = c0.clone().requires_grad_(True)
        pos = w["positions"].to(c0.dtype)
        (grads[name],) = torch.autograd.grad(total(pos, c_req), c_req)
    err_k = rel_rmse(grads["kernel"], grads["plain64"])
    err_32 = rel_rmse(grads["plain32"], grads["plain64"])
    log(f"dE/dc_list: kernel f32 vs plain f64 rel RMSE {err_k:.3e}, plain f32 "
        f"vs plain f64 {err_32:.3e}")
    require(bool(torch.isfinite(grads["kernel"]).all()), "dE/dc_list not finite")
    require(err_k <= 2 * err_32 + 1e-6, f"dE/dc_list {err_k} > 2 x {err_32}")

    # force matching over c_list: targets from the plain f64 path at a
    # drifted configuration, the fit started 5% off
    p1 = w["positions"] + w["drift"]
    e_t, g_t = ff_step(plain64, p1.double(), c64)
    batch = [(p1, w["box"], w["ff_pairs"], e_t.float(), -g_t.float())]
    runs = {}
    for name, total in (("kernel", kern), ("plain32", plain32)):
        loss = energy_force_loss(
            lambda pos, box, pairs, params, total=total: total(pos,
                                                               params["c"]))
        if name == "kernel":
            reset_counts()
        runs[name] = fit(loss, {"c": 1.05 * c32}, [batch] * N_FF_FIT_STEPS,
                         optimizer=adam(FF_FIT_LR), log_every=0)
        if name == "kernel":
            fit_counts = read_counts()
    lk = [h["loss"] for h in runs["kernel"].history]
    lp = [h["loss"] for h in runs["plain32"].history]
    log(f"phase 3e fit launches (kernel run): {fit_counts}")
    log(f"fit (energy_force_loss over c_list): kernel losses {lk}, plain f32 "
        f"losses {lp}")
    require(all(np.isfinite(lk)) and all(np.isfinite(lp)),
            "c_list fit: non-finite loss")
    require(lk[-1] < lk[0], "c_list fit: the loss did not fall")
    require(all(abs(a - b) <= TOL_FIT * abs(b) for a, b in zip(lk, lp)),
            "c_list fit: kernel and plain losses differ")
    require(fit_counts["spread_by_shape"][c3] > 0
            and fit_counts["gather_by_shape"][c3] > 0,
            "c_list fit: the C=3 kernels never launched")
    fit_ms = {m: [1e3 * h["dt"] for h in runs[m].history] for m in runs}
    return kern, plain32, fit_ms


# ---------------------------------------------------------------------------
# phases 2 (K5/K7) and 3f: the large system
# ---------------------------------------------------------------------------


def build_large(device):
    """examples/fluctuating_multipoles.py --n-side 32 in the port: 98,304
    atoms, its sparse exclusion table and cell list, with their build
    times."""
    from admp_tpu_torch import neighbor_list_cell, water_system
    from admp_tpu_torch.ops.exclusions import build_sparse_exclusions

    t0 = time.perf_counter()
    s = water_system(n_side=N98_SIDE, spacing=SPACING, jitter=N98_JITTER,
                     seed=SEED, exclusions=None)
    n = s["positions"].shape[0]
    t_sys = time.perf_counter() - t0
    t0 = time.perf_counter()
    bonds = [(3 * m, 3 * m + h) for m in range(n // 3) for h in (1, 2)]
    sparse = build_sparse_exclusions(bonds, n, max_depth=6)
    t_excl = time.perf_counter() - t0
    f32 = dict(device=device, dtype=torch.float32)
    positions = torch.tensor(s["positions"], **f32)
    box = torch.tensor(s["box"], **f32)
    t0 = time.perf_counter()
    nl = neighbor_list_cell(positions, box, RC)
    torch.cuda.synchronize()
    t_nl = time.perf_counter() - t0
    require(not bool(nl.did_overflow) and nl.i_sorted,
            "98k cell list overflow or not i-sorted")
    log(f"large system: {n} atoms, box {s['box'][0, 0]:.2f} A; system "
        f"{t_sys:.2f} s, sparse exclusions (width {sparse.idx.shape[1]}) "
        f"{t_excl:.2f} s, cell list {t_nl:.2f} s: {nl.capacity} pair slots, "
        f"cell capacity {nl.cell_capacity}, {nl.n_cells} cells")
    rng = np.random.default_rng(1)
    return dict(sys=s, sparse=sparse, positions=positions, box=box,
                pairs=nl.pairs, q_cart=torch.tensor(s["q_cart"], **f32),
                scales=torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], **f32),
                drift=torch.tensor(DRIFT * rng.standard_normal(
                    s["positions"].shape), **f32))


def fluctuating_q_local(positions, q_cart0):
    """examples/fluctuating_multipoles.py:75-91: each water's O and H
    charges shift by COUPLING x its O-H stretches about R0_OH, then
    Cartesian -> harmonic (lmax 2); differentiable in the positions."""
    from admp_tpu_torch import convert_cart2harm

    n = positions.shape[0]
    o, h1, h2 = positions[0::3], positions[1::3], positions[2::3]
    dq1 = COUPLING * (torch.linalg.norm(h1 - o, dim=-1) - R0_OH)
    dq2 = COUPLING * (torch.linalg.norm(h2 - o, dim=-1) - R0_OH)
    q = q_cart0.reshape(n // 3, 3, -1)
    dq = torch.stack([dq1 + dq2, -dq1, -dq2], dim=1)
    q = torch.cat([q[..., :1] + dq[..., None], q[..., 1:]], dim=-1)
    return convert_cart2harm(q.reshape(n, -1), 2)


def make_large_force(w, dtype, pair_kernel, spread_method, k=None):
    """The example's force: fixed multipoles, lmax 2, the 5-smooth grid
    (320^3 here), i-sorted pairs; ``k`` sets K1..K3 as its --k does."""
    from admp_tpu_torch import ADMPPmeForce, EngineConfig

    s = w["sys"]
    force = ADMPPmeForce(
        s["box"], s["axis_types"], s["axis_indices"], w["sparse"], RC,
        ETHRESH, lmax=LMAX,
        config=EngineConfig(fft_friendly_grid=True, pairs_i_sorted=True,
                            pair_kernel=pair_kernel,
                            spread_method=spread_method),
        device=w["positions"].device, dtype=dtype)
    if k:
        force.K1 = force.K2 = force.K3 = k
        force.refresh_calculators()
    return force


def large_args(w, positions, dtype):
    c = lambda t: t.to(dtype)  # noqa: E731
    return (positions, c(w["box"]), w["pairs"],
            fluctuating_q_local(positions, c(w["q_cart"])), c(w["scales"]))


def large_step(force, w, positions, dtype=torch.float32):
    """(energy, dE/dpositions) through the geometry and Q_local."""
    pos = positions.to(dtype).detach().requires_grad_(True)
    with torch.enable_grad():
        e = force.get_energy(*large_args(w, pos, dtype))
        (g,) = torch.autograd.grad(e, pos)
    return e.detach(), g


def run_large(force, w, n_steps, dtype=torch.float32):
    """n_steps 98k steps with drift, consuming the forces."""
    p, energies = w["positions"].to(dtype), []
    for _ in range(n_steps):
        e, g = large_step(force, w, p, dtype)
        p = p + w["drift"].to(dtype) + 0.0 * g
        energies.append(e)
    return energies


def large_stencil(w, grid, order=6):
    """The 98k step's energy-mesh stencil values at its first step."""
    from admp_tpu_torch.ops.reciprocal import atom_spread_alpha, spread_points_separable

    q_local = fluctuating_q_local(w["positions"], w["q_cart"])
    m_u0, u0, alpha = atom_spread_alpha(w["positions"], w["box"], q_local,
                                        grid, LMAX, order)
    q = spread_points_separable(u0, alpha, LMAX, order)
    return m_u0.contiguous(), q.reshape(q.shape[0], 1, -1).contiguous()


def crowded_stencil(dev, grid, order, n_ch, n=N_CROWD):
    """n atoms whose bases all lie in one core tile of the grid (more than
    K5's stage holds: 48 rows at (6, 1), 54 at (4, 3)), random stencil
    values."""
    from admp_tpu_torch.ops.cuda import spread as S

    rng = np.random.default_rng(10)
    corner = np.array([t * 3 for t in S.TILE]) + order // 2
    bases = corner + np.stack([rng.integers(0, t, n) for t in S.TILE], 1)
    m_u0 = torch.tensor(bases % np.array(grid), device=dev, dtype=torch.int32)
    q = torch.tensor(rng.standard_normal((n, n_ch, order ** 3)), device=dev,
                     dtype=torch.float32)
    return m_u0, q


def check_spread_tiled(w, record):
    """K5 and K7 against their plain versions (and the plain spread and
    gather) at the 98k shapes: (6, 1) at 320^3 and 256^3 on the step's
    stencils, (4, 3) at 320^3 on random stencil values, and K5 on one
    crowded tile at (6, 1) and (4, 3). K5 must give the same mesh on a
    second launch."""
    from admp_tpu_torch.ops.cuda import spread as S
    from admp_tpu_torch.ops.reciprocal import mesh_coordinates

    rng = np.random.default_rng(8)
    dev = w["positions"].device
    cases = []
    for k in (K98, K98_ALT):
        cases.append(((k,) * 3, 6) + large_stencil(w, (k,) * 3))
    grid = (K98,) * 3
    m_u0 = mesh_coordinates(w["positions"], w["box"], grid, 4)[0]
    q = torch.tensor(rng.standard_normal((m_u0.shape[0], 3, 64)), device=dev,
                     dtype=torch.float32)
    cases.append((grid, 4, m_u0.contiguous(), q))
    for order, n_ch in ((6, 1), (4, 3)):
        cases.append((grid, order) + crowded_stencil(dev, grid, order, n_ch))
    for grid, order, m_u0, q in cases:
        n_ch = q.shape[1]
        bins = S.tile_bins(m_u0, grid, S.TILE, order)
        crowd = int((bins.offsets[1:] - bins.offsets[:-1]).max())
        mesh_k = S.launch_spread_tiled(bins, q, grid, order)
        again = S.launch_spread_tiled(bins, q, grid, order)
        mesh_t = S.spread_tiled_torch(bins, q, grid, order)
        mesh_p = S.spread_torch(m_u0, q, grid, order)
        torch.cuda.synchronize()
        scale = float(mesh_t.abs().max())
        err = float((mesh_k - mesh_t).abs().max())
        err_p = float((mesh_k - mesh_p).abs().max())
        det = bool(torch.equal(mesh_k, again))
        g_mesh = torch.tensor(rng.standard_normal((n_ch, *grid)), device=dev,
                              dtype=torch.float32)
        out_k = S.launch_gather_tiled(bins, g_mesh, grid, order)
        out_t = S.gather_tiled_torch(bins, g_mesh, grid, order)
        same = (torch.equal(out_k, out_t)
                and torch.equal(out_k, S.gather_torch(m_u0, g_mesh, grid,
                                                      order)))
        log(f"tiled spread (K5) order {order} C={n_ch} N={m_u0.shape[0]} "
            f"grid={grid}, at most {crowd} atoms in a bin: max abs err "
            f"{err:.3e} = {err / scale:.3e} x max|mesh| vs its plain "
            f"version, {err_p / scale:.3e} vs the plain spread; the same "
            f"mesh on a second launch {det}; tiled gather (K7) bitwise "
            f"equal {same}")
        require(err <= TOL_SPREAD * scale and err_p <= TOL_SPREAD * scale,
                f"tiled spread order {order} C={n_ch} {grid}: {err / scale}")
        require(det, f"tiled spread order {order} C={n_ch} {grid}: another "
                "mesh on a second launch")
        require(same, f"tiled gather order {order} C={n_ch} {grid} differs")
        if "_tiled_inputs" not in record:  # the step's stencils at 320^3
            record["spread_tiled"]["max_abs_err"] = err
            record["gather_tiled"]["max_abs_err"] = float(
                (out_k - out_t).abs().max())
            record["_tiled_inputs"] = (m_u0, q, g_mesh)


def large_path(w, record):
    """Phase 3f: the 98k step on 'auto' (K5/K7), its launches, and its
    first step against the plain path in f32 and f64 at 320^3 and 256^3 and
    under spread_method='cuda' (K4/K6). Returns the forces it timed."""
    dev = w["positions"].device
    auto = make_large_force(w, torch.float32, "auto", "auto")
    grid = (auto.K1, auto.K2, auto.K3)
    log(f"large system: grid {grid}, kappa {auto.kappa:.6f}, "
        f"{w['pairs'].shape[0]} pair slots")
    require(grid == (K98,) * 3, f"the 5-smooth grid is {grid}")
    reset_counts()
    t0 = time.perf_counter()
    energies = run_large(auto, w, 1 + N_STEPS)
    counts = read_counts()
    log(f"phase 3f launches (1 cold + {N_STEPS} drift steps, "
        f"{time.perf_counter() - t0:.2f} s): {counts}")
    log("98k steps: energies " + str([round(float(e), 3) for e in energies]))
    want = 1 + N_STEPS
    require(counts["spread_tiled_by_shape"][6, 1] == want
            and counts["gather_tiled_by_shape"][6, 1] == want,
            "K5/K7 did not launch once per step")
    require(counts["pair_fwd"] == want and counts["pair_bwd"] == want,
            "K1/K2 perm did not launch once per step")
    require(counts["spread_by_shape"][6, 1] == 0
            and counts["gather_by_shape"][6, 1] == 0,
            "K4/K6 launched on the large mesh")
    require(all(bool(torch.isfinite(e)) for e in energies),
            "98k: non-finite energy")
    record["spread_tiled"]["launches"] = counts["spread_tiled_by_shape"][6, 1]
    record["gather_tiled"]["launches"] = counts["gather_tiled_by_shape"][6, 1]

    forces, scales = {}, {}
    for k in (K98, K98_ALT):
        kern = (auto if k == K98
                else make_large_force(w, torch.float32, "auto", "auto", k))
        plain32 = make_large_force(w, torch.float32, "torch", "torch", k)
        plain64 = make_large_force(w, torch.float64, "torch", "torch", k)
        forces[k] = {"auto": kern, "plain": plain32}
        p0 = w["positions"]
        e_k, g_k = large_step(kern, w, p0)
        require(bool(torch.isfinite(g_k).all())
                and tuple(g_k.shape) == tuple(p0.shape),
                f"98k at {k}^3: forces not finite or of the wrong shape")
        e_p, g_p = large_step(plain32, w, p0)
        e_64, g_64 = large_step(plain64, w, p0, torch.float64)
        with torch.no_grad():
            terms = plain64.get_metrics(*large_args(w, p0.double(),
                                                    torch.float64))
        scale = scales[k] = max(abs(float(terms[t])) for t in (
            "e_real", "e_recip", "e_self"))
        de, de64 = (abs(float(e_k) - float(e)) / scale for e in (e_p, e_64))
        de64_p = abs(float(e_p) - float(e_64)) / scale
        df, df64 = rel_rmse(g_k, g_p), rel_rmse(g_k, g_64)
        log(f"98k first step at {k}^3: E {float(e_k):.4f} (kernel f32), "
            f"{float(e_p):.4f} (plain f32), {float(e_64):.4f} (plain f64) "
            f"kJ/mol; terms (f64) real {float(terms['e_real']):.1f}, recip "
            f"{float(terms['e_recip']):.1f}, self {float(terms['e_self']):.1f}"
            f"; |dE| / max|term| vs plain f32 {de:.3e}, vs f64 {de64:.3e} "
            f"(plain f32 vs f64 {de64_p:.3e}); "
            f"force rel RMSE vs plain f32 {df:.3e}, vs f64 {df64:.3e}, plain "
            f"f32 vs f64 {rel_rmse(g_p, g_64):.3e}")
        require(de < TOL_E98 and de64 < max(TOL_E98, 2 * de64_p),
                f"98k energy at {k}^3: {de}, {de64} (plain f32 {de64_p})")
        require(df < TOL_STEP_F98, f"98k forces vs plain f32 at {k}^3: {df}")
        if k == K98:
            # which kernels the f32 difference comes from (logged only)
            for pk, sm in (("auto", "torch"), ("torch", "auto")):
                _, g_mix = large_step(make_large_force(
                    w, torch.float32, pk, sm, k), w, p0)
                log(f"98k at {k}^3, pair_kernel={pk!r} spread_method={sm!r}"
                    f": force rel RMSE vs plain f32 {rel_rmse(g_mix, g_p):.3e}")
        require(df64 < TOL_F64, f"98k forces vs plain f64 at {k}^3: {df64}")
        del plain64

    for k in (K98, K98_ALT):
        cuda = make_large_force(w, torch.float32, "auto", "cuda", k)
        reset_counts()
        e_c, g_c = large_step(cuda, w, w["positions"])
        counts = read_counts()
        e_a, g_a = large_step(forces[k]["auto"], w, w["positions"])
        de = abs(float(e_c) - float(e_a)) / scales[k]
        df = rel_rmse(g_c, g_a)
        log(f"98k at {k}^3 under spread_method='cuda' (K4/K6) vs 'auto' "
            f"(K5/K7): energy {float(e_c):.4f} vs {float(e_a):.4f} "
            f"(|dE| / max|term| {de:.3e}), force rel RMSE {df:.3e}; launches "
            f"K4 {counts['spread_by_shape']}, K5 "
            f"{counts['spread_tiled_by_shape']}")
        require(counts["spread_by_shape"][6, 1] == 1
                and counts["gather_by_shape"][6, 1] == 1
                and counts["spread_tiled_by_shape"][6, 1] == 0,
                "spread_method='cuda' did not take K4/K6")
        require(de < TOL_E98, f"98k 'cuda' vs 'auto' energy {de}")
        require(df < TOL_STEP_F98, f"98k 'cuda' vs 'auto' forces {df}")
        forces[k]["cuda"] = cuda
    return forces


def time_runs(run, n_steps=N_STEPS):
    """Median ms/step over N_REPEATS calls of run(n_steps), CUDA events
    around each call (each ends in a synchronize); run returns a list of the
    per-step PCG iteration counts, or of anything."""
    run(2)  # warm-up
    times, iters = [], []
    for _ in range(N_REPEATS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(n_steps)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / n_steps)
        iters += out
    return statistics.median(times), times, iters


def time_steps(force, w, dtype=torch.float32):
    """The polarizable step's time_runs, with its PCG iteration counts."""
    return time_runs(lambda n: [s[1] for s in run_steps(
        force, w, w["positions"], n, dtype)[1]])


def profile_steps(run, name, n_steps=3):
    """Device busy share and the top device kernels over run(n_steps) warm
    steps (torch.profiler); the table goes to
    chiprun_out/chip_smoke/profile_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile

    run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / n_steps
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=25)
    (OUT_DIR / f"profile_{name}.txt").write_text(table)
    top = sorted(prof.key_averages(), key=lambda a: -a.device_time_total)
    top = [a for a in top if a.device_time_total > 0][:8]
    return wall, device_ms, len(events) / n_steps, [
        (a.key[:60], a.device_time_total / 1e3 / n_steps, a.count // n_steps)
        for a in top]


# aten ops that only move, view or make data: they do no arithmetic
_MOVES = frozenset("""
_to_copy _unsafe_view alias arange as_strided cat clone contiguous copy_
detach empty empty_like expand expand_as fill_ full full_like index
index_select lift_fresh lift_fresh_copy narrow new_empty new_full new_ones
new_zeros ones ones_like permute reshape scalar_tensor select
select_backward slice slice_backward split split_with_sizes squeeze stack t
transpose unbind unsqueeze view zero_ zeros zeros_like
""".split())


def count_ops(fn):
    """The arithmetic operations of fn(), counted on the host: for each aten
    op that is not a data movement (_MOVES), the size of its largest operand
    or result. The plain versions repeat their kernels' arithmetic, so this
    counts a kernel's work on the same inputs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ not in _MOVES:
                leaves = tree_flatten((args, kwargs, out))[0]
                Count.ops += max((t.numel() for t in leaves
                                  if isinstance(t, torch.Tensor)), default=0)
            return out

    with Count():
        fn()
    return Count.ops


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(ms, 'bytes' or 'operations'): the least time the card could take to
    move n_bytes through HBM and do n_ops float32 operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spread_calls(m_u0, q, g_mesh, order):
    """(kernel, plain, library) calls of the spread and of the gather at one
    (order, C), and their bounds: the spread reads the stencil values and
    writes the whole mesh; the gather reads the mesh points the stencils
    touch and writes the values."""
    from admp_tpu_torch.ops.cuda import spread as S

    grid = tuple(g_mesh.shape[1:])
    n_ch, kcube = g_mesh.shape[0], g_mesh[0].numel()
    flat = S.flat_stencil_indices(m_u0, grid, order)  # (N, order^3)
    chan = torch.arange(n_ch, device=flat.device) * kcube
    s_idx = (flat[None] + chan[:, None, None]).reshape(-1)  # (C, N, P)
    s_val = q.transpose(0, 1).reshape(-1)
    zeros = torch.zeros(n_ch * kcube, device=q.device)
    g_idx = flat[:, None, :] + chan[None, :, None]  # (N, C, P)
    touched = int(torch.unique(flat).numel()) * n_ch * 4
    return {
        "spread": (lambda: S.launch_spread(m_u0, q, grid, order),
                   lambda: S.spread_torch(m_u0, q, grid, order),
                   lambda: torch.index_add(zeros, 0, s_idx, s_val),
                   bound(nbytes(m_u0, q) + 4 * n_ch * kcube, q.numel())),
        "gather": (lambda: S.launch_gather(m_u0, g_mesh, grid, order),
                   lambda: S.gather_torch(m_u0, g_mesh, grid, order),
                   lambda: torch.take(g_mesh, g_idx),
                   bound(nbytes(m_u0, q) + touched, 0)),
    }


def tiled_calls(m_u0, q, g_mesh, order):
    """K5 and K7 on their bins, their plain versions, the one-call
    counterparts and bounds of spread_calls (the same functions)."""
    from admp_tpu_torch.ops.cuda import spread as S

    grid = tuple(g_mesh.shape[1:])
    bins = S.tile_bins(m_u0, grid, S.TILE, order)
    base = spread_calls(m_u0, q, g_mesh, order)
    return {
        "spread_tiled": (
            lambda: S.launch_spread_tiled(bins, q, grid, order),
            lambda: S.spread_tiled_torch(bins, q, grid, order),
            *base["spread"][2:]),
        "gather_tiled": (
            lambda: S.launch_gather_tiled(bins, g_mesh, grid, order),
            lambda: S.gather_tiled_torch(bins, g_mesh, grid, order),
            *base["gather"][2:]),
    }


def time_large_kernels(w, card):
    """K5/K7 beside K4/K6 on the same 98k inputs at 320^3 and 256^3, each
    with its bound and the one PyTorch call that computes its function
    (index_add / take), and the binning that K5/K7 need; logged."""
    from admp_tpu_torch.ops.cuda import spread as S

    rng = np.random.default_rng(9)
    for k in (K98, K98_ALT):
        grid = (k,) * 3
        m_u0, q = large_stencil(w, grid)
        g_mesh = torch.tensor(rng.standard_normal((1, *grid)),
                              device=q.device, dtype=torch.float32)
        calls = dict(spread_calls(m_u0, q, g_mesh, 6))
        calls.update(tiled_calls(m_u0, q, g_mesh, 6))
        calls["tile_bins"] = (lambda: S.tile_bins(m_u0, grid, S.TILE, 6),)
        for name, c in calls.items():
            ms, dev_ms = cuda_time_ms(c[0])
            extra = ""
            if len(c) > 3:
                lib_ms, lib_dev_ms = cuda_time_ms(c[2])
                extra = (f", one PyTorch call {lib_ms:.4f} ms/call "
                         f"({lib_dev_ms:.4f} ms device), bound "
                         f"{c[3][0]:.4f} ms ({c[3][1]})")
            log(f"phase 4 [{card}]: 98k {grid} {name}: {ms:.4f} ms/call "
                f"({dev_ms:.4f} ms device){extra}")


def launcher_host_us(S, dev, rounds=5, n=1000, parts=False):
    """Host us per call (time.perf_counter over n back-to-back calls, no
    synchronize inside: the launches queue up on the card, so this is the
    caller's own host work), the median of ``rounds`` rounds that take
    every call in turn: K6's launcher at the MD shapes ((6, 1), 3000 atoms
    on (96, 96, 128)) and the full force field's ((4, 3) on 128^3), one
    torch.take of the same function beside each, and K5's launcher at
    98,304 atoms on 320^3. The bases and values are random from a seed: the
    host work does not depend on them. ``S`` is the ops/cuda/spread module
    under test. With ``parts``, also two pieces of K6's launcher at the MD
    shapes alone: torch.empty of its output, and the C entry point's call
    (ctypes and the launch) into a buffer made beforehand."""
    rng = np.random.default_rng(14)

    def inputs(n_atoms, grid, n_ch, order):
        m_u0 = torch.tensor(np.stack([rng.integers(0, k, n_atoms)
                                      for k in grid], 1),
                            device=dev, dtype=torch.int32)
        mesh = torch.tensor(rng.standard_normal((n_ch, *grid)), device=dev,
                            dtype=torch.float32)
        q = torch.tensor(rng.standard_normal((n_atoms, n_ch, order ** 3)),
                         device=dev, dtype=torch.float32)
        return m_u0, mesh, q

    calls = {}
    for grid, n_ch, order in (((96, 96, K3), 1, 6),
                              ((K_FF,) * 3, 3, DISP_ORDER)):
        m_u0, mesh, _ = inputs(3000, grid, n_ch, order)
        kcube = mesh[0].numel()
        idx = (S.flat_stencil_indices(m_u0, grid, order)[:, None, :]
               + (torch.arange(n_ch, device=dev) * kcube)[None, :, None])
        calls[f"gather ({order}, {n_ch})"] = functools.partial(
            S.launch_gather, m_u0, mesh, grid, order)
        calls[f"torch.take ({order}, {n_ch})"] = functools.partial(
            torch.take, mesh, idx)
        if parts and n_ch == 1:
            out = torch.empty(3000, 1, order ** 3, device=dev)
            P = ctypes.c_void_p
            args = (P(m_u0.data_ptr()), P(mesh.data_ptr()), P(out.data_ptr()),
                    3000, 1, order, *grid, P(S._raw_stream(0)))
            calls["torch.empty (6, 1)"] = functools.partial(
                torch.empty, 3000, 1, order ** 3, dtype=torch.float32,
                device=dev)
            calls["entry call (6, 1)"] = functools.partial(
                S._entry("admp_gather"), *args)
    grid98 = (K98,) * 3
    m_u0, _, q = inputs(98304, grid98, 1, 6)
    bins = S.tile_bins(m_u0, grid98, S.TILE, 6)
    calls["spread_tiled (6, 1) 98k"] = functools.partial(
        S.launch_spread_tiled, bins, q, grid98, 6)
    times = {k: [] for k in calls}
    for _ in range(rounds):
        for label, fn in calls.items():
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            times[label].append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def kernels_against(other, dev, card, repeats=5):
    """Device ms per call of K6 and K5 from this tree's sources and from
    those of the checkout in ``other`` (built there by its own build.py and
    loaded beside this tree's: the C interfaces are the same), on the same
    inputs in one process, the two taken in turn, median of ``repeats``
    profiles each: K6 at the MD shapes, at the full force field's (4, 3)
    and at 98k on 320^3 and 256^3; K5 at 98k on 320^3 and 256^3. Logged."""
    from admp_tpu_torch.ops.cuda import build, spread as S

    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from admp_tpu_torch.ops.cuda import build as b; "
            "b.build(('spread', 'spread_tiled')); "
            "print(b.library_path('spread'), b.library_path('spread_tiled'))")
    theirs = subprocess.run([sys.executable, "-c", code, other],
                            capture_output=True, text=True, check=True,
                            timeout=900).stdout.split()
    build.build(("spread", "spread_tiled"))
    libs = {"this tree": [ctypes.PyDLL(str(build.library_path(n)))
                          for n in ("spread", "spread_tiled")],
            other: [ctypes.PyDLL(path) for path in theirs]}
    P = ctypes.c_void_p
    stream = P(S._raw_stream(0))
    rng = np.random.default_rng(15)

    def mesh_of(shape):
        return torch.tensor(rng.standard_normal(shape), device=dev,
                            dtype=torch.float32)

    w = build_workload(dev)
    m_md = spread_inputs(w)[0]
    m_ff = disp_stencil(w, DISP_ORDER)[0]
    cases = [("K6 MD (6, 1)", m_md, mesh_of((1, *w["grid"])), 6),
             (f"K6 full FF ({DISP_ORDER}, 3)", m_ff,
              mesh_of((3, K_FF, K_FF, K_FF)), DISP_ORDER)]
    w98 = build_large(dev)
    tiled = []
    for k in (K98, K98_ALT):
        m98, q98 = large_stencil(w98, (k,) * 3)
        cases.append((f"K6 98k {k}^3 (6, 1)", m98, mesh_of((1, k, k, k)), 6))
        tiled.append((f"K5 98k {k}^3 (6, 1)", S.tile_bins(m98, (k,) * 3),
                      q98, (k,) * 3))

    def gather(lib, m_u0, mesh, order, out):
        return lambda: lib[0].admp_gather(
            P(m_u0.data_ptr()), P(mesh.data_ptr()), P(out.data_ptr()),
            m_u0.shape[0], mesh.shape[0], order, *mesh.shape[1:], stream)

    def spread_tiled(lib, bins, q, grid, out):
        return lambda: lib[1].admp_spread_tiled(
            P(bins.base.data_ptr()), P(bins.perm.data_ptr()),
            P(bins.offsets.data_ptr()), P(q.data_ptr()), P(out.data_ptr()),
            q.shape[1], 6, *grid, *S.TILE, stream)

    calls = {}
    for label, m_u0, mesh, order in cases:
        ref = S.gather_torch(m_u0, mesh, tuple(mesh.shape[1:]),
                             order).contiguous()
        for name, lib in libs.items():
            out = torch.empty_like(ref)
            calls[label, name] = gather(lib, m_u0, mesh, order, out)
            require(calls[label, name]() == 0, f"{label} of {name}: launch")
            torch.cuda.synchronize()
            require(torch.equal(out, ref), f"{label} of {name}: not the "
                    "plain gather's values")
    for label, bins, q, grid in tiled:
        meshes = []
        for name, lib in libs.items():
            meshes.append(torch.empty(1, *grid, device=dev))
            calls[label, name] = spread_tiled(lib, bins, q, grid, meshes[-1])
            require(calls[label, name]() == 0, f"{label} of {name}: launch")
        torch.cuda.synchronize()
        scale = float(meshes[0].abs().max())
        require(float((meshes[0] - meshes[1]).abs().max())
                <= TOL_SPREAD * scale, f"{label}: the two meshes differ")
    times = {key: [] for key in calls}
    for _ in range(repeats):
        for key, fn in calls.items():
            times[key].append(cuda_time_ms(fn, n=20)[1])
    for label in dict.fromkeys(k[0] for k in calls):
        log(f"[{card}] {label}: device ms per call " + ", ".join(
            f"{name} {statistics.median(times[label, name]):.4f} "
            f"({min(times[label, name]):.4f}-{max(times[label, name]):.4f})"
            for name in libs))


def time_kernels(record):
    """Each kernel, its plain version and its one-call PyTorch counterpart
    (where there is one) at the main path's shapes, and its bound."""
    from admp_tpu_torch.ops.cuda import pairs as P

    g_i, g_j, scl, scal, lmax, ct = record.pop("_pair_inputs")
    leaves = [t.clone().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
    e = (P.pair_energies_torch(*leaves, lmax, "pol") * ct).sum()
    x, hct, cs, hl = record.pop("_hvp_inputs")
    host = lambda ts: [t.detach().cpu() for t in ts]  # noqa: E731
    hx, hcs = host(x), host(cs)
    h_tab, h_ct, h_hct = host((g_i, g_j, scl, scal)), ct.cpu(), hct.cpu()

    def host_bwd():
        lv = [t.clone().requires_grad_(True) for t in h_tab]
        torch.autograd.grad((P.pair_energies_torch(*lv, lmax, "pol")
                             * h_ct).sum(), lv)

    tables = nbytes(g_i, g_j, scl, scal)
    calls = {
        "pair_fwd": (
            lambda: P.launch_pair_fwd(g_i, g_j, scl, scal, lmax, "pol"),
            lambda: P.pair_energies_torch(g_i, g_j, scl, scal, lmax, "pol"),
            None,
            bound(tables + nbytes(ct), count_ops(
                lambda: P.pair_energies_torch(*h_tab, lmax, "pol")))),
        "pair_bwd": (
            lambda: P.launch_pair_bwd(g_i, g_j, scl, scal, ct, lmax, "pol"),
            lambda: torch.autograd.grad(e, leaves, retain_graph=True),
            None,
            bound(2 * tables + nbytes(ct), count_ops(host_bwd))),
        "pair_hvp": (
            lambda: P.launch_pair_hvp(*x, hct, *cs, hl, "pol"),
            lambda: P.pair_hvp_torch(*x, hct, *cs, hl, "pol"),
            None,
            bound(2 * nbytes(*x, hct) + nbytes(*cs), count_ops(
                lambda: P.pair_hvp_torch(*hx, h_hct, *hcs, hl, "pol")))),
    }
    m_u0, q, g_mesh = record.pop("_spread_inputs")
    calls.update(spread_calls(m_u0, q, g_mesh, 6))
    m3, q3, g3, order3 = record.pop("_spread_c3_inputs")
    calls.update({f"{k}_c3": v for k, v in
                  spread_calls(m3, q3, g3, order3).items()})
    m98, q98, g98 = record.pop("_tiled_inputs")
    calls.update(tiled_calls(m98, q98, g98, 6))
    for name, (kernel, plain, library, (b_ms, b_by)) in calls.items():
        r = record[name]
        r["ms"], r["device_ms"] = cuda_time_ms(kernel)
        r["plain_ms"], r["plain_device_ms"] = cuda_time_ms(plain)
        r["library_ms"] = cuda_time_ms(library)[0] if library else None
        r["bound_ms"], r["bound_by"] = b_ms, b_by


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
    # --launchers DIR: only the launcher host-us line, of the admp_tpu_torch
    # in DIR (another commit's checkout, to compare in one run);
    # --kernels DIR: only K5's and K6's device times, this tree's beside
    # DIR's in one process
    mode = sys.argv[1] if len(sys.argv) > 2 else None
    other = sys.argv[2] if mode == "--launchers" else None
    sys.path.insert(0, other or str(ROOT))
    from admp_tpu_torch.ops.cuda import build

    dev = torch.device("cuda:0")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    if other:
        from admp_tpu_torch.ops.cuda import spread as S
        build.build(("spread", "spread_tiled"))
        log(f"[{card}] {S.__file__}: launcher host us per call: "
            + ", ".join(f"{k} {v:.2f}" for k, v in
                        launcher_host_us(S, dev).items()))
        return 0
    if mode == "--kernels":
        kernels_against(sys.argv[2], dev, card)
        return 0

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
        # the same kernels at C=3 (the dispersion mesh); TPU kernels reached
        # through spread_blocks_multi (:629) and gather_blocks (:1361)
        "spread_c3": dict(source="admp_tpu_torch/csrc/spread.cu",
                          replaces="admp_tpu/ops/pallas/spread.py:210"),
        "gather_c3": dict(source="admp_tpu_torch/csrc/spread.cu",
                          replaces="admp_tpu/ops/pallas/spread.py:890"),
        # the large-mesh pair (order 6, C=1, 320^3, 98,304 atoms)
        "spread_tiled": dict(source="admp_tpu_torch/csrc/spread_tiled.cu",
                             replaces="admp_tpu/ops/pallas/spread.py:718"),
        "gather_tiled": dict(source="admp_tpu_torch/csrc/spread_tiled.cu",
                             replaces="admp_tpu/ops/pallas/spread.py:949"),
    }
    t0 = time.perf_counter()
    w = build_workload(dev)
    log(f"workload: {w['positions'].shape[0]} atoms, "
        f"{w['pairs'].shape[0]} pair slots (dense), "
        f"{w['ff_pairs'].shape[0]} (cell list), built in "
        f"{time.perf_counter() - t0:.1f} s")
    check_pairs(w, record)
    check_hvp(w, record)
    check_spread(w, record)
    check_spread_c3(w, record)
    w98 = build_large(dev)
    check_spread_tiled(w98, record)
    log("phase 2: every kernel agrees with its plain version")

    force, plain32 = main_path(w, record)
    log("phase 3: main path ok")
    adj, adj_plain = adjoint_path(w, record)
    log("phases 3b, 3c: exact-adjoint path and parameter gradients ok")
    fit_times = fitting_path(w, record)
    log("phase 3d: trainer ok")
    ff, ff_plain, ff_fit_ms = ff_path(w, record)
    log("phase 3e: full force field ok")
    large = large_path(w98, record)
    log("phase 3f: large system ok")

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
    ms_ff, times_ff, _ = time_runs(lambda n: run_ff(ff, w, n))
    ms_ff_plain, times_ff_plain, _ = time_runs(lambda n: run_ff(ff_plain, w, n))
    log(f"phase 4 [{card}]: full-force-field step: kernel path {ms_ff:.3f} "
        f"ms/step ({[round(t, 3) for t in times_ff]}), plain path "
        f"{ms_ff_plain:.3f} ms/step ({[round(t, 3) for t in times_ff_plain]})"
        f"; c_list fit steps: kernel {[round(v, 3) for v in ff_fit_ms['kernel']]}"
        f" ms, plain f32 {[round(v, 3) for v in ff_fit_ms['plain32']]} ms")
    for k, routes in large.items():
        out = []
        for route, f in routes.items():
            ms_r, times_r, _ = time_runs(lambda n, f=f: run_large(f, w98, n),
                                         N98_TIME_STEPS)
            out.append(f"{route} {ms_r:.3f} ({[round(t, 3) for t in times_r]})")
        log(f"phase 4 [{card}]: 98k step at {k}^3, ms/step (median of "
            f"{N_REPEATS} x {N98_TIME_STEPS} steps): " + "; ".join(out)
            + " [auto: K5/K7, cuda: K4/K6, plain: index_add_ and the plain "
            "pair path]")
    for name, run in (
            ("md", lambda n: run_steps(force, w, w["positions"], n)),
            ("fullff", lambda n: run_ff(ff, w, n)),
            ("large", lambda n: run_large(large[K98]["auto"], w98, n))):
        wall, device_ms, n_kernels, top = profile_steps(run, name)
        log(f"profile {name} (3 warm steps, profiler on): {wall:.3f} ms/step "
            f"wall, {device_ms:.3f} ms/step device busy "
            f"({100 * device_ms / wall:.1f}%), {n_kernels:.0f} device "
            "kernels/step; top by device time:")
        for key, ms_k, count in top:
            log(f"  {ms_k:8.4f} ms/step  x{count:<4d} {key}")
    time_large_kernels(w98, card)
    from admp_tpu_torch.ops.cuda import spread as S
    log(f"phase 4 [{card}]: launcher host us per call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    launcher_host_us(S, dev, parts=True).items()))
    time_kernels(record)
    for name, r in record.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms/call")
        log(f"  {name}: kernel {r['ms']:.4f} ms/call ({r['device_ms']:.4f} ms "
            f"device), plain {r['plain_ms']:.4f} ms/call "
            f"({r['plain_device_ms']:.4f} ms device), one PyTorch call {lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")

    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=r["launches"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for name, r in record.items()]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
