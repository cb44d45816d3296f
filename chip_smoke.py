"""Run the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase failure is caught):
  0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
     no CUDA device -> exit 1 before anything is printed as a result;
  1. build the nine CUDA kernels (six libraries) from admp_tpu_torch/csrc
     into admp_tpu_torch/_build (nvcc, one process per source, concurrently);
  2. each kernel against its plain PyTorch version at the main path's shapes
     (the pair HVP K3 and its backward K3b, the pair energies' third
     derivative, for kinds pol, uu and perm, every output), and the
     tiled spread and gather (K5, K7) at the 98k-atom shapes: (order 6, C=1)
     at 320^3 and 256^3 on the step's stencils, (4, 3) at 320^3 on random
     ones, and K5 on one crowded tile (more atoms than its stage holds) at
     (6, 1) and (4, 3), each K5 mesh the same on a second launch; K4 and K6
     also on stencil rows that wrap at K3 and, at every (order, C), on axes
     shorter than the stencil; K4 through its C entry into a mesh filled
     with NaN (the entry zeroes it); K8 (the local frames and the multipole
     rotation, forward and backward) against its plain chain at the 98k box
     (98,304 sites) and the main path's 3,000: the global multipoles (also
     the plain f32 chain's bit for bit) and the gradients of the positions, the box and q_local at a
     standard-normal cotangent, each within max(TOL_FRAMES_Q or
     TOL_FRAMES_G, 2 x the plain f32 chain's) relative RMSE of the plain
     f64 chain;
  3. the MD path: the polarizable multipolar PME energy+force step of
     1000 waters (3000 atoms, lmax=2, rc 4 A, ethresh 1e-4, K3=128, the MD
     SCF profile), one cold step and 10 warm drift steps, plus one
     fixed-multipole step; launch counts; the first step against the plain
     path in f32 and in f64 on the card; one step with the damped Jacobi SCF
     (5 iterations), its dipoles on the kernels against plain f32;
  3b. the exact-adjoint path (default SCFConfig(): implicit adjoint,
     field_tol 10, order-6 full-resolution matvec mesh): one cold and 10 warm
     drift steps, launch counts (K3 for pol and uu), the first step against
     the plain path in f32 and f64; the warm-started adjoint
     (adjoint_warmstart) against the cold one over the same drift steps;
  3c. parameter gradients dE/dQ_local, dE/dpol, dE/dtholes, dE/dmScales and
     dE/dpScales on the kernels against the plain path in f64;
  3d. the trainer: 3 fitting.fit steps of energy matching on the exact-adjoint
     polarizable model (Q_local, pol, tholes) and of energy_force_loss on the
     fixed-multipole model (Q_local), B=2 each, kernel path against plain f32;
     launch counts (K3 for perm, K3b never); then force matching on the
     polarizable exact-adjoint model with SCFConfig(adjoint_fixed_iters=n),
     n the iterations the host-checked adjoint takes on the box at float32
     (energy_force_loss at energy_weight 0, Q_local, pol and tholes started
     5% off, the fixed model's float64 forces as targets, B=2): the first
     step's parameter gradients on the kernels within 2x the plain f32
     route's error + 1e-6 of plain f64, 3 steps on the kernels and on plain
     f32 (losses within TOL_FIT, falling, finite), K3b launched for pol and
     uu (per fit step logged), ms per fit step of both routes;
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
  3g. the XML/PDB front end: the MPID water XML and a PDB of the main path's
     box written to a temporary directory, Hamiltonian(xml, device='cuda')
     and createPotential(pdb, nonbondedCutoff=4.0) (ethresh 1e-5: 171^3
     meshes), cell-list pairs; the assembled system equals water_system's,
     each potential equals the same energy from the force objects (kernels
     1e-6; plain f32: energy 1e-5, forces 1e-4), its parameter gradients
     within 2x the plain f32 error + 1e-6 of plain f64, K1-K3 and K4/K6 at
     (6, 1) and (6, 3) launched, and K4/K6 on the 171^3 meshes against
     their plain versions;
  3h. MD (examples/run_npt.py at --nmol 1000): fixed multipoles,
     Tang-Toennies and bonded water, the influence grid following the box,
     a cell list with a 1 A skin; 50 NVE steps from Maxwell velocities on the
     kernels and on the plain f64 path (|dE_total| < 2% of KE), then three
     NPT segments (20 Langevin steps, a refresh, one MC barostat move), with
     launch counts per segment;
  3i. the precision modes (examples/precision_tpu.py's ladder on the main
     path's box, fixed multipoles, the constructor's kappa and grid; the DS
     rows at the power-of-two grid it rounds to, 128^3): the DS primitives
     and FFTs against numpy float64 (add, mul, div, sqrt 1e-13, npow, exp,
     erfc 1e-10, sum_pairs 1e-14, ds_fft3 and the ds_irfft3 round trip
     1e-13); each mode's f32 step on the kernels against the plain f64 path
     at the same grid (plain f32 5e-3; high_accuracy() 5e-6 and |dE| 0.05
     kJ/mol; 'f64-all' and 'f64-all' + 'f64-dft' 1e-6 and 1e-3;
     ds_accuracy() 2e-6 and a tenth of plain f32's; spread-f64 and
     recip-ds logged) and against its own plain f32 route (1e-4), K1/K2
     launched once per step (twice under 'f64-near', never under
     'f64-all') and K4/K6 exactly where the mesh is f32; the DS engine alone
     against the plain f64 reciprocal engine (energy 1e-10, gradients 5e-7);
     the polarizable exact-adjoint step under ds_accuracy() on the kernels
     against plain f32 (2e-4), K3 launched;
  3j. the sharded layer (admp_tpu_torch/parallel) over NCCL at world size
     1, in this process: examples/fluctuating_multipoles.py --n-side 32
     --sharded (98,304 atoms, sparse exclusions, cell-list pairs, the
     example's grid setup_ewald_parameters(4.0, 1e-4) -> 305^3, multipoles
     that follow the O-H stretches) through make_sharded_pme_energy, and on
     the 3000-atom box make_sharded_pol_energy (SCFConfig(), 96 x 96 x 128)
     and make_sharded_ff_energy (128^3, order-4 dispersion), each against
     the single-device force objects on the kernels (energy 1e-5, 98k 1e-6
     of the largest term; forces 1e-4, 2e-4 for the exact adjoint and 98k)
     and on plain f64 (forces 1e-3; 98k energy within 2x the plain f32
     path's); K1, K2, K4 and K6 launched in every sharded energy+force, K3
     ('pol', 'uu') in the exact adjoint; K4 and K6 on the 98k halo slabs
     of P = 1 and P = 4 against their plain versions, K4/K6 timed on the
     P = 1 slab (310 x 305 x 305) beside their plain versions, one
     PyTorch call and their bounds; the comm tally per step; ms/step
     sharded and single-device (drift, forces consumed) and one profiler
     window of each sharded step; the EngineConfig keywords
     spread_precision='f64' and compensated_sums=False on the two
     3000-atom calls at P = 1 over NCCL and P = 2 over gloo (ranks 0 and 1
     of 3k), against the single-device kernels under the same keyword
     (energy 1e-5, forces 1e-4) and plain f64 (forces 1e-3), every kernel
     launched, the same PCG iterations on every rank; compensated_sums=False
     also against the default P = 1 calls (forces and dipoles 1e-4: the
     sums move only the energy), each energy's distance from plain f64
     logged; K4/K6 on the halo slabs of P = 1 and 2 on stencils of float64
     weights, ms/step and peak bytes
     (chiprun_out/chip_smoke/sharded_keywords.json);
  3k. the same two 3000-atom calls on 2 and then 4 gloo ranks sharing the
     card (one start-up; admp_tpu_torch/parallel/launch.py), with the bins
     sized for the lattice atom order (halo_cap_factor = P), against 3j's
     P = 1 results, every rank the same iterations; the batch energy on a
     2 x 2 data x model split against P = 1; dryrun_multichip(4,
     device='cuda'); ms/step per rank (the overhead of P ranks on one card,
     not scaling) and the bytes per rank per step;
  3l. the user's scripts (admp_tpu_torch.examples), each through its own
     run() at the size its users run it: run_water --nmol 1000 plain and
     --polarizable, run_npt --nmol 1000 --steps 20 --segments 3, fit_params
     main() and multi_config(n_side=10) in float32, fluctuating_multipoles
     --n-side 32 and its sharded branch at world size 1 over NCCL; each on
     the kernels with its launches (counts set to 0 just before each script
     and read just after) and its wall time, and its deterministic energies
     and forces against the same run() on the plain versions
     (method='torch') within the tolerances of the phase of the same system
     (3e, 3b, 3h, 3d, 3f/3j); the scripts' own asserts; one forced volume
     move (ln V - 0.02) on the NPT script's end state, which must change the
     pair count, its refreshed list against a fresh cell list (the same
     pairs, the same energy within 1e-5);
  3m. the precision modes on the polarizable MD step (the main path's
     SCFConfig.md(), cached influence, the ladder's grid: 96^3, the DS rows
     128^3 with an order-6 matvec mesh): plain-f32, high_accuracy(),
     'f64-all', spread-f64, ds_accuracy() and ds_accuracy() with every
     pair in float64 over a cold and 3 drift steps, each on the kernels
     against the plain f64 path at the same grid, kappa and matvec
     (energy, forces, induced dipoles, each within max(the row's LADDER
     bound, 2 x the same mode's plain f32 route's own error), a row
     with every pair in float64 within the LADDER bound alone; a row
     without an energy bound also within the plain route's + 1e-6 of the
     largest term) and against the same mode's plain f32
     route (forces and dipoles 1e-4, energy 1e-6 of the largest term, the
     f64 path's real, reciprocal or self energy); K1/K2 by kind: 'pol' 2
     per step (4 under 'f64-near', 0
     under 'f64-all'), 'uu' once per PCG matvec, K3 never; K4/K6 2 per step
     on an f32 mesh; the PCG iterations of each route and the peak bytes;
     in phase 4 each row's ms/step and a profiler window of the
     high_accuracy() step (chiprun_out/chip_smoke/precision_pol.json);
  3n. the precision modes on the 98k system: spread-f64 (K5/K7 on stencils
     of float64 weights, also held alone against their plain tiled
     versions), high_accuracy() and 'f64-all' at 320^3 and 256^3, one
     energy+force step each against the plain f64 step (forces relative
     RMSE and |dE| over the largest term, within max(the LADDER bound or
     TOL_E98, 2 x the plain f32 route's own)) and the same mode's plain f32
     route (forces 2e-4, energy 1e-6 of the largest term), with launches,
     peak bytes and ms/step at 320^3 (a profiler window of the
     high_accuracy() step there); then ds_accuracy() at the grid its
     constructor picks (512^3 at 98k), once its byte count
     (DS_BYTES_PER_POINT, DS_BYTES_PER_ATOM) fits the card's free memory,
     its peak held under the count and its first step within 60 s
     (chiprun_out/chip_smoke/precision_98k.json);
  4. timing: ms/step of the MD step (median of 3 x 10 steps, CUDA events), of
     the exact-adjoint step (also with adjoint_warmstart) and of the
     full-force-field step, ms per fitting step, ms/step of the 98k step on
     K5/K7, on K4/K6 and plain at 320^3 and 256^3 (median of 3 x 5 steps),
     ms per NPT Langevin step (kernels, plain), ms per Hamiltonian
     energy+force (both potentials, kernels and plain), K4/K6 on the front
     end's 171^3 meshes, one profiler window each of the MD, exact-adjoint,
     full-force-field, 98k and NPT Langevin steps, and each kernel beside
     its plain version, its bound on the card and, where one exists, the one
     PyTorch call that computes the same function (at the 98k shapes too),
     and the host us per call of the launchers of K1-K6 (K4 beside one
     torch.index_add, K6 beside one torch.take), K3b at the 'pol' and 'uu'
     shapes (no one PyTorch call computes it); for the ladder each mode's
     ms/step (median of 3 x 10 drift steps, the DS rows 3 x 3), the 'ds' and
     'f64' reciprocal engines' energy+force at 128^3 with their force
     errors and host syncs (none allowed in the DS engine), the host syncs
     of a ds_accuracy() step, one profiler window of that step, and the
     polarizable ds_accuracy() step's time (results in
     chiprun_out/chip_smoke/precision.json).

    python3 chip_smoke.py --launchers DIR
    python3 chip_smoke.py --adjoint DIR
    python3 chip_smoke.py --sharded
    python3 chip_smoke.py --scripts
    python3 chip_smoke.py --precision
    python3 chip_smoke.py --fitting
    python3 chip_smoke.py --frames

print only that last line, or only the exact-adjoint step's ms/step and
profile, for the admp_tpu_torch in DIR (another commit's checkout, or .),
so that two trees compare in one run on the card, or run only phases 1,
3j and 3k (with 3j's keywords), or only phases 1 and 3l, or only phases
1, 3m (with its phase 4) and 3n, or only phases 1, K3b's part of 2, 3d and
K3b's timing, or only phases 1, K8's part of 2 and 3 (the MD path, with K8's
launches) and K8's times and record, and

    python3 chip_smoke.py --kernels DIR [DIR ...]

only the device times of K2-K7 built from this tree's sources and from each
DIR's, on the same inputs in one process, in turns (median of 5), each
checked first (K6, K7 bit for bit against the plain gather, K4 within 1e-5
of the plain spread, K5 within 1e-5 of the other tree's mesh, K2 within
1e-5 relative RMSE of autograd, K3 under its float64 gate), and the
registers and spills of each tree's K2, K3, K4 and K7: K2 'pol' at the MD
shapes and 'perm' at 98k, K3 'pol', 'uu' and 'perm' at the MD shapes, K4 at
the MD (6, 1), full FF (4, 3) and 98k 320^3 shapes, K5 and K7 at 98k on
320^3 and 256^3, K6 at the MD, full FF and 98k shapes.
Phase 2 also holds the three-channel spread and gather (K4, K6 at C=3) on the
dispersion stencil at orders 4 and 6.
The frames have no route of their own: on the float32 card every path takes
K8 for them, the plain routes (pair_kernel and spread_method 'torch') too,
so the plain routes' times and comparisons hold K8 on both sides; K8 is
held against its plain chain in phase 2.
Each path's launch counts are set to 0 just before it runs and read just
after; each kernel's record also holds its launches in the sharded calls
(``sharded_launches``: the 98k and 3000-atom calls at P = 1, and rank 0's
at P = 2 and 4) and in each script of phase 3l (``script_launches``). The line before the last is the kernels' JSON record; the
last line is
{"ok": true, "device": {...}}. Long logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import ctypes
import functools
import inspect
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from benchmark.counts.opcount import count_ops
from benchmark.counts.peaks import HBM_BYTES_S, bound_s

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
# K8 against the plain f64 chain, relative RMSE floors (the global
# multipoles; the gradients, the positions' summed by atomics in a varying
# order), as tests/test_torch_kernels_cuda.py sets them
TOL_FRAMES_Q, TOL_FRAMES_G = 1e-6, 1e-5
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

# the large system of examples/fluctuating_multipoles.py --n-side 32 (its
# charges follow the O-H stretches: the port's script's
# fluctuating_q_local), the example's --k grid
N98_SIDE, N98_JITTER = 32, 0.1
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

# the Jacobi SCF step: its dipoles after this many iterations (field_tol 0,
# so none stops early), kernel path against plain f32
N_JACOBI = 5
# phase 3g: the front end on the main path's box. Its generators' ethresh
# gives 171^3 meshes; the Hamiltonian's potentials against the same energies
# built from the force objects, both on the kernels, relative
FE_ETHRESH = 1e-5
TOL_FE = 1e-6
# phase 3h: examples/run_npt.py at --nmol 1000. NVE: |dE_total| within
# TOL_NVE of the starting kinetic energy (admp_tpu's own gate,
# tests/test_md_fitting.py:59-61); NPT: Langevin segments, a neighbor-list
# refresh, one MC barostat move each
NVE_STEPS, NVE_DT, TOL_NVE = 50, 5e-5, 0.02
NPT_SEGMENTS, NPT_STEPS, NPT_DT = 3, 20, 2e-4
TEMPERATURE, FRICTION, PRESSURE_BAR, MAX_DLNV = 300.0, 10.0, 1.0, 0.02

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


def pair_list_inputs(w, kind):
    """K1/K2's inputs at the main path's shapes (3000 atoms, the full pair
    capacity), as models/pme builds them: (the packed (N, F) table, the
    list's columns i and j, the scale rows, the 19 scalars, lmax)."""
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
    return (packed.contiguous(), i.contiguous(), j.contiguous(),
            scl.contiguous(), _pair_scalars(0.7296, box).contiguous(), lmax)


def pair_inputs(w, kind):
    """K3/K3b's gathered pair tables at the main path's shapes: rows
    table[i], table[j] of pair_list_inputs, the scale rows, the scalars,
    lmax."""
    table, i, j, scl, scal, lmax = pair_list_inputs(w, kind)
    return (table.index_select(0, i).contiguous(),
            table.index_select(0, j).contiguous(), scl, scal, lmax)


def check_pairs(w, record):
    """K1 and K2 (the packed table read through the pair list, K2's row
    gradients added by atomics) at the main path's shapes, on the i-sorted
    list and on the same list shuffled: the energies against the plain
    version on the gathered rows, K2's gradients of the table, the scale
    rows and the scalars against autograd of it and index_add."""
    from admp_tpu_torch.ops.cuda import pairs as P

    for kind, order in itertools.product(("pol", "uu", "perm"),
                                         ("sorted", "shuffled")):
        table, i, j, scl, scal, lmax = pair_list_inputs(w, kind)
        if order == "shuffled":
            perm = torch.randperm(i.shape[0], device=i.device, generator=(
                torch.Generator(device=i.device).manual_seed(4)))
            i, j, scl = i[perm], j[perm], scl[:, perm].contiguous()
        g_i, g_j = table.index_select(0, i), table.index_select(0, j)
        e_k = P.launch_pair_fwd(table, i, j, scl, scal, lmax, kind)
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
        log(f"pair {kind:4s} {order}: max|e| {e_max:.4e}; max |e - e_f64| "
            "kernel "
            f"{float((e_k.double() - e_64).abs().max()):.3e}, plain f32 "
            f"{float((e_p.double() - e_64).abs().max()):.3e}")
        rng = np.random.default_rng(3)
        ct = torch.tensor(rng.uniform(0.5, 1.5, g_i.shape[0]),
                          device=g_i.device, dtype=torch.float32)
        outs_k = P.launch_pair_bwd(table, i, j, scl, scal, ct, lmax, kind)
        leaves = [t.clone().requires_grad_(True) for t in (table, scl, scal)]
        e_leaf = P.pair_energies_torch(
            leaves[0].index_select(0, i), leaves[0].index_select(0, j),
            *leaves[1:], lmax, kind)
        outs_p = torch.autograd.grad((e_leaf * ct).sum(), leaves)
        torch.cuda.synchronize()
        names = ("d_table", "d_scl", "d_scal")
        # the mask row has no gradient; compare the differentiable rows
        errs = {}
        for nm, a, b in zip(names, outs_k, outs_p):
            if nm == "d_scl":
                rows = [0, 2] if kind == "pol" else [0]
                a, b = a[rows], b[rows]
            errs[nm] = rel_rmse(a, b)
        g_abs = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
        log(f"pair {kind:4s} {order} N={table.shape[0]} C={i.shape[0]} "
            f"F={table.shape[1]}: energy max "
            f"rel err {e_rel:.3e} (abs {e_abs:.3e}); grad rel RMSE "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        require(e_rel < TOL_PAIR_E, f"pair {kind} {order} energies {e_rel}")
        for nm, v in errs.items():
            require(v < TOL_PAIR_GRAD, f"pair {kind} {order} {nm} {v}")
        if kind == "pol" and order == "sorted":
            record["pair_fwd"]["max_abs_err"] = e_abs
            record["pair_bwd"]["max_abs_err"] = g_abs
            record["_pair_inputs"] = (table, i, j, scl, scal, lmax, ct)


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


THIRD_NAMES = ("x_gi", "x_gj", "x_scl", "x_scal", "x_ct", "x_cgi", "x_cgj",
               "x_cscl", "x_cscal")


def third_inputs(w, kind):
    """K3b's inputs at the main path's shapes: the pair tables of ``kind``,
    K3's cotangent ct and direction c, and the cotangents h of K3's outputs
    (P.hvp_directions, and a standard-normal h_ct)."""
    from admp_tpu_torch.ops.cuda import pairs as P

    g_i, g_j, scl, scal, lmax = pair_inputs(w, kind)
    x = (g_i, g_j, scl, scal)
    rng = np.random.default_rng(3)
    f32 = dict(device=g_i.device, dtype=torch.float32)
    ct = torch.tensor(rng.uniform(0.5, 1.5, g_i.shape[0]), **f32)
    cs = P.hvp_directions(x, kind, seed=5)
    hs = P.hvp_directions(x, kind, seed=6)
    hs.append(torch.tensor(rng.standard_normal(g_i.shape[0]), **f32))
    return x, ct, cs, hs, lmax


def check_third(w, record):
    """K3b against pair_third_torch (float64 and float32, same inputs) at
    the main path's shapes, every one of its nine outputs under K3's gate
    (hvp_ok), for each kind it has a template for."""
    from admp_tpu_torch.ops.cuda import pairs as P

    record["_third_inputs"] = {}
    for kind in ("pol", "uu", "perm"):
        x, ct, cs, hs, lmax = third_inputs(w, kind)
        out_k = P.launch_pair_third(*x, ct, *cs, *hs, lmax, kind)
        out_64 = P.pair_third_torch(*(t.double() for t in (*x, ct, *cs, *hs)),
                                    lmax, kind)
        out_32 = P.pair_third_torch(*x, ct, *cs, *hs, lmax, kind)
        torch.cuda.synchronize()
        errs = {nm: hvp_ok(*t) for nm, *t in zip(THIRD_NAMES, out_k, out_32,
                                                 out_64)}
        log(f"pair third {kind:4s} C={x[0].shape[0]} F={x[0].shape[1]}: rel "
            "RMSE vs plain f64, kernel / plain f32: "
            + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}" for k, v in errs.items()))
        for nm, a in zip(THIRD_NAMES, out_k):
            require(bool(torch.isfinite(a).all()),
                    f"pair third {kind} {nm} not finite")
        for nm, (err_k, err_32, ok) in errs.items():
            require(ok, f"pair third {kind} {nm} {err_k} (plain f32 {err_32})")
        if kind == "pol":
            record["pair_third"]["max_abs_err"] = max(
                float((a - b).abs().max()) for a, b in zip(out_k, out_32))
        record["_third_inputs"][kind] = (x, ct, cs, hs, lmax)


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
    swrap_k = S.launch_spread(m_wrap, q, grid, 6)
    swrap_p = S.spread_torch(m_wrap, q, grid, 6)
    # K4's C entry zeroes the mesh it is given: a buffer filled with NaN
    nan_mesh = torch.full((1, *grid), float("nan"), device=q.device)
    status = S._entry("admp_spread")(
        *(S._P(t.data_ptr()) for t in (m_u0, q, nan_mesh)), m_u0.shape[0], 1,
        6, *grid, S._P(S._raw_stream(q.get_device())))
    torch.cuda.synchronize()
    gerr = float((out_k - out_p).abs().max())
    serr_wrap = float((swrap_k - swrap_p).abs().max()) / float(
        swrap_p.abs().max())
    serr_nan = float((nan_mesh - mesh_p).abs().max()) / scale
    log(f"gather order 6: bitwise equal {bool(torch.equal(out_k, out_p))}, "
        f"on rows that wrap at K3 {bool(torch.equal(wrap_k, wrap_p))}; "
        f"spread on rows that wrap at K3 {serr_wrap:.3e} x max|mesh|, "
        f"through its C entry into a mesh of NaN {serr_nan:.3e} x max|mesh|")
    require(torch.equal(out_k, out_p), "gather differs from plain gather")
    require(torch.equal(wrap_k, wrap_p),
            "gather differs from plain gather on rows that wrap at K3")
    require(serr_wrap <= TOL_SPREAD, f"spread on rows that wrap {serr_wrap}")
    require(status == 0 and serr_nan <= TOL_SPREAD,
            f"spread into a mesh of NaN: status {status}, {serr_nan}")
    record["spread"]["max_abs_err"] = err
    record["gather"]["max_abs_err"] = gerr
    record["_spread_inputs"] = (m_u0, q, g_mesh)


def check_spread_rows(dev):
    """K4 and K6 at every (order, C) on axes shorter than the stencil (z by
    its remainder) and on rows that wrap at K3 (K4's float4 windows at K3 =
    12 and 20), random bases in and out of the box, against the plain spread
    (TOL_SPREAD) and gather (bit for bit)."""
    from admp_tpu_torch.ops.cuda import spread as S

    rng = np.random.default_rng(11)
    for grid in ((5, 4, 7), (9, 7, 3), (20, 16, 37), (12, 10, 12),
                 (9, 7, 20)):
        for order, n_ch in S.SHAPES:
            bases = np.stack([rng.integers(-9, k + 9, 300) for k in grid], 1)
            bases[:20, 2] = grid[2] - 1  # these rows run past K3 and wrap
            m_u0 = torch.tensor(bases, device=dev, dtype=torch.int32)
            q = torch.tensor(rng.standard_normal((300, n_ch, order ** 3)),
                             device=dev, dtype=torch.float32)
            g = torch.tensor(rng.standard_normal((n_ch, *grid)), device=dev,
                             dtype=torch.float32)
            mesh_k = S.launch_spread(m_u0, q, grid, order)
            mesh_p = S.spread_torch(m_u0, q, grid, order)
            same = torch.equal(S.launch_gather(m_u0, g, grid, order),
                               S.gather_torch(m_u0, g, grid, order))
            torch.cuda.synchronize()
            err = float((mesh_k - mesh_p).abs().max()) / float(
                mesh_p.abs().max())
            log(f"spread/gather ({order}, {n_ch}) on grid {grid}: spread "
                f"{err:.3e} x max|mesh|, gather bitwise equal {same}")
            require(err <= TOL_SPREAD, f"spread ({order}, {n_ch}) {grid}: "
                    f"{err}")
            require(same, f"gather ({order}, {n_ch}) {grid} differs")


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


def frames_inputs(w, q_local):
    """K8's inputs on a workload: positions shifted by 1.5 A along each
    axis and wrapped into the box (waters then straddle its faces, so the
    minimum-image wrap runs and the box carries a gradient: with every
    molecule whole, the frames do not depend on the box),
    box, q_local (lmax 2), the axis types and anchors as int64 on the card,
    and a standard-normal cotangent of the global multipoles."""
    from admp_tpu_torch.ops.pbc import wrap_positions

    dev = w["positions"].device
    idx = lambda a: torch.as_tensor(np.asarray(a), device=dev).long()  # noqa: E731
    g = torch.tensor(np.random.default_rng(7).standard_normal(
        tuple(q_local.shape)), device=dev, dtype=torch.float32)
    pos = wrap_positions(w["positions"].double() + 1.5,
                         w["box"].double()).float()
    return (pos.contiguous(), w["box"].contiguous(),
            q_local.contiguous(), idx(w["sys"]["axis_types"]).contiguous(),
            idx(w["sys"]["axis_indices"]).contiguous(), g)


def check_frames(w, w98, record):
    """K8 against its plain chain (global_multipoles_torch and its
    autograd, frames_vjp_torch) in float32 and float64 at the 98k box and
    at the main path's 3,000 sites: the forward and every gradient of the
    backward, each within max(floor, 2 x the plain f32 chain's error)
    relative RMSE of float64."""
    from admp_tpu_torch import convert_cart2harm
    from admp_tpu_torch.ops.cuda import frames as F8

    names = ("q_global", "d_positions", "d_box", "d_q_local")
    floors = (TOL_FRAMES_Q, TOL_FRAMES_G, TOL_FRAMES_G, TOL_FRAMES_G)
    record["_frames_inputs"] = {}
    for label, x in (
            ("98k", frames_inputs(w98, convert_cart2harm(w98["q_cart"],
                                                         LMAX))),
            ("3000", frames_inputs(w, w["q_local"]))):
        pos, box, q, types, anchors, g = x
        f0, b0 = F8.launch_frames_fwd.launches, F8.launch_frames_bwd.launches
        kern = (F8.launch_frames_fwd(pos, box, q, types, anchors, LMAX),
                *F8.launch_frames_bwd(pos, box, q, types, anchors, g, LMAX))
        require(F8.launch_frames_fwd.launches - f0 == 1
                and F8.launch_frames_bwd.launches - b0 == 1,
                f"K8 {label}: not one launch each way")
        plain = (F8.global_multipoles_torch(pos, box, q, types, anchors, LMAX),
                 *F8.frames_vjp_torch(g, pos, box, q, types, anchors, LMAX))
        d = [t.double() for t in (pos, box, q, g)]
        f64 = (F8.global_multipoles_torch(*d[:3], types, anchors, LMAX),
               *F8.frames_vjp_torch(d[3], *d[:3], types, anchors, LMAX))
        torch.cuda.synchronize()
        errs = [(rel_rmse(k, t), rel_rmse(p, t))
                for k, p, t in zip(kern, plain, f64)]
        same = torch.equal(kern[0], plain[0])
        log(f"K8 {label} ({pos.shape[0]} sites): forward the plain f32 "
            f"chain's bit for bit: {same}; rel RMSE vs plain f64, "
            "kernel / plain f32: " + ", ".join(
                f"{nm} {e[0]:.3e} / {e[1]:.3e}" for nm, e in zip(names, errs)))
        require(same, f"K8 {label}: the forward is not the plain f32 chain's")
        for nm, k, (err_k, err_p), floor in zip(names, kern, errs, floors):
            require(bool(torch.isfinite(k).all()), f"K8 {label} {nm} not "
                    "finite")
            require(err_k <= max(floor, 2 * err_p),
                    f"K8 {label} {nm}: {err_k} (plain f32 {err_p})")
        if label == "98k":
            record["frames_fwd"]["max_abs_err"] = float(
                (kern[0] - plain[0]).abs().max())
            record["frames_bwd"]["max_abs_err"] = max(
                float((a - b).abs().max()) for a, b in zip(kern[1:],
                                                           plain[1:]))
        record["_frames_inputs"][label] = x


def frames_calls(inputs):
    """K8's (kernel, plain, library, bound) at the 98k box ('frames_fwd',
    'frames_bwd') and at the 3,000 sites ('..._3000'), as the MD step calls
    it: the forward, and the backward for the positions' gradient alone (the
    box and q_local carry none there); the plain chain's forward, and its
    autograd backward for the positions. Bytes: the forward reads a site's
    position, type, anchors and multipoles and writes its global multipoles
    (116 B a site at lmax 2), the backward reads those and the cotangent and
    writes the position's gradient (128 B); operations: the plain chain's,
    counted on the host. No single PyTorch call computes either."""
    from admp_tpu_torch.ops.cuda import frames as F8

    calls = {}
    for label, suffix in (("98k", ""), ("3000", "_3000")):
        pos, box, q, types, anchors, g = inputs[label]
        xp = pos.detach().requires_grad_(True)
        out = F8.global_multipoles_torch(xp, box, q, types, anchors, LMAX)
        host = [t.detach().cpu() for t in (pos, box, q, types, anchors, g)]

        def host_fwd(h=host):
            F8.global_multipoles_torch(*h[:5], LMAX)

        def host_bwd(h=host):
            hp = h[0].clone().requires_grad_(True)
            torch.autograd.grad(F8.global_multipoles_torch(hp, *h[1:5], LMAX),
                                hp, h[5])

        a = (pos, box, q, types, anchors)
        calls["frames_fwd" + suffix] = (
            lambda a=a: F8.launch_frames_fwd(*a, LMAX),
            lambda a=a: F8.global_multipoles_torch(*a, LMAX),
            None,
            bound_s(nbytes(pos, q, types, anchors) + nbytes(q),
                    count_ops(host_fwd)))
        calls["frames_bwd" + suffix] = (
            lambda a=a, g=g: F8.launch_frames_bwd(*a, g, LMAX, want_box=False,
                                                  want_q=False),
            lambda out=out, xp=xp, g=g: torch.autograd.grad(
                out, xp, g, retain_graph=True),
            None,
            bound_s(nbytes(pos, q, types, anchors, g, pos),
                    count_ops(host_bwd)))
    return calls


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
    require(launches["pair_hvp"] == launches["pair_third"] == 0,
            "the MD step launched K3 or K3b")
    require(launches["frames_fwd"] > 0 and launches["frames_bwd"] > 0,
            "the MD step never launched K8")
    require(cold[1] and all(s[2] for s in steps), "SCF did not converge")
    require(cold[0] <= 10, f"cold iterations {cold[0]} > 10")
    require(all(s[1] <= 3 for s in steps), "warm iterations > 3")
    require(all(bool(torch.isfinite(s[0])) for s in steps)
            and bool(torch.isfinite(e0)) and bool(torch.isfinite(e_fix)),
            "non-finite energy")
    require(bool(torch.isfinite(g0).all()) and bool(torch.isfinite(g_fix).all())
            and tuple(g0.shape) == tuple(w["positions"].shape),
            "forces not finite or of the wrong shape")
    for k in ("pair_fwd", "pair_bwd", "spread", "gather", "frames_fwd",
              "frames_bwd"):
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

    # one step with the damped Jacobi SCF: the iterates, not convergence
    # (the reference's Jacobi diverged on its own configuration)
    from admp_tpu_torch import SCFConfig

    scf = SCFConfig(method="jacobi", max_iter=N_JACOBI, field_tol=0.0)
    out = {}
    for method in ("auto", "torch"):
        jac = make_force(w, True, dev, torch.float32, method, scf=scf)
        reset_counts()
        e_j, g_j = jac.get_forces(*pol_args(w, w["positions"], torch.float32))
        counts = read_counts()
        out[method] = (e_j, g_j, jac.U_ind, jac.n_cycle, counts)
    (e_k, g_k, u_k, n_k, c_k), (e_p, g_p, u_p, n_p, _) = (out["auto"],
                                                          out["torch"])
    du = rel_rmse(u_k, u_p)
    log(f"Jacobi step ({N_JACOBI} iterations): U_ind kernel vs plain f32 rel "
        f"RMSE {du:.3e}, energy {float(e_k):.6f} vs {float(e_p):.6f}, force "
        f"rel RMSE {rel_rmse(g_k, g_p):.3e}, iterations {n_k} / {n_p}; "
        f"max|U_ind| {float(u_p.abs().max()):.4f}; launches K1 "
        f"{c_k['pair_fwd']}, K2 {c_k['pair_bwd']}, K3 {c_k['pair_hvp']}")
    require(n_k == n_p == N_JACOBI, f"Jacobi iterations {n_k}, {n_p}")
    require(bool(torch.isfinite(u_k).all()), "Jacobi dipoles not finite")
    require(du < TOL_STEP_F, f"Jacobi dipoles kernel vs plain f32 {du}")
    return force, plain32


def reset_counts():
    from admp_tpu_torch.ops.cuda import frames as F8, pairs as P, spread as S

    for c in (P.launch_pair_fwd, P.launch_pair_bwd, P.launch_pair_hvp,
              P.launch_pair_third, S.launch_spread, S.launch_gather,
              S.launch_spread_tiled, S.launch_gather_tiled,
              F8.launch_frames_fwd, F8.launch_frames_bwd):
        c.launches = 0
    for c in (P.launch_pair_fwd, P.launch_pair_bwd, P.launch_pair_hvp,
              P.launch_pair_third):
        c.by_kind = dict.fromkeys(P.KINDS, 0)
    for c in (S.launch_spread, S.launch_gather, S.launch_spread_tiled,
              S.launch_gather_tiled):
        c.by_shape = dict.fromkeys(S.SHAPES, 0)


def read_counts():
    from admp_tpu_torch.ops.cuda import frames as F8, pairs as P, spread as S

    torch.cuda.synchronize()
    return {"pair_fwd": P.launch_pair_fwd.launches,
            "pair_bwd": P.launch_pair_bwd.launches,
            "pair_hvp": P.launch_pair_hvp.launches,
            "pair_third": P.launch_pair_third.launches,
            "spread": S.launch_spread.launches,
            "gather": S.launch_gather.launches,
            "frames_fwd": F8.launch_frames_fwd.launches,
            "frames_bwd": F8.launch_frames_bwd.launches,
            "pair_fwd_by_kind": dict(P.launch_pair_fwd.by_kind),
            "pair_bwd_by_kind": dict(P.launch_pair_bwd.by_kind),
            "pair_hvp_by_kind": dict(P.launch_pair_hvp.by_kind),
            "pair_third_by_kind": dict(P.launch_pair_third.by_kind),
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
    require(counts["pair_third"] == 0, "the exact-adjoint step launched K3b")
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

    # the warm-started adjoint (adjoint_warmstart=True) against the cold one
    # over the same drift steps, both on the kernels from the same start
    import dataclasses

    warm = make_force(w, True, dev, torch.float32, "auto",
                      scf=dataclasses.replace(scf, adjoint_warmstart=True))
    cold = make_force(w, True, dev, torch.float32, "auto", scf=scf)
    p, errs = w["positions"], []
    for _ in range(1 + N_STEPS):
        _, g_c = cold.get_forces(*pol_args(w, p, torch.float32))
        _, g_w = warm.get_forces(*pol_args(w, p, torch.float32))
        errs.append(rel_rmse(g_w, g_c))
        p = p + w["drift"]
    log(f"adjoint_warmstart: forces vs the cold exact adjoint over 1 + "
        f"{N_STEPS} drift steps, rel RMSE max {max(errs):.3e} "
        f"({[f'{e:.1e}' for e in errs]}); max|W_adj| "
        f"{float(warm.W_adj.abs().max()):.4e}")
    require(max(errs) < TOL_ADJ_F, f"adjoint_warmstart forces {max(errs)}")
    require(float(warm.W_adj.abs().max()) > 0.0, "W_adj was not carried")

    # 3c: dE/d(Q_local, pol, tholes, mScales, pScales) through get_energy,
    # cold-started; the two scales reach K2's dscl rows
    names = ("Q_local", "pol", "tholes", "mScales", "pScales")
    grads = {}
    for name, f in (("kernel", force), ("plain32", plain32),
                    ("plain64", plain64)):
        dtype = torch.float64 if name == "plain64" else torch.float32
        args = list(pol_args(w, w["positions"], dtype))
        params = [args[k].clone().requires_grad_(True) for k in range(3, 8)]
        args[3:8] = params
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
    return force, plain32, warm


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
    require(counts["pair_third"] == 0,
            "the energy fit or the fixed-model force fit launched K3b")
    require(all(counts[k] > 0 for k in ("pair_fwd", "pair_bwd", "pair_hvp",
                                        "spread", "gather")),
            "a kernel never launched on the fitting path")
    record["pair_hvp"]["launches"] = (record["pair_hvp"].get("launches", 0)
                                      + counts["pair_hvp"])
    record["pair_third"]["launches"] = counts["pair_third"]
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
    times.update(pol_force_fit(w, record, targets))
    return times


def adjoint_iterations(w):
    """The PCG iterations of the host-checked adjoint (SCFConfig()) on the
    main path's box at float32 on the kernels, cold: the matvecs of one
    energy+force call without a graph, less the forward's."""
    from admp_tpu_torch import SCFConfig

    dev = w["positions"].device
    force = make_force(w, True, dev, torch.float32, "auto", scf=SCFConfig())
    calls = []
    make = force._matvec_fn

    def counting(pairs):
        inner = make(pairs)

        def matvec(v, theta, create_graph):
            calls.append(create_graph)
            return inner(v, theta, create_graph)

        return matvec

    force._matvec_fn = counting
    force.get_forces(*pol_args(w, w["positions"], torch.float32))
    return calls.count(False) - force.n_cycle, force.n_cycle


def pol_force_fit(w, record, targets):
    """Phase 3d's force-matching fit on the polarizable exact-adjoint
    potential: SCFConfig(adjoint_fixed_iters=n), n the iterations of the
    host-checked adjoint on this box at float32, so that the loss's
    gradient takes the pair energies' third derivative (K3b, 'pol' and
    'uu'). Fits Q_local, pol and tholes (started 5% off) to the float64
    forces of the fixed potential (``targets``, B=2) with energy_force_loss
    at energy_weight 0 (force matching alone: the whole gradient takes the
    third derivative), N_FIT_STEPS steps on the kernels and on plain f32;
    the first step's gradients on the kernels within 2x the plain f32
    route's error + 1e-6 of the plain f64 route's. Returns the per-step
    times (ms) of each run."""
    from admp_tpu_torch import SCFConfig, energy_force_loss, fit, stack_batch
    from admp_tpu_torch.fitting import adam

    dev = w["positions"].device
    n_adj, n_fwd = adjoint_iterations(w)
    scf = SCFConfig(adjoint_fixed_iters=max(n_adj, 1))
    log(f"phase 3d force fit: the host-checked adjoint takes {n_adj} PCG "
        f"iterations on the 3000-atom box at float32 (forward {n_fwd}): "
        f"{scf}")
    sc = w["scales"]
    true = {"q": w["q_local"], "pol": w["pol"], "tholes": w["tholes"]}
    names = tuple(true)

    def potential_of(method, dtype):
        force = make_force(w, True, dev, dtype, method, scf=scf)
        scales = sc.to(dtype)

        def potential(positions, box, pairs, params):
            return force.get_energy(positions, box, pairs, params["q"],
                                    params["pol"], params["tholes"], scales,
                                    scales, scales)

        return potential

    def batch_of(dtype):
        return stack_batch([tuple(t.to(dtype) if t.is_floating_point() else t
                                  for t in (p, b, pr, torch.as_tensor(e), f))
                            for p, b, pr, e, f in targets])

    # the first step's parameter gradients, cold, on the three routes
    grads = {}
    for route, method, dtype in (("kernel", "auto", torch.float32),
                                 ("plain32", "torch", torch.float32),
                                 ("plain64", "torch", torch.float64)):
        params = {k: (1.05 * v).to(dtype).requires_grad_(True)
                  for k, v in true.items()}
        loss = energy_force_loss(potential_of(method, dtype),
                                 energy_weight=0.0)(params, batch_of(dtype))
        grads[route] = torch.autograd.grad(loss, list(params.values()))
    for nm, g_k, g_32, g_64 in zip(names, *grads.values()):
        err_k, err_32 = rel_rmse(g_k, g_64), rel_rmse(g_32, g_64)
        log(f"force fit first step d loss/d{nm}: kernel f32 vs plain f64 rel "
            f"RMSE {err_k:.3e}, plain f32 vs plain f64 {err_32:.3e}")
        require(bool(torch.isfinite(g_k).all()), f"d loss/d{nm} not finite")
        require(err_k <= 2 * err_32 + 1e-6,
                f"force fit d loss/d{nm} {err_k} > 2 x {err_32} + 1e-6")

    def run(method):
        start = {k: 1.05 * v for k, v in true.items()}
        return fit(energy_force_loss(potential_of(method, torch.float32),
                                     energy_weight=0.0),
                   start, [batch_of(torch.float32)] * N_FIT_STEPS,
                   optimizer=adam(FIT_LR), log_every=0)

    reset_counts()
    runs = {"kernel": run("auto")}
    counts = read_counts()
    runs["plain32"] = run("torch")
    per_step = {k: v / N_FIT_STEPS for k, v in
                counts["pair_third_by_kind"].items()}
    log(f"phase 3d force fit launches (kernel run): {counts}; K3b per fit "
        f"step: {per_step}")
    require(counts["pair_third_by_kind"]["pol"] > 0
            and counts["pair_third_by_kind"]["uu"] > 0,
            "K3b did not run for both pol and uu")
    require(all(counts[k] > 0 for k in ("pair_fwd", "pair_bwd", "pair_hvp",
                                        "spread", "gather")),
            "a kernel never launched on the force-matching fit")
    record["pair_third"]["launches"] += counts["pair_third"]
    record["pair_third"]["launches_per_fit_step"] = per_step
    label = ("force matching, polarizable exact adjoint "
             f"(adjoint_fixed_iters={scf.adjoint_fixed_iters})")
    lk = [h["loss"] for h in runs["kernel"].history]
    lp = [h["loss"] for h in runs["plain32"].history]
    log(f"fit ({label}): kernel losses {lk}, plain f32 losses {lp}")
    require(all(np.isfinite(lk)) and all(np.isfinite(lp)),
            f"fit {label}: non-finite loss")
    require(all(bool(torch.isfinite(v).all())
                for r in runs.values() for v in r.params.values()),
            f"fit {label}: non-finite parameters")
    require(lk[-1] < lk[0], f"fit {label}: the loss did not fall")
    require(all(abs(a - b) <= TOL_FIT * abs(b) for a, b in zip(lk, lp)),
            f"fit {label}: kernel and plain losses differ")
    return {label: {m: [1e3 * h["dt"] for h in runs[m].history]
                    for m in runs}}


def make_ff(w, device, dtype, method, **keywords):
    """The full force field of bench.py's build_nonpol_workload in the port:
    (total(positions, c_list) -> energy, the dispersion force); the
    EngineConfig ``keywords`` reach the multipolar PME."""
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
                                           spread_method=method, **keywords),
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

    total.pme_terms = lambda positions: pme.get_metrics(  # noqa: E731
        positions, box, pairs, q_local, sc)
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
# phase 3g: the XML/PDB front end
# ---------------------------------------------------------------------------


def hamiltonian(xml, pdb, device, dtype, plain=False):
    """The front end: Hamiltonian(xml) on ``device`` in ``dtype`` (no
    reference-dipole file), its potentials for ``pdb`` at rc 4 A. With
    ``plain`` its force objects are switched to the plain path after
    assembly (the front end has no such option: this is the comparison's
    own doing)."""
    import dataclasses

    from admp_tpu_torch import Hamiltonian

    ham = Hamiltonian(xml, device=device, dtype=dtype)
    ham.getGenerators()[1].ref_dip = ""
    pots = ham.createPotential(pdb, nonbondedCutoff=RC)
    if plain:
        for gen in ham.getGenerators():
            f = getattr(gen, "pme_force", None) or gen.disp_pme_force
            f.config = dataclasses.replace(f.config, pair_kernel="torch",
                                           spread_method="torch")
            f.refresh_calculators()
    return ham, pots


def direct_potentials(w, dtype, method):
    """The front end's two potentials built from the force objects and
    water_system's arrays: Tang-Toennies minus dispersion PME, and the
    polarizable multipolar PME (cold SCF, exact adjoint), at ethresh 1e-5."""
    from admp_tpu_torch import (
        ADMPDispPmeForce,
        ADMPPmeForce,
        EngineConfig,
        generate_pairwise_interaction,
        tt_damping_qq_c6_kernel,
    )

    s, dev = w["sys"], w["positions"].device
    c = lambda x: torch.as_tensor(x, device=dev, dtype=dtype)  # noqa: E731
    cfg = EngineConfig(pair_kernel=method, spread_method=method)
    disp = ADMPDispPmeForce(s["box"], s["covalent_map"], RC, FE_ETHRESH, PMAX,
                            config=cfg, device=dev, dtype=dtype)
    pme = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                       s["covalent_map"], RC, FE_ETHRESH, LMAX, lpol=True,
                       config=cfg, device=dev, dtype=dtype)
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                       s["covalent_map"], device=dev)
    c_list, sc = c(s["c_list"]), c(w["scales"])
    tt_args = [c(s[k]) for k in ("tt_a", "tt_b", "tt_q")] + [c_list[:, 0]]
    q_local, pol, tholes = c(w["q_local"]), c(s["pol"]), c(s["tholes"])

    def e_disp(pos, box, pairs):
        return (tt(pos, box, pairs, sc, *tt_args)
                - disp.get_energy(pos, box, pairs, c_list, sc))

    def e_pme(pos, box, pairs):
        return pme.get_energy(pos, box, pairs, q_local, pol, tholes, sc, sc,
                              sc, U_init=torch.zeros_like(pos))

    return (e_disp, e_pme), pme


def potential_grads(pot, gen, w, dtype):
    """(energy, dE/dpositions, {name: dE/dparam}) of one front-end potential
    at the workload's positions and cell-list pairs, params as leaves."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in gen.params.items()}
    pos = w["positions"].to(dtype).detach().requires_grad_(True)
    e = pot(pos, w["box"].to(dtype), w["ff_pairs"], params)
    names = list(params)
    grads = torch.autograd.grad(e, [pos] + [params[k] for k in names],
                                allow_unused=True)
    return e.detach(), grads[0], {
        k: torch.zeros_like(params[k]) if g is None else g
        for k, g in zip(names, grads[1:])}


def check_spread_171(w, grids):
    """K4/K6 on the front end's meshes (171^3: odd K3, so K4 takes its scalar
    rounds; the three-channel mesh is larger than the card's L2) against
    their plain versions; returns the stencils for the timings."""
    from admp_tpu_torch.ops.cuda import spread as S
    from admp_tpu_torch.ops.reciprocal import multi_stencil

    out = {}
    for (order, n_ch), grid in grids.items():
        if n_ch == 1:
            m_u0, q = spread_inputs(dict(w, grid=grid))
        else:
            m_u0, q = multi_stencil(w["positions"], w["box"], w["c_list"],
                                    grid, order)
        m_u0, q = m_u0.contiguous(), q.contiguous()
        mesh_k = S.launch_spread(m_u0, q, grid, order)
        mesh_p = S.spread_torch(m_u0, q, grid, order)
        rng = np.random.default_rng(15)
        g_mesh = torch.tensor(rng.standard_normal((n_ch, *grid)),
                              device=q.device, dtype=torch.float32)
        same = torch.equal(S.launch_gather(m_u0, g_mesh, grid, order),
                           S.gather_torch(m_u0, g_mesh, grid, order))
        err = float((mesh_k - mesh_p).abs().max() / mesh_p.abs().max())
        log(f"front end ({order}, {n_ch}) on {grid} ({4 * n_ch * np.prod(grid) / 1e6:.1f} MB): "
            f"spread max err {err:.3e} x max|mesh|, gather bitwise equal "
            f"{same}")
        require(err <= TOL_SPREAD, f"spread ({order}, {n_ch}) on {grid}: {err}")
        require(same, f"gather ({order}, {n_ch}) on {grid} differs")
        out[order, n_ch] = (m_u0, q, g_mesh)
    return out


def front_end_path(w):
    """Phase 3g: the MPID water XML and a PDB of the main path's box through
    Hamiltonian.createPotential on the card; its system, its potentials
    against the direct force objects (kernels, plain f32), its parameter
    gradients against plain f64, and its kernel launches. Returns what
    phase 4 times."""
    from admp_tpu_torch.systems import write_water_inputs

    s, dev = w["sys"], w["positions"].device
    with tempfile.TemporaryDirectory() as tmp:
        xml, pdb = write_water_inputs(tmp, s["positions"], s["box"])
        t0 = time.perf_counter()
        ham, pots = hamiltonian(xml, pdb, dev, torch.float32)
        t_build = time.perf_counter() - t0
        ham_32, pots_32 = hamiltonian(xml, pdb, dev, torch.float32,
                                      plain=True)
        ham_64, pots_64 = hamiltonian(xml, pdb, dev, torch.float64)
    gens = ham.getGenerators()
    system = ham._system
    for k in ("axis_types", "axis_indices", "covalent_map"):
        require(np.array_equal(getattr(system, k), s[k]),
                f"front end: {k} differs from water_system's")
    q_err = max(float(np.max(np.abs(getattr(system, k) - s[k])))
                for k in ("q_cart", "pol", "tholes"))
    require(q_err <= 1e-12, f"front end: q_cart/pol/tholes differ by {q_err}")
    pme_f, disp_f = gens[1].pme_force, gens[0].disp_pme_force
    grids = {(6, 1): (pme_f.K1, pme_f.K2, pme_f.K3),
             (6, 3): (disp_f.K1, disp_f.K2, disp_f.K3)}
    log(f"front end: Hamiltonian + createPotential in {t_build:.2f} s; "
        f"{system.n_atoms} atoms, {len(system.bonds)} bonds, the system "
        f"equals water_system's (q_cart/pol/tholes max diff {q_err:.1e}); "
        f"electrostatic grid {grids[6, 1]} kappa {pme_f.kappa:.6f}, "
        f"dispersion grid {grids[6, 3]} kappa {disp_f.kappa:.6f}, "
        f"{w['ff_pairs'].shape[0]} cell-list pair slots")
    stencils = check_spread_171(w, grids)

    direct_k, pme_k = direct_potentials(w, torch.float32, "auto")
    direct_32, pme_32 = direct_potentials(w, torch.float32, "torch")
    pos, box, pairs = w["positions"], w["box"], w["ff_pairs"]
    labels = ("dispersion", "polarizable")
    # the polarizable potential is the exact-adjoint step (cold SCF): its
    # force gate is the exact adjoint's (PERF.md §2)
    tol_f = (TOL_STEP_F, TOL_ADJ_F)
    for k, label in enumerate(labels):
        reset_counts()
        e_k, f_k, g_k = potential_grads(pots[k], gens[k], w, torch.float32)
        counts = read_counts()
        _, f_32, g_32 = potential_grads(pots_32[k], ham_32.getGenerators()[k],
                                        w, torch.float32)
        _, f_64, g_64 = potential_grads(pots_64[k], ham_64.getGenerators()[k],
                                        w, torch.float64)
        with torch.no_grad():
            e_dk = float(direct_k[k](pos, box, pairs))
        p = pos.detach().requires_grad_(True)
        with torch.enable_grad():
            e_d32 = direct_32[k](p, box, pairs)
            (f_d32,) = torch.autograd.grad(e_d32, p)
        e_k, e_d32 = float(e_k), e_d32.detach()
        db = abs(e_k - e_dk) / abs(e_dk)
        dc = abs(e_k - float(e_d32)) / abs(float(e_d32))
        df = rel_rmse(f_k, f_d32)
        scf = ""
        if k == 1:
            scf = (f"; SCF iterations Hamiltonian kernels / plain / f64 "
                   f"{gens[1].pme_force.n_cycle} / "
                   f"{ham_32.getGenerators()[1].pme_force.n_cycle} / "
                   f"{ham_64.getGenerators()[1].pme_force.n_cycle}, direct "
                   f"kernels / plain {pme_k.n_cycle} / {pme_32.n_cycle}")
        log(f"phase 3g {label} launches: {counts}")
        log(f"front end {label}: E {e_k:.6f} (Hamiltonian, kernels), "
            f"{e_dk:.6f} (direct objects, kernels), {float(e_d32):.6f} "
            f"(direct, plain f32) kJ/mol; Hamiltonian vs direct on the "
            f"kernels rel {db:.3e}; vs direct plain f32 energy rel {dc:.3e}, "
            f"force rel RMSE {df:.3e} (plain Hamiltonian vs direct plain "
            f"{rel_rmse(f_32, f_d32):.3e}); forces vs plain f64: kernels "
            f"{rel_rmse(f_k, f_64):.3e}, plain f32 {rel_rmse(f_32, f_64):.3e}"
            f"{scf}")
        require(db < TOL_FE, f"front end {label}: Hamiltonian vs direct {db}")
        require(dc < TOL_STEP_E, f"front end {label}: energy vs plain {dc}")
        require(df < tol_f[k], f"front end {label}: forces vs plain {df}")
        for name in g_k:
            err_k, err_32 = (rel_rmse(g[name], g_64[name]) for g in (g_k, g_32))
            log(f"  dE/d{name}: kernel f32 vs plain f64 rel RMSE {err_k:.3e}, "
                f"plain f32 vs plain f64 {err_32:.3e}")
            require(bool(torch.isfinite(g_k[name]).all()),
                    f"front end dE/d{name} not finite")
            require(err_k <= 2 * err_32 + 1e-6,
                    f"front end dE/d{name}: {err_k} > 2 x {err_32} + 1e-6")
        # the dispersion potential's pair terms are plain PyTorch (XLA code
        # in admp_tpu); its reciprocal space takes the three-channel K4/K6
        want = ["pair_fwd", "pair_bwd", "pair_hvp"] if k == 1 else []
        require(all(counts[c] > 0 for c in want), f"front end {label}: "
                f"a pair kernel never launched ({want})")
        shape = (6, 1) if k == 1 else (6, 3)
        require(counts["spread_by_shape"][shape] > 0
                and counts["gather_by_shape"][shape] > 0,
                f"front end {label}: K4/K6 at {shape} never launched")
    return dict(ham=ham, pots=pots, ham_32=ham_32, pots_32=pots_32,
                stencils=stencils)


# ---------------------------------------------------------------------------
# phase 3h: MD (examples/run_npt.py at --nmol 1000)
# ---------------------------------------------------------------------------


def build_md(device, dtype, method):
    """examples/run_npt.py's system at --nmol 1000, built by the port's
    script (admp_tpu_torch.examples.run_npt.build): fixed multipoles (lmax
    2, the influence grid following the box), Tang-Toennies and the water
    bonded terms, rc 4 A on a cell list with a 1 A skin; a dict with the
    energy(positions, box, pairs) closure."""
    from admp_tpu_torch.examples.run_npt import build

    m = build(N_SIDE ** 3, device, dtype, method)
    require(not bool(m["nl"].did_overflow), "MD cell list overflow")
    return m


def maxwell_velocities(masses, temperature, seed):
    """Velocities (A/ps) drawn from the Maxwell distribution at
    ``temperature`` with an explicit generator on the masses' device."""
    from admp_tpu_torch.md import K_B

    gen = torch.Generator(device=masses.device).manual_seed(seed)
    noise = torch.randn((masses.shape[0], 3), generator=gen,
                        device=masses.device, dtype=masses.dtype)
    return noise * torch.sqrt(K_B * temperature * 100.0 / masses)[:, None]


def nve_drift(m):
    """NVE_STEPS velocity-Verlet steps from Maxwell velocities: (|dE_total|,
    the starting kinetic energy, E_total at start and end)."""
    from admp_tpu_torch.examples import run_npt
    from admp_tpu_torch.md import MDState, _kinetic, run_nve

    box, pairs = m["box"], m["nl"].pairs
    force_fn = run_npt.force_fn(m["energy"], box, pairs)
    v0 = maxwell_velocities(m["masses"], TEMPERATURE, SEED)
    e0, f0, _ = force_fn(m["positions"], None)
    ke0 = float(_kinetic(m["masses"], v0))
    state = MDState(m["positions"], v0, f0, None)
    final, kes = run_nve(force_fn, m["masses"], NVE_DT, state, NVE_STEPS)
    with torch.no_grad():
        e1 = float(m["energy"](final.positions, box, pairs)) + float(kes[-1])
    e0 = float(e0) + ke0
    require(bool(torch.isfinite(final.positions).all()), "NVE not finite")
    return abs(e1 - e0), ke0, e0, e1


def md_path(w):
    """Phase 3h: an NVE segment on the kernels and on the plain f64 path,
    then three NPT segments (Langevin, neighbor-list refresh, one MC
    barostat move) on the kernels with their launch counts. Returns the
    kernel and plain f32 systems for phase 4."""
    from admp_tpu_torch import (
        BAR_TO_KJMOL_A3,
        MDState,
        make_mc_barostat,
        refresh_neighbor_list,
        run_langevin,
    )
    from admp_tpu_torch.examples import run_npt

    dev = w["positions"].device
    kern = build_md(dev, torch.float32, "auto")
    log(f"MD: {kern['positions'].shape[0]} atoms, box "
        f"{float(kern['box'][0, 0]):.3f} A, grid {kern['pme'].K1, kern['pme'].K2, kern['pme'].K3}"
        f", {kern['nl'].pairs.shape[0]} pair slots (cell list, rc "
        f"{RC} + 1 A skin)")
    reset_counts()
    drift_k = nve_drift(kern)
    counts = read_counts()
    drift_64 = nve_drift(build_md(dev, torch.float64, "torch"))
    for label, (de, ke0, e0, e1) in (("kernels f32", drift_k),
                                     ("plain f64", drift_64)):
        log(f"NVE ({label}): {NVE_STEPS} steps of {NVE_DT} ps from Maxwell "
            f"velocities at {TEMPERATURE} K: E_total {e0:.4f} -> {e1:.4f} "
            f"kJ/mol, |dE| {de:.4f} = {de / ke0:.3e} x KE0 ({ke0:.2f})")
        require(de < TOL_NVE * ke0, f"NVE drift ({label}) {de} >= "
                f"{TOL_NVE} x {ke0}")
    log(f"phase 3h NVE launches (kernels): {counts}")
    require(all(counts[k] > 0 for k in ("pair_fwd", "pair_bwd"))
            and counts["spread_by_shape"][6, 1] > 0
            and counts["gather_by_shape"][6, 1] > 0,
            "MD: a kernel never launched in the NVE segment")

    # NPT: Langevin segments, a refresh, one barostat move (run_npt.py)
    barostat = make_mc_barostat(kern["energy"], kern["molecules"],
                                PRESSURE_BAR * BAR_TO_KJMOL_A3, TEMPERATURE,
                                max_dlnv=MAX_DLNV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    box, nl = kern["box"], kern["nl"]
    p0 = kern["positions"]
    state = MDState(p0, torch.zeros_like(p0),
                    run_npt.force_fn(kern["energy"], box, nl.pairs)(p0, None)[1], None)
    for seg in range(NPT_SEGMENTS):
        reset_counts()
        state, kes = run_langevin(run_npt.force_fn(kern["energy"], box, nl.pairs),
                                  kern["masses"], NPT_DT, TEMPERATURE,
                                  FRICTION, state, NPT_STEPS, gen)
        nl = refresh_neighbor_list(nl, state.positions, box)
        n_pairs = nl.pairs.shape[0]
        pos, box_new, acc, e = barostat(state.positions, box, gen, nl.pairs)
        accepted = bool(acc)
        require(torch.equal(box_new, box) != accepted,
                f"NPT segment {seg}: the box changed if and only if the "
                f"move was rejected (accepted {accepted})")
        box = box_new
        if accepted:
            nl = refresh_neighbor_list(nl, pos, box)
        forces = run_npt.force_fn(kern["energy"], box, nl.pairs)(pos, None)[1]
        state = state._replace(positions=pos, forces=forces)
        counts = read_counts()
        t_inst = 2.0 * float(kes[-1]) / (3.0 * p0.shape[0] * 0.00831446261815324)
        log(f"NPT segment {seg}: E {float(e):.3f} kJ/mol, V "
            f"{abs(float(torch.det(box.double()))):.1f} A^3, T_inst "
            f"{t_inst:.1f} K, barostat {'accept' if accepted else 'reject'}, "
            f"pair slots {n_pairs} -> {nl.pairs.shape[0]}; launches "
            f"K1 {counts['pair_fwd']}, K2 {counts['pair_bwd']}, K4 "
            f"{counts['spread_by_shape'][6, 1]}, K6 "
            f"{counts['gather_by_shape'][6, 1]}")
        require(all(bool(torch.isfinite(x).all()) for x in
                    (state.positions, state.velocities, state.forces, kes,
                     box, e)), f"NPT segment {seg}: not finite")
        require(counts["pair_fwd"] > 0 and counts["spread_by_shape"][6, 1] > 0,
                f"NPT segment {seg}: a kernel never launched")
    plain = build_md(dev, torch.float32, "torch")
    return kern, plain


def time_front_end(front, w, card):
    """Phase 4 of the front end: ms per energy+force of each Hamiltonian
    potential (kernels and plain f32; the polarizable one starts its SCF
    cold on every call, as the front end does), and K4/K6 at (6, 1) and
    (6, 3) on its 171^3 meshes beside their plain versions, the one
    PyTorch call (index_add / take) and the bound; logged."""
    for k, label in enumerate(("dispersion", "polarizable")):
        out = []
        for route, ham, pots in (("kernels", front["ham"], front["pots"]),
                                 ("plain f32", front["ham_32"],
                                  front["pots_32"])):
            gen = ham.getGenerators()[k]

            def run(n, pot=pots[k], gen=gen):
                p = w["positions"]
                for _ in range(n):
                    x = p.detach().requires_grad_(True)
                    e = pot(x, w["box"], w["ff_pairs"], gen.params)
                    (g,) = torch.autograd.grad(e, x)
                    p = p + w["drift"] + 0.0 * g
                return [float(e.detach())]

            ms, times, _ = time_runs(run, 3)
            out.append(f"{route} {ms:.3f} ({[round(t, 3) for t in times]})")
        log(f"phase 4 [{card}]: Hamiltonian {label} energy+force, ms/call "
            "(median of 3 x 3): " + "; ".join(out))
    for (order, n_ch), (m_u0, q, g_mesh) in front["stencils"].items():
        grid = tuple(g_mesh.shape[1:])
        for name, (kern, plain, lib, (b_s, b_by)) in spread_calls(
                m_u0, q, g_mesh, order).items():
            ms, dev_ms = cuda_time_ms(kern)
            p_ms, p_dev = cuda_time_ms(plain)
            l_ms, l_dev = cuda_time_ms(lib)
            log(f"phase 4 [{card}]: front end {grid} ({order}, {n_ch}) "
                f"{name}: {ms:.4f} ms/call ({dev_ms:.4f} ms device), plain "
                f"{p_ms:.4f} ({p_dev:.4f} device), one PyTorch call "
                f"{l_ms:.4f} ({l_dev:.4f} device), bound {b_s * 1e3:.4f} ms "
                f"({b_by})")


def langevin_runner(m):
    """run(n): n Langevin steps of the 3h system from its start (the first
    forces taken once, here), for phase 4; returns [the last KE]."""
    from admp_tpu_torch import MDState, run_langevin
    from admp_tpu_torch.examples import run_npt

    force_fn = run_npt.force_fn(m["energy"], m["box"], m["nl"].pairs)
    p0 = m["positions"]
    state0 = MDState(p0, torch.zeros_like(p0), force_fn(p0, None)[1], None)
    gen = torch.Generator(device=p0.device).manual_seed(SEED)

    def run(n):
        _, kes = run_langevin(force_fn, m["masses"], NPT_DT, TEMPERATURE,
                              FRICTION, state0, n, gen)
        return [float(kes[-1])]

    return run


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


def large_force(w, config, dtype):
    """The example's force under ``config``: fixed multipoles, lmax 2, its
    sparse exclusions."""
    from admp_tpu_torch import ADMPPmeForce

    s = w["sys"]
    return ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                        w["sparse"], RC, ETHRESH, lmax=LMAX, config=config,
                        device=w["positions"].device, dtype=dtype)


def make_large_force(w, dtype, pair_kernel, spread_method, k=None):
    """The example's force: the 5-smooth grid (320^3 here), i-sorted pairs;
    ``k`` sets K1..K3 as its --k does."""
    from admp_tpu_torch import EngineConfig

    force = large_force(w, EngineConfig(
        fft_friendly_grid=True, pairs_i_sorted=True, pair_kernel=pair_kernel,
        spread_method=spread_method), dtype)
    if k:
        force.K1 = force.K2 = force.K3 = k
        force.refresh_calculators()
    return force


def large_args(w, positions, dtype):
    from admp_tpu_torch.examples.fluctuating_multipoles import (
        fluctuating_q_local,
    )

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


def large_stencil(w, grid, order=6, precision=None):
    """The 98k step's energy-mesh stencil values at its first step; with
    ``precision='f64'`` computed in float64 and rounded to float32, as
    spread_precision='f64' feeds the spread."""
    from admp_tpu_torch.examples.fluctuating_multipoles import (
        fluctuating_q_local,
    )
    from admp_tpu_torch.ops.reciprocal import atom_spread_alpha, spread_points_separable

    q_local = fluctuating_q_local(w["positions"], w["q_cart"])
    m_u0, u0, alpha = atom_spread_alpha(w["positions"], w["box"], q_local,
                                        grid, LMAX, order, precision)
    q = spread_points_separable(u0, alpha, LMAX, order).float()
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


def check_tiled(grid, order, m_u0, q, rng, label=""):
    """K5 against its plain version and the plain spread (TOL_SPREAD of
    max|mesh|; the same mesh on a second launch) and K7 bit for bit
    against its plain version and the plain gather, on one case; returns
    (K5's max abs error, K7's, the random cotangent mesh)."""
    from admp_tpu_torch.ops.cuda import spread as S

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
    g_mesh = torch.tensor(rng.standard_normal((n_ch, *grid)), device=q.device,
                          dtype=torch.float32)
    out_k = S.launch_gather_tiled(bins, g_mesh, grid, order)
    out_t = S.gather_tiled_torch(bins, g_mesh, grid, order)
    same = (torch.equal(out_k, out_t)
            and torch.equal(out_k, S.gather_torch(m_u0, g_mesh, grid, order)))
    log(f"tiled spread (K5){label} order {order} C={n_ch} N={m_u0.shape[0]} "
        f"grid={grid}, at most {crowd} atoms in a bin: max abs err "
        f"{err:.3e} = {err / scale:.3e} x max|mesh| vs its plain "
        f"version, {err_p / scale:.3e} vs the plain spread; the same "
        f"mesh on a second launch {det}; tiled gather (K7) bitwise "
        f"equal {same}")
    require(err <= TOL_SPREAD * scale and err_p <= TOL_SPREAD * scale,
            f"tiled spread{label} order {order} C={n_ch} {grid}: "
            f"{err / scale}")
    require(det, f"tiled spread{label} order {order} C={n_ch} {grid}: "
            "another mesh on a second launch")
    require(same, f"tiled gather{label} order {order} C={n_ch} {grid} "
            "differs")
    return err, float((out_k - out_t).abs().max()), g_mesh


def check_spread_tiled(w, record):
    """K5 and K7 against their plain versions (and the plain spread and
    gather) at the 98k shapes: (6, 1) at 320^3 and 256^3 on the step's
    stencils, (4, 3) at 320^3 on random stencil values, and K5 on one
    crowded tile at (6, 1) and (4, 3) (check_tiled)."""
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
        err, err_g, g_mesh = check_tiled(grid, order, m_u0, q, rng)
        if "_tiled_inputs" not in record:  # the step's stencils at 320^3
            record["spread_tiled"]["max_abs_err"] = err
            record["gather_tiled"]["max_abs_err"] = err_g
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


# ---------------------------------------------------------------------------
# phase 3i: the precision modes (examples/precision_tpu.py's ladder)
# ---------------------------------------------------------------------------

# the ladder: name, EngineConfig keywords or preset, its bound on the force
# relative RMSE against the plain f64 path at the same grid and on |dE|
# (kJ/mol), None where the row is logged; admp_tpu's CPU tests' bounds
# (tests/test_precision.py:65-113, tests/test_ds.py:193-235)
LADDER = [
    ("plain-f32", dict(compensated_sums=False), 5e-3, None),
    ("high_accuracy", "high_accuracy", 5e-6, 0.05),
    ("f64-all", ("high_accuracy", dict(realspace_precision="f64-all")),
     1e-6, 1e-3),
    ("f64-all+f64-dft", ("high_accuracy", dict(
        realspace_precision="f64-all", recip_precision="f64-dft")),
     1e-6, 1e-3),
    ("ds_accuracy", "ds_accuracy", 2e-6, None),
    ("spread-f64", dict(spread_precision="f64"), None, None),
    ("recip-ds", dict(recip_precision="ds"), None, None),
]
# the DS engine alone against the f64 reciprocal (tests/test_ds.py:116-155)
TOL_DS_E, TOL_DS_G = 1e-10, 5e-7
# the DS primitives against numpy float64 (tests/test_ds.py:19-63)
TOL_DS_OPS, TOL_DS_POW, TOL_DS_FN, TOL_DS_SUM = 1e-13, 1e-10, 1e-10, 1e-14
# ladder rows timed over fewer drift steps: the DS engine runs ~10^4 plain
# PyTorch operations per step
N_LADDER_STEPS, N_DS_STEPS = 10, 3


def ladder_config(spec, method, **extra):
    from admp_tpu_torch import EngineConfig

    kw = dict(pair_kernel=method, spread_method=method, **extra)
    if isinstance(spec, str):
        return getattr(EngineConfig, spec)(**kw)
    if isinstance(spec, tuple):
        return getattr(EngineConfig, spec[0])(**spec[1], **kw)
    return EngineConfig(**spec, **kw)


def ladder_force(w, config, dtype, lpol=False, grid=None):
    from admp_tpu_torch import ADMPPmeForce

    s = w["sys"]
    force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                         s["covalent_map"], RC, ETHRESH, lmax=LMAX, lpol=lpol,
                         config=config, device=w["positions"].device,
                         dtype=dtype)
    if grid is not None:
        force.K1, force.K2, force.K3 = grid
        force.refresh_calculators()
    return force


def fixed_step(force, w, positions, dtype=torch.float32):
    c = lambda t: t.to(dtype)  # noqa: E731
    return force.get_forces(c(positions), c(w["box"]), w["pairs"],
                            c(w["q_local"]), c(w["scales"]))


def check_ds_primitives(dev):
    """The DS arithmetic and FFTs on the card against numpy float64."""
    from scipy.special import erfc

    from admp_tpu_torch.ops import dsrecip
    from admp_tpu_torch.utils import ds

    def rel(got, ref):
        got = ds.to_f64(got).cpu().numpy()
        return float(np.max(np.abs(got - ref)
                            / np.maximum(np.abs(ref), 1e-300)))

    rng = np.random.RandomState(0)
    a = rng.randn(2000) * np.exp(rng.randn(2000) * 3)
    b = rng.randn(2000) * np.exp(rng.randn(2000) * 3)
    A, B = ds.from_f64(a, dev), ds.from_f64(b, dev)
    got = ds.to_f64(ds.add(A, B)).cpu().numpy()
    errs = {"add": float(np.max(np.abs(got - (a + b))
                                / np.maximum(np.abs(a), np.abs(b)))),
            "mul": rel(ds.mul(A, B), a * b), "div": rel(ds.div(A, B), a / b),
            "sqrt": rel(ds.sqrt(ds.from_f64(np.abs(a), dev)),
                        np.sqrt(np.abs(a))),
            "npow": rel(ds.npow(A, 5), a ** 5)}
    x = np.linspace(-60.0, 3.0, 3000)
    y = np.concatenate([np.linspace(1e-6, 0.468, 500),
                        np.linspace(0.469, 3.99, 1500),
                        np.linspace(4.0, 7.0, 500)])
    errs["exp"] = rel(ds.exp(ds.from_f64(x, dev)), np.exp(x))
    errs["erfc"] = rel(ds.erfc(ds.from_f64(y, dev)), erfc(y))
    c = np.random.RandomState(1).randn(4097) * np.exp(
        np.random.RandomState(2).randn(4097) * 4)
    s = float(ds.to_f64(ds.sum_pairs(ds.from_f64(c, dev))))
    errs["sum_pairs"] = abs(s - c.sum()) / np.abs(c).sum()
    m = np.random.RandomState(3).randn(32, 64, 128)
    re, im = dsrecip.ds_fft3(ds.from_f64(m, dev),
                             ds.from_f64(np.zeros_like(m), dev))
    ref = np.fft.fftn(m)
    got = ds.to_f64(re).cpu().numpy() + 1j * ds.to_f64(im).cpu().numpy()
    errs["ds_fft3"] = float(np.abs(got - ref).max() / np.abs(ref).max())
    back = ds.to_f64(dsrecip.ds_irfft3(*dsrecip.ds_rfft3(
        ds.from_f64(m, dev)))).cpu().numpy()
    errs["ds_irfft3(ds_rfft3)"] = float(np.abs(back - m.size * m).max()
                                        / (m.size * np.abs(m).max()))
    log("phase 3i DS primitives vs numpy float64 (max relative): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    bounds = dict(add=TOL_DS_OPS, mul=TOL_DS_OPS, div=TOL_DS_OPS,
                  sqrt=TOL_DS_OPS, npow=TOL_DS_POW, exp=TOL_DS_FN,
                  erfc=TOL_DS_FN, sum_pairs=TOL_DS_SUM)
    bounds["ds_fft3"] = bounds["ds_irfft3(ds_rfft3)"] = TOL_DS_OPS
    for k, v in errs.items():
        require(v < bounds[k], f"DS {k} error {v} >= {bounds[k]}")
    return errs


def ladder_path(w):
    """The ladder on the main path's box: each mode's f32 energy+force step
    on the kernels against the plain f64 path at the same grid and against
    its own plain f32 route, with launch counts; returns the kernel-route
    forces by mode for phase 4 and the results."""
    dev = w["positions"].device
    oracles, results, forces = {}, {}, {}
    for name, spec, tol_f, tol_e in LADDER:
        kern = ladder_force(w, ladder_config(spec, "auto"), torch.float32)
        grid = (kern.K1, kern.K2, kern.K3)
        if grid not in oracles:
            oracle = ladder_force(w, ladder_config({}, "torch"),
                                  torch.float64, grid=grid)
            oracle.kappa = kern.kappa
            oracle.refresh_calculators()
            oracles[grid] = fixed_step(oracle, w, w["positions"],
                                       torch.float64)
        e64, g64 = oracles[grid]
        reset_counts()
        e_k, g_k = fixed_step(kern, w, w["positions"])
        counts = read_counts()
        plain = ladder_force(w, ladder_config(spec, "torch"), torch.float32)
        e_p, g_p = fixed_step(plain, w, w["positions"])
        err = rel_rmse(g_k, g64)
        de = float(e_k) - float(e64)
        dkp = rel_rmse(g_k, g_p)
        results[name] = dict(grid=grid, force_rel_rmse=err, dE=de,
                             plain_f32_force_rel_rmse=rel_rmse(g_p, g64),
                             kernel_vs_plain=dkp,
                             launches={k: counts[k] for k in (
                                 "pair_fwd", "pair_bwd", "spread", "gather")})
        log(f"phase 3i ladder {name} at {grid}: force rel RMSE vs plain f64 "
            f"{err:.3e} (bound {tol_f}), dE {de:+.3e} kJ/mol (bound "
            f"{tol_e}); plain f32 route {rel_rmse(g_p, g64):.3e}; kernel vs "
            f"plain f32 route {dkp:.3e}; launches "
            f"{results[name]['launches']}")
        require(bool(torch.isfinite(g_k).all()) and bool(torch.isfinite(e_k)),
                f"ladder {name}: non-finite energy or forces")
        require(dkp < TOL_STEP_F, f"ladder {name}: kernel vs plain f32 {dkp}")
        if tol_f is not None:
            require(err < tol_f, f"ladder {name}: force error {err} >= {tol_f}")
        if tol_e is not None:
            require(abs(de) < tol_e, f"ladder {name}: |dE| {de} >= {tol_e}")
        # K1/K2 once per step; twice under 'f64-near' (the main pass and the
        # near pass); never under 'f64-all' (every pair in float64)
        want = {"f64-all": 0, "f64-near": 2}.get(
            kern.config.realspace_precision, 1)
        require(counts["pair_fwd"] == want and counts["pair_bwd"] == want,
                f"ladder {name}: K1/K2 launched {counts['pair_fwd']}/"
                f"{counts['pair_bwd']} times, want {want}")
        f32_mesh = kern.config.recip_precision is None
        require((counts["spread"] > 0 and counts["gather"] > 0) == f32_mesh,
                f"ladder {name}: K4/K6 launched {counts['spread']}/"
                f"{counts['gather']} times with an f32 mesh {f32_mesh}")
        forces[name] = kern
    ds = results["ds_accuracy"]
    require(ds["force_rel_rmse"] < results["plain-f32"]["force_rel_rmse"] / 10,
            "ds_accuracy is not a tenth of plain f32's error")
    return forces, results


def ds_recip_inputs(w, kappa, grid):
    """The main path box's global multipoles (frames of the f32 positions)
    and the two engines at ``grid``: the DS engine and the plain f64 one."""
    from admp_tpu_torch.ops.dsrecip import make_ds_pme_recip
    from admp_tpu_torch.ops.frames import local_frames_components
    from admp_tpu_torch.ops.harmonics import rot_local2global_components
    from admp_tpu_torch.ops.influence import ck_1
    from admp_tpu_torch.ops.reciprocal import make_pme_recip
    from admp_tpu_torch.utils.constants import DIELECTRIC

    s, dev = w["sys"], w["positions"].device
    frames = local_frames_components(
        w["positions"], w["box"], torch.as_tensor(s["axis_types"], device=dev),
        torch.as_tensor(s["axis_indices"], device=dev))
    q = rot_local2global_components(w["q_local"], frames, LMAX).detach()
    engines = {
        "ds": make_ds_pme_recip(kappa, grid, LMAX, DIELECTRIC),
        "f64": make_pme_recip(ck_1, kappa, grid, LMAX, DIELECTRIC,
                              recip_precision="f64"),
        "plain64": make_pme_recip(ck_1, kappa, grid, LMAX, DIELECTRIC,
                                  spread_method="torch")}
    return q, engines


def count_syncs(fn):
    """Host syncs that fn() makes on the card: torch.cuda's sync debug mode
    warns once for each synchronizing call (a device-to-host read, a
    host-to-device copy from pageable memory, a stream synchronize)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(c.message)
               for c in caught)


def recip_energy_force(engine, w, q, dtype):
    p = w["positions"].to(dtype).requires_grad_(True)
    qq = q.to(dtype).requires_grad_(True)
    e = engine(p, w["box"].to(dtype), qq)
    gp, gq = torch.autograd.grad(e, (p, qq))
    return e.detach(), gp, gq


def ds_engine_path(w, kappa, grid):
    """The DS engine alone against the plain f64 reciprocal engine on the
    main path's positions and global multipoles at the DS grid."""
    q, engines = ds_recip_inputs(w, kappa, grid)
    e_ds, gp, gq = recip_energy_force(engines["ds"], w, q, torch.float32)
    e64, rp, rq = recip_energy_force(engines["plain64"], w, q, torch.float64)
    de = abs(float(e_ds) - float(e64)) / abs(float(e64))
    errs = (rel_rmse(gp, rp), rel_rmse(gq, rq))
    log(f"phase 3i DS engine alone at {grid}: energy rel {de:.3e} (bound "
        f"{TOL_DS_E}), dE/dx rel RMSE {errs[0]:.3e}, dE/dq {errs[1]:.3e} "
        f"(bound {TOL_DS_G}) vs the plain f64 engine")
    require(de < TOL_DS_E, f"DS engine energy {de}")
    require(max(errs) < TOL_DS_G, f"DS engine gradients {errs}")
    return dict(energy_rel=de, dx_rel_rmse=errs[0], dq_rel_rmse=errs[1])


def ds_polarizable_path(w):
    """The polarizable exact-adjoint step (SCFConfig()) under ds_accuracy()
    on the kernels against the same configuration on the plain f32 path;
    K3 must launch."""
    from admp_tpu_torch import SCFConfig

    scf = SCFConfig()
    kern = ladder_force(w, ladder_config("ds_accuracy", "auto", scf=scf),
                        torch.float32, lpol=True)
    plain = ladder_force(w, ladder_config("ds_accuracy", "torch", scf=scf),
                         torch.float32, lpol=True)
    reset_counts()
    e_k, g_k = kern.get_forces(*pol_args(w, w["positions"], torch.float32))
    counts = read_counts()
    e_p, g_p = plain.get_forces(*pol_args(w, w["positions"], torch.float32))
    df = rel_rmse(g_k, g_p)
    log(f"phase 3i polarizable ds_accuracy() exact adjoint at "
        f"{(kern.K1, kern.K2, kern.K3)}: E {float(e_k):.6f} vs plain f32 "
        f"{float(e_p):.6f}, force rel RMSE {df:.3e} (bound {TOL_ADJ_F}), "
        f"PCG iterations {kern.n_cycle} / {plain.n_cycle}; launches "
        f"{counts}")
    require(kern.lconverg and plain.lconverg, "ds_accuracy SCF did not converge")
    require(bool(torch.isfinite(g_k).all()), "ds_accuracy pol forces")
    require(df < TOL_ADJ_F, f"ds_accuracy exact adjoint forces {df}")
    require(counts["pair_hvp"] > 0 and counts["pair_fwd"] > 0,
            "K3 or K1 did not launch on the ds_accuracy exact adjoint")
    return kern, dict(force_rel_rmse=df, launches=counts["pair_hvp"])


def precision_path(w):
    """Phase 3i; returns what phase 4 times and the results."""
    out = {"ds_primitives": check_ds_primitives(w["positions"].device)}
    forces, out["ladder"] = ladder_path(w)
    ds = forces["ds_accuracy"]
    out["ds_engine"] = ds_engine_path(w, ds.kappa, (ds.K1, ds.K2, ds.K3))
    pol, out["ds_polarizable"] = ds_polarizable_path(w)
    return forces, pol, out


def time_precision(forces, pol, w, card, out):
    """Phase 4 of the ladder: ms/step of each mode on the kernels (median of
    N_REPEATS x N_LADDER_STEPS drift steps, forces consumed; the DS rows
    over N_DS_STEPS), the DS and f64 reciprocal engines' energy+force at
    the DS grid with their force errors, and one profiler window of a
    ds_accuracy() step."""
    def runner(force):
        def run(n):
            p = w["positions"]
            for _ in range(n):
                _, g = fixed_step(force, w, p)
                p = p + w["drift"] + 0.0 * g
            return [0] * n
        return run

    timing = {}
    for name, force in forces.items():
        n = (N_DS_STEPS if force.config.recip_precision == "ds"
             else N_LADDER_STEPS)
        ms, times, _ = time_runs(runner(force), n)
        timing[name] = dict(ms=ms, times=times, steps=n)
        log(f"phase 4 [{card}]: ladder {name}: {ms:.3f} ms/step (median of "
            f"{N_REPEATS} x {n} steps: {[round(t, 3) for t in times]})")
    ds = forces["ds_accuracy"]
    grid = (ds.K1, ds.K2, ds.K3)
    q, engines = ds_recip_inputs(w, ds.kappa, grid)
    _, rp, _ = recip_energy_force(engines["plain64"], w, q, torch.float64)
    recip = {}
    for name in ("ds", "f64"):
        eng = engines[name]
        ms, _ = cuda_time_ms(
            lambda eng=eng: recip_energy_force(eng, w, q, torch.float32),
            n=5, warmup=1)
        _, gp, _ = recip_energy_force(eng, w, q, torch.float32)
        syncs = count_syncs(
            lambda eng=eng: recip_energy_force(eng, w, q, torch.float32))
        recip[name] = dict(ms=ms, force_rel_rmse=rel_rmse(gp, rp),
                           host_syncs=syncs)
    log(f"phase 4 [{card}]: reciprocal energy+force at {grid} on the main "
        f"path's box: 'ds' {recip['ds']['ms']:.3f} ms (dE/dx rel RMSE "
        f"{recip['ds']['force_rel_rmse']:.3e} vs plain f64, "
        f"{recip['ds']['host_syncs']} host syncs), 'f64' "
        f"{recip['f64']['ms']:.3f} ms ({recip['f64']['force_rel_rmse']:.3e}, "
        f"{recip['f64']['host_syncs']} host syncs)")
    require(recip["ds"]["host_syncs"] == 0,
            f"the DS engine synchronizes {recip['ds']['host_syncs']} times "
            "per energy+force (its constants belong on the card)")
    step_syncs = count_syncs(lambda: runner(ds)(1))
    log(f"phase 4 [{card}]: host syncs in one ds_accuracy() step: "
        f"{step_syncs}")
    wall, device_ms, n_kernels, top = profile_steps(runner(ds), "ds_accuracy",
                                                    n_steps=1)
    log(f"profile ds_accuracy (1 warm step, profiler on): {wall:.3f} ms/step "
        f"wall, {device_ms:.3f} ms/step device busy "
        f"({100 * device_ms / wall:.1f}%), {n_kernels:.0f} device "
        "kernels/step; top by device time:")
    for key, ms_k, count in top:
        log(f"  {ms_k:8.4f} ms/step  x{count:<4d} {key}")
    ms_pol, times_pol, _ = time_runs(
        lambda n: [s[1] for s in run_steps(pol, w, w["positions"], n)[1]], 1)
    log(f"phase 4 [{card}]: polarizable ds_accuracy() exact-adjoint step "
        f"{ms_pol:.3f} ms/step (median of {N_REPEATS} x 1 steps: "
        f"{[round(t, 3) for t in times_pol]})")
    out.update(timing=timing, recip=recip, pol_ms=ms_pol,
               ds_step_host_syncs=step_syncs,
               profile=dict(wall_ms=wall, device_ms=device_ms,
                            kernels=n_kernels), card=card)
    (OUT_DIR / "precision.json").write_text(json.dumps(out, indent=1))


# ---------------------------------------------------------------------------
# phase 3m: the precision modes on the polarizable MD step
# ---------------------------------------------------------------------------

# ladder rows on the main path's polarizable MD step (SCFConfig.md(), cached
# influence), at the constructor's grid as in 3i (96^3; the DS rows 128^3);
# plain-f32 is the baseline of the PCG iterations. high_accuracy() and
# ds_accuracy() keep the float32 pass of the polarizable ('pol') pairs;
# 'f64-all' is high_accuracy() with every pair in float64, and
# POL_WITNESS's row is ds_accuracy() so: the two hold the LADDER bound
# alone, which shows whether the float32 pair pass is what sets the
# others' error on this step
POL_WITNESS = {"ds_accuracy+f64-all": (
    ("ds_accuracy", dict(realspace_precision="f64-all")), 2e-6, None)}
POL_LADDER = ("plain-f32", "high_accuracy", "f64-all", "spread-f64",
              "ds_accuracy", "ds_accuracy+f64-all")
N_POL_LADDER_STEPS = 4  # a cold step and 3 drift steps
# K1/K2 launches per energy evaluation by realspace_precision (default 1):
# none under 'f64-all' (every pair in float64), two under 'f64-near' (the
# main and the near pass); an MD step evaluates the energy twice (the field
# at the warm start, then the energy at u*), each with its backward
REAL_PASSES = {"f64-all": 0, "f64-near": 2}


def pol_ladder_force(w, spec, method, dtype, grid=None, matvec_order=None):
    """A row's MD-profile force; ``matvec_order`` replaces the profile's
    order-4 matvec mesh."""
    import dataclasses

    from admp_tpu_torch import SCFConfig

    scf = SCFConfig.md()
    if matvec_order is not None:
        scf = dataclasses.replace(scf, matvec_spread_order=matvec_order)
    return ladder_force(w, ladder_config(spec, method, scf=scf,
                                         cache_influence=True),
                        dtype, lpol=True, grid=grid)


def pol_steps(force, w, n_steps, dtype=torch.float32):
    """n_steps polarizable steps from the main path's positions, drifting in
    float32 whatever ``dtype`` (forces consumed, dipoles carried): per step
    (energy, forces, induced dipoles, PCG iterations, converged), and the
    PCG matvecs they took (calls of the force's u-quadratic energy)."""
    energy_uu, calls = force.energy_uu, [0]

    def counted(*args):
        calls[0] += 1
        return energy_uu(*args)

    force.energy_uu = counted
    try:
        p, out = w["positions"], []
        for _ in range(n_steps):
            e, g = force.get_forces(*pol_args(w, p, dtype))
            out.append((e, g, force.U_ind, force.n_cycle, force.lconverg))
            p = p + w["drift"] + 0.0 * g.to(p.dtype)
    finally:
        force.energy_uu = energy_uu
    return out, calls[0]


def step_errors(run, ref):
    """The largest, over the steps, force and dipole relative RMSE and
    |dE| (kJ/mol) of ``run`` against ``ref`` (pol_steps' lists)."""
    return dict(f=max(rel_rmse(a[1], b[1]) for a, b in zip(run, ref)),
                u=max(rel_rmse(a[2], b[2]) for a, b in zip(run, ref)),
                e=max(abs(float(a[0]) - float(b[0]))
                      for a, b in zip(run, ref)))


def json_counts(counts, keys):
    """The launch counts of ``keys``, their (order, C) keys as strings."""
    return {k: ({f"{o},{c}": v for (o, c), v in counts[k].items()}
                if k.endswith("by_shape") else counts[k]) for k in keys}


def peak_bytes(fn):
    """(fn(), the card's peak allocated bytes while it ran, above what was
    allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def pol_ladder_path(w):
    """Phase 3m: each POL_LADDER row's MD steps on the kernels against the
    plain float64 path at the same grid and kappa (energy, forces, induced
    dipoles) and against the same mode's plain f32 route, with the K1/K2
    launches by kind, the PCG iterations and the peak memory; returns the
    kernel-route forces for phase 4 and the results."""
    lad = dict({row[0]: row[1:] for row in LADDER}, **POL_WITNESS)
    n = N_POL_LADDER_STEPS
    oracles, results, forces = {}, {}, {}
    for name in POL_LADDER:
        spec, tol_f, tol_e = lad[name]
        kern = pol_ladder_force(w, spec, "auto", torch.float32)
        grid = (kern.K1, kern.K2, kern.K3)
        # the DS engine spreads at order 6 only (both packages), so the DS
        # row's matvec mesh is order 6 where the profile's is order 4: its
        # float64 oracle runs the same matvec
        mv_order = 6 if kern.config.recip_precision == "ds" else None
        if (grid, mv_order) not in oracles:
            oracle = pol_ladder_force(w, {}, "torch", torch.float64, grid,
                                      mv_order)
            oracle.kappa = kern.kappa
            oracle.refresh_calculators()
            require(oracle.matvec_grid == kern.matvec_grid,
                    f"phase 3m oracle matvec grid {oracle.matvec_grid}")
            ref = pol_steps(oracle, w, n, torch.float64)[0]
            with torch.no_grad():
                terms = oracle.get_metrics(*pol_args(w, w["positions"],
                                                     torch.float64))
            oracles[grid, mv_order] = ref, max(
                abs(float(terms[t])) for t in ("e_real", "e_recip", "e_self"))
        ref, e_scale = oracles[grid, mv_order]
        reset_counts()
        (steps, matvecs), peak = peak_bytes(lambda: pol_steps(kern, w, n))
        counts = read_counts()
        plain, _ = pol_steps(pol_ladder_force(w, spec, "torch",
                                              torch.float32), w, n)
        ek, ep, ekp = (step_errors(steps, ref), step_errors(plain, ref),
                       step_errors(steps, plain))
        # the total is a residue of ~1e6 kJ/mol terms: energies are set
        # over the largest of them (the plain f64 path's first step), as
        # the 98k step's (TOL_E98)
        de_kp = ekp["e"] / e_scale
        iters = {"kernel": [s[3] for s in steps], "plain32": [s[3] for s in
                                                             plain],
                 "plain64": [s[3] for s in ref]}
        # the bound of the row: admp_tpu's tests set none for a polarizable
        # path, so max(the row's fixed-box bound in LADDER, 2 x the same
        # mode's plain f32 route's own error against float64); a row without
        # an energy bound in LADDER also within the plain route's own +
        # TOL_E98 of the largest term (the kernel-vs-plain energy gate below
        # implies it; at the f32 floor the two routes' residues differ by
        # more than 2x). A row with every pair in float64 holds the LADDER
        # bound on forces and dipoles alone: the witness that the others'
        # widening is the float32 pair pass's (POL_WITNESS)
        all64 = kern.config.realspace_precision == "f64-all"
        bound = dict(f=tol_f if all64 else max(tol_f or 0.0, 2 * ep["f"]),
                     u=tol_f if all64 else max(tol_f or 0.0, 2 * ep["u"]),
                     e=(max(tol_e, 2 * ep["e"]) if tol_e is not None else
                        max(2 * ep["e"], ep["e"] + TOL_E98 * e_scale)))
        want_pol = 2 * REAL_PASSES.get(kern.config.realspace_precision, 1) * n
        results[name] = dict(
            grid=grid, matvec_grid=kern.matvec_grid, vs_f64=ek,
            plain32_vs_f64=ep, e_scale=e_scale,
            kernel_vs_plain32=dict(ekp, e_over_term=de_kp),
            bound=bound, iterations=iters, matvecs=matvecs,
            peak_bytes=peak,
            launches=json_counts(counts, (
                "pair_fwd_by_kind", "pair_bwd_by_kind", "pair_hvp",
                "spread_by_shape", "gather_by_shape")))
        log(f"phase 3m {name} at {grid} (matvec {kern.matvec_grid}), "
            f"{n} MD steps: vs plain f64 forces {ek['f']:.3e}, dipoles "
            f"{ek['u']:.3e}, |dE| {ek['e']:.3e} kJ/mol (bounds "
            f"{bound['f']:.3e}, {bound['u']:.3e}, {bound['e']:.3e}; the "
            f"plain f32 route {ep['f']:.3e}, {ep['u']:.3e}, {ep['e']:.3e}); "
            f"kernel vs plain f32 route forces {ekp['f']:.3e}, dipoles "
            f"{ekp['u']:.3e}, |dE| {ekp['e']:.3e} kJ/mol = {de_kp:.3e} of "
            f"the largest term ({e_scale:.1f}); PCG iterations "
            f"{iters}; {matvecs} matvecs; peak {peak / 2**20:.1f} MiB; "
            f"launches K1 {counts['pair_fwd_by_kind']}, K2 "
            f"{counts['pair_bwd_by_kind']}, K4 (6, 1) "
            f"{counts['spread_by_shape'][6, 1]}, K6 (6, 1) "
            f"{counts['gather_by_shape'][6, 1]}")
        require(all(s[4] for s in steps + plain + ref),
                f"phase 3m {name}: SCF did not converge")
        require(all(bool(torch.isfinite(s[1]).all())
                    and bool(torch.isfinite(s[0])) for s in steps),
                f"phase 3m {name}: non-finite energy or forces")
        for k in ("f", "u", "e"):
            require(ek[k] < bound[k], f"phase 3m {name}: {k} vs f64 "
                    f"{ek[k]} >= {bound[k]}")
        require(ekp["f"] < TOL_STEP_F and ekp["u"] < TOL_STEP_F,
                f"phase 3m {name}: kernel vs plain f32 {ekp}")
        require(de_kp < TOL_E98, f"phase 3m {name}: energy {de_kp}")
        for k in ("pair_fwd_by_kind", "pair_bwd_by_kind"):
            kinds = counts[k]
            require(kinds["pol"] == want_pol and kinds["uu"] == matvecs
                    and kinds["perm"] == 0,
                    f"phase 3m {name}: {k} {kinds}, want pol {want_pol}, "
                    f"uu {matvecs} (one per PCG matvec)")
        require(sum(iters["kernel"]) == matvecs and counts["pair_hvp"] == 0,
                f"phase 3m {name}: {matvecs} matvecs for iterations "
                f"{iters['kernel']}, K3 {counts['pair_hvp']}")
        # K4/K6 twice per step on an f32 energy mesh (the matvec's order-4
        # mesh stays on index_add_), never on a float64 or DS one
        want_mesh = 2 * n if kern.config.recip_precision is None else 0
        require(counts["spread_by_shape"][6, 1] == want_mesh
                and counts["gather_by_shape"][6, 1] == want_mesh,
                f"phase 3m {name}: K4/K6 (6, 1) launched "
                f"{counts['spread_by_shape'][6, 1]}/"
                f"{counts['gather_by_shape'][6, 1]} times, want {want_mesh}")
        forces[name] = kern
    base = sum(results["plain-f32"]["iterations"]["kernel"])
    more = {k: sum(r["iterations"]["kernel"]) for k, r in results.items()
            if sum(r["iterations"]["kernel"]) > base}
    log(f"phase 3m: PCG iterations over the {n} steps against plain-f32's "
        f"{base}: " + (f"more under {more}" if more else "none more"))
    for f32_pass, all64 in (("high_accuracy", "f64-all"),
                            ("ds_accuracy", "ds_accuracy+f64-all")):
        a, b = results[f32_pass]["vs_f64"], results[all64]["vs_f64"]
        log(f"phase 3m: the float32 pair pass, forces vs plain f64 "
            f"{f32_pass} {a['f']:.3e} against {all64} {b['f']:.3e}, dipoles "
            f"{a['u']:.3e} against {b['u']:.3e}")
    return forces, results


def time_pol_ladder(forces, w, card, out):
    """Phase 4 of 3m: each row's ms per MD step on the kernels (median of
    N_REPEATS x N_LADDER_STEPS drift steps, the DS row N_DS_STEPS), and one
    profiler window of a high_accuracy() step
    (profile_pol_high_accuracy.txt)."""
    for name, force in forces.items():
        steps = (N_DS_STEPS if force.config.recip_precision == "ds"
                 else N_LADDER_STEPS)
        ms, times, iters = time_runs(
            lambda k, force=force: [s[3] for s in pol_steps(force, w, k)[0]],
            steps)
        out[name].update(ms=ms, times=times)
        log(f"phase 4 [{card}]: 3m {name} MD step {ms:.3f} ms/step (median "
            f"of {N_REPEATS} x {steps}: {[round(t, 3) for t in times]}), "
            f"warm PCG iterations {sorted(set(iters))}")
    log_profile("pol_high_accuracy",
                lambda k: pol_steps(forces["high_accuracy"], w, k), 3)
    (OUT_DIR / "precision_pol.json").write_text(json.dumps(
        dict(out, card=card), indent=1, default=str))


# ---------------------------------------------------------------------------
# phase 3n: the precision modes on the 98k system
# ---------------------------------------------------------------------------

# rows run at 320^3 and 256^3, one energy+force step each, timed over
# N98_MODE_STEPS
LARGE_LADDER = ("spread-f64", "high_accuracy", "f64-all")
N98_MODE_STEPS = 1
# The DS engine's bytes at its peak, counted before its first run at 98k
# (ops/dsrecip.py), per mesh point of K1 K2 K3 and per atom. Per point: the
# k-space weights are its largest stage, on the K1 K2 (K3/2 + 1)
# half-spectrum, about half a point each: the three DS components of k
# (24 B), their squares (24 B) and the float32 temporaries of a DS product
# over them (~5 tensors of 3 components, 60 B) beside the DS spectrum (16
# B), ~130 B per half-spectrum point = 65 B per point; a butterfly level of
# the FFTs holds the DS mesh (8 B), the old and new halves (16 B), the
# twiddled products (4 B) and a product's temporaries (5 B), ~33 B: 80 B
# per point covers either. Per atom: the stencil stage, one DS product over
# 10 separable terms x 216 points with 7 float32 tensors live, 60,480 B. At
# 98,304 atoms on 512^3: 10.7 GB + 5.9 GB = 16.7 GB, the two stages' sum
# (they do not overlap: an upper bound). The run must fit the card's free
# bytes beside the rest of the step, and its peak must stay under the count.
DS_BYTES_PER_POINT, DS_BYTES_PER_ATOM = 80, 60480
DS_MAX_STEP_S = 60.0  # a slower step is a size limit too


def large_mode_force(w, spec, method, dtype, grid=None, kappa=None):
    """The 98k example's force (the 5-smooth grid, i-sorted pairs) under a
    ladder row; ``grid``/``kappa`` as given."""
    force = large_force(w, ladder_config(spec, method, fft_friendly_grid=True,
                                         pairs_i_sorted=True), dtype)
    if grid is not None:
        force.kappa = force.kappa if kappa is None else kappa
        force.K1, force.K2, force.K3 = grid
        force.refresh_calculators()
    return force


def large_oracle(w, grid, kappa):
    """The plain float64 step at ``grid``: (energy, forces, the largest of
    its real, reciprocal and self terms)."""
    oracle = large_mode_force(w, {}, "torch", torch.float64, grid, kappa)
    p0 = w["positions"]
    e, g = large_step(oracle, w, p0, torch.float64)
    with torch.no_grad():
        terms = oracle.get_metrics(*large_args(w, p0.double(), torch.float64))
    return e, g, max(abs(float(terms[t])) for t in ("e_real", "e_recip",
                                                    "e_self"))


def large_mode_check(w, name, spec, tol_f, oracle, grid=None):
    """One row's first 98k step on the kernels against the plain float64
    step ``oracle`` (forces relative RMSE, |dE| over the largest term) and
    against the same mode's plain f32 route, with its launches, peak bytes
    and wall seconds; the row's bounds as phase 3m's: max(the LADDER bound
    (TOL_E98 for the energy), 2 x the plain route's own error)."""
    e64, g64, scale = oracle
    kern = large_mode_force(w, spec, "auto", torch.float32, grid)
    grid = (kern.K1, kern.K2, kern.K3)
    reset_counts()
    t0 = time.perf_counter()
    (e_k, g_k), peak = peak_bytes(lambda: large_step(kern, w, w["positions"]))
    wall = time.perf_counter() - t0
    counts = read_counts()
    e_p, g_p = large_step(large_mode_force(w, spec, "torch", torch.float32,
                                           grid), w, w["positions"])
    de, de_p = (abs(float(e) - float(e64)) / scale for e in (e_k, e_p))
    df, df_p = rel_rmse(g_k, g64), rel_rmse(g_p, g64)
    de_kp, df_kp = abs(float(e_k) - float(e_p)) / scale, rel_rmse(g_k, g_p)
    bound_f, bound_e = max(tol_f or 0.0, 2 * df_p), max(TOL_E98, 2 * de_p)
    out = dict(grid=grid, force_rel_rmse=df, dE_over_term=de,
               plain32=dict(force_rel_rmse=df_p, dE_over_term=de_p),
               kernel_vs_plain32=dict(force_rel_rmse=df_kp,
                                      dE_over_term=de_kp),
               bound=dict(f=bound_f, e=bound_e), peak_bytes=peak,
               first_step_s=wall,
               launches=json_counts(counts, (
                   "pair_fwd_by_kind", "spread_by_shape",
                   "spread_tiled_by_shape", "gather_tiled_by_shape")))
    log(f"phase 3n {name} at {grid} ({w['positions'].shape[0]} atoms): "
        f"vs plain f64 force rel RMSE {df:.3e} (bound {bound_f:.3e}), |dE| "
        f"/ max|term| {de:.3e} (bound {bound_e:.3e}); plain f32 route "
        f"{df_p:.3e}, {de_p:.3e}; kernel vs plain f32 route {df_kp:.3e}, "
        f"{de_kp:.3e}; first step {wall:.2f} s, peak {peak / 2**30:.3f} GiB; "
        f"launches K1 {counts['pair_fwd_by_kind']}, K5 (6, 1) "
        f"{counts['spread_tiled_by_shape'][6, 1]}, K7 (6, 1) "
        f"{counts['gather_tiled_by_shape'][6, 1]}, K4 (6, 1) "
        f"{counts['spread_by_shape'][6, 1]}")
    require(bool(torch.isfinite(g_k).all()) and bool(torch.isfinite(e_k)),
            f"phase 3n {name} at {grid}: non-finite energy or forces")
    require(df < bound_f, f"phase 3n {name} at {grid}: forces vs f64 {df}")
    require(de < bound_e, f"phase 3n {name} at {grid}: energy vs f64 {de}")
    require(df_kp < TOL_STEP_F98 and de_kp < TOL_E98,
            f"phase 3n {name} at {grid}: kernel vs plain f32 {df_kp}, "
            f"{de_kp}")
    cfg = kern.config
    # K1/K2 'perm' REAL_PASSES times per step; K5/K7 on an f32 mesh
    # (beyond the L2 at both grids)
    want = REAL_PASSES.get(cfg.realspace_precision, 1)
    tiled = int(cfg.recip_precision is None)
    require(counts["pair_fwd_by_kind"]["perm"] == want
            and counts["pair_bwd_by_kind"]["perm"] == want
            and counts["spread_tiled_by_shape"][6, 1] == tiled
            and counts["gather_tiled_by_shape"][6, 1] == tiled
            and counts["spread_by_shape"][6, 1] == 0,
            f"phase 3n {name} at {grid}: launches {counts}, want K1/K2 "
            f"{want}, K5/K7 {tiled}")
    return kern, out


def ds_predicted_bytes(n_atoms, grid):
    return DS_BYTES_PER_POINT * math.prod(grid) + DS_BYTES_PER_ATOM * n_atoms


def large_ds_path(w98, rest_bytes, card):
    """ds_accuracy() on the 98k system at the grid its constructor picks,
    held as a 3n row: first its predicted bytes (ds_predicted_bytes +
    ``rest_bytes``, the rest of the step: the high_accuracy() step's peak)
    must fit the card's free memory, then its peak must stay under the
    prediction and its first step within DS_MAX_STEP_S."""
    kern = large_mode_force(w98, "ds_accuracy", "auto", torch.float32)
    grid, kappa = (kern.K1, kern.K2, kern.K3), kern.kappa
    del kern
    n = w98["positions"].shape[0]
    pred = ds_predicted_bytes(n, grid) + rest_bytes
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    log(f"phase 3n ds_accuracy at {n} atoms, {grid}: predicted "
        f"{pred / 2**30:.3f} GiB, the card's free {free / 2**30:.2f} GiB")
    require(pred <= free, f"phase 3n ds_accuracy at {n} atoms, {grid}: "
            f"predicted {pred} B > free {free} B: a size limit")
    oracle = large_oracle(w98, grid, kappa)
    kern, out = large_mode_check(w98, "ds_accuracy", "ds_accuracy", 2e-6,
                                 oracle)
    require(out["grid"] == grid, f"the DS grid {out['grid']} != {grid}")
    out.update(atoms=n, predicted_bytes=pred, free_bytes=free)
    log(f"phase 3n [{card}] ds_accuracy at {n} atoms, {grid}: peak "
        f"{out['peak_bytes'] / 2**30:.3f} GiB against the predicted "
        f"{pred / 2**30:.3f} GiB (ratio {out['peak_bytes'] / pred:.3f}),"
        f" first step {out['first_step_s']:.2f} s")
    require(out["peak_bytes"] <= pred,
            f"phase 3n ds_accuracy: peak {out['peak_bytes']} B above the "
            f"predicted {pred} B")
    require(out["first_step_s"] <= DS_MAX_STEP_S,
            f"phase 3n ds_accuracy at {n} atoms: a step of "
            f"{out['first_step_s']:.1f} s > {DS_MAX_STEP_S} s: a size limit")
    return kern, out


def large_ladder_path(w98, card):
    """Phase 3n: LARGE_LADDER at 320^3 and 256^3 and ds_accuracy() at its
    grid (large_ds_path), each against the plain float64 step and its own
    plain f32 route, with peak bytes and ms/step (a profiler window of the
    high_accuracy() step at 320^3); K5/K7 on the f64-weight stencils
    against their plain versions. Returns the results."""
    lad = {row[0]: row[1:] for row in LADDER}
    rng = np.random.default_rng(11)
    results = {}
    for k in (K98, K98_ALT):
        grid = (k,) * 3
        m_u0, q = large_stencil(w98, grid, precision="f64")
        check_tiled(grid, 6, m_u0, q, rng, " on float64 weights")
        oracle = large_oracle(w98, grid, make_large_force(
            w98, torch.float32, "auto", "auto", k).kappa)
        for name in LARGE_LADDER:
            spec, tol_f, _ = lad[name]
            kern, out = large_mode_check(w98, name, spec, tol_f, oracle, grid)
            if k == K98:
                out["ms"], out["times"], _ = time_runs(
                    lambda n, f=kern: run_large(f, w98, n), N98_MODE_STEPS)
                log(f"phase 3n [{card}] {name} at {grid}: "
                    f"{out['ms']:.3f} ms/step ({[round(t, 3) for t in out['times']]})")
                if name == "high_accuracy":
                    log_profile("large_high_accuracy",
                                lambda n, f=kern: run_large(f, w98, n))
            results[f"{name}@{k}"] = out
            del kern
        del oracle
    rest = results[f"high_accuracy@{K98}"]["peak_bytes"]
    kern, out = large_ds_path(w98, rest, card)
    out["ms"], out["times"], _ = time_runs(
        lambda n: run_large(kern, w98, n), N98_MODE_STEPS)
    log(f"phase 3n [{card}] ds_accuracy at {out['grid']} "
        f"({out['atoms']} atoms): {out['ms']:.3f} ms/step "
        f"({[round(t, 3) for t in out['times']]})")
    results["ds_accuracy"] = out
    (OUT_DIR / "precision_98k.json").write_text(json.dumps(
        dict(results, card=card), indent=1, default=str))
    return results


# ---------------------------------------------------------------------------
# phases 3j, 3k: the sharded layer (admp_tpu_torch/parallel) on the card
# ---------------------------------------------------------------------------

# 3k: P gloo ranks share the one card (NCCL refuses two ranks on one GPU);
# their times are the overhead of P ranks on one card, not scaling
SHARD_PS = (2, 4)
N_SHARD_STEPS = 2
SHARD_DATA_MODEL = (2, 2)  # the batch energy's data x model split at P = 4


def pad_pairs(pairs, n, multiple):
    """pairs padded with (n, n) rows to a multiple of ``multiple``."""
    extra = -pairs.shape[0] % multiple
    pad = torch.full((extra, 2), n, device=pairs.device, dtype=pairs.dtype)
    return torch.cat([pairs, pad])


def slab_stencil(m_u0, q, grid, n_dev, slab, order=6):
    """The halo slab spread's K4 inputs for slab ``slab`` of ``n_dev``: the
    atoms whose base x-row it owns, at the synthetic m_u0' = base - slab x
    width + order/2 on the (K1/P + order - 1, K2, K3) slab grid (the same
    inputs parallel/spread._local_slab_spread gives K4), and that grid."""
    half = order // 2
    k = torch.tensor(grid, device=m_u0.device)
    base = torch.remainder(m_u0.long() - half, k)
    width = grid[0] // n_dev
    keep = torch.div(base[:, 0], width, rounding_mode="floor") == slab
    m_slab = base[keep] + half
    m_slab[:, 0] -= slab * width
    slab_grid = (width + order - 1, grid[1], grid[2])
    return m_slab.to(torch.int32).contiguous(), q[keep].contiguous(), slab_grid


def check_slab_kernels(m_u0, q, grid, n_dev, label, card=None):
    """K4 and K6 on halo slab 0 of n_dev against spread_torch /
    gather_torch: the spread within TOL_SPREAD of max|mesh|, the gather bit
    for bit; with ``card``, also each kernel's time beside its plain
    version, its one PyTorch call and its bound (spread_calls), logged."""
    from admp_tpu_torch.ops.cuda import spread as S

    m_s, q_s, sgrid = slab_stencil(m_u0, q, grid, n_dev, 0)
    mesh_k = S.launch_spread(m_s, q_s, sgrid, 6)
    mesh_p = S.spread_torch(m_s, q_s, sgrid, 6)
    g = torch.randn((1, *sgrid), device=q.device,
                    generator=torch.Generator(q.device).manual_seed(5))
    out_k = S.launch_gather(m_s, g, sgrid, 6)
    out_p = S.gather_torch(m_s, g, sgrid, 6)
    torch.cuda.synchronize()
    err = float((mesh_k - mesh_p).abs().max())
    scale = float(mesh_p.abs().max())
    log(f"K4/K6 on the {label} halo slab {sgrid} ({m_s.shape[0]} atoms): "
        f"spread max abs err {err / scale:.3e} x max|mesh|, gather equal "
        f"{bool(torch.equal(out_k, out_p))}")
    require(err <= TOL_SPREAD * scale, f"K4 on the {label} slab {err / scale}")
    require(torch.equal(out_k, out_p), f"K6 on the {label} slab")
    if card is None:
        return
    for name, (kernel, plain, library, (b_s, b_by)) in spread_calls(
            m_s, q_s, g, 6).items():
        (ms, dev_ms), (p_ms, p_dev), (l_ms, l_dev) = (
            cuda_time_ms(fn) for fn in (kernel, plain, library))
        log(f"phase 4 [{card}]: {label} halo slab {sgrid} {name} (K4/K6 at "
            f"(6, 1)): kernel {ms:.4f} ms/call ({dev_ms:.4f} ms device), "
            f"plain {p_ms:.4f} ({p_dev:.4f}), one PyTorch call {l_ms:.4f} "
            f"({l_dev:.4f}), bound {b_s * 1e3:.4f} ms ({b_by})")


def sharded_inputs(w, n_dev):
    """The 3000-atom box's sharded calls: the MD box's polarizable model
    (grid (96, 96, 128), exact adjoint) and the full force field's (128^3,
    kappa pinned, order-4 dispersion), pairs padded to a multiple of
    n_dev, the halo bins sized for the lattice atom order
    (halo_cap_factor = n_dev)."""
    from admp_tpu_torch.ops.ewald import setup_ewald_parameters

    s = w["sys"]
    n = w["positions"].shape[0]
    kappa = setup_ewald_parameters(RC, ETHRESH, s["box"])[0]
    topo = dict(axis_types=s["axis_types"], axis_indices=s["axis_indices"],
                covalent_map=s["covalent_map"], device=w["positions"].device)
    return dict(kappa=kappa, topo=topo,
                pairs=pad_pairs(w["pairs"], n, n_dev),
                ff_pairs=pad_pairs(w["ff_pairs"], n, n_dev))


def sharded_fns(w, n_dev, group=None, **keywords):
    """(pol energy_and_aux, full force field) of the 3000-atom box on
    ``group``, under the EngineConfig ``keywords``."""
    from admp_tpu_torch import EngineConfig, SCFConfig
    from admp_tpu_torch.parallel import (
        make_sharded_ff_energy,
        make_sharded_pol_energy,
    )

    si = sharded_inputs(w, n_dev)
    cfg = EngineConfig(halo_cap_factor=float(n_dev), **keywords)
    pol = make_sharded_pol_energy(group, grid_shape=w["grid"],
                                  kappa=si["kappa"], lmax=LMAX,
                                  scf_config=SCFConfig(), config=cfg,
                                  **si["topo"])
    ff = make_sharded_ff_energy(group, grid_shape=(K_FF,) * 3,
                                kappa=KAPPA_FF, lmax=LMAX,
                                disp_grid_shape=(K_FF,) * 3,
                                disp_kappa=KAPPA_FF, pmax=PMAX,
                                disp_spread_order=DISP_ORDER, config=cfg,
                                **si["topo"])
    return pol, ff, si


def sharded_pol_step(pol, w, si, positions, u_init):
    """(energy, forces, u*, converged, n_iter) of one sharded polarizable
    energy+force (exact adjoint)."""
    pos = positions.detach().requires_grad_(True)
    e, (u, conv, n_iter) = pol(pos, w["box"], si["pairs"], w["q_local"],
                               w["pol"], w["tholes"], w["scales"],
                               w["scales"], u_init)
    (g,) = torch.autograd.grad(e, pos)
    return e.detach(), g, u, conv, n_iter


def sharded_ff_step(ff, w, si, positions):
    s = w["sys"]
    c = lambda x: torch.as_tensor(x, device=positions.device,  # noqa: E731
                                  dtype=torch.float32)
    pos = positions.detach().requires_grad_(True)
    e = ff(pos, w["box"], si["ff_pairs"], w["q_local"], w["scales"],
           w["c_list"], c(s["tt_a"]), c(s["tt_b"]), c(s["tt_q"]))
    (g,) = torch.autograd.grad(e, pos)
    return e.detach(), g


def sharded_box_runs(w, n_dev, group=None, **keywords):
    """Phase 3j (n_dev = 1, NCCL) and each rank of 3k: the sharded
    polarizable step and full force field on the 3000-atom box under the
    EngineConfig ``keywords``, the first step's results with its launch
    counts, comm tally and peak bytes, one warm step's tally, and ms/step
    over drift steps (forces consumed, warm-started dipoles). Returns numpy
    results."""
    from admp_tpu_torch.utils.comm import CommTally

    pol, ff, si = sharded_fns(w, n_dev, group, **keywords)
    out = {}
    u0 = torch.zeros_like(w["positions"])
    reset_counts()
    with CommTally().recording() as tally:
        (e, g, u, conv, n_iter), peak = peak_bytes(
            lambda: sharded_pol_step(pol, w, si, w["positions"], u0))
    out["pol"] = dict(energy=float(e), forces=g.cpu().numpy(),
                      u=u.cpu().numpy(), converged=bool(conv),
                      n_iter=int(n_iter), launches=read_counts(),
                      tally=tally.report(), peak_bytes=peak)
    reset_counts()
    with CommTally().recording() as tally:
        (e_ff, g_ff), peak = peak_bytes(
            lambda: sharded_ff_step(ff, w, si, w["positions"]))
    out["ff"] = dict(energy=float(e_ff), forces=g_ff.cpu().numpy(),
                     launches=read_counts(), tally=tally.report(),
                     peak_bytes=peak)

    state = {"u": u}

    def run_pol(n):
        p, iters = w["positions"], []
        for _ in range(n):
            _, gp, state["u"], _, it = sharded_pol_step(pol, w, si, p,
                                                        state["u"])
            p = p + w["drift"] + 0.0 * gp
            iters.append(it)
        return iters

    def run_ff(n):
        p = w["positions"]
        for _ in range(n):
            _, gf = sharded_ff_step(ff, w, si, p)
            p = p + w["drift"] + 0.0 * gf
        return [0]

    with CommTally().recording() as tally:
        run_pol(1)
    out["pol"]["tally_warm"] = tally.report()
    for name, run in (("pol", run_pol), ("ff", run_ff)):
        ms, times, iters = time_runs(run, N_SHARD_STEPS)
        out[name].update(ms=ms, times=times, warm_iters=sorted(set(iters)))
    return out, (run_pol, run_ff)


def sharded_batch(w, data_group, model_group, n_dev):
    """make_sharded_batch_energy on the 3000-atom box: two configurations
    (the start and one drift step), fixed multipoles at the MD grid; the
    (2,) energies and dE/dQ_local, numpy."""
    from admp_tpu_torch import EngineConfig
    from admp_tpu_torch.parallel import make_sharded_batch_energy

    si = sharded_inputs(w, n_dev)
    energy_b = make_sharded_batch_energy(
        data_group, model_group, grid_shape=w["grid"], kappa=si["kappa"],
        lmax=LMAX, config=EngineConfig(halo_cap_factor=float(n_dev)),
        **si["topo"])
    batch = torch.stack([w["positions"], w["positions"] + w["drift"]])
    pairs_b = si["pairs"].expand(2, *si["pairs"].shape)
    q = w["q_local"].clone().requires_grad_(True)
    e = energy_b(batch, w["box"], pairs_b, q, w["scales"])
    (g,) = torch.autograd.grad(e.sum(), q)
    return e.detach().cpu().numpy(), g.cpu().numpy()


# the precision keywords of the sharded factories away from their defaults
# (compensated sums are on by default), on the 3000-atom box at P = 1 over
# NCCL and P = 2 over gloo, against the single-device kernels under the
# same keyword
SHARD_KEYWORDS = {"spread_f64": dict(spread_precision="f64"),
                  "uncompensated": dict(compensated_sums=False)}


def sharded_keyword_runs(w, n_dev, group=None):
    """sharded_box_runs under each of SHARD_KEYWORDS on ``group``."""
    return {name: sharded_box_runs(w, n_dev, group, **kw)[0]
            for name, kw in SHARD_KEYWORDS.items()}


def sharded_keywords(w, f64, p1, ranks2, card):
    """The precision keywords of 3j: sharded_keyword_runs at P = 1 over NCCL
    (its own world-size-1 group) and at P = 2 over gloo (``ranks2``, ranks
    0 and 1 of 3k), each rank against the single-device kernels under the
    same keyword (energy TOL_STEP_E, forces TOL_STEP_F) and plain f64
    (forces TOL_F64), every kernel launched (K3 in the exact adjoint), the
    same PCG iterations on every rank; compensated_sums=False also against
    the default calls of 3j at P = 1, ``p1`` (forces and dipoles within
    TOL_STEP_F: the sums move only the energy); each energy's distance
    from plain f64 logged; ms/step and peak bytes; K4/K6 on the 3000-atom
    halo slabs of P = 1 and 2 on stencils of float64 weights against their
    plain versions."""
    import torch.distributed as dist

    from admp_tpu_torch.ops.reciprocal import (
        atom_spread_alpha,
        spread_points_separable,
    )

    dev = w["positions"].device
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        p1_kw = sharded_keyword_runs(w, 1)
    finally:
        dist.destroy_process_group()
    for name, kw in SHARD_KEYWORDS.items():
        ref = single_device_refs(w, "auto", torch.float32, **kw)
        for kind, hvp in (("pol", True), ("ff", False)):
            runs = [("P=1 (NCCL)", p1_kw[name][kind])] + [
                (f"P=2 rank {i}", r[name][kind]) for i, r in enumerate(ranks2)]
            # the total is a residue of ~1e6 kJ/mol terms: plain f32 sums in
            # two orders (P = 2 against one device) differ by an f32 unit
            # of the largest term, so without compensated sums the energy
            # is held over that term (TOL_E98), as 3m's
            tol_e = (TOL_E98 * f64[kind]["scale"] / abs(ref[kind]["e"])
                     if name == "uncompensated" else TOL_STEP_E)
            for label, got in runs:
                msg = f"phase 3j {kind} {name} {label}"
                if kind == "pol":
                    msg += (f" ({got['n_iter']} PCG iterations, single device"
                            f" {ref['pol']['n']})")
                    require(got["converged"], f"{msg}: SCF did not converge")
                check_against(msg + ", vs single-device kernels under the "
                              "same keyword", got, ref[kind], TOL_STEP_F,
                              f64[kind], tol_e)
                require_launched(msg, got["launches"], hvp=hvp)
            if kind == "pol":
                iters = {got["n_iter"] for _, got in runs}
                require(len(iters) == 1,
                        f"phase 3j pol {name}: iterations {iters}")
            got, base = p1_kw[name][kind], p1[kind]
            log(f"phase 3j {kind} {name} P=1: |E - E_f64| "
                f"{abs(got['energy'] - f64[kind]['e']):.4e} kJ/mol, the "
                f"default call's {abs(base['energy'] - f64[kind]['e']):.4e}")
            if name == "uncompensated":
                keys = ("forces", "u") if kind == "pol" else ("forces",)
                for k in keys:
                    d = rel_rmse(torch.as_tensor(got[k]),
                                 torch.as_tensor(base[k]))
                    log(f"phase 3j {kind} {name} P=1 vs the default call: "
                        f"{k} rel RMSE {d:.3e}")
                    require(d < TOL_STEP_F, f"phase 3j {kind} {name}: {k} "
                            f"vs the default call {d}")
            log(f"phase 3j [{card}] {kind} {name}: ms/step "
                + ", ".join(f"{label} {got['ms']:.3f}" for label, got in runs)
                + "; peak MiB " + ", ".join(
                    f"{label} {got['peak_bytes'] / 2**20:.1f}"
                    for label, got in runs))
    n = w["positions"].shape[0]
    m_u0, u0, alpha = atom_spread_alpha(w["positions"], w["box"],
                                        w["q_local"], w["grid"], LMAX, 6,
                                        "f64")
    q = spread_points_separable(u0, alpha, LMAX).float().reshape(n, 1, 216)
    for n_dev in (1, 2):
        check_slab_kernels(m_u0, q, w["grid"], n_dev,
                           f"3000-atom P={n_dev} (float64 weights)")
    keep = ("energy", "converged", "n_iter", "ms", "times", "peak_bytes")
    (OUT_DIR / "sharded_keywords.json").write_text(json.dumps(dict(
        card=card, p1={name: {kind: {k: v for k, v in r.items() if k in keep}
                              for kind, r in runs.items()}
                       for name, runs in p1_kw.items()}), indent=1))


def sharded_rank(rank, world_size):
    """The gloo ranks of phase 3k on the card they share: P = 2 on ranks 0
    and 1 (the others wait), then P = 4 with the 2 x 2 batch energy and
    the dry run. One start-up serves both."""
    import torch.distributed as dist

    from admp_tpu_torch.entry import dryrun_multichip
    from admp_tpu_torch.parallel.launch import mesh_groups

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    w = build_workload(dev)
    out = {}
    pair = dist.new_group([0, 1])
    if rank < 2:
        out[2], _ = sharded_box_runs(w, 2, pair)
        out["keywords"] = sharded_keyword_runs(w, 2, pair)
    dist.barrier()
    out[world_size], _ = sharded_box_runs(w, world_size)
    out["batch"] = sharded_batch(w, *mesh_groups(*SHARD_DATA_MODEL),
                                 world_size)
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(world_size, device="cuda")
    out["dryrun"]["s"] = time.perf_counter() - t0
    return out


def sharded_large(w98, card):
    """Phase 3j (a): examples/fluctuating_multipoles.py --n-side 32 --sharded
    at world size 1: the example's grid (setup_ewald_parameters(4.0, 1e-4),
    K1 and K2 rounded up to P), cell-list pairs padded to P, sparse
    exclusions, multipoles that follow the O-H stretches; energy+force
    through make_sharded_pme_energy against the single-device force on the
    kernels ('auto') and on plain f32 and f64 at the same grid."""
    from admp_tpu_torch.examples.fluctuating_multipoles import (
        fluctuating_q_local,
    )
    from admp_tpu_torch.ops.ewald import setup_ewald_parameters
    from admp_tpu_torch.ops.reciprocal import (
        atom_spread_alpha,
        spread_points_separable,
    )
    from admp_tpu_torch.parallel import make_sharded_pme_energy
    from admp_tpu_torch.utils.comm import CommTally

    s = w98["sys"]
    n = w98["positions"].shape[0]
    n_dev = 1
    kappa, k1, k2, k3 = setup_ewald_parameters(RC, ETHRESH, s["box"])
    k1, k2 = -(-k1 // n_dev) * n_dev, -(-k2 // n_dev) * n_dev
    grid = (k1, k2, k3)
    pairs = pad_pairs(w98["pairs"], n, n_dev)
    sharded = make_sharded_pme_energy(
        None, grid_shape=grid, kappa=kappa, lmax=LMAX,
        axis_types=s["axis_types"], axis_indices=s["axis_indices"],
        covalent_map=w98["sparse"], device=w98["positions"].device)

    def sharded_step(positions):
        pos = positions.detach().requires_grad_(True)
        e = sharded(pos, w98["box"], pairs,
                    fluctuating_q_local(pos, w98["q_cart"]), w98["scales"])
        (g,) = torch.autograd.grad(e, pos)
        return e.detach(), g

    forces = {}
    for name, pk, sm, dtype in (("kernel", "auto", "auto", torch.float32),
                                ("plain32", "torch", "torch", torch.float32),
                                ("plain64", "torch", "torch", torch.float64)):
        f = make_large_force(w98, dtype, pk, sm)
        f.kappa, (f.K1, f.K2, f.K3) = kappa, grid
        f.refresh_calculators()
        forces[name] = f
    p0 = w98["positions"]
    reset_counts()
    with CommTally().recording() as tally:
        e_s, g_s = sharded_step(p0)
    counts = read_counts()
    report = tally.report()
    e_k, g_k = large_step(forces["kernel"], w98, p0)
    e_p, g_p = large_step(forces["plain32"], w98, p0)
    e_64, g_64 = large_step(forces["plain64"], w98, p0, torch.float64)
    with torch.no_grad():
        terms = forces["plain64"].get_metrics(*large_args(w98, p0.double(),
                                                          torch.float64))
    scale = max(abs(float(terms[t])) for t in ("e_real", "e_recip",
                                               "e_self"))
    de_k, de_64, de_p64 = (abs(float(a) - float(b)) / scale for a, b in (
        (e_s, e_k), (e_s, e_64), (e_p, e_64)))
    df_k, df_64 = rel_rmse(g_s, g_k), rel_rmse(g_s, g_64)
    df_p, df_kp = rel_rmse(g_s, g_p), rel_rmse(g_k, g_p)
    log(f"phase 3j 98k sharded (world size 1, NCCL): grid {grid}, kappa "
        f"{kappa:.6f}, {pairs.shape[0]} pair slots; launches {counts}; "
        f"E {float(e_s):.4f} (sharded kernels), {float(e_k):.4f} (single "
        f"device, kernels), {float(e_64):.4f} (plain f64) kJ/mol; |dE| / "
        f"max|term| vs single-device kernels {de_k:.3e}, vs plain f64 "
        f"{de_64:.3e} (plain f32 vs f64 {de_p64:.3e}); force rel RMSE vs "
        f"single-device kernels {df_k:.3e}, vs plain f64 {df_64:.3e} "
        f"(single-device kernels vs f64 {rel_rmse(g_k, g_64):.3e}); vs plain "
        f"f32 {df_p:.3e} (single-device kernels vs plain f32 {df_kp:.3e})")
    log(format_tally("phase 3j 98k sharded energy+force", report))
    require(all(counts[k] == 1 for k in ("pair_fwd", "pair_bwd", "spread",
                                          "gather")),
            f"98k sharded: K1/K2/K4/K6 did not launch once: {counts}")
    require(bool(torch.isfinite(g_s).all())
            and tuple(g_s.shape) == tuple(p0.shape),
            "98k sharded: forces not finite or of the wrong shape")
    require(de_k < TOL_E98, f"98k sharded vs single-device energy {de_k}")
    require(de_64 < max(TOL_E98, 2 * de_p64),
            f"98k sharded vs f64 energy {de_64} (plain f32 {de_p64})")
    # two f32 summation orders differ by ~1.1e-4 at this size (TOL_STEP_F98)
    require(df_k < TOL_STEP_F98,
            f"98k sharded vs single-device forces {df_k}")
    require(df_64 < TOL_F64, f"98k sharded vs f64 forces {df_64}")
    q_local = fluctuating_q_local(p0, w98["q_cart"])
    m_u0, u0, alpha = atom_spread_alpha(p0, w98["box"], q_local, grid, LMAX)
    q_pts = spread_points_separable(u0, alpha, LMAX).reshape(n, 1, 216)
    check_slab_kernels(m_u0, q_pts, grid, 1, "98k P=1", card)
    check_slab_kernels(m_u0, q_pts, grid, 4, "98k P=4")
    del forces["plain64"], forces["plain32"]

    def run_sharded(n_steps):
        p = p0
        for _ in range(n_steps):
            _, g = sharded_step(p)
            p = p + w98["drift"] + 0.0 * g
        return [0]

    return dict(launches=counts, tally=report, run=run_sharded,
                single=forces["kernel"])


def format_tally(title, report):
    from admp_tpu_torch.utils.comm import format_report

    return format_report(title, report,
                         f"{report['while_iters']} solver iterations")


def single_pol_force(w, dtype, method, **keywords):
    """The single-device counterpart of the sharded polarizable call: the
    MD box's model with SCFConfig(), no cached influence, its grid (K3 =
    128), and the EngineConfig ``keywords``."""
    from admp_tpu_torch import ADMPPmeForce, EngineConfig, SCFConfig

    s = w["sys"]
    force = ADMPPmeForce(
        s["box"], s["axis_types"], s["axis_indices"], s["covalent_map"], RC,
        ETHRESH, lmax=LMAX, lpol=True,
        config=EngineConfig(scf=SCFConfig(), pair_kernel=method,
                            spread_method=method, **keywords),
        device=w["positions"].device, dtype=dtype)
    force.K1, force.K2, force.K3 = w["grid"]
    force.refresh_calculators()
    return force


def single_device_refs(w, method, dtype, **keywords):
    """The single-device counterparts of 3j's two 3000-atom calls under the
    EngineConfig ``keywords``: the polarizable step (energy, forces,
    dipoles, iterations) and the full force field in the sharded factory's
    sign, with the forces and the full force field's total for timing."""
    force = single_pol_force(w, dtype, method, **keywords)
    e, g = force.get_forces(*pol_args(w, w["positions"], dtype))
    ff_total, disp = make_ff(w, w["positions"].device, dtype, method,
                             **keywords)
    box, sc = w["box"].to(dtype), w["scales"].to(dtype)

    def ff_signed(positions, c_list):
        # the sharded factory's sign (the front end's e_sr - e_lr): PME +
        # TT - dispersion PME, where make_ff adds the dispersion
        return ff_total(positions, c_list) - 2.0 * disp.get_energy(
            positions, box, w["ff_pairs"], c_list, sc)

    e_ff, g_ff = ff_step(ff_signed, w["positions"].to(dtype),
                         w["c_list"].to(dtype))
    # the largest of each call's PME real, reciprocal and self energies
    with torch.no_grad():
        scales = [max(abs(float(terms[t])) for t in ("e_real", "e_recip",
                                                      "e_self"))
                  for terms in (force.get_metrics(*pol_args(
                      w, w["positions"], dtype)), ff_total.pme_terms(
                          w["positions"].to(dtype)))]
    return dict(pol=dict(e=float(e), g=g, u=force.U_ind, n=force.n_cycle,
                         scale=scales[0]),
                ff=dict(e=float(e_ff), g=g_ff, scale=scales[1]), force=force,
                total=ff_total)


def log_profile(name, run, n_steps=1):
    """One profiler window of n_steps warm steps (a window of the sharded
    polarizable step holds ~30k device kernels per step, and the profiler
    takes tens of seconds per step to sort them)."""
    wall, device_ms, n_kernels, top = profile_steps(run, name, n_steps)
    log(f"profile {name} ({n_steps} warm step(s), profiler on): "
        f"{wall:.3f} ms/step wall, {device_ms:.3f} ms/step device busy "
        f"({100 * device_ms / wall:.1f}%), {n_kernels:.0f} device "
        "kernels/step; top by device time:")
    for key, ms_k, count in top:
        log(f"  {ms_k:8.4f} ms/step  x{count:<4d} {key}")


def check_against(label, got, ref, tol_f, f64=None, tol_e=TOL_STEP_E):
    """Log and gate a sharded result against a reference (energy within
    tol_e relative, forces within tol_f relative RMSE) and, with ``f64``,
    its forces against plain f64 within TOL_F64."""
    dev = ref["g"].device
    de = abs(got["energy"] - ref["e"]) / abs(ref["e"])
    df = rel_rmse(torch.as_tensor(got["forces"], device=dev), ref["g"])
    msg = (f"{label}: E {got['energy']:.6f} vs {ref['e']:.6f}, energy rel "
           f"{de:.3e}, force rel RMSE {df:.3e}")
    if f64 is not None:
        df64 = rel_rmse(torch.as_tensor(got["forces"], device=dev), f64["g"])
        msg += f"; vs plain f64 ({f64['e']:.6f}) force rel RMSE {df64:.3e}"
    log(msg)
    require(bool(np.isfinite(got["forces"]).all()),
            f"{label}: forces not finite")
    require(de < tol_e, f"{label}: energy {de} >= {tol_e}")
    require(df < tol_f, f"{label}: forces {df}")
    if f64 is not None:
        require(df64 < TOL_F64, f"{label}: forces vs f64 {df64}")


def require_launched(label, launches, hvp=False):
    names = ("pair_fwd", "pair_bwd", "spread", "gather")
    ok = all(launches[k] > 0 for k in names)
    if hvp:
        kinds = launches["pair_hvp_by_kind"]
        ok = ok and kinds["pol"] > 0 and kinds["uu"] > 0
    require(ok, f"{label}: a kernel never launched: {launches}")


def sharded_path(w, w98, record, card):
    """Phases 3j and 3k, with their times and profiles, and 3j's precision
    keywords (sharded_keywords; each NCCL group lives only in its
    function)."""
    import torch.distributed as dist

    from admp_tpu_torch.parallel.launch import launch, mesh_groups

    dev = w["positions"].device
    t0 = time.perf_counter()
    # the single-device paths on the same inputs: kernels and plain f64
    single = {name: single_device_refs(w, method, dtype)
              for name, method, dtype in (("kernel", "auto", torch.float32),
                                          ("plain64", "torch",
                                           torch.float64))}
    k, f64 = single["kernel"], single["plain64"]

    log(f"phase 3j: single-device references, {time.perf_counter() - t0:.1f}"
        " s")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        t0 = time.perf_counter()
        large = sharded_large(w98, card)
        log(f"phase 3j: 98k, {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        p1, (run_pol_s, run_ff_s) = sharded_box_runs(w, 1)
        batch1 = sharded_batch(w, *mesh_groups(1, 1), 1)
        pol1, ff1 = p1["pol"], p1["ff"]
        log(f"phase 3j polarizable (SCFConfig(), grid {w['grid']}): launches "
            f"{pol1['launches']}; iterations {pol1['n_iter']} vs "
            f"{k['pol']['n']} single-device; U_ind rel RMSE "
            f"{rel_rmse(torch.as_tensor(pol1['u'], device=dev), k['pol']['u']):.3e}")
        check_against("phase 3j polarizable, sharded vs single-device "
                      "kernels", pol1, k["pol"], TOL_ADJ_F, f64["pol"])
        require_launched("phase 3j polarizable", pol1["launches"], hvp=True)
        require(pol1["converged"], "phase 3j: SCF did not converge")
        log(format_tally("phase 3j polarizable, cold step", pol1["tally"]))
        log(format_tally("phase 3j polarizable, warm step",
                         pol1["tally_warm"]))
        log(f"phase 3j full force field (128^3): launches "
            f"{ff1['launches']}")
        check_against("phase 3j full force field, sharded vs single-device "
                      "kernels", ff1, k["ff"], TOL_STEP_F, f64["ff"])
        require_launched("phase 3j full force field", ff1["launches"])
        log(format_tally("phase 3j full force field", ff1["tally"]))
        log("phase 3j: sharded layer at world size 1 (NCCL) ok, "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

        # times: the sharded calls at world size 1 beside the single-device
        # kernel path, forces consumed, positions drifting
        ms98, t98, _ = time_runs(large["run"], N_SHARD_STEPS)
        ms98_1, t98_1, _ = time_runs(
            lambda n: run_large(large["single"], w98, n), N_SHARD_STEPS)
        ms_pol1, t_pol1, _ = time_runs(lambda n: [s[1] for s in run_steps(
            k["force"], w, w["positions"], n)[1]], N_SHARD_STEPS)
        ms_ff1, t_ff1, _ = time_runs(lambda n: run_ff(k["total"], w, n),
                                     N_SHARD_STEPS)
        for label, (ms, t), (ms_s, t_s) in (
                ("98k", (ms98, t98), (ms98_1, t98_1)),
                ("polarizable", (pol1["ms"], pol1["times"]), (ms_pol1, t_pol1)),
                ("full force field", (ff1["ms"], ff1["times"]),
                 (ms_ff1, t_ff1))):
            log(f"phase 3j [{card}]: {label} step, sharded at world size 1 "
                f"(NCCL) {ms:.3f} ms/step ({[round(x, 3) for x in t]}), "
                f"single device {ms_s:.3f} ms/step "
                f"({[round(x, 3) for x in t_s]}); kernels both")
        log_profile("sharded_98k", large["run"])
        log_profile("sharded_pol", run_pol_s)
        log_profile("sharded_ff", run_ff_s)
        log(f"phase 3j: times and profiles, {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    ranks = launch(sharded_rank, max(SHARD_PS), backend="gloo")
    log(f"phase 3k: {max(SHARD_PS)} gloo ranks sharing the card, "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    by_p = {n: [r[n] for r in ranks[:n]] for n in SHARD_PS}
    for n_dev in SHARD_PS:
        ranks_p = by_p[n_dev]
        as_ref = lambda r: dict(e=r["energy"],  # noqa: E731
                                g=torch.as_tensor(r["forces"], device=dev))
        for name, tol in (("pol", TOL_ADJ_F), ("ff", TOL_STEP_F)):
            r0 = ranks_p[0][name]
            log(f"phase 3k P={n_dev} {name}: launches on rank 0 "
                f"{r0['launches']}; ranks' energies "
                f"{[r[name]['energy'] for r in ranks_p]}")
            for rank, r in enumerate(ranks_p):
                check_against(f"phase 3k P={n_dev} {name} rank {rank} vs P=1",
                              r[name], as_ref(p1[name]), tol)
                require_launched(f"phase 3k P={n_dev} {name} rank {rank}",
                                 r[name]["launches"], hvp=name == "pol")
            if name == "pol":
                iters = [r[name]["n_iter"] for r in ranks_p]
                du = rel_rmse(torch.as_tensor(r0["u"], device=dev),
                              torch.as_tensor(pol1["u"], device=dev))
                log(f"phase 3k P={n_dev} pol: iterations per rank {iters} "
                    f"(P=1: {pol1['n_iter']}), U_ind rel RMSE vs P=1 "
                    f"{du:.3e}")
                require(len(set(iters)) == 1, f"ranks' iterations {iters}")
                require(all(r[name]["converged"] for r in ranks_p),
                        f"P={n_dev}: SCF did not converge")
            log(format_tally(f"phase 3k P={n_dev} {name}, rank 0, first step",
                             r0["tally"]))
            log(f"phase 3k [{card}] P={n_dev} {name}: ms/step per rank "
                f"{[round(r[name]['ms'], 3) for r in ranks_p]} (the overhead "
                f"of {n_dev} ranks sharing one card over gloo, not scaling;"
                f" P=1 NCCL {p1[name]['ms']:.3f})")
    e_b, g_b = ranks[0]["batch"]
    de = float(np.max(np.abs(e_b - batch1[0]) / np.abs(batch1[0])))
    dg = rel_rmse(torch.as_tensor(g_b), torch.as_tensor(batch1[1]))
    log(f"phase 3k batch energy, data x model {SHARD_DATA_MODEL}: "
        f"energies {e_b.tolist()} vs P=1 {batch1[0].tolist()} (rel "
        f"{de:.3e}), dE/dQ_local rel RMSE {dg:.3e}")
    require(de < TOL_STEP_E and dg < TOL_STEP_F,
            f"batch energy vs P=1: {de}, {dg}")
    log(f"phase 3k dryrun_multichip(4, device='cuda') on rank 0: "
        f"{ranks[0]['dryrun']}")
    log("phase 3k: sharded layer on 2 and 4 gloo ranks ok")
    sharded_keywords(w, f64, p1, [r["keywords"] for r in ranks[:2]], card)
    log("phase 3j: the precision keywords at P = 1 (NCCL) and P = 2 (gloo) "
        "ok")
    for name in ("pair_fwd", "pair_bwd", "pair_hvp", "spread", "gather",
                 "frames_fwd", "frames_bwd"):
        record[name]["sharded_launches"] = {
            "98k_P1": large["launches"][name],
            "pol_P1": pol1["launches"][name],
            "fullff_P1": ff1["launches"][name],
            **{f"{kind}_P{n}_rank0": by_p[n][0][kind]["launches"][name]
               for n in SHARD_PS for kind in ("pol", "ff")}}
    for name in ("pair_third", "spread_c3", "gather_c3", "spread_tiled",
                 "gather_tiled"):
        record[name]["sharded_launches"] = {}


# ---------------------------------------------------------------------------
# phase 3l: the user's scripts (admp_tpu_torch.examples)
# ---------------------------------------------------------------------------

# each script at the size its users run: run_water --nmol 1000 (plain and
# --polarizable), run_npt --nmol 1000 --steps 20 --segments 3, fit_params
# main() and multi_config(n_side=10), fluctuating_multipoles --n-side 32
# and its sharded branch at world size 1 over NCCL
SCRIPT_NMOL, NPT_SCRIPT_STEPS, NPT_SCRIPT_SEGMENTS = 1000, 20, 3
FIT_N_SIDE, FIT_PLAIN_EPOCHS, FIT_COMPARE_STEPS = 10, 2, 2
# the barostat's largest compression, forced once on the NPT script's end
# state: it must change the pair count
FORCED_DLNV = -0.02
FLUCT_TIMED_STEPS = 3  # fluctuating_multipoles.run's default time_steps


def script_logger(name):
    return lambda msg: log(f"  [{name}] {msg}")


def script_step_counts(label, counts, shapes=((6, 1),), hvp_kinds=(),
                       tiled=False, pairs=True):
    """Gate a script's launches: K1 and K2 (with ``pairs``) and, per
    (order, C) in ``shapes``, K4/K6 (K5/K7 with ``tiled``), and K3 of each
    kind in ``hvp_kinds``."""
    sp, ga = (("spread_tiled_by_shape", "gather_tiled_by_shape") if tiled
              else ("spread_by_shape", "gather_by_shape"))
    ok = not pairs or (counts["pair_fwd"] > 0 and counts["pair_bwd"] > 0)
    ok = ok and all(counts[sp][s] > 0 and counts[ga][s] > 0 for s in shapes)
    ok = ok and all(counts["pair_hvp_by_kind"][k] > 0 for k in hvp_kinds)
    require(ok, f"phase 3l {label}: a kernel never launched: {counts}")


def script_launches(counts):
    """A script's launches per kernel record (phase 3l's column)."""
    by = lambda key, c: sum(v for (o, ch), v in counts[key].items()  # noqa: E731
                            if (ch == 1) == (c == 1))
    return {"pair_fwd": counts["pair_fwd"], "pair_bwd": counts["pair_bwd"],
            "pair_hvp": counts["pair_hvp"],
            "pair_third": counts["pair_third"],
            "spread": by("spread_by_shape", 1),
            "gather": by("gather_by_shape", 1),
            "spread_c3": by("spread_by_shape", 3),
            "gather_c3": by("gather_by_shape", 3),
            "spread_tiled": sum(counts["spread_tiled_by_shape"].values()),
            "gather_tiled": sum(counts["gather_tiled_by_shape"].values()),
            "frames_fwd": counts["frames_fwd"],
            "frames_bwd": counts["frames_bwd"]}


def run_script(name, fn, walls, launches):
    """fn() on the kernels with the counts set to 0 just before and read
    just after; its wall time and counts are kept under ``name``."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    counts = read_counts()
    launches[name] = counts
    log(f"phase 3l {name}: {walls[name]:.1f} s wall, launches {counts}")
    return out, counts


def same_step(label, kern, plain, e_keys, f_keys, tol_f, tol_e=TOL_STEP_E,
              scale=None):
    """Gate a script's energies (relative, or over ``scale``) and forces
    (relative RMSE) on the kernels against its run on the plain versions."""
    for key in e_keys:
        de = abs(kern[key] - plain[key]) / (scale or abs(plain[key]))
        over = f" of the largest term {scale:.1f}" if scale else " relative"
        log(f"phase 3l {label} {key}: kernels {kern[key]:.6f}, plain "
            f"{plain[key]:.6f} ({de:.3e}{over})")
        require(de < tol_e, f"phase 3l {label} {key}: {de}")
    for key in f_keys:
        df = rel_rmse(kern[key], plain[key])
        log(f"phase 3l {label} {key}: force rel RMSE {df:.3e}")
        require(bool(torch.isfinite(kern[key]).all()) and df < tol_f,
                f"phase 3l {label} {key}: {df}")


def scripts_path(record, card):
    """Phase 3l: each of the user's scripts once on the card through its own
    run() (its printed lines logged), on the kernels with its launches, and
    again on the plain versions (``method='torch'``) where it computes a
    deterministic energy or force, gated by the phase of the same system;
    the scripts' own asserts; one forced volume move on the NPT script's end
    state that changes the pair count, its refreshed list against a fresh
    cell list."""
    import torch.distributed as dist

    from admp_tpu_torch import water_system
    from admp_tpu_torch.examples import fit_params, run_npt, run_water
    from admp_tpu_torch.systems import write_water_inputs
    from admp_tpu_torch.examples import fluctuating_multipoles as fluct

    walls, launches = {}, {}
    quiet = lambda msg: None  # noqa: E731

    # run_water --nmol 1000, plain (3e's tolerances) and --polarizable (3b's)
    kern_times = {}
    for pol, tol_f in ((False, TOL_STEP_F), (True, TOL_ADJ_F)):
        name = "run_water" + (" --polarizable" if pol else "")
        kern, counts = run_script(name, lambda pol=pol: run_water.run(
            nmol=SCRIPT_NMOL, polarizable=pol,
            log=script_logger(name)), walls, launches)
        script_step_counts(name, counts, shapes=((6, 1), (6, 3)),
                           hvp_kinds=("pol", "uu") if pol else ())
        plain = run_water.run(nmol=SCRIPT_NMOL, polarizable=pol,
                              method="torch", time_iters=0, log=quiet)
        # the PME total is a residue of ~1e5 kJ/mol terms: over the largest
        terms = plain["pme"].get_metrics(*plain["e_args"])
        scale = max(abs(float(terms[t])) for t in ("e_real", "e_recip",
                                                   "e_self"))
        same_step(name, kern, plain, ("e_pme",), (), tol_f, scale=scale)
        same_step(name, kern, plain, ("e_disp", "e_tt"),
                  ("f_pme", "f_disp", "f_tt"), tol_f)
        kern_times[name] = kern["ms_step"]
        log(f"phase 3l {name}: PME grid {kern['grid']}, dispersion grid "
            f"{(plain['disp'].K1, plain['disp'].K2, plain['disp'].K3)}")
        if pol:
            require(kern["converged"], "phase 3l run_water: SCF did not "
                    "converge")

    # run_npt --nmol 1000 --steps 20 --segments 3 (3h's system)
    name = "run_npt"
    npt, counts = run_script(name, lambda: run_npt.run(
        SCRIPT_NMOL, NPT_SCRIPT_STEPS, NPT_SCRIPT_SEGMENTS,
        log=script_logger(name)), walls, launches)
    script_step_counts(name, counts)
    for seg in npt["segments"]:
        require(all(np.isfinite([seg["e"], seg["volume"], seg["t_inst"]])),
                f"phase 3l run_npt: segment not finite {seg}")
    log(f"phase 3l run_npt: pair counts per segment (before -> after the "
        f"barostat) {[s['pairs'] for s in npt['segments']]}, accepted "
        f"{npt['accepts']}/{NPT_SCRIPT_SEGMENTS}")
    m = npt["system"]
    plain_m = run_npt.build(SCRIPT_NMOL, m["positions"].device,
                            torch.float32, "torch")
    plain_e, plain_f, _ = run_npt.force_fn(
        plain_m["energy"], plain_m["box"], plain_m["nl"].pairs)(
            plain_m["positions"], None)
    same_step(name, dict(e0=npt["e0"], f0=npt["f0"]),
              dict(e0=float(plain_e), f0=plain_f), ("e0",), ("f0",),
              TOL_STEP_F)
    # the forced volume move on the end state
    n = npt["n_atoms"]
    pos, box, refreshed, fresh = run_npt.volume_move(
        m, npt["state"].positions, npt["box"], npt["nl"],
        math.exp(FORCED_DLNV / 3.0))
    before = run_npt.n_pairs(npt["nl"], n)
    after, n_fresh = run_npt.n_pairs(refreshed, n), run_npt.n_pairs(fresh, n)
    keep = lambda nl: nl.pairs[nl.pairs[:, 0] < n]  # noqa: E731
    same_set = torch.equal(*(torch.unique(keep(nl)[:, 0] * n + keep(nl)[:, 1])
                             for nl in (refreshed, fresh)))
    with torch.no_grad():
        e_ref, e_fresh = (float(m["energy"](pos, box, nl.pairs))
                          for nl in (refreshed, fresh))
    de = abs(e_ref - e_fresh) / abs(e_fresh)
    log(f"phase 3l run_npt forced volume move (ln V {FORCED_DLNV:+}): pair "
        f"count {before} -> {after} refreshed at capacity "
        f"{refreshed.capacity}, {n_fresh} in a fresh cell list, the same "
        f"pairs {same_set}; energy refreshed {e_ref:.4f} vs fresh "
        f"{e_fresh:.4f} ({de:.3e})")
    require(after != before, "phase 3l: the volume move kept the pair count")
    require(not bool(refreshed.did_overflow) and same_set,
            "phase 3l: the refreshed list is not the fresh cell list's")
    require(de < TOL_STEP_E, f"phase 3l: refreshed vs fresh energy {de}")

    # fit_params main() (dispersion, 24 atoms) and multi_config(n_side=10),
    # in float32 on the card, against the plain versions (3d's TOL_FIT)
    with tempfile.TemporaryDirectory() as tmp:
        s = water_system(n_side=1)
        fit_params.FF_XML = write_water_inputs(tmp, s["positions"],
                                               s["box"])[0]
        name = "fit_params main"
        fm, counts = run_script(name, lambda: fit_params.main(
            dtype=torch.float32, log=script_logger(name)), walls, launches)
        script_step_counts(name, counts, shapes=((6, 3),), pairs=False)
        fp = fit_params.main(dtype=torch.float32, method="torch", log=quiet)
        for key in ("e_disp",):
            de = abs(fm[key] - fp[key]) / abs(fp[key])
            log(f"phase 3l {name} {key}: kernels {fm[key]:.6f}, plain "
                f"{fp[key]:.6f} ({de:.3e})")
            require(de < TOL_STEP_E, f"phase 3l {name} {key}: {de}")
        for key in ("dE_dmScales", "dE_dC6"):
            dg = rel_rmse(torch.as_tensor(fm[key]), torch.as_tensor(fp[key]))
            log(f"phase 3l {name} {key}: rel RMSE {dg:.3e}")
            require(dg < TOL_STEP_F, f"phase 3l {name} {key}: {dg}")
        dl = [abs(a - b) / abs(b) for a, b in zip(
            fm["losses"][:FIT_COMPARE_STEPS], fp["losses"])]
        log(f"phase 3l {name}: C6 error {fm['rel0']:.3f} -> "
            f"{fm['rel1']:.4f} (plain {fp['rel1']:.4f}); first losses rel "
            f"{[f'{x:.2e}' for x in dl]}")
        require(max(dl) < TOL_FIT, f"phase 3l {name} losses: {dl}")
    name = "fit_params multi_config"
    # at n_side=10 the script's own loss assert does not hold with its
    # settings (Adam 2e-3 oscillates: the same in float64 on the CPU on the
    # plain path, 14.9 -> 21.0), so it runs there without the assert, gated
    # against the plain versions, and with the assert at its default size
    mc, counts = run_script(name, lambda: fit_params.multi_config(
        n_side=FIT_N_SIDE, dtype=torch.float32, log=script_logger(name),
        check=False), walls, launches)
    script_step_counts(name, counts, hvp_kinds=("perm",))
    mp = fit_params.multi_config(n_side=FIT_N_SIDE, n_epochs=FIT_PLAIN_EPOCHS,
                                 dtype=torch.float32, method="torch",
                                 log=quiet, check=False)
    dl = [abs(a - b) / abs(b) for a, b in zip(mc["losses"], mp["losses"])]
    log(f"phase 3l {name}: {mc['n_atoms']} atoms, loss {mc['l0']:.4g} -> "
        f"{mc['l1']:.4g} (ratio {mc['l1'] / mc['l0']:.3f}; the script asks "
        f"< 0.2), losses {[round(x, 4) for x in mc['losses']]}; ms per fit "
        f"step {[round(x, 1) for x in mc['step_ms']]}; first {len(dl)} "
        f"losses rel to plain {[f'{x:.2e}' for x in dl]}")
    require(mc["n_atoms"] == 3 * FIT_N_SIDE ** 3 and mc["steps"] == 20
            and mc["r1_steps"] == 10
            and bool(np.isfinite(mc["losses"]).all()) and max(dl) < TOL_FIT,
            f"phase 3l {name}: {mc['steps']} steps, losses {dl}")
    fit_params.multi_config(dtype=torch.float32,
                            log=script_logger(name + " (24 atoms)"))

    # fluctuating_multipoles --n-side 32 (3f's tolerances) ...
    name = "fluctuating_multipoles"
    fk, counts = run_script(name, lambda: fluct.run(
        N98_SIDE, log=script_logger(name)), walls, launches)
    script_step_counts(name, counts, tiled=True)
    require(fk["route"] == "cuda2d", f"phase 3l {name}: route {fk['route']}")
    box_sys = fk["box_sys"]
    fp = fluct.run(N98_SIDE, method="torch", time_steps=0, box_sys=box_sys,
                   log=quiet)
    with torch.no_grad():
        pos = box_sys["positions"]
        terms = fp["force"].get_metrics(
            pos, box_sys["box"], box_sys["nlist"].pairs,
            fluct.fluctuating_q_local(pos, box_sys["q_cart"]),
            box_sys["m_scales"])
    scale = max(abs(float(terms[t])) for t in ("e_real", "e_recip",
                                               "e_self"))
    same_step(name, fk, fp, ("e",), ("f",), TOL_STEP_F98, TOL_E98, scale)
    # ... and its sharded branch at world size 1 over NCCL (3j's)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=pos.device)
    try:
        name = "fluctuating_multipoles --sharded"
        sk, counts = run_script(name, lambda: fluct.run(
            N98_SIDE, sharded=True, box_sys=box_sys,
            log=script_logger(name)), walls, launches)
        steps = 1 + FLUCT_TIMED_STEPS
        require(all(counts[k] == steps for k in ("pair_fwd", "pair_bwd",
                                                 "spread", "gather")),
                f"phase 3l {name}: K1/K2/K4/K6 not once per step: {counts}")
        sp = fluct.run(N98_SIDE, sharded=True, method="torch", time_steps=0,
                       box_sys=box_sys, log=quiet)
        same_step(name, sk, sp, ("e",), ("f",), TOL_STEP_F98, TOL_E98, scale)
    finally:
        dist.destroy_process_group()

    ms = {"run_water": kern_times["run_water"],
          "run_water --polarizable": kern_times[
              "run_water --polarizable"],
          "run_npt": 1e3 * npt["wall_s"] / (NPT_SCRIPT_STEPS
                                            * NPT_SCRIPT_SEGMENTS),
          "fit_params main": statistics.median(fm["step_ms"]),
          "fit_params multi_config": statistics.median(mc["step_ms"]),
          "fluctuating_multipoles": fk["ms_step"],
          "fluctuating_multipoles --sharded": sk["ms_step"]}
    what = {"run_water": "ms per PME energy+force (time_fn, 5 calls)",
            "run_npt": "ms per Langevin step, the segments' wall over their "
                       "steps (refreshes and barostat moves included)",
            "fit_params main": "ms per fit step (median of 150)",
            "fit_params multi_config": "ms per fit step (median of 20)",
            "fluctuating_multipoles": "ms per energy+force (median of 3)"}
    for label, wall in walls.items():
        unit = next(v for k, v in what.items() if label.startswith(k))
        log(f"phase 3l [{card}]: {label}: {wall:.1f} s wall, "
            f"{ms[label]:.3f} {unit}")
    for rec_name, rec in record.items():
        if not rec_name.startswith("_"):
            rec["script_launches"] = {
                label: script_launches(c)[rec_name]
                for label, c in launches.items()}
    return ms


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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
                   bound_s(nbytes(m_u0, q) + 4 * n_ch * kcube, q.numel())),
        "gather": (lambda: S.launch_gather(m_u0, g_mesh, grid, order),
                   lambda: S.gather_torch(m_u0, g_mesh, grid, order),
                   lambda: torch.take(g_mesh, g_idx),
                   bound_s(nbytes(m_u0, q) + touched, 0)),
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
                         f"{c[3][0] * 1e3:.4f} ms ({c[3][1]})")
            log(f"phase 4 [{card}]: 98k {grid} {name}: {ms:.4f} ms/call "
                f"({dev_ms:.4f} ms device){extra}")


def launcher_host_us(S, P, dev, rounds=5, n=1000, parts=False):
    """Host us per call (time.perf_counter over n back-to-back calls, no
    synchronize inside: the launches queue up on the card, so this is the
    caller's own host work while the card keeps up), the median of
    ``rounds`` rounds that take every call in turn: K6's and K4's launchers
    at the MD shapes ((6, 1), 3000 atoms on (96, 96, 128)) and the full
    force field's ((4, 3) on 128^3), one torch.take beside K6 and one
    torch.index_add beside K4 (the same functions), K5's launcher at 98,304
    atoms on 320^3, and K1's, K2's and K3's launchers ('pol' lmax 2) on 4,096
    pairs (one wave of blocks) over 200 calls, since K3's one wave outlasts
    its launcher's host work and fewer calls queue fewer launches ahead of
    the card. The inputs are random from a seed: the host work does not
    depend on them. ``S`` and ``P`` are the ops/cuda/spread and
    ops/cuda/pairs modules under test. With ``parts``, also two pieces of
    K6's launcher at the MD shapes alone: torch.empty of its output, and
    the C entry point's call (ctypes and the launch) into a buffer made
    beforehand."""
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
        m_u0, mesh, q = inputs(3000, grid, n_ch, order)
        kcube = mesh[0].numel()
        idx = (S.flat_stencil_indices(m_u0, grid, order)[:, None, :]
               + (torch.arange(n_ch, device=dev) * kcube)[None, :, None])
        calls[f"gather ({order}, {n_ch})"] = functools.partial(
            S.launch_gather, m_u0, mesh, grid, order)
        calls[f"torch.take ({order}, {n_ch})"] = functools.partial(
            torch.take, mesh, idx)
        calls[f"spread ({order}, {n_ch})"] = functools.partial(
            S.launch_spread, m_u0, q, grid, order)
        calls[f"torch.index_add ({order}, {n_ch})"] = functools.partial(
            torch.index_add, torch.zeros(n_ch * kcube, device=dev), 0,
            idx.transpose(0, 1).reshape(-1), q.transpose(0, 1).reshape(-1))
        if parts and n_ch == 1:
            out = torch.empty(3000, 1, order ** 3, device=dev)
            ptr = ctypes.c_void_p
            args = (ptr(m_u0.data_ptr()), ptr(mesh.data_ptr()),
                    ptr(out.data_ptr()), 3000, 1, order, *grid,
                    ptr(S._raw_stream(0)))
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
    # 'pol' lmax 2 tables: positions in a 10 A cubic box, unmasked pairs;
    # K1/K2 read them as one table, pair p at rows p and c + p (an older
    # tree's K1/K2 launchers, under --launchers, take the two tables)
    c = 4096
    f32 = dict(device=dev, dtype=torch.float32)
    g = [torch.tensor(rng.standard_normal((c, 17)), **f32) for _ in range(2)]
    for t in g:
        t[:, :3] = torch.tensor(rng.uniform(0, 10, (c, 3)), **f32)
    idx = torch.arange(c, device=dev)
    listed = (torch.cat(g), idx, idx + c)
    if "table" not in inspect.signature(P.launch_pair_fwd).parameters:
        listed = g
    scl = torch.ones(3, c, **f32)
    eye = torch.eye(3, **f32).reshape(-1)
    scal = torch.cat([torch.tensor([0.3], **f32), 10 * eye, 0.1 * eye])
    ct = torch.ones(c, **f32)
    calls["pair_fwd (pol, 2)"] = functools.partial(
        P.launch_pair_fwd, *listed, scl, scal, 2, "pol")
    calls["pair_bwd (pol, 2)"] = functools.partial(
        P.launch_pair_bwd, *listed, scl, scal, ct, 2, "pol")
    calls["pair_hvp (pol, 2)"] = functools.partial(
        P.launch_pair_hvp, *g, scl, scal, ct, *g, scl, scal, 2, "pol")
    times = {k: [] for k in calls}
    for _ in range(rounds):
        for label, fn in calls.items():
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            count = 200 if label.startswith("pair_") else n
            t0 = time.perf_counter()
            for _ in range(count):
                fn()
            times[label].append((time.perf_counter() - t0) / count * 1e6)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def device_by_kernel(fn, n=20):
    """ms per call of each device activity of fn() (kernels, memsets), by
    name, from one profile of n calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name[:48]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    return out


def kernels_against(others, dev, card, repeats=5):
    """Device ms per call of K3-K7 from this tree's sources and from those
    of each checkout in ``others`` (built there by its own build.py, all at
    once, and loaded beside this tree's: the C interfaces are the same), on
    the same inputs in one process, the trees taken in turn, median of
    ``repeats`` profiles each, every call checked first: K3 'pol', 'uu' and
    'perm' at the MD shapes (every output under K3's float64 gate, hvp_ok), K4 at the MD
    shapes (6, 1), the full force field's (4, 3) and 98k on 320^3 (within
    TOL_SPREAD of the plain spread), K5 at 98k on 320^3 and 256^3 (each
    tree's mesh within TOL_SPREAD of this tree's), K6 at the MD shapes, at
    the full force field's (4, 3) and at 98k on 320^3 and 256^3, K7 at 98k
    on 320^3 and 256^3 (K6 and K7 bit for bit against the plain gather).
    Logged, with the registers and spills of every tree's K2, K3, K4 and
    K7. K2 is not timed here: its C entry reads the packed table through
    the pair list, which older trees' K2 entries (gathered rows) do not;
    the kernels line of a full run times it."""
    from admp_tpu_torch.ops.cuda import build, pairs as PP, spread as S

    names = ("pairs", "pair_hvp", "spread", "spread_tiled")
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from admp_tpu_torch.ops.cuda import build as b; "
            f"logs = b.build({names!r}); print(json.dumps("
            f"[[str(b.library_path(n)) for n in {names!r}], logs]))")
    procs = {d: subprocess.Popen([sys.executable, "-c", code, d],
                                 stdout=subprocess.PIPE, text=True)
             for d in others}
    logs = {"this tree": build.build(names)}
    libs = {"this tree": {n: ctypes.PyDLL(str(build.library_path(n)))
                          for n in names}}
    for d, proc in procs.items():
        out, _ = proc.communicate(timeout=900)
        require(proc.returncode == 0, f"the build of {d}")
        paths, logs[d] = json.loads(out)
        libs[d] = {n: ctypes.PyDLL(path) for n, path in zip(names, paths)}
    for name, tree_logs in logs.items():
        for lib in names:
            for line in ptxas_summary(tree_logs.get(lib, "")):
                if any(k in line for k in ("pair_bwd", "pair_hvp",
                                           "spread_kernel", "spread_vec",
                                           "gather_tiled")):
                    log(f"[{card}] {name} {lib}: {line}")
    P = ctypes.c_void_p
    stream = P(S._raw_stream(0))
    rng = np.random.default_rng(15)

    def mesh_of(shape):
        return torch.tensor(rng.standard_normal(shape), device=dev,
                            dtype=torch.float32)

    w = build_workload(dev)
    m_md, q_md = spread_inputs(w)
    m_ff, q_ff = disp_stencil(w, DISP_ORDER)
    cases = [("K6 MD (6, 1)", m_md, mesh_of((1, *w["grid"])), 6),
             (f"K6 full FF ({DISP_ORDER}, 3)", m_ff,
              mesh_of((3, K_FF, K_FF, K_FF)), DISP_ORDER)]
    spreads = [("K4 MD (6, 1)", m_md, q_md, w["grid"], 6),
               (f"K4 full FF ({DISP_ORDER}, 3)", m_ff, q_ff, (K_FF,) * 3,
                DISP_ORDER)]
    hvp_cases = [(f"K3 MD '{kind}'", kind, pair_inputs(w, kind))
                 for kind in ("pol", "uu", "perm")]
    w98 = build_large(dev)
    tiled, gathers = [], []
    for k in (K98, K98_ALT):
        grid = (k,) * 3
        m98, q98 = large_stencil(w98, grid)
        mesh = mesh_of((1, *grid))
        cases.append((f"K6 98k {k}^3 (6, 1)", m98, mesh, 6))
        bins = S.tile_bins(m98, grid)
        tiled.append((f"K5 98k {k}^3 (6, 1)", bins, q98, grid))
        gathers.append((f"K7 98k {k}^3 (6, 1)", m98, bins, mesh))
        if k == K98:
            spreads.append((f"K4 98k {k}^3 (6, 1)", m98, q98, grid, 6))

    def gather(lib, m_u0, mesh, order, out):
        return lambda: lib["spread"].admp_gather(
            P(m_u0.data_ptr()), P(mesh.data_ptr()), P(out.data_ptr()),
            m_u0.shape[0], mesh.shape[0], order, *mesh.shape[1:], stream)

    def spread(lib, m_u0, q, order, mesh, zero):
        call = lambda: lib["spread"].admp_spread(  # noqa: E731
            P(m_u0.data_ptr()), P(q.data_ptr()), P(mesh.data_ptr()),
            m_u0.shape[0], q.shape[1], order, *mesh.shape[1:], stream)
        if not zero:
            return call
        return lambda: (mesh.zero_(), call())[1]

    def spread_tiled(lib, bins, q, grid, out):
        return lambda: lib["spread_tiled"].admp_spread_tiled(
            P(bins.base.data_ptr()), P(bins.perm.data_ptr()),
            P(bins.offsets.data_ptr()), P(q.data_ptr()), P(out.data_ptr()),
            q.shape[1], 6, *grid, *S.TILE, stream)

    def gather_tiled(lib, bins, mesh, out):
        return lambda: lib["spread_tiled"].admp_gather_tiled(
            P(bins.base.data_ptr()), P(bins.perm.data_ptr()),
            P(bins.offsets.data_ptr()), P(mesh.data_ptr()),
            P(out.data_ptr()), mesh.shape[0], 6, *mesh.shape[1:], *S.TILE,
            stream)

    def pair_hvp(lib, tables, ct, cs, kind, outs):
        g_i, g_j, scl, scal, lmax = tables
        return lambda: lib["pair_hvp"].admp_pair_hvp(
            *(P(t.data_ptr()) for t in (g_i, g_j, scl, scal, ct, *cs,
                                        *outs)),
            g_i.shape[0], PP.KINDS[kind], lmax, stream)

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
    for label, m_u0, q, grid, order in spreads:
        ref = S.spread_torch(m_u0, q, grid, order)
        scale = float(ref.abs().max())
        for name, lib in libs.items():
            # How the harness tells the two C contracts apart: an
            # admp_spread that zeroes its mesh (this tree's) leaves no NaN
            # of a buffer filled with NaN; one that accumulates into the
            # mesh it is given (the parent's: its launcher zeroed it by
            # torch.zeros) leaves them, and its timed call zeroes the mesh
            # first (mesh.zero_()), so that both sides count a zeroing
            mesh = torch.full_like(ref, float("nan"))
            require(spread(lib, m_u0, q, order, mesh, False)() == 0,
                    f"{label} of {name}: launch")
            torch.cuda.synchronize()
            zero = bool(torch.isnan(mesh).any())
            calls[label, name] = spread(lib, m_u0, q, order, mesh, zero)
            require(calls[label, name]() == 0, f"{label} of {name}: launch")
            torch.cuda.synchronize()
            err = float((mesh - ref).abs().max()) / scale
            log(f"[{card}] {label} of {name}: {err:.3e} x max|mesh| from "
                f"the plain spread; zeroes its own mesh {not zero}")
            require(err <= TOL_SPREAD, f"{label} of {name}: {err}")
    for label, m_u0, bins, mesh in gathers:
        ref = S.gather_torch(m_u0, mesh, tuple(mesh.shape[1:]), 6)
        for name, lib in libs.items():
            out = torch.empty_like(ref)
            calls[label, name] = gather_tiled(lib, bins, mesh, out)
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
        require(all(float((m - meshes[0]).abs().max()) <= TOL_SPREAD * scale
                    for m in meshes), f"{label}: the meshes differ")
    for label, kind, tables in hvp_cases:
        g_i, g_j, scl, scal, lmax = tables
        c = g_i.shape[0]
        ct = torch.tensor(rng.uniform(0.5, 1.5, c), device=dev,
                          dtype=torch.float32)
        cs = PP.hvp_directions(tables[:4], kind, seed=5)
        x = (*tables[:4], ct, *cs)
        ref64 = PP.pair_hvp_torch(*(t.double() for t in x), lmax, kind)
        ref32 = PP.pair_hvp_torch(*x, lmax, kind)
        for name, lib in libs.items():
            n_blocks = -(-c // lib["pair_hvp"].admp_pair_hvp_block_size())
            outs = (torch.empty_like(g_i), torch.empty_like(g_j),
                    torch.empty_like(scl), torch.empty_like(ct),
                    torch.empty(n_blocks, PP.N_SCAL, device=dev))
            calls[label, name] = pair_hvp(lib, tables, ct, cs, kind, outs)
            require(calls[label, name]() == 0, f"{label} of {name}: launch")
            torch.cuda.synchronize()
            got = (outs[0], outs[1], outs[2], outs[4].sum(dim=0), outs[3])
            errs = [hvp_ok(*t) for t in zip(got, ref32, ref64)]
            log(f"[{card}] {label} C={c} of {name}: rel RMSE vs plain f64 "
                "d_gi, d_gj, d_scl, d_scal, d_ct (plain f32): " + ", ".join(
                    f"{e[0]:.3e} ({e[1]:.3e})" for e in errs))
            require(all(e[2] for e in errs), f"{label} of {name}: {errs}")
        del ref64, ref32
    times = {key: [] for key in calls}
    for _ in range(repeats):
        for key, fn in calls.items():
            times[key].append(cuda_time_ms(fn, n=20)[1])
    for label in dict.fromkeys(k[0] for k in calls):
        log(f"[{card}] {label}: device ms per call " + ", ".join(
            f"{name} {statistics.median(times[label, name]):.4f} "
            f"({min(times[label, name]):.4f}-{max(times[label, name]):.4f})"
            for name in libs))
    for label, *_ in spreads:  # K4's call: its zeroing beside its kernel
        for name in libs:
            log(f"[{card}] {label} of {name}, device ms per call by "
                "activity: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in
                    device_by_kernel(calls[label, name]).items()))


def time_kernels(record):
    """Each kernel, its plain version and its one-call PyTorch counterpart
    (where there is one) at the main path's shapes, and its bound."""
    from admp_tpu_torch.ops.cuda import pairs as P

    table, i, j, scl, scal, lmax, ct = record.pop("_pair_inputs")
    g_i, g_j = table.index_select(0, i), table.index_select(0, j)
    # the plain route: the gathers, the plain version, autograd (the
    # gathers' backward an index_add)
    leaves = [t.clone().requires_grad_(True) for t in (table, scl, scal)]
    e = (P.pair_energies_torch(leaves[0].index_select(0, i),
                               leaves[0].index_select(0, j), *leaves[1:],
                               lmax, "pol") * ct).sum()
    x, hct, cs, hl = record.pop("_hvp_inputs")
    host = lambda ts: [t.detach().cpu() for t in ts]  # noqa: E731
    hx, hcs = host(x), host(cs)
    h_tab, h_ct, h_hct = host((g_i, g_j, scl, scal)), ct.cpu(), hct.cpu()

    def host_bwd():
        lv = [t.clone().requires_grad_(True) for t in h_tab]
        torch.autograd.grad((P.pair_energies_torch(*lv, lmax, "pol")
                             * h_ct).sum(), lv)

    # K1 reads the table, the list's two columns, the scale rows and the
    # scalars once and writes C energies (as many bytes as ct); K2 reads
    # them and ct, writes the scale rows' gradient and adds into the (N, F
    # rounded up to 4) gradient table: each of its rows written at least
    # once (its memset outside the kernel, not counted)
    inputs = nbytes(table, i, j, scl, scal)
    d_table = 4 * table.shape[0] * -(-table.shape[1] // 4) * 4
    calls = {
        "pair_fwd": (
            lambda: P.launch_pair_fwd(table, i, j, scl, scal, lmax, "pol"),
            lambda: P.pair_energies_torch(table.index_select(0, i),
                                          table.index_select(0, j), scl,
                                          scal, lmax, "pol"),
            None,
            bound_s(inputs + nbytes(ct), count_ops(
                lambda: P.pair_energies_torch(*h_tab, lmax, "pol")))),
        "pair_bwd": (
            lambda: P.launch_pair_bwd(table, i, j, scl, scal, ct, lmax,
                                      "pol"),
            lambda: torch.autograd.grad(e, leaves, retain_graph=True),
            None,
            bound_s(inputs + nbytes(ct, scl) + d_table, count_ops(host_bwd))),
        "pair_hvp": (
            lambda: P.launch_pair_hvp(*x, hct, *cs, hl, "pol"),
            lambda: P.pair_hvp_torch(*x, hct, *cs, hl, "pol"),
            None,
            bound_s(2 * nbytes(*x, hct) + nbytes(*cs), count_ops(
                lambda: P.pair_hvp_torch(*hx, h_hct, *hcs, hl, "pol")))),
    }
    calls.update(third_calls(record.pop("_third_inputs")))
    m_u0, q, g_mesh = record.pop("_spread_inputs")
    calls.update(spread_calls(m_u0, q, g_mesh, 6))
    m3, q3, g3, order3 = record.pop("_spread_c3_inputs")
    calls.update({f"{k}_c3": v for k, v in
                  spread_calls(m3, q3, g3, order3).items()})
    m98, q98, g98 = record.pop("_tiled_inputs")
    calls.update(tiled_calls(m98, q98, g98, 6))
    calls.update(frames_calls(record.pop("_frames_inputs")))
    for name, (kernel, plain, library, (b_s, b_by)) in calls.items():
        r = record.setdefault(name, {})
        r["ms"], r["device_ms"] = cuda_time_ms(kernel)
        r["plain_ms"], r["plain_device_ms"] = cuda_time_ms(plain)
        r["library_ms"] = cuda_time_ms(library)[0] if library else None
        r["bound_ms"], r["bound_by"] = b_s * 1e3, b_by
    # K3b at the 'uu' shapes and K8 at 3,000 sites: logged, their record
    # rows are 'pol' and the 98k box
    for name in ("pair_third_uu", "frames_fwd_3000", "frames_bwd_3000"):
        r = record.pop(name)
        log(f"  {name}: kernel {r['ms']:.4f} ms/call ({r['device_ms']:.4f}"
            f" ms device), plain {r['plain_ms']:.4f} ms/call "
            f"({r['plain_device_ms']:.4f} ms device), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def third_calls(inputs):
    """K3b's (kernel, plain, library, bound) at the 'pol' and 'uu' shapes of
    the main path: it reads its 14 inputs once and writes its 9 outputs
    once; its operations are those of the plain version (counted on the
    host). No single PyTorch call computes it."""
    from admp_tpu_torch.ops.cuda import pairs as P

    calls = {}
    for kind, name in (("pol", "pair_third"), ("uu", "pair_third_uu")):
        x, ct, cs, hs, lmax = inputs[kind]
        args = (*x, ct, *cs, *hs)
        host = [t.detach().cpu() for t in args]
        outs = nbytes(*x, ct, *cs)  # the nine outputs' shapes
        log(f"  pair_third ({kind}): byte bound "
            f"{(nbytes(*args) + outs) / HBM_BYTES_S * 1e3:.4f} ms "
            f"({nbytes(*args) + outs} B over {HBM_BYTES_S:.3g} B/s)")
        calls[name] = (
            lambda a=args, k=kind, lm=lmax: P.launch_pair_third(*a, lm, k),
            lambda a=args, k=kind, lm=lmax: P.pair_third_torch(*a, lm, k),
            None,
            bound_s(nbytes(*args) + outs, count_ops(
                lambda h=host, k=kind, lm=lmax: P.pair_third_torch(*h, lm,
                                                                   k))))
    return calls


def adjoint_step_only(dev, card, tag):
    """The exact-adjoint step (SCFConfig()) of the admp_tpu_torch on
    sys.path alone: ms/step (time_steps, after a cold step) and one profiler
    window of 3 warm steps (profile_adjoint_<tag>.txt), logged."""
    from admp_tpu_torch import SCFConfig

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    w = build_workload(dev)
    force = make_force(w, True, dev, torch.float32, "auto", scf=SCFConfig())
    force.get_forces(*pol_args(w, w["positions"], torch.float32))
    ms, times, iters = time_steps(force, w)
    wall, device_ms, n_kernels, top = profile_steps(
        lambda n: run_steps(force, w, w["positions"], n), f"adjoint_{tag}")
    log(f"[{card}] {tag}: exact-adjoint step {ms:.3f} ms/step "
        f"({[round(t, 3) for t in times]}), warm PCG iterations "
        f"{sorted(set(iters))}; profile (3 warm steps, profiler on): "
        f"{wall:.3f} ms/step wall, {device_ms:.3f} ms/step device busy "
        f"({100 * device_ms / wall:.1f}%), {n_kernels:.0f} device "
        "kernels/step; top by device time:")
    for key, ms_k, count in top:
        log(f"  {ms_k:8.4f} ms/step  x{count:<4d} {key}")


def ptxas_summary(text):
    """One line per kernel of an nvcc -Xptxas -v log: its name with its
    template arguments, registers and spill stores / loads (the log's own
    register and spill lines where no kernel name is found)."""
    import re

    out, kernel, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for \S*?\d([a-z_]+_kernel)"
                      r"(I(?:Li\d+E)+E)?", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2) or "")
            kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.append(f"{kernel}: {m.group(1)} registers, {spill}")
            kernel, spill = None, ""
    return out or [line.strip() for line in text.splitlines()
                   if "registers" in line or "spill" in line]


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
    # --launchers DIR: only the launcher host-us line, and --adjoint DIR only
    # the exact-adjoint step's time and profile, of the admp_tpu_torch in DIR
    # (another commit's checkout, to compare in one run);
    # --kernels DIR [DIR ...]: only the device times of K2-K7,
    # this tree's beside each DIR's in one process
    # --sharded: only phases 1, 3j and 3k; --scripts: only phases 1 and 3l;
    # --precision: only phases 1, 3m and 3n; --fitting: only phase 1, K3b
    # against its plain version, phase 3d and K3b's times; --frames: only
    # phase 1, K8 against its plain chain, phase 3 and K8's times
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    other = sys.argv[2] if mode in ("--launchers", "--adjoint") else None
    sys.path.insert(0, other or str(ROOT))
    from admp_tpu_torch.ops.cuda import build

    dev = torch.device("cuda:0")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    if mode == "--launchers":
        from admp_tpu_torch.ops.cuda import pairs as P, spread as S
        build.build()
        log(f"[{card}] {S.__file__}: launcher host us per call: "
            + ", ".join(f"{k} {v:.2f}" for k, v in
                        launcher_host_us(S, P, dev).items()))
        return 0
    if mode == "--adjoint":
        build.build()
        adjoint_step_only(dev, card, pathlib.Path(other).resolve().name)
        return 0
    if mode == "--kernels":
        kernels_against(sys.argv[2:], dev, card)
        return 0

    t0 = time.perf_counter()
    logs = build.build()
    log(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, text in logs.items():
        (OUT_DIR / f"ptxas_{name}.log").write_text(text)
        for line in ptxas_summary(text):
            log(f"  {name}: {line}")

    record = {
        "pair_fwd": dict(source="admp_tpu_torch/csrc/pairs.cu",
                         replaces="admp_tpu/ops/pallas/pairs.py:330"),
        "pair_bwd": dict(source="admp_tpu_torch/csrc/pairs.cu",
                         replaces="admp_tpu/ops/pallas/pairs.py:343"),
        "pair_hvp": dict(source="admp_tpu_torch/csrc/pair_hvp.cu",
                         replaces="admp_tpu/ops/pallas/pairs.py:445"),
        # no TPU kernel: the VJP of K3's custom_vjp rule (_pair_bwd_op_bwd),
        # which admp_tpu has not; it takes this derivative on XLA only
        "pair_third": dict(source="admp_tpu_torch/csrc/pair_third.cu",
                           replaces="admp_tpu/ops/pallas/pairs.py:569"),
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
        # no TPU kernel: XLA fuses local_frames_components (frames.py:102)
        # and rot_local2global_components (harmonics.py:226) on the TPU
        "frames_fwd": dict(source="admp_tpu_torch/csrc/frames.cu",
                           replaces="admp_tpu/ops/frames.py:102"),
        "frames_bwd": dict(source="admp_tpu_torch/csrc/frames.cu",
                           replaces="admp_tpu/ops/frames.py:102"),
    }
    t0 = time.perf_counter()
    w = build_workload(dev)
    if mode == "--sharded":
        sharded_path(w, build_large(dev), record, card)
        return 0
    if mode == "--scripts":
        scripts_path(record, card)
        log("phase 3l: the user's scripts ok")
        return 0
    if mode == "--fitting":
        check_third(w, record)
        fit_times = fitting_path(w, record)
        for label, t in fit_times.items():
            log(f"phase 3d [{card}]: fit step ({label}): kernel "
                f"{statistics.median(t['kernel'][1:]):.3f} ms/step "
                f"({[round(v, 3) for v in t['kernel']]}), plain f32 "
                f"{statistics.median(t['plain32'][1:]):.3f} ms/step "
                f"({[round(v, 3) for v in t['plain32']]})")
        for name, (kernel, plain, _, (b_s, b_by)) in third_calls(
                record.pop("_third_inputs")).items():
            ms_k, dev_k = cuda_time_ms(kernel)
            ms_p, dev_p = cuda_time_ms(plain)
            log(f"  [{card}] {name}: kernel {ms_k:.4f} ms/call ({dev_k:.4f} "
                f"ms device), plain {ms_p:.4f} ms/call ({dev_p:.4f} ms "
                f"device), bound {b_s * 1e3:.4f} ms ({b_by})")
        log("phase 3d: trainer ok")
        return 0
    if mode == "--frames":
        check_frames(w, build_large(dev), record)
        log("phase 2: K8 agrees with its plain chain")
        main_path(w, record)
        log("phase 3: main path ok")
        rows = []
        for name, (kernel, plain, _, (b_s, b_by)) in frames_calls(
                record.pop("_frames_inputs")).items():
            ms_k, dev_k = cuda_time_ms(kernel)
            ms_p, dev_p = cuda_time_ms(plain)
            log(f"  [{card}] {name}: kernel {ms_k:.4f} ms/call ({dev_k:.4f} "
                f"ms device), plain {ms_p:.4f} ms/call ({dev_p:.4f} ms "
                f"device), bound {b_s * 1e3:.4f} ms ({b_by})")
            if name in ("frames_fwd", "frames_bwd"):
                r = record[name]
                rows.append(dict(
                    name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=r["launches"],
                    max_abs_err=r["max_abs_err"], ms=ms_k, device_ms=dev_k,
                    plain_ms=ms_p, plain_device_ms=dev_p, bound_ms=b_s * 1e3,
                    bound_by=b_by, library_ms=None))
        log(card)
        print(json.dumps({"kernels": rows}))
        return 0
    if mode == "--precision":
        pol_forces, pol_prec = pol_ladder_path(w)
        time_pol_ladder(pol_forces, w, card, pol_prec)
        del pol_forces
        large_ladder_path(build_large(dev), card)
        log("phases 3m and 3n ok")
        return 0
    log(f"workload: {w['positions'].shape[0]} atoms, "
        f"{w['pairs'].shape[0]} pair slots (dense), "
        f"{w['ff_pairs'].shape[0]} (cell list), built in "
        f"{time.perf_counter() - t0:.1f} s")
    check_pairs(w, record)
    check_hvp(w, record)
    check_third(w, record)
    check_spread(w, record)
    check_spread_c3(w, record)
    check_spread_rows(dev)
    w98 = build_large(dev)
    check_spread_tiled(w98, record)
    check_frames(w, w98, record)
    log("phase 2: every kernel agrees with its plain version")

    force, plain32 = main_path(w, record)
    log("phase 3: main path ok")
    adj, adj_plain, adj_warm = adjoint_path(w, record)
    log("phases 3b, 3c: exact-adjoint path and parameter gradients ok")
    fit_times = fitting_path(w, record)
    log("phase 3d: trainer ok")
    ff, ff_plain, ff_fit_ms = ff_path(w, record)
    log("phase 3e: full force field ok")
    large = large_path(w98, record)
    log("phase 3f: large system ok")
    front = front_end_path(w)
    log("phase 3g: front end ok")
    md_kern, md_plain = md_path(w)
    log("phase 3h: MD ok")
    prec_forces, prec_pol, prec = precision_path(w)
    log("phase 3i: precision modes ok")
    pol_forces, pol_prec = pol_ladder_path(w)
    log("phase 3m: precision modes on the polarizable MD step ok")
    large_ladder_path(w98, card)
    log("phase 3n: precision modes on the 98k system ok")
    sharded_path(w, w98, record, card)
    scripts_path(record, card)
    log("phase 3l: the user's scripts ok")

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
    ms_warm, times_warm, _ = time_steps(adj_warm, w)
    log(f"phase 4 [{card}]: exact-adjoint step (SCFConfig()): kernel path "
        f"{ms_adj:.3f} ms/step ({[round(t, 3) for t in times_adj]}), plain "
        f"path {ms_adj_plain:.3f} ms/step "
        f"({[round(t, 3) for t in times_adj_plain]}); warm PCG iterations "
        f"{sorted(set(iters_adj))}; with adjoint_warmstart (kernels) "
        f"{ms_warm:.3f} ms/step ({[round(t, 3) for t in times_warm]})")
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
    npt_run = langevin_runner(md_kern)
    ms_npt, times_npt, _ = time_runs(npt_run)
    ms_npt_plain, times_npt_plain, _ = time_runs(langevin_runner(md_plain))
    log(f"phase 4 [{card}]: NPT Langevin step (3h system): kernel path "
        f"{ms_npt:.3f} ms/step ({[round(t, 3) for t in times_npt]}), plain "
        f"path {ms_npt_plain:.3f} ms/step "
        f"({[round(t, 3) for t in times_npt_plain]})")
    time_front_end(front, w, card)
    time_precision(prec_forces, prec_pol, w, card, prec)
    time_pol_ladder(pol_forces, w, card, pol_prec)
    for name, run in (
            ("md", lambda n: run_steps(force, w, w["positions"], n)),
            ("adjoint", lambda n: run_steps(adj, w, w["positions"], n)),
            ("fullff", lambda n: run_ff(ff, w, n)),
            ("large", lambda n: run_large(large[K98]["auto"], w98, n)),
            ("npt", npt_run)):
        wall, device_ms, n_kernels, top = profile_steps(run, name)
        log(f"profile {name} (3 warm steps, profiler on): {wall:.3f} ms/step "
            f"wall, {device_ms:.3f} ms/step device busy "
            f"({100 * device_ms / wall:.1f}%), {n_kernels:.0f} device "
            "kernels/step; top by device time:")
        for key, ms_k, count in top:
            log(f"  {ms_k:8.4f} ms/step  x{count:<4d} {key}")
    time_large_kernels(w98, card)
    from admp_tpu_torch.ops.cuda import pairs as P, spread as S
    log(f"phase 4 [{card}]: launcher host us per call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in
                    launcher_host_us(S, P, dev, parts=True).items()))
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
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    sharded_launches=r["sharded_launches"],
                    script_launches=r["script_launches"])
               for name, r in record.items()]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
