"""The Langevin MD loop: BAOAB NVT steps through the program's
``md.make_langevin_step`` on the configuration's system under test, in
segments of ``segment_steps`` on one pair list, refreshed between segments
(``refresh_neighbor_list``), as md.py prescribes.

Set-up builds the inputs from the seed, the system under test and its first
forces, takes ``warmup_steps`` steps and one refresh (every shape the window
uses), and ends in a synchronization. The window then steps until
``seconds`` have passed, recording a CUDA event at each step's end and no
synchronization, so the host runs ahead where the program lets it. With
``trace`` a sub-window of ``trace_steps`` whole steps from
``trace_start_step`` is profiled (harness/trace.py).

The check, once the window has closed and the program is freed: from the
program's own state before a step (positions, velocities, forces) and the
same noise draw (the generator's state before the step), the reference takes
the step in float64 and evaluates its forces and dipoles afresh (its own pair
list at the list cutoff, frames, influence and converged dipoles). Checked:
the first step (whose input is the benchmark's own starting state, and whose
starting forces are compared too), ``check_window_steps`` steps of the
window's first ``check_within_steps`` drawn from the seed, and the window's
last step.
"""

from __future__ import annotations

import importlib
import math
import statistics
import time

import numpy as np
import torch


def rel_rmse(a, b):
    """Relative RMSE of ``a`` against the reference ``b``."""
    a, b = a.double(), b.double()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / (torch.sqrt(torch.mean(b ** 2)) + 1e-300))


def max_rel(a, b):
    """The largest per-atom deviation over the reference's RMS norm."""
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b, dim=-1).max()
                 / (torch.sqrt(torch.mean(torch.sum(b * b, dim=-1)))
                    + 1e-300))


class _Sample:
    """A step's input state, the noise generator's state before it, and
    its output state and dipoles."""

    def __init__(self, before, gen_state, after, dipoles):
        self.before, self.gen_state = before, gen_state
        self.after, self.dipoles = after, dipoles


def _device_info(device, peak):
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1, memory_peak_bytes=int(peak))
    return dict(platform="cpu", kind="cpu", count=1,
                memory_peak_bytes=int(peak))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config, traffic, limits, seed, seconds, trace, device,
        t_process=None, control=False):
    from admp_tpu_torch import MDState, make_langevin_step

    from benchmark.harness.trace import Window

    t_process = time.perf_counter() if t_process is None else t_process
    sysmod = importlib.import_module(f"benchmark.systems.{config['system']}")
    temp, dt = traffic["temperature_K"], traffic["dt_ps"]
    friction, seg = traffic["friction_per_ps"], traffic["segment_steps"]
    cutoff = config["model"]["rc_A"] + traffic["skin_A"]
    system = sysmod.make_system(config, seed, temp)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    prog = sysmod.WaterProgram(system, config, cutoff, device)
    step = make_langevin_step(prog.force_fn, prog.masses, dt, temp, friction)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    _, f0, _ = prog.force_fn(prog.positions, None)
    state = MDState(prog.positions, prog.velocities, f0, None)
    gst = gen.get_state()
    start = state
    state = step(state, gen)
    samples = [_Sample(start, gst, state, prog.dipoles())]
    for _ in range(traffic["warmup_steps"] - 1):
        state = step(state, gen)
    prog.refresh(state.positions)
    _sync(device)
    setup_s = time.perf_counter() - t_process

    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2]))
    picks = set(int(k) for k in rng.choice(
        np.arange(1, traffic["check_within_steps"]),
        traffic["check_window_steps"], replace=False))
    t_start, t_stop = traffic["trace_start_step"], (
        traffic["trace_start_step"] + traffic["trace_steps"])
    timing = device.type == "cuda"
    events = []
    traced_iters = []
    window = trace_state = None
    if timing:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        events.append(ev0)
    t0 = time.perf_counter()
    k = 0
    while True:
        if k > 0 and k % seg == 0:
            prog.refresh(state.positions)
        if trace and k == t_start:
            window = Window(device).__enter__()
            trace_state = state
        before, gst = state, gen.get_state()
        state = step(state, gen)
        if timing:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        if window is not None and k < t_stop:
            traced_iters.append(prog.scf_iterations())
        last = _Sample(before, gst, state, prog.dipoles())
        if k in picks:
            samples.append(last)
        k += 1
        if window is not None and k == t_stop:
            window.__exit__(None, None, None)
        if time.perf_counter() - t0 >= seconds and (not trace or k >= t_stop):
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    samples.append(last)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    step_ms = ([a.elapsed_time(b) for a, b in zip(events, events[1:])]
               if timing else [])
    summary = window.summary() if window is not None else None
    masses, grid = prog.masses, prog.grid
    del prog, step
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks, control_checks, failed, ref = _check(
        config, system, samples, masses, traffic, cutoff, limits, device,
        control)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.positions, state.velocities, state.forces))
    failed = failed if finite else k
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    ctx = dict(window=dict(seconds=window_s, steps=k, step_ms=step_ms),
               setup_s=setup_s)
    out = dict(correct=correct, attempted=k, failed=failed, checks=checks,
               device=_device_info(device, peak), ctx=ctx,
               control_checks=control_checks)
    if summary is not None:
        n_pairs = int(ref.pair_list(trace_state.positions, cutoff)[0].numel())
        traced = [x for x in traced_iters if x is not None]
        ctx["trace"] = dict(summary, steps=len(traced_iters),
                            pcg_iters=traced)
        ctx["shapes"] = dict(n_atoms=system["positions"].shape[0],
                             n_pairs=n_pairs,
                             lmax=int(config["model"]["lmax"]),
                             polarizable=bool(config["model"]["polarizable"]),
                             grid=tuple(grid))
        out["device"].update(busy_s=summary["busy_s"],
                             window_s=summary["wall_s"])
        out["breakdown"] = dict(device_ops=summary["device_ops"],
                                idle_gaps=summary["idle_gaps"])
    return out


class _Worst:
    """The worst of each number compared over the checked steps (a value
    that is not finite stays)."""

    def __init__(self, polarizable):
        self.v = dict(force_rmse=0.0, force_max=0.0, velocity_rmse=0.0)
        if polarizable:
            self.v["dipole_rmse"] = 0.0

    def take(self, name, value):
        old = self.v[name]
        self.v[name] = (value if not math.isfinite(value) or
                        not math.isfinite(old) else max(old, value))

    def forces(self, got, want):
        self.take("force_rmse", rel_rmse(got, want))
        self.take("force_max", max_rel(got, want))

    def checks(self, limits):
        return {k: dict(value=(v if math.isfinite(v) else float("inf")),
                        limit=float(limits[k]["limit"]))
                for k, v in self.v.items()}


def _check(config, system, samples, masses, traffic, cutoff, limits, device,
           control=False):
    """The numbers compared, each the worst over the checked steps, beside
    their limits; the count of checked steps whose output is not finite;
    the reference. With ``control``, also the same numbers of the control:
    the reference in float32 with TF32 matmuls, put in the program's place
    on the same states and noise."""
    refmod = importlib.import_module(
        f"benchmark.reference.{config['reference']}")
    ref = refmod.WaterReference(system, config["model"], device,
                                torch.float64)
    pol = bool(config["model"]["polarizable"])
    prog, ctl = _Worst(pol), _Worst(pol)
    ref_ctl = None
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        ref_ctl = refmod.WaterReference(system, config["model"], device,
                                        torch.float32)
    params = (masses, traffic["dt_ps"], traffic["temperature_K"],
              traffic["friction_per_ps"], cutoff)
    failed = 0
    start = samples[0].before
    f_start = ref.evaluate(start.positions, cutoff)[1]
    prog.forces(start.forces, f_start)
    if ref_ctl is not None:
        ctl.forces(ref_ctl.evaluate(start.positions, cutoff)[1], f_start)
    for s in samples:
        gen = torch.Generator(device=device)
        gen.set_state(s.gen_state)
        b = s.before
        noise = torch.randn(b.velocities.shape, generator=gen,
                            dtype=b.velocities.dtype, device=device)
        args = (b.positions, b.velocities, b.forces, noise) + params
        _, v_ref, f_ref, u_ref = refmod.langevin_step(ref, *args)
        got = [(prog, s.after.velocities, s.after.forces, s.dipoles)]
        if ref_ctl is not None:
            _, v_c, f_c, u_c = refmod.langevin_step(ref_ctl, *args)
            got.append((ctl, v_c, f_c, u_c))
        if not all(bool(torch.isfinite(t).all()) for t in (
                s.after.positions, s.after.velocities, s.after.forces)):
            failed += 1
        for w, v, f, u in got:
            w.forces(f, f_ref)
            w.take("velocity_rmse", rel_rmse(v, v_ref))
            if pol:
                w.take("dipole_rmse", rel_rmse(u, u_ref))
    if control:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return (prog.checks(limits), ctl.checks(limits) if control else None,
            failed, ref)


def percentile(values, q):
    """The q-th percentile (0-100) of ``values``, inclusive method."""
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
