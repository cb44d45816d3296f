"""The spans and counters of admp_tpu_torch/utils/profiling.py on the CPU, on
small water boxes (tests/watergen.py): off without a profiler (nothing
recorded, no marker node, the same numbers bit for bit as a traced run), on
under torch.profiler (every span of a Langevin step with its parent, the
leaf ranges top-level with the backward's autograd nodes inside the
``.bwd`` ranges, the registry's stamps inside the profiler's events), the
exact adjoint's third derivative traced, the list refresh and the export.
On the card: the kernels' step traced and untraced, no synchronizing call
in a fixed step and none but the SCF's residual reads in a polarizable
one, the frames on K8 still recorded as
``frames`` and ``frames.bwd``, with its two launches a step counted, and
every real-space pass on the indexed K1/K2 (``pairs.indexed``), none on the
gathered fallback (``pairs.gathered``)."""

import contextlib
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from admp_tpu_torch import (
    ADMPPmeForce,
    EngineConfig,
    MDState,
    SCFConfig,
    generate_pairwise_interaction,
    make_langevin_step,
    neighbor_list_cell,
    neighbor_list_dense,
    refresh_neighbor_list,
    tt_damping_qq_c6_kernel,
)
from admp_tpu_torch.fitting import energy_force_loss, fit
from admp_tpu_torch.ops import bonded as tb
from admp_tpu_torch.ops.harmonics import convert_cart2harm
from admp_tpu_torch.utils import profiling

try:
    from watergen import water_arrays
except ImportError:  # the card's machine has no JAX: the port's own boxes
    from admp_tpu_torch import water_system as water_arrays

SCALES = [0.0, 0.0, 0.0, 1.0, 1.0]
LAYERS = ("frames", "realspace", "reciprocal")
# a field tolerance the PCG has to iterate for, from zero dipoles
POL_SCF = dataclasses.replace(SCFConfig.md(), field_tol=1e-3)


def _profile():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


class _Water:
    """A small MPID water box: PME (fixed or polarizable), Tang-Toennies and
    the bonded terms summed as an MD user's force function does."""

    def __init__(self, lpol, device="cpu", dtype=torch.float64, n_side=3,
                 spread_method="auto"):
        s = water_arrays(n_side=n_side, seed=4)
        self.n = n = s["positions"].shape[0]
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,  # noqa
                                      device=device)
        self.t = t
        self.positions, self.box = t(s["positions"]), t(s["box"])
        self.masses = t(np.tile([15.999, 1.008, 1.008], n // 3))
        self.lpol = lpol
        cfg = EngineConfig(spread_method=spread_method)
        if lpol:
            cfg = dataclasses.replace(cfg, scf=POL_SCF)
        self.pme = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                                s["covalent_map"], 4.0, 1e-4, 2, lpol=lpol,
                                config=cfg, device=device, dtype=dtype)
        self.tt = generate_pairwise_interaction(
            tt_damping_qq_c6_kernel, s["covalent_map"], device=device)
        self.tt_args = [t(s[k]) for k in ("tt_a", "tt_b", "tt_q")] + [
            t(s["c_list"][:, 0])]
        self.bonded = [torch.as_tensor(x, device=device) if x.dtype.kind == "i"
                       else t(x) for x in tb.water_bonded_terms(n // 3)]
        self.q_local = convert_cart2harm(t(s["q_cart"]), 2)
        self.pol_args = (t(s["pol"]), t(s["tholes"]))
        self.sc = t(SCALES)
        self.pairs = neighbor_list_cell(self.positions, self.box, 4.5).pairs

    def energy(self, x):
        if self.lpol:
            e = self.pme.get_energy(x, self.box, self.pairs, self.q_local,
                                    *self.pol_args, self.sc, self.sc,
                                    self.sc)
        else:
            e = self.pme.get_energy(x, self.box, self.pairs, self.q_local,
                                    self.sc)
        e = e + self.tt(x, self.box, self.pairs, self.sc, *self.tt_args)
        bi, r0, kb, ai, th0, ka = self.bonded
        return (e + tb.harmonic_bond_energy(x, self.box, bi, r0, kb)
                + tb.harmonic_angle_energy(x, self.box, ai, th0, ka))

    def force_fn(self, positions, aux):
        x = positions.detach().requires_grad_(True)
        with torch.enable_grad():
            e = self.energy(x)
            (g,) = torch.autograd.grad(e, x)
        return e.detach(), -g, aux

    def start(self):
        """A BAOAB step function, its first state (from zero dipoles) and
        its seeded noise generator."""
        step = make_langevin_step(self.force_fn, self.masses, 2e-4, 300.0,
                                  10.0)
        gen = torch.Generator(device=self.positions.device).manual_seed(5)
        self.pme.U_ind = torch.zeros_like(self.pme.U_ind)
        _, f0, _ = self.force_fn(self.positions, None)
        return step, MDState(self.positions, torch.zeros_like(f0), f0,
                             None), gen

    def langevin_step(self, traced):
        """One step from ``start()``; (state, dipoles, profiler or None,
        snapshot)."""
        step, state, gen = self.start()
        profiling.reset()
        prof = None
        if traced:
            with _profile() as prof:
                state = step(state, gen)
        else:
            state = step(state, gen)
        return state, self.pme.U_ind, prof, profiling.snapshot()


@pytest.fixture(scope="module", params=["fixed", "pol"])
def runs(request):
    w = _Water(request.param == "pol")
    off = w.langevin_step(traced=False)
    on = w.langevin_step(traced=True)
    profiling.reset()
    return request.param, off, on


def _nodes(root):
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo += [nxt for nxt, _ in node.next_functions]
    return seen


def test_off_records_nothing_and_places_no_marker(runs):
    kind, off, _ = runs
    assert off[3] == {"spans": {}, "counters": {}}
    w = _Water(kind == "pol")
    x = w.positions.detach().requires_grad_(True)
    names = {type(n).__name__ for n in _nodes(w.energy(x).grad_fn)}
    assert "_OutputBackward" not in names
    with _profile():
        traced = {type(n).__name__ for n in _nodes(w.energy(x).grad_fn)}
    assert "_OutputBackward" in traced
    profiling.reset()


def test_traced_numbers_are_bitwise_the_untraced(runs):
    _, (s_off, u_off, _, _), (s_on, u_on, _, _) = runs
    assert torch.equal(s_off.forces, s_on.forces)
    assert torch.equal(s_off.velocities, s_on.velocities)
    assert torch.equal(s_off.positions, s_on.positions)
    assert torch.equal(u_off, u_on)


def test_one_step_records_every_span_with_its_parent(runs):
    kind, _, (_, _, _, snap) = runs
    spans = snap["spans"]
    want = {"md.step": None, "md.integrate": "md.step",
            "pme.energy": "md.step", "shortrange": "md.step",
            "shortrange.bwd": "md.step", "bonded": "md.step",
            "bonded.bwd": "md.step"}
    for name in LAYERS:
        want[name] = want[name + ".bwd"] = "pme.energy"
    if kind == "pol":
        want.update({"scf.solve": "pme.energy", "scf.iter": "scf.solve",
                     "host.sync": "scf.solve"})
        assert snap["counters"]["host.syncs.scf.residual"] == (
            spans["scf.iter"]["count"] + 1)
        # the field's gradient in the dipoles runs no frames backward
        assert spans["frames.bwd"]["count"] == 1
    for name, parent in want.items():
        assert parent in spans[name]["parents"], (name, spans[name])
    assert spans["md.step"]["count"] == 1
    assert spans["md.integrate"]["count"] == 2
    assert spans["bonded"]["count"] == 2
    for name, s in spans.items():
        assert 0 <= s["self_ms"] <= s["total_ms"], (name, s)
    assert spans["md.step"]["self_ms"] < spans["md.step"]["total_ms"]
    assert profiling._OPEN == []


def test_the_step_syncs_only_at_the_scf_residuals(runs):
    """The force call's constants stay on the device (utils/devconst): the
    fixed step counts no host sync, the polarizable step only its SCF's
    residual reads, one a PCG iteration and one more."""
    kind, _, (_, _, _, snap) = runs
    syncs = {k: v for k, v in snap["counters"].items()
             if k.startswith("host.syncs.")}
    if kind == "fixed":
        assert syncs == {}
    else:
        assert syncs == {"host.syncs.scf.residual":
                         snap["spans"]["scf.iter"]["count"] + 1}


def test_the_tiled_spread_counts_no_sync():
    """``spread_route(..., 'cuda2d')`` on CPU tensors runs K5/K7's plain
    versions through ``tile_bins``, forward and backward, traced: no
    ``host.syncs.*`` counter."""
    from admp_tpu_torch.ops.cuda import spread as S

    g = torch.Generator().manual_seed(3)
    grid = (16, 12, 40)
    m_u0 = torch.randint(-4, 44, (200, 3), generator=g, dtype=torch.int32)
    q = torch.randn(200, 1, 216, generator=g,
                    dtype=torch.float64).requires_grad_(True)
    profiling.reset()
    with _profile():
        mesh = S.spread_route(m_u0, q, grid, 6, "cuda2d")
        (g_q,) = torch.autograd.grad((mesh * mesh).sum(), q)
    snap = profiling.snapshot()
    profiling.reset()
    assert mesh.shape == (1, *grid) and g_q.shape == q.shape
    assert not [k for k in snap["counters"] if k.startswith("host.syncs.")]


def test_leaf_ranges_are_top_level(runs):
    _, _, (_, _, prof, snap) = runs
    events = prof.events()
    ranges = [e for e in events if e.name.startswith("admp::")]
    leaves = {n for n in snap["spans"]
              if n not in ("md.step", "pme.energy", "scf.solve", "scf.iter")}
    assert {e.name[6:] for e in ranges} == leaves
    # a host sync may wait inside a layer's range
    for e in ranges:
        assert e.cpu_parent is None or (
            e.name == "admp::host.sync"
            and e.cpu_parent.name.startswith("admp::")), e.name
    nodes = [e for e in events
             if e.name.startswith("autograd::engine::evaluate_function")]
    for r in ranges:
        if not r.name.endswith(".bwd"):
            continue
        inside = [e for e in nodes if e.thread == r.thread
                  and r.time_range.start <= e.time_range.start
                  and e.time_range.end <= r.time_range.end]
        assert inside, r.name
        for e in inside:
            while e.cpu_parent is not None and e.cpu_parent is not r:
                e = e.cpu_parent
            assert e.cpu_parent is r, r.name


def test_registry_stamps_lie_within_profiler_events(runs):
    _, _, (_, _, prof, snap) = runs
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith("admp::"):
            events.setdefault(e.name[6:], []).append(
                (t0 + round(e.time_range.start * 1e3),
                 t0 + round(e.time_range.end * 1e3)))
    for name, ev in events.items():
        start, end = snap["spans"][name]["last_ns"]
        assert any(a <= start <= end <= b for a, b in ev), name


def test_nodes_without_sequence_numbers(monkeypatch):
    """Where a custom Function's autograd node gives no sequence number (some
    torch versions), it counts as the layer's own: the backward spans still
    pair up and the numbers stay bit for bit."""
    real = profiling._sequence_nr
    custom = torch.autograd.function.BackwardCFunction
    monkeypatch.setattr(profiling, "_sequence_nr", lambda node: (
        None if isinstance(node, custom) else real(node)))
    w = _Water(True)
    off, on = w.langevin_step(False), w.langevin_step(True)
    assert torch.equal(off[0].forces, on[0].forces)
    assert torch.equal(off[1], on[1])
    for name in LAYERS + ("shortrange", "bonded"):
        assert on[3]["spans"][name + ".bwd"]["count"] >= 1, name
    assert profiling._OPEN == []
    profiling.reset()


@pytest.mark.parametrize("exact", [False, True],
                         ids=["feynman_hellmann", "exact_adjoint"])
def test_scf_solve_encloses_the_forward_iterations(exact):
    """One polarizable force call traced: ``scf.solve`` once, under the
    energy call, around the warm-start field and every iteration of the
    forward PCG. Under the exact adjoint the adjoint's iterations run in the
    backward, after the solve has closed, and are the only ones outside
    it."""
    w = _Water(True)
    w.pme.scf_config = SCFConfig(exact_adjoint=exact, field_tol=1e-3)
    w.pme.refresh_calculators()
    profiling.reset()
    with _profile():
        w.force_fn(w.positions, None)
    spans = profiling.snapshot()["spans"]
    profiling.reset()
    assert spans["scf.solve"]["count"] == 1
    assert spans["scf.solve"]["parents"] == {"pme.energy": 1}
    n_fwd = w.pme.n_cycle
    assert n_fwd >= 1
    parents = dict(spans["scf.iter"]["parents"])
    assert parents.pop("scf.solve") == n_fwd
    n_adjoint = sum(parents.values())
    assert (n_adjoint >= 1) if exact else (n_adjoint == 0)
    assert spans["scf.solve"]["total_ms"] <= spans["pme.energy"]["total_ms"]
    assert profiling._OPEN == []


def _force_matching(traced):
    """One fitting step of a force-matching loss on the polarizable exact
    adjoint with its adjoint unrolled: the third derivative."""
    s = water_arrays(n_side=3, seed=8)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64))  # noqa: E731
    force = ADMPPmeForce(
        s["box"], s["axis_types"], s["axis_indices"], s["covalent_map"],
        4.0, 1e-4, 2, lpol=True,
        config=EngineConfig(scf=SCFConfig(adjoint_fixed_iters=3)),
        device="cpu", dtype=torch.float64)
    box = t(s["box"])
    pairs = neighbor_list_dense(t(s["positions"]), box, 4.0).pairs
    sc = t(SCALES)

    def potential(positions, box_, pairs_, params):
        return force.get_energy(positions, box_, pairs_, params["q"],
                                t(s["pol"]), t(s["tholes"]), sc, sc, sc)

    pos = t(s["positions"])
    batch = [(pos, box, pairs, torch.tensor(0.0, dtype=torch.float64),
              0.9 * pos.sin())]
    params = {"q": convert_cart2harm(t(s["q_cart"]), 2)}
    loss = energy_force_loss(potential, energy_weight=0.0)
    profiling.reset()
    if traced:
        with _profile():
            res = fit(loss, params, [batch], log_every=0)
    else:
        res = fit(loss, params, [batch], log_every=0)
    return res, profiling.snapshot()


def test_exact_adjoint_force_matching_is_the_same_traced():
    res_off, snap_off = _force_matching(False)
    res_on, snap_on = _force_matching(True)
    assert snap_off == {"spans": {}, "counters": {}}
    assert torch.equal(res_off.params["q"], res_on.params["q"])
    assert res_off.history[0]["loss"] == res_on.history[0]["loss"]
    spans = snap_on["spans"]
    assert spans["fit.step"]["count"] == 1
    assert snap_on["counters"]["host.syncs.fit.loss"] == 1
    assert "fit.step" in spans["pme.energy"]["parents"]
    # the loss's backward times each layer's backward once per pass and
    # leaves no span open, whatever the derivative's order
    for name in LAYERS:
        assert spans[name + ".bwd"]["count"] >= 1
    assert profiling._OPEN == []


def test_refresh_records_its_span_and_syncs():
    s = water_arrays(n_side=4, seed=2)
    pos = torch.as_tensor(s["positions"])
    box = torch.as_tensor(s["box"])
    nl = neighbor_list_cell(pos, box, 4.0)
    profiling.reset()
    with _profile():
        refresh_neighbor_list(nl, pos + 0.01, box)
    snap = profiling.snapshot()
    assert snap["spans"]["nl.refresh"]["count"] == 1
    assert snap["spans"]["host.sync"]["parents"] == {"nl.refresh": 3}
    assert snap["counters"] == {"host.syncs.nl.cell_grid": 1,
                                "host.syncs.nl.stencil": 1,
                                "host.syncs.nl.overflow": 1}
    # a box that moves the cell grid allocates the list anew
    profiling.reset()
    with _profile():
        refresh_neighbor_list(nl, pos * 1.4, box * 1.4)
    assert profiling.snapshot()["counters"]["nl.rebuilds"] == 1
    profiling.reset()


def test_trace_writes_the_trace_and_the_spans(tmp_path):
    step, state, gen = _Water(False).start()
    with profiling.trace(str(tmp_path / "tr")):
        step(step(state, gen), gen)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert spans["spans"]["md.step"]["count"] == 2
    assert spans["spans"]["frames.bwd"]["parents"] == {"pme.energy": 2}
    assert set(spans) == {"spans", "counters"}
    profiling.reset()


def test_counters_and_spans_are_off_without_a_profiler():
    profiling.reset()
    profiling.count("x")
    with profiling.span("y"):
        pass
    assert profiling.host_sync("z", float, torch.tensor(2.0)) == 2.0
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    with _profile():
        profiling.count("x", 3)
        with profiling.span("y", composite=True):
            pass
    snap = profiling.snapshot()
    assert snap["counters"] == {"x": 3}
    assert snap["spans"]["y"]["count"] == 1
    profiling.reset()


@pytest.mark.cuda
def test_kernels_step_traced_and_without_stray_syncs():
    """On the card: the kernels' fixed-multipole step traced as untraced
    (within the spread of the card's atomic sums, whose order is not
    fixed), the spans' ranges on the host's timeline only, and under
    torch.cuda.set_sync_debug_mode('warn') no synchronizing call in an
    untraced fixed-multipole step (on K4/K6 and on the tiled K5/K7), and
    in a traced polarizable step none but the SCF's residual reads (one a
    PCG iteration and one more), each inside its counted ``host.sync``
    span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    w = _Water(False, device=dev, dtype=torch.float32, n_side=10)
    off, on = w.langevin_step(False), w.langevin_step(True)
    gap = (on[0].forces - off[0].forces).norm() / off[0].forces.norm()
    assert float(gap) < 1e-4
    events = on[2].events()
    assert any("pair_fwd_kernel" in e.name for e in events)
    assert not [e.name for e in events if e.name.startswith("admp::")
                and e.device_type == torch.autograd.DeviceType.CUDA]
    syncs, stray = [], []

    def record(message, *args, **kwargs):
        if "called a synchronizing" in str(message):
            syncs.append(str(message))
            if not any(o.name == "host.sync" for o in profiling._OPEN):
                stray.append(str(message))

    def run(step, state, gen, traced):
        with warnings.catch_warnings(), (_profile() if traced
                                         else contextlib.nullcontext()):
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(state, gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()

    # the tiled K5/K7 too (tile_bins), which the 98k meshes take
    tiled = _Water(False, device=dev, dtype=torch.float32, n_side=10,
                   spread_method="cuda2d")
    for fixed in (w, tiled):
        run(*fixed.start(), traced=False)
    assert syncs == []
    pol = _Water(True, device=dev, dtype=torch.float32, n_side=10)
    step, state, gen = pol.start()
    profiling.reset()
    run(step, state, gen, traced=True)
    snap = profiling.snapshot()
    profiling.reset()
    assert {k: v for k, v in snap["counters"].items()
            if k.startswith("host.syncs.")} == {
                "host.syncs.scf.residual": pol.pme.n_cycle + 1}
    assert syncs and stray == []


@pytest.mark.cuda
def test_frames_kernel_step_keeps_its_spans():
    """On the card: the fixed-multipole Langevin step with the frames on K8
    (ops/cuda/frames.py) records the spans ``frames`` and ``frames.bwd``
    once each, with their parent, and the counter ``frames.kernel`` reads
    2: K8's forward and backward, the launches the profile shows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = _Water(False, device=torch.device("cuda", 0), dtype=torch.float32,
               n_side=10)
    _, _, prof, snap = w.langevin_step(True)
    profiling.reset()
    spans = snap["spans"]
    for name in ("frames", "frames.bwd"):
        assert spans[name]["count"] == 1, (name, spans[name])
        assert spans[name]["parents"] == {"pme.energy": 1}, name
    assert snap["counters"]["frames.kernel"] == 2
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("frames_fwd_kernel" in n for n in names) == 1
    assert sum("frames_bwd_kernel" in n for n in names) == 1
    assert profiling._OPEN == []


@pytest.mark.cuda
@pytest.mark.parametrize("lpol", [False, True])
def test_pair_kernels_read_the_table_through_the_list(lpol):
    """On the card: every real-space pass of a Langevin step takes the
    indexed K1/K2 (``pairs.indexed``: one K1 and one K2 launch a pass) and
    none falls back to the gathered layout (``pairs.gathered`` 0). The fixed
    step has one pass; the polarizable step (the warm-start field, one
    matvec a PCG iteration, the final energy) 2 'pol' passes and one 'uu'
    pass an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from admp_tpu_torch.ops.cuda import pairs as P

    w = _Water(lpol, device=torch.device("cuda", 0), dtype=torch.float32,
               n_side=10)
    step, state, gen = w.start()
    fwd, bwd = dict(P.launch_pair_fwd.by_kind), dict(P.launch_pair_bwd.by_kind)
    profiling.reset()
    with _profile():
        step(state, gen)
    snap = profiling.snapshot()
    profiling.reset()
    launched = {k: (P.launch_pair_fwd.by_kind[k] - fwd[k],
                    P.launch_pair_bwd.by_kind[k] - bwd[k]) for k in P.KINDS}
    counters = snap["counters"]
    assert counters.get("pairs.gathered", 0) == 0
    if lpol:
        iters = w.pme.n_cycle
        assert iters >= 1
        assert launched == {"perm": (0, 0), "pol": (2, 2),
                            "uu": (iters, iters)}
        assert counters["pairs.indexed"] == 2 * (2 + iters)
    else:
        assert launched == {"perm": (1, 1), "pol": (0, 0), "uu": (0, 0)}
        assert counters["pairs.indexed"] == 2
