"""The work of the polarizable step's energy-mesh passes (counts/scf_mesh.py)
against hand counts, at a tiny shape and at polfull98k.md's; its reader
(scfmesh.roofline_pct.md) only where the matvec runs on the energy mesh; and
the SCF's span metric (scf.host_ms.md) in a traced run of polfull98k.md on
the tiny CPU bench."""

from __future__ import annotations

import math

import pytest
from tiny import run_tiny

from benchmark.counts import peaks, scf_mesh
from benchmark.harness import core

HBM = peaks.HBM_BYTES_S


def test_passes_by_hand_at_a_tiny_shape():
    # 2 atoms, a 4^3 mesh (64 points, fewer than 2 x 6^3 stencil points)
    assert scf_mesh.dipole_pass_work(2, 6, (4, 4, 4)) == [
        (2 * 6 * 4 + 64 * 4, 2 * 216), (64 * 4 + 2 * 3 * 4 + 2 * 3 * 4,
                                        2 * 2 * 216)]
    # lmax 1: four harmonics
    assert scf_mesh.full_pass_work(2, 1, 6, (4, 4, 4)) == [
        (2 * 7 * 4 + 64 * 4, 2 * 216), (64 * 4 + 2 * 3 * 4 + 2 * 7 * 4,
                                        2 * 2 * 216)]
    shapes = dict(n_atoms=2, lmax=1, grid=(4, 4, 4))
    want = (2 * (312 + 336) + 2.5 * (304 + 304)) / HBM
    assert scf_mesh.step_bound_s(shapes, 2.5) == pytest.approx(want)


def test_passes_by_hand_at_the_cell_shape():
    n, grid = 98304, (320, 320, 320)
    mesh, touched = 320 ** 3 * 4, 98304 * 216 * 4  # bytes
    full = (n * 12 * 4 + mesh) + (touched + n * 3 * 4 + n * 12 * 4)
    dipole = (n * 6 * 4 + mesh) + (touched + n * 3 * 4 + n * 3 * 4)
    assert (full, dipole) == (226_623_488, 220_725_248)
    shapes = dict(n_atoms=n, lmax=2, grid=grid)
    # bytes bound every pass: 21M stencil points are 0.3 us of operations
    assert scf_mesh.step_bound_s(shapes, 2.0) == pytest.approx(
        (2 * full + 2 * dipole) / HBM)
    assert scf_mesh.step_bound_s(shapes, 0.0) == pytest.approx(
        2 * full / HBM)


def _ctx(scf, iters=(2, 3)):
    trace = dict(steps=2, pcg_iters=list(iters),
                 by_fn={"spread_tiled_kernel": 2e-3,
                        "gather_tiled_kernel": 1e-3, "pair_fwd_kernel": 5.0})
    return dict(bench=core.BENCH, metric="scfmesh.roofline_pct.md",
                config=dict(model=dict(scf=scf) if scf else {}),
                trace=trace, shapes=dict(n_atoms=98304, lmax=2,
                                         grid=(320, 320, 320)))


FULL_MESH = dict(exact_adjoint=False, field_tol=0.3,
                 matvec_spread_order=None, matvec_grid_div=1)


def test_the_reader_takes_the_tiled_kernels_only():
    read = core.load_reader(core.BENCH, "scfmesh.roofline_pct.md").read
    work = scf_mesh.step_bound_s(_ctx(FULL_MESH)["shapes"], 2.5) * 2
    assert read(_ctx(FULL_MESH)) == pytest.approx(100.0 * work / 3e-3)
    assert read(dict(_ctx(FULL_MESH), trace=None)) is None
    assert read(_ctx(FULL_MESH, iters=())) is None


@pytest.mark.parametrize("scf", [
    None, dict(FULL_MESH, matvec_spread_order=4),
    dict(FULL_MESH, matvec_grid_div=2), dict(FULL_MESH, exact_adjoint=True)])
def test_the_reader_reads_none_off_the_energy_mesh(scf):
    read = core.load_reader(core.BENCH, "scfmesh.roofline_pct.md").read
    assert read(_ctx(scf)) is None


def test_a_traced_run_reports_the_scf_metrics(tiny_bench):
    from admp_tpu_torch.utils import profiling

    profiling.reset()
    res = run_tiny(tiny_bench, "polfull98k.md", trace=1)
    profiling.reset()
    m = res["metrics"]
    assert math.isfinite(m["scf.host_ms.md"]["value"])
    assert m["scf.host_ms.md"]["value"] > 0
    assert m["scf.pcg_iters.md"]["value"] >= 0
    # on the CPU no device kernel runs: the roofline finds nothing to read
    assert "scfmesh.roofline_pct.md" not in m
    assert res["correct"]


def test_without_the_span_the_reader_reads_none(monkeypatch):
    from admp_tpu_torch.utils import profiling

    read = core.load_reader(core.BENCH, "scf.host_ms.md").read
    ctx = dict(trace=dict(steps=20), window=dict(steps=30))
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: dict(spans={}, counters={}))
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(ctx) is None
