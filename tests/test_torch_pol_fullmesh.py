"""The polarizable 98k-atom cell's configuration
(benchmark/configs/water-pol-98k-fullmesh.json: MPID water, Thole, the SCF's
matvec on the energy's own order-6 mesh) built at 192 atoms by
benchmark/systems/water_scf.py, with multipoles, polarizabilities and Thole
widths perturbed by up to 10% from a seed, against the benchmark's plain
float64 reference (benchmark/reference/water.py): in float64 with the SCF
converged far below the cell's tolerance, and in float32 at the cell's own
field tolerance. On the card: the 98,304-atom step's matvec spreads on the
tiled K5/K7 pair, not on ``index_add_``.

No JAX here: the file runs on the card's machine too
(``python -m pytest --noconftest -m cuda tests/test_torch_pol_fullmesh.py``).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.reference.water import WaterReference
from benchmark.systems import water_scf

CONFIG = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
          / "configs" / "water-pol-98k-fullmesh.json")
LIST_CUTOFF = 5.0  # rc + the langevin traffic's 1 A skin
DIELECTRIC = 1389.35455846
# float32 at the cell's field tolerance 0.3, forces: the float32 floor of
# this box (the same call at field tolerance 1e-3: 2.6e-4-3.9e-4 over seeds
# 11-14) plus the early stop's share (float64 at 0.3: 1.7e-4-2.1e-4);
# their sum is 6.0e-4 at worst
TOL_F32_FORCES = 1e-3


def _config(dtype, **scf):
    c = json.loads(CONFIG.read_text())
    c["lattice"]["n_side"] = 4  # 64 waters, a 12.4 A box, a 40^3 mesh
    c["dtype"] = dtype
    c["model"]["scf"].update(scf)
    return c


def _system(seed):
    """The configuration's arrays at ``seed``, every water's charges (kept
    neutral), O dipole and quadrupole (kept traceless), polarizability and
    Thole width scaled by factors drawn in [0.9, 1.1]."""
    s = water_scf.make_system(_config("float64"), seed, 300.0)
    rng = np.random.default_rng(seed)
    n = s["positions"].shape[0]
    nmol = n // 3

    def scale(size):
        return 1.0 + 0.1 * rng.uniform(-1.0, 1.0, size)

    q = s["q_cart"].copy()
    q[1::3, 0] *= scale(nmol)
    q[2::3, 0] *= scale(nmol)
    q[0::3, 0] = -(q[1::3, 0] + q[2::3, 0])
    for k in (3, 4, 5):
        q[0::3, k] *= scale(nmol)
    q[0::3, 6] = -(q[0::3, 4] + q[0::3, 5])
    return dict(s, q_cart=q, pol=s["pol"] * scale(n),
                tholes=s["tholes"] * scale(n))


def _rel(a, b):
    return float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))


def _program_and_reference(seed, dtype, **scf):
    s = _system(seed)
    c = _config(dtype, **scf)
    prog = water_scf.WaterProgram(s, c, LIST_CUTOFF, "cpu")
    e, f, _ = prog.force_fn(prog.positions, None)
    ref = WaterReference(s, c["model"], "cpu")
    e_r, f_r, u_r = ref.evaluate(torch.as_tensor(s["positions"]),
                                 LIST_CUTOFF)
    return s, prog, (e, f, prog.dipoles()), (e_r, f_r, u_r)


def test_the_matvec_runs_on_the_energy_mesh():
    prog = water_scf.WaterProgram(_system(11), _config("float64"),
                                  LIST_CUTOFF, "cpu")
    pme = prog.pme
    assert pme.scf_config.matvec_spread_order is None
    assert not pme.scf_config.exact_adjoint
    assert pme.scf_config.field_tol == 0.3
    assert pme.matvec_grid == (pme.K1, pme.K2, pme.K3)


@pytest.mark.parametrize("seed", [11, 12])
def test_float64_matches_the_reference(seed):
    _, prog, (e, f, u), (e_r, f_r, u_r) = _program_and_reference(
        seed, "float64", field_tol=1e-9, max_iter=500)
    assert prog.pme.lconverg
    assert abs(float(e) - float(e_r)) < 1e-8 * abs(float(e_r))
    assert _rel(f, f_r) < 1e-8
    assert _rel(u, u_r) < 1e-8


@pytest.mark.parametrize("seed", [11, 12])
def test_float32_at_the_cell_tolerance(seed):
    s, prog, (_, f, u), (_, f_r, u_r) = _program_and_reference(seed,
                                                               "float32")
    assert prog.pme.lconverg and prog.pme.n_cycle >= 1
    assert _rel(f, f_r) < TOL_F32_FORCES
    # dipoles: every component's field residual under the tolerance, times
    # the inverse of the operator's diagonal (pol / DIELECTRIC), over the
    # reference's norm (6.1e-3-6.7e-3 at seeds 11-14, where the program
    # reads 1.7e-3-1.9e-3)
    bound = (np.sqrt(3.0 * np.sum((s["pol"] * 0.3 / DIELECTRIC) ** 2))
             / float(torch.linalg.norm(u_r)))
    assert _rel(u, u_r) < bound


@pytest.mark.cuda
def test_98k_matvec_spreads_on_the_tiled_pair(monkeypatch):
    """One force call of the cell at its size: every spread, the two
    full-multipole passes and one per PCG iteration, on the 320^3 mesh by
    K5 (route 'cuda2d'), and 'auto' resolves the matvec's mesh to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from admp_tpu_torch.ops import reciprocal
    from admp_tpu_torch.ops.cuda import spread as spread_ops

    c = json.loads(CONFIG.read_text())
    s = water_scf.make_system(c, 1, 300.0)
    prog = water_scf.WaterProgram(s, c, c["model"]["rc_A"] + 1.0, "cuda")
    pme = prog.pme
    assert pme.matvec_grid == (pme.K1, pme.K2, pme.K3) == (320, 320, 320)
    probe = torch.empty(0, device="cuda", dtype=torch.float32)
    assert reciprocal.resolve_spread_method(
        "auto", probe, 6, pme.matvec_grid) == "cuda2d"
    routes = []
    real = spread_ops.spread_route

    def record(m_u0, q_points, grid_shape, order, route):
        routes.append((tuple(grid_shape), order, route))
        return real(m_u0, q_points, grid_shape, order, route)

    monkeypatch.setattr(spread_ops, "spread_route", record)
    _, f, _ = prog.force_fn(prog.positions, None)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(f).all())
    assert pme.n_cycle >= 1
    assert routes == [((320, 320, 320), 6, "cuda2d")] * (2 + pme.n_cycle)
