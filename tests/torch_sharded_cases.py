"""Rank-side cases of the sharded layer's tests (tests/test_torch_comm.py,
tests/test_torch_sharded_*.py).

Each function runs on every rank of a gloo process group on the CPU
(admp_tpu_torch/parallel/launch.py), takes numpy inputs made by the test
module from a seed, and returns numpy results, which the test module holds
against admp_tpu. This module imports no JAX, so the ranks start without it.
"""

import numpy as np
import torch

from admp_tpu_torch.utils import comm

F64 = torch.float64


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _np(x):
    return x.detach().numpy()


def _energy_forces(fn, positions, *args):
    pos = positions.clone().requires_grad_(True)
    e = fn(pos, *args)
    (g,) = torch.autograd.grad(e, pos)
    return float(e.detach()), _np(g)


# ---------------------------------------------------------------------------
# utils/comm.py
# ---------------------------------------------------------------------------


def comm_cases(rank, world_size, inp):
    """Every collective forward and backward, a second derivative through
    psum/pvary, and the tally of each; the rfft pencil's and the halo
    spread's collective bytes on admp_tpu's pinned inputs."""
    from admp_tpu_torch.parallel.fft import rfft3d_pencil
    from admp_tpu_torch.parallel.spread import sharded_spread_halo

    out = {}
    x = (torch.arange(8, dtype=F64).reshape(2, 4) + 10 * rank)
    c = _t(inp["c"])  # (2, 4), replicated
    # psum: the sum; its backward hands the replicated cotangent over
    xr = x.clone().requires_grad_(True)
    y = comm.psum(xr)
    (out["psum_grad"],) = map(_np, torch.autograd.grad((y * c).sum(), xr))
    out["psum"] = _np(y)
    # pvary: its backward sums the ranks' cotangents
    a = c.clone().requires_grad_(True)
    (b,) = comm.pvary(None, a)
    loss = comm.psum((b * (rank + 1)).sum())
    (out["pvary_grad"],) = map(_np, torch.autograd.grad(loss, a))
    # a second derivative through both: f(a) = sum_r (r+1) |a|^2
    a = c.clone().requires_grad_(True)
    (b,) = comm.pvary(None, a)
    f = comm.psum((b * b * (rank + 1)).sum())
    (g,) = torch.autograd.grad(f, a, create_graph=True)
    (out["second"],) = map(_np, torch.autograd.grad((g * c).sum(), a))
    out["first"] = _np(g)
    # all_to_all, split 1 -> concat 0, and its backward
    xa = _t(inp["a2a_x"][rank]).requires_grad_(True)  # (4, 8, 3)
    ya = comm.all_to_all(xa, 1, 0)
    wa = _t(inp["a2a_w"][rank])
    (out["a2a_grad"],) = map(_np, torch.autograd.grad((ya * wa).sum(), xa))
    out["a2a"] = _np(ya)
    # complex tensors travel as their real views, there and back
    z = torch.complex(_t(inp["a2a_x"][rank]), -_t(inp["a2a_x"][rank]))
    out["a2a_complex_roundtrip"] = bool(torch.equal(
        comm.all_to_all(comm.all_to_all(z, 0, 2), 2, 0), z))
    # ppermute on the ring and its backward (the inverse shift)
    xp = x.clone().requires_grad_(True)
    yp = comm.ppermute(xp, 1)
    wp = _t(inp["ppermute_w"][rank])
    (out["ppermute_grad"],) = map(_np, torch.autograd.grad((yp * wp).sum(),
                                                           xp))
    out["ppermute"] = _np(yp)
    # all_gather: replicated; its backward takes this rank's block
    xg = x.clone().requires_grad_(True)
    yg = comm.all_gather(xg)
    (out["all_gather_grad"],) = map(_np, torch.autograd.grad(
        (yg * _t(inp["gather_c"])).sum(), xg))
    out["all_gather"] = _np(yg)
    # the tally: bytes entering each collective, loop iterations apart
    tally = comm.CommTally()
    with tally.recording():
        comm.psum(x)
        comm.all_to_all(_t(inp["a2a_x"][rank]), 1, 0)
        comm.ppermute(x, 1)
        comm.all_gather(x)
        for _ in range(3):
            with comm.loop_iteration():
                comm.psum(x)
                comm.psum(x[0])
    out["tally"] = tally.report()
    # admp_tpu's pinned bytes (tests/test_sharding.py:743-792) at P ranks
    k = int(inp["k"])
    width = k // world_size
    slab = _t(inp["fft_x"])[rank * width:(rank + 1) * width]
    tally = comm.CommTally()
    with tally.recording():
        rfft3d_pencil(slab)
    out["fft_tally"] = tally.report()
    tally = comm.CommTally()
    with tally.recording():
        sharded_spread_halo(_t(inp["pos"]), _t(inp["box"]), _t(inp["q9"]),
                            (k, k, k), 2)
    out["spread_tally"] = tally.report()
    return out


# ---------------------------------------------------------------------------
# parallel/fft.py, parallel/spread.py, sharded_cell_pairs
# ---------------------------------------------------------------------------


def fft_spread_cases(rank, world_size, inp):
    """This rank's pencil FFT blocks, halo-spread slabs and gradients,
    multi-channel slabs, the overflow case and its sharded_cell_pairs
    block."""
    from admp_tpu_torch.ops.neighborlist import sharded_cell_pairs
    from admp_tpu_torch.parallel.fft import fft3d_pencil, rfft3d_pencil
    from admp_tpu_torch.parallel.spread import (
        sharded_spread_halo,
        sharded_spread_halo_multi,
    )

    out = {}
    x = _t(inp["fft_x"])
    k1 = x.shape[0]
    block = x[rank * k1 // world_size:(rank + 1) * k1 // world_size]
    out["fft3d"] = _np(fft3d_pencil(block))
    out["rfft3d"] = _np(rfft3d_pencil(block))

    grid = tuple(int(k) for k in inp["grid"])
    pos, box, q9 = _t(inp["pos"]), _t(inp["box"]), _t(inp["q9"])
    slab, overflow = sharded_spread_halo(pos, box, q9, grid, 2)
    out["slab"], out["overflow"] = _np(slab), bool(overflow)
    p, q = pos.clone().requires_grad_(True), q9.clone().requires_grad_(True)
    # replicated inputs enter this rank's work through pvary, as in the
    # sharded energies: the backward then sums the ranks' cotangents
    slab, _ = sharded_spread_halo(*comm.pvary(None, p, box, q), grid, 2)
    loss = comm.psum((slab * slab).sum())
    out["slab_grad_pos"], out["slab_grad_q"] = map(
        _np, torch.autograd.grad(loss, (p, q)))
    c3 = _t(inp["c3"])
    for order in (6, 4):
        slabs, flag = sharded_spread_halo_multi(pos, box, c3, grid,
                                                order=order)
        out[f"multi{order}"], out[f"multi{order}_overflow"] = (_np(slabs),
                                                               bool(flag))
    # atoms in lattice (x-major) order crowd a block into few slabs: a bin
    # over its capacity poisons the slab and raises the flag everywhere
    slab, flag = sharded_spread_halo(_t(inp["lattice_pos"]),
                                     _t(inp["lattice_box"]),
                                     _t(inp["lattice_q"]), grid, 2,
                                     cap_factor=float(inp["tight_cap"]))
    out["tight_slab"], out["tight_overflow"] = _np(slab), bool(flag)

    cp = inp["cell_pairs"]
    pairs, flag = sharded_cell_pairs(
        _t(cp["positions"]), _t(cp["box"]), float(cp["cutoff"]),
        tuple(int(n) for n in cp["n_cells"]), int(cp["cell_capacity"]),
        int(cp["capacity"]))
    out["cell_pairs"], out["cell_pairs_overflow"] = pairs.numpy(), bool(flag)
    return out


# ---------------------------------------------------------------------------
# parallel/sharded.py
# ---------------------------------------------------------------------------


def _water(inp, dtype=F64):
    """The box's tensors in ``dtype``; ``"f32-in-f64"``: their float32
    values held in float64 (the float64 reference of a float32 run)."""
    def t(x):
        if dtype == "f32-in-f64":
            return _t(x, torch.float32).to(F64)
        return _t(x, dtype)

    s = inp["sys"]
    return dict(positions=t(s["positions"]), box=t(s["box"]),
                q_local=t(inp["q_local"]), pairs=torch.as_tensor(
                    inp["pairs"]).long(), scales=t(inp["m_scales"]),
                pol=t(s["pol"]), tholes=t(s["tholes"]),
                c_list=t(s["c_list"]), tt=[t(s[k]) for k in
                                           ("tt_a", "tt_b", "tt_q")])


def _topo(inp, covalent_map=None):
    s = inp["sys"]
    return dict(axis_types=s["axis_types"], axis_indices=s["axis_indices"],
                covalent_map=(s["covalent_map"] if covalent_map is None
                              else covalent_map), device="cpu")


def energy_cases(rank, world_size, inp):
    """Energies and forces of the fixed-multipole factories (dense and
    sparse exclusions, cached influence), the dispersion, pairwise and full
    force field factories, and the batch energy on a 2 x 2 mesh."""
    from admp_tpu_torch import EngineConfig
    from admp_tpu_torch.ops.exclusions import SparseExclusions
    from admp_tpu_torch.ops.shortrange import tt_damping_qq_c6_kernel
    from admp_tpu_torch.parallel import (
        make_sharded_batch_energy,
        make_sharded_disp_energy,
        make_sharded_ff_energy,
        make_sharded_pairwise_energy,
        make_sharded_pme_energy,
    )
    from admp_tpu_torch.parallel.launch import mesh_groups

    w = _water(inp)
    grid, kappa = tuple(inp["grid"]), float(inp["kappa"])
    disp_kappa = float(inp["disp_kappa"])
    out = {}
    pme_args = (w["box"], w["pairs"], w["q_local"], w["scales"])
    pme = make_sharded_pme_energy(grid_shape=grid, kappa=kappa, lmax=2,
                                  **_topo(inp))
    out["pme"] = _energy_forces(pme, w["positions"], *pme_args)
    sparse = SparseExclusions(*(inp["sparse"][k] for k in ("idx", "dist")),
                              inp["sparse"]["n_atoms"])
    pme_sparse = make_sharded_pme_energy(grid_shape=grid, kappa=kappa, lmax=2,
                                         **_topo(inp, sparse))
    out["pme_sparse"] = _energy_forces(pme_sparse, w["positions"], *pme_args)
    pme_cached = make_sharded_pme_energy(
        grid_shape=grid, kappa=kappa, lmax=2,
        config=EngineConfig(cache_influence=True), static_box=w["box"],
        **_topo(inp))
    with torch.no_grad():
        out["pme_cached"] = float(pme_cached(w["positions"], *pme_args))

    disp_args = (w["box"], w["pairs"], w["c_list"], w["scales"])
    for order in (6, 4):
        disp = make_sharded_disp_energy(
            grid_shape=grid, kappa=disp_kappa, pmax=10, spread_order=order,
            covalent_map=inp["sys"]["covalent_map"], device="cpu")
        out[f"disp{order}"] = _energy_forces(disp, w["positions"], *disp_args)
    tt = make_sharded_pairwise_energy(None, tt_damping_qq_c6_kernel,
                                      inp["sys"]["covalent_map"],
                                      device="cpu")
    out["tt"] = _energy_forces(tt, w["positions"], w["box"], w["pairs"],
                               w["scales"], *w["tt"], w["c_list"][:, 0])
    ff = make_sharded_ff_energy(grid_shape=grid, kappa=kappa, lmax=2,
                                disp_grid_shape=grid, disp_kappa=disp_kappa,
                                pmax=10, **_topo(inp))
    out["ff"] = _energy_forces(ff, w["positions"], w["box"], w["pairs"],
                               w["q_local"], w["scales"], w["c_list"],
                               *w["tt"])

    data_group, model_group = mesh_groups(2, world_size // 2)
    energy_b = make_sharded_batch_energy(data_group, model_group,
                                         grid_shape=grid, kappa=kappa,
                                         lmax=2, **_topo(inp))
    batch = torch.stack([w["positions"], w["positions"] + 0.01])
    q = w["q_local"].clone().requires_grad_(True)
    e_b = energy_b(batch, w["box"], w["pairs"].expand(2, *w["pairs"].shape),
                   q, w["scales"])
    (g_q,) = torch.autograd.grad((e_b * _t([1.0, -0.5])).sum(), q)
    out["batch"] = (_np(e_b), _np(g_q))
    out.update(keyword_cases(inp, grid, kappa, disp_kappa))
    return out


# EngineConfig keywords of the sharded factories (tests/test_torch_sharded_
# energy.py's docstring), each away from its default (compensated sums are
# on by default): at float64 and at float32, where they act; at float32 the
# default config runs too, the compensated contrast of 'uncompensated'
KEYWORDS = {"spread_f64": dict(spread_precision="f64"),
            "uncompensated": dict(compensated_sums=False)}
KEYWORDS32 = dict(default={}, **KEYWORDS)
# (label, dtype of _water, keywords): float64, float32, and the float64
# reference at the float32 inputs
KEYWORD_RUNS = (("64", F64, KEYWORDS), ("32", torch.float32, KEYWORDS32),
                ("64r", "f32-in-f64", {"default": {}}))


def _single_force(inp, grid, kappa, config, lpol=False, dtype=F64):
    """The port's single-device force of the box at ``grid`` and ``kappa``
    (rc 4, the sharded factories' terms)."""
    from admp_tpu_torch import ADMPPmeForce

    s = inp["sys"]
    force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                         s["covalent_map"], 4.0, 1e-3, 2, lpol=lpol,
                         config=config, device="cpu", dtype=dtype)
    force.kappa, (force.K1, force.K2, force.K3) = kappa, grid
    force.refresh_calculators()
    return force


def keyword_cases(inp, grid, kappa, disp_kappa):
    """make_sharded_pme_energy and make_sharded_ff_energy under each of the
    KEYWORD_RUNS, and the port's single-device fixed force under the same
    config: {"pme32_spread_f64": (energy, forces), ...}."""
    from admp_tpu_torch import EngineConfig
    from admp_tpu_torch.parallel import (
        make_sharded_ff_energy,
        make_sharded_pme_energy,
    )

    out = {}
    for label, dtype, keywords in KEYWORD_RUNS:
        w = _water(inp, dtype)
        pme_args = (w["box"], w["pairs"], w["q_local"], w["scales"])
        ff_args = pme_args + (w["c_list"], *w["tt"])
        for name, kw in keywords.items():
            cfg = EngineConfig(**kw)
            pme = make_sharded_pme_energy(grid_shape=grid, kappa=kappa,
                                          lmax=2, config=cfg, **_topo(inp))
            ff = make_sharded_ff_energy(
                grid_shape=grid, kappa=kappa, lmax=2, disp_grid_shape=grid,
                disp_kappa=disp_kappa, pmax=10, config=cfg, **_topo(inp))
            key = f"{label}_{name}"
            out["pme" + key] = _energy_forces(pme, w["positions"], *pme_args)
            out["ff" + key] = _energy_forces(ff, w["positions"], *ff_args)
            single = _single_force(inp, grid, kappa, cfg,
                                   dtype=w["box"].dtype)
            e, g = single.get_forces(w["positions"], *pme_args)
            out["single" + key] = (float(e), _np(g))
    return out


def pol_cases(rank, world_size, inp):
    """The polarizable factory (exact adjoint) and the polarizable full
    force field, energies, forces, induced dipoles and iterations; the
    Feynman-Hellmann and Jacobi solves and the cheap matvec against the
    port's own single-device and field-difference results."""
    from admp_tpu_torch import ADMPPmeForce, SCFConfig
    from admp_tpu_torch.parallel import (
        make_sharded_ff_energy,
        make_sharded_pol_energy,
    )
    from admp_tpu_torch.parallel.sharded import (
        _make_local_energy,
        _make_local_uu_energy,
        _own_block,
    )

    w = _water(inp)
    grid, kappa = tuple(inp["grid"]), float(inp["kappa"])
    n = w["positions"].shape[0]
    u0 = torch.zeros(n, 3, dtype=F64)
    scf = SCFConfig(max_iter=40, field_tol=1e-3)
    pol_args = (w["box"], w["pairs"], w["q_local"], w["pol"], w["tholes"],
                w["scales"], w["scales"], u0)
    out = {}

    def run(fn, *args):
        pos = w["positions"].clone().requires_grad_(True)
        e, (u, conv, n_iter) = fn(pos, *args)
        (g,) = torch.autograd.grad(e, pos)
        return dict(energy=float(e), forces=_np(g), u=_np(u),
                    converged=bool(conv), n_iter=int(n_iter))

    pol = make_sharded_pol_energy(grid_shape=grid, kappa=kappa, lmax=2,
                                  scf_config=scf, **_topo(inp))
    out["pol"] = run(pol, *pol_args)
    ff = make_sharded_ff_energy(grid_shape=grid, kappa=kappa, lmax=2,
                                disp_grid_shape=grid,
                                disp_kappa=float(inp["disp_kappa"]), pmax=10,
                                lpol=True, scf_config=scf, **_topo(inp))
    out["ff_pol"] = run(ff, w["box"], w["pairs"], w["q_local"], w["pol"],
                        w["tholes"], w["scales"], w["scales"], w["c_list"],
                        *w["tt"], u0)

    # Feynman-Hellmann and Jacobi solves against the single-device port
    single = ADMPPmeForce(w["box"], inp["sys"]["axis_types"],
                          inp["sys"]["axis_indices"],
                          inp["sys"]["covalent_map"], 4.0, 1e-3, 2,
                          lpol=True, device="cpu", dtype=F64)
    single.kappa, (single.K1, single.K2, single.K3) = kappa, grid
    for name, cfg in (("fh", SCFConfig(max_iter=40, field_tol=1e-3,
                                       exact_adjoint=False)),
                      ("jacobi", SCFConfig(method="jacobi", max_iter=6,
                                           field_tol=0.0))):
        fn = make_sharded_pol_energy(grid_shape=grid, kappa=kappa, lmax=2,
                                     scf_config=cfg, **_topo(inp))
        out[name] = run(fn, *pol_args)
        single.scf_config = cfg
        single.refresh_calculators()
        e, g = single.get_forces(w["positions"], w["box"], w["pairs"],
                                 w["q_local"], w["pol"], w["tholes"],
                                 w["scales"], w["scales"], w["scales"],
                                 U_init=u0)
        out[name + "_single"] = dict(energy=float(e), forces=_np(g),
                                     u=_np(single.U_ind),
                                     n_iter=int(single.n_cycle))

    # the cheap matvec equals field(v) - field(0) of the full energy
    local = _make_local_energy(None, grid, kappa, 2, lpol=True, **_topo(inp))
    local_uu = _make_local_uu_energy(None, grid, kappa,
                                     inp["sys"]["covalent_map"],
                                     device="cpu")
    pairs_local = _own_block(w["pairs"], None)
    v = _t(inp["v"])

    def field(u):
        u = u.clone().requires_grad_(True)
        e = local(w["positions"], w["box"], pairs_local, w["q_local"],
                  w["scales"], u, w["pol"], w["tholes"], w["scales"])
        return torch.autograd.grad(e, u)[0]

    v_req = v.clone().requires_grad_(True)
    e_uu = local_uu(w["positions"], w["box"], pairs_local, v_req, w["pol"],
                    w["tholes"], w["scales"])
    out["matvec"] = _np(torch.autograd.grad(e_uu, v_req)[0])
    out["field_diff"] = _np(field(v) - field(torch.zeros_like(v)))
    out.update(pol_keyword_cases(inp, grid, kappa))
    return out


def pol_keyword_cases(inp, grid, kappa):
    """make_sharded_pol_energy (exact adjoint, pol_cases' SCF) under each
    of the KEYWORD_RUNS, and the port's single-device polarizable force
    under the same config: {"pol32_spread_f64": {...}, "pol_single32_...":
    {...}}."""
    from admp_tpu_torch import EngineConfig, SCFConfig
    from admp_tpu_torch.parallel import make_sharded_pol_energy

    scf = SCFConfig(max_iter=40, field_tol=1e-3)
    out = {}
    for label, dtype, keywords in KEYWORD_RUNS:
        w = _water(inp, dtype)
        u0 = torch.zeros_like(w["positions"])
        args = (w["box"], w["pairs"], w["q_local"], w["pol"], w["tholes"],
                w["scales"], w["scales"])
        for name, kw in keywords.items():
            cfg = EngineConfig(scf=scf, **kw)
            fn = make_sharded_pol_energy(grid_shape=grid, kappa=kappa,
                                         lmax=2, scf_config=scf, config=cfg,
                                         **_topo(inp))
            pos = w["positions"].clone().requires_grad_(True)
            e, (u, conv, n_iter) = fn(pos, *args, u0)
            (g,) = torch.autograd.grad(e, pos)
            out[f"pol{label}_{name}"] = dict(
                energy=float(e), forces=_np(g), u=_np(u),
                converged=bool(conv), n_iter=int(n_iter))
            single = _single_force(inp, grid, kappa, cfg, lpol=True,
                                   dtype=w["box"].dtype)
            e, g = single.get_forces(w["positions"], *args, w["scales"],
                                     U_init=u0)
            out[f"pol_single{label}_{name}"] = dict(
                energy=float(e), forces=_np(g), u=_np(single.U_ind),
                n_iter=int(single.n_cycle))
    return out


def failing_rank(rank, world_size):
    """Rank 1 raises while the others wait for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    comm.psum(torch.ones(1))
    return rank
