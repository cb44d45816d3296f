"""Entry points of the port: the single-device energy+force step and the
multi-rank dry run (the counterparts of admp_tpu's __graft_entry__.py).

    entry(device='cuda') -> (step, example_args)
    dryrun_multichip(n, device='cuda')

``dryrun_multichip`` runs admp_tpu's dry-run body on ``n`` ranks: a fitting
step of a data x model sharded batch energy (2 x n/2) with
``torch.optim.Adam``, the sharded polarizable step, the sharded full force
field, and a 3000-atom liquid box on a cell list at K=32 with the halo bins
sized for any atom order (``halo_cap_factor = n``). Inside a process group
of ``n`` ranks it runs in place; otherwise it starts the ranks itself
(parallel/launch.py): over NCCL with one card per rank where there are
enough cards, else over gloo, every rank on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

M_SCALES = (0.0, 0.0, 0.0, 1.0, 1.0)
GRID = (16, 16, 16)


def _water_inputs(n_side, device, dtype, seed=0):
    """admp_tpu's dry-run system: a water box, every pair padded to a
    multiple of 128, harmonic multipoles (lmax 2)."""
    from admp_tpu_torch import convert_cart2harm, water_system

    sysd = water_system(n_side=n_side, spacing=3.1, jitter=0.12, seed=seed)
    n = sysd["positions"].shape[0]
    ii, jj = np.triu_indices(n, 1)
    cap = -(-len(ii) // 128) * 128
    pairs = np.full((cap, 2), n, dtype=np.int64)
    pairs[:len(ii), 0], pairs[:len(ii), 1] = ii, jj
    q_local = convert_cart2harm(
        torch.tensor(sysd["q_cart"], device=device, dtype=dtype), 2)
    return sysd, torch.from_numpy(pairs).to(device), q_local


def entry(device="cuda", dtype=torch.float32):
    """(step, example_args): the energy+force step of the flagship model,
    polarizable multipolar PME (PCG SCF, exact implicit-adjoint forces), on
    ``device``; ``step(positions) -> (energy, dE/dpositions)``."""
    from admp_tpu_torch import ADMPPmeForce, SCFConfig
    from admp_tpu_torch.ops.cuda import resolve_device

    device = resolve_device(device)
    sysd, pairs, q_local = _water_inputs(2, device, dtype)
    c = lambda x: torch.as_tensor(np.asarray(x), device=device,  # noqa: E731
                                  dtype=dtype)
    box = c(sysd["box"])
    force = ADMPPmeForce(box, sysd["axis_types"], sysd["axis_indices"],
                         sysd["covalent_map"], 3.0, 1e-3, lmax=2, lpol=True,
                         scf_config=SCFConfig(max_iter=20), device=device,
                         dtype=dtype)
    m_scales = c(M_SCALES)
    pol, tholes = c(sysd["pol"]), c(sysd["tholes"])
    u0 = torch.zeros(sysd["positions"].shape, device=device, dtype=dtype)

    def step(positions):
        return force.get_forces(positions, box, pairs, q_local, pol, tholes,
                                m_scales, m_scales, m_scales, U_init=u0)

    return step, (c(sysd["positions"]),)


def dryrun_multichip(n_devices: int, device="cuda", dtype=torch.float32):
    """admp_tpu's multi-device dry run on ``n_devices`` ranks (see the
    module docstring); returns rank 0's summary: the fit loss, the
    energies, and that every energy and force was finite."""
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        return _dryrun_body(n_devices, device, dtype)
    from admp_tpu_torch.parallel.launch import launch

    own_cards = (torch.device(device).type == "cuda"
                 and torch.cuda.device_count() >= n_devices)
    return launch(_dryrun_rank, n_devices, args=(device, dtype, own_cards),
                  backend="nccl" if own_cards else "gloo")[0]


def _dryrun_rank(rank, world_size, device, dtype, own_cards):
    if own_cards:
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    return _dryrun_body(world_size, device, dtype)


def _require_finite(what, *tensors):
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"dry run: {what} is not finite")


def _dryrun_body(n_devices, device, dtype):
    from admp_tpu_torch import EngineConfig, SCFConfig, neighbor_list_cell
    from admp_tpu_torch import convert_cart2harm, water_system
    from admp_tpu_torch.ops.cuda import resolve_device
    from admp_tpu_torch.parallel import (
        make_sharded_batch_energy,
        make_sharded_ff_energy,
        make_sharded_pol_energy,
    )
    from admp_tpu_torch.parallel.launch import mesh_groups

    device = resolve_device(device)
    c = lambda x: torch.as_tensor(np.asarray(x), device=device,  # noqa: E731
                                  dtype=dtype)
    data_size, model_size = (1, 1) if n_devices == 1 else (2, n_devices // 2)
    data_group, model_group = mesh_groups(data_size, model_size)
    sysd, pairs, q_local = _water_inputs(2, device, dtype)
    n = sysd["positions"].shape[0]
    box, m_scales = c(sysd["box"]), c(M_SCALES)
    topo = dict(axis_types=sysd["axis_types"],
                axis_indices=sysd["axis_indices"],
                covalent_map=sysd["covalent_map"], device=device)
    summary = {}

    # the fitting step: a data-parallel batch of configurations, each
    # model-sharded, gradients to Q_local, one Adam update
    energy_b = make_sharded_batch_energy(data_group, model_group,
                                         grid_shape=GRID, kappa=0.62, lmax=2,
                                         **topo)
    base = c(sysd["positions"])
    batch = torch.stack([base + 0.01 * b for b in range(2 * data_size)])
    pairs_b = pairs.expand(batch.shape[0], *pairs.shape)
    targets = torch.zeros(batch.shape[0], device=device, dtype=dtype)
    q = q_local.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=1e-3)
    opt.zero_grad()
    loss = torch.mean((energy_b(batch, box, pairs_b, q, m_scales)
                       - targets) ** 2)
    loss.backward()
    opt.step()
    _require_finite("the fit loss or the updated Q_local", loss, q)
    summary["fit_loss"] = float(loss.detach())

    # the polarizable step over all ranks as one model axis
    energy_aux = make_sharded_pol_energy(
        None, grid_shape=GRID, kappa=0.62, lmax=2,
        scf_config=SCFConfig(max_iter=20), **topo)
    pos = base.clone().requires_grad_(True)
    e_pol, (_u, conv, n_iter) = energy_aux(
        pos, box, pairs, q_local, c(sysd["pol"]), c(sysd["tholes"]),
        m_scales, m_scales, torch.zeros(n, 3, device=device, dtype=dtype))
    (f_pol,) = torch.autograd.grad(e_pol, pos)
    _require_finite("the polarizable energy or forces", e_pol, f_pol)
    summary.update(e_pol=float(e_pol.detach()), pol_converged=bool(conv),
                   pol_iters=int(n_iter))

    # the full force field over the same ranks
    ff = make_sharded_ff_energy(None, grid_shape=GRID, kappa=0.62, lmax=2,
                                disp_grid_shape=GRID, disp_kappa=0.7,
                                pmax=10, **topo)
    ff_args = (c(sysd["c_list"]), c(sysd["tt_a"]), c(sysd["tt_b"]),
               c(sysd["tt_q"]))
    pos = base.clone().requires_grad_(True)
    e_ff = ff(pos, box, pairs, q_local, m_scales, *ff_args)
    (f_ff,) = torch.autograd.grad(e_ff, pos)
    _require_finite("the full force field", e_ff, f_ff)
    summary["e_ff"] = float(e_ff.detach())

    # a 3000-atom liquid box on a cell list at K=32: water_system lists the
    # atoms in lattice (x-major) order, so a rank's atom block crowds few
    # slabs; the bins are sized for that (halo_cap_factor = n)
    sys2 = water_system(n_side=10, spacing=3.1, jitter=0.12, seed=3)
    pos2, box2 = c(sys2["positions"]), c(sys2["box"])
    n2 = pos2.shape[0]
    nl2 = neighbor_list_cell(pos2, box2, 3.0)
    pairs2 = nl2.pairs[nl2.pairs[:, 0] < n2]
    cap2 = -(-pairs2.shape[0] // 128) * 128
    pairs2 = torch.cat([pairs2, torch.full((cap2 - pairs2.shape[0], 2), n2,
                                           device=device,
                                           dtype=pairs2.dtype)])
    q2 = convert_cart2harm(c(sys2["q_cart"]), 2)
    ff2 = make_sharded_ff_energy(
        None, grid_shape=(32, 32, 32), kappa=0.66, lmax=2,
        axis_types=sys2["axis_types"], axis_indices=sys2["axis_indices"],
        covalent_map=sys2["covalent_map"], disp_grid_shape=(32, 32, 32),
        disp_kappa=0.66, pmax=10,
        config=EngineConfig(halo_cap_factor=float(n_devices)), device=device)
    pos = pos2.clone().requires_grad_(True)
    e_ff2 = ff2(pos, box2, pairs2, q2, m_scales, c(sys2["c_list"]),
                c(sys2["tt_a"]), c(sys2["tt_b"]), c(sys2["tt_q"]))
    (f_ff2,) = torch.autograd.grad(e_ff2, pos)
    _require_finite("the 3000-atom full force field", e_ff2, f_ff2)
    summary.update(e_ff_3000=float(e_ff2.detach()), n_atoms_3000=n2,
                   n_pairs_3000=int(pairs2.shape[0]))
    return summary
