"""Sharded multipolar PME over the ranks of a torch.distributed process group
(admp_tpu/parallel/sharded.py).

Every rank runs the same function on the same replicated inputs and does its
own share of the work (SPMD, where admp_tpu runs one ``shard_map`` body per
device):

* pair-parallel real space: the padded pair list is cut into P contiguous
  blocks, rank r evaluates block r (admp_tpu's ``P(axis_name, None)``), and
  the partial energies are summed with ``psum``;
* halo-exchange spreading (parallel/spread.py): each rank spreads its atom
  block into the (K1/P + order-1, K2, K3) slab of the ranks that own the
  rows, on the port's K4 for float32 CUDA tensors;
* grid-parallel FFT: the pencil FFT of parallel/fft.py with one all_to_all;
  the influence multiply happens in the transposed layout (Parseval's sum
  does not care);
* the polarizable SCF's PCG matvec is the cheap u-quadratic energy gradient
  (sharded udud real space, a dipole-only lmax 1 mesh, dipole self energy
  and penalty), the sharded mirror of
  models/pme.make_induced_quadratic_energy;
* every factory takes an ``EngineConfig``: compensated pair sums, f64
  spread weights, the dispersion spread order, the halo bins' capacity
  (``halo_cap_factor``), the pair kernel and spread routes, and fixed-cell
  influence caching (``static_box``: each rank slices its K2 pencil chunk of
  the cached grid; box gradients are then zero, with a warning, as in the
  single-device engines).

Gradients: a replicated input passes through ``comm.pvary`` where it enters
a rank's own work, whose backward sums the ranks' cotangents, and the terms
every rank computes whole (self energies, the polarization penalty) stay
outside it, so each is counted once; see utils/comm.py. The result on every
rank is the full gradient. The SCF solve (scf/solver.py) runs on every rank
in lockstep: each quantity its loop tests comes out of an all_reduce, the
same on every rank, so every rank takes the same branch.

Call surfaces are admp_tpu's with a ``ProcessGroup`` (``group``, None for
the default group) where it takes a mesh and an axis name, and a ``device``
for the factory's own tables (the card unless the caller asks for the CPU).
``pairs`` is the full padded list, every other argument replicated; n_atoms,
the pair capacity, K1 and K2 must be divisible by the group's size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from admp_tpu_torch.models.dispersion import disp_pme_real_energy
from admp_tpu_torch.models.pme import (
    pair_chunk_for,
    pme_real_energy,
    pme_real_uu_energy,
)
from admp_tpu_torch.ops import bsplines
from admp_tpu_torch.ops.cuda import resolve_device
from admp_tpu_torch.ops.exclusions import as_covalent_map
from admp_tpu_torch.ops.frames import global_multipoles
from admp_tpu_torch.ops.harmonics import cart_dipole_to_harm
from admp_tpu_torch.ops.influence import ck_1, ck_6, ck_8, ck_10
from admp_tpu_torch.ops.reciprocal import (
    _CachedInfluenceBoxGuard,
    _fft_int_freqs,
    _hermitian_weights,
    influence_weights,
)
from admp_tpu_torch.ops.selfenergy import (
    dispersion_self_energy,
    pme_self_energy,
    polarization_penalty,
)
from admp_tpu_torch.ops.shortrange import expand_pairs, tt_damping_qq_c6_kernel
from admp_tpu_torch.parallel.fft import rfft3d_pencil
from admp_tpu_torch.parallel.spread import (
    sharded_spread_halo,
    sharded_spread_halo_multi,
)
from admp_tpu_torch.scf import solver
from admp_tpu_torch.settings import EngineConfig, SCFConfig
from admp_tpu_torch.utils import comm, profiling
from admp_tpu_torch.utils.constants import DIELECTRIC
from admp_tpu_torch.utils.linalg3 import det3x3, inv3x3


def _own_block(x, group, axis: int = 0):
    """This rank's contiguous block of ``x`` along ``axis`` (admp_tpu's
    ``P(axis_name)`` on that axis)."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[axis]
    if size % p:
        raise ValueError(f"axis {axis} of {size} is not divisible by {p} "
                         "ranks: pad it")
    return x.narrow(axis, r * (size // p), size // p)


def _shard_pairs(local, group, pair_arg: int = 2):
    """``local`` taking the full pair list at ``pair_arg`` and evaluating
    this rank's block of it (the shard_map boundary of admp_tpu)."""
    def fn(*args):
        args = list(args)
        args[pair_arg] = _own_block(args[pair_arg], group)
        return local(*args)

    return fn


def _pencil_kspace(box, grid_shape, dtype, dev, n_dev, order: int = 6):
    """(k^2, theta^2) grids of this rank's transposed half-spectrum pencil
    (K1, K2/P, K3//2+1), the layout :func:`rfft3d_pencil` returns."""
    k1, k2, k3 = grid_shape
    device = box.device
    box_inv = inv3x3(box).to(dtype)
    f1 = _fft_int_freqs(k1, dtype, device)
    k2_local = k2 // n_dev
    f2 = _fft_int_freqs(k2, dtype, device)[dev * k2_local:
                                           (dev + 1) * k2_local]
    f3 = torch.arange(k3 // 2 + 1, dtype=dtype, device=device)
    kvec = (
        f1[:, None, None, None] * box_inv[0][None, None, None, :]
        + f2[None, :, None, None] * box_inv[1][None, None, None, :]
        + f3[None, None, :, None] * box_inv[2][None, None, None, :]
    ) * (2.0 * math.pi)
    ksq = torch.sum(kvec * kvec, dim=-1)
    theta_fn = (bsplines.euler_spline_theta if order == 6
                else bsplines.euler_spline_theta4)
    theta = (theta_fn(f1, k1)[:, None, None] * theta_fn(f2, k2)[None, :, None]
             * theta_fn(f3, k3)[None, None, :])
    return ksq, theta * theta


def _pencil_weight_slice(cached_weight, dev, n_dev):
    """This rank's K2 pencil chunk of a cached (..., K1, K2, K3h) influence
    grid (the transposed layout rfft3d_pencil returns)."""
    k2_local = cached_weight.shape[-2] // n_dev
    return cached_weight.narrow(-2, dev * k2_local, k2_local)


@profiling.traced("reciprocal")
def _sharded_recip_energy(positions, box, q_tot, grid_shape, kappa, lmax,
                          ck_fn, include_gamma, prefactor, group,
                          order: int = 6, spread_precision=None,
                          cached=None, cap_factor: float = 3.0,
                          spread_method: str = "auto"):
    """Reciprocal-space energy: halo-exchange spreading + pencil FFT, the
    replicated total. The only grid-sized allocations are this rank's
    (K1/P + order-1, K2, K3) slab and its (K1, K2/P, K3//2+1) pencil.
    ``cached``: the fixed-cell influence grid (ops/reciprocal.
    influence_weights, Hermitian multiplicity folded in)."""
    k1, k2, k3 = grid_shape
    n_dev, dev = dist.get_world_size(group), dist.get_rank(group)
    if cached is not None:
        box = _CachedInfluenceBoxGuard.apply(box)
    slab, _overflow = sharded_spread_halo(
        positions, box, q_tot, grid_shape, lmax, group, order,
        cap_factor=cap_factor, precision=spread_precision,
        spread_method=spread_method)
    s_k = rfft3d_pencil(slab, group)
    dtype = slab.dtype
    s_sq = s_k.real * s_k.real + s_k.imag * s_k.imag
    if cached is not None:
        w_loc = _pencil_weight_slice(cached.to(dtype), dev, n_dev)
        return prefactor * comm.psum(torch.sum(w_loc * s_sq), group)
    ksq, theta_sq = _pencil_kspace(box, grid_shape, dtype, dev, n_dev, order)
    volume = det3x3(box)
    nonzero = ksq > 0.0
    ksq_safe = torch.where(nonzero, ksq, torch.ones_like(ksq))
    c_k = torch.where(nonzero, ck_fn(ksq_safe, kappa, volume),
                      torch.zeros_like(ksq))
    w3 = _hermitian_weights(k3, dtype, box.device)
    energy = torch.sum((c_k / theta_sq * w3[None, None, :]) * s_sq)
    if include_gamma and dev == 0:
        # only the rank holding k2-chunk 0 holds the gamma point
        c0 = ck_fn.at_zero(kappa, volume)
        energy = energy + c0 * s_sq[0, 0, 0] / theta_sq[0, 0, 0]
    return prefactor * comm.psum(energy, group)


def _sharded_disp_recip_energy(positions, box, c_list, grid_shape, kappa,
                               ck_fns, group, order: int = 6, cached=None,
                               cap_factor: float = 3.0):
    """Multi-channel (C6/C8/C10) dispersion reciprocal energy: one shared
    halo-exchange spread, a pencil FFT per channel, the gamma point
    included (single-device: ops/reciprocal.make_disp_pme_recip)."""
    k1, k2, k3 = grid_shape
    n_dev, dev = dist.get_world_size(group), dist.get_rank(group)
    if cached is not None:
        box = _CachedInfluenceBoxGuard.apply(box)
    slabs, _overflow = sharded_spread_halo_multi(
        positions, box, c_list[:, :len(ck_fns)], grid_shape, group, order,
        cap_factor=cap_factor)  # (C, K1/P, K2, K3)
    dtype = slabs.dtype
    if cached is None:
        ksq, theta_sq = _pencil_kspace(box, grid_shape, dtype, dev, n_dev,
                                       order)
        volume = det3x3(box)
        nonzero = ksq > 0.0
        ksq_safe = torch.where(nonzero, ksq, torch.ones_like(ksq))
        w3 = _hermitian_weights(k3, dtype, box.device)
    else:
        w_loc = _pencil_weight_slice(cached.to(dtype), dev, n_dev)
    energy = torch.zeros((), dtype=dtype, device=slabs.device)
    for c, ck_fn in enumerate(ck_fns):
        s_k = rfft3d_pencil(slabs[c], group)
        s_sq = s_k.real * s_k.real + s_k.imag * s_k.imag
        if cached is not None:
            # the gamma point is folded into the k = 0 entry of the grid
            energy = energy + torch.sum(w_loc[c] * s_sq)
            continue
        c_k = torch.where(nonzero, ck_fn(ksq_safe, kappa, volume),
                          torch.zeros_like(ksq))
        e_c = torch.sum((c_k / theta_sq * w3[None, None, :]) * s_sq)
        if dev == 0:
            c0 = ck_fn.at_zero(kappa, volume)
            e_c = e_c + c0 * s_sq[0, 0, 0] / theta_sq[0, 0, 0]
        energy = energy + e_c
    return comm.psum(energy, group)


def _electro_cached(config, static_box, grid_shape, kappa, order=6):
    """The fixed-cell influence grid of the electrostatic mesh when the
    config asks for it (None otherwise)."""
    if static_box is None or not (config and config.cache_influence):
        return None
    return influence_weights(static_box, grid_shape, kappa, ck_1, order)


def _static_box(static_box, device):
    if static_box is None:
        return None
    return torch.as_tensor(static_box, device=device).detach().clone()


def _index(x, device):
    return torch.as_tensor(x, device=device).long()


def _make_local_energy(group, grid_shape, kappa, lmax, axis_types,
                       axis_indices, covalent_map, lpol: bool = False,
                       config: EngineConfig | None = None, static_box=None,
                       device="cuda"):
    """This rank's energy function of (positions, box, pairs_local,
    q_local, m_scales[, u_ind, pol, tholes, p_scales]): the same total on
    every rank, from its pair block and its share of the mesh.

    With ``lpol`` it takes the polarizable tail (u_ind, pol, tholes,
    p_scales) and adds the induced real terms, the induced dipoles in the
    mesh and the self energy, and the polarization penalty: the total of
    models/pme.energy_pme with lpol=True (lmax >= 1)."""
    config = config or EngineConfig()
    device = resolve_device(device)
    axis_types = _index(axis_types, device)
    axis_indices = _index(axis_indices, device)
    covalent_map = as_covalent_map(covalent_map, device)
    grid_shape = tuple(int(k) for k in grid_shape)
    cached = _electro_cached(config, _static_box(static_box, device),
                             grid_shape, kappa)

    def _shared(positions, box, pairs_local, q_local, m_scales,
                u_ind=None, pol=None, tholes=None, p_scales=None):
        q_global = global_multipoles(positions, box, q_local, axis_types,
                                     axis_indices, lmax)
        u_harm = cart_dipole_to_harm(u_ind) if lpol else None
        # computed whole on every rank: outside pvary and psum
        q_tot = _add_dipoles(q_global, u_harm)
        e_self = pme_self_energy(q_tot, kappa, lmax)
        if lpol:
            e_self = e_self + polarization_penalty(u_ind, pol)
        # this rank's pair block and its share of the mesh
        pos_v, box_v, qg_v, ms_v, uh_v, pol_v, th_v, ps_v = comm.pvary(
            group, positions, box, q_global, m_scales, u_harm, pol, tholes,
            p_scales)
        e_real = comm.psum(pme_real_energy(
            pos_v, box_v, pairs_local, qg_v, uh_v, pol_v, th_v, ms_v, ps_v,
            covalent_map, kappa, lmax, lpol,
            compensated=config.compensated_sums,
            pair_kernel=config.pair_kernel,
            pair_chunk=pair_chunk_for(pairs_local)), group)
        e_recip = _sharded_recip_energy(
            pos_v, box_v, _add_dipoles(qg_v, uh_v), grid_shape, kappa, lmax,
            ck_1, False, DIELECTRIC, group,
            spread_precision=config.spread_precision, cached=cached,
            cap_factor=config.halo_cap_factor,
            spread_method=config.spread_method)
        return (e_real + e_recip + e_self).to(positions.dtype)

    return _shared


def _add_dipoles(q_global, u_harm):
    if u_harm is None:
        return q_global
    return torch.cat([q_global[:, :1], q_global[:, 1:4] + u_harm,
                      q_global[:, 4:]], dim=-1)


def _make_local_uu_energy(group, grid_shape, kappa, covalent_map,
                          config: EngineConfig | None = None,
                          static_box=None, device="cuda"):
    """This rank's u-quadratic energy of (positions, box, pairs_local,
    u_cart, pol, tholes, p_scales): the cheap SCF matvec, grad_u E_uu(u) =
    field(u) - field(0) = A u. Real-space udud over this rank's pairs, the
    dipoles on an lmax 1 halo-spread mesh, the dipole self energy and the
    polarization penalty; used by every PCG iteration of the forward solve
    and of the implicit-adjoint solve."""
    config = config or EngineConfig()
    device = resolve_device(device)
    covalent_map = as_covalent_map(covalent_map, device)
    grid_shape = tuple(int(k) for k in grid_shape)
    cached = _electro_cached(config, _static_box(static_box, device),
                             grid_shape, kappa)

    def _local_uu(positions, box, pairs_local, u_cart, pol, tholes,
                  p_scales):
        u_harm = cart_dipole_to_harm(u_cart)
        zero = u_harm.new_zeros(u_harm.shape[0], 1)
        e_self = (pme_self_energy(torch.cat([zero, u_harm], dim=-1), kappa, 1)
                  + polarization_penalty(u_cart, pol))
        pos_v, box_v, uh_v, pol_v, th_v, ps_v = comm.pvary(
            group, positions, box, u_harm, pol, tholes, p_scales)
        e_real = comm.psum(pme_real_uu_energy(
            pos_v, box_v, pairs_local, uh_v, pol_v, th_v, ps_v,
            covalent_map, kappa, config.pair_kernel,
            pair_chunk_for(pairs_local)), group)
        e_recip = _sharded_recip_energy(
            pos_v, box_v, torch.cat([zero, uh_v], dim=-1), grid_shape, kappa,
            1, ck_1, False, DIELECTRIC, group,
            spread_precision=config.spread_precision, cached=cached,
            cap_factor=config.halo_cap_factor,
            spread_method=config.spread_method)
        return e_real + e_recip + e_self

    return _local_uu


def make_sharded_pme_energy(group=None, *, grid_shape, kappa, lmax: int,
                            axis_types, axis_indices, covalent_map,
                            config: EngineConfig | None = None,
                            static_box=None, device="cuda"):
    """A fixed-multipole PME energy function sharded over ``group``.

    Returns energy_fn(positions, box, pairs, q_local, m_scales) -> the
    replicated energy, differentiable in every floating input; ``pairs`` is
    the full padded list, of which each rank evaluates its block. n_atoms,
    the pair capacity, K1 and K2 must be divisible by the group's size.
    ``config``/``static_box``: compensated sums, f64 spread weights, the
    halo capacity and fixed-cell influence caching (box gradients zero)."""
    local = _make_local_energy(group, grid_shape, kappa, lmax, axis_types,
                               axis_indices, covalent_map, config=config,
                               static_box=static_box, device=device)
    return _shard_pairs(local, group)


def make_sharded_pol_energy(group=None, *, grid_shape, kappa, lmax: int,
                            axis_types, axis_indices, covalent_map,
                            scf_config=None,
                            config: EngineConfig | None = None,
                            static_box=None, device="cuda"):
    """Sharded polarizable PME: the fixed-multipole machinery of
    :func:`make_sharded_pme_energy` with Thole-damped induced dipoles, solved
    by the port's SCF (scf/solver.py) around two sharded operators, the
    field (the u-gradient of the sharded energy, once per solve for the
    starting residual) and the cheap matvec (:func:`_make_local_uu_energy`,
    every PCG iteration of the forward and the adjoint solves). The matvec
    mesh is the energy mesh, as in admp_tpu's sharded path.

    With ``scf_config.exact_adjoint`` (the default) the solve carries the
    exact implicit adjoint (solver.solve_implicit), so the energy is
    differentiable in every input, parameters included; otherwise the solve
    is cut (Feynman-Hellmann). Requires lmax >= 1.

    Returns ``energy_and_aux(positions, box, pairs, q_local, pol, tholes,
    m_scales, p_scales, u_init) -> (energy, (u_star, converged, n_iter))``,
    the same on every rank; ``pairs`` is the full padded list."""
    scf = scf_config or SCFConfig()
    local = _make_local_energy(group, grid_shape, kappa, lmax, axis_types,
                               axis_indices, covalent_map, lpol=True,
                               config=config, static_box=static_box,
                               device=device)
    local_uu = _make_local_uu_energy(group, grid_shape, kappa, covalent_map,
                                     config=config, static_box=static_box,
                                     device=device)

    def energy_and_aux(positions, box, pairs, q_local, pol, tholes,
                       m_scales, p_scales, u_init):
        pairs_local = _own_block(pairs, group)

        def energy_u(inp, u):
            return local(inp[0], inp[1], pairs_local, inp[2], inp[3], u,
                         inp[4], inp[5], inp[6])

        def field(inp, u, create_graph=False):
            u_req = u.detach().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(energy_u(inp, u_req), u_req,
                                           create_graph=create_graph)
            return g

        def matvec_fn(v, theta, create_graph):
            pos, bx, pl, th, ps = theta
            v_req = v.detach().requires_grad_(True)
            # a solver iteration, for the comm tally, unless it is the
            # adjoint's theta path (create_graph)
            with torch.enable_grad(), (contextlib.nullcontext()
                                       if create_graph
                                       else comm.loop_iteration()):
                e = local_uu(pos, bx, pairs_local, v_req, pl, th, ps)
                (g,) = torch.autograd.grad(e, v_req,
                                           create_graph=create_graph)
            return g

        inp = (positions, box, q_local, m_scales, pol, tholes, p_scales)
        inp_d = tuple(t.detach() for t in inp)
        theta = [positions, box, pol, tholes, p_scales]
        u0 = u_init.detach()
        # the Jacobi method iterates on A u = b from b = -field(0)
        rhs = (-field(inp_d, torch.zeros_like(u0))
               if scf.method == "jacobi" else None)
        if scf.exact_adjoint:
            r0 = -field(inp, u0, create_graph=True)
            u_star, conv, n_it, _ = solver.solve_implicit(
                r0, u0, pol, matvec_fn,
                dataclasses.replace(scf, adjoint_warmstart=False), theta,
                rhs=rhs)
        else:
            theta_d = [t.detach() for t in theta]
            u_star, conv, n_it, _ = solver.solve(
                lambda v: matvec_fn(v, theta_d, False), -field(inp_d, u0),
                u0, pol, scf, rhs)
        energy = energy_u(inp, u_star)
        return energy, (u_star.detach(), conv, n_it)

    return energy_and_aux


def make_sharded_disp_energy(group=None, *, grid_shape, kappa, pmax: int,
                             covalent_map, spread_order: int | None = None,
                             config: EngineConfig | None = None,
                             static_box=None, device="cuda"):
    """Sharded dispersion PME (C6/C8/C10): pair-sharded real space, one
    shared halo-exchange multi-channel spread, a pencil FFT per channel,
    the replicated self term (single-device:
    models/dispersion.ADMPDispPmeForce).

    ``spread_order`` defaults to ``config.disp_spread_order``;
    ``config.cache_influence`` with ``static_box`` precomputes the
    per-channel influence grids. Returns ``energy_fn(positions, box, pairs,
    c_list, m_scales) -> energy``."""
    config = config or EngineConfig()
    if spread_order is None:
        spread_order = config.disp_spread_order
    device = resolve_device(device)
    covalent_map = as_covalent_map(covalent_map, device)
    grid_shape = tuple(int(k) for k in grid_shape)
    recip_pmax = min(pmax, config.pmax_recip or pmax)
    ck_fns = tuple(fn for fn, p in ((ck_6, 6), (ck_8, 8), (ck_10, 10))
                   if recip_pmax >= p)
    static_box = _static_box(static_box, device)
    cached = None
    if static_box is not None and config.cache_influence:
        cached = torch.stack([
            influence_weights(static_box, grid_shape, kappa, ck_fn,
                              spread_order, include_gamma=True)
            for ck_fn in ck_fns])

    def _local(positions, box, pairs_local, c_list, m_scales):
        e_self = dispersion_self_energy(c_list, kappa, pmax)
        pos_v, box_v, c_v, ms_v = comm.pvary(group, positions, box, c_list,
                                             m_scales)
        e_real = comm.psum(disp_pme_real_energy(
            pos_v, box_v, pairs_local, c_v, ms_v, covalent_map, kappa, pmax),
            group)
        e_recip = _sharded_disp_recip_energy(
            pos_v, box_v, c_v, grid_shape, kappa, ck_fns, group,
            spread_order, cached=cached, cap_factor=config.halo_cap_factor)
        return e_real + e_recip + e_self

    return _shard_pairs(_local, group)


def make_sharded_pairwise_energy(group, kernel, covalent_map, device="cuda"):
    """Pair-sharded generic short-range interaction: the sharded
    ops/shortrange.generate_pairwise_interaction, with its call surface
    ``fn(positions, box, pairs, m_scales, *atomic_params)``."""
    covalent_map = as_covalent_map(covalent_map, resolve_device(device))

    @profiling.traced("shortrange")
    def _local(positions, box, pairs_local, m_scales, *atomic_params):
        pos_v, box_v, ms_v, *params_v = comm.pvary(
            group, positions, box, m_scales, *atomic_params)
        mask, i, j, r, mscale = expand_pairs(pos_v, box_v, pairs_local,
                                             covalent_map, ms_v)
        gathered = []
        for param in params_v:
            gathered += [param[i], param[j]]
        energies = kernel(r, mscale, *gathered)
        e = torch.where(mask, energies, torch.zeros_like(energies)).sum()
        return comm.psum(e, group)

    return _shard_pairs(_local, group)


def make_sharded_ff_energy(group=None, *, grid_shape, kappa, lmax: int,
                           axis_types, axis_indices, covalent_map,
                           disp_grid_shape, disp_kappa, pmax: int = 10,
                           disp_spread_order: int | None = None,
                           lpol: bool = False, scf_config=None,
                           config: EngineConfig | None = None,
                           static_box=None, device="cuda"):
    """The full MPID water force field, sharded: multipolar PME (optionally
    polarizable) + Tang-Toennies short range - dispersion PME, the front
    end's sign convention (api.py: ``e_sr - e_lr``).

    Nonpolarizable: ``fn(positions, box, pairs, q_local, m_scales, c_list,
    tt_a, tt_b, tt_q) -> energy``. Polarizable (``lpol=True``):
    ``fn(positions, box, pairs, q_local, pol, tholes, m_scales, p_scales,
    c_list, tt_a, tt_b, tt_q, u_init) -> (energy, (u_star, converged,
    n_iter))``. One pair list serves every term."""
    disp_fn = make_sharded_disp_energy(
        group, grid_shape=disp_grid_shape, kappa=disp_kappa, pmax=pmax,
        covalent_map=covalent_map, spread_order=disp_spread_order,
        config=config, static_box=static_box, device=device)
    tt_fn = make_sharded_pairwise_energy(group, tt_damping_qq_c6_kernel,
                                         covalent_map, device=device)
    common = dict(grid_shape=grid_shape, kappa=kappa, lmax=lmax,
                  axis_types=axis_types, axis_indices=axis_indices,
                  covalent_map=covalent_map, config=config,
                  static_box=static_box, device=device)

    if not lpol:
        elec_fn = make_sharded_pme_energy(group, **common)

        def ff_energy(positions, box, pairs, q_local, m_scales, c_list,
                      tt_a, tt_b, tt_q):
            e = elec_fn(positions, box, pairs, q_local, m_scales)
            e = e + tt_fn(positions, box, pairs, m_scales, tt_a, tt_b, tt_q,
                          c_list[:, 0])
            return e - disp_fn(positions, box, pairs, c_list, m_scales)

        return ff_energy

    pol_fn = make_sharded_pol_energy(group, scf_config=scf_config, **common)

    def ff_energy_pol(positions, box, pairs, q_local, pol, tholes, m_scales,
                      p_scales, c_list, tt_a, tt_b, tt_q, u_init):
        e_elec, aux = pol_fn(positions, box, pairs, q_local, pol, tholes,
                             m_scales, p_scales, u_init)
        e = e_elec + tt_fn(positions, box, pairs, m_scales, tt_a, tt_b, tt_q,
                           c_list[:, 0])
        return e - disp_fn(positions, box, pairs, c_list, m_scales), aux

    return ff_energy_pol


def make_sharded_batch_energy(data_group, model_group, **kw):
    """Data-parallel batches of configurations over the model-sharded
    energy: ``energy_b(positions_b, box, pairs_b, q_local, m_scales)`` with
    positions (B, N, 3) and pairs (B, C, 2); data rank d evaluates the
    batch block d, each element sharded over ``model_group`` (its pairs cut
    into the model group's blocks). Returns the (B,) energies, replicated
    on every rank (admp_tpu's ``P(data_axis)`` output, gathered). The batch
    block runs element by element, as admp_tpu's ``lax.map``. Groups:
    parallel/launch.mesh_groups."""
    local = _make_local_energy(
        model_group, kw["grid_shape"], kw["kappa"], kw["lmax"],
        kw["axis_types"], kw["axis_indices"], kw["covalent_map"],
        config=kw.get("config"), static_box=kw.get("static_box"),
        device=kw.get("device", "cuda"))

    def energy_b(positions_b, box, pairs_b, q_local, m_scales):
        # replicated over the data group -> this data rank's share
        pos_d, box_d, q_d, ms_d = comm.pvary(data_group, positions_b, box,
                                             q_local, m_scales)
        pos_blk = _own_block(pos_d, data_group)
        pairs_blk = _own_block(_own_block(pairs_b, data_group), model_group,
                               axis=1)
        energies = torch.stack([
            local(pos_blk[b], box_d, pairs_blk[b], q_d, ms_d)
            for b in range(pos_blk.shape[0])])
        return comm.all_gather(energies, data_group)

    return energy_b
