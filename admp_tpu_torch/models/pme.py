"""Multipolar electrostatic PME with optional Thole polarization
(admp_tpu/models/pme.py).

The class keeps admp_tpu's public surface: the constructor arguments (with
the compatibility keywords), ``update_env`` and ``refresh_calculators``,
``get_energy`` / ``get_forces`` / ``get_metrics`` / ``optimize_Uind``, the
``U_ind`` / ``W_adj`` / ``lconverg`` / ``n_cycle`` state and writable
``kappa`` / ``K1..K3`` (rebuild with ``refresh_calculators``). As there,
``get_forces`` returns (energy, dE/dpositions).

The polarizable step follows admp_tpu's Feynman-Hellmann (FH) path
(models/pme.py:969-1000): r0 = -field(u0) from ``torch.autograd.grad`` on
detached inputs with no graph kept, warm-started PCG whose every matvec is
one ``torch.autograd.grad`` of the u-quadratic energy with respect to v, and
the final energy evaluated at a detached u* and differentiated with respect
to the positions. With ``exact_adjoint=True`` (the default ``SCFConfig()``,
the fitting profile) u* carries the implicit-function adjoint of
scf/solver.ImplicitSolve instead, on the plain path and on the kernels alike:
r0 = -field(u0) keeps its graph, so the backward differentiates the pair
kernel's backward (K3 for ``'pol'``), and the adjoint differentiates the
matvec with respect to its parameters (K3 for ``'uu'``). Gradients with
respect to Q_local, pol, tholes, mScales and pScales flow through
``get_energy`` on either path. With ``adjoint_fixed_iters`` set those
gradients are differentiable again, as admp_tpu's are: a force-matching
loss takes the third derivative (K3b for ``'pol'`` and ``'uu'``).

The precision modes (EngineConfig, admp_tpu/models/pme.py:380-622) are
admp_tpu's: under a float64 real-space mode the frames, the multipole
rotation and the self energy run in float64; ``'f64-all'`` evaluates every
pair in float64; ``'f64'`` masks the topological pairs out of the working
pass and evaluates them in float64 on the static ``exclusion_pair_list``;
``'f64-near'`` adds, for the pairs closer than ``realspace_near_radius``,
the float64 pair energy minus the working-dtype one on the same route, so
the main pass's rounding of those pairs cancels. The reciprocal modes are
ops/reciprocal.make_pme_recip's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from admp_tpu_torch.ops import realspace
from admp_tpu_torch.ops.cuda import resolve_device, use_kernel
from admp_tpu_torch.ops.cuda.pairs import pair_energies_indexed
from admp_tpu_torch.ops.ewald import (
    lane_align_k3,
    setup_ewald_parameters,
    setup_ewald_parameters_fft,
)
from admp_tpu_torch.ops.exclusions import (
    SparseExclusions,
    as_covalent_map,
    exclusion_pair_list,
    lookup_topology_distance,
    scale_for_distance,
)
from admp_tpu_torch.ops.frames import global_multipoles
from admp_tpu_torch.ops.harmonics import cart_dipole_to_harm
from admp_tpu_torch.ops.influence import ck_1
from admp_tpu_torch.ops.neighborlist import NeighborList
from admp_tpu_torch.ops.reciprocal import make_pme_recip
from admp_tpu_torch.ops.selfenergy import pme_self_energy, polarization_penalty
from admp_tpu_torch.scf import solver
from admp_tpu_torch.settings import EngineConfig, SCFConfig
from admp_tpu_torch.utils import profiling
from admp_tpu_torch.utils.accmath import compensated_sum, masked_compensated_sum
from admp_tpu_torch.utils.constants import DIELECTRIC
from admp_tpu_torch.utils.devconst import device_values
from admp_tpu_torch.utils.linalg3 import inv3x3


# admp_tpu's pair-chunk rule (models/pme.py:787): blocks of 2^21 pairs once a
# list holds more than 2^22 (unchunked below: chunking was slower at 1.6M)
PAIR_CHUNK, PAIR_CHUNK_ABOVE = 1 << 21, 1 << 22


def pair_chunk_for(pairs):
    return PAIR_CHUNK if pairs.shape[0] > PAIR_CHUNK_ABOVE else None


def _sum_pair_chunks(energy_of, pairs, pair_chunk, compensated=False):
    """The sum of ``energy_of(block)`` over consecutive blocks of
    ``pair_chunk`` pairs (admp_tpu's lax.map over padded blocks; a ragged
    last block needs no padding here)."""
    parts = torch.stack([energy_of(pairs[k:k + pair_chunk])
                         for k in range(0, pairs.shape[0], pair_chunk)])
    return compensated_sum(parts) if compensated else parts.sum()


def _pair_indices(pairs, n):
    raw_i, raw_j = pairs[:, 0], pairs[:, 1]
    mask = raw_i < raw_j
    return torch.clamp(raw_i, max=n - 1), torch.clamp(raw_j, max=n - 1), mask


def _pair_scalars(kappa, box):
    """The pair kernel's 19 scalars: kappa, box (9), inv(box) (9)."""
    k = device_values(kappa.reshape(1) if torch.is_tensor(kappa) else
                      (kappa,), box.dtype, box.device)
    return torch.cat([k, box.reshape(9), inv3x3(box).reshape(9)])


@profiling.traced("realspace")
def pme_real_energy(positions, box, pairs, q_global, u_ind_harm, pol, tholes,
                    m_scales, p_scales, covalent_map, kappa, lmax: int,
                    lpol: bool, compensated: bool = False,
                    pair_kernel: str = "auto", pair_chunk: int | None = None,
                    exclude_topological: bool = False):
    """Real-space multipolar Ewald energy over a padded pair list (pairs with
    i >= j are padding). ``pair_kernel`` picks the CUDA pair kernel or the
    plain component path (ops/cuda.use_kernel); ``pair_chunk`` sums over
    blocks of that many pairs; ``exclude_topological`` also masks every pair
    at a nonzero topological distance (the kernel takes it in its mask row),
    which realspace_precision='f64' evaluates in float64 instead."""
    if pair_chunk is not None and pairs.shape[0] > pair_chunk:
        # the blocks run inside this call's span
        return _sum_pair_chunks(
            lambda blk: pme_real_energy.__wrapped__(
                positions, box, blk, q_global, u_ind_harm, pol, tholes,
                m_scales, p_scales, covalent_map, kappa, lmax, lpol,
                compensated, pair_kernel, None, exclude_topological),
            pairs, pair_chunk, compensated)
    n = positions.shape[0]
    i, j, mask = _pair_indices(pairs, n)
    nbond = lookup_topology_distance(covalent_map, i, j)
    mscale = scale_for_distance(m_scales, nbond)
    if exclude_topological:
        mask = mask & (nbond == 0)

    if use_kernel(pair_kernel, positions, "pair_kernel"):
        # the kernels read both rows of each pair from one packed atom table
        dtype = positions.dtype
        cols = [positions, q_global[:, : (lmax + 1) ** 2]]
        scl_rows = [mscale.to(dtype), mask.to(dtype)]
        if lpol:
            cols += [u_ind_harm, pol.to(dtype)[:, None],
                     tholes.to(dtype)[:, None]]
            scl_rows.append(scale_for_distance(p_scales, nbond).to(dtype))
        packed = torch.cat(cols, dim=1)
        e = pair_energies_indexed(
            packed, i, j, torch.stack(scl_rows), _pair_scalars(kappa, box),
            lmax, "pol" if lpol else "perm")
        return compensated_sum(e) if compensated else e.sum()

    r, qi_i, qi_j, ui, uj = realspace.qi_pair_components(
        positions, box, q_global, i, j, mask, lmax,
        u_ind_harm if lpol else None)
    coef = realspace.perm_coefficients(r, mscale, kappa, lmax)
    e = realspace.pair_energy_perm(qi_i, qi_j, coef, lmax)
    if lpol:
        pscale = scale_for_distance(p_scales, nbond)
        dmp = realspace.pair_damping_width(pol[i], pol[j])
        icoef = realspace.induced_coefficients(
            r, tholes[i], tholes[j], dmp, pscale, kappa, lmax)
        e = e + realspace.pair_energy_induced(qi_i, qi_j, ui, uj, icoef, lmax)
    if compensated:
        return masked_compensated_sum(e, mask)
    return torch.where(mask, e, torch.zeros_like(e)).sum()


@profiling.traced("realspace")
def pme_real_uu_energy(positions, box, pairs, u_ind_harm, pol, tholes,
                       p_scales, covalent_map, kappa,
                       pair_kernel: str = "auto", pair_chunk: int | None = None):
    """Real-space induced-induced energy only (the u-quadratic slice of the
    polarizable pair energy), for the SCF matvec."""
    if pair_chunk is not None and pairs.shape[0] > pair_chunk:
        return _sum_pair_chunks(
            lambda blk: pme_real_uu_energy.__wrapped__(
                positions, box, blk, u_ind_harm, pol, tholes, p_scales,
                covalent_map, kappa, pair_kernel),
            pairs, pair_chunk)
    n = positions.shape[0]
    i, j, mask = _pair_indices(pairs, n)
    pscale = scale_for_distance(p_scales,
                                lookup_topology_distance(covalent_map, i, j))
    if use_kernel(pair_kernel, positions, "pair_kernel"):
        dtype = positions.dtype
        packed = torch.cat([positions, u_ind_harm, pol.to(dtype)[:, None],
                            tholes.to(dtype)[:, None]], dim=1)
        e = pair_energies_indexed(
            packed, i, j, torch.stack([pscale.to(dtype), mask.to(dtype)]),
            _pair_scalars(kappa, box), 1, "uu")
        return e.sum()

    dx, dy, dz, r, rinv, _, _ = realspace.pair_displacement_components(
        positions, box, i, j, mask)
    ug_i, ug_j = u_ind_harm[i], u_ind_harm[j]
    e = realspace.uu_pair_energy(
        dx, dy, dz, r, rinv, (ug_i[:, 1], ug_i[:, 2], ug_i[:, 0]),
        (ug_j[:, 1], ug_j[:, 2], ug_j[:, 0]), pol[i], pol[j], tholes[i],
        tholes[j], pscale, kappa)
    return torch.where(mask, e, torch.zeros_like(e)).sum()


def make_induced_quadratic_energy(covalent_map, kappa, grid_shape,
                                  config: EngineConfig, static_box=None):
    """E_uu(v): the exactly-u-quadratic part of the polarizable energy, whose
    v-gradient is A v. Terms: real-space udud, |S(u)|^2 on an lmax=1 mesh,
    the u self energy and the polarization penalty. ``covalent_map`` is a
    dense map or a SparseExclusions on the pairs' device."""
    recip_uu = make_pme_recip(
        ck_1, kappa, grid_shape, 1, DIELECTRIC,
        spread_method=config.spread_method,
        compensated=config.compensated_sums, static_box=static_box,
        spread_order=config.spread_order,
        spread_precision=config.spread_precision,
        recip_precision=config.recip_precision,
    )

    def energy_uu(positions, box, pairs, u_ind_cart, pol, tholes, p_scales):
        u_harm = cart_dipole_to_harm(u_ind_cart)
        e = pme_real_uu_energy(positions, box, pairs, u_harm, pol, tholes,
                               p_scales, covalent_map, kappa,
                               config.pair_kernel, pair_chunk_for(pairs))
        q_u = torch.cat([u_harm.new_zeros(u_harm.shape[0], 1), u_harm], dim=-1)
        e = e + recip_uu(positions, box, q_u)
        e = e + pme_self_energy(q_u, kappa, 1)
        e = e + polarization_penalty(u_ind_cart, pol)
        return e

    return energy_uu


def energy_pme(positions, box, pairs, q_local, u_ind_cart, pol, tholes,
               m_scales, p_scales, d_scales, covalent_map, axis_types,
               axis_indices, pme_recip_fn, kappa, lmax: int, lpol: bool,
               config: EngineConfig | None = None,
               return_terms: bool = False, pair_chunk: int | None = None,
               excl_pairs=None):
    """Total multipolar PME energy: real + reciprocal + self
    (+ polarization). ``u_ind_cart`` are Cartesian induced dipoles;
    ``d_scales`` is accepted for API parity and unused, as in admp_tpu.
    ``pair_chunk``: the real-space sum over blocks of that many pairs.
    ``excl_pairs``: the static (E, 2) list of every topological pair
    (ops/exclusions.exclusion_pair_list), which
    ``config.realspace_precision='f64'`` evaluates in float64; it covers
    every topological pair whatever the neighbour list's cutoff."""
    del d_scales
    config = config or EngineConfig()
    work_dtype = positions.dtype
    f64 = torch.float64
    all64 = config.realspace_precision == "f64-all"
    excl64 = config.realspace_precision == "f64" and excl_pairs is not None
    near64 = config.realspace_precision == "f64-near"
    # under a float64 real-space mode the O(N) stages (frames, rotation,
    # self energy) run in float64: their rounding feeds the ~1e6-magnitude
    # real/self/reciprocal cancellation
    geo_dtype = f64 if (all64 or excl64 or near64) else work_dtype
    if lmax > 0:
        q_global = global_multipoles(
            positions.to(geo_dtype), box.to(geo_dtype),
            q_local.to(geo_dtype), axis_types, axis_indices, lmax)
    else:
        q_global = q_local.to(geo_dtype)
    lmax_eff = lmax
    u_harm = None
    q_tot = q_global
    if lpol:
        if lmax == 0:
            # promote charges so induced dipoles have slots
            q_global = torch.cat(
                [q_global, q_global.new_zeros(q_global.shape[0], 3)], dim=-1)
            lmax_eff = 1
        u_harm = cart_dipole_to_harm(u_ind_cart).to(geo_dtype)
        q_tot = torch.cat([q_global[:, :1], q_global[:, 1:4] + u_harm,
                           q_global[:, 4:]], dim=-1)

    def pair_pass(dtype, pair_list, pair_kernel, **kw):
        cast = lambda t: None if t is None else t.to(dtype)  # noqa: E731
        return pme_real_energy(
            positions.to(dtype), box.to(dtype), pair_list, q_global.to(dtype),
            cast(u_harm), cast(pol), cast(tholes), m_scales.to(dtype),
            cast(p_scales), covalent_map, kappa, lmax_eff, lpol,
            pair_kernel=pair_kernel, **kw)

    # a float64 pass takes the plain path under every pair_kernel, as
    # admp_tpu's float64 passes never take its kernel
    if all64:
        e_real = pair_pass(f64, pairs, "auto", pair_chunk=pair_chunk)
    else:
        e_real = pair_pass(work_dtype, pairs, config.pair_kernel,
                           compensated=config.compensated_sums,
                           pair_chunk=pair_chunk,
                           exclude_topological=excl64)
    if excl64:
        e_real = e_real.to(f64) + pair_pass(f64, excl_pairs, "auto")
    if near64:
        e_real = e_real.to(f64) + _near_pair_delta(
            positions, box, pairs, config, pair_pass)
    recip_f64 = config.recip_precision in ("f64", "f64-dft")
    if lpol and lmax == 0:
        # the engine spreads charges only; the dipoles go on their own mesh
        recip_q = q_global if recip_f64 else q_global.to(work_dtype)
        recip_u = u_harm if recip_f64 else u_harm.to(work_dtype)
        e_recip = pme_recip_fn(positions, box, recip_q[:, :1], recip_u)
    else:
        e_recip = pme_recip_fn(positions, box,
                               q_tot if recip_f64 else q_tot.to(work_dtype))
    e_self = pme_self_energy(q_tot, kappa, lmax_eff)
    e_pol = None
    if lpol:
        e_pol = polarization_penalty(u_ind_cart.to(geo_dtype), pol)
        e_self = e_self + e_pol
    # compensated float32 sums come back in float64 (utils/accmath): add the
    # ~1e6-magnitude terms there and round the total once
    total = (e_real + e_recip + e_self).to(work_dtype)
    if return_terms:
        terms = {"e_real": e_real, "e_recip": e_recip, "e_self": e_self}
        if e_pol is not None:
            terms["e_pol_penalty"] = e_pol
        return total, {k: v.to(work_dtype) for k, v in terms.items()}
    return total


def _near_pair_delta(positions, box, pairs, config, pair_pass):
    """realspace_precision='f64-near' (admp_tpu/models/pme.py:520-587): the
    pairs closer than ``realspace_near_radius``, compacted in order to
    ceil(capacity x ``realspace_near_frac``) slots clipped to [128,
    capacity] by a cumulative sum and a scatter (no host read), evaluated in
    float64 and in the working dtype on the main pass's route and with its
    summation; returns E64 - E_work. More near pairs than slots make the
    energy NaN and, through a NaN times zero term, the position gradient
    too."""
    f64 = torch.float64
    cap = pairs.shape[0]
    n = positions.shape[0]
    with torch.no_grad():
        i, j, pmask = _pair_indices(pairs, n)
        r = realspace.pair_displacement_components(positions, box, i, j,
                                                   pmask)[3]
        sel = pmask & (r < config.realspace_near_radius)
        near_cap = min(max(int(np.ceil(cap * config.realspace_near_frac)),
                           128), cap)
        slot = torch.cumsum(sel.long(), 0) - 1
        slot = torch.where(sel & (slot < near_cap), slot,
                           torch.full_like(slot, near_cap))
        idx = torch.full((near_cap + 1,), cap, dtype=torch.long,
                         device=pairs.device)
        idx = idx.scatter(0, slot, torch.arange(cap, device=pairs.device))
        idx = idx[:near_cap]
        near_pairs = torch.where((idx < cap)[:, None],
                                 pairs[torch.clamp(idx, max=cap - 1)],
                                 torch.full_like(pairs[:1], n))
        overflowed = sel.sum() > near_cap
    # the working-dtype pass sums as the main pass does (compensated), so
    # the delta cancels the main pass's near pairs in the energy too;
    # admp_tpu sums it plainly and keeps that sum's f32 rounding
    delta = (pair_pass(f64, near_pairs, "auto")
             - pair_pass(positions.dtype, near_pairs, config.pair_kernel,
                         compensated=config.compensated_sums).to(f64))
    nan = torch.full_like(delta, float("nan"))
    delta = torch.where(overflowed, nan, delta)
    poison = torch.where(overflowed, nan, torch.zeros_like(delta))
    return delta + poison * positions.sum().to(f64) * 0.0


class ADMPPmeForce:
    """Multipolar PME calculator with admp_tpu's public surface.

    ``device`` and ``dtype`` say where and in what type the force works;
    inputs are moved there. The default is the card: without one the
    constructor raises, and the CPU is taken only when asked for
    (``device='cpu'``). The kernels run for ``dtype=torch.float32`` on a
    CUDA device (EngineConfig.pair_kernel / spread_method ``'auto'``).

    ``scf_config``, ``fft_friendly_grid``, ``spread_method`` and
    ``spread_precision`` are admp_tpu's compatibility keywords, folded into
    ``config`` as there (admp_tpu/models/pme.py:645-657): without a
    ``config`` they make one, and ``scf_config`` also replaces the SCF of a
    given ``config``.
    """

    def __init__(self, box, axis_type, axis_indices, covalent_map, rc,
                 ethresh, lmax, lpol=False, scf_config: SCFConfig | None = None,
                 fft_friendly_grid: bool | str = "auto",
                 spread_method: str = "auto",
                 spread_precision: str | None = None,
                 config: EngineConfig | None = None, device="cuda",
                 dtype=torch.float32):
        if config is None:
            config = EngineConfig(fft_friendly_grid=fft_friendly_grid,
                                  spread_method=spread_method,
                                  spread_precision=spread_precision,
                                  scf=scf_config or SCFConfig())
        elif scf_config is not None:
            config = dataclasses.replace(config, scf=scf_config)
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype
        box_np = np.asarray(box.detach().cpu() if torch.is_tensor(box) else box,
                            dtype=np.float64)
        self.axis_type = self._index_tensor(axis_type)
        self.axis_indices = self._index_tensor(axis_indices)
        # a dense (N, N) map or a SparseExclusions (admp_tpu/models/pme.py
        # :695-702); N comes from either
        self.covalent_map = as_covalent_map(covalent_map, self.device)
        self.n_atoms = (self.covalent_map.n_atoms
                        if isinstance(self.covalent_map, SparseExclusions)
                        else int(self.covalent_map.shape[0]))
        self.rc = rc
        self.ethresh = ethresh
        self.lmax = int(lmax)
        self.lpol = bool(lpol)
        if self.config.resolve_fft_friendly():
            kappa, k1, k2, k3 = setup_ewald_parameters_fft(rc, ethresh, box_np)
        else:
            kappa, k1, k2, k3 = setup_ewald_parameters(rc, ethresh, box_np)
        if self.config.resolve_lane_align():
            k3 = lane_align_k3(k3)
        if self.config.recip_precision == "ds":
            # the DS engine's radix-2 FFT needs power-of-two grids: round
            # the heuristic up (admp_tpu/models/pme.py:688-691)
            k1, k2, k3 = (1 << (int(k) - 1).bit_length() for k in (k1, k2, k3))
        self.kappa = kappa
        self.K1, self.K2, self.K3 = k1, k2, k3
        self.scf_config = self.config.scf
        self._static_box = (self._float(box_np) if self.config.cache_influence
                            else None)
        # the static topological pair list of realspace_precision='f64'
        self._excl_pairs = (
            exclusion_pair_list(self.covalent_map).to(self.device)
            if self.config.realspace_precision == "f64" else None)
        self.U_ind = torch.zeros((self.n_atoms, 3), device=self.device,
                                 dtype=dtype)
        # the adjoint warm start, carried across get_forces calls like U_ind
        # (zeros unless SCFConfig.adjoint_warmstart)
        self.W_adj = torch.zeros_like(self.U_ind)
        self.lconverg = None
        self.n_cycle = None
        if self.lpol:
            self.get_energy = self._pol_energy
            self.get_forces = self._pol_forces
            self.get_metrics = self._pol_metrics
        else:
            self.get_energy = self._fixed_energy
            self.get_forces = self._fixed_forces
            self.get_metrics = self._fixed_metrics
        self.refresh_calculators()

    # ------------------------------------------------------------------
    def _index_tensor(self, x):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x))
        return x.to(self.device).long()

    def _float(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x))
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _accept_pairs(self, pairs):
        """A NeighborList is unwrapped to its pair tensor; the pair order
        does not matter to the port, so nothing is resolved or cached."""
        if isinstance(pairs, NeighborList):
            pairs = pairs.pairs
        if isinstance(pairs, np.ndarray):
            pairs = torch.from_numpy(np.array(pairs))
        return torch.as_tensor(pairs, device=self.device).long()

    def update_env(self, attr, val):
        """Set an attribute (kappa, K1..K3, ...) and rebuild the engines
        (admp_tpu/models/pme.py:725-729)."""
        setattr(self, attr, val)
        self.refresh_calculators()

    def refresh_calculators(self):
        """(Re)build the reciprocal engines from kappa and K1..K3."""
        cfg = self.config
        self._kappa = self.kappa
        self.pme_recip = make_pme_recip(
            ck_1, self.kappa, (self.K1, self.K2, self.K3), self.lmax,
            DIELECTRIC, spread_method=cfg.spread_method,
            compensated=cfg.compensated_sums, static_box=self._static_box,
            spread_order=cfg.spread_order,
            spread_precision=cfg.spread_precision,
            recip_precision=cfg.recip_precision,
        )
        if self.lpol:
            scf = self.scf_config
            mv_config = cfg
            if scf.matvec_spread_order is not None:
                mv_config = dataclasses.replace(
                    cfg, spread_order=scf.matvec_spread_order)
            div = max(int(scf.matvec_grid_div), 1)

            def reduce_k(k, keep_aligned=False):
                if div == 1 or (keep_aligned and k % 128 == 0):
                    return k
                kd = max(-(-k // div), 32)
                kd = kd + (kd % 2)
                return min(kd, k)

            mv_grid = (reduce_k(self.K1), reduce_k(self.K2),
                       reduce_k(self.K3, keep_aligned=True))
            self.matvec_grid = mv_grid
            self.energy_uu = make_induced_quadratic_energy(
                self.covalent_map, self.kappa, mv_grid, mv_config,
                static_box=self._static_box)

    # ------------------------------------------------------------------
    # fixed-multipole path
    # ------------------------------------------------------------------
    def _fixed_terms(self, positions, box, pairs, Q_local, mScales,
                     return_terms=False):
        pairs = self._accept_pairs(pairs)
        return energy_pme(
            self._float(positions), self._float(box), pairs,
            self._float(Q_local), None, None, None, self._float(mScales),
            None, None, self.covalent_map, self.axis_type, self.axis_indices,
            self.pme_recip, self._kappa, self.lmax, False, self.config,
            return_terms=return_terms, pair_chunk=pair_chunk_for(pairs),
            excl_pairs=self._excl_pairs)

    @profiling.traced("pme.energy", composite=True)
    def _fixed_energy(self, positions, box, pairs, Q_local, mScales):
        return self._fixed_terms(positions, box, pairs, Q_local, mScales)

    @profiling.traced("pme.energy", composite=True)
    def _fixed_forces(self, positions, box, pairs, Q_local, mScales):
        pos = self._float(positions).detach().requires_grad_(True)
        with torch.enable_grad():
            energy = self._fixed_terms(pos, box, pairs, Q_local, mScales)
            (grad,) = torch.autograd.grad(energy, pos)
        return energy.detach(), grad

    def _fixed_metrics(self, positions, box, pairs, Q_local, mScales):
        with torch.no_grad():
            total, terms = self._fixed_terms(positions, box, pairs, Q_local,
                                             mScales, return_terms=True)
        return dict(terms, e_total=total)

    # ------------------------------------------------------------------
    # polarizable path
    # ------------------------------------------------------------------
    def _inputs(self, positions, box, pairs, Q_local, pol, tholes, mScales,
                pScales, dScales):
        f = self._float
        return dict(positions=f(positions), box=f(box),
                    pairs=self._accept_pairs(pairs), Q_local=f(Q_local),
                    pol=f(pol), tholes=f(tholes), mScales=f(mScales),
                    pScales=f(pScales), dScales=f(dScales))

    def energy_fn(self, inp, u_ind, return_terms=False):
        """Total energy at induced dipoles ``u_ind`` (the admp_tpu
        ``energy_fn``)."""
        return energy_pme(
            inp["positions"], inp["box"], inp["pairs"], inp["Q_local"],
            u_ind, inp["pol"], inp["tholes"], inp["mScales"], inp["pScales"],
            inp["dScales"], self.covalent_map, self.axis_type,
            self.axis_indices, self.pme_recip, self._kappa, self.lmax, True,
            self.config, return_terms=return_terms,
            pair_chunk=pair_chunk_for(inp["pairs"]),
            excl_pairs=self._excl_pairs)

    def field(self, u, inp, create_graph=False):
        """dE/du at ``u``: one torch.autograd.grad of the total energy."""
        u_req = u.detach().requires_grad_(True)
        with torch.enable_grad():
            e = self.energy_fn(inp, u_req)
            (g,) = torch.autograd.grad(e, u_req, create_graph=create_graph)
        return g

    _MATVEC_KEYS = ("positions", "box", "pol", "tholes", "pScales")

    def _matvec_fn(self, pairs):
        def matvec(v, theta, create_graph):
            positions, box, pol, tholes, p_scales = theta
            v_req = v.detach().requires_grad_(True)
            with torch.enable_grad():
                e = self.energy_uu(positions, box, pairs, v_req, pol, tholes,
                                   p_scales)
                (g,) = torch.autograd.grad(e, v_req, create_graph=create_graph)
            return g

        return matvec

    def _energy_and_aux(self, inp, U_init, return_terms=False, W_init=None):
        """Energy at the converged dipoles (with the autograd graph to any
        input that requires grad) and (u*, converged, n_iter, w). ``W_init``
        (the carried ``W_adj``) engages the warm-started adjoint where the
        configuration asks for it; without it the adjoint is cold and ``w``
        is zeros, as admp_tpu's energy-only surfaces run it."""
        u0 = (self.U_ind if U_init is None else self._float(U_init)).detach()
        matvec_fn = self._matvec_fn(inp["pairs"])
        theta = [inp[k] for k in self._MATVEC_KEYS]
        scf = self.scf_config
        inp_d = {k: v.detach() for k, v in inp.items()}
        # the warm-start field and the solve; the energy pass stays outside
        with profiling.span("scf.solve", composite=True):
            # the Jacobi method iterates on A u = b from b = -field(0)
            rhs = (-self.field(torch.zeros_like(u0), inp_d)
                   if scf.method == "jacobi" else None)
            if scf.exact_adjoint:
                if W_init is None and scf.adjoint_warmstart:
                    scf = dataclasses.replace(scf, adjoint_warmstart=False)
                r0 = -self.field(u0, inp, create_graph=True)
                u_star, conv, n_it, w = solver.solve_implicit(
                    r0, u0, inp["pol"], matvec_fn, scf, theta, rhs=rhs,
                    w_init=W_init)
            else:
                # FH cut: the solve contributes no gradient
                theta_d = [t.detach() for t in theta]
                r0 = -self.field(u0, inp_d)
                u_star, conv, n_it, _ = solver.solve(
                    lambda v: matvec_fn(v, theta_d, False), r0, u0,
                    inp["pol"], scf, rhs)
                w = torch.zeros_like(u0)
        out = self.energy_fn(inp, u_star, return_terms=return_terms)
        return out, (u_star.detach(), conv, n_it, w)

    @profiling.traced("pme.energy", composite=True)
    def _pol_energy(self, positions, box, pairs, Q_local, pol, tholes,
                    mScales, pScales, dScales, U_init=None):
        inp = self._inputs(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales)
        energy, (u, conv, n_it, _) = self._energy_and_aux(inp, U_init)
        self.U_ind, self.lconverg, self.n_cycle = u, conv, n_it
        return energy

    @profiling.traced("pme.energy", composite=True)
    def _pol_forces(self, positions, box, pairs, Q_local, pol, tholes,
                    mScales, pScales, dScales, U_init=None):
        """(energy, dE/dpositions); carries ``U_ind`` and, under
        ``adjoint_warmstart``, the adjoint warm start ``W_adj`` to the next
        call (admp_tpu/models/pme.py:1050-1065)."""
        inp = self._inputs(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales)
        inp["positions"] = inp["positions"].detach().requires_grad_(True)
        with torch.enable_grad():
            energy, (u, conv, n_it, w) = self._energy_and_aux(
                inp, U_init, W_init=self.W_adj)
            (grad,) = torch.autograd.grad(energy, inp["positions"])
        self.U_ind, self.lconverg, self.n_cycle = u, conv, n_it
        self.W_adj = w
        return energy.detach(), grad

    def _pol_metrics(self, positions, box, pairs, Q_local, pol, tholes,
                     mScales, pScales, dScales, U_init=None):
        """Term energies at the converged dipoles plus SCF diagnostics."""
        inp = self._inputs(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales)
        inp = {k: v.detach() for k, v in inp.items()}
        (total, terms), (u, conv, n_it, _) = self._energy_and_aux(
            inp, U_init, return_terms=True)
        terms = {k: v.detach() for k, v in terms.items()}
        return dict(terms, e_total=total.detach(), scf_converged=conv,
                    scf_iters=n_it)

    def optimize_Uind(self, positions, box, pairs, Q_local, pol, tholes,
                      mScales, pScales, dScales, U_init=None):
        """Converge the induced dipoles only; returns (U, converged,
        n_iterations). Starts from zero unless ``U_init`` is given."""
        inp = self._inputs(positions, box, pairs, Q_local, pol, tholes,
                           mScales, pScales, dScales)
        inp = {k: v.detach() for k, v in inp.items()}
        if U_init is None:
            U_init = torch.zeros_like(self.U_ind)
        _, aux = self._energy_and_aux(inp, U_init)
        return aux[:3]
