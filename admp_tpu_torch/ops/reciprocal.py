"""Reciprocal-space PME: B-spline multipole spreading, 3D FFT, influence
convolution (admp_tpu/ops/reciprocal.py, plain precision only).

E = prefactor sum_k C(|k|^2) |S_k|^2 / theta_k^2 with S_k = FFT(Q_mesh), over
the rfft half-spectrum with Hermitian multiplicity weights. The spread runs
on the CUDA kernel pair of ops/cuda/spread.py or on ``index_add_``
(``spread_method``).
"""

from __future__ import annotations

import math
import warnings

import torch

from admp_tpu_torch.ops import bsplines
from admp_tpu_torch.ops.cuda import spread as spread_ops
from admp_tpu_torch.ops.cuda import use_kernel
from admp_tpu_torch.utils.accmath import compensated_sum
from admp_tpu_torch.utils.linalg3 import det3x3, inv3x3

RT3 = 1.7320508075688772

# Separable-term derivative multi-indices (d^p/dux^p, d^q/duy^q, d^r/duz^r):
# order 0, the three first derivatives, the six second derivatives.
_SEP_TERMS = [
    (0, 0, 0),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
]


def mesh_coordinates(positions, box, grid_shape, order: int = bsplines.ORDER):
    """Map positions to mesh space.

    Returns (m_u0 (N, 3) int32 base mesh index, u0 (N, 3) fractional offsets
    in [order/2, order/2 + 1), dug_dx (3, 3) Jacobian N_j invbox[c, j])."""
    n = torch.as_tensor(grid_shape, dtype=positions.dtype,
                        device=positions.device)
    box_inv = inv3x3(box)
    r_in_m = (positions @ box_inv) * n
    m_f = torch.ceil(r_in_m).detach()
    u0 = (m_f - r_in_m) + order / 2
    dug_dx = (box_inv * n[None, :]).T
    return m_f.to(torch.int32), u0, dug_dx


def spread_mixing_matrix(dug_dx, lmax: int):
    """(n_harm, n_terms) matrix M with W_h = sum_t M[h, t] T_t, T_t the
    separable spline-derivative stencils of ``_SEP_TERMS``: the
    atom-independent Cartesian chain rule of the harmonic spread weights."""
    dug = dug_dx
    one = torch.ones((), dtype=dug.dtype, device=dug.device)
    zero = torch.zeros((), dtype=dug.dtype, device=dug.device)
    cols = [[one] + [zero] * ((lmax + 1) ** 2 - 1)]
    if lmax >= 1:
        for j in range(3):
            col = [zero, -dug[j, 2], -dug[j, 0], -dug[j, 1]]
            if lmax >= 2:
                col += [zero] * 5
            cols.append(col)
    if lmax >= 2:
        for (j, l) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
            def beta(c, d):
                b = dug[j, c] * dug[l, d]
                if j != l:
                    b = b + dug[l, c] * dug[j, d]
                return b
            b00, b11, b22 = beta(0, 0), beta(1, 1), beta(2, 2)
            cols.append([zero, zero, zero, zero,
                         (3.0 * b22 - (b00 + b11 + b22)) / 2.0,
                         RT3 * beta(0, 2),
                         RT3 * beta(1, 2),
                         RT3 / 2.0 * (b00 - b11),
                         RT3 * beta(0, 1)])
    return torch.stack([torch.stack(c) for c in cols], dim=-1)  # (H, T)


def spread_points_separable(u0, alpha, lmax: int, order: int = 6):
    """Per-atom order^3 stencil values Q[a] = sum_t alpha[a, t] T_t[a]."""
    n = u0.shape[0]
    tabs = [bsplines.spline_values(u0, order)]
    if lmax >= 1:
        tabs.append(bsplines.spline_derivs(u0, order))
    if lmax >= 2:
        tabs.append(bsplines.spline_derivs2(u0, order))
    tab = torch.stack(tabs, dim=1)  # (N, lmax+1, order, 3)
    n_terms = alpha.shape[-1]
    terms = _SEP_TERMS[:n_terms]
    x = tab[:, [t[0] for t in terms], :, 0]  # (N, T, order)
    y = tab[:, [t[1] for t in terms], :, 1]
    z = tab[:, [t[2] for t in terms], :, 2]
    ax = alpha[:, :, None] * x
    xy = (ax[:, :, :, None] * y[:, :, None, :]).reshape(n, n_terms,
                                                        order * order)
    q_points = torch.einsum("atp,atk->apk", xy, z)  # (N, order^2, order)
    return q_points.reshape(n, order, order, order)


def atom_spread_alpha(positions, box, q_harm, grid_shape, lmax: int,
                      order: int = 6):
    """(m_u0, u0, alpha): base mesh index, fractional offsets, and the
    separable-term coefficients alpha = q @ spread_mixing_matrix (with the
    MPID quadrupole 1/3 applied)."""
    m_u0, u0, dug_dx = mesh_coordinates(positions, box, grid_shape, order)
    q = q_harm[:, : (lmax + 1) ** 2]
    if lmax >= 2:
        q = torch.cat([q[:, :4], q[:, 4:9] / 3.0], dim=-1)
    alpha = q @ spread_mixing_matrix(dug_dx, lmax)
    return m_u0, u0, alpha


def resolve_spread_method(method: str, x, order: int) -> str:
    """``'auto'`` takes the kernel for the order-6 mesh of a float32 CUDA
    tensor and ``index_add_`` otherwise; admp_tpu's 'auto' leaves the order-4
    matvec mesh on the XLA scatter the same way (reciprocal.py:449-464)."""
    if method == "auto" and order != 6:
        return "torch"
    return "cuda" if use_kernel(method, x, "spread_method") else "torch"


def spread_to_mesh(positions, box, q_harm, grid_shape, lmax: int,
                   method: str = "auto", order: int = 6):
    """Spread harmonic multipoles onto the (K1, K2, K3) charge mesh;
    quadrupole channels carry the MPID 1/3 prefactor."""
    grid_shape = tuple(int(k) for k in grid_shape)
    m_u0, u0, alpha = atom_spread_alpha(positions, box, q_harm, grid_shape,
                                        lmax, order)
    q_points = spread_points_separable(u0, alpha, lmax, order)
    n = q_points.shape[0]
    mesh = spread_ops.spread(
        m_u0, q_points.reshape(n, 1, order ** 3), grid_shape, order,
        resolve_spread_method(method, q_points, order))
    return mesh[0]


def spectrum_sq(mesh):
    """|FFT(mesh)|^2 over the rfft half-spectrum."""
    s_k = torch.fft.rfftn(mesh)
    return s_k.real * s_k.real + s_k.imag * s_k.imag


def _fft_int_freqs(n: int, dtype, device):
    """Integer FFT frequencies [0, 1, ..., -1] in fftn output order."""
    a = torch.arange(n, device=device)
    return torch.where(a <= n // 2 - (1 - n % 2), a, a - n).to(dtype)


def k_space_grids(box, grid_shape, dtype, order: int = 6):
    """(ksq, theta_k_sq) broadcast grids over the rfft half-spectrum (the
    last axis keeps the non-negative frequencies)."""
    k1, k2, k3 = grid_shape
    device = box.device
    box_inv = inv3x3(box).to(dtype)
    f1 = _fft_int_freqs(k1, dtype, device)
    f2 = _fft_int_freqs(k2, dtype, device)
    f3 = torch.arange(k3 // 2 + 1, dtype=dtype, device=device)
    kvec = (
        f1[:, None, None, None] * box_inv[0][None, None, None, :]
        + f2[None, :, None, None] * box_inv[1][None, None, None, :]
        + f3[None, None, :, None] * box_inv[2][None, None, None, :]
    ) * (2.0 * math.pi)
    ksq = torch.sum(kvec * kvec, dim=-1)
    euler = (bsplines.euler_spline_theta4 if order == 4
             else bsplines.euler_spline_theta)
    theta_k = (euler(f1, k1)[:, None, None] * euler(f2, k2)[None, :, None]
               * euler(f3, k3)[None, None, :])
    return ksq, theta_k * theta_k


def _hermitian_weights(k3: int, dtype, device):
    """Multiplicities of rfft modes in the full spectrum: the k3 = 0 plane
    (and the Nyquist plane for even K3) once, every other mode twice."""
    k3h = k3 // 2 + 1
    w = torch.full((k3h,), 2.0, dtype=dtype, device=device)
    w[0] = 1.0
    if k3 % 2 == 0:
        w[k3h - 1] = 1.0
    return w


def influence_weights(box, grid_shape, kappa, ck_fn, order: int = 6):
    """Influence grid C(k^2)/theta_k^2 over the rfft half-spectrum with the
    Hermitian multiplicity folded in, in the box's dtype. The gamma point is
    excluded (electrostatics; the dispersion kernels that include it are
    not ported yet)."""
    ksq, theta_sq = k_space_grids(box, grid_shape, box.dtype, order)
    volume = det3x3(box)
    w3 = _hermitian_weights(grid_shape[2], box.dtype, box.device)
    nonzero = ksq > 0.0
    ksq_safe = torch.where(nonzero, ksq, torch.ones_like(ksq))
    c_k = torch.where(nonzero, ck_fn(ksq_safe, kappa, volume),
                      torch.zeros_like(ksq))
    return c_k / theta_sq * w3[None, None, :]


def convolve_energy(mesh, weight, prefactor=1.0, compensated: bool = False):
    """E = prefactor sum_k weight_k |S_k|^2 (Parseval over the half-spectrum)."""
    terms = weight.to(mesh.dtype) * spectrum_sq(mesh)
    if compensated and terms.dtype == torch.float32:
        return prefactor * compensated_sum(terms)
    return prefactor * terms.sum()


class _CachedInfluenceBoxGuard(torch.autograd.Function):
    """Identity on the box that makes box-differentiation of a
    cache_influence engine loud and consistent (admp_tpu/ops/reciprocal.py
    :688-720): the influence grid is precomputed for a fixed cell, so a box
    gradient would be partial. Its backward warns and returns ZERO."""

    @staticmethod
    def forward(ctx, box):
        return box.clone()

    @staticmethod
    def backward(ctx, g):
        warnings.warn(
            "cache_influence=True: box gradients through this reciprocal "
            "engine are NOT tracked (the influence grid is precomputed for a "
            "fixed cell); the engine contributes ZERO box gradient. Harmless "
            "unless you consume dE/dbox (virial/NPT) - then rebuild with "
            "cache_influence=False.",
            stacklevel=2,
        )
        return torch.zeros_like(g)


def make_pme_recip(ck_fn, kappa, grid_shape, lmax, prefactor=1.0,
                   spread_method: str = "auto", compensated: bool = False,
                   static_box=None, spread_order: int = 6):
    """Build a reciprocal-space energy function (positions, box, Q) -> energy
    (admp_tpu's ``make_pme_recip`` without the gamma point).

    ``static_box``: fixed-cell fast path; the influence grid is computed once
    (in the box tensor's dtype and device) and the per-step convolution is
    FFT + multiply-and-sum. Box gradients through it are then zero, with a
    warning (see _CachedInfluenceBoxGuard).
    """
    grid_shape = tuple(int(k) for k in grid_shape)
    cached = None
    if static_box is not None:
        cached = influence_weights(static_box, grid_shape, kappa, ck_fn,
                                   spread_order)

    def pme_recip(positions, box, q_harm, u_harm=None):
        """``u_harm`` (N, 3, harmonic z/x/y order): induced dipoles spread on
        an lmax=1 mesh and added (spreading is linear)."""
        if cached is not None:
            box = _CachedInfluenceBoxGuard.apply(box)
        mesh = spread_to_mesh(positions, box, q_harm, grid_shape, lmax,
                              spread_method, spread_order)
        if u_harm is not None:
            q_u = torch.cat([u_harm.new_zeros(u_harm.shape[0], 1), u_harm],
                            dim=-1)
            mesh = mesh + spread_to_mesh(positions, box, q_u, grid_shape, 1,
                                         spread_method, spread_order)
        weight = cached if cached is not None else influence_weights(
            box.to(mesh.dtype), grid_shape, kappa, ck_fn, spread_order)
        energy = convolve_energy(mesh, weight, prefactor, compensated)
        return energy.to(q_harm.dtype)

    return pme_recip
