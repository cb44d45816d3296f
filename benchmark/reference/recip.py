"""Plain reciprocal-space PME (B-spline multipole spreading by
``index_add``, 3D FFT, influence convolution), in any float dtype: the
functions of admp_tpu_torch/ops/reciprocal.py's plain route, frozen, with the
kernel routes and the precision modes left out.
"""

from __future__ import annotations

import math

import torch

from . import bsplines
from .constants import DIELECTRIC
from .linalg3 import det3x3, inv3x3

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


def influence_weights(box, grid_shape, kappa, ck_fn, order: int = 6,
                      include_gamma: bool = False, dtype=None):
    """Influence grid C(k^2)/theta_k^2 over the rfft half-spectrum with the
    Hermitian multiplicity folded in, in ``dtype`` (default the box's). The
    gamma point is
    excluded (electrostatics) or, with ``include_gamma`` (dispersion), holds
    the kernel's analytic limit ``ck_fn.at_zero`` / theta_0^2: admp_tpu adds
    that term beside the sum (reciprocal.py:627-629, 676-677); folded into
    the grid it is the same term."""
    if dtype is not None:
        box = box.to(dtype)
    ksq, theta_sq = k_space_grids(box, grid_shape, box.dtype, order)
    volume = det3x3(box)
    w3 = _hermitian_weights(grid_shape[2], box.dtype, box.device)
    nonzero = ksq > 0.0
    ksq_safe = torch.where(nonzero, ksq, torch.ones_like(ksq))
    gamma = (ck_fn.at_zero(kappa, volume) * torch.ones_like(ksq)
             if include_gamma else torch.zeros_like(ksq))
    c_k = torch.where(nonzero, ck_fn(ksq_safe, kappa, volume), gamma)
    return c_k / theta_sq * w3[None, None, :]


def flat_stencil_indices(m_u0, grid_shape, order: int):
    """(N, order^3) flat periodic mesh indices of each atom's stencil, points
    ordered (x, y, z) with z fastest."""
    k1, k2, k3 = grid_shape
    m = m_u0.long()
    offsets = torch.arange(-(order // 2), order // 2, device=m.device)
    i1 = torch.remainder(m[:, 0:1] + offsets[None], k1)
    i2 = torch.remainder(m[:, 1:2] + offsets[None], k2)
    i3 = torch.remainder(m[:, 2:3] + offsets[None], k3)
    flat = (i1[:, :, None, None] * k2 + i2[:, None, :, None]) * k3 \
        + i3[:, None, None, :]
    return flat.reshape(m.shape[0], order ** 3)


def spread_to_mesh(positions, box, q_harm, grid_shape, lmax: int,
                   order: int = 6, atom_chunk: int = 4096):
    """The (K1, K2, K3) mesh of harmonic multipoles ``q_harm`` (quadrupoles
    with the MPID 1/3), accumulated by ``index_add`` over blocks of atoms."""
    kcube = grid_shape[0] * grid_shape[1] * grid_shape[2]
    mesh = q_harm.new_zeros(kcube)
    for a in range(0, positions.shape[0], atom_chunk):
        pos, q = positions[a:a + atom_chunk], q_harm[a:a + atom_chunk]
        m_u0, u0, dug_dx = mesh_coordinates(pos, box, grid_shape, order)
        q = q[:, : (lmax + 1) ** 2]
        if lmax >= 2:
            q = torch.cat([q[:, :4], q[:, 4:9] / 3.0], dim=-1)
        alpha = q @ spread_mixing_matrix(dug_dx, lmax)
        points = spread_points_separable(u0, alpha, lmax, order)
        flat = flat_stencil_indices(m_u0, grid_shape, order)
        mesh = mesh.index_add(0, flat.reshape(-1), points.reshape(-1))
    return mesh.reshape(grid_shape)


def recip_energy(positions, box, q_harm, grid_shape, kappa, lmax: int,
                 weight=None, order: int = 6):
    """DIELECTRIC sum_k C(k^2)/theta_k^2 |S_k|^2 over the rfft half-spectrum
    (gamma point excluded); ``weight`` is a precomputed influence grid."""
    from .influence import ck_1

    mesh = spread_to_mesh(positions, box, q_harm, grid_shape, lmax, order)
    if weight is None:
        weight = influence_weights(box, grid_shape, kappa, ck_1, order)
    s_k = torch.fft.rfftn(mesh, dim=(-3, -2, -1))
    s_sq = s_k.real * s_k.real + s_k.imag * s_k.imag
    return DIELECTRIC * torch.sum(weight.to(mesh.dtype) * s_sq)
