"""Reciprocal-space PME: B-spline multipole spreading, 3D FFT, influence
convolution (admp_tpu/ops/reciprocal.py).

E = prefactor sum_k C(|k|^2) |S_k|^2 / theta_k^2 with S_k = FFT(Q_mesh), over
the rfft half-spectrum with Hermitian multiplicity weights. The spread runs
on a CUDA kernel pair of ops/cuda/spread.py (K4/K6, or K5/K7 for a mesh
larger than the card's L2) or on ``index_add_`` (``spread_method``,
``resolve_spread_method``). The electrostatic engine (``make_pme_recip``)
spreads one multipolar channel and excludes the gamma point; the dispersion
engine (``make_disp_pme_recip``) spreads the C6/C8/C10 channels in one pass
and includes it.

The precision modes of the electrostatic engine (admp_tpu/ops/reciprocal.py
:45-100, 349-378, 777-948): ``spread_precision='f64'`` evaluates the spline
weights in float64 and rounds the stencil values to the working dtype before
the spread (K4/K6 on a float32 CUDA mesh); ``recip_precision='f64'`` and
``'f64-dft'`` accumulate a float64 mesh (``index_add_``: the kernels are
float32 only, as admp_tpu's f64 mode leaves its slab kernel) and transform it
with the native float64 FFT, or with explicit-matmul DFTs; ``'ds'`` is the
double-single engine of ops/dsrecip.py. admp_tpu splits a float64 mesh into
hi/lo float32 FFTs off the CPU because the TPU has no float64 FFT; the card
has one, so the port always takes it, and keeps the split
(``spectrum_sq(..., force_split=True)``) for the tests.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from admp_tpu_torch.ops import bsplines
from admp_tpu_torch.ops.cuda import spread as spread_ops
from admp_tpu_torch.ops.cuda import SPREAD_METHODS, use_kernel
from admp_tpu_torch.utils import profiling
from admp_tpu_torch.utils.accmath import compensated_sum
from admp_tpu_torch.utils.devconst import device_constant, device_values
from admp_tpu_torch.utils.linalg3 import det3x3, inv3x3

RT3 = 1.7320508075688772

# Separable-term derivative multi-indices (d^p/dux^p, d^q/duy^q, d^r/duz^r):
# order 0, the three first derivatives, the six second derivatives.
_SEP_TERMS = [
    (0, 0, 0),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
]


def _term_index(n_terms: int, device):
    """(3, n_terms) int64: each separable term's derivative order along x,
    y and z (``_SEP_TERMS``), kept on ``device`` (utils/devconst)."""
    key = ("sep_terms", n_terms)
    return device_constant(key, lambda: [[t[c] for t in _SEP_TERMS[:n_terms]]
                                         for c in range(3)],
                           torch.int64, device)


def mesh_coordinates(positions, box, grid_shape, order: int = bsplines.ORDER):
    """Map positions to mesh space.

    Returns (m_u0 (N, 3) int32 base mesh index, u0 (N, 3) fractional offsets
    in [order/2, order/2 + 1), dug_dx (3, 3) Jacobian N_j invbox[c, j])."""
    n = device_values(grid_shape, positions.dtype, positions.device)
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
    index = _term_index(n_terms, tab.device)
    x, y, z = (tab[:, index[c], :, c] for c in range(3))  # (N, T, order)
    ax = alpha[:, :, None] * x
    xy = (ax[:, :, :, None] * y[:, :, None, :]).reshape(n, n_terms,
                                                        order * order)
    q_points = torch.einsum("atp,atk->apk", xy, z)  # (N, order^2, order)
    return q_points.reshape(n, order, order, order)


def atom_spread_alpha(positions, box, q_harm, grid_shape, lmax: int,
                      order: int = 6, precision: str | None = None):
    """(m_u0, u0, alpha): base mesh index, fractional offsets, and the
    separable-term coefficients alpha = q @ spread_mixing_matrix (with the
    MPID quadrupole 1/3 applied); ``precision='f64'`` evaluates them in
    float64."""
    if precision == "f64":
        f64 = torch.float64
        positions, box, q_harm = (positions.to(f64), box.to(f64),
                                  q_harm.to(f64))
    m_u0, u0, dug_dx = mesh_coordinates(positions, box, grid_shape, order)
    q = q_harm[:, : (lmax + 1) ** 2]
    if lmax >= 2:
        q = torch.cat([q[:, :4], q[:, 4:9] / 3.0], dim=-1)
    alpha = q @ spread_mixing_matrix(dug_dx, lmax)
    return m_u0, u0, alpha


def auto_spread_route(dtype, device_type: str, order: int, mesh_bytes: int,
                      l2_bytes: int) -> str:
    """The route ``'auto'`` takes: a pure function of the working type, the
    device type, the B-spline order, the mesh's bytes and the card's L2.

    A float32 CUDA mesh of order 6 goes to a kernel pair: K4/K6 while the
    mesh fits L2 (their atomics and reads hit it), the tiled K5/K7 once it
    does not (the 98k-atom box: 67 MB at 256^3, 131 MB at 320^3, against
    the H100's 50 MB). This is the card's counterpart of admp_tpu's rule,
    which leaves the 1-D slab kernel for the 2-D blocked one when the slab
    accumulator no longer fits VMEM (reciprocal.py:449-464). Every other
    mesh, the order-4 matvec mesh among them, stays on ``index_add_`` as it
    stays on the XLA scatter there."""
    if device_type != "cuda" or dtype != torch.float32 or order != 6:
        return "torch"
    return "cuda2d" if mesh_bytes > l2_bytes else "cuda"


def resolve_spread_method(method: str, x, order: int, grid_shape,
                          n_ch: int = 1) -> str:
    """The route of a spread of ``x``'s stencils onto an (n_ch, *grid_shape)
    mesh: ``'auto'`` by auto_spread_route (the L2 size read from the card),
    ``'cuda'`` (K4/K6) and ``'cuda2d'`` (K5/K7) forced, raising for a tensor
    the kernels cannot take, ``'torch'`` the plain path."""
    if method == "auto":
        if not x.is_cuda:
            return "torch"
        l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
        mesh_bytes = n_ch * math.prod(grid_shape) * x.element_size()
        return auto_spread_route(x.dtype, x.device.type, order, mesh_bytes,
                                 l2)
    use_kernel(method, x, "spread_method", SPREAD_METHODS)
    return method


# admp_tpu's atom chunk on the plain scatter (reciprocal.py:913): blocks of
# 4096 atoms above 16384; the kernel routes take every atom in one launch
ATOM_CHUNK, ATOM_CHUNK_ABOVE = 4096, 16384


def spread_to_mesh(positions, box, q_harm, grid_shape, lmax: int,
                   method: str = "auto", order: int = 6,
                   atom_chunk: int | None = None,
                   precision: str | None = None, mesh_dtype=None):
    """Spread harmonic multipoles onto the (K1, K2, K3) charge mesh;
    quadrupole channels carry the MPID 1/3 prefactor. ``atom_chunk``: on the
    plain route, accumulate the mesh over blocks of that many atoms, which
    bounds the (N, order^3) stencil intermediates (admp_tpu's kernel paths
    ignore it, and so do the port's).

    ``precision='f64'``: the spline-weight pipeline in float64, its stencil
    values rounded to the mesh dtype before the spread. ``mesh_dtype``: the
    mesh's dtype (default the working dtype of ``q_harm``); the route is
    resolved for it, so a float64 mesh takes ``index_add_`` under 'auto'."""
    grid_shape = tuple(int(k) for k in grid_shape)
    work_dtype = mesh_dtype or q_harm.dtype
    route = resolve_spread_method(
        method, q_harm.new_empty(0, dtype=work_dtype), order, grid_shape)
    n = positions.shape[0]
    if route == "torch" and atom_chunk is not None and n > atom_chunk:
        return sum(spread_to_mesh(positions[a:a + atom_chunk], box,
                                  q_harm[a:a + atom_chunk], grid_shape, lmax,
                                  "torch", order, None, precision, mesh_dtype)
                   for a in range(0, n, atom_chunk))
    m_u0, u0, alpha = atom_spread_alpha(positions, box, q_harm, grid_shape,
                                        lmax, order, precision)
    q_points = spread_points_separable(u0, alpha, lmax, order).to(work_dtype)
    mesh = spread_ops.spread_route(
        m_u0, q_points.reshape(n, 1, order ** 3), grid_shape, order, route)
    return mesh[0]


def spread_to_mesh_multi(positions, box, coeffs, grid_shape, order: int = 6,
                         method: str = "auto"):
    """Spread C scalar channels (``coeffs`` (N, C)) over one B-spline
    geometry onto a (C, K1, K2, K3) mesh, channel axis leading: the
    dispersion C6/C8/C10 grids in one pass.

    The stencil is theta (N, order^3), z fastest, times each channel's
    coefficient: the (N, C, order^3) values K4 takes. ``'auto'`` takes the
    kernel K4 for float32 CUDA tensors at orders 4 and 6 alike, as admp_tpu's
    multi-channel 'auto' takes its Pallas slab kernel at either order
    (reciprocal.py:552-557); the single-channel order-6 rule of
    ``resolve_spread_method`` does not apply here. ``'cuda2d'`` takes the
    tiled K5."""
    grid_shape = tuple(int(k) for k in grid_shape)
    m_u0, q_points = multi_stencil(positions, box, coeffs, grid_shape, order)
    return spread_ops.spread(m_u0, q_points, grid_shape, order, method)


def multi_stencil(positions, box, coeffs, grid_shape, order: int = 6):
    """(m_u0 (N, 3), q_points (N, C, order^3)): the base mesh indices and
    each channel's stencil values theta * coeffs, theta's points ordered
    (x, y, z) with z fastest, offsets -order/2 .. order/2 - 1."""
    n = positions.shape[0]
    m_u0, u0, _ = mesh_coordinates(positions, box, grid_shape, order)
    m = bsplines.spline_values(u0, order)  # (N, order, 3)
    txy = (m[:, :, None, 0] * m[:, None, :, 1]).reshape(n, order * order)
    theta = (txy[:, :, None] * m[:, None, :, 2]).reshape(n, order ** 3)
    return m_u0, theta[:, None, :] * coeffs[:, :, None]


def spectrum_sq(mesh, force_split: bool = False):
    """|FFT(mesh)|^2 over the rfft half-spectrum of the last three axes, in
    ``mesh.dtype``. ``force_split`` (float64 mesh): admp_tpu's TPU path,
    the FFTs of the hi and lo float32 halves summed in float64 (the FFT is
    linear); otherwise the native FFT of the mesh's dtype."""
    dims = (-3, -2, -1)
    if mesh.dtype == torch.float64 and force_split:
        hi32 = mesh.to(torch.float32)
        lo32 = (mesh - hi32.to(mesh.dtype)).to(torch.float32)
        sh = torch.fft.rfftn(hi32, dim=dims)
        sl = torch.fft.rfftn(lo32, dim=dims)
        re = sh.real.to(mesh.dtype) + sl.real.to(mesh.dtype)
        im = sh.imag.to(mesh.dtype) + sl.imag.to(mesh.dtype)
        return re * re + im * im
    s_k = torch.fft.rfftn(mesh, dim=dims)
    return s_k.real * s_k.real + s_k.imag * s_k.imag


def _dft_mats(k: int, n_out: int, like):
    """Real cos/sin DFT matrices C[m, c] = cos(2 pi m c / k), S = sin, in
    ``like``'s dtype, kept on its device (utils/devconst)."""

    def make(f):
        m = np.arange(n_out)[:, None]
        c = np.arange(k)[None, :]
        return f(2.0 * np.pi * (m * c % k) / k)

    return tuple(device_constant(("dft." + f.__name__, k, n_out),
                                 lambda f=f: make(f), like.dtype, like.device)
                 for f in (np.cos, np.sin))


def spectrum_sq_dft(mesh):
    """|DFT(mesh)|^2 over the rfft half-spectrum by explicit-matmul DFTs
    in the mesh's dtype (O(K^4)): recip_precision='f64-dft'."""
    k1, k2, k3 = mesh.shape
    c3, s3 = _dft_mats(k3, k3 // 2 + 1, mesh)
    re = torch.einsum("abc,kc->abk", mesh, c3)
    im = -torch.einsum("abc,kc->abk", mesh, s3)
    # e^{-i t}(R + i I) = (R cos + I sin) + i(I cos - R sin)
    c2, s2 = _dft_mats(k2, k2, mesh)
    mid = lambda a, m: torch.einsum("abk,mb->amk", a, m)  # noqa: E731
    re, im = mid(re, c2) + mid(im, s2), mid(im, c2) - mid(re, s2)
    c1, s1 = _dft_mats(k1, k1, mesh)
    lead = lambda a, m: torch.einsum("amk,na->nmk", a, m)  # noqa: E731
    re, im = lead(re, c1) + lead(im, s1), lead(im, c1) - lead(re, s1)
    return re * re + im * im


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
    (and the Nyquist plane for even K3) once, every other mode twice; kept
    on ``device`` (utils/devconst), read only."""

    def make():
        w = np.full(k3 // 2 + 1, 2.0)
        w[0] = 1.0
        if k3 % 2 == 0:
            w[-1] = 1.0
        return w

    return device_constant(("hermitian", int(k3)), make, dtype, device)


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


def convolve_energy(mesh, weight, prefactor=1.0, compensated: bool = False,
                    dft: bool = False):
    """E = prefactor sum_k weight_k |S_k|^2 (Parseval over the half-spectrum);
    ``dft``: the spectrum by explicit-matmul DFTs (spectrum_sq_dft)."""
    s_sq = spectrum_sq_dft(mesh) if dft else spectrum_sq(mesh)
    terms = weight.to(mesh.dtype) * s_sq
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
                   static_box=None, spread_order: int = 6,
                   spread_precision: str | None = None,
                   recip_precision: str | None = None):
    """Build a reciprocal-space energy function (positions, box, Q) -> energy
    (admp_tpu's ``make_pme_recip`` without the gamma point), returned in the
    dtype of Q.

    ``static_box``: fixed-cell fast path; the influence grid is computed once
    (in the box tensor's dtype and device, float64 under the f64 modes) and
    the per-step convolution is FFT + multiply-and-sum. Box gradients through
    it are then zero, with a warning (see _CachedInfluenceBoxGuard).

    ``spread_precision='f64'``: float64 spline weights (spread_to_mesh).
    ``recip_precision``: ``'f64'`` a float64 mesh, FFT, influence and
    Parseval sum (implies the f64 spread weights); ``'f64-dft'`` the same
    with explicit-matmul DFTs; ``'ds'`` the double-single engine
    (ops/dsrecip.py, power-of-two grids), which merges induced dipoles into
    the dipole channels of one lmax >= 1 mesh.
    """
    grid_shape = tuple(int(k) for k in grid_shape)
    if recip_precision == "ds":
        return _make_ds_recip(kappa, grid_shape, lmax, prefactor, static_box)
    f64_mode = recip_precision in ("f64", "f64-dft")
    mesh_dtype = None
    if f64_mode:
        spread_precision = "f64"
        mesh_dtype = torch.float64
        if spread_method in ("cuda", "cuda2d"):
            spread_method = "torch"  # the kernels are float32 only
    cached = None
    if static_box is not None:
        cached = influence_weights(static_box, grid_shape, kappa, ck_fn,
                                   spread_order, dtype=mesh_dtype)

    @profiling.traced("reciprocal")
    def pme_recip(positions, box, q_harm, u_harm=None):
        """``u_harm`` (N, 3, harmonic z/x/y order): induced dipoles spread on
        an lmax=1 mesh and added (spreading is linear)."""
        if cached is not None:
            box = _CachedInfluenceBoxGuard.apply(box)
        atom_chunk = (ATOM_CHUNK if positions.shape[0] > ATOM_CHUNK_ABOVE
                      else None)
        mesh = spread_to_mesh(positions, box, q_harm, grid_shape, lmax,
                              spread_method, spread_order, atom_chunk,
                              spread_precision, mesh_dtype)
        if u_harm is not None:
            q_u = torch.cat([u_harm.new_zeros(u_harm.shape[0], 1), u_harm],
                            dim=-1)
            mesh = mesh + spread_to_mesh(positions, box, q_u, grid_shape, 1,
                                         spread_method, spread_order,
                                         atom_chunk, spread_precision,
                                         mesh_dtype)
        weight = cached if cached is not None else influence_weights(
            box, grid_shape, kappa, ck_fn, spread_order, dtype=mesh.dtype)
        energy = convolve_energy(mesh, weight, prefactor, compensated,
                                 dft=recip_precision == "f64-dft")
        return energy.to(q_harm.dtype)

    return pme_recip


def _make_ds_recip(kappa, grid_shape, lmax, prefactor, static_box):
    """recip_precision='ds' (admp_tpu/ops/reciprocal.py:859-888): the DS
    engine at lmax, and for induced dipoles beside charges (lmax 0) one at
    lmax 1 whose dipole channels carry them: spreading is linear, so one
    mesh holds both."""
    from admp_tpu_torch.ops.dsrecip import make_ds_pme_recip

    engines = {lmax: make_ds_pme_recip(kappa, grid_shape, lmax, prefactor,
                                       static_box=static_box)}

    @profiling.traced("reciprocal")
    def ds_recip(positions, box, q_harm, u_harm=None):
        if u_harm is None:
            e = engines[lmax](positions, box, q_harm)
        else:
            lm = max(lmax, 1)
            if lm not in engines:
                engines[lm] = make_ds_pme_recip(kappa, grid_shape, lm,
                                                prefactor,
                                                static_box=static_box)
            q4 = u_harm.new_zeros(q_harm.shape[0], (lm + 1) ** 2)
            q4 = torch.cat([q_harm.to(u_harm.dtype),
                            q4[:, q_harm.shape[1]:]], dim=1)
            q4 = torch.cat([q4[:, :1], q4[:, 1:4] + u_harm, q4[:, 4:]], dim=1)
            e = engines[lm](positions, box, q4)
        return e.to(q_harm.dtype)

    return ds_recip


def _multi_weights(box, grid_shape, kappa, ck_fns, order, include_gamma):
    return torch.stack([influence_weights(box, grid_shape, kappa, ck_fn, order,
                                          include_gamma) for ck_fn in ck_fns])


def convolve_energy_multi(meshes, box, kappa, ck_fns, include_gamma: bool,
                          prefactor=1.0, order: int = 6):
    """E = prefactor sum_c sum_k C_c(k^2) |S_c,k|^2 / theta_k^2 for
    channel-stacked (C, K1, K2, K3) meshes, one batched rfft."""
    weights = _multi_weights(box.to(meshes.dtype), tuple(meshes.shape[1:]),
                             kappa, ck_fns, order, include_gamma)
    return prefactor * torch.sum(weights * spectrum_sq(meshes))


def make_disp_pme_recip(ck_fns, kappa, grid_shape, static_box=None,
                        spread_order: int = 6, spread_method: str = "auto"):
    """Multi-channel dispersion reciprocal engine (positions, box, c_list)
    -> energy: one spread of the len(ck_fns) leading columns of c_list, one
    batched FFT, the gamma point included.

    ``static_box``: fixed-cell fast path; the influence grids are computed
    once (in the box tensor's dtype and device) and box gradients through
    the engine are zero, with a warning (_CachedInfluenceBoxGuard)."""
    grid_shape = tuple(int(k) for k in grid_shape)
    ck_fns = tuple(ck_fns)
    cached = None
    if static_box is not None:
        cached = _multi_weights(static_box, grid_shape, kappa, ck_fns,
                                spread_order, True)

    def disp_recip(positions, box, c_list):
        if cached is not None:
            box = _CachedInfluenceBoxGuard.apply(box)
        meshes = spread_to_mesh_multi(positions, box, c_list[:, :len(ck_fns)],
                                      grid_shape, spread_order, spread_method)
        if cached is not None:
            return torch.sum(cached.to(meshes.dtype) * spectrum_sq(meshes))
        return convolve_energy_multi(meshes, box, kappa, ck_fns, True,
                                     order=spread_order)

    return disp_recip
