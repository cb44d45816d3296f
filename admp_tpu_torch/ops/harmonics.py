"""Multipole representations: Cartesian <-> real spherical harmonics, and frame
rotations (admp_tpu/ops/harmonics.py).

Conventions (shared with admp_tpu and its force-field files):
  Cartesian order:  [c0, dX, dY, dZ, qXX, qYY, qZZ, qXY, qXZ, qYZ]
  Harmonic order:   [Q00, Q10(z), Q11c(x), Q11s(y), Q20, Q21c, Q21s, Q22c, Q22s]
Frames have the local axes in rows: ``v_local = R @ v_global``.
"""

from __future__ import annotations

import numpy as np
import torch

RT3 = 1.73205080757  # sqrt(3), truncated as in admp_tpu/ops/harmonics.py


def _cart2harm_matrix(lmax: int) -> np.ndarray:
    """Constant (n_harm, n_cart) conversion matrix."""
    n_harm = (lmax + 1) ** 2
    n_cart = {0: 1, 1: 4, 2: 10}[lmax]
    m = np.zeros((n_harm, n_cart))
    m[0, 0] = 1.0
    if lmax >= 1:
        m[1, 3] = 1.0
        m[2, 1] = 1.0
        m[3, 2] = 1.0
    if lmax >= 2:
        inv_rt3 = 1.0 / RT3
        m[4, 6] = 1.0
        m[5, 8] = 2.0 * inv_rt3
        m[6, 9] = 2.0 * inv_rt3
        m[7, 4] = inv_rt3
        m[7, 5] = -inv_rt3
        m[8, 7] = 2.0 * inv_rt3
    return m


def convert_cart2harm(theta, lmax: int):
    """(..., n_cart) Cartesian multipoles -> (..., (lmax+1)**2) harmonics;
    trailing components beyond what ``lmax`` needs are ignored."""
    if lmax > 2:
        raise NotImplementedError("l > 2 (beyond quadrupole) not supported")
    n_cart = {0: 1, 1: 4, 2: 10}[lmax]
    mat = torch.as_tensor(_cart2harm_matrix(lmax), dtype=theta.dtype,
                          device=theta.device)
    return theta[..., :n_cart] @ mat.T


def rotate_harm_components(q, f, lmax: int):
    """Rotate harmonic components by frames, all in component form.

    ``q``: sequence of harmonic components (each a tensor of one shape);
    ``f``: 9-tuple of frame entries (fxx..fzz, rows = local x, y, z axes).
    Returns a tuple of the rotated components.
    """
    fxx, fxy, fxz, fyx, fyy, fyz, fzx, fzy, fzz = f
    out = [q[0]]
    if lmax >= 1:
        cx, cy, cz = q[2], q[3], q[1]
        lx = fxx * cx + fxy * cy + fxz * cz
        ly = fyx * cx + fyy * cy + fyz * cz
        lz = fzx * cx + fzy * cy + fzz * cz
        out += [lz, lx, ly]
    if lmax >= 2:
        q20, q21c, q21s, q22c, q22s = q[4], q[5], q[6], q[7], q[8]
        h = RT3 / 2.0
        txx = -0.5 * q20 + h * q22c
        tyy = -0.5 * q20 - h * q22c
        tzz = q20
        txy = h * q22s
        txz = h * q21c
        tyz = h * q21s
        # T' = F T F^T via u[a] = F[a] . T (T symmetric)
        ux_x = fxx * txx + fxy * txy + fxz * txz
        ux_y = fxx * txy + fxy * tyy + fxz * tyz
        ux_z = fxx * txz + fxy * tyz + fxz * tzz
        uy_x = fyx * txx + fyy * txy + fyz * txz
        uy_y = fyx * txy + fyy * tyy + fyz * tyz
        uy_z = fyx * txz + fyy * tyz + fyz * tzz
        uz_x = fzx * txx + fzy * txy + fzz * txz
        uz_y = fzx * txy + fzy * tyy + fzz * tyz
        uz_z = fzx * txz + fzy * tyz + fzz * tzz
        tpxx = ux_x * fxx + ux_y * fxy + ux_z * fxz
        tpyy = uy_x * fyx + uy_y * fyy + uy_z * fyz
        tpzz = uz_x * fzx + uz_y * fzy + uz_z * fzz
        tpxy = ux_x * fyx + ux_y * fyy + ux_z * fyz
        tpxz = ux_x * fzx + ux_y * fzy + ux_z * fzz
        tpyz = uy_x * fzx + uy_y * fzy + uy_z * fzz
        inv = 2.0 / RT3
        out += [tpzz, inv * tpxz, inv * tpyz, (tpxx - tpyy) / RT3,
                inv * tpxy]
    return tuple(out)


def cart_dipole_to_harm(u_cart):
    """Cartesian dipoles (x, y, z) -> harmonic order (z, x, y)."""
    return torch.stack([u_cart[..., 2], u_cart[..., 0], u_cart[..., 1]], dim=-1)


def rot_local2global_components(q_local, frame_comps, lmax: int = 2):
    """Local -> global rotation via frame components
    (ops/frames.local_frames_components): rotates with F^T and restacks to an
    (N, H) tensor."""
    f = frame_comps
    ft = (f[0], f[3], f[6], f[1], f[4], f[7], f[2], f[5], f[8])
    q_comps = tuple(q_local[..., k] for k in range((lmax + 1) ** 2))
    return torch.stack(rotate_harm_components(q_comps, ft, lmax), dim=-1)
