"""Local-frame construction for multipolar sites (admp_tpu/ops/frames.py).

Every axis-type variant is computed for every site and selected with
``torch.where``. Anchor indices may be -1 ("absent"), wrapped with ``mod`` as
Python negative indexing would.

Axis type codes follow MPID/OpenMM:
  ZThenX=0, Bisector=1, ZBisect=2, ThreeFold=3, Zonly=4, NoAxisType=5
"""

from __future__ import annotations

import numpy as np
import torch

from admp_tpu_torch.ops.harmonics import rot_local2global_components
from admp_tpu_torch.utils import profiling
from admp_tpu_torch.utils.linalg3 import inv3x3
from admp_tpu_torch.utils.safety import safe_normalize

ZTHENX = 0
BISECTOR = 1
ZBISECT = 2
THREEFOLD = 3
ZONLY = 4
NOAXISTYPE = 5


def _soa_normalize(vx, vy, vz, eps=1e-12):
    """Normalize component triples; ~zero vectors map to zero (double-where,
    so the gradient stays finite)."""
    nsq = vx * vx + vy * vy + vz * vz
    small = nsq < eps
    ninv = torch.where(
        small, torch.zeros_like(nsq),
        1.0 / torch.sqrt(torch.where(small, torch.ones_like(nsq), nsq)),
    )
    return vx * ninv, vy * ninv, vz * ninv


def local_frames_components(positions, box, axis_types, axis_indices):
    """Per-site local frames as 9 flat (N,) tensors (fxx, fxy, fxz, fyx, ...,
    fzz); rows are the local (x, y, z) axes."""
    n = positions.shape[0]
    box_inv = inv3x3(box)
    idx = torch.remainder(axis_indices.long(), n)
    z_at, x_at, y_at = idx[:, 0], idx[:, 1], idx[:, 2]

    is_zonly = axis_types == ZONLY
    is_bisector = axis_types == BISECTOR
    is_zbisect = axis_types == ZBISECT
    is_threefold = axis_types == THREEFOLD
    is_noaxis = axis_types == NOAXISTYPE

    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]

    def anchor_dir(at):
        pa = positions[at]
        dx, dy, dz = pa[:, 0] - px, pa[:, 1] - py, pa[:, 2] - pz
        sa = dx * box_inv[0, 0] + dy * box_inv[1, 0] + dz * box_inv[2, 0]
        sb = dx * box_inv[0, 1] + dy * box_inv[1, 1] + dz * box_inv[2, 1]
        sc = dx * box_inv[0, 2] + dy * box_inv[1, 2] + dz * box_inv[2, 2]
        sa = sa - torch.floor(sa + 0.5)
        sb = sb - torch.floor(sb + 0.5)
        sc = sc - torch.floor(sc + 0.5)
        dx = sa * box[0, 0] + sb * box[1, 0] + sc * box[2, 0]
        dy = sa * box[0, 1] + sb * box[1, 1] + sc * box[2, 1]
        dz = sa * box[0, 2] + sb * box[1, 2] + sc * box[2, 2]
        return _soa_normalize(dx, dy, dz)

    zx, zy, zz = anchor_dir(z_at)
    ax, ay, az = anchor_dir(x_at)

    # Zonly: unit x or unit y depending on the dominant component of z
    zx_round = torch.round(torch.abs(zx))
    xx = torch.where(is_zonly, 1.0 - zx_round, ax)
    xy = torch.where(is_zonly, zx_round, ay)
    xz = torch.where(is_zonly, torch.zeros_like(az), az)

    bx, by, bz = anchor_dir(y_at)

    # Bisector: z bisects (z, x)
    nzx, nzy, nzz = _soa_normalize(zx + xx, zy + xy, zz + xz)
    zx = torch.where(is_bisector, nzx, zx)
    zy = torch.where(is_bisector, nzy, zy)
    zz = torch.where(is_bisector, nzz, zz)
    # ZBisect: x bisects (x, y-anchor)
    nxx, nxy, nxz = _soa_normalize(xx + bx, xy + by, xz + bz)
    xx = torch.where(is_zbisect, nxx, xx)
    xy = torch.where(is_zbisect, nxy, xy)
    xz = torch.where(is_zbisect, nxz, xz)
    # ThreeFold: z is the average of (z, x, y-anchor)
    tzx, tzy, tzz = _soa_normalize(zx + xx + bx, zy + xy + by, zz + xz + bz)
    zx = torch.where(is_threefold, tzx, zx)
    zy = torch.where(is_threefold, tzy, zy)
    zz = torch.where(is_threefold, tzz, zz)

    # Gram-Schmidt x against z, then y = z x x
    proj = xx * zx + xy * zy + xz * zz
    xx, xy, xz = _soa_normalize(xx - zx * proj, xy - zy * proj, xz - zz * proj)
    yx = zy * xz - zz * xy
    yy = zz * xx - zx * xz
    yz = zx * xy - zy * xx

    one = torch.ones_like(proj)
    zero = torch.zeros_like(proj)
    return (
        torch.where(is_noaxis, one, xx),
        torch.where(is_noaxis, zero, xy),
        torch.where(is_noaxis, zero, xz),
        torch.where(is_noaxis, zero, yx),
        torch.where(is_noaxis, one, yy),
        torch.where(is_noaxis, zero, yz),
        torch.where(is_noaxis, zero, zx),
        torch.where(is_noaxis, zero, zy),
        torch.where(is_noaxis, one, zz),
    )


@profiling.traced("frames")
def global_multipoles(positions, box, q_local, axis_types, axis_indices,
                      lmax: int):
    """The sites' multipoles in the global frame: the local frames of
    ``positions`` and the rotation of the (N, (lmax + 1)^2) local harmonic
    multipoles ``q_local`` by them (the span ``frames``)."""
    frame_comps = local_frames_components(positions, box, axis_types,
                                          axis_indices)
    return rot_local2global_components(q_local, frame_comps, lmax)


def construct_local_frames(positions, box, axis_types, axis_indices):
    """Per-site local frames as (N, 3, 3) rotation matrices, local axes in
    rows (x, y, z): ``v_local = frames @ v_global``. ``axis_indices`` (N, 3)
    holds the (z, x, y) anchors, -1 where absent."""
    f = local_frames_components(positions, box,
                                _on(axis_types, positions.device),
                                _on(axis_indices, positions.device))
    return torch.stack(f, dim=-1).reshape(-1, 3, 3)


def _on(x, device):
    """An index array (numpy, list or tensor) as a tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def make_frame_constructor(axis_types, axis_indices):
    """``construct(positions, box) -> frames`` closed over the per-system
    axis data (the reference's factory form)."""

    def _construct(positions, box):
        return construct_local_frames(positions, box, axis_types,
                                      axis_indices)

    return _construct


def build_quasi_internal(r1, r2, dr, norm_dr):
    """Per-pair quasi-internal frames (..., 3, 3), rows (x, y, z), z along
    the wrapped displacement ``dr`` = r1 - r2 of norm ``norm_dr``. The seed
    of x is unit y where r1 and r2 share their y and z (compared unwrapped,
    as the reference does), else unit x."""
    vec_z = dr / norm_dr[..., None]
    degenerate = ((r1[..., 1] == r2[..., 1])
                  & (r1[..., 2] == r2[..., 2]))[..., None]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dr.dtype, device=dr.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dr.dtype, device=dr.device)
    vec_x = vec_z + torch.where(degenerate, ey, ex)
    vec_x = vec_x - vec_z * torch.sum(vec_z * vec_x, dim=-1, keepdim=True)
    vec_x = safe_normalize(vec_x)
    vec_y = torch.cross(vec_z, vec_x, dim=-1)
    return torch.stack([vec_x, vec_y, vec_z], dim=-2)
