"""Local-frame construction for multipolar sites (admp_tpu/ops/frames.py).

Every axis-type variant is computed for every site and selected with
``torch.where``. Anchor indices may be -1 ("absent"), wrapped with ``mod`` as
Python negative indexing would.

Axis type codes follow MPID/OpenMM:
  ZThenX=0, Bisector=1, ZBisect=2, ThreeFold=3, Zonly=4, NoAxisType=5
"""

from __future__ import annotations

import torch

from admp_tpu_torch.utils.linalg3 import inv3x3

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
