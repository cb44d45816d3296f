"""Real-space multipolar Ewald: screened interaction coefficients and the pair
energy (admp_tpu/ops/realspace.py), in the component form of admp_tpu's plain
pair path: every per-pair intermediate is a flat (C,) tensor.

The pair energy is the bilinear form E = qiQJ^T T(r) qiQI in the
quasi-internal (QI) frame, with the induced-dipole couplings
E_ind = 1/2 qiQJ^T G qiUI + 1/2 qiQI^T G' qiUJ + qiUJ^T D2 qiUI.
Padded pairs (i >= j) flow through with sanitized distances and are masked.

The per-pair row gathers are plain ``index_select``. admp_tpu's
``take_rows_sorted`` (realspace.py:47-78) gives them a sorted segment-sum
backward, a TPU fast path that is wrong for unsorted pairs; the backward of
``index_select`` is right for any pair order, so the port accepts
``EngineConfig.pairs_i_sorted`` and ignores it.
"""

from __future__ import annotations

import math

import torch

from admp_tpu_torch.ops.harmonics import rotate_harm_components
from admp_tpu_torch.utils.constants import DEFAULT_THOLE_WIDTH, DIELECTRIC, SQRT_PI
from admp_tpu_torch.utils.linalg3 import inv3x3


def pair_displacement_components(positions, box, i, j, mask):
    """Minimum-image pair displacements and sanitized norms.

    Returns (dx, dy, dz, r, rinv, p_i, p_j); r is 1 on masked pairs so they
    stay finite."""
    p_i, p_j = positions.index_select(0, i), positions.index_select(0, j)
    return _displacement_from_rows(p_i, p_j, box, mask) + (p_i, p_j)


def _displacement_from_rows(p_i, p_j, box, mask, binv=None):
    """Wrap/norm math given gathered (C, 3) position rows. ``binv`` may be
    passed in, as the pair kernel takes the box inverse as its own input."""
    dx = p_i[:, 0] - p_j[:, 0]
    dy = p_i[:, 1] - p_j[:, 1]
    dz = p_i[:, 2] - p_j[:, 2]
    if binv is None:
        binv = inv3x3(box)
    sa = dx * binv[0, 0] + dy * binv[1, 0] + dz * binv[2, 0]
    sb = dx * binv[0, 1] + dy * binv[1, 1] + dz * binv[2, 1]
    sc = dx * binv[0, 2] + dy * binv[1, 2] + dz * binv[2, 2]
    sa = sa - torch.floor(sa + 0.5)
    sb = sb - torch.floor(sb + 0.5)
    sc = sc - torch.floor(sc + 0.5)
    dx = sa * box[0, 0] + sb * box[1, 0] + sc * box[2, 0]
    dy = sa * box[0, 1] + sb * box[1, 1] + sc * box[2, 1]
    dz = sa * box[0, 2] + sb * box[1, 2] + sc * box[2, 2]
    sq = dx * dx + dy * dy + dz * dz
    one = torch.ones_like(sq)
    r = torch.where(mask, torch.sqrt(torch.where(mask, sq, one)), one)
    return dx, dy, dz, r, 1.0 / r


def qi_frame(dx, dy, dz, rinv, degenerate):
    """Quasi-internal frame: z along the pair displacement, x from a
    degeneracy-aware seed orthogonalized against z, y = z x x. ``degenerate``
    compares the RAW y/z coordinates of the two sites (admp_tpu keeps that
    test exactly). Returns the 9 frame entries, rows = local axes."""
    fzx, fzy, fzz = dx * rinv, dy * rinv, dz * rinv
    one = torch.ones_like(rinv)
    seedx = torch.where(degenerate, torch.zeros_like(one), one)
    seedy = one - seedx
    vx = fzx + seedx
    vy = fzy + seedy
    vz = fzz
    dot = fzx * vx + fzy * vy + fzz * vz
    vx = vx - fzx * dot
    vy = vy - fzy * dot
    vz = vz - fzz * dot
    nsq = vx * vx + vy * vy + vz * vz
    small = nsq < 1e-12
    ninv = torch.where(
        small, torch.zeros_like(nsq),
        1.0 / torch.sqrt(torch.where(small, torch.ones_like(nsq), nsq)),
    )
    fxx, fxy, fxz = vx * ninv, vy * ninv, vz * ninv
    fyx = fzy * fxz - fzz * fxy
    fyy = fzz * fxx - fzx * fxz
    fyz = fzx * fxy - fzy * fxx
    return (fxx, fxy, fxz, fyx, fyy, fyz, fzx, fzy, fzz)


def rotate_dipole_qi(u_harm_comps, frame):
    """Harmonic-order (z, x, y) dipole components -> QI frame (z, x, y)."""
    zero = torch.zeros_like(u_harm_comps[0])
    return rotate_harm_components((zero,) + tuple(u_harm_comps), frame, 1)[1:]


def qi_pair_components(positions, box, q_comps, i, j, mask, lmax: int,
                       u_comps=None):
    """Pair geometry and QI-frame rotation in component form.

    Args:
      q_comps: (N, H) harmonic multipoles (H >= (lmax+1)^2).
      u_comps: optional (N, 3) induced dipoles (harmonic z, x, y order).
    Returns:
      (r, qi_i, qi_j, ui, uj): r (C,) sanitized distances; qi_* component
      tuples in the QI frame; ui/uj component triples or None.
    """
    n_h = (lmax + 1) ** 2
    cols = [positions, q_comps[:, :n_h]]
    if u_comps is not None:
        cols.append(u_comps)
    packed = torch.cat(cols, dim=1)
    g_i = packed.index_select(0, i)
    g_j = packed.index_select(0, j)
    p_i, p_j = g_i[:, :3], g_j[:, :3]
    dx, dy, dz, r, rinv = _displacement_from_rows(p_i, p_j, box, mask)
    degenerate = (p_i[:, 1] == p_j[:, 1]) & (p_i[:, 2] == p_j[:, 2])
    frame = qi_frame(dx, dy, dz, rinv, degenerate)
    qi_i = rotate_harm_components(
        tuple(g_i[:, 3 + k] for k in range(n_h)), frame, lmax)
    qi_j = rotate_harm_components(
        tuple(g_j[:, 3 + k] for k in range(n_h)), frame, lmax)
    ui = uj = None
    if u_comps is not None:
        b = 3 + n_h
        ui = rotate_dipole_qi((g_i[:, b], g_i[:, b + 1], g_i[:, b + 2]), frame)
        uj = rotate_dipole_qi((g_j[:, b], g_j[:, b + 1], g_j[:, b + 2]), frame)
    return r, qi_i, qi_j, ui, uj


def ewald_screening_s(kr, x, mscale):
    """Cancellation-free screening sums (admp_tpu/ops/realspace.py:216-242):
    s2 = (mscale-1) + erfc(kr), s2x = s2 + kr x, s3 = s2x + (2/3) kr^3 x,
    s4 = s3 + (4/15) kr^5 x."""
    kr2 = kr * kr
    kr3 = kr2 * kr
    kr5 = kr3 * kr2
    s2 = (mscale - 1.0) + torch.erfc(kr)
    s2x = s2 + kr * x
    s3 = s2x + (2.0 / 3.0) * kr3 * x
    s4 = s3 + (4.0 / 15.0) * kr5 * x
    return s2, s2x, s3, s4


def perm_coefficients(r, mscale, kappa, lmax: int):
    """Screened permanent-multipole coefficients in the QI frame: dict with
    cc, cd, dd_m0, dd_m1, cq, dq_m0, dq_m1, qq_m0, qq_m1, qq_m2."""
    kr = kappa * r
    x = 2.0 * torch.exp(-(kr * kr)) / SQRT_PI
    return perm_coefficients_from_screening(r, kr, x, mscale, lmax)


def perm_coefficients_from_screening(r, kr, x, mscale, lmax: int):
    r_inv = 1.0 / r
    d1 = DIELECTRIC * r_inv
    d2 = d1 * r_inv
    d3 = d2 * r_inv
    d4 = d3 * r_inv
    d5 = d4 * r_inv
    kr2 = kr * kr
    kr3 = kr2 * kr
    kr5 = kr3 * kr2
    s2, s2x, s3, s4 = ewald_screening_s(kr, x, mscale)
    out = {"cc": d1 * s2}
    if lmax >= 1:
        out["cd"] = d2 * s2x
        out["dd_m0"] = -2.0 / 3.0 * d3 * (3.0 * s3 + kr3 * x)
        out["dd_m1"] = d3 * s2x
    if lmax >= 2:
        out["cq"] = d3 * s3
        out["dq_m0"] = d4 * (3.0 * s3 + (4.0 / 3.0) * kr5 * x)
        out["dq_m1"] = -math.sqrt(3.0) * d4 * s3
        out["qq_m0"] = d5 * (
            6.0 * s4 + (4.0 / 45.0) * (-3.0 + 10.0 * kr2) * kr5 * x
        )
        out["qq_m1"] = -(4.0 / 15.0) * d5 * (15.0 * s4 + kr5 * x)
        out["qq_m2"] = d5 * s3
    return out


def _thole_width(pscale, thole1, thole2):
    """Thole width: the default for real pairs (pscale ~ 0), thole1+thole2
    for scaled intramolecular pairs, by a Fermi switch on pscale."""
    uu = (pscale - 1e-3) / 1e-5
    w0 = 1.0 / (torch.exp(torch.clamp(uu, -60.0, 60.0)) + 1.0)
    return w0 * DEFAULT_THOLE_WIDTH + (1.0 - w0) * (thole1 + thole2)


def _exp_damping(au):
    """exp(-au) below the au = 50 clamp, 0 above it (double-where)."""
    return torch.where(au < 50.0, torch.exp(-torch.clamp(au, max=50.0)),
                       torch.zeros_like(au))


def thole_factor_complements(au):
    """Thole damping factor complements (c-1, d0-1, d1-1, q0-1, q1-1)."""
    exp_au = _exp_damping(au)
    au2 = au * au
    au3 = au2 * au
    au4 = au3 * au
    cm = -exp_au * (1.0 + au + 0.5 * au2)
    d0m = -exp_au * (1.0 + au + 0.5 * au2 + au3 / 4.0)
    q0m = -exp_au * (1.0 + au + 0.5 * au2 + au3 / 6.0 + au4 / 18.0)
    q1m = -exp_au * (1.0 + au + 0.5 * au2 + au3 / 6.0)
    return cm, d0m, cm, q0m, q1m


def _scaled_distance(r, dmp):
    dmp_safe = torch.clamp(dmp, min=1e-8)
    return torch.clamp(r / dmp_safe, max=1e8)


def induced_coefficients(r, thole1, thole2, dmp, pscale, kappa, lmax: int):
    """Screened induced-dipole coefficients: dict with cud, dud_m0, dud_m1,
    udq_m0, udq_m1, udud_m0, udud_m1 (uscale fixed to 1)."""
    a = _thole_width(pscale, thole1, thole2)
    tcm, td0m, td1m, tq0m, tq1m = thole_factor_complements(
        a * _scaled_distance(r, dmp))
    r_inv = 1.0 / r
    d2 = DIELECTRIC * r_inv * r_inv
    d3 = d2 * r_inv
    d4 = d3 * r_inv
    kr = kappa * r
    kr2 = kr * kr
    kr3 = kr2 * kr
    kr5 = kr3 * kr2
    x = 2.0 * torch.exp(-kr2) / SQRT_PI
    ps1 = pscale - 1.0
    e2 = torch.erfc(kr) + kr * x
    e3 = e2 + (2.0 / 3.0) * kr3 * x
    out = {"cud": 2.0 * d2 * (pscale * tcm + ps1 + e2)}
    if lmax >= 1:
        out["dud_m0"] = -4.0 / 3.0 * d3 * (
            3.0 * (pscale * td0m + ps1 + e3) + kr3 * x
        )
        out["dud_m1"] = 2.0 * d3 * (pscale * td1m + ps1 + e2)
    if lmax >= 2:
        out["udq_m0"] = 2.0 * d4 * (
            3.0 * (pscale * tq0m + ps1 + e3) + 4.0 / 3.0 * kr5 * x
        )
        out["udq_m1"] = -2.0 * math.sqrt(3.0) * d4 * (pscale * tq1m + ps1 + e3)
    out["udud_m0"] = -2.0 / 3.0 * d3 * (3.0 * (td0m + e3) + kr3 * x)
    out["udud_m1"] = d3 * (td1m + e2)
    return out


def induced_uu_coefficients(r, thole1, thole2, dmp, pscale, kappa):
    """Only the induced-induced coefficients (udud_m0, udud_m1): the SCF
    matvec needs just the u-quadratic part of the energy."""
    a = _thole_width(pscale, thole1, thole2)
    au = a * _scaled_distance(r, dmp)
    exp_au = _exp_damping(au)
    au2 = au * au
    au3 = au2 * au
    td0m = -exp_au * (1.0 + au + 0.5 * au2 + au3 / 4.0)
    td1m = -exp_au * (1.0 + au + 0.5 * au2)
    r_inv = 1.0 / r
    d3 = DIELECTRIC * r_inv * r_inv * r_inv
    kr = kappa * r
    kr2 = kr * kr
    kr3 = kr2 * kr
    x = 2.0 * torch.exp(-kr2) / SQRT_PI
    e2 = torch.erfc(kr) + kr * x
    e3 = e2 + (2.0 / 3.0) * kr3 * x
    udud_m0 = -2.0 / 3.0 * d3 * (3.0 * (td0m + e3) + kr3 * x)
    udud_m1 = d3 * (td1m + e2)
    return udud_m0, udud_m1


def uu_pair_energy(dx, dy, dz, r, rinv, ui, uj, pol_i, pol_j, thole_i,
                   thole_j, pscale, kappa):
    """Induced-induced pair energy by radial projection, no QI frame:
    e = (m0 - m1) (uj.zhat)(ui.zhat) + m1 (ui.uj). ``ui``/``uj`` are
    Cartesian (x, y, z) component triples."""
    uix, uiy, uiz = ui
    ujx, ujy, ujz = uj
    ui_z = (uix * dx + uiy * dy + uiz * dz) * rinv
    uj_z = (ujx * dx + ujy * dy + ujz * dz) * rinv
    ui_dot_uj = uix * ujx + uiy * ujy + uiz * ujz
    dmp = pair_damping_width(pol_i, pol_j)
    m0, m1 = induced_uu_coefficients(r, thole_i, thole_j, dmp, pscale, kappa)
    return (m0 - m1) * uj_z * ui_z + m1 * ui_dot_uj


def pair_energy_perm(qi_i, qi_j, coef, lmax: int):
    """Permanent-permanent pair energy qiQJ^T T qiQI."""
    e = coef["cc"] * qi_j[0] * qi_i[0]
    if lmax >= 1:
        e = e + coef["cd"] * (qi_j[1] * qi_i[0] - qi_j[0] * qi_i[1])
        e = e + coef["dd_m0"] * qi_j[1] * qi_i[1]
        e = e + coef["dd_m1"] * (qi_j[2] * qi_i[2] + qi_j[3] * qi_i[3])
    if lmax >= 2:
        e = e + coef["cq"] * (qi_j[0] * qi_i[4] + qi_j[4] * qi_i[0])
        e = e + coef["dq_m0"] * (qi_j[1] * qi_i[4] - qi_j[4] * qi_i[1])
        e = e + coef["dq_m1"] * (
            qi_j[2] * qi_i[5] - qi_j[5] * qi_i[2]
            + qi_j[3] * qi_i[6] - qi_j[6] * qi_i[3]
        )
        e = e + coef["qq_m0"] * qi_j[4] * qi_i[4]
        e = e + coef["qq_m1"] * (qi_j[5] * qi_i[5] + qi_j[6] * qi_i[6])
        e = e + coef["qq_m2"] * (qi_j[7] * qi_i[7] + qi_j[8] * qi_i[8])
    return e


def pair_energy_induced(qi_i, qi_j, ui, uj, icoef, lmax: int):
    """Induced-dipole contributions to the pair energy."""
    e_ju = -icoef["cud"] * qi_j[0] * ui[0]
    e_iu = icoef["cud"] * qi_i[0] * uj[0]
    if lmax >= 1:
        e_ju = e_ju + icoef["dud_m0"] * qi_j[1] * ui[0] + icoef["dud_m1"] * (
            qi_j[2] * ui[1] + qi_j[3] * ui[2])
        e_iu = e_iu + icoef["dud_m0"] * qi_i[1] * uj[0] + icoef["dud_m1"] * (
            qi_i[2] * uj[1] + qi_i[3] * uj[2])
    if lmax >= 2:
        e_ju = e_ju - icoef["udq_m0"] * qi_j[4] * ui[0] - icoef["udq_m1"] * (
            qi_j[5] * ui[1] + qi_j[6] * ui[2])
        e_iu = e_iu + icoef["udq_m0"] * qi_i[4] * uj[0] + icoef["udq_m1"] * (
            qi_i[5] * uj[1] + qi_i[6] * uj[2])
    e_uu = icoef["udud_m0"] * uj[0] * ui[0] + icoef["udud_m1"] * (
        uj[1] * ui[1] + uj[2] * ui[2])
    return 0.5 * (e_ju + e_iu) + e_uu


def pair_damping_width(pol_i, pol_j):
    """Thole distance rescaling (pol_i pol_j)^(1/6), floored by a double-where
    so derivatives stay finite at zero-polarizability sites."""
    prod = pol_i * pol_j
    small = prod <= 1e-36
    prod_safe = torch.where(small, torch.ones_like(prod), prod)
    return torch.where(small, torch.full_like(prod, 1e-6),
                       prod_safe ** (1.0 / 6.0))
