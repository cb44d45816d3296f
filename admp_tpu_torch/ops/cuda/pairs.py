"""Fused real-space pair kernel (K1, forward), its backward (K2) and the
backward's own backward (K3, the Hessian-vector kernel), in CUDA.

Replaces admp_tpu/ops/pallas/pairs.py ``_make_fwd_kernel`` (:330, launched by
``pair_perm_energies`` :392), ``_make_bwd_kernel`` (:343, launched by
``_pair_bwd_op`` :502) and ``_make_hvp_kernel`` (:445, launched by
``_pair_bwd_op_bwd`` :569). Sources: admp_tpu_torch/csrc/pairs.cu (K1, K2),
csrc/pair_hvp.cu (K3), both on the device templates of
csrc/pair_energy.cuh.

What it computes, per pair: the minimum-image wrap, the quasi-internal frame,
the rotation of both sites' harmonics into it, the erfc-screened coefficients
and the bilinear contraction (kind ``'perm'``); ``'pol'`` adds the
Thole-damped induced terms; ``'uu'`` is the induced-induced energy of the SCF
matvec by radial projection. The backward returns the gradients of sum(ct e)
with respect to both gathered rows, the scale rows and the 19 scalars
(kappa, box, box inverse); the scalar gradients come back per thread block
and are summed here, so the virial and the kappa gradient are exact and
deterministic. K3 is the VJP of that backward at cotangents c of its four
outputs: ct H c for every input and J c for ct.

Inputs, as in admp_tpu: ``g_i``/``g_j`` (C, F) gathered rows of the packed
atom table [x, y, z, q_harm (+ u_harm(3), pol, thole)] or, for ``'uu'``,
[x, y, z, u_harm(3), pol, thole]; ``scl`` rows [mscale, mask(, pscale)] or
[pscale, mask] for ``'uu'``; ``scal`` (19,) [kappa, box(9), inv(box)(9)].

On the card the kernels are bound by arithmetic, not bytes: one thread per
pair reads ~2F+3 floats and evaluates a few hundred flops (erfcf, expf, a
frame and two rotations). The design keeps every intermediate in registers
and writes only the (C,) energies. The backward runs the same templated
device function with forward-mode dual numbers of a small tangent width, in
several passes over the ~15-34 independent inputs of a pair, instead of a
hand-written reverse adjoint of the rotations and Thole terms: exact
derivatives from the very source the forward uses, at the price of
repeating the forward arithmetic once per pass (ROADMAP.md lists a
reverse-mode kernel as later speed work). K3 runs K2's body once more with
every value a one-tangent dual along c.

Autograd: ``PairEnergyFn`` (forward K1) has the backward ``PairBwdFn``
(forward K2, backward K3), so the pair energies are twice differentiable on
the kernels, as admp_tpu's ``_pair_bwd_op`` is a custom_vjp. K3's backward
is ``once_differentiable``: a third derivative raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from admp_tpu_torch.ops import realspace
from admp_tpu_torch.ops.cuda import build, use_kernel

N_SCAL = 19  # kappa + box (9) + inv(box) (9)
KINDS = {"perm": 0, "pol": 1, "uu": 2}


def _width(lmax: int, kind: str) -> int:
    """Columns of the packed per-atom table."""
    if kind == "uu":
        return 8
    return 3 + (lmax + 1) ** 2 + (5 if kind == "pol" else 0)


def _n_scl(kind: str) -> int:
    return 3 if kind == "pol" else 2


# ---------------------------------------------------------------------------
# Plain PyTorch version (the same physics as ops/realspace)
# ---------------------------------------------------------------------------


def pair_energies_torch(g_i, g_j, scl, scal, lmax: int, kind: str = "perm"):
    """Per-pair masked energies (C,) of the pair kernel, in plain PyTorch;
    autograd gives the backward kernel's gradients."""
    mask = scl[1] > 0.5
    kappa = scal[0]
    box = scal[1:10].reshape(3, 3)
    binv = scal[10:19].reshape(3, 3)
    dx, dy, dz, r, rinv = realspace._displacement_from_rows(
        g_i[:, :3], g_j[:, :3], box, mask, binv)
    if kind == "uu":
        # u in harmonic (z, x, y) order -> Cartesian (x, y, z)
        ui = (g_i[:, 4], g_i[:, 5], g_i[:, 3])
        uj = (g_j[:, 4], g_j[:, 5], g_j[:, 3])
        e = realspace.uu_pair_energy(
            dx, dy, dz, r, rinv, ui, uj, g_i[:, 6], g_j[:, 6], g_i[:, 7],
            g_j[:, 7], scl[0], kappa)
        return torch.where(mask, e, torch.zeros_like(e))
    n_h = (lmax + 1) ** 2
    degenerate = (g_i[:, 1] == g_j[:, 1]) & (g_i[:, 2] == g_j[:, 2])
    frame = realspace.qi_frame(dx, dy, dz, rinv, degenerate)
    qi_i = realspace.rotate_harm_components(
        tuple(g_i[:, 3 + k] for k in range(n_h)), frame, lmax)
    qi_j = realspace.rotate_harm_components(
        tuple(g_j[:, 3 + k] for k in range(n_h)), frame, lmax)
    coef = realspace.perm_coefficients(r, scl[0], kappa, lmax)
    e = realspace.pair_energy_perm(qi_i, qi_j, coef, lmax)
    if kind == "pol":
        b = 3 + n_h
        ui = realspace.rotate_dipole_qi(
            (g_i[:, b], g_i[:, b + 1], g_i[:, b + 2]), frame)
        uj = realspace.rotate_dipole_qi(
            (g_j[:, b], g_j[:, b + 1], g_j[:, b + 2]), frame)
        dmp = realspace.pair_damping_width(g_i[:, b + 3], g_j[:, b + 3])
        icoef = realspace.induced_coefficients(
            r, g_i[:, b + 4], g_j[:, b + 4], dmp, scl[2], kappa, lmax)
        e = e + realspace.pair_energy_induced(qi_i, qi_j, ui, uj, icoef, lmax)
    return torch.where(mask, e, torch.zeros_like(e))


def pair_hvp_torch(g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl, c_scal,
                   lmax: int, kind: str = "perm"):
    """Plain version of K3: the VJP of the backward's outputs (gradients of
    sum(ct e) with respect to g_i, g_j, scl, scal) at cotangents
    (c_gi, c_gj, c_scl, c_scal), by autograd of ``pair_energies_torch``
    twice. Returns (d_gi, d_gj, d_scl, d_scal, d_ct)."""
    with torch.enable_grad():
        x = [t.detach().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
        ct_r = ct.detach().requires_grad_(True)
        e = pair_energies_torch(*x, lmax, kind)
        grads = torch.autograd.grad((e * ct_r).sum(), x, create_graph=True)
        h = sum((g * c).sum() for g, c in zip(grads, (c_gi, c_gj, c_scl,
                                                      c_scal)))
        return torch.autograd.grad(h, x + [ct_r])


def hvp_directions(tables, kind: str, seed: int):
    """Standard-normal cotangents for K2's four outputs (the direction K3
    differentiates along), for holding K3 against a reference: float32 on
    the tables' device, nonzero on every output, except the pol and thole
    columns of a row whose pol is 0. There the damping width is the 1e-6
    floor, the Thole argument a r / 1e-6 of a pair of two such sites is
    ~1e-20 with a slope of ~1e6 per unit thole, and its second derivatives
    cancel terms of ~1e13 to ~0, which float32 keeps to no digit in any
    implementation (fused multiply-adds on the card change which). The
    paths that run K3 put no cotangent there: the field VJP and the SCF
    adjoint differentiate along the dipole columns, force matching along
    the positions."""
    rng = np.random.default_rng(seed)
    out = [torch.tensor(rng.standard_normal(tuple(t.shape)),
                        dtype=torch.float32, device=t.device) for t in tables]
    if kind != "perm":
        for g, c in zip(tables[:2], out[:2]):
            c[g[:, -2] == 0, -2:] = 0.0
    return out


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("pairs")
    if not getattr(lib, "_admp_typed", False):
        lib.admp_pair_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.admp_pair_fwd.restype = _I
        lib.admp_pair_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _P]
        lib.admp_pair_bwd.restype = _I
        lib.admp_pair_block_size.argtypes = []
        lib.admp_pair_block_size.restype = _I
        lib._admp_typed = True
    return lib


def _hvp_lib():
    lib = build.load("pair_hvp")
    if not getattr(lib, "_admp_typed", False):
        lib.admp_pair_hvp.argtypes = [_P] * 14 + [_I, _I, _I, _P]
        lib.admp_pair_hvp.restype = _I
        lib.admp_pair_hvp_block_size.argtypes = []
        lib.admp_pair_hvp_block_size.restype = _I
        lib._admp_typed = True
    return lib


def _check(g_i, g_j, scl, scal, lmax, kind):
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r}: expected one of {tuple(KINDS)}")
    if not 0 <= lmax <= 2:
        raise ValueError(f"lmax={lmax}: the kernel takes 0..2")
    c, f = g_i.shape[0], _width(lmax, kind)
    for name, t, shape in (("g_i", g_i, (c, f)), ("g_j", g_j, (c, f)),
                           ("scl", scl, (_n_scl(kind), c)),
                           ("scal", scal, (N_SCAL,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous float32 CUDA tensor")
        if t.device != g_i.device:
            raise ValueError(f"{name}: on {t.device}, g_i on {g_i.device}")


def _operand(name, t, like):
    """A cotangent or direction operand: ``like``'s shape, float32, on its
    device; returned contiguous (PyTorch hands zero cotangents and an
    expanded ``ct`` with zero strides)."""
    if (tuple(t.shape) != tuple(like.shape) or t.dtype != torch.float32
            or t.device != like.device):
        raise ValueError(f"{name}: needs a float32 tensor of shape "
                         f"{tuple(like.shape)} on {like.device}")
    return t.contiguous()


def launch_pair_fwd(g_i, g_j, scl, scal, lmax: int, kind: str):
    """K1: per-pair energies (C,) from the CUDA kernel."""
    _check(g_i, g_j, scl, scal, lmax, kind)
    c = g_i.shape[0]
    e = torch.empty(c, device=g_i.device, dtype=torch.float32)
    if c == 0:
        return e
    status = _lib().admp_pair_fwd(
        g_i.data_ptr(), g_j.data_ptr(), scl.data_ptr(), scal.data_ptr(),
        e.data_ptr(), c, KINDS[kind], lmax,
        torch.cuda.current_stream(g_i.device).cuda_stream)
    build.check(status, f"pair forward ({kind}, lmax={lmax})")
    launch_pair_fwd.launches += 1
    return e


launch_pair_fwd.launches = 0


def launch_pair_bwd(g_i, g_j, scl, scal, ct, lmax: int, kind: str):
    """K2: gradients of sum(ct * e) w.r.t. (g_i, g_j, scl, scal)."""
    _check(g_i, g_j, scl, scal, lmax, kind)
    c = g_i.shape[0]
    ct = _operand("ct", ct, g_i[:, 0])
    dgi = torch.empty_like(g_i)
    dgj = torch.empty_like(g_j)
    dscl = torch.empty_like(scl)
    if c == 0:
        return dgi, dgj, dscl, torch.zeros_like(scal)
    lib = _lib()
    n_blocks = -(-c // lib.admp_pair_block_size())
    dscal_blocks = torch.empty((n_blocks, N_SCAL), device=g_i.device,
                               dtype=torch.float32)
    status = lib.admp_pair_bwd(
        g_i.data_ptr(), g_j.data_ptr(), scl.data_ptr(), scal.data_ptr(),
        ct.data_ptr(), dgi.data_ptr(), dgj.data_ptr(), dscl.data_ptr(),
        dscal_blocks.data_ptr(), c, KINDS[kind], lmax,
        torch.cuda.current_stream(g_i.device).cuda_stream)
    build.check(status, f"pair backward ({kind}, lmax={lmax})")
    launch_pair_bwd.launches += 1
    return dgi, dgj, dscl, dscal_blocks.sum(dim=0)


launch_pair_bwd.launches = 0


def launch_pair_hvp(g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl, c_scal,
                    lmax: int, kind: str):
    """K3: the VJP of K2 at cotangents (c_gi, c_gj, c_scl, c_scal) of its
    outputs. Returns (d_gi, d_gj, d_scl, d_scal, d_ct): ct H c for every
    input of the pair energies and J c for ct."""
    _check(g_i, g_j, scl, scal, lmax, kind)
    c = g_i.shape[0]
    ct = _operand("ct", ct, g_i[:, 0])
    c_gi = _operand("c_gi", c_gi, g_i)
    c_gj = _operand("c_gj", c_gj, g_j)
    c_scl = _operand("c_scl", c_scl, scl)
    c_scal = _operand("c_scal", c_scal, scal)
    dgi = torch.empty_like(g_i)
    dgj = torch.empty_like(g_j)
    dscl = torch.empty_like(scl)
    dct = torch.empty_like(ct)
    if c == 0:
        return dgi, dgj, dscl, torch.zeros_like(scal), dct
    lib = _hvp_lib()
    n_blocks = -(-c // lib.admp_pair_hvp_block_size())
    dscal_blocks = torch.empty((n_blocks, N_SCAL), device=g_i.device,
                               dtype=torch.float32)
    status = lib.admp_pair_hvp(
        *(t.data_ptr() for t in (g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl,
                                 c_scal, dgi, dgj, dscl, dct, dscal_blocks)),
        c, KINDS[kind], lmax,
        torch.cuda.current_stream(g_i.device).cuda_stream)
    build.check(status, f"pair HVP ({kind}, lmax={lmax})")
    launch_pair_hvp.launches += 1
    launch_pair_hvp.by_kind[kind] += 1
    return dgi, dgj, dscl, dscal_blocks.sum(dim=0), dct


launch_pair_hvp.launches = 0
launch_pair_hvp.by_kind = dict.fromkeys(KINDS, 0)  # the launches per kind


class PairBwdFn(torch.autograd.Function):
    """The pair energies' gradients on the kernels: forward K2, backward K3
    (admp_tpu's ``_pair_bwd_op`` custom_vjp). ``once_differentiable``: a
    third derivative raises instead of coming out silently zero."""

    @staticmethod
    def forward(ctx, g_i, g_j, scl, scal, ct, lmax, kind):
        ctx.save_for_backward(g_i, g_j, scl, scal, ct)
        ctx.lmax, ctx.kind = lmax, kind
        return launch_pair_bwd(g_i, g_j, scl, scal, ct, lmax, kind)

    @staticmethod
    @once_differentiable
    def backward(ctx, c_gi, c_gj, c_scl, c_scal):
        g_i, g_j, scl, scal, ct = ctx.saved_tensors
        return (*launch_pair_hvp(g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl,
                                 c_scal, ctx.lmax, ctx.kind), None, None)


class PairEnergyFn(torch.autograd.Function):
    """Per-pair energies on the kernels: forward K1, backward ``PairBwdFn``
    (K2, whose own backward is K3), so twice differentiable."""

    @staticmethod
    def forward(ctx, g_i, g_j, scl, scal, lmax, kind):
        ctx.save_for_backward(g_i, g_j, scl, scal)
        ctx.lmax, ctx.kind = lmax, kind
        return launch_pair_fwd(g_i, g_j, scl, scal, lmax, kind)

    @staticmethod
    def backward(ctx, ct):
        g_i, g_j, scl, scal = ctx.saved_tensors
        return (*PairBwdFn.apply(g_i, g_j, scl, scal, ct, ctx.lmax,
                                 ctx.kind), None, None)


def pair_energies(g_i, g_j, scl, scal, lmax: int, kind: str = "perm",
                  method: str = "auto"):
    """Per-pair masked energies (C,): the CUDA kernels (differentiable twice)
    or the plain version, by ``method`` (see ops/cuda.use_kernel)."""
    if use_kernel(method, g_i, "pair_kernel"):
        return PairEnergyFn.apply(
            g_i.contiguous(), g_j.contiguous(), scl.contiguous(),
            scal.contiguous(), lmax, kind)
    return pair_energies_torch(g_i, g_j, scl, scal, lmax, kind)
