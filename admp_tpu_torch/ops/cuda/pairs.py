"""Fused real-space pair kernel (K1, forward), its backward (K2), the
backward's own backward (K3, the Hessian-vector kernel) and K3's backward
(K3b, the third derivative), in CUDA.

Replaces admp_tpu/ops/pallas/pairs.py ``_make_fwd_kernel`` (:330, launched by
``pair_perm_energies`` :392), ``_make_bwd_kernel`` (:343, launched by
``_pair_bwd_op`` :502) and ``_make_hvp_kernel`` (:445, launched by
``_pair_bwd_op_bwd`` :569). K3b has no TPU kernel: admp_tpu's HVP has no
VJP, and it takes this derivative on its XLA route only. Sources:
admp_tpu_torch/csrc/pairs.cu (K1, K2), csrc/pair_hvp.cu (K3),
csrc/pair_third.cu (K3b), all on the device templates of
csrc/pair_energy.cuh.

What it computes, per pair: the minimum-image wrap, the quasi-internal frame,
the rotation of both sites' harmonics into it, the erfc-screened coefficients
and the bilinear contraction (kind ``'perm'``); ``'pol'`` adds the
Thole-damped induced terms; ``'uu'`` is the induced-induced energy of the SCF
matvec by radial projection. The backward returns the gradients of sum(ct e)
with respect to the packed table, the scale rows and the 19 scalars (kappa,
box, box inverse); the scalar gradients come back per thread block and are
summed here, so the virial and the kappa gradient are exact and
deterministic. K3 is the VJP of that backward at cotangents c of its outputs
in the gathered layout: ct H c for every input and J c for ct.

Inputs: the packed (N, F) atom table [x, y, z, q_harm (+ u_harm(3), pol,
thole)] or, for ``'uu'``, [x, y, z, u_harm(3), pol, thole]; the pair list's
columns ``i``, ``j`` (C,) int64; ``scl`` rows [mscale, mask(, pscale)] or
[pscale, mask] for ``'uu'``; ``scal`` (19,) [kappa, box(9), inv(box)(9)].
K1 and K2 read rows table[i], table[j] through the list, so no (C, F)
gathered table is made and no ``index_add`` of one; K2 adds both rows'
gradients into the table's gradient with atomics, right for any pair
order, cheapest for an i-sorted list. A pair whose i or j lies outside
[0, N) (a padding slot) is masked: it reads no row and adds nothing. K3 and
K3b take, as admp_tpu's kernels do, the gathered rows ``g_i``/``g_j``
(C, F) = table[i], table[j].

On the card the kernels are bound by arithmetic, registers and latency, not
bytes: one thread per pair reads ~2F+3 floats and evaluates a few hundred
flops (erfcf, expf, a frame and two rotations). The design keeps every
intermediate in registers and writes only the (C,) energies. The backward
K2 is mixed mode, as admp_tpu's kernel is reverse mode (``jax.grad`` in its
body): one float forward, a hand reverse of the bilinear contractions and
of the rotations (their transposes written out), and forward-mode dual
numbers only over the narrow inputs, the 3 components of the displacement
through the frame and the rotations and the coefficient functions' 3 or 7
scalar inputs, from the same templated source as the forward, so each of
its branches (the degenerate frame, the damping floor, the Thole clips)
takes autograd's side. It stages each block's output rows in shared memory
and adds them into the table's gradient. K3 runs the same mixed-mode body
with every value a one-tangent dual along c (as admp_tpu's kernel takes
``jax.jvp`` of its gradient), its staged rows stored coalesced: each
gradient entry comes out with its derivative along c. K3b runs the same body once more, every value a
hyper-dual along c and along the cotangent h of K3's outputs: one pass gives
the cotangents of K3's tables and of its direction. The launchers keep
their host work lean, as the spread launchers do (ops/cuda/entries.py).

Autograd (``pair_energies_indexed``, the engines' route in models/pme.py):
``PairTableEnergyFn`` (forward K1) has the backward ``PairTableBwdFn``
(forward K2), whose backward, taken only where a
graph is asked for (the exact adjoint, force matching), gathers the rows
and takes ``PairHvpFn`` on them (forward K3, backward K3b), so K3/K3b keep
the gathered layout and the pair energies are three times differentiable
on the kernels, as admp_tpu's are on its XLA route. K3b's backward is
``once_differentiable``: a fourth derivative raises. Counters while a
profiler records (utils/profiling.py): ``pairs.indexed``, each K1/K2
launch; ``pairs.gathered``, each fallback to the gathered layout. On
CPU tensors the Functions run their plain versions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from admp_tpu_torch.ops import realspace
from admp_tpu_torch.ops.cuda import build
from admp_tpu_torch.ops.cuda.entries import entry as _entry
from admp_tpu_torch.ops.cuda.entries import raw_stream as _raw_stream
from admp_tpu_torch.utils import profiling

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


def pair_third_torch(g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl, c_scal,
                     h_gi, h_gj, h_scl, h_scal, h_ct, lmax: int,
                     kind: str = "perm"):
    """Plain version of K3b: the VJP of K3's outputs (d_gi, d_gj, d_scl,
    d_scal, d_ct) at cotangents (h_gi, h_gj, h_scl, h_scal, h_ct), by
    autograd of ``pair_energies_torch`` three times. Returns the cotangents
    of K3's nine inputs: (x_gi, x_gj, x_scl, x_scal, x_ct, x_cgi, x_cgj,
    x_cscl, x_cscal), each of its input's shape (zeros where it has no
    derivative)."""
    with torch.enable_grad():
        x = [t.detach().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
        ct_r = ct.detach().requires_grad_(True)
        cs = [t.detach().requires_grad_(True)
              for t in (c_gi, c_gj, c_scl, c_scal)]
        e = pair_energies_torch(*x, lmax, kind)
        grads = torch.autograd.grad((e * ct_r).sum(), x, create_graph=True)
        h = sum((g * c).sum() for g, c in zip(grads, cs))
        outs = torch.autograd.grad(h, x + [ct_r], create_graph=True)
        phi = sum((o * t).sum() for o, t in zip(
            outs, (h_gi, h_gj, h_scl, h_scal, h_ct)))
        leaves = x + [ct_r] + cs
        return tuple(torch.zeros_like(t) if d is None else d for t, d in zip(
            leaves, torch.autograd.grad(phi, leaves, allow_unused=True)))


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
_F32 = torch.float32
_I64 = torch.int64
# (kind, lmax) -> columns of the packed table, for every (kind, lmax) the
# kernels take ('uu' has one template, whatever lmax it is given)
_WIDTHS = {(k, lmax): _width(lmax, k) for k in KINDS for lmax in range(3)}
# C entry point of a block size -> pairs per thread block, read once
_block_sizes = {}


def _n_blocks(c: int, name: str) -> int:
    """Thread blocks of a launch over c pairs (admp_pair_block_size or
    admp_pair_hvp_block_size, read from the library once)."""
    size = _block_sizes.get(name)
    if size is None:
        size = _block_sizes[name] = _entry(name)()
    return -(-c // size)


# The launchers take the spread launchers' lean path (ops/cuda/entries.py):
# one pass of checks (_fits; the error that names a failure is worked out
# only then, by _refuse), the C entry point and the raw stream from
# entries, torch.empty, the call, the counts.


def _list_specs(kind, lmax, table, i, j, scl, scal):
    """K1/K2's inputs as (name, tensor, dtype, shape): the packed (N, F)
    table, the pair list's columns and the scale rows and scalars."""
    c = i.shape[0] if i.dim() == 1 else -1
    n = table.shape[0] if table.dim() == 2 else -1
    return (("table", table, _F32, (n, _WIDTHS[kind, lmax])),
            ("i", i, _I64, (c,)), ("j", j, _I64, (c,)),
            ("scl", scl, _F32, (_n_scl(kind), c)),
            ("scal", scal, _F32, (N_SCAL,)))


def _row_specs(kind, lmax, g_i, g_j, scl, scal):
    """K3/K3b's inputs as (name, tensor, dtype, shape): the gathered (C, F)
    rows of both sites, the scale rows and scalars."""
    c, f = g_i.shape[0], _WIDTHS[kind, lmax]
    return (("g_i", g_i, _F32, (c, f)), ("g_j", g_j, _F32, (c, f)),
            ("scl", scl, _F32, (_n_scl(kind), c)),
            ("scal", scal, _F32, (N_SCAL,)))


def _fits(kind, lmax, specs, inputs, operands=()):
    """Whether the kernels take the inputs as they are: a (kind, lmax) they
    have a template for, ``specs(kind, lmax, *inputs)`` contiguous of their
    dtypes and shapes on one CUDA device, and ``operands`` ((name, tensor,
    shape)) float32 of their shapes on the same device, of any strides."""
    if (kind, lmax) not in _WIDTHS:
        return False
    dev = inputs[0].get_device()
    return dev >= 0 and all(
        t.dtype is dtype and t.shape == shape and t.is_contiguous()
        and t.get_device() == dev
        for _, t, dtype, shape in specs(kind, lmax, *inputs)) and all(
        t.dtype is _F32 and t.shape == shape and t.get_device() == dev
        for _, t, shape in operands)


def _refuse(kind, lmax, specs, inputs, operands=()):
    """Raise the ValueError that names the first thing the kernels cannot
    take: the kind, lmax, every input's shape, then every input's type and
    device (all on the first input's), then each operand (name, tensor,
    shape)."""
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r}: expected one of {tuple(KINDS)}")
    if not 0 <= lmax <= 2:
        raise ValueError(f"lmax={lmax}: the kernel takes 0..2")
    named = specs(kind, lmax, *inputs)
    for name, t, _, shape in named:
        if tuple(t.shape) != shape:
            want = f"(N, {shape[1]})" if name == "table" else shape
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want}")
    first = named[0][1]
    for name, t, dtype, _ in named:
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous "
                             f"{str(dtype)[6:]} CUDA tensor")
        if t.device != first.device:
            raise ValueError(f"{name}: on {t.device}, {named[0][0]} on "
                             f"{first.device}")
    for name, t, shape in operands:
        if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
                or t.device != first.device):
            raise ValueError(f"{name}: needs a float32 tensor of shape "
                             f"{tuple(shape)} on {first.device}")
    raise ValueError(f"pair tables ({kind}, lmax={lmax}): not taken")


def _dense(t):
    """t contiguous (PyTorch hands zero cotangents and an expanded ``ct``
    with zero strides)."""
    return t if t.is_contiguous() else t.contiguous()


def launch_pair_fwd(table, i, j, scl, scal, lmax: int, kind: str):
    """K1: per-pair energies (C,) of rows table[i], table[j] of the packed
    (N, F) atom table; a pair masked or with an index outside [0, N) reads
    nothing and has energy 0. Counted as ``pairs.indexed`` too."""
    inputs = (table, i, j, scl, scal)
    if not _fits(kind, lmax, _list_specs, inputs):
        _refuse(kind, lmax, _list_specs, inputs)
    c = i.shape[0]
    e = torch.empty(c, dtype=_F32, device=table.device)
    if c == 0:
        return e
    status = _entry("admp_pair_fwd")(
        *(_P(t.data_ptr()) for t in (table, i, j, scl, scal, e)),
        table.shape[0], c, KINDS[kind], lmax,
        _P(_raw_stream(table.get_device())))
    if status:
        build.check(status, f"pair forward ({kind}, lmax={lmax})")
    launch_pair_fwd.launches += 1
    launch_pair_fwd.by_kind[kind] += 1
    profiling.count("pairs.indexed")
    return e


launch_pair_fwd.launches = 0
launch_pair_fwd.by_kind = dict.fromkeys(KINDS, 0)  # the launches per kind


def launch_pair_bwd(table, i, j, scl, scal, ct, lmax: int, kind: str,
                    wants=(True, True, True)):
    """K2: the gradients of sum(ct * e) with respect to (table, scl, scal),
    each None unless ``wants`` asks for it. The table's comes from the
    kernel's atomics into an (N, F rounded up to 4) table, as its first F
    columns (a view); a pair masked or with an index outside [0, N) adds
    nothing. Counted as ``pairs.indexed`` too."""
    inputs = (table, i, j, scl, scal)
    c = i.shape[0]
    if not _fits(kind, lmax, _list_specs, inputs, (("ct", ct, (c,)),)):
        _refuse(kind, lmax, _list_specs, inputs, (("ct", ct, (c,)),))
    want_table, want_scl, want_scal = wants
    n, f = table.shape
    dtab = (torch.empty(n, -(-f // 4) * 4, dtype=_F32, device=table.device)
            if want_table else None)
    dscl = torch.empty_like(scl) if want_scl else None
    if c == 0:
        if dtab is not None:
            dtab.zero_()
        dscal = torch.zeros_like(scal) if want_scal else None
        return None if dtab is None else dtab[:, :f], dscl, dscal
    ct = _dense(ct)
    dscal_blocks = torch.empty(_n_blocks(c, "admp_pair_block_size"), N_SCAL,
                               dtype=_F32, device=table.device)
    status = _entry("admp_pair_bwd")(
        *(_P(t.data_ptr()) for t in (table, i, j, scl, scal, ct)),
        *(_P(None if t is None else t.data_ptr()) for t in (dtab, dscl)),
        _P(dscal_blocks.data_ptr()), n, c, KINDS[kind], lmax,
        _P(_raw_stream(table.get_device())))
    if status:
        build.check(status, f"pair backward ({kind}, lmax={lmax})")
    launch_pair_bwd.launches += 1
    launch_pair_bwd.by_kind[kind] += 1
    profiling.count("pairs.indexed")
    # the blocks' sums in a fixed order: deterministic
    dscal = dscal_blocks.sum(dim=0) if want_scal else None
    return None if dtab is None else dtab[:, :f], dscl, dscal


launch_pair_bwd.launches = 0
launch_pair_bwd.by_kind = dict.fromkeys(KINDS, 0)  # the launches per kind


def launch_pair_hvp(g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl, c_scal,
                    lmax: int, kind: str):
    """K3: the VJP of K2 at cotangents (c_gi, c_gj, c_scl, c_scal) of its
    outputs. Returns (d_gi, d_gj, d_scl, d_scal, d_ct): ct H c for every
    input of the pair energies and J c for ct."""
    dev = g_i.get_device()
    c = g_i.shape[0]
    inputs = (g_i, g_j, scl, scal)
    ops = (ct, c_gi, c_gj, c_scl, c_scal)
    named = tuple(zip(("ct", "c_gi", "c_gj", "c_scl", "c_scal"), ops,
                      ((c,), g_i.shape, g_j.shape, scl.shape, scal.shape)))
    if not _fits(kind, lmax, _row_specs, inputs, named):
        _refuse(kind, lmax, _row_specs, inputs, named)
    dgi = torch.empty_like(g_i)
    dgj = torch.empty_like(g_j)
    dscl = torch.empty_like(scl)
    dct = torch.empty(c, dtype=_F32, device=g_i.device)
    if c == 0:
        return dgi, dgj, dscl, torch.zeros_like(scal), dct
    dscal_blocks = torch.empty(_n_blocks(c, "admp_pair_hvp_block_size"),
                               N_SCAL, dtype=_F32, device=g_i.device)
    ops = tuple(map(_dense, ops))  # held until the launch has read them
    status = _entry("admp_pair_hvp")(
        *(_P(t.data_ptr()) for t in (g_i, g_j, scl, scal, *ops,
                                     dgi, dgj, dscl, dct, dscal_blocks)),
        c, KINDS[kind], lmax, _P(_raw_stream(dev)))
    if status:
        build.check(status, f"pair HVP ({kind}, lmax={lmax})")
    launch_pair_hvp.launches += 1
    launch_pair_hvp.by_kind[kind] += 1
    return dgi, dgj, dscl, dscal_blocks.sum(dim=0), dct


launch_pair_hvp.launches = 0
launch_pair_hvp.by_kind = dict.fromkeys(KINDS, 0)  # the launches per kind


def launch_pair_third(g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl, c_scal,
                      h_gi, h_gj, h_scl, h_scal, h_ct, lmax: int, kind: str):
    """K3b: the VJP of K3 at cotangents (h_gi, h_gj, h_scl, h_scal, h_ct) of
    its outputs. Returns the cotangents of K3's inputs (x_gi, x_gj, x_scl,
    x_scal, x_ct, x_cgi, x_cgj, x_cscl, x_cscal): ct T[c, h] + h_ct H c for
    the tables, h^T H c for ct, ct H h + h_ct grad e for the direction."""
    dev = g_i.get_device()
    c = g_i.shape[0]
    inputs = (g_i, g_j, scl, scal)
    ops = (ct, c_gi, c_gj, c_scl, c_scal, h_gi, h_gj, h_scl, h_scal, h_ct)
    shapes = ((c,), g_i.shape, g_j.shape, scl.shape, scal.shape)
    # in the order the error names them: K3's operands, then h_ct and the
    # other cotangents of K3's outputs
    named = tuple(zip(
        ("ct", "c_gi", "c_gj", "c_scl", "c_scal", "h_ct", "h_gi", "h_gj",
         "h_scl", "h_scal"), ops[:5] + (h_ct,) + ops[5:9],
        shapes + shapes))
    if not _fits(kind, lmax, _row_specs, inputs, named):
        _refuse(kind, lmax, _row_specs, inputs, named)
    out = [torch.empty_like(t) for t in (g_i, g_j, scl)]
    dct = torch.empty(c, dtype=_F32, device=g_i.device)
    outc = [torch.empty_like(t) for t in (g_i, g_j, scl)]
    if c == 0:
        zero = torch.zeros_like(scal)
        return (*out, zero, dct, *outc, zero)
    dscal_blocks = torch.empty(_n_blocks(c, "admp_pair_third_block_size"), 2,
                               N_SCAL, dtype=_F32, device=g_i.device)
    ops = tuple(map(_dense, ops))  # held until the launch has read them
    status = _entry("admp_pair_third")(
        *(_P(t.data_ptr()) for t in (g_i, g_j, scl, scal, *ops,
                                     *out, dct, *outc, dscal_blocks)),
        c, KINDS[kind], lmax, _P(_raw_stream(dev)))
    if status:
        build.check(status, f"pair third derivative ({kind}, lmax={lmax})")
    launch_pair_third.launches += 1
    launch_pair_third.by_kind[kind] += 1
    dscal = dscal_blocks.sum(dim=0)
    return (*out, dscal[0], dct, *outc, dscal[1])


launch_pair_third.launches = 0
launch_pair_third.by_kind = dict.fromkeys(KINDS, 0)  # the launches per kind


class PairHvpFn(torch.autograd.Function):
    """The pair energies' Hessian-vector products on the kernels: forward
    K3, backward K3b, the pair energies' third derivative (admp_tpu takes
    it on its XLA route, where JAX differentiates the plain pair energies;
    its Pallas HVP has no VJP). K3b's own backward is
    ``once_differentiable``: a fourth derivative raises. On CPU tensors
    its plain versions (``pair_hvp_torch``, ``pair_third_torch``)."""

    @staticmethod
    def forward(ctx, g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl, c_scal,
                lmax, kind):
        ctx.save_for_backward(g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl,
                              c_scal)
        ctx.lmax, ctx.kind = lmax, kind
        hvp = launch_pair_hvp if g_i.is_cuda else pair_hvp_torch
        return tuple(hvp(g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl, c_scal,
                         lmax, kind))

    @staticmethod
    @once_differentiable
    def backward(ctx, h_gi, h_gj, h_scl, h_scal, h_ct):
        third = launch_pair_third if h_gi.is_cuda else pair_third_torch
        return (*third(*ctx.saved_tensors, h_gi, h_gj, h_scl, h_scal, h_ct,
                       ctx.lmax, ctx.kind),
                None, None)


def _gather(table, i, j, scl):
    """What K1/K2 read of each pair, in the gathered layout of K3/K3b and
    the plain version: (rows table[i], rows table[j], the scale rows, i, j),
    a pair whose i or j lies outside [0, N) masked as the kernels mask it
    (its indices clamped into the table, its mask row 0)."""
    n = table.shape[0]
    inside = (i >= 0) & (i < n) & (j >= 0) & (j < n)
    keep = torch.ones_like(scl)
    keep[1] = inside
    i, j = i.clamp(0, n - 1), j.clamp(0, n - 1)
    return (table.index_select(0, i), table.index_select(0, j), scl * keep,
            i, j)


class PairTableBwdFn(torch.autograd.Function):
    """The pair energies' gradients with respect to the packed table, the
    scale rows and the scalars: forward K2 (the gathered plain version and
    its scatter for CPU tensors), returning only the gradients
    ``wants`` asks for (None for the others). Its backward, taken where a
    graph was asked for (the exact adjoint, force matching), gathers the
    rows, takes ``PairHvpFn`` (K3, and K3b for a third derivative) on the
    gathered layout, and scatters its row outputs back into the table
    (counted as ``pairs.gathered``)."""

    @staticmethod
    def forward(ctx, table, i, j, scl, scal, ct, lmax, kind, wants):
        ct = _dense(ct)
        ctx.save_for_backward(table, i, j, scl, scal, ct)
        ctx.lmax, ctx.kind = lmax, kind
        ctx.set_materialize_grads(False)
        if table.is_cuda:
            return launch_pair_bwd(table, i, j, scl, scal, ct, lmax, kind,
                                   wants)
        g_i, g_j, scl, i, j = _gather(table, i, j, scl)
        with torch.enable_grad():
            x = [t.detach().requires_grad_(True) for t in (g_i, g_j, scl,
                                                           scal)]
            e = pair_energies_torch(*x, lmax, kind)
            d_gi, d_gj, d_scl, d_scal = torch.autograd.grad((e * ct).sum(),
                                                            x)
        d_table = torch.zeros_like(table).index_add_(0, i, d_gi).index_add_(
            0, j, d_gj)
        return tuple(t if w else None for t, w in zip(
            (d_table, d_scl, d_scal), wants))

    @staticmethod
    def backward(ctx, h_table, h_scl, h_scal):
        table, i, j, scl, scal, ct = ctx.saved_tensors
        profiling.count("pairs.gathered")
        g_i, g_j, scl, i, j = _gather(table, i, j, scl)
        if h_table is None:
            c_gi, c_gj = torch.zeros_like(g_i), torch.zeros_like(g_j)
        else:
            c_gi, c_gj = h_table.index_select(0, i), h_table.index_select(0, j)
        c_scl = torch.zeros_like(scl) if h_scl is None else h_scl
        c_scal = torch.zeros_like(scal) if h_scal is None else h_scal
        d_gi, d_gj, d_scl, d_scal, d_ct = PairHvpFn.apply(
            g_i, g_j, scl, scal, ct, c_gi, c_gj, c_scl.contiguous(),
            c_scal.contiguous(), ctx.lmax, ctx.kind)
        d_table = torch.zeros_like(table).index_add(0, i, d_gi).index_add(
            0, j, d_gj)
        return d_table, None, None, d_scl, d_scal, d_ct, None, None, None


class PairTableEnergyFn(torch.autograd.Function):
    """Per-pair energies of rows ``table[i]``, ``table[j]`` of the packed
    atom table: forward K1 (``index_select`` and the plain version for CPU
    tensors), backward ``PairTableBwdFn`` (K2), whose own
    backward takes the gathered K3: three times differentiable. The table's
    gradient never passes through a (C, F) gathered table on the first
    derivative."""

    @staticmethod
    def forward(ctx, table, i, j, scl, scal, lmax, kind):
        ctx.save_for_backward(table, i, j, scl, scal)
        ctx.lmax, ctx.kind = lmax, kind
        if table.is_cuda:
            return launch_pair_fwd(table, i, j, scl, scal, lmax, kind)
        return pair_energies_torch(*_gather(table, i, j, scl)[:3], scal, lmax,
                                   kind)

    @staticmethod
    def backward(ctx, ct):
        table, i, j, scl, scal = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_table, d_scl, d_scal = PairTableBwdFn.apply(
            table, i, j, scl, scal, ct, ctx.lmax, ctx.kind,
            (need[0], need[3], need[4]))
        return d_table, None, None, d_scl, d_scal, None, None


def pair_energies_indexed(table, i, j, scl, scal, lmax: int,
                          kind: str = "perm"):
    """Per-pair masked energies (C,) of the pairs (i[p], j[p]) of the packed
    (N, F) atom table: K1/K2 for CUDA tensors (raising for tensors they
    cannot take), the plain version for CPU tensors; the caller picks the
    route (ops/cuda.use_kernel). A pair whose i or j lies outside [0, N)
    (a padding slot) is masked. Right for any pair order; an i-sorted list
    makes K2's adds cheaper."""
    return PairTableEnergyFn.apply(
        table.contiguous(), i.contiguous(), j.contiguous(), scl.contiguous(),
        scal.contiguous(), lmax, kind)
