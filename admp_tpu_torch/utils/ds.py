"""Double-single (two-float32) arithmetic (admp_tpu/utils/ds.py): values of
~47 significant bits as (hi, lo) pairs of float32 tensors.

A DS number is a tuple ``(hi, lo)`` of same-shape (or broadcastable) float32
tensors with x ~= hi + lo and |lo| <= ulp(hi)/2; every operation assumes and
restores that normalisation. The error-free transforms are Dekker's and
Knuth's and assume that each ``+``, ``-`` and ``*`` rounds once: this module
uses only plain binary tensor operations (no ``alpha=`` arguments,
``addcmul``, ``lerp`` or other fused helpers, no ``torch.compile``), and
eager PyTorch runs each as its own kernel, so nothing is contracted into a
fused multiply-add. ``two_prod`` uses Dekker splitting (exact for
|a| < 2^115).

Scalar constants are float64 numbers split on the host (``const``) into a
pair of Python floats that are exact in float32; ``_bc`` puts such a pair on
the device of a DS tensor with ``new_full`` (a fill, never a host-to-device
copy, which would wait for the queued work). No division ever takes a Python
number as its divisor: PyTorch divides a CUDA tensor by a host scalar as a
multiplication by its reciprocal, which rounds twice.

Reverse-mode autodiff through these transforms degrades to plain f32 (in
exact arithmetic every compensation term is identically zero, so autograd
differentiates the uncompensated function): the engine built on them
(ops/dsrecip.py) takes its first derivatives from a hand-written adjoint.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# 2^ceil(24/2) + 1: Dekker splitter for the 24-bit f32 mantissa
_SPLIT = 4097.0
_F32 = torch.float32


def f32(x):
    return torch.as_tensor(x, dtype=_F32)


def ds(hi, lo=None):
    """A DS pair from float32 tensors (lo defaults to zero)."""
    hi = f32(hi)
    return (hi, torch.zeros_like(hi) if lo is None else f32(lo).to(hi.device))


def const(x):
    """A float64 scalar split into an exact DS pair of Python floats."""
    hi = np.float32(x)
    return (float(hi), float(np.float32(np.float64(x) - np.float64(hi))))


def from_f64(x, device=None):
    """A float64 array (or tensor) split into an exact DS pair of float32
    tensors on ``device``."""
    if torch.is_tensor(x):
        x64 = x.to(device=device, dtype=torch.float64)
        hi = x64.to(_F32)
        return hi, (x64 - hi.to(torch.float64)).to(_F32)
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return (torch.as_tensor(hi, device=device),
            torch.as_tensor(lo, device=device))


def to_f64(a):
    """hi + lo in float64 (a tensor on the pair's device)."""
    return a[0].to(torch.float64) + a[1].to(torch.float64)


def _bc(c, like):
    """A DS constant (a ``const`` pair, or a pair of 0-dim tensors) as 0-dim
    float32 tensors on the device of the DS tensor ``like``; they broadcast
    against it."""
    ref = like[0]
    if torch.is_tensor(c[0]):
        return (c[0].to(ref.device), c[1].to(ref.device))
    return (ref.new_full((), c[0]), ref.new_full((), c[1]))


def two_sum(a, b):
    """Error-free a + b (Knuth): s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b (Dekker, FMA-free): p + e == a * b exactly."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(a, b):
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return quick_two_sum(s, e)


def neg(a):
    return (-a[0], -a[1])


def sub(a, b):
    return add(a, neg(b))


def add_f(a, b):
    """DS + plain f32 (a tensor, or a Python number exact in f32)."""
    s, e = two_sum(a[0], b)
    e = e + a[1]
    return quick_two_sum(s, e)


def mul(a, b):
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def mul_f(a, b):
    """DS * plain f32 (a tensor, or a Python number exact in f32)."""
    if not torch.is_tensor(b):
        b = a[0].new_full((), b)
    p, e = two_prod(a[0], b)
    e = e + a[1] * b
    return quick_two_sum(p, e)


def mul_pow2(a, p):
    """Exact scaling by a power of two."""
    return (a[0] * p, a[1] * p)


def div(a, b):
    q1 = a[0] / b[0]
    r = sub(a, mul_f(b, q1))
    q2 = r[0] / b[0]
    r = sub(r, mul_f(b, q2))
    q3 = r[0] / b[0]
    s, e = quick_two_sum(q1, q2)
    return add_f((s, e), q3)


def recip(b):
    return div(ds(torch.ones_like(b[0])), b)


def sqrt(a):
    """DS square root (one Karp-Markstein refinement of the f32 root)."""
    y = torch.sqrt(a[0])
    zero = y == 0.0
    y_safe = torch.where(zero, torch.ones_like(y), y)
    # r = (a - y^2) / (2y);  sqrt(a) ~= y + r
    diff = sub(a, two_prod(y, y))
    r = diff[0] / (2.0 * y_safe)
    out = quick_two_sum(y, r)
    return (torch.where(zero, torch.zeros_like(y), out[0]),
            torch.where(zero, torch.zeros_like(y), out[1]))


def npow(a, n: int):
    """Integer power by repeated squaring."""
    if n < 1:
        raise ValueError(f"npow needs n >= 1, got {n}")
    result = None
    base = a
    while n:
        if n & 1:
            result = base if result is None else mul(result, base)
        n >>= 1
        if n:
            base = mul(base, base)
    return result


def poly(x, coeffs_f64):
    """Horner evaluation with exact DS-split float64 coefficients (highest
    order first)."""
    cs = [const(c) for c in np.asarray(coeffs_f64, np.float64)]
    c0 = _bc(cs[0], x)
    acc = (c0[0].expand_as(x[0]), c0[1].expand_as(x[0]))
    for c in cs[1:]:
        acc = add(mul(acc, x), _bc(c, x))
    return acc


_LN2 = const(math.log(2.0))
_INV_LN2 = float(1.0 / np.log(2.0))
# exp Taylor 1 + r + r^2/2 + ... + r^9/9!  (|r| <= ln2/2: error ~ 2e-11 rel)
_EXP_COEFFS = np.array([1.0 / math.factorial(k) for k in range(9, -1, -1)])


def pow2(n):
    """2^n (float32) for an int32 tensor n in [-126, 127], assembled from the
    exponent bits: exact, where a multiplication by pow(2, n) (which
    ``torch.ldexp`` does) is exact only if the library's pow is."""
    return ((n.to(torch.int32) + 127) << 23).view(_F32)


def exp(a):
    """DS exp. Relative error ~1e-11 over the force-field range (arguments
    in [-90, 90]); underflows to 0 below exp(-87)."""
    k = torch.round(a[0] * _INV_LN2)
    r = sub(a, mul_f(_bc(_LN2, a), k))
    e_r = poly(r, _EXP_COEFFS)
    # split k so the hi/lo parts scale without intermediate under/overflow
    ki = torch.clamp(k, -252.0, 252.0).to(torch.int32)
    half1 = torch.div(ki, 2, rounding_mode="floor")
    half2 = ki - half1
    s1, s2 = pow2(half1), pow2(half2)
    return (e_r[0] * s1 * s2, e_r[1] * s1 * s2)


# Cody (1969) rational Chebyshev coefficients for erf/erfc (the netlib
# CALERF/SPECFUN constants)
_ERF_A = np.array([3.16112374387056560e00, 1.13864154151050156e02,
                   3.77485237685302021e02, 3.20937758913846947e03,
                   1.85777706184603153e-1])
_ERF_B = np.array([2.36012909523441209e01, 2.44024637934444173e02,
                   1.28261652607737228e03, 2.84423683343917062e03])
_ERF_C = np.array([5.64188496988670089e-1, 8.88314979438837594e00,
                   6.61191906371416295e01, 2.98635138197400131e02,
                   8.81952221241769090e02, 1.71204761263407058e03,
                   2.05107837782607147e03, 1.23033935479799725e03,
                   2.15311535474403846e-8])
_ERF_D = np.array([1.57449261107098347e01, 1.17693950891312499e02,
                   5.37181101862009858e02, 1.62138957456669019e03,
                   3.29079923573345963e03, 4.36261909014324716e03,
                   3.43936767414372164e03, 1.23033935480374942e03])
_ERF_P = np.array([3.05326634961232344e-1, 3.60344899949804439e-1,
                   1.25781726111229246e-1, 1.60837851487422766e-2,
                   6.58749161529837803e-4, 1.63153871373020978e-2])
_ERF_Q = np.array([2.56852019228982242e00, 1.87295284992346047e00,
                   5.27905102951428412e-1, 6.05183413124413191e-2,
                   2.33520497626869185e-3])
_INV_SQRT_PI = 5.6418958354775628695e-1


def _where(c, a, b):
    return (torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1]))


def _ones(y):
    return ds(torch.ones_like(y[0]))


def erfc(x):
    """DS complementary error function for x >= 0 (relative error ~1e-13);
    saturates to 0 past x ~ 9.2 (erfc < 1e-38, below f32 range)."""
    y = x
    ysq = mul(y, y)

    # region 1: x < 0.46875 -- erfc = 1 - x P(x^2)/Q(x^2)
    z = ysq
    xnum = mul(z, _bc(const(_ERF_A[4]), z))
    xden = z
    for i in range(3):
        xnum = mul(add(xnum, _bc(const(_ERF_A[i]), z)), z)
        xden = mul(add(xden, _bc(const(_ERF_B[i]), z)), z)
    r1 = div(add(xnum, _bc(const(_ERF_A[3]), z)),
             add(xden, _bc(const(_ERF_B[3]), z)))
    erfc1 = sub(_ones(y), mul(y, r1))

    exp_m = exp(neg(ysq))

    # region 2: 0.46875 <= x < 4 -- erfc = exp(-x^2) P(x)/Q(x)
    y_s = _where(y[0] >= 0.46875, y, _ones(y))
    xnum = mul(y_s, _bc(const(_ERF_C[8]), y))
    xden = y_s
    for i in range(7):
        xnum = mul(add(xnum, _bc(const(_ERF_C[i]), y)), y_s)
        xden = mul(add(xden, _bc(const(_ERF_D[i]), y)), y_s)
    r2 = div(add(xnum, _bc(const(_ERF_C[7]), y)),
             add(xden, _bc(const(_ERF_D[7]), y)))
    erfc2 = mul(exp_m, r2)

    # region 3: x >= 4 -- erfc = exp(-x^2)/x (1/sqrt(pi) - z P(z)/Q(z)),
    # z = 1/x^2
    big = y[0] >= 4.0
    z3 = recip(_where(big, ysq, _ones(y)))
    xnum = mul(z3, _bc(const(_ERF_P[5]), y))
    xden = z3
    for i in range(4):
        xnum = mul(add(xnum, _bc(const(_ERF_P[i]), y)), z3)
        xden = mul(add(xden, _bc(const(_ERF_Q[i]), y)), z3)
    r3 = mul(z3, div(add(xnum, _bc(const(_ERF_P[4]), y)),
                     add(xden, _bc(const(_ERF_Q[4]), y))))
    r3 = sub(_bc(const(_INV_SQRT_PI), y), r3)
    erfc3 = mul(exp_m, div(r3, _where(big, y, _ones(y))))

    return _where(y[0] < 0.46875, erfc1, _where(big, erfc3, erfc2))


def sum_pairs(a, dim=None):
    """Sum a DS tensor with pairwise DS additions along ``dim`` (all
    elements when None): a tree whose error is O(eps^2 log n).

    Each level adds the even- and odd-indexed halves (two strided views,
    one DS add); an odd-length tail element is folded into slot 0 of the
    halved tensor."""
    hi, lo = a
    if dim is None:
        hi, lo, dim = hi.reshape(-1), lo.reshape(-1), 0
    dim = dim % hi.dim()
    n = hi.shape[dim]
    while n > 1:
        half = n // 2
        even = (hi.narrow(dim, 0, 2 * half)[_strided(dim, 0)],
                lo.narrow(dim, 0, 2 * half)[_strided(dim, 0)])
        odd = (hi.narrow(dim, 0, 2 * half)[_strided(dim, 1)],
               lo.narrow(dim, 0, 2 * half)[_strided(dim, 1)])
        ph, pl = add(even, odd)
        if n % 2:
            head = add((ph.narrow(dim, 0, 1), pl.narrow(dim, 0, 1)),
                       (hi.narrow(dim, n - 1, 1), lo.narrow(dim, n - 1, 1)))
            ph = torch.cat([head[0], ph.narrow(dim, 1, half - 1)], dim)
            pl = torch.cat([head[1], pl.narrow(dim, 1, half - 1)], dim)
        hi, lo = ph, pl
        n = half
    return (hi.select(dim, 0), lo.select(dim, 0))


def _strided(dim, start):
    return (slice(None),) * dim + (slice(start, None, 2),)
