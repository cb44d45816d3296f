"""Double-single (two-float32) reciprocal PME (admp_tpu/ops/dsrecip.py).

The reciprocal path rebuilt in the double-single arithmetic of utils/ds.py:

* DS B-spline weights (the piece polynomials of ops/bsplines.py with
  DS-split coefficients);
* an exact fixed-point two-pass f32 scatter for the mesh (the quantized pass
  is error-free in any summation order, atomics included; the residual pass
  rounds at ~2^-26 of the mesh scale);
* DS radix-2 complex FFTs with exact-split twiddles, the DS influence
  weights and a pairwise-tree Parseval sum;
* a hand-written adjoint: autograd through error-free transforms degrades
  to plain f32 (utils/ds.py), so the backward of ``_DSRecipFn`` evaluates the
  analytic force formulas in DS (the potential mesh 2 Re F(conj(w S)), the
  stencil gathers, the spline-derivative chain one order above the forward
  channels).

Scope as in admp_tpu: electrostatic PME (ck_1 influence, gamma excluded),
order-6 splines, lmax <= 2, power-of-two grids (a grid that is not raises
``ValueError``). Differentiable with respect to positions and multipoles;
the box is guarded (a warning and a zero gradient, ``_DSBoxGuard``).

What differs from admp_tpu, and why:

* The computation is vectorised over the loops admp_tpu unrolls in its
  trace (spline pieces, separable terms, harmonic channels, the adjoint's
  stencil contractions, the box's cofactors): eager PyTorch launches one
  kernel per operation, so each DS operation runs once over a stacked
  tensor. Each element sees the same operations in the same order. The FFTs
  are iterative (a bit-reversal gather, then one vectorised butterfly level
  per stage) where admp_tpu recurses on even/odd halves: the butterflies
  and twiddles are the same.
* Constants (twiddles, spline coefficients, theta^2, the integer
  frequencies, the grid sizes and every index list of the gathers) are put
  on the device once per engine (``_DSTables``): a host-to-device copy in
  the step would wait for the queued work.
* The energy comes back in float64 (hi + lo): torch has no global x64
  switch, and admp_tpu returns that sum under x64 (its tests' setting).
* Second derivatives (the polarizable exact adjoint differentiates the
  field, itself this engine's gradient): JAX differentiates the custom_vjp's
  rules as traced code. Here the backward recomputes the forward pieces from
  the saved inputs with autograd on when it is itself differentiated
  (``torch.is_grad_enabled()`` in the backward), and evaluates the adjoint
  in differentiable operations, so the residuals' dependence on positions
  and multipoles is tracked; like JAX's, those second derivatives carry
  plain-f32 accuracy.
* The backward gathers the potential window with a flat index gather:
  admp_tpu's lane-aligned row gather (ops/pallas/spread._row_gather_impl) is
  a TPU layout device, bitwise equal to it.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from admp_tpu_torch.ops import bsplines
from admp_tpu_torch.utils import ds
from admp_tpu_torch.utils.constants import DIELECTRIC

RT3 = 1.7320508075688772
_F32 = torch.float32

# separable derivative multi-indices, in the order of
# ops/reciprocal._SEP_TERMS
_SEP = [(0, 0, 0),
        (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2)]
# the adjoint's partial contractions, in admp_tpu's loop order: (q, r) pairs
# and (p, q, r) triples of total derivative order <= 3
_QR = [(q, r) for r in range(4) for q in range(4 - r)]
_PQR = [(p, q, r) for r in range(4) for q in range(4 - r)
        for p in range(4 - r - q)]
_PQR_ROW = {k: n for n, k in enumerate(_PQR)}


class _DSTables:
    """Constants of one engine, built on the host and put on each device
    once: {(name, device): tensors}."""

    def __init__(self):
        self._store = {}

    def get(self, name, device, make):
        key = (name, str(device))
        if key not in self._store:
            out = make()
            self._store[key] = tuple(torch.as_tensor(t).to(device)
                                     for t in out)
        return self._store[key]


def _tables_of(tables):
    return _DSTables() if tables is None else tables


def _grid_sizes(grid_shape, tables, device):
    """The grid sizes (K1, K2, K3) as a float32 tensor on ``device``."""
    return tables.get(f"kk{tuple(grid_shape)}", device, lambda: (
        np.asarray(grid_shape, np.float32),))[0]


# ---------------------------------------------------------------------------
# DS spline tables
# ---------------------------------------------------------------------------


def _split_table(table):
    t = np.asarray(table, np.float64)
    hi = t.astype(np.float32)
    return hi, (t - hi.astype(np.float64)).astype(np.float32)


def _ds_eval_pieces(u0, coeff_table, tables=None, name="C"):
    """DS evaluation of the spline pieces: u0 DS (N, 3) -> DS (N, order, 3),
    piece k at u = u0 + k - order/2."""
    order = coeff_table.shape[0]
    dev = u0[0].device
    hi, lo, offs = _tables_of(tables).get(
        "pieces" + name, dev,
        lambda: _split_table(coeff_table)
        + ((np.arange(order)[:, None] - order / 2.0).astype(np.float32),))
    u = ds.add_f((u0[0][:, None, :], u0[1][:, None, :]), offs)
    acc = (hi[:, -1:], lo[:, -1:])
    for p in range(coeff_table.shape[1] - 2, -1, -1):
        acc = ds.add(ds.mul(acc, u), (hi[:, p:p + 1], lo[:, p:p + 1]))
    return acc


def ds_spline_tables(u0, tables=None):
    """(B, B', B'', B''') at the 6 stencil offsets per dimension, each DS
    (N, 6, 3)."""
    return tuple(_ds_eval_pieces(u0, c, tables, name)
                 for c, name in ((bsplines._C, "C"), (bsplines._C1, "C1"),
                                 (bsplines._C2, "C2"), (bsplines._C3, "C3")))


# ---------------------------------------------------------------------------
# DS complex FFT (radix-2 DIT, exact-split twiddles)
# ---------------------------------------------------------------------------


def _bitrev(n):
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _twiddles(n, tables, device):
    """cos, sin of -2 pi k / n for k < n/2, each DS."""
    def make():
        ang = -2.0 * np.pi * np.arange(n // 2) / n
        return _split_table(np.cos(ang)) + _split_table(np.sin(ang))

    t = tables.get(f"tw{n}", device, make)
    return (t[0], t[1]), (t[2], t[3])


def _cmul(ar, ai, br, bi):
    rr = ds.sub(ds.mul(ar, br), ds.mul(ai, bi))
    ri = ds.add(ds.mul(ar, bi), ds.mul(ai, br))
    return rr, ri


def _select(a, dim, idx):
    return (a[0].index_select(dim, idx), a[1].index_select(dim, idx))


def _ds_fft_axis(re, im, dim, tables=None):
    """DS complex FFT along ``dim`` (length a power of two): the bit-reversal
    gather, then one butterfly level per stage, each over the whole tensor.
    Level m combines the halves E, O of every block of m as
    (E + w^k O, E - w^k O), w = e^{-2 pi i / m}: admp_tpu's even/odd
    recursion (dsrecip.py:103-133) unrolled."""
    tables = _tables_of(tables)
    dim = dim % re[0].dim()
    n = re[0].shape[dim]
    if n & (n - 1):
        raise ValueError(f"the DS FFT needs power-of-two lengths, got {n}")
    if n == 1:
        return re, im
    dev = re[0].device
    (perm,) = tables.get(f"bitrev{n}", dev, lambda: (_bitrev(n),))
    re, im = _select(re, dim, perm), _select(im, dim, perm)
    shape = re[0].shape
    pre, post = shape[:dim], shape[dim + 1:]
    m = 2
    while m <= n:
        h = m // 2
        view = pre + (n // m, 2, h) + post

        def halves(a):
            va, vb = a[0].reshape(view), a[1].reshape(view)
            return ((va.select(dim + 1, 0), vb.select(dim + 1, 0)),
                    (va.select(dim + 1, 1), vb.select(dim + 1, 1)))

        (er, orr), (ei, oi) = halves(re), halves(im)
        wr, wi = _twiddles(m, tables, dev)
        wshape = (h,) + (1,) * len(post)
        wr = (wr[0].reshape(wshape), wr[1].reshape(wshape))
        wi = (wi[0].reshape(wshape), wi[1].reshape(wshape))
        tr, ti = _cmul(orr, oi, wr, wi)
        top_r, top_i = ds.add(er, tr), ds.add(ei, ti)
        bot_r, bot_i = ds.sub(er, tr), ds.sub(ei, ti)

        def join(top, bot):
            return tuple(torch.stack([t, b], dim + 1).reshape(shape)
                         for t, b in zip(top, bot))

        re, im = join(top_r, bot_r), join(top_i, bot_i)
        m *= 2
    return re, im


def ds_fft_lead(re, im, n: int | None = None, tables=None):
    """DS complex FFT along the leading axis (admp_tpu's ``n`` is the
    axis length; checked when given)."""
    if n is not None and n != re[0].shape[0]:
        raise ValueError(f"n={n} but the leading axis has {re[0].shape[0]}")
    return _ds_fft_axis(re, im, 0, tables)


def ds_fft_last(re, im, n: int | None = None, tables=None):
    """DS complex FFT along the last axis."""
    if n is not None and n != re[0].shape[-1]:
        raise ValueError(f"n={n} but the last axis has {re[0].shape[-1]}")
    return _ds_fft_axis(re, im, -1, tables)


def _neg_index_map(x, dim, tables=None):
    """x[(-k) % K] along ``dim``."""
    k = x[0].shape[dim]
    (idx,) = _tables_of(tables).get(
        f"neg{k}", x[0].device, lambda: ((-np.arange(k)) % k,))
    return _select(x, dim, idx)


def _rtwiddles(k3, sign, tables, device):
    """cos, sin of sign 2 pi j / k3 for j < k3/2, each DS."""
    def make():
        ang = sign * 2.0 * np.pi * np.arange(k3 // 2) / k3
        return _split_table(np.cos(ang)) + _split_table(np.sin(ang))

    t = tables.get(f"rtw{k3}{sign:+d}", device, make)
    return (t[0], t[1]), (t[2], t[3])


def ds_rfft3(mesh, tables=None):
    """DS real-input 3D FFT -> the half spectrum (K1, K2, K3//2 + 1), complex
    DS: the z axis by the even/odd complex packing (one DS FFT of length
    K3/2 and an untangle), then axes 0 and 1 on the K3/2 + 1 columns."""
    tables = _tables_of(tables)
    k3 = mesh[0].shape[2]
    m = k3 // 2
    re = (mesh[0][..., 0::2], mesh[1][..., 0::2])  # z[2c] + i z[2c+1]
    im = (mesh[0][..., 1::2], mesh[1][..., 1::2])
    zr, zi = _ds_fft_axis(re, im, 2, tables)
    zmr = _neg_index_map(zr, 2, tables)  # conj(Z_{-k mod m})
    zmi = _neg_index_map(zi, 2, tables)
    er = ds.mul_pow2(ds.add(zr, zmr), 0.5)
    ei = ds.mul_pow2(ds.sub(zi, zmi), 0.5)
    orr = ds.mul_pow2(ds.add(zi, zmi), 0.5)
    oi = ds.mul_pow2(ds.neg(ds.sub(zr, zmr)), 0.5)
    wr, wi = _rtwiddles(k3, -1, tables, mesh[0].device)
    tr, ti = _cmul(orr, oi, wr, wi)
    xr, xi = ds.add(er, tr), ds.add(ei, ti)
    # Nyquist mode: E and O are m-periodic -> X_{K3/2} = E_0 - O_0
    first = lambda a: (a[0][..., :1], a[1][..., :1])  # noqa: E731
    nyq_r = ds.sub(first(er), first(orr))
    nyq_i = ds.sub(first(ei), first(oi))
    s_re = (torch.cat([xr[0], nyq_r[0]], 2), torch.cat([xr[1], nyq_r[1]], 2))
    s_im = (torch.cat([xi[0], nyq_i[0]], 2), torch.cat([xi[1], nyq_i[1]], 2))
    for dim in (0, 1):
        s_re, s_im = _ds_fft_axis(s_re, s_im, dim, tables)
    return s_re, s_im


def _hermitian_fill(s_re, s_im, k3: int, tables=None):
    """The full z spectrum from the half one:
    X[k1, k2, j] = conj(X[(-k1) % K1, (-k2) % K2, K3 - j]) for j >= K3h."""
    k3h = k3 // 2 + 1

    def fill(x, sign):
        body = (torch.flip(x[0][:, :, 1:k3h - 1], [2]),
                torch.flip(x[1][:, :, 1:k3h - 1], [2]))
        body = _neg_index_map(_neg_index_map(body, 0, tables), 1, tables)
        return (torch.cat([x[0], sign * body[0]], 2),
                torch.cat([x[1], sign * body[1]], 2))

    return fill(s_re, 1.0), fill(s_im, -1.0)


def ds_fft3(re, im, tables=None):
    """DS complex 3D FFT of (K1, K2, K3) DS tensors (powers of two)."""
    for dim in (2, 1, 0):
        re, im = _ds_fft_axis(re, im, dim, tables)
    return re, im


def ds_irfft3(s_re, s_im, tables=None):
    """Unnormalized inverse real 3D transform of a Hermitian half spectrum:
    x_n = sum_k X_k e^{+2 pi i k.n/K} over the full k grid, as the real
    (K1, K2, K3) DS mesh; the inverse counterpart of ``ds_rfft3``."""
    tables = _tables_of(tables)
    k3h = s_re[0].shape[2]
    m = k3h - 1
    k3 = 2 * m
    # axes 0, 1: sum_k X e^{+..} = conj(DFT(conj X))
    for dim in (0, 1):
        s_re, s_im = _ds_fft_axis(s_re, ds.neg(s_im), dim, tables)
        s_im = ds.neg(s_im)
    # z untangle (inverse of ds_rfft3's packing): with
    #   A_j = X_j + conj(X_{m-j}) = 2 E_j
    #   B_j = (X_j - conj(X_{m-j})) e^{+2 pi i j/K3} = 2 O_j     (j < m)
    # the even/odd samples interleave as
    #   x_{2t} + i x_{2t+1} = sum_j (A_j + i B_j) e^{+2 pi i jt/m}.
    dev = s_re[0].device
    (rev,) = tables.get(f"rev{m}", dev, lambda: (np.arange(m, 0, -1),))
    head = lambda a: (a[0][..., :m], a[1][..., :m])  # noqa: E731
    xjr, xji = head(s_re), head(s_im)
    cr, ci = _select(s_re, 2, rev), ds.neg(_select(s_im, 2, rev))
    ar, ai = ds.add(xjr, cr), ds.add(xji, ci)
    dr, di = ds.sub(xjr, cr), ds.sub(xji, ci)
    wr, wi = _rtwiddles(k3, 1, tables, dev)
    br, bi = _cmul(dr, di, wr, wi)
    zr = ds.add(ar, ds.neg(bi))  # Z = A + iB
    zi = ds.add(ai, br)
    # z_t = sum_j Z_j e^{+2 pi i jt/m} = conj(DFT(conj Z))
    zr, zi = _ds_fft_axis(zr, ds.neg(zi), 2, tables)
    zi = ds.neg(zi)
    shape = zr[0].shape[:2] + (k3,)
    return tuple(torch.stack([a, b], -1).reshape(shape)
                 for a, b in zip(zr, zi))


# ---------------------------------------------------------------------------
# DS geometry / k-space
# ---------------------------------------------------------------------------

# cofactor (i, j) of a 3x3 = b[i1, j1] b[i2, j2] - b[i1, j2] b[i2, j1] with
# (i1, i2), (j1, j2) the other rows and columns
_OTHER = [[1, 2], [0, 2], [0, 1]]
_O1 = [o[0] for o in _OTHER]
_O2 = [o[1] for o in _OTHER]


def _ds_inv3x3(b, tables=None):
    """DS inverse and determinant of a DS (3, 3) matrix: (inv DS (3, 3),
    det DS 0-dim)."""
    o1, o2, sign = _tables_of(tables).get("inv3x3", b[0].device, lambda: (
        np.asarray(_O1), np.asarray(_O2),
        np.asarray([[1.0, -1.0, 1.0], [-1.0, 1.0, -1.0], [1.0, -1.0, 1.0]],
                   np.float32)))

    def pick(rows, cols):
        return (b[0][rows][:, cols], b[1][rows][:, cols])

    cof = ds.sub(ds.mul(pick(o1, o1), pick(o2, o2)),
                 ds.mul(pick(o1, o2), pick(o2, o1)))
    m = ds.mul((b[0][0], b[1][0]), (cof[0][0], cof[1][0]))
    det = ds.add(ds.sub((m[0][0], m[1][0]), (m[0][1], m[1][1])),
                 (m[0][2], m[1][2]))
    c = (cof[0].T * sign, cof[1].T * sign)
    return ds.div(c, det), det


def _ds_box(box):
    """The f32 box as DS (lo = 0: the f32 input is the exact value)."""
    return ds.ds(box)


def _euler_theta_sq_axis(k: int):
    """Per-axis Euler factor theta (numpy f64)."""
    ang = 2.0 * np.pi * np.arange(k) / k
    return (bsplines.B6_KNOTS[2] + 2.0 * bsplines.B6_KNOTS[1] * np.cos(ang)
            + 2.0 * bsplines.B6_KNOTS[0] * np.cos(2.0 * ang))


def _int_freqs(k: int):
    f = np.arange(k)
    return np.where(f <= (k - 1) // 2, f, f - k).astype(np.float64)


def _kspace_weights_ds(box, grid_shape, kappa, rfft: bool = False,
                       tables=None):
    """DS influence weights w(k) = C(k^2)/theta^2 (k = 0 -> 0), C = ck_1 =
    2 pi exp(-k^2/4 kappa^2)/(V k^2). With ``rfft`` the last axis holds the
    K3//2 + 1 non-negative z modes."""
    tables = _tables_of(tables)
    k1, k2, k3 = grid_shape
    binv, det = _ds_inv3x3(_ds_box(box), tables)
    dev = box.device

    def make():
        f3 = (np.arange(k3 // 2 + 1, dtype=np.float64) if rfft
              else _int_freqs(k3))
        t3 = _euler_theta_sq_axis(k3)[:f3.shape[0]]
        theta = np.einsum("i,j,k->ijk", _euler_theta_sq_axis(k1),
                          _euler_theta_sq_axis(k2), t3)
        return ((_int_freqs(k1).astype(np.float32),
                 _int_freqs(k2).astype(np.float32), f3.astype(np.float32))
                + _split_table(theta * theta))

    f1, f2, f3, th_hi, th_lo = tables.get(f"kspace{rfft}", dev, make)
    # kvec_c = 2 pi (f1 binv[0][c] + f2 binv[1][c] + f3 binv[2][c]);
    # integer frequencies are exact in f32
    t1 = ds.mul_f((binv[0][0][None], binv[1][0][None]), f1[:, None])
    t2 = ds.mul_f((binv[0][1][None], binv[1][1][None]), f2[:, None])
    t3 = ds.mul_f((binv[0][2][None], binv[1][2][None]), f3[:, None])
    kc = ds.add(ds.add((t1[0][:, None, None], t1[1][:, None, None]),
                       (t2[0][None, :, None], t2[1][None, :, None])),
                (t3[0][None, None], t3[1][None, None]))
    kc2 = ds.mul(kc, kc)  # (K1, K2, K3n, 3)
    comp = lambda c: (kc2[0][..., c], kc2[1][..., c])  # noqa: E731
    ksq = ds.add(ds.add(comp(0), comp(1)), comp(2))
    ksq = ds.mul(ksq, ds._bc(ds.const(4.0 * np.pi ** 2), ksq))
    nonzero = ksq[0] > 0.0
    ksq_safe = (torch.where(nonzero, ksq[0], torch.ones_like(ksq[0])),
                torch.where(nonzero, ksq[1], torch.zeros_like(ksq[1])))
    inv4k = ds.const(1.0 / (4.0 * float(kappa) ** 2))
    e = ds.exp(ds.neg(ds.mul(ksq_safe, ds._bc(inv4k, ksq_safe))))
    c_k = ds.mul(ds.div(e, ksq_safe), ds.recip(det))
    c_k = ds.mul(c_k, ds._bc(ds.const(2.0 * np.pi), c_k))
    w = ds.div(c_k, (th_hi, th_lo))
    return (torch.where(nonzero, w[0], torch.zeros_like(w[0])),
            torch.where(nonzero, w[1], torch.zeros_like(w[1])))


_JL = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _ds_mixing_matrix(binv, grid_shape, lmax: int, tables=None):
    """DS mirror of ops/reciprocal.spread_mixing_matrix: the (H, T) constant
    folding the Cartesian chain rule into the harmonic channels, DS (H, T);
    dug[j][c] = N_j binv[c][j]."""
    tables = _tables_of(tables)
    kk = _grid_sizes(grid_shape, tables, binv[0].device)
    dug = ds.mul_f((binv[0].T, binv[1].T), kk[:, None])  # [j, c]
    n_h = (lmax + 1) ** 2
    n_t = {0: 1, 1: 4, 2: 10}[lmax]
    hi = binv[0].new_zeros(n_h, n_t)
    lo = binv[0].new_zeros(n_h, n_t)
    hi[0, 0].fill_(1.0)  # a setitem of a Python number copies it from host
    if lmax >= 1:
        for h, c in ((1, 2), (2, 0), (3, 1)):
            hi[h, 1:4] = -dug[0][:, c]
            lo[h, 1:4] = -dug[1][:, c]
    if lmax >= 2:
        # beta_jl(c, d) = dug[j][c] dug[l][d] (+ dug[l][c] dug[j][d], j != l)
        p = ds.mul((dug[0][:, None, :, None], dug[1][:, None, :, None]),
                   (dug[0][None, :, None, :], dug[1][None, :, None, :]))
        psum = ds.add(p, (p[0].transpose(0, 1), p[1].transpose(0, 1)))
        jj, ll, same = tables.get("jl", hi.device, lambda: (
            np.asarray([j for j, _ in _JL]), np.asarray([lv for _, lv in _JL]),
            np.asarray([j == lv for j, lv in _JL])[:, None, None]))
        beta = (torch.where(same, p[0][jj, ll], psum[0][jj, ll]),
                torch.where(same, p[1][jj, ll], psum[1][jj, ll]))  # (6,3,3)
        b = lambda c, d: (beta[0][:, c, d], beta[1][:, c, d])  # noqa: E731
        b00, b11, b22 = b(0, 0), b(1, 1), b(2, 2)
        tr = ds.add(ds.add(b00, b11), b22)
        rt3 = ds._bc(ds.const(RT3), b00)
        rows = [ds.mul_f(ds.sub(ds.mul_f(b22, 3.0), tr), 0.5),
                ds.mul(rt3, b(0, 2)), ds.mul(rt3, b(1, 2)),
                ds.mul_f(ds.mul(rt3, ds.sub(b00, b11)), 0.5),
                ds.mul(rt3, b(0, 1))]
        hi[4:9, 4:10] = torch.stack([r[0] for r in rows])
        lo[4:9, 4:10] = torch.stack([r[1] for r in rows])
    return hi, lo


def _ds_alpha(q_harm, mixing, lmax: int):
    """alpha[:, t] = sum_h q~_h M[h][t], DS (N, T) (q~ carries the MPID
    quadrupole 1/3)."""
    q = ds.ds(q_harm)
    if lmax >= 2:
        quad = ds.mul((q[0][:, 4:], q[1][:, 4:]),
                      ds._bc(ds.const(1.0 / 3.0), q))
        q = (torch.cat([q[0][:, :4], quad[0]], 1),
             torch.cat([q[1][:, :4], quad[1]], 1))
    prod = ds.mul((q[0][:, :, None], q[1][:, :, None]),
                  (mixing[0][None], mixing[1][None]))  # (N, H, T)
    return _ordered_sum(prod, 1)


def _ordered_sum(a, dim):
    """DS sum along ``dim`` by sequential adds (admp_tpu's loop order)."""
    acc = (a[0].select(dim, 0), a[1].select(dim, 0))
    for k in range(1, a[0].shape[dim]):
        acc = ds.add(acc, (a[0].select(dim, k), a[1].select(dim, k)))
    return acc


def _stack_tabs(tabs):
    return (torch.stack([t[0] for t in tabs]),
            torch.stack([t[1] for t in tabs]))


def _ds_q_points(alphas, tabs, lmax: int, tables=None):
    """Per-atom 6^3 stencil values sum_t alpha_t B^(p) (x) B^(q) (x) B^(r);
    tabs: DS (N, 6, 3) tables (B, B', B''). Returns DS (N, 6, 6, 6)."""
    n_t = alphas[0].shape[1]
    tab = _stack_tabs(tabs)  # (D, N, 6, 3)
    # the derivative order of each separable term along each axis
    sep = _tables_of(tables).get(f"sep{n_t}", tab[0].device, lambda: tuple(
        np.asarray([_SEP[t][k] for t in range(n_t)]) for k in range(3)))

    def axis(k):
        return (tab[0][sep[k]][..., k], tab[1][sep[k]][..., k])  # (T, N, 6)

    x, y, z = axis(0), axis(1), axis(2)
    a = (alphas[0].T[..., None], alphas[1].T[..., None])
    ax = ds.mul(a, x)
    xy = ds.mul((ax[0][..., None], ax[1][..., None]),
                (y[0][:, :, None, :], y[1][:, :, None, :]))
    xyz = ds.mul((xy[0][..., None], xy[1][..., None]),
                 (z[0][:, :, None, None, :], z[1][:, :, None, None, :]))
    return _ordered_sum(xyz, 0)


def _flat_stencil(m_u0, grid_shape):
    """(N, 6, 6, 6) flat periodic mesh indices of each atom's stencil."""
    k1, k2, k3 = grid_shape
    m = m_u0.long()
    offs = torch.arange(-3, 3, device=m.device)
    i1 = torch.remainder(m[:, 0:1] + offs[None], k1)
    i2 = torch.remainder(m[:, 1:2] + offs[None], k2)
    i3 = torch.remainder(m[:, 2:3] + offs[None], k3)
    return ((i1[:, :, None, None] * k2 + i2[:, None, :, None]) * k3
            + i3[:, None, None, :])


def _ds_mesh_coords(positions, box, grid_shape, tables=None):
    """DS mesh coordinates: int32 base indices m_u0 (N, 3), DS fractional
    offsets u0 (N, 3) in [3, 4), and the DS box inverse."""
    tables = _tables_of(tables)
    kk = _grid_sizes(grid_shape, tables, positions.device)
    binv, _ = _ds_inv3x3(_ds_box(box), tables)
    pos = ds.ds(positions)
    # r_j = N_j sum_c x_c binv[c][j]
    t = ds.mul((pos[0][:, :, None], pos[1][:, :, None]),
               (binv[0][None], binv[1][None]))  # (N, c, j)
    r = ds.mul_f(_ordered_sum(t, 1), kk)
    m = torch.ceil(r[0]).detach()
    u = ds.add_f(ds.sub((m, torch.zeros_like(m)), r), 3.0)
    return m.to(torch.int32), u, binv


def _ceil_log2(v):
    """ceil(log2(v)) for v > 0, exact (from the binary exponent)."""
    mant, ex = torch.frexp(v)
    return torch.where(mant == 0.5, ex - 1, ex)


def _fp_quantize(hi, lo):
    """(q1, r): the stencil values quantized to a power-of-two quantum
    u = 2^(ceil(log2 max|hi|) - 9), and the residuals (hi - q1) + lo. With
    2^14 headroom over the per-point depth, q1 and every sum of q1 at one
    mesh point are multiples of u below 2^24 u: exact in f32."""
    vmax = torch.clamp(hi.abs().max(), min=1e-30)
    u = ds.pow2(_ceil_log2(vmax) - 9)
    q1 = torch.round(hi / u) * u
    return q1, (hi - q1) + lo


def _fp_scatter_ds(flat, qp, size, grid_shape):
    """Mesh accumulation, exact to ~2^-26 of the mesh scale, in two plain f32
    scatters: the quantized values (``_fp_quantize``; exact in any order,
    atomics included) and then the residuals (|r| <= u/2, plus lo)."""
    q1, r = _fp_quantize(*qp)
    zero = q1.new_zeros(size)
    mesh1 = zero.index_add(0, flat, q1.reshape(-1)).reshape(grid_shape)
    mesh2 = zero.index_add(0, flat, r.reshape(-1)).reshape(grid_shape)
    return ds.two_sum(mesh1, mesh2)


def _hermitian_mult(k3: int):
    """Multiplicity of each rfft z mode in the full spectrum (1, 2, ..., 1)."""
    m = np.full((k3 // 2 + 1,), 2.0, np.float32)
    m[0] = m[-1] = 1.0
    return m


def _energy_from_spectrum(s_re, s_im, w, prefactor, herm):
    s_sq = ds.add(ds.mul(s_re, s_re), ds.mul(s_im, s_im))
    terms = ds.mul_f(ds.mul(w, s_sq), herm[None, None, :])
    e = ds.sum_pairs(terms)
    return ds.mul(e, ds._bc(ds.const(prefactor), e))


# ---------------------------------------------------------------------------
# The engine: forward energy and the hand-written DS adjoint
# ---------------------------------------------------------------------------


def _adjoint_indices(n_t):
    """The adjoint's gather rows for T separable terms: (q, r) and (p, q, r)
    of the partial contractions, the rows of g for the multipole cotangent,
    and for each axis j the rows one derivative order above along j."""
    qi = [q for q, _ in _QR]
    ri = [r for _, r in _QR]
    pi = [p for p, _, _ in _PQR]
    qri = [_QR.index((q, r)) for _, q, r in _PQR]
    rows = [_PQR_ROW[_SEP[t]] for t in range(n_t)]
    rows_j = [[_PQR_ROW[tuple(s + (c == j) for c, s in enumerate(_SEP[t]))]
               for t in range(n_t)] for j in range(3)]
    return tuple(np.asarray(v) for v in (qi, ri, pi, qri, rows, rows_j))


class _DSEngine:
    """One DS reciprocal engine: its grid, kappa, lmax, prefactor, tables and
    (for a static box) cached influence weights."""

    def __init__(self, kappa, grid_shape, lmax, prefactor, static_box):
        self.kappa, self.grid_shape = kappa, grid_shape
        self.lmax, self.prefactor = lmax, prefactor
        self.tables = _DSTables()
        self.w_cached = None
        if static_box is not None:
            if not torch.is_tensor(static_box):
                static_box = torch.as_tensor(np.asarray(static_box,
                                                        np.float64))
            self.w_cached = _kspace_weights_ds(
                static_box.detach().to(_F32), grid_shape, kappa, True,
                self.tables)

    def weights(self, box):
        if self.w_cached is not None:
            return tuple(t.to(box.device) for t in self.w_cached)
        return _kspace_weights_ds(box, self.grid_shape, self.kappa, True,
                                  self.tables)

    def herm(self, device):
        return self.tables.get("herm", device, lambda: (
            _hermitian_mult(self.grid_shape[2]),))[0]

    def pieces(self, positions, box, q_harm, energy=True):
        """The DS energy (float64; None unless ``energy``) and the forward's
        residuals."""
        k1, k2, k3 = self.grid_shape
        box = box.detach()
        m_u0, u0, binv = _ds_mesh_coords(positions, box, self.grid_shape,
                                         self.tables)
        tabs4 = ds_spline_tables(u0, self.tables)
        mixing = _ds_mixing_matrix(binv, self.grid_shape, self.lmax,
                                   self.tables)
        alphas = _ds_alpha(q_harm, mixing, self.lmax)
        qp = _ds_q_points(alphas, tabs4[:3], self.lmax, self.tables)
        flat = _flat_stencil(m_u0, self.grid_shape).reshape(-1)
        mesh = _fp_scatter_ds(flat, qp, k1 * k2 * k3, self.grid_shape)
        s_re, s_im = ds_rfft3(mesh, self.tables)
        w = self.weights(box)
        e = None
        if energy:
            e = ds.to_f64(_energy_from_spectrum(
                s_re, s_im, w, self.prefactor, self.herm(positions.device)))
        res = (m_u0, tabs4, mixing, alphas, binv, ds.mul(w, s_re),
               ds.mul(w, s_im))
        return e, res

    def adjoint(self, res):
        """(dE/dpositions (N, 3), dE/dq_harm (N, H)) in f32 from the
        residuals, in DS: the potential mesh dE/dmesh = 2 Re F(conj(w S))
        x prefactor (T = w S is Hermitian, so the half spectrum feeds the
        inverse real transform), gathered at each stencil and contracted
        with the spline tables up to third derivatives."""
        m_u0, tabs4, mixing, alphas, binv, t_re, t_im = res
        n_t = alphas[0].shape[1]
        qi, ri, pi, qri, rows, rows_j = self.tables.get(
            f"adjoint{n_t}", t_re[0].device, lambda: _adjoint_indices(n_t))
        pot = ds.mul_f(ds_irfft3(t_re, t_im, self.tables), 2.0)
        pot = ds.mul(pot, ds._bc(ds.const(self.prefactor), pot))
        flat = _flat_stencil(m_u0, self.grid_shape)
        pw = (pot[0].reshape(-1)[flat], pot[1].reshape(-1)[flat])
        tab = _stack_tabs(tabs4)  # (4, N, 6, 3)
        x, y, z = ((tab[0][..., c], tab[1][..., c]) for c in range(3))
        # separable partial contractions: over z, then y, then x
        c1 = _ordered_sum(ds.mul(
            (pw[0][None], pw[1][None]),
            (z[0][:, :, None, None, :], z[1][:, :, None, None, :])), 4)
        c2 = _ordered_sum(ds.mul((c1[0][ri], c1[1][ri]),
                                 (y[0][qi][:, :, None, :],
                                  y[1][qi][:, :, None, :])), 3)
        g = _ordered_sum(ds.mul((c2[0][qri], c2[1][qri]),
                                (x[0][pi], x[1][pi])), 2)  # (20, N)

        # multipole cotangent: dE/dq~_h = sum_t M[h][t] g_{SEP t}; quads /3
        gs = (g[0][rows][None], g[1][rows][None])  # (1, T, N)
        acc = _ordered_sum(ds.mul(gs, (mixing[0][:, :, None],
                                       mixing[1][:, :, None])), 1)  # (H, N)
        if self.lmax >= 2:
            quad = ds.mul((acc[0][4:], acc[1][4:]),
                          ds._bc(ds.const(1.0 / 3.0), acc))
            acc = (torch.cat([acc[0][:4], quad[0]]),
                   torch.cat([acc[1][:4], quad[1]]))
        cot_q = (acc[0] + acc[1]).T

        # position cotangent: dE/du0_j = sum_t alpha_t g_{SEP t + e_j};
        # du0_j/dx_c = -N_j binv[c][j]
        gj = (g[0][rows_j], g[1][rows_j])  # (3, T, N)
        de_du = _ordered_sum(ds.mul((alphas[0].T[None], alphas[1].T[None]),
                                    gj), 1)  # (3, N)
        kk = _grid_sizes(self.grid_shape, self.tables, binv[0].device)
        dug = ds.mul_f(binv, kk[None, :])  # [c, j] = binv[c][j] N_j
        acc = _ordered_sum(ds.mul((de_du[0][None], de_du[1][None]),
                                  (dug[0][:, :, None], dug[1][:, :, None])),
                           1)  # (3, N)
        cot_x = -(acc[0] + acc[1]).T
        return cot_x, cot_q


class _DSRecipFn(torch.autograd.Function):
    """(positions, box, q) -> the DS energy (float64), with the hand-written
    DS adjoint as its backward; zero box gradient. Differentiated again, the
    backward recomputes the forward pieces from the saved inputs with
    autograd on and evaluates the adjoint in differentiable operations."""

    @staticmethod
    def forward(ctx, positions, box, q, engine):
        e, res = engine.pieces(positions, box, q)
        ctx.save_for_backward(positions, box, q)
        ctx.engine, ctx.res = engine, res
        return e

    @staticmethod
    def backward(ctx, g):
        positions, box, q = ctx.saved_tensors
        engine = ctx.engine
        res = ctx.res
        if torch.is_grad_enabled():
            _, res = engine.pieces(positions, box, q, energy=False)
        cot_x, cot_q = engine.adjoint(res)
        g32 = g.to(_F32)
        box_bar = torch.zeros_like(box) if ctx.needs_input_grad[1] else None
        return cot_x * g32, box_bar, cot_q * g32, None


class _DSBoxGuard(torch.autograd.Function):
    """Identity on the box whose backward warns and returns zero: the DS
    engine's influence grid and chain rule are built for gradients with
    respect to positions and multipoles only (admp_tpu/ops/dsrecip.py
    :537-563)."""

    @staticmethod
    def forward(ctx, box):
        return box.clone()

    @staticmethod
    def backward(ctx, g):
        warnings.warn(
            "recip_precision='ds' does not track box gradients: the engine "
            "contributes ZERO box gradient. Harmless unless you consume "
            "dE/dbox (virial/NPT) - then use the f64 reciprocal modes.",
            stacklevel=2,
        )
        return torch.zeros_like(g)


def make_ds_pme_recip(kappa, grid_shape, lmax: int,
                      prefactor: float = DIELECTRIC, static_box=None):
    """The DS reciprocal engine: (positions, box, q_harm) -> energy, float64
    (hi + lo). ck_1 influence without the gamma point (electrostatics);
    power-of-two grids only. ``static_box``: the DS influence weights are
    computed once, at build (the engine tracks no box gradient anyway)."""
    grid_shape = tuple(int(k) for k in grid_shape)
    for k in grid_shape:
        if k < 2 or k & (k - 1):
            raise ValueError(
                f"recip_precision='ds' needs power-of-two grids, got "
                f"{grid_shape}; use a power-of-two K (e.g. 128)")
    lmax = int(lmax)
    if lmax not in (0, 1, 2):
        raise ValueError(f"lmax={lmax}: the DS engine takes 0, 1 or 2")
    engine = _DSEngine(float(kappa), grid_shape, lmax, float(prefactor),
                       static_box)
    n_h = (lmax + 1) ** 2

    def ds_pme_recip(positions, box, q_harm):
        box = _DSBoxGuard.apply(box)
        return _DSRecipFn.apply(positions.to(_F32), box.to(_F32),
                                q_harm[:, :n_h].to(_F32), engine)

    return ds_pme_recip


__all__ = ["make_ds_pme_recip", "ds_fft_lead", "ds_fft_last", "ds_fft3",
           "ds_rfft3", "ds_irfft3", "ds_spline_tables"]
