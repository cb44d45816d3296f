"""admp_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; each test skips without a CUDA device).

This file imports nothing of JAX or admp_tpu, so it also runs where JAX is not
installed; tests/conftest.py imports JAX, hence on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances (float32 on the card): pair energies 1e-5 relative per pair with
an absolute floor of 1e-6 max|e| (a pair's rounding follows its largest
term), pair gradients 1e-5 relative RMSE, the pair HVP (K3) within
max(1e-4, 2 x the plain float32 version's) relative RMSE of the plain
version in float64 (second derivatives in float32 have a floor of their own;
P.hvp_directions keeps the direction off the Thole parameters of
zero-polarizability sites, where float32 keeps no digit), a central
difference of K2 within 1e-2, the spread 1e-5 max|mesh| (atomic summation
order), the gather bit for bit, the three-channel spread's autograd and the
dispersion force (energy 1e-5 relative, forces and dE/dc_list 1e-4 relative
RMSE) against their plain paths. The tiled pair: K5 within 1e-5 max|mesh| of
its plain version and of the plain spread and the same on every run (its
sum order is fixed), K7 bit for bit, on grids the tile divides and does
not, with atoms outside the box, and K7 where its warps cross from one bin
into the next beside empty bins; K5 on a crowded tile that holds more atoms
than its stage (chunks, in a fixed order); the plain versions under
gradcheck at float64; second-order pulls on the kernels; and 'auto' on a
256^3 mesh launching K5/K7 and not K4/K6, also on stencils of float64
weights rounded to float32 (spread_precision='f64'). K6 bit for bit and K4
within 1e-5 max|mesh| on axes shorter than the stencil and on rows that
wrap at K3, both on a side stream, and the launchers' refusal of bases on
another device; K4 at N = 0 (zeros) and through its C entry into a mesh filled with
NaN (the entry zeroes its mesh). K3 on all seven (kind, lmax). K2 and K3
also on tables crafted onto each branch of the pair energy (degenerate
pairs, the frame guard, masked pairs, zero-pol sites, the pscale sigmoid,
the Thole cut). K3b, K3's backward (the pair energies' third derivative),
at the 3000-atom pair count for 'pol' and 'uu' against the plain third
derivative in float64 under K3's gate, and through autograd on all three
kinds (a fourth derivative raises), taken through the engines' autograd
(pair_energies_indexed). K1/K2 read the packed table through the pair
list (K2's row gradients added by atomics); the tests above give them the
gathered rows as a table read through an identity list (_stacked). On the
3,000- and 98,304-atom water boxes with the benchmark's 5 A cell lists,
i-sorted and shuffled, for all seven (kind, lmax): K1 against the plain
version on the gathered rows (and K1 on those rows bit for bit), K2
within 1e-5 relative RMSE of autograd of the plain version and index_add;
pairs with an index outside [0, N) (the raw list's padding, -1) masked;
their autograd and its double backward (the gathered K3) against the
kernels on the gathered rows, with the counters pairs.indexed and
pairs.gathered. The precision modes: the double-single arithmetic, FFTs and
engine (plain PyTorch operations, where a fused multiply-add or a flush to
zero would break the error-free transforms) against float64 with admp_tpu's
bounds (tests/test_ds.py), the DS mesh's quantized pass the same bits in any
atom order under the card's atomics, and the kernel route of each
real-space and spread mode against its plain f32 route (forces 1e-4), K1
launched twice per step under 'f64-near'. K4 and K6 on the sharded spread's
halo slabs (1e-5 max|mesh|, bit for bit) at the 98k box's P = 1 and P = 4
slab shapes. The user's script admp_tpu_torch.examples.run_water at
--nmol 27, plain and --polarizable, on the kernels against the plain
versions (energies 1e-5, forces 1e-4; 2e-4 for the exact adjoint). K8, the
local frames and the multipole rotation, against the plain chain in
float64 on water boxes of 192 and 98,304 sites (every y anchor absent; at
98k the main path's size, where the position gradient's atomics meet on
each water's oxygen) and on a random system of every axis type (absent
anchors, one wrapped to site n - 1, zero directions): the forward, the
gradients of the positions, q_local and the box, and a force-matching
loss's gradient through its double backward, each within 2 x the plain
float32 chain's error or a floor (1e-6 forward, 1e-5 gradients: the
positions' gradient is summed by atomics in a varying order); one launch
each way, and 'auto' taking the plain chain in float64; K8's forward is
the plain float32 chain's bit for bit. Since K8, 'auto'
takes it on the float32 card under every EngineConfig, so the older
whole-path comparisons above (kernels against the plain pair and spread
routes) hold K8 on both sides; K8's own tests hold it against the plain
chain.
"""

import numpy as np
import pytest
import torch

from admp_tpu_torch import ADMPDispPmeForce, ADMPPmeForce, EngineConfig, SCFConfig
from admp_tpu_torch import convert_cart2harm, neighbor_list_cell, neighbor_list_dense
from admp_tpu_torch import water_system
from admp_tpu_torch.models.pme import _pair_indices, _pair_scalars
from admp_tpu_torch.ops.cuda import pairs as P
from admp_tpu_torch.ops.cuda import spread as S
from admp_tpu_torch.ops.exclusions import scale_for_distance
from admp_tpu_torch.ops.frames import local_frames_components
from admp_tpu_torch.ops.harmonics import rot_local2global_components
from admp_tpu_torch.ops.reciprocal import (
    atom_spread_alpha,
    multi_stencil,
    spread_points_separable,
    spread_to_mesh,
)

pytestmark = pytest.mark.cuda
SCALES = [0.0, 0.3, 0.7, 1.0, 1.0]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (see the module docstring)")
    return torch.device("cuda:0")


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / (torch.sqrt(torch.mean(b ** 2)) + 1e-30))


def _system(dev, n_side=4):
    s = water_system(n_side=n_side, spacing=3.1, jitter=0.12, seed=4)
    f = lambda x: torch.tensor(x, device=dev, dtype=torch.float32)  # noqa: E731
    pos, box = f(s["positions"]), f(s["box"])
    q = convert_cart2harm(f(s["q_cart"]), 2)
    frames = local_frames_components(
        pos, box, torch.as_tensor(s["axis_types"], device=dev),
        torch.as_tensor(s["axis_indices"], device=dev))
    qg = rot_local2global_components(q, frames, 2)
    pairs = neighbor_list_dense(pos, box, 4.0).pairs
    return s, pos, box, q, qg, pairs


def _tables(dev, kind, lmax, n_side=4):
    s, pos, box, _, qg, pairs = _system(dev, n_side)
    n = pos.shape[0]
    i, j, mask = _pair_indices(pairs, n)
    cov = torch.as_tensor(s["covalent_map"], device=dev).long()
    sc = scale_for_distance(torch.tensor(SCALES, device=dev), cov[i, j])
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.normal(0, 0.05, (n, 3)), device=dev,
                     dtype=torch.float32)
    pol = torch.tensor(s["pol"], device=dev, dtype=torch.float32)[:, None]
    th = torch.tensor(s["tholes"], device=dev, dtype=torch.float32)[:, None]
    if kind == "uu":
        packed, rows = torch.cat([pos, u, pol, th], 1), [sc, mask.float()]
    else:
        cols, rows = [pos, qg[:, : (lmax + 1) ** 2]], [sc, mask.float()]
        if kind == "pol":
            cols += [u, pol, th]
            rows.append(sc.flip(0))
        packed = torch.cat(cols, 1)
    ct = torch.tensor(rng.uniform(0.5, 1.5, pairs.shape[0]), device=dev,
                      dtype=torch.float32)
    return (packed[i].contiguous(), packed[j].contiguous(),
            torch.stack(rows).contiguous(),
            _pair_scalars(0.73, box).contiguous(), ct)


def _stacked(g_i, g_j):
    """The table (g_i; g_j) and the list that reads pair p from its rows p
    and C + p: K1/K2 on it take the gathered rows as they are, and K2 adds
    each row's gradient once."""
    c = g_i.shape[0]
    idx = torch.arange(c, device=g_i.device)
    return torch.cat([g_i, g_j]).contiguous(), idx, idx + c


def _pair_fwd(g_i, g_j, scl, scal, lmax, kind):
    """K1 on gathered rows (_stacked)."""
    return P.launch_pair_fwd(*_stacked(g_i, g_j), scl, scal, lmax, kind)


def _pair_bwd(g_i, g_j, scl, scal, ct, lmax, kind):
    """K2 on gathered rows (_stacked): the gradients of g_i, g_j, the scale
    rows and the scalars."""
    d_tab, d_scl, d_scal = P.launch_pair_bwd(*_stacked(g_i, g_j), scl, scal,
                                             ct, lmax, kind)
    c = g_i.shape[0]
    return d_tab[:c], d_tab[c:], d_scl, d_scal


@pytest.mark.parametrize("kind,lmax", [("perm", 0), ("perm", 1), ("perm", 2),
                                       ("pol", 0), ("pol", 1), ("pol", 2),
                                       ("uu", 1)])
def test_pair_kernels_match_plain(dev, kind, lmax):
    g_i, g_j, scl, scal, ct = _tables(dev, kind, lmax)
    e_k = _pair_fwd(g_i, g_j, scl, scal, lmax, kind)
    e_p = P.pair_energies_torch(g_i, g_j, scl, scal, lmax, kind)
    torch.cuda.synchronize()
    floor = 1e-6 * float(e_p.abs().max())
    assert bool(((e_k - e_p).abs() <= 1e-5 * e_p.abs() + floor).all())
    out_k = _pair_bwd(g_i, g_j, scl, scal, ct, lmax, kind)
    leaves = [t.clone().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
    out_p = torch.autograd.grad(
        (P.pair_energies_torch(*leaves, lmax, kind) * ct).sum(), leaves)
    torch.cuda.synchronize()
    for name, a, b in zip(("g_i", "g_j", "scl", "scal"), out_k, out_p):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))


@pytest.mark.parametrize("kind,lmax", [("perm", 0), ("perm", 1), ("perm", 2),
                                       ("pol", 0), ("pol", 1), ("pol", 2),
                                       ("uu", 1)])
def test_pair_hvp_matches_plain_f64(dev, kind, lmax):
    """K3 (K2's mixed-mode body in one-tangent duals) against the plain HVP
    in float64 on the same inputs, every output within max(1e-4, 2 x the
    plain float32 version's error); one launch, counted for its kind."""
    *x, ct = _tables(dev, kind, lmax)
    cs = P.hvp_directions(x, kind, seed=7)
    before = P.launch_pair_hvp.by_kind[kind]
    out_k = P.launch_pair_hvp(*x, ct, *cs, lmax, kind)
    assert P.launch_pair_hvp.by_kind[kind] - before == 1
    out_64 = P.pair_hvp_torch(*(t.double() for t in (*x, ct, *cs)), lmax, kind)
    out_32 = P.pair_hvp_torch(*x, ct, *cs, lmax, kind)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("g_i", "g_j", "scl", "scal", "ct"), out_k,
                             out_32, out_64):
        assert bool(torch.isfinite(a).all()), name
        tol = max(1e-4, 2 * _rel(b, c))
        assert _rel(a, c) <= tol, (name, _rel(a, c), tol)


def _branch_tables(dev, kind, lmax):
    """_tables with pairs crafted onto each branch of the pair energy, 40
    pairs each: degenerate pairs (equal raw y and z), the frame guard (raw y
    and z one box vector apart: the wrapped d lies along x), masked pairs,
    and for the Thole kinds zero-pol sites on one side and on both, pscale
    at 0 and at 1e-3 -+ 1e-4 (the sigmoid's slope), and pol 1e-9 on both
    sides (damping width 1e-3: a Thole argument far above the exp cut at
    50)."""
    g_i, g_j, scl, scal, ct = _tables(dev, kind, lmax)
    live = torch.nonzero(scl[1] > 0.5).flatten()
    gen = torch.Generator().manual_seed(0)
    blocks = live[torch.randperm(live.numel(), generator=gen).to(dev)][
        :8 * 40].reshape(8, 40)
    box = scal[1:10].reshape(3, 3)
    b = blocks[0]  # degenerate
    g_j[b, 1:3] = g_i[b, 1:3]
    g_j[b, 0] = g_i[b, 0] + 2.5
    b = blocks[1]  # the frame guard
    g_j[b, :3] = g_i[b, :3] + box[1]
    g_j[b, 0] += 2.0
    scl[1, blocks[2]] = 0.0  # masked
    if kind != "perm":
        pscale = 2 if kind == "pol" else 0  # the pscale row
        g_i[blocks[3], -2] = 0.0
        g_i[blocks[4], -2] = 0.0
        g_j[blocks[4], -2] = 0.0
        scl[pscale, blocks[5]] = 0.0
        scl[pscale, blocks[6, :20]] = 1e-3 - 1e-4
        scl[pscale, blocks[6, 20:]] = 1e-3 + 1e-4
        g_i[blocks[7], -2] = 1e-9
        g_j[blocks[7], -2] = 1e-9
    return g_i, g_j, scl, scal, ct


@pytest.mark.parametrize("kind,lmax", [("perm", 2), ("pol", 0), ("pol", 1),
                                       ("pol", 2), ("uu", 1)])
def test_pair_backward_takes_autograds_side_of_each_branch(dev, kind, lmax):
    """K2 (mixed mode) on _branch_tables against autograd of the plain
    version in float32, every output within 1e-5 relative RMSE; K3 on the
    same tables under its own gate against the plain version in float64."""
    g_i, g_j, scl, scal, ct = _branch_tables(dev, kind, lmax)
    out_k = _pair_bwd(g_i, g_j, scl, scal, ct, lmax, kind)
    leaves = [t.clone().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
    out_p = torch.autograd.grad(
        (P.pair_energies_torch(*leaves, lmax, kind) * ct).sum(), leaves)
    torch.cuda.synchronize()
    for name, a, b in zip(("g_i", "g_j", "scl", "scal"), out_k, out_p):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))
    assert bool((out_k[2][1] == 0).all())  # the mask row
    masked = scl[1] <= 0.5
    assert bool((out_k[0][masked] == 0).all() and (out_k[1][masked] == 0).all())
    x = (g_i, g_j, scl, scal)
    cs = P.hvp_directions(x, kind, seed=5)
    h_k = P.launch_pair_hvp(*x, ct, *cs, lmax, kind)
    h_64 = P.pair_hvp_torch(*(t.double() for t in (*x, ct, *cs)), lmax, kind)
    h_32 = P.pair_hvp_torch(*x, ct, *cs, lmax, kind)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("g_i", "g_j", "scl", "scal", "ct"), h_k, h_32,
                             h_64):
        assert bool(torch.isfinite(a).all()), name
        tol = max(1e-4, 2 * _rel(b, c))
        assert _rel(a, c) <= tol, (name, _rel(a, c), tol)


def _directions(tables, seed, kind):
    """Random directions for the four inputs for a finite difference: zero on
    the mask row, scaled down on the box inverse so that no pair's
    fractional coordinate crosses the wrap, and for the Thole kinds zero on
    the pol and thole columns (the zero-pol floor) and the scale rows (the
    1e-5-wide pscale sigmoid)."""
    rng = np.random.default_rng(seed)
    out = [torch.tensor(rng.standard_normal(t.shape), device=t.device,
                        dtype=torch.float32) for t in tables]
    out[2][1] = 0.0
    out[3][10:] *= 1e-2  # the box inverse is ~1/12 of the box's entries
    if kind != "perm":
        for c in out[:2]:
            c[:, -2:] = 0.0
        out[2].zero_()
    return out


@pytest.mark.parametrize("kind,lmax", [("perm", 2), ("pol", 2), ("uu", 1)])
def test_pair_kernel_autograd_is_first_order(dev, kind, lmax):
    """The pair kernels' autograd: the backward's backward (K3) matches the
    plain version and agrees with a central difference of the backward
    (K2); K3's own backward (K3b) gives the plain third derivative, and is
    itself first order (a fourth derivative raises)."""
    g_i, g_j, scl, scal, ct = _tables(dev, kind, lmax)
    cs = P.hvp_directions((g_i, g_j, scl, scal), kind, seed=5)
    out_k = P.launch_pair_hvp(g_i, g_j, scl, scal, ct, *cs, lmax, kind)
    out_64 = P.pair_hvp_torch(*(t.double() for t in (g_i, g_j, scl, scal, ct)),
                              *(c.double() for c in cs), lmax, kind)
    out_32 = P.pair_hvp_torch(g_i, g_j, scl, scal, ct, *cs, lmax, kind)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("g_i", "g_j", "scl", "scal", "ct"), out_k,
                             out_32, out_64):
        assert bool(torch.isfinite(a).all()), name
        tol = max(1e-4, 2 * _rel(b, c))
        assert _rel(a, c) <= tol, (name, _rel(a, c), tol)

    # <K3(c), v> = d/dt <K2(x + t v), c>: central differences of K2 at
    # steps h and h/2, Richardson-extrapolated (error O(h^4))
    x = (g_i, g_j, scl, scal)
    v = _directions(x, 6, kind)

    def phi(t):
        outs = _pair_bwd(*(a + t * b for a, b in zip(x, v)), ct, lmax,
                         kind)
        return sum(float((o.double() * c.double()).sum())
                   for o, c in zip(outs, cs))

    h = 4e-3
    d1 = (phi(h) - phi(-h)) / (2 * h)
    d2 = (phi(h / 2) - phi(-h / 2)) / h
    fd = (4 * d2 - d1) / 3
    an = sum(float((o.double() * d.double()).sum())
             for o, d in zip(out_k[:4], v))
    assert abs(fd - an) <= 1e-2 * abs(an), (fd, an)

    # the engines' autograd (pair_energies_indexed) on the table whose rows
    # are (g_i; g_j), pair p reading rows p and C + p: its derivatives are
    # the gathered kernels' outputs, stacked the same way
    c = g_i.shape[0]
    idx = torch.arange(c, device=dev)
    leaves = [t.clone().requires_grad_(True)
              for t in (torch.cat([g_i, g_j]), scl, scal)]
    e = P.pair_energies_indexed(leaves[0], idx, idx + c, *leaves[1:], lmax,
                                kind)
    grads = torch.autograd.grad((e * ct).sum(), leaves, create_graph=True)
    c_tab = (torch.cat(cs[:2]), cs[2], cs[3])
    hvp = torch.autograd.grad(sum((g * d).sum() for g, d in zip(grads, c_tab)),
                              leaves, create_graph=True)
    for a, b in zip((hvp[0][:c], hvp[0][c:], *hvp[1:]), out_k[:4]):
        assert torch.equal(a, b)
    before = P.launch_pair_third.by_kind[kind]
    third = torch.autograd.grad(hvp[0][:c].sum(), leaves, create_graph=True)
    assert P.launch_pair_third.by_kind[kind] - before == 1
    h = [torch.ones_like(g_i), torch.zeros_like(g_j), torch.zeros_like(scl),
         torch.zeros_like(scal), torch.zeros_like(ct)]
    t_64 = P.pair_third_torch(*(t.double() for t in (*x, ct, *cs, *h)),
                              lmax, kind)
    t_32 = P.pair_third_torch(*x, ct, *cs, *h, lmax, kind)
    for name, a, b, d in zip(("g_i", "g_j", "scl", "scal"),
                             (third[0][:c], third[0][c:], *third[1:]), t_32,
                             t_64):
        assert bool(torch.isfinite(a).all()), name
        tol = max(1e-4, 2 * _rel(b, d))
        assert _rel(a, d) <= tol, (name, _rel(a, d), tol)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(third[0].sum(), leaves[0])


@pytest.mark.parametrize("kind,lmax", [("pol", 2), ("uu", 2)])
def test_pair_third_matches_plain_f64(dev, kind, lmax):
    """K3b (K2's mixed-mode body in hyper-duals) at the 3000-atom box's pair
    count (water_system(n_side=10), the main path's pairs) against the plain
    third derivative in float64 on the same inputs, each of its nine outputs
    within K3's gate, max(1e-4, 2 x the plain float32 version's error); one
    launch, counted for its kind."""
    *x, ct = _tables(dev, kind, lmax, n_side=10)
    cs = P.hvp_directions(x, kind, seed=7)
    hs = P.hvp_directions(x, kind, seed=8)
    hs.append(torch.tensor(np.random.default_rng(9).standard_normal(
        ct.shape[0]), device=dev, dtype=torch.float32))
    before = P.launch_pair_third.by_kind[kind]
    out_k = P.launch_pair_third(*x, ct, *cs, *hs, lmax, kind)
    assert P.launch_pair_third.by_kind[kind] - before == 1
    f64 = lambda ts: [t.double() for t in ts]  # noqa: E731
    out_64 = P.pair_third_torch(*f64((*x, ct, *cs, *hs)), lmax, kind)
    out_32 = P.pair_third_torch(*x, ct, *cs, *hs, lmax, kind)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("g_i", "g_j", "scl", "scal", "ct", "c_gi",
                              "c_gj", "c_scl", "c_scal"), out_k, out_32,
                             out_64):
        assert bool(torch.isfinite(a).all()), name
        tol = max(1e-4, 2 * _rel(b, c))
        assert _rel(a, c) <= tol, (name, _rel(a, c), tol)


PAIR_KINDS = [("perm", 0), ("perm", 1), ("perm", 2), ("pol", 0), ("pol", 1),
              ("pol", 2), ("uu", 1)]
_WATER_PAIRS = {}


def _water_pairs(dev, n_side):
    """The n_side^3 water box on the card with its cell-list pairs at 5 A
    (the benchmark's lists: i-sorted, padding last) and, per pair, its
    mscale and pscale rows as the engines take them (random levels; no
    covalent map at 98,304 atoms): cached per size."""
    key = (str(dev), n_side)
    if key not in _WATER_PAIRS:
        s = water_system(n_side=n_side, spacing=3.1, jitter=0.12, seed=4,
                         exclusions=None)
        f = lambda x: torch.tensor(x, device=dev, dtype=torch.float32)  # noqa: E731
        pos, box = f(s["positions"]), f(s["box"])
        pairs = neighbor_list_cell(pos, box, 5.0).pairs
        n = pos.shape[0]
        gen = torch.Generator(device=dev).manual_seed(n_side)
        rand = lambda *shape: torch.rand(*shape, device=dev, generator=gen)  # noqa: E731
        _WATER_PAIRS[key] = dict(
            pos=pos, box=box, pairs=pairs, pol=f(s["pol"])[:, None],
            th=f(s["tholes"])[:, None], q=(rand(n, 9) - 0.5) * 0.6,
            u=(rand(n, 3) - 0.5) * 0.1, sc=torch.where(
                rand(pairs.shape[0]) < 0.1, 0.3, 1.0),
            ct=0.5 + rand(pairs.shape[0]))
    return _WATER_PAIRS[key]


def _indexed_inputs(dev, kind, lmax, n_side, order):
    """(table, i, j, scl, scal, ct) of the indexed kernels on the water box
    of _water_pairs: the packed table of the kind's width, the list's
    columns (its rows shuffled for order 'shuffled'), the scale rows and
    the 19 scalars."""
    w = _water_pairs(dev, n_side)
    pairs, sc, ct = w["pairs"], w["sc"], w["ct"]
    if order == "shuffled":
        perm = torch.randperm(pairs.shape[0], device=dev,
                              generator=torch.Generator(device=dev).manual_seed(5))
        pairs, sc, ct = pairs[perm], sc[perm], ct[perm]
    i, j, mask = _pair_indices(pairs, w["pos"].shape[0])
    rows = [sc, mask.float()]
    if kind == "uu":
        table = torch.cat([w["pos"], w["u"], w["pol"], w["th"]], 1)
    else:
        table = torch.cat([w["pos"], w["q"][:, : (lmax + 1) ** 2]], 1)
        if kind == "pol":
            table = torch.cat([table, w["u"], w["pol"], w["th"]], 1)
            rows.append(sc.flip(0))
    return (table.contiguous(), i.contiguous(), j.contiguous(),
            torch.stack(rows).contiguous(),
            _pair_scalars(0.73, w["box"]).contiguous(), ct.contiguous())


@pytest.mark.parametrize("n_side", [10, 32])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("kind,lmax", PAIR_KINDS)
def test_indexed_pair_forward_is_the_gathered_bitwise(dev, kind, lmax, order,
                                                      n_side):
    """K1 (rows table[i], table[j] read through the pair list) on the 3,000-
    and 98,304-atom water boxes: K1 on the gathered rows (_stacked) bit for
    bit, and against the plain version on those rows in float64 within
    max(1e-6, 2 x the plain float32 version's) relative RMSE (over 3.4M
    pairs a per-pair bound meets pairs whose terms cancel); one launch
    counted per call."""
    table, i, j, scl, scal, _ = _indexed_inputs(dev, kind, lmax, n_side,
                                                order)
    before = P.launch_pair_fwd.by_kind[kind]
    e_k = P.launch_pair_fwd(table, i, j, scl, scal, lmax, kind)
    assert P.launch_pair_fwd.by_kind[kind] - before == 1
    g_i, g_j = table[i].contiguous(), table[j].contiguous()
    e_g = _pair_fwd(g_i, g_j, scl, scal, lmax, kind)
    e_p = P.pair_energies_torch(g_i, g_j, scl, scal, lmax, kind)
    e_64 = P.pair_energies_torch(g_i.double(), g_j.double(), scl.double(),
                                 scal.double(), lmax, kind)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_g)
    assert _rel(e_k, e_64) <= max(1e-6, 2 * _rel(e_p, e_64)), (
        _rel(e_k, e_64), _rel(e_p, e_64))


@pytest.mark.parametrize("n_side", [10, 32])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("kind,lmax", PAIR_KINDS)
def test_indexed_pair_backward_matches_gathered_and_index_add(
        dev, kind, lmax, order, n_side):
    """K2 (the rows' gradients added into the table's by the kernel's
    atomics: runs of equal i summed per warp) against autograd of the plain
    version on the gathered rows and index_add, on the 3,000- and
    98,304-atom water boxes, i-sorted and shuffled: the table's, the scale
    rows' and the scalars' gradients within 1e-5 relative RMSE; each
    gradient left out when not asked for."""
    table, i, j, scl, scal, ct = _indexed_inputs(dev, kind, lmax, n_side,
                                                 order)
    d_tab, d_scl, d_scal = P.launch_pair_bwd(table, i, j, scl, scal, ct,
                                             lmax, kind)
    x = [t.clone().requires_grad_(True) for t in (table, scl, scal)]
    e = P.pair_energies_torch(x[0][i], x[0][j], x[1], x[2], lmax, kind)
    g_tab, g_scl, g_scal = torch.autograd.grad((e * ct).sum(), x)
    torch.cuda.synchronize()
    assert d_tab.shape == table.shape
    for name, a, b in (("table", d_tab, g_tab), ("scl", d_scl, g_scl),
                       ("scal", d_scal, g_scal)):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))
    only = P.launch_pair_bwd(table, i, j, scl, scal, ct, lmax, kind,
                             (True, False, False))
    assert only[1] is None and only[2] is None
    assert _rel(only[0], g_tab) < 1e-5


@pytest.mark.parametrize("kind,lmax", [("perm", 2), ("pol", 2), ("uu", 1)])
def test_indexed_pair_kernels_mask_pairs_outside_the_table(dev, kind, lmax):
    """The raw cell list of the 3,000-atom box (its padding slots read
    index N) with a few i set to -1 and a few j to N on unmasked pairs: K1
    and K2 mask each pair with an index outside [0, N), as the clamped list
    with those pairs' mask row 0 reads: energies, scale rows' and scalars' gradients bit for bit, the
    table's within 1e-5 relative RMSE (atomic sums); so does the plain
    route on the same tensors moved to the CPU."""
    table, i, j, scl, scal, ct = _indexed_inputs(dev, kind, lmax, 10,
                                                 "sorted")
    raw = _water_pairs(dev, 10)["pairs"]  # the list that i, j clamp
    n = table.shape[0]
    i_raw, j_raw = raw[:, 0].long().clone(), raw[:, 1].long().clone()
    i_raw[::97] = -1
    j_raw[5::89] = n  # beside the padding's, on unmasked pairs
    outside = (i_raw < 0) | (i_raw >= n) | (j_raw < 0) | (j_raw >= n)
    scl_in = scl.clone()
    scl_in[1] = torch.where(outside, 0.0, scl[1])
    i_in, j_in = i_raw.clamp(0, n - 1), j_raw.clamp(0, n - 1)
    e_k = P.launch_pair_fwd(table, i_raw, j_raw, scl, scal, lmax, kind)
    e_in = P.launch_pair_fwd(table, i_in, j_in, scl_in, scal, lmax, kind)
    b_k = P.launch_pair_bwd(table, i_raw, j_raw, scl, scal, ct, lmax, kind)
    b_in = P.launch_pair_bwd(table, i_in, j_in, scl_in, scal, ct, lmax, kind)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_in) and bool((e_k[outside] == 0).all())
    assert _rel(b_k[0], b_in[0]) < 1e-5
    assert torch.equal(b_k[1], b_in[1]) and torch.equal(b_k[2], b_in[2])
    cpu = [t.cpu() for t in (table, i_raw, j_raw, scl, scal)]
    e_p = P.pair_energies_indexed(*cpu, lmax, kind)
    floor = 1e-6 * float(e_p.abs().max())
    assert bool(((e_k.cpu() - e_p).abs() <= 1e-5 * e_p.abs() + floor).all())


@pytest.mark.parametrize("kind,lmax", [("perm", 2), ("pol", 2), ("uu", 1)])
def test_indexed_pair_functions_on_the_kernels(dev, kind, lmax):
    """pair_energies_indexed on the card, on a shuffled list: forward and
    first derivative on K1/K2 (counted as ``pairs.indexed``), the double
    backward on the gathered K3 (counted as ``pairs.gathered``), against K1,
    K2 and K3 on the gathered rows (_stacked) with index_add: energies bit
    for bit, the derivatives within 1e-5 relative RMSE (atomic sums)."""
    from admp_tpu_torch.utils import profiling

    table, i, j, scl, scal, ct = _indexed_inputs(dev, kind, lmax, 10,
                                                 "shuffled")
    gen = torch.Generator(device=dev).manual_seed(3)
    cs = [torch.randn(t.shape, device=dev, generator=gen)
          for t in (table, scl, scal)]
    if kind != "perm":  # off the Thole columns of zero-pol sites
        cs[0][table[:, -2] == 0, -2:] = 0.0
    x = [t.clone().requires_grad_(True) for t in (table, scl, scal)]
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        e = P.pair_energies_indexed(x[0], i, j, x[1], x[2], lmax, kind)
        g = torch.autograd.grad((e * ct).sum(), x, create_graph=True)
        h = torch.autograd.grad(sum((a * b).sum() for a, b in zip(g, cs)), x)
        counters = profiling.snapshot()["counters"]
    profiling.reset()
    assert counters["pairs.indexed"] == 2 and counters["pairs.gathered"] == 1

    def scatter(d_gi, d_gj):
        return torch.zeros_like(table).index_add_(0, i, d_gi).index_add_(
            0, j, d_gj)

    g_i, g_j = table[i].contiguous(), table[j].contiguous()
    e_g = _pair_fwd(g_i, g_j, scl, scal, lmax, kind)
    b = _pair_bwd(g_i, g_j, scl, scal, ct, lmax, kind)
    k3 = P.launch_pair_hvp(g_i, g_j, scl, scal, ct, cs[0][i].contiguous(),
                           cs[0][j].contiguous(), cs[1], cs[2], lmax, kind)
    torch.cuda.synchronize()
    assert torch.equal(e, e_g)
    for a, r in zip(g + h, (scatter(*b[:2]), *b[2:], scatter(*k3[:2]),
                            *k3[2:4])):
        assert _rel(a, r) < 1e-5, _rel(a, r)


@pytest.mark.parametrize("order,channels", [(6, 1), (4, 1), (6, 3), (4, 3)])
def test_spread_and_gather_match_plain(dev, order, channels):
    _, pos, box, q, _, _ = _system(dev)
    grid = (40, 36, 48)
    m_u0, u0, alpha = atom_spread_alpha(pos, box, q, grid, 2, order)
    pts = spread_points_separable(u0, alpha, 2, order).reshape(-1, 1, order ** 3)
    pts = pts.repeat(1, channels, 1) * torch.arange(
        1, channels + 1, device=dev)[None, :, None]
    pts = pts.contiguous()
    mesh_k = S.launch_spread(m_u0.contiguous(), pts, grid, order)
    mesh_p = S.spread_torch(m_u0, pts, grid, order)
    torch.cuda.synchronize()
    assert float((mesh_k - mesh_p).abs().max()) <= 1e-5 * float(
        mesh_p.abs().max())
    g = torch.randn((channels, *grid), device=dev)
    assert torch.equal(S.launch_gather(m_u0.contiguous(), g, grid, order),
                       S.gather_torch(m_u0, g, grid, order))


def test_spread_functions_are_mutual_adjoints(dev):
    _, pos, box, q, _, _ = _system(dev)
    grid = (40, 36, 48)
    m_u0, u0, alpha = atom_spread_alpha(pos, box, q, grid, 2, 6)
    pts = spread_points_separable(u0, alpha, 2, 6).reshape(-1, 1, 216)
    pts = pts.detach().requires_grad_(True)
    w = torch.randn((1, *grid), device=dev)
    mesh = S.spread(m_u0, pts, grid, 6, method="cuda")
    (g1,) = torch.autograd.grad((mesh * mesh * w).sum(), pts,
                                create_graph=True)
    (g2,) = torch.autograd.grad(g1.sum(), pts)  # second order on kernels
    mesh_p = S.spread(m_u0, pts, grid, 6, method="torch")
    (h1,) = torch.autograd.grad((mesh_p * mesh_p * w).sum(), pts,
                                create_graph=True)
    (h2,) = torch.autograd.grad(h1.sum(), pts)
    assert _rel(g1, h1) < 1e-5 and _rel(g2, h2) < 1e-5


@pytest.mark.parametrize("n_dev", [1, 4])
def test_halo_slab_spread_and_gather_match_plain(dev, n_dev):
    """K4 and K6 on halo slab 0 of the sharded spread (parallel/spread.py):
    the (K1/P + 5, K2, K3) slab of the 98k box's 305^3 grid (98,304 atoms
    at P = 1, the 310 x 305 x 305 slab; a quarter of them at P = 4, 81 x
    305 x 305), fed the synthetic m_u0' = base - slab x width + 3 that
    _local_slab_spread gives them, against spread_torch / gather_torch;
    and _local_slab_spread itself launching K4 under 'auto'."""
    from admp_tpu_torch.parallel.spread import _local_slab_spread

    n, grid, box = 98304, (305, 305, 305), 99.328
    gen = torch.Generator(dev).manual_seed(3)
    pos = torch.rand(n, 3, device=dev, generator=gen) * box
    q = torch.randn(n, 9, device=dev, generator=gen)
    m_u0, u0, alpha = atom_spread_alpha(pos, torch.eye(3, device=dev) * box,
                                        q, grid, 2)
    k = torch.tensor(grid, device=dev)
    base = torch.remainder(m_u0.long() - 3, k)
    width = grid[0] // n_dev
    keep = torch.div(base[:, 0], width, rounding_mode="floor") == 0
    m_slab = (base[keep] + 3).to(torch.int32).contiguous()
    q_pts = spread_points_separable(u0[keep], alpha[keep], 2).reshape(
        -1, 1, 216).contiguous()
    sgrid = (width + 5, grid[1], grid[2])
    mesh_k = S.launch_spread(m_slab, q_pts, sgrid, 6)
    mesh_p = S.spread_torch(m_slab, q_pts, sgrid, 6)
    assert float((mesh_k - mesh_p).abs().max()) <= 1e-5 * float(
        mesh_p.abs().max())
    g = torch.randn((1, *sgrid), device=dev, generator=gen)
    assert torch.equal(S.launch_gather(m_slab, g, sgrid, 6),
                       S.gather_torch(m_slab, g, sgrid, 6))
    before = S.launch_spread.launches
    slab = _local_slab_spread(base[keep].to(torch.int32), q_pts[:, 0], 0,
                              width, 5, grid[1], grid[2], 6, "auto")
    assert S.launch_spread.launches == before + 1
    assert float((slab - mesh_p[0]).abs().max()) <= 1e-5 * float(
        mesh_p.abs().max())


@pytest.mark.parametrize("order", [4, 6])
def test_three_channel_spread_autograd_matches_plain(dev, order):
    """SpreadFn/GatherFn at C=3 on the dispersion stencil: the mesh, the
    stencil gradient (K6) and its second derivative (K4 again) against the
    plain path; launches counted per (order, C)."""
    s, pos, box, _, _, _ = _system(dev)
    grid = (40, 36, 48)
    c = torch.tensor(s["c_list"], device=dev, dtype=torch.float32)
    m_u0, pts = multi_stencil(pos, box, c, grid, order)
    pts = pts.detach().requires_grad_(True)
    w = torch.randn((3, *grid), device=dev)
    out = {}
    for method in ("cuda", "torch"):
        before = (S.launch_spread.by_shape[order, 3],
                  S.launch_gather.by_shape[order, 3])
        mesh = S.spread(m_u0, pts, grid, order, method=method)
        (g1,) = torch.autograd.grad((mesh * mesh * w).sum(), pts,
                                    create_graph=True)
        (g2,) = torch.autograd.grad(g1.sum(), pts)
        after = (S.launch_spread.by_shape[order, 3],
                 S.launch_gather.by_shape[order, 3])
        assert (after[0] > before[0] and after[1] > before[1]) == (
            method == "cuda")
        out[method] = (mesh, g1, g2)
    for a, b in zip(out["cuda"], out["torch"]):
        assert _rel(a, b) < 1e-5


@pytest.mark.parametrize("order", [4, 6])
def test_dispersion_force_kernels_match_plain(dev, order):
    """ADMPDispPmeForce on the C=3 kernels against its plain path: energy,
    forces and dE/dc_list; the cell list on the card is the CPU's."""
    s, pos, box, _, _, _ = _system(dev)
    nl = neighbor_list_cell(pos, box, 4.0)
    cpu = neighbor_list_cell(pos.cpu(), box.cpu(), 4.0)
    assert torch.equal(nl.pairs.cpu(), cpu.pairs)
    c = torch.tensor(s["c_list"], device=dev, dtype=torch.float32)
    sc = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], device=dev)
    out = {}
    for method in ("auto", "torch"):
        force = ADMPDispPmeForce(
            s["box"], s["covalent_map"], 4.0, 1e-4, 10, device=dev,
            config=EngineConfig(cache_influence=True, disp_spread_order=order,
                                spread_method=method))
        before = S.launch_gather.by_shape[order, 3]
        e, g = force.get_forces(pos, box, nl, c, sc)
        c_req = c.clone().requires_grad_(True)
        (gc,) = torch.autograd.grad(force.get_energy(pos, box, nl, c_req, sc),
                                    c_req)
        assert (S.launch_gather.by_shape[order, 3] > before) == (
            method == "auto")
        out[method] = (e, g, gc)
    (e_k, g_k, c_k), (e_p, g_p, c_p) = out["auto"], out["torch"]
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * abs(float(e_p))
    assert _rel(g_k, g_p) < 1e-4 and _rel(c_k, c_p) < 1e-4


def test_force_step_kernels_match_plain(dev):
    s, pos, box, q, _, pairs = _system(dev)
    f = lambda x: torch.tensor(x, device=dev, dtype=torch.float32)  # noqa: E731
    args = (pos, box, pairs, q, f(s["pol"]), f(s["tholes"]),
            f([0.0, 0.0, 0.0, 1.0, 1.0]), f([0.0, 0.0, 0.0, 1.0, 1.0]),
            f([0.0, 0.0, 0.0, 1.0, 1.0]))
    out = {}
    for method in ("auto", "torch"):
        cfg = EngineConfig(cache_influence=True, scf=SCFConfig.md(),
                           pair_kernel=method, spread_method=method)
        force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                             s["covalent_map"], 4.0, 1e-4, 2, lpol=True,
                             config=cfg, device=dev)
        before = P.launch_pair_fwd.launches
        out[method] = force.get_forces(*args) + (force.n_cycle,)
        launched = P.launch_pair_fwd.launches - before
        assert (launched > 0) == (method == "auto")
    (e_k, g_k, n_k), (e_p, g_p, n_p) = out["auto"], out["torch"]
    assert n_k == n_p
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * abs(float(e_p))
    assert _rel(g_k, g_p) < 1e-4


def test_exact_adjoint_step_kernels_match_plain(dev):
    """The default SCFConfig() (exact adjoint) on the kernels: K3 runs, and
    the forces and the parameter gradients match the plain path."""
    s, pos, box, q, _, pairs = _system(dev)
    f = lambda x: torch.tensor(x, device=dev, dtype=torch.float32)  # noqa: E731
    sc = f([0.0, 0.0, 0.0, 1.0, 1.0])
    out = {}
    for method in ("auto", "torch"):
        cfg = EngineConfig(cache_influence=True, pair_kernel=method,
                           spread_method=method)
        force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                             s["covalent_map"], 4.0, 1e-4, 2, lpol=True,
                             config=cfg, device=dev)
        params = [t.clone().requires_grad_(True)
                  for t in (q, f(s["pol"]), f(s["tholes"]))]
        before = P.launch_pair_hvp.launches
        e, g = force.get_forces(pos, box, pairs, *params, sc, sc, sc)
        energy = force.get_energy(pos, box, pairs, *params, sc, sc, sc)
        grads = torch.autograd.grad(energy, params)
        assert (P.launch_pair_hvp.launches > before) == (method == "auto")
        out[method] = (e, g, grads)
    (e_k, g_k, p_k), (e_p, g_p, p_p) = out["auto"], out["torch"]
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * abs(float(e_p))
    assert _rel(g_k, g_p) < 2e-4
    for a, b in zip(p_k, p_p):
        assert _rel(a, b) < 1e-3


def _tiled_stencil(dev, grid, order, channels, shift):
    """Stencil values of the 192-atom box, with ``shift`` moving every atom
    by box vectors (bases outside [0, K), as after a drift)."""
    _, pos, box, q, _, _ = _system(dev)
    pos = pos + shift * (1.3 * box[0] - 0.7 * box[1])
    m_u0, u0, alpha = atom_spread_alpha(pos, box, q, grid, 2, order)
    pts = spread_points_separable(u0, alpha, 2, order).reshape(
        -1, 1, order ** 3)
    pts = (pts.repeat(1, channels, 1) * torch.arange(
        1, channels + 1, device=dev)[None, :, None]).contiguous()
    return m_u0.contiguous(), pts


@pytest.mark.parametrize("grid", [(64, 48, 96), (250, 243, 250), (20, 13, 9)])
@pytest.mark.parametrize("order,channels", [(6, 1), (4, 3)])
@pytest.mark.parametrize("shift", [0, 1])
def test_tiled_spread_and_gather_match_plain(dev, grid, order, channels,
                                             shift):
    m_u0, pts = _tiled_stencil(dev, grid, order, channels, shift)
    bins = S.tile_bins(m_u0, grid, S.TILE, order)
    before = (S.launch_spread_tiled.by_shape[order, channels],
              S.launch_gather_tiled.by_shape[order, channels])
    mesh_k = S.launch_spread_tiled(bins, pts, grid, order)
    again = S.launch_spread_tiled(bins, pts, grid, order)
    mesh_t = S.spread_tiled_torch(bins, pts, grid, order)
    mesh_p = S.spread_torch(m_u0, pts, grid, order)
    torch.cuda.synchronize()
    scale = float(mesh_p.abs().max())
    assert float((mesh_k - mesh_t).abs().max()) <= 1e-5 * scale
    assert float((mesh_k - mesh_p).abs().max()) <= 1e-5 * scale
    assert torch.equal(mesh_k, again)  # a fixed summation order
    g = torch.randn((channels, *grid), device=dev)
    out_k = S.launch_gather_tiled(bins, g, grid, order)
    assert torch.equal(out_k, S.gather_torch(m_u0, g, grid, order))
    assert torch.equal(out_k, S.gather_tiled_torch(bins, g, grid, order))
    assert (S.launch_spread_tiled.by_shape[order, channels] - before[0],
            S.launch_gather_tiled.by_shape[order, channels] - before[1]) == (
                2, 1)


@pytest.mark.parametrize("order,channels", [(6, 1), (4, 3)])
def test_tiled_spread_walks_a_crowded_bin_in_chunks(dev, order, channels):
    """200 atoms whose bases all lie in one core tile, more than K5's stage
    holds (48 rows at (6, 1), 54 at (4, 3)), beside 300 spread over the
    grid: K5 walks the tile's list in chunks, in a fixed order."""
    rng = np.random.default_rng(12)
    grid, n = (64, 64, 64), 200
    corner = np.array([16, 24, 32]) + order // 2  # a tile corner, after wrap
    crowd = corner + np.stack([rng.integers(0, t, n) for t in S.TILE], 1)
    bases = np.concatenate([crowd, rng.integers(0, 64, (300, 3))])
    m_u0 = torch.tensor(bases, device=dev, dtype=torch.int32)
    pts = torch.tensor(rng.standard_normal((500, channels, order ** 3)),
                       device=dev, dtype=torch.float32)
    bins = S.tile_bins(m_u0, grid, S.TILE, order)
    assert int((bins.offsets[1:] - bins.offsets[:-1]).max()) >= n
    before = S.launch_spread_tiled.by_shape[order, channels]
    mesh_k = S.launch_spread_tiled(bins, pts, grid, order)
    again = S.launch_spread_tiled(bins, pts, grid, order)
    mesh_t = S.spread_tiled_torch(bins, pts, grid, order)
    mesh_p = S.spread_torch(m_u0, pts, grid, order)
    torch.cuda.synchronize()
    scale = float(mesh_p.abs().max())
    assert float((mesh_k - mesh_t).abs().max()) <= 1e-5 * scale
    assert float((mesh_k - mesh_p).abs().max()) <= 1e-5 * scale
    assert torch.equal(mesh_k, again)  # the chunks sum in a fixed order
    assert S.launch_spread_tiled.by_shape[order, channels] - before == 2


@pytest.mark.parametrize("order,channels", [(6, 1), (4, 3)])
def test_tiled_gather_across_bins_and_empty_bins(dev, order, channels):
    """K7 bit for bit where its warps cross from one bin into the next: one
    atom in each of 120 scattered tiles (a warp's 32 stencil rows span two
    slots, and so two bins, wherever a slot ends inside it), beside one
    tile of 7, with most bins empty; bases outside the box and rows that
    wrap at every axis."""
    rng = np.random.default_rng(16)
    grid = (72, 40, 100)  # 9 x 5 x 4 tiles, the last z tile partial
    tiles = rng.choice(9 * 5 * 4, 120, replace=False)
    t3, t2, t1 = tiles % 4, tiles // 4 % 5, tiles // 20
    corner = np.stack([t1 * 8, t2 * 8, t3 * 32], 1)
    inside = rng.integers(0, np.minimum(S.TILE, np.array(grid) - corner))
    bases = np.concatenate([corner + inside, np.full((7, 3), 8) + np.arange(
        7)[:, None]])
    # m_u0 with base (m_u0 - order/2) mod K, shifted by whole boxes
    shift = rng.integers(-1, 2, bases.shape) * np.array(grid)
    m_u0 = torch.tensor(bases + order // 2 + shift, device=dev,
                        dtype=torch.int32)
    mesh = torch.randn((channels, *grid), device=dev)
    bins = S.tile_bins(m_u0, grid, S.TILE, order)
    counts = bins.offsets[1:] - bins.offsets[:-1]
    assert int((counts == 0).sum()) > 0 and int((counts == 1).sum()) >= 100
    before = S.launch_gather_tiled.by_shape[order, channels]
    out = S.launch_gather_tiled(bins, mesh, grid, order)
    assert torch.equal(out, S.gather_torch(m_u0, mesh, grid, order))
    assert torch.equal(out, S.gather_tiled_torch(bins, mesh, grid, order))
    assert S.launch_gather_tiled.by_shape[order, channels] - before == 1


@pytest.mark.parametrize("grid", [(5, 4, 7), (9, 7, 3), (20, 16, 37)])
@pytest.mark.parametrize("order,channels", [(6, 1), (6, 3), (4, 1), (4, 3)])
def test_gather_rows_on_short_and_wrapping_axes(dev, grid, order, channels):
    """K6 bit for bit on axes shorter than the stencil and on stencil rows
    that wrap at K3; one launch per call, counted per (order, C)."""
    rng = np.random.default_rng(13)
    n = 300
    bases = np.stack([rng.integers(-9, k + 9, n) for k in grid], 1)
    bases[:20, 2] = grid[2] - 1  # these rows run past K3 and wrap
    m_u0 = torch.tensor(bases, device=dev, dtype=torch.int32)
    mesh = torch.randn((channels, *grid), device=dev)
    before = S.launch_gather.by_shape[order, channels]
    out = S.launch_gather(m_u0, mesh, grid, order)
    assert torch.equal(out, S.gather_torch(m_u0, mesh, grid, order))
    assert S.launch_gather.by_shape[order, channels] - before == 1


@pytest.mark.parametrize("grid", [(5, 4, 7), (9, 7, 3), (20, 16, 37),
                                  (12, 10, 12), (9, 7, 20)])
@pytest.mark.parametrize("order,channels", [(6, 1), (6, 3), (4, 1), (4, 3)])
def test_spread_rows_on_short_and_wrapping_axes(dev, grid, order, channels):
    """K4 within 1e-5 max|mesh| of the plain spread on axes shorter than the
    stencil (z by its remainder) and on stencil rows that wrap at K3 (z by
    one compare; at K3 % 4 == 0, K3 >= 12, float4 windows that wrap whole,
    down to K3 = 12); one launch per call, counted per (order, C)."""
    rng = np.random.default_rng(17)
    n = 300
    bases = np.stack([rng.integers(-9, k + 9, n) for k in grid], 1)
    bases[:20, 2] = grid[2] - 1  # these rows run past K3 and wrap
    m_u0 = torch.tensor(bases, device=dev, dtype=torch.int32)
    pts = torch.tensor(rng.standard_normal((n, channels, order ** 3)),
                       device=dev, dtype=torch.float32)
    before = S.launch_spread.by_shape[order, channels]
    mesh_k = S.launch_spread(m_u0, pts, grid, order)
    mesh_p = S.spread_torch(m_u0, pts, grid, order)
    torch.cuda.synchronize()
    assert float((mesh_k - mesh_p).abs().max()) <= 1e-5 * float(
        mesh_p.abs().max())
    assert S.launch_spread.by_shape[order, channels] - before == 1


def test_spread_zeroes_and_launches_on_the_current_stream(dev):
    """On a side stream K4's entry zeroes the mesh and launches after the
    work enqueued there before it."""
    grid = (40, 36, 48)
    m_u0, pts = _tiled_stencil(dev, grid, 6, 1, 0)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.full((1, *grid), float("nan"), device=dev)  # a dirty block
        scaled = pts * 3.0
        mesh = S.launch_spread(m_u0, scaled, grid, 6)
    side.synchronize()
    mesh_p = S.spread_torch(m_u0, pts * 3.0, grid, 6)
    assert float((mesh - mesh_p).abs().max()) <= 1e-5 * float(
        mesh_p.abs().max())


def test_spread_of_no_atoms_is_zeros(dev):
    """K4's launcher at N = 0: a zero mesh (its C entry zeroes the buffer,
    whatever the allocator hands back) and no launch counted."""
    grid = (40, 36, 48)
    for n_ch in (1, 3):
        dirty = torch.full((n_ch, *grid), float("nan"), device=dev)
        del dirty  # its block goes back to the caching allocator
        before = S.launch_spread.by_shape[6, n_ch]
        mesh = S.launch_spread(
            torch.empty((0, 3), device=dev, dtype=torch.int32),
            torch.empty((0, n_ch, 216), device=dev), grid, 6)
        assert mesh.shape == (n_ch, *grid)
        assert bool((mesh == 0).all())
        assert S.launch_spread.by_shape[6, n_ch] == before


@pytest.mark.parametrize("order,channels", [(6, 1), (4, 3)])
def test_spread_entry_writes_over_a_nan_mesh(dev, order, channels):
    """admp_spread, called directly, zeroes the mesh it is given before it
    accumulates: a buffer filled with NaN comes back as the plain spread."""
    grid = (40, 36, 48)
    m_u0, pts = _tiled_stencil(dev, grid, order, channels, 1)
    mesh = torch.full((channels, *grid), float("nan"), device=dev)
    status = S._entry("admp_spread")(
        *(S._P(t.data_ptr()) for t in (m_u0, pts, mesh)), m_u0.shape[0],
        channels, order, *grid, S._P(S._raw_stream(mesh.get_device())))
    assert status == 0
    mesh_p = S.spread_torch(m_u0, pts, grid, order)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(mesh).all())
    assert float((mesh - mesh_p).abs().max()) <= 1e-5 * float(
        mesh_p.abs().max())


def test_gather_launches_on_the_current_stream(dev):
    """The launcher reads the current stream on every call: on a side
    stream K6 runs after the work enqueued there before it."""
    grid = (40, 36, 48)
    m_u0, _ = _tiled_stencil(dev, grid, 6, 1, 0)
    mesh = torch.randn((1, *grid), device=dev)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        scaled = mesh * 3.0
        out = S.launch_gather(m_u0, scaled, grid, 6)
    side.synchronize()
    assert torch.equal(out, S.gather_torch(m_u0, mesh * 3.0, grid, 6))


def test_spread_launchers_refuse_mixed_devices(dev):
    m_u0, pts = _tiled_stencil(dev, (40, 36, 48), 6, 1, 0)
    mesh = torch.randn((1, 40, 36, 48), device=dev)
    with pytest.raises(ValueError, match="the bases on cpu"):
        S.launch_gather(m_u0.cpu(), mesh, (40, 36, 48), 6)
    with pytest.raises(ValueError, match="the bases on cpu"):
        S.launch_spread(m_u0.cpu(), pts, (40, 36, 48), 6)


def test_tiled_plain_versions_gradcheck_f64(dev):
    grid, order = (9, 10, 11), 4
    m_u0, pts = _tiled_stencil(dev, grid, order, 1, 1)
    m_u0, pts = m_u0[:6], pts[:6].double().requires_grad_(True)
    bins = S.tile_bins(m_u0, grid, S.TILE, order)
    g = torch.randn((1, *grid), device=dev, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: S.spread_tiled_torch(bins, x, grid, order), (pts,))
    assert torch.autograd.gradcheck(
        lambda x: S.gather_tiled_torch(bins, x, grid, order), (g,))


def test_tiled_functions_second_order_on_kernels(dev):
    """spread (K5) -> its gradient (K7) -> the gradient's gradient (K5, the
    gather's backward, then K7 again) against the plain spread's autograd."""
    grid = (50, 27, 43)
    m_u0, pts = _tiled_stencil(dev, grid, 6, 1, 0)
    pts = pts.detach().requires_grad_(True)
    w = torch.randn((1, *grid), device=dev)
    out = {}
    for method in ("cuda2d", "torch"):
        before = (S.launch_spread_tiled.launches,
                  S.launch_gather_tiled.launches)
        mesh = S.spread(m_u0, pts, grid, 6, method=method)
        (g1,) = torch.autograd.grad((mesh * mesh * w).sum(), pts,
                                    create_graph=True)
        (g2,) = torch.autograd.grad(g1.sum(), pts)
        launched = (S.launch_spread_tiled.launches - before[0],
                    S.launch_gather_tiled.launches - before[1])
        assert launched == ((2, 2) if method == "cuda2d" else (0, 0))
        out[method] = (mesh, g1, g2)
    for a, b in zip(out["cuda2d"], out["torch"]):
        assert _rel(a, b) < 1e-5


def test_auto_takes_the_tiled_pair_on_a_large_mesh(dev):
    """'auto' on a 256^3 order-6 mesh (67 MB, more than the H100's 50 MB
    L2) launches K5 and, in the backward, K7, and neither K4 nor K6; the
    mesh and the position gradient match the plain route."""
    s, pos, box, q, _, _ = _system(dev, n_side=10)
    grid = (256, 256, 256)
    out = {}
    for method in ("auto", "torch"):
        p = pos.detach().requires_grad_(True)
        counts = (S.launch_spread_tiled.launches,
                  S.launch_gather_tiled.launches, S.launch_spread.launches,
                  S.launch_gather.launches)
        mesh = spread_to_mesh(p, box, q, grid, 2, method)
        (g,) = torch.autograd.grad((mesh * mesh).sum(), p)
        now = (S.launch_spread_tiled.launches, S.launch_gather_tiled.launches,
               S.launch_spread.launches, S.launch_gather.launches)
        launched = tuple(b - a for a, b in zip(counts, now))
        assert launched == ((1, 1, 0, 0) if method == "auto" else (0,) * 4)
        out[method] = (mesh, g)
    assert _rel(out["auto"][0], out["torch"][0]) < 1e-5
    assert _rel(out["auto"][1], out["torch"][1]) < 1e-4


def test_tiled_pair_on_float64_weights_beyond_the_l2(dev):
    """spread_precision='f64' on a 256^3 order-6 mesh (67 MB, beyond the
    H100's 50 MB L2): stencils computed in float64 and rounded to float32,
    K5 within 1e-5 max|mesh| of spread_tiled_torch, K7 bit for bit against
    gather_tiled_torch; and spread_to_mesh(precision='f64') under 'auto'
    launching K5 and, in the backward, K7, its float32 mesh and position
    gradient within 1e-5 and 1e-4 of the plain route's."""
    _, pos, box, q, _, _ = _system(dev, n_side=10)
    grid = (256, 256, 256)
    m_u0, u0, alpha = atom_spread_alpha(pos, box, q, grid, 2, 6, "f64")
    assert u0.dtype == alpha.dtype == torch.float64
    pts = spread_points_separable(u0, alpha, 2).to(torch.float32).reshape(
        -1, 1, 216).contiguous()
    bins = S.tile_bins(m_u0, grid, S.TILE, 6)
    mesh_k = S.launch_spread_tiled(bins, pts, grid, 6)
    mesh_t = S.spread_tiled_torch(bins, pts, grid, 6)
    assert float((mesh_k - mesh_t).abs().max()) <= 1e-5 * float(
        mesh_t.abs().max())
    g = torch.randn((1, *grid), device=dev,
                    generator=torch.Generator(dev).manual_seed(7))
    assert torch.equal(S.launch_gather_tiled(bins, g, grid, 6),
                       S.gather_tiled_torch(bins, g, grid, 6))
    out = {}
    for method in ("auto", "torch"):
        p = pos.detach().requires_grad_(True)
        before = (S.launch_spread_tiled.launches,
                  S.launch_gather_tiled.launches)
        mesh = spread_to_mesh(p, box, q, grid, 2, method, precision="f64")
        (grad,) = torch.autograd.grad((mesh * mesh).sum(), p)
        launched = (S.launch_spread_tiled.launches - before[0],
                    S.launch_gather_tiled.launches - before[1])
        assert launched == ((1, 1) if method == "auto" else (0, 0))
        assert mesh.dtype == torch.float32
        out[method] = (mesh, grad)
    assert _rel(out["auto"][0], out["torch"][0]) < 1e-5
    assert _rel(out["auto"][1], out["torch"][1]) < 1e-4


def _plain(ham):
    """Switch a Hamiltonian's force objects to the plain path."""
    import dataclasses

    for gen in ham.getGenerators():
        f = getattr(gen, "pme_force", None) or gen.disp_pme_force
        f.config = dataclasses.replace(f.config, pair_kernel="torch",
                                       spread_method="torch")
        f.refresh_calculators()


def test_hamiltonian_potentials_kernels_match_plain(dev, tmp_path):
    """The front end on the card (MPID water XML, a PDB of 192 atoms):
    both potentials on the kernels against the plain f32 path, energy 1e-5
    relative, forces 1e-4 (dispersion) and 2e-4 (the polarizable one, an
    exact-adjoint step, as test_exact_adjoint_step_kernels_match_plain) and
    parameter gradients 1e-3 relative RMSE, and the kernels launched (K1-K3
    and K4/K6 at (6, 1) for the polarizable one, K4/K6 at (6, 3) for
    dispersion)."""
    from admp_tpu_torch import Hamiltonian
    from admp_tpu_torch.systems import write_water_inputs

    s, pos, box, _, _, pairs = _system(dev)
    xml, pdb = write_water_inputs(tmp_path, s["positions"], s["box"])
    out = {}
    for method in ("auto", "torch"):
        ham = Hamiltonian(xml, device=dev)
        ham.getGenerators()[1].ref_dip = ""
        pots = ham.createPotential(pdb, nonbondedCutoff=4.0)
        if method == "torch":
            _plain(ham)
        before = (P.launch_pair_hvp.launches, S.launch_spread.by_shape[6, 1],
                  S.launch_spread.by_shape[6, 3])
        res = []
        for pot, gen in zip(pots, ham.getGenerators()):
            params = {k: v.clone().requires_grad_(True)
                      for k, v in gen.params.items()}
            x = pos.detach().requires_grad_(True)
            e = pot(x, box, pairs, params)
            names = [k for k in params if k not in ("dScales", "U_ind")]
            grads = torch.autograd.grad(e, [x] + [params[k] for k in names])
            res.append((e.detach(), grads))
        after = (P.launch_pair_hvp.launches, S.launch_spread.by_shape[6, 1],
                 S.launch_spread.by_shape[6, 3])
        assert all((b > a) == (method == "auto")
                   for a, b in zip(before, after)), (before, after)
        out[method] = res
    for (e_k, g_k), (e_p, g_p), tol in zip(out["auto"], out["torch"],
                                           (1e-4, 2e-4)):
        assert abs(float(e_k) - float(e_p)) <= 1e-5 * abs(float(e_p))
        assert _rel(g_k[0], g_p[0]) < tol
        for a, b in zip(g_k[1:], g_p[1:]):
            assert _rel(a, b) < 1e-3


def test_langevin_step_and_barostat_on_kernels(dev):
    """One Langevin step and one MC barostat move of fixed multipoles +
    Tang-Toennies + bonded water (the NPT loop's force field) on the kernels
    against the plain f32 path with the same generator seeds."""
    from admp_tpu_torch import (
        MDState,
        generate_pairwise_interaction,
        make_langevin_step,
        make_mc_barostat,
        tt_damping_qq_c6_kernel,
    )
    from admp_tpu_torch.ops.bonded import harmonic_bond_energy, water_bonded_terms

    s, pos, box, q, _, pairs = _system(dev)
    f = lambda x: torch.as_tensor(np.asarray(x), device=dev, dtype=torch.float32)  # noqa: E731
    sc = f([0.0, 0.0, 0.0, 1.0, 1.0])
    tt = generate_pairwise_interaction(tt_damping_qq_c6_kernel,
                                       s["covalent_map"], device=dev)
    tt_args = [f(s[k]) for k in ("tt_a", "tt_b", "tt_q")] + [f(s["c_list"])[:, 0]]
    b_idx, r0, kb, _, _, _ = water_bonded_terms(pos.shape[0] // 3)
    b_idx = torch.as_tensor(b_idx, device=dev)
    masses = f(np.tile([15.999, 1.008, 1.008], pos.shape[0] // 3))
    out = {}
    for method in ("auto", "torch"):
        pme = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                           s["covalent_map"], 4.0, 1e-4, 2,
                           config=EngineConfig(pair_kernel=method,
                                               spread_method=method),
                           device=dev)

        def energy(p, bx, prs, pme=pme):
            e = pme.get_energy(p, bx, prs, q, sc) + tt(p, bx, prs, sc, *tt_args)
            return e + harmonic_bond_energy(p, bx, b_idx, f(r0), f(kb))

        def force_fn(p, aux, energy=energy):
            x = p.detach().requires_grad_(True)
            e = energy(x, box, pairs)
            return e.detach(), -torch.autograd.grad(e, x)[0], aux

        before = (P.launch_pair_fwd.launches, S.launch_spread.launches)
        state = MDState(pos, torch.zeros_like(pos), force_fn(pos, None)[1])
        gen = torch.Generator(device=dev).manual_seed(3)
        state = make_langevin_step(force_fn, masses, 2e-4, 300.0, 10.0)(
            state, gen)
        move = make_mc_barostat(energy, np.repeat(np.arange(pos.shape[0] // 3), 3),
                                6.02214076e-5, 300.0)(state.positions, box, gen,
                                                     pairs)
        after = (P.launch_pair_fwd.launches, S.launch_spread.launches)
        assert all((b > a) == (method == "auto")
                   for a, b in zip(before, after))
        out[method] = (state, move)
    (st_k, mv_k), (st_p, mv_p) = out["auto"], out["torch"]
    assert _rel(st_k.positions, st_p.positions) < 1e-6
    assert _rel(st_k.velocities, st_p.velocities) < 1e-4
    assert _rel(st_k.forces, st_p.forces) < 1e-4
    assert bool(mv_k[2]) == bool(mv_p[2])
    assert _rel(mv_k[1], mv_p[1]) < 1e-6
    assert abs(float(mv_k[3]) - float(mv_p[3])) <= 1e-5 * abs(float(mv_p[3]))


# ---------------------------------------------------------------------------
# the precision modes on the card: the DS arithmetic and engine (plain
# PyTorch ops, where an FMA or a flush to zero would break the error-free
# transforms) against float64, and the modes' kernel routes
# ---------------------------------------------------------------------------


def _ds_operands(dev):
    from admp_tpu_torch.utils import ds

    rng = np.random.RandomState(0)
    a = rng.randn(2000) * np.exp(rng.randn(2000) * 3)
    b = rng.randn(2000) * np.exp(rng.randn(2000) * 3)
    return ds, a, b, ds.from_f64(a, dev), ds.from_f64(b, dev)


def _relmax(got, ref):
    got = got.cpu().numpy()
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))


def test_ds_primitives_on_the_card(dev):
    """admp_tpu's bounds (tests/test_ds.py) against numpy float64."""
    from scipy.special import erfc

    ds, a, b, A, B = _ds_operands(dev)
    f64 = ds.to_f64
    add = (f64(ds.add(A, B)).cpu().numpy() - (a + b))
    assert np.max(np.abs(add) / np.maximum(np.abs(a), np.abs(b))) < 1e-13
    assert _relmax(f64(ds.mul(A, B)), a * b) < 1e-13
    assert _relmax(f64(ds.div(A, B)), a / b) < 1e-13
    assert _relmax(f64(ds.sqrt(ds.from_f64(np.abs(a), dev))),
                   np.sqrt(np.abs(a))) < 1e-13
    assert _relmax(f64(ds.npow(A, 5)), a ** 5) < 1e-10
    x = np.linspace(-60.0, 3.0, 3000)
    assert _relmax(f64(ds.exp(ds.from_f64(x, dev))), np.exp(x)) < 1e-10
    y = np.concatenate([np.linspace(1e-6, 0.468, 500),
                        np.linspace(0.469, 3.99, 1500),
                        np.linspace(4.0, 7.0, 500)])
    assert _relmax(f64(ds.erfc(ds.from_f64(y, dev))), erfc(y)) < 1e-10
    c = np.random.RandomState(1).randn(4097) * np.exp(
        np.random.RandomState(2).randn(4097) * 4)
    s = float(f64(ds.sum_pairs(ds.from_f64(c, dev))))
    assert abs(s - c.sum()) / np.abs(c).sum() < 1e-14


def test_ds_ffts_on_the_card(dev):
    from admp_tpu_torch.ops import dsrecip
    from admp_tpu_torch.utils import ds

    rng = np.random.RandomState(3)
    m = rng.randn(16, 32, 64)
    re, im = dsrecip.ds_fft3(ds.from_f64(m, dev),
                             ds.from_f64(np.zeros_like(m), dev))
    ref = np.fft.fftn(m)
    got = ds.to_f64(re).cpu().numpy() + 1j * ds.to_f64(im).cpu().numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-13
    s_re, s_im = dsrecip.ds_rfft3(ds.from_f64(m, dev))
    back = ds.to_f64(dsrecip.ds_irfft3(s_re, s_im)).cpu().numpy()
    assert np.abs(back - m.size * m).max() / (m.size * np.abs(m).max()) \
        < 1e-13


@pytest.mark.parametrize("n,k,bound", [(48, 16, 1e-10), (200, 32, 3e-10)])
@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_ds_recip_on_the_card_vs_f64(dev, lmax, n, k, bound):
    """The DS engine against the float64 reciprocal engine on the same
    f32-representable inputs: position and multipole gradients 5e-7
    relative RMSE, and the energy within ``bound`` relative. admp_tpu's
    bound, 1e-10, on admp_tpu's inputs (tests/test_ds.py:116-155: 48 atoms,
    16^3); at 200 atoms on 32^3, 3e-10: there both packages' DS engines sit
    1.87e-10 from float64 at lmax 2 on the CPU (1.4e-11 at lmax 0, 3.4e-12
    at lmax 1), bit for bit alike, from the residual scatter's rounding,
    which the card's atomic adds reorder."""
    from admp_tpu_torch.ops.dsrecip import make_ds_pme_recip
    from admp_tpu_torch.ops.influence import ck_1
    from admp_tpu_torch.ops.reciprocal import make_pme_recip
    from admp_tpu_torch.utils.constants import DIELECTRIC

    rng = np.random.RandomState(0)
    box = np.eye(3, dtype=np.float32) * 14.0
    pos = (rng.rand(n, 3) * 14.0).astype(np.float32)
    q = rng.randn(n, (lmax + 1) ** 2).astype(np.float32)
    out = []
    for engine, dtype in (
            (make_ds_pme_recip(0.6, (k, k, k), lmax), torch.float32),
            (make_pme_recip(ck_1, 0.6, (k, k, k), lmax, DIELECTRIC,
                            spread_method="torch"), torch.float64)):
        p = torch.tensor(pos, device=dev, dtype=dtype, requires_grad=True)
        qq = torch.tensor(q, device=dev, dtype=dtype, requires_grad=True)
        e = engine(p, torch.tensor(box, device=dev, dtype=dtype), qq)
        out.append((float(e.detach()),) + torch.autograd.grad(e, (p, qq)))
    (e_ds, gp, gq), (e64, rp, rq) = out
    assert abs(e_ds - e64) <= bound * abs(e64)
    assert _rel(gp, rp) < 5e-7
    assert _rel(gq, rq) < 5e-7


def test_ds_quantized_scatter_is_exact_under_atomics(dev):
    """The quantized pass of the DS mesh: the same bits in any atom order,
    with the card's atomic adds."""
    from admp_tpu_torch.ops import dsrecip

    rng = np.random.RandomState(4)
    n, grid = 300, (32, 32, 32)
    pos = torch.tensor(rng.rand(n, 3) * 14.0, device=dev, dtype=torch.float32)
    box = torch.eye(3, device=dev) * 14.0
    q = torch.tensor(rng.randn(n, 9), device=dev, dtype=torch.float32)
    perm = torch.tensor(rng.permutation(n), device=dev)
    meshes = []
    for order in (torch.arange(n, device=dev), perm):
        m_u0, u0, binv = dsrecip._ds_mesh_coords(pos[order], box, grid)
        mix = dsrecip._ds_mixing_matrix(binv, grid, 2)
        qp = dsrecip._ds_q_points(dsrecip._ds_alpha(q[order], mix, 2),
                                  dsrecip.ds_spline_tables(u0)[:3], 2)
        q1, _ = dsrecip._fp_quantize(*qp)
        flat = dsrecip._flat_stencil(m_u0, grid).reshape(-1)
        meshes.append(torch.zeros(32 ** 3, device=dev).index_add_(
            0, flat, q1.reshape(-1)))
    assert torch.equal(meshes[0], meshes[1])


@pytest.mark.parametrize("mode", ["none", "f64", "f64-near", "spread-f64"])
def test_precision_modes_take_the_kernels(dev, mode):
    """Each mode's kernel route against its plain f32 route (forces 1e-4
    relative RMSE; energy 1e-5 of the largest term: the total, -103
    kJ/mol, is a residue of ~1e4-magnitude terms), with K1 and K4 launched,
    K1 twice per step under 'f64-near' (the main pass and the near pass)."""
    s, pos, box, q, _, pairs = _system(dev)
    sc = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0], device=dev)
    over = {"none": {}, "f64": dict(realspace_precision="f64"),
            "f64-near": dict(realspace_precision="f64-near"),
            "spread-f64": dict(spread_precision="f64")}[mode]
    out = {}
    for method in ("auto", "torch"):
        cfg = EngineConfig(pair_kernel=method, spread_method=method, **over)
        force = ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                             s["covalent_map"], 4.0, 1e-4, 2, config=cfg,
                             device=dev)
        k1, k4 = P.launch_pair_fwd.launches, S.launch_spread.launches
        out[method] = force.get_forces(pos, box, pairs, q, sc)
        k1 = P.launch_pair_fwd.launches - k1
        k4 = S.launch_spread.launches - k4
        if method == "auto":
            assert k1 == (2 if mode == "f64-near" else 1)
            assert k4 == 1
        else:
            assert k1 == k4 == 0
        if method == "torch":
            terms = force.get_metrics(pos, box, pairs, q, sc)
    (e_k, g_k), (e_p, g_p) = out["auto"], out["torch"]
    scale = max(abs(float(terms[k])) for k in ("e_real", "e_recip", "e_self"))
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * scale
    assert _rel(g_k, g_p) < 1e-4


@pytest.mark.parametrize("polarizable", [False, True])
def test_run_water_script_kernels_match_plain(dev, polarizable):
    """admp_tpu_torch.examples.run_water at --nmol 27 on the card, on the
    kernels ('auto') against the plain versions ('torch'): each energy 1e-5
    relative, each force 1e-4 relative RMSE (2e-4 for the polarizable exact
    adjoint), K1/K2 and K4/K6 launched (K3 under --polarizable)."""
    from admp_tpu_torch.examples import run_water

    quiet = dict(nmol=27, polarizable=polarizable, time_iters=0,
                 log=lambda *a: None)
    k = (P.launch_pair_fwd.launches, P.launch_pair_bwd.launches,
         P.launch_pair_hvp.launches, S.launch_spread.launches,
         S.launch_gather.launches)
    kern = run_water.run(method="auto", **quiet)
    k = [b - a for a, b in zip(k, (
        P.launch_pair_fwd.launches, P.launch_pair_bwd.launches,
        P.launch_pair_hvp.launches, S.launch_spread.launches,
        S.launch_gather.launches))]
    plain = run_water.run(method="torch", **quiet)
    assert min(k[0], k[1], k[3], k[4]) > 0 and (k[2] > 0) == polarizable
    for e in ("e_pme", "e_disp", "e_tt"):
        assert abs(kern[e] - plain[e]) <= 1e-5 * abs(plain[e]), e
    tol_f = 2e-4 if polarizable else 1e-4
    for f in ("f_pme", "f_disp", "f_tt"):
        assert _rel(kern[f], plain[f]) < tol_f, f


# ---------------------------------------------------------------------------
# K8: the local frames and the rotation of the multipoles (ops/cuda/frames)
# ---------------------------------------------------------------------------


def _frames_system(dev, lmax, dtype=torch.float32, seed=0, n_mol=12):
    """A random system for K8: clusters of four sites in a triclinic box
    (positions wrapped into it, so clusters straddle its faces), every axis
    type in turn, -1 for each anchor a type does not use, and on top: the y
    anchor of ZBisect site 2 and of ThreeFold site 3 -1 (wrapped to site
    n - 1), site 6 its own x anchor (a zero direction) and site n - 1 a
    ZThenX site whose z anchor -1 wraps to itself. (positions, box,
    q_local (N, (lmax + 1)^2), axis_types, axis_indices)."""
    rng = np.random.default_rng(seed)
    box = np.array([[9.0, 0.0, 0.0], [0.3, 9.0, 0.0], [0.2, -0.4, 9.0]])
    centres = rng.uniform(0, 1, (n_mol, 3)) @ box
    pos = (centres[:, None, :] + rng.normal(0, 0.8, (n_mol, 4, 3))).reshape(
        -1, 3)
    frac = pos @ np.linalg.inv(box)
    pos = (frac - np.floor(frac)) @ box
    n = pos.shape[0]
    types = np.arange(n) % 6
    anchors = np.full((n, 3), -1, dtype=np.int64)
    used = {0: 2, 1: 2, 2: 3, 3: 3, 4: 1, 5: 0}
    for i in range(n):
        mates = [m for m in range(4 * (i // 4), 4 * (i // 4) + 4) if m != i]
        rng.shuffle(mates)
        anchors[i, :used[types[i]]] = mates[:used[types[i]]]
    anchors[2, 2] = anchors[3, 2] = -1
    anchors[6, 1] = 6
    types[n - 1] = 0
    anchors[n - 1, :2] = (-1, n - 2)
    q = rng.normal(0, 1, (n, (lmax + 1) ** 2))
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    return (t(pos), t(box), t(q), torch.tensor(types, device=dev),
            torch.tensor(anchors, device=dev))


def _frames_water(dev, dtype=torch.float32, n_side=4):
    """The n_side^3 water box of _system with its multipoles (lmax 2):
    Bisector and ZThenX sites whose y anchors are all -1, the positions
    shifted by 1.5 A along each axis and wrapped into the box (waters then
    straddle its faces, so the minimum-image wrap runs and the box carries
    a gradient: with every molecule whole, the frames do not depend on the
    box)."""
    s = water_system(n_side=n_side, spacing=3.1, jitter=0.12, seed=4,
                     exclusions=None)
    frac = (s["positions"] + 1.5) @ np.linalg.inv(s["box"])
    pos = (frac - np.floor(frac)) @ s["box"]
    t = lambda x: torch.tensor(x, dtype=dtype, device=dev)  # noqa: E731
    return (t(pos), t(s["box"]),
            convert_cart2harm(t(s["q_cart"]), 2),
            torch.as_tensor(s["axis_types"], device=dev),
            torch.as_tensor(s["axis_indices"], device=dev))


def _frames_route(method):
    """The global multipoles by route: 'cuda' K8
    (ops/cuda/frames.kernel_global_multipoles), 'torch' the plain chain
    (global_multipoles_torch), 'auto' ops/frames.global_multipoles, which
    picks one of the two."""
    from admp_tpu_torch.ops.cuda import frames as K8
    from admp_tpu_torch.ops.frames import global_multipoles

    return {"cuda": K8.kernel_global_multipoles,
            "torch": K8.global_multipoles_torch,
            "auto": global_multipoles}[method]


def _frames_grads(system, method, dtype, seed=3):
    """The global multipoles of ``system`` cast to ``dtype`` by the route
    ``method`` (_frames_route), and the gradients of sum(w * q_global)
    w.r.t. positions, q_local and the box (through its inverse) at a seeded
    standard-normal w."""
    pos, box, q, types, anchors = system
    lmax = int(round(q.shape[1] ** 0.5)) - 1
    x = [t.detach().to(dtype).requires_grad_(True) for t in (pos, box, q)]
    out = _frames_route(method)(x[0], x[1], x[2], types, anchors, lmax)
    rng = np.random.default_rng(seed)
    w = torch.tensor(rng.standard_normal(tuple(out.shape)), dtype=dtype,
                     device=out.device)
    return (out, *torch.autograd.grad((out * w).sum(), x))


def _frames_force_matching(system, method, dtype):
    """The gradient w.r.t. q_local and positions of a force-matching loss
    through global_multipoles: E = sum(w q_global + q_global^2 / 2), F =
    -dE/dx (a graph asked of it), loss = sum((F - F0)^2): K8's double
    backward (FramesBwdFn's backward)."""
    pos, box, q, types, anchors = system
    lmax = int(round(q.shape[1] ** 0.5)) - 1
    x, ql = (t.detach().to(dtype).requires_grad_(True) for t in (pos, q))
    rng = np.random.default_rng(11)
    w = torch.tensor(rng.standard_normal(tuple(q.shape)), dtype=dtype,
                     device=q.device)
    f0 = torch.tensor(rng.standard_normal(tuple(pos.shape)), dtype=dtype,
                      device=q.device)
    qg = _frames_route(method)(x, box.to(dtype), ql, types, anchors, lmax)
    e = (w * qg + 0.5 * qg * qg).sum()
    (g,) = torch.autograd.grad(e, x, create_graph=True)
    loss = ((-g - f0) ** 2).sum()
    return torch.autograd.grad(loss, (ql, x))


FRAMES_CASES = [("water", 2), ("random", 1), ("random", 2)]
# on the card also the main path's 98,304-site water box
FRAMES_CARD_CASES = FRAMES_CASES + [("water98k", 2)]


def _frames_case(dev, name, lmax):
    if name.startswith("water"):
        return _frames_water(dev, n_side=32 if name == "water98k" else 4)
    return _frames_system(dev, lmax)


@pytest.mark.parametrize("name,lmax", FRAMES_CARD_CASES)
def test_frames_kernel_matches_plain(dev, name, lmax):
    """K8 forward and backward against the plain chain in float64, within
    max(1e-6, 2 x the plain float32 chain's error) relative RMSE for the
    global multipoles and max(1e-5, 2 x its error) for the gradients (the
    positions' are summed by atomics in an order that varies from run to
    run, and the card contracts to FMAs); one launch each way, and none on
    the plain route."""
    from admp_tpu_torch.ops.cuda import frames as K8

    system = _frames_case(dev, name, lmax)
    f0, b0 = K8.launch_frames_fwd.launches, K8.launch_frames_bwd.launches
    kern = _frames_grads(system, "cuda", torch.float32)
    torch.cuda.synchronize()
    assert K8.launch_frames_fwd.launches - f0 == 1
    assert K8.launch_frames_bwd.launches - b0 == 1
    plain = _frames_grads(system, "torch", torch.float32)
    assert K8.launch_frames_fwd.launches - f0 == 1
    truth = _frames_grads(system, "torch", torch.float64)
    for what, k, p, t, floor in zip(("q_global", "positions", "box",
                                     "q_local"), kern, plain, truth,
                                    (1e-6, 1e-5, 1e-5, 1e-5)):
        assert bool(torch.isfinite(k).all()), what
        tol = max(floor, 2 * _rel(p, t))
        assert _rel(k, t) <= tol, (what, _rel(k, t), tol)


@pytest.mark.parametrize("name,lmax", FRAMES_CARD_CASES)
def test_frames_kernel_forward_is_the_plain_chain_bitwise(dev, name, lmax):
    """K8's forward is the plain float32 chain's result bit for bit: built
    without FMA contraction, it takes the chain's operations in their order
    and rounds each as PyTorch's elementwise ops do."""
    from admp_tpu_torch.ops.cuda import frames as K8

    pos, box, q, types, anchors = _frames_case(dev, name, lmax)
    got = K8.kernel_global_multipoles(pos, box, q, types, anchors, lmax)
    want = K8.global_multipoles_torch(pos, box, q, types, anchors, lmax)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("name,lmax", FRAMES_CARD_CASES)
def test_frames_kernel_double_backward(dev, name, lmax):
    """A force-matching loss's gradient w.r.t. q_local and the positions
    through K8 (its backward's backward recomputes the plain chain) against
    the plain chain in float64, within max(1e-5, 2 x the plain float32
    chain's error) relative RMSE."""
    system = _frames_case(dev, name, lmax)
    kern = _frames_force_matching(system, "cuda", torch.float32)
    plain = _frames_force_matching(system, "torch", torch.float32)
    truth = _frames_force_matching(system, "torch", torch.float64)
    for what, k, p, t in zip(("q_local", "positions"), kern, plain, truth):
        tol = max(1e-5, 2 * _rel(p, t))
        assert _rel(k, t) <= tol, (what, _rel(k, t), tol)


def test_frames_auto_takes_the_kernel_in_float32_only(dev):
    """'auto' launches K8 on float32 CUDA inputs and the plain chain on
    float64 ones (the float64 real-space modes)."""
    from admp_tpu_torch.ops.cuda import frames as K8

    system = _frames_water(dev)
    f0 = K8.launch_frames_fwd.launches
    _frames_grads(system, "auto", torch.float32)
    assert K8.launch_frames_fwd.launches - f0 == 1
    _frames_grads(system, "auto", torch.float64)
    assert K8.launch_frames_fwd.launches - f0 == 1
