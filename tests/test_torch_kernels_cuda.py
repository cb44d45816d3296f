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
not, with atoms outside the box; K5 on a crowded tile that holds more
atoms than its stage (chunks, in a fixed order); the plain versions under
gradcheck at float64; second-order pulls on the kernels; and 'auto' on a
256^3 mesh launching K5/K7 and not K4/K6. K6 bit for bit on axes shorter
than the stencil and on rows that wrap at K3, on a side stream, and the
launchers' refusal of bases on another device.
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


def _tables(dev, kind, lmax):
    s, pos, box, _, qg, pairs = _system(dev)
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


@pytest.mark.parametrize("kind,lmax", [("perm", 0), ("perm", 1), ("perm", 2),
                                       ("pol", 0), ("pol", 1), ("pol", 2),
                                       ("uu", 1)])
def test_pair_kernels_match_plain(dev, kind, lmax):
    g_i, g_j, scl, scal, ct = _tables(dev, kind, lmax)
    e_k = P.launch_pair_fwd(g_i, g_j, scl, scal, lmax, kind)
    e_p = P.pair_energies_torch(g_i, g_j, scl, scal, lmax, kind)
    torch.cuda.synchronize()
    floor = 1e-6 * float(e_p.abs().max())
    assert bool(((e_k - e_p).abs() <= 1e-5 * e_p.abs() + floor).all())
    out_k = P.launch_pair_bwd(g_i, g_j, scl, scal, ct, lmax, kind)
    leaves = [t.clone().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
    out_p = torch.autograd.grad(
        (P.pair_energies_torch(*leaves, lmax, kind) * ct).sum(), leaves)
    torch.cuda.synchronize()
    for name, a, b in zip(("g_i", "g_j", "scl", "scal"), out_k, out_p):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))


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
    plain version, agrees with a central difference of the backward (K2),
    and is itself first order (a third derivative raises)."""
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
        outs = P.launch_pair_bwd(*(a + t * b for a, b in zip(x, v)), ct,
                                 lmax, kind)
        return sum(float((o.double() * c.double()).sum())
                   for o, c in zip(outs, cs))

    h = 4e-3
    d1 = (phi(h) - phi(-h)) / (2 * h)
    d2 = (phi(h / 2) - phi(-h / 2)) / h
    fd = (4 * d2 - d1) / 3
    an = sum(float((o.double() * d.double()).sum())
             for o, d in zip(out_k[:4], v))
    assert abs(fd - an) <= 1e-2 * abs(an), (fd, an)

    leaves = [t.clone().requires_grad_(True) for t in x]
    e = P.pair_energies(*leaves, lmax, kind, method="cuda")
    grads = torch.autograd.grad((e * ct).sum(), leaves, create_graph=True)
    hvp = torch.autograd.grad(sum((g * c).sum() for g, c in zip(grads, cs)),
                              leaves, create_graph=True)
    for a, b in zip(hvp, out_k[:4]):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(hvp[0].sum(), leaves[0])


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
