"""admp_tpu_torch's CUDA kernels against their plain PyTorch versions, on the
card (marked ``cuda``; each test skips without a CUDA device).

This file imports nothing of JAX or admp_tpu, so it also runs where JAX is not
installed; tests/conftest.py imports JAX, hence on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances (float32 on the card): pair energies 1e-5 relative per pair with
an absolute floor of 1e-6 max|e| (a pair's rounding follows its largest
term), pair gradients 1e-5 relative RMSE, the spread 1e-5 max|mesh| (atomic
summation order), the gather bit for bit.
"""

import numpy as np
import pytest
import torch

from admp_tpu_torch import ADMPPmeForce, EngineConfig, SCFConfig
from admp_tpu_torch import convert_cart2harm, neighbor_list_dense, water_system
from admp_tpu_torch.models.pme import _pair_indices, _pair_scalars
from admp_tpu_torch.ops.cuda import pairs as P
from admp_tpu_torch.ops.cuda import spread as S
from admp_tpu_torch.ops.exclusions import scale_for_distance
from admp_tpu_torch.ops.frames import local_frames_components
from admp_tpu_torch.ops.harmonics import rot_local2global_components
from admp_tpu_torch.ops.reciprocal import atom_spread_alpha, spread_points_separable

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


def test_pair_kernel_autograd_is_first_order(dev):
    g_i, g_j, scl, scal, _ = _tables(dev, "perm", 2)
    g = g_i.clone().requires_grad_(True)
    e = P.pair_energies(g, g_j, scl, scal, 2, "perm").sum()
    (d,) = torch.autograd.grad(e, g, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(d.sum(), g)


@pytest.mark.parametrize("order,channels", [(6, 1), (4, 1), (6, 3)])
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
