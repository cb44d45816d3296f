"""admp_tpu_torch real space against admp_tpu.

* The plain component pair path (pme_real_energy / pme_real_uu_energy) against
  admp_tpu's XLA path at float64: energies and every gradient, 1e-10 relative.
* The pair kernel's plain version (ops/cuda/pairs.pair_energies_torch) against
  the Pallas pair kernels K1/K2 run in interpret mode at float32, kinds
  perm/pol/uu at lmax 0-2: energy within 2e-6 |E| + 1e-3 and every gradient
  (rows, scale rows, the 19 scalars) within 3e-6 relative RMSE, the
  tolerance of tests/test_pairs_kernel.py (the Pallas kernel's gaussian and
  erfc are rational reformulations, ~1e-7 relative per pair).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.models import pme as jpme
from admp_tpu.ops.frames import local_frames_components as j_frames
from admp_tpu.ops.harmonics import rot_local2global_components as j_l2g
from admp_tpu.ops.pallas.pairs import pair_perm_energies
from admp_tpu_torch.models import pme as tpme
from admp_tpu_torch.ops.cuda.pairs import pair_energies_torch
from torch_port_cases import assert_close, dense_pairs, rel_err, t64, water

KAPPA = 0.68
M_SCALES = np.array([0.0, 0.3, 0.7, 1.0, 1.0])
P_SCALES = np.array([0.0, 0.5, 1.0, 1.0, 1.0])


def _case(seed=5):
    s = water(n_side=3, seed=seed)
    n = s["positions"].shape[0]
    frames = j_frames(jnp.asarray(s["positions"]), jnp.asarray(s["box"]),
                      jnp.asarray(s["axis_types"]),
                      jnp.asarray(s["axis_indices"]))
    s["q_global"] = np.asarray(j_l2g(jnp.asarray(s["q_local"]), frames, 2))
    rng = np.random.default_rng(seed)
    s["u_harm"] = rng.normal(0, 0.05, (n, 3))
    s["pairs"] = dense_pairs(s["positions"], s["box"], 4.0)
    return s


@pytest.mark.parametrize("lmax,lpol", [(0, False), (1, False), (2, False),
                                       (1, True), (2, True)])
def test_pme_real_energy_matches_xla(lmax, lpol):
    s = _case()
    n_h = (lmax + 1) ** 2
    names = ["positions", "box", "q_global", "m_scales"]
    vals = [s["positions"], s["box"], s["q_global"][:, :n_h], M_SCALES]
    if lpol:
        names += ["u_harm", "pol", "tholes", "p_scales"]
        vals += [s["u_harm"], s["pol"], s["tholes"], P_SCALES]

    def jf(*a):
        d = dict(zip(names, a))
        return jpme.pme_real_energy(
            d["positions"], d["box"], jnp.asarray(s["pairs"]), d["q_global"],
            d.get("u_harm"), d.get("pol"), d.get("tholes"), d["m_scales"],
            d.get("p_scales"), jnp.asarray(s["covalent_map"]), KAPPA, lmax,
            lpol, compensated=True, pair_kernel="xla")

    ej, gj = jax.value_and_grad(jf, argnums=tuple(range(len(vals))))(
        *[jnp.asarray(v) for v in vals])
    leaves = [t64(v).requires_grad_(True) for v in vals]
    d = dict(zip(names, leaves))
    et = tpme.pme_real_energy(
        d["positions"], d["box"], torch.as_tensor(s["pairs"]), d["q_global"],
        d.get("u_harm"), d.get("pol"), d.get("tholes"), d["m_scales"],
        d.get("p_scales"), torch.as_tensor(s["covalent_map"]), KAPPA, lmax,
        lpol, compensated=True, pair_kernel="torch")
    gt = torch.autograd.grad(et, leaves)
    assert_close(et.detach(), ej)
    for name, a, b in zip(names, gt, gj):
        assert_close(a, b, rel=1e-10, abs_=1e-12), name


def test_pme_real_uu_energy_matches_xla():
    s = _case(seed=7)
    vals = [s["positions"], s["box"], s["u_harm"], s["pol"], s["tholes"],
            P_SCALES]

    def jf(pos, box, u, pol, th, ps):
        return jpme.pme_real_uu_energy(
            pos, box, jnp.asarray(s["pairs"]), u, pol, th, ps,
            jnp.asarray(s["covalent_map"]), KAPPA, pair_kernel="xla")

    ej, gj = jax.value_and_grad(jf, argnums=tuple(range(6)))(
        *[jnp.asarray(v) for v in vals])
    leaves = [t64(v).requires_grad_(True) for v in vals]
    et = tpme.pme_real_uu_energy(
        leaves[0], leaves[1], torch.as_tensor(s["pairs"]), *leaves[2:],
        torch.as_tensor(s["covalent_map"]), KAPPA, pair_kernel="torch")
    gt = torch.autograd.grad(et, leaves)
    assert_close(et.detach(), ej)
    for a, b in zip(gt, gj):
        assert_close(a, b)


def _kernel_tables(kind, lmax):
    """Gathered per-pair rows as the engines build them, float32 numpy."""
    s = _case(seed=4)
    n = s["positions"].shape[0]
    pairs = s["pairs"]
    mask = pairs[:, 0] < pairs[:, 1]
    i = np.minimum(pairs[:, 0], n - 1)
    j = np.minimum(pairs[:, 1], n - 1)
    nbond = s["covalent_map"][i, j]
    last = len(M_SCALES) - 1
    sidx = np.where(nbond == 0, last, np.minimum(nbond - 1, last))
    pol, th = s["pol"][:, None], s["tholes"][:, None]
    if kind == "uu":
        packed = np.concatenate([s["positions"], s["u_harm"], pol, th], 1)
        scl = np.stack([P_SCALES[sidx], mask])
    else:
        cols = [s["positions"], s["q_global"][:, : (lmax + 1) ** 2]]
        rows = [M_SCALES[sidx], mask]
        if kind == "pol":
            cols += [s["u_harm"], pol, th]
            rows.append(P_SCALES[sidx])
        packed = np.concatenate(cols, 1)
        scl = np.stack(rows)
    box = s["box"]
    scal = np.concatenate([[KAPPA], box.reshape(9),
                           np.linalg.inv(box).reshape(9)])
    rng = np.random.default_rng(9)
    ct = rng.uniform(0.5, 1.5, len(pairs))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(packed[i]), f32(packed[j]), f32(scl), f32(scal), f32(ct)


@pytest.mark.parametrize("kind,lmax", [("perm", 0), ("perm", 1), ("perm", 2),
                                       ("pol", 1), ("pol", 2), ("uu", 1)])
def test_block_function_matches_interpret_kernel(kind, lmax):
    g_i, g_j, scl, scal, ct = _kernel_tables(kind, lmax)

    def jf(a, b, c, d):
        e = pair_perm_energies(a, b, c, d, lmax, interpret=True, kind=kind)
        return jnp.sum(e * jnp.asarray(ct))

    ej, gj = jax.value_and_grad(jf, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(x) for x in (g_i, g_j, scl, scal)])
    leaves = [torch.tensor(x, requires_grad=True) for x in (g_i, g_j, scl, scal)]
    e = pair_energies_torch(*leaves, lmax, kind)
    et = torch.sum(e * torch.as_tensor(ct))
    gt = torch.autograd.grad(et, leaves)
    assert abs(float(et.detach()) - float(ej)) < 2e-6 * abs(float(ej)) + 1e-3
    mask_row = 1
    for name, a, b in zip(("g_i", "g_j", "scl", "scal"), gt, gj):
        a, b = a.numpy(), np.asarray(b)
        assert np.all(np.isfinite(a)), name
        if name == "scl":
            # the mask row has no gradient on either side
            assert np.all(a[mask_row] == 0) and np.all(b[mask_row] == 0)
            a, b = np.delete(a, mask_row, 0), np.delete(b, mask_row, 0)
        assert rel_err(a, b) < 3e-6, (name, rel_err(a, b))


def test_pair_kernel_dispatch_on_cpu():
    """pme_real_energy's ``pair_kernel`` on CPU tensors: 'cuda' refuses
    them, 'auto' takes the plain component path, as 'torch' does."""
    s = _case(seed=4)
    args = (t64(s["positions"]), t64(s["box"]), torch.as_tensor(s["pairs"]),
            t64(s["q_global"][:, :4]), None, None, None, t64(M_SCALES), None,
            torch.as_tensor(s["covalent_map"]), KAPPA, 1, False)
    with pytest.raises(ValueError, match="CUDA"):
        tpme.pme_real_energy(*args, pair_kernel="cuda")
    plain = tpme.pme_real_energy(*args, pair_kernel="torch")
    assert torch.equal(tpme.pme_real_energy(*args), plain)
