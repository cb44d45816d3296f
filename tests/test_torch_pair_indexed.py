"""The pair kernels' indexed route on the CPU: ``PairTableEnergyFn`` (K1) and
``PairTableBwdFn`` (K2), which read both rows of a pair from the packed atom
table through the pair list and add the rows' gradients into the table's,
run their plain branches on CPU tensors (``index_select`` and
``pair_energies_torch``; the scatter by ``index_add``), so their wiring is
held here; the kernels themselves are held on the card
(tests/test_torch_kernels_cuda.py).

* The Functions against the gathered plain version at float64, for 'perm',
  'pol' and 'uu' at lmax 0-2, on a padded i-sorted list with masked pairs
  and on the same list shuffled: energies bit for bit, the gradients of the
  table, the scale rows and the scalars 1e-12 relative, the double backward
  (``create_graph``, through the gathered ``PairHvpFn``) 1e-11, and for
  'pol' and 'uu' the third derivative (``PairHvpFn``'s backward) 1e-10; a
  pair with an index outside [0, N) masked (the clamped list with its mask
  row 0, at the same tolerances); the counters ``pairs.gathered`` (each double backward) and ``pairs.indexed``
  (card launches only: 0 here).
* ``pme_real_energy`` and ``pme_real_uu_energy`` on the indexed route (the
  dispatch made to answer yes on the CPU) against admp_tpu's XLA path at
  float64 on i-sorted, shuffled and chunked lists: energy and every
  gradient 1e-10 relative, as tests/test_torch_realspace.py holds the plain
  route.
* The SCF on the 3,000-atom water box (water_system(n_side=10), cell-list
  pairs): the induced field at zero dipoles, the matvec of the u-quadratic
  energy and a polarizable MD-profile force call on the indexed route
  against the plain component route: 1e-11 relative, the same PCG
  iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.models import pme as jpme
from admp_tpu.ops.frames import local_frames_components as j_frames
from admp_tpu.ops.harmonics import rot_local2global_components as j_l2g
from admp_tpu_torch import (
    ADMPPmeForce,
    EngineConfig,
    SCFConfig,
    convert_cart2harm,
    neighbor_list_cell,
)
from admp_tpu_torch.models import pme as tpme
from admp_tpu_torch.ops.cuda import pairs as P
from admp_tpu_torch.systems import water_system
from admp_tpu_torch.utils import profiling
from torch_port_cases import assert_close, dense_pairs, rel_err, t64, water

KINDS = [("perm", 0), ("perm", 1), ("perm", 2), ("pol", 0), ("pol", 1),
         ("pol", 2), ("uu", 1)]
KAPPA = 0.68
M_SCALES = np.array([0.0, 0.3, 0.7, 1.0, 1.0])
P_SCALES = np.array([0.0, 0.5, 1.0, 1.0, 1.0])


def _indexed_route(monkeypatch):
    """pme_real_energy's dispatch answering 'the kernels' for every route
    but 'torch', so CPU tensors reach the indexed Functions."""
    monkeypatch.setattr(tpme, "use_kernel",
                        lambda method, x, what, *a: method != "torch")


def _order(pairs, order, seed=3):
    """The list as built (i-sorted, padding last) or its rows shuffled."""
    if order == "sorted":
        return pairs
    return pairs[np.random.default_rng(seed).permutation(len(pairs))]


def _inputs(kind, lmax, order):
    """(table, i, j, scl, scal) at float64 on the 81-atom water box: the
    packed table of the kind's width, the pair columns of a padded dense
    list (a tenth of its real pairs masked besides), its scale rows and the
    19 scalars."""
    s = water(n_side=3, seed=5)
    n = s["positions"].shape[0]
    rng = np.random.default_rng(11)
    pairs = _order(dense_pairs(s["positions"], s["box"], 4.0), order)
    i = np.minimum(pairs[:, 0], n - 1)
    j = np.minimum(pairs[:, 1], n - 1)
    mask = (pairs[:, 0] < pairs[:, 1]) & (rng.uniform(size=len(pairs)) > 0.1)
    u = rng.normal(0, 0.05, (n, 3))
    pol, th = s["pol"][:, None], s["tholes"][:, None]
    sc = M_SCALES[rng.integers(0, 5, len(pairs))]
    if kind == "uu":
        table, rows = np.concatenate([s["positions"], u, pol, th], 1), [sc]
    else:
        q = rng.normal(0, 0.3, (n, (lmax + 1) ** 2))
        table, rows = np.concatenate([s["positions"], q], 1), [sc]
        if kind == "pol":
            table = np.concatenate([table, u, pol, th], 1)
    rows.append(mask)
    if kind == "pol":
        rows.append(P_SCALES[rng.integers(0, 5, len(pairs))])
    box = s["box"]
    scal = np.concatenate([[KAPPA], box.reshape(9),
                           np.linalg.inv(box).reshape(9)])
    return (t64(table), torch.as_tensor(i), torch.as_tensor(j),
            t64(np.stack(rows)), t64(scal))


def _gathered(table, i, j, scl, scal, lmax, kind):
    return P.pair_energies_torch(table.index_select(0, i),
                                 table.index_select(0, j), scl, scal, lmax,
                                 kind)


def _leaves(table, scl, scal):
    return [t.clone().requires_grad_(True) for t in (table, scl, scal)]


def _derivatives(fn, x, i, j, ct, v, lmax, kind):
    """The first and second derivatives of sum(ct e) of ``fn`` at leaves
    x = (table, scl, scal): the gradient, and the gradient of <gradient, v>
    with respect to x and ct."""
    e = fn(x[0], i, j, x[1], x[2], lmax, kind)
    g = torch.autograd.grad((e * ct).sum(), x, create_graph=True)
    h = torch.autograd.grad(sum((a * b).sum() for a, b in zip(g, v)),
                            x + [ct])
    return e, g, h


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("kind,lmax", KINDS)
def test_indexed_functions_match_the_gathered_plain_version(kind, lmax,
                                                            order):
    table, i, j, scl, scal = _inputs(kind, lmax, order)
    rng = np.random.default_rng(2)
    ct = t64(rng.uniform(0.5, 1.5, i.shape[0])).requires_grad_(True)
    v = [t64(rng.standard_normal(t.shape)) for t in (table, scl, scal)]
    v[1][1] = 0.0  # the mask row
    out = {}
    for name, fn in (("indexed", P.pair_energies_indexed),
                     ("gathered", _gathered)):
        x = _leaves(table, scl, scal)
        out[name] = _derivatives(fn, x, i, j, ct, v, lmax, kind)
    (e_k, g_k, h_k), (e_p, g_p, h_p) = out["indexed"], out["gathered"]
    assert torch.equal(e_k, e_p)
    for name, a, b in zip(("table", "scl", "scal"), g_k, g_p):
        assert_close(a.detach(), b.detach(), rel=1e-12, abs_=0.0), name
    for name, a, b in zip(("table", "scl", "scal", "ct"), h_k, h_p):
        assert_close(a, b, rel=1e-11, abs_=0.0), name


@pytest.mark.parametrize("kind,lmax", [("pol", 2), ("uu", 1)])
def test_indexed_functions_third_derivative(kind, lmax):
    """A force-matching loss's derivative: the gradient of <hvp, w> through
    the gathered PairHvpFn's backward (pair_third_torch on the CPU)."""
    table, i, j, scl, scal = _inputs(kind, lmax, "shuffled")
    rng = np.random.default_rng(4)
    ct = t64(rng.uniform(0.5, 1.5, i.shape[0]))
    v = t64(rng.standard_normal(table.shape))
    w = t64(rng.standard_normal(table.shape))
    out = []
    for fn in (P.pair_energies_indexed, _gathered):
        x = _leaves(table, scl, scal)
        e = fn(x[0], i, j, x[1], x[2], lmax, kind)
        (g,) = torch.autograd.grad((e * ct).sum(), x[:1], create_graph=True)
        (h,) = torch.autograd.grad((g * v).sum(), x[:1], create_graph=True)
        out.append(torch.autograd.grad((h * w).sum(), x))
    for name, a, b in zip(("table", "scl", "scal"), *out):
        assert_close(a, b, rel=1e-10, abs_=0.0), name


@pytest.mark.parametrize("kind,lmax", [("perm", 2), ("pol", 2), ("uu", 1)])
def test_indexed_functions_mask_pairs_outside_the_table(kind, lmax):
    """A pair whose i or j lies outside [0, N) (a padding slot N, or -1) is
    masked, as K1/K2 mask it: the energies (0 there), gradients and double
    backward are those of the list with those indices clamped into the
    table and the pairs' mask row 0."""
    table, i, j, scl, scal = _inputs(kind, lmax, "shuffled")
    n = table.shape[0]
    i_raw, j_raw = i.clone(), j.clone()
    i_raw[::13] = n
    j_raw[4::17] = -1
    outside = (i_raw >= n) | (j_raw < 0)
    keep = torch.ones_like(scl)
    keep[1] = ~outside
    i_in, j_in = i_raw.clamp(0, n - 1), j_raw.clamp(0, n - 1)

    def clamped(table, i, j, scl, scal, lmax, kind):
        return _gathered(table, i_in, j_in, scl * keep, scal, lmax, kind)

    rng = np.random.default_rng(6)
    ct = t64(rng.uniform(0.5, 1.5, i.shape[0])).requires_grad_(True)
    v = [t64(rng.standard_normal(t.shape)) for t in (table, scl, scal)]
    v[1][1] = 0.0  # the mask row
    (e_k, g_k, h_k), (e_p, g_p, h_p) = (
        _derivatives(fn, _leaves(table, scl, scal), i_raw, j_raw, ct, v,
                     lmax, kind) for fn in (P.pair_energies_indexed, clamped))
    assert torch.equal(e_k, e_p) and bool((e_k[outside] == 0).all())
    for name, a, b in zip(("table", "scl", "scal"), g_k, g_p):
        assert_close(a.detach(), b.detach(), rel=1e-12, abs_=0.0), name
    for name, a, b in zip(("table", "scl", "scal", "ct"), h_k, h_p):
        assert_close(a, b, rel=1e-11, abs_=0.0), name


def test_indexed_functions_count_their_gathered_fallback():
    """Under a profiler: a first derivative takes no gathered fallback; a
    double backward takes one (``pairs.gathered``); ``pairs.indexed``
    counts card launches only."""
    table, i, j, scl, scal = _inputs("pol", 2, "sorted")
    x = _leaves(table, scl, scal)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        e = P.pair_energies_indexed(x[0], i, j, x[1], x[2], 2, "pol")
        (g,) = torch.autograd.grad(e.sum(), x[:1], create_graph=True)
        first = dict(profiling.snapshot()["counters"])
        torch.autograd.grad(g.sum(), x[:1])
        second = profiling.snapshot()["counters"]
    profiling.reset()
    assert "pairs.gathered" not in first
    assert second.get("pairs.gathered") == 1
    assert "pairs.indexed" not in second


def _case(seed=5):
    s = water(n_side=3, seed=seed)
    n = s["positions"].shape[0]
    frames = j_frames(jnp.asarray(s["positions"]), jnp.asarray(s["box"]),
                      jnp.asarray(s["axis_types"]),
                      jnp.asarray(s["axis_indices"]))
    s["q_global"] = np.asarray(j_l2g(jnp.asarray(s["q_local"]), frames, 2))
    s["u_harm"] = np.random.default_rng(seed).normal(0, 0.05, (n, 3))
    s["pairs"] = dense_pairs(s["positions"], s["box"], 4.0)
    return s


def _list(s, order):
    """(the list the port takes, its pair_chunk): i-sorted, shuffled, or
    i-sorted in blocks of 128 pairs."""
    if order == "chunked":
        return torch.as_tensor(s["pairs"]), 128
    return torch.as_tensor(_order(s["pairs"], order)), None


@pytest.mark.parametrize("order", ["sorted", "shuffled", "chunked"])
@pytest.mark.parametrize("lmax,lpol", [(0, False), (1, False), (2, False),
                                       (1, True), (2, True)])
def test_pme_real_energy_indexed_matches_xla(monkeypatch, lmax, lpol,
                                             order):
    _indexed_route(monkeypatch)
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

    ej, gj = jax_value_and_grad(jf, vals)
    pairs, chunk = _list(s, order)
    leaves = [t64(v).requires_grad_(True) for v in vals]
    d = dict(zip(names, leaves))
    et = tpme.pme_real_energy(
        d["positions"], d["box"], pairs, d["q_global"], d.get("u_harm"),
        d.get("pol"), d.get("tholes"), d["m_scales"], d.get("p_scales"),
        torch.as_tensor(s["covalent_map"]), KAPPA, lmax, lpol,
        compensated=True, pair_kernel="auto", pair_chunk=chunk)
    gt = torch.autograd.grad(et, leaves)
    assert_close(et.detach(), ej)
    for name, a, b in zip(names, gt, gj):
        assert_close(a, b, rel=1e-10, abs_=1e-12), name


@pytest.mark.parametrize("order", ["sorted", "shuffled", "chunked"])
def test_pme_real_uu_energy_indexed_matches_xla(monkeypatch, order):
    _indexed_route(monkeypatch)
    s = _case(seed=7)
    vals = [s["positions"], s["box"], s["u_harm"], s["pol"], s["tholes"],
            P_SCALES]

    def jf(pos, box, u, pol, th, ps):
        return jpme.pme_real_uu_energy(
            pos, box, jnp.asarray(s["pairs"]), u, pol, th, ps,
            jnp.asarray(s["covalent_map"]), KAPPA, pair_kernel="xla")

    ej, gj = jax_value_and_grad(jf, vals)
    pairs, chunk = _list(s, order)
    leaves = [t64(v).requires_grad_(True) for v in vals]
    et = tpme.pme_real_uu_energy(
        leaves[0], leaves[1], pairs, *leaves[2:],
        torch.as_tensor(s["covalent_map"]), KAPPA, pair_kernel="auto",
        pair_chunk=chunk)
    gt = torch.autograd.grad(et, leaves)
    assert_close(et.detach(), ej)
    for a, b in zip(gt, gj):
        assert_close(a, b)


def jax_value_and_grad(fn, vals):
    import jax

    return jax.value_and_grad(fn, argnums=tuple(range(len(vals))))(
        *[jnp.asarray(v) for v in vals])


@pytest.fixture(scope="module")
def water3k():
    """The 3,000-atom water box, float64 on the CPU, with cell-list pairs
    (i-sorted, padding last)."""
    s = water_system(n_side=10, spacing=3.1, jitter=0.12, seed=4)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64))  # noqa: E731
    pos, box = t(s["positions"]), t(s["box"])
    n = pos.shape[0]
    rng = np.random.default_rng(8)
    return dict(
        s=s, positions=pos, box=box, pairs=neighbor_list_cell(pos, box, 4.0).pairs,
        q_local=convert_cart2harm(t(s["q_cart"]), 2), pol=t(s["pol"]),
        tholes=t(s["tholes"]), scales=t([0.0, 0.0, 0.0, 1.0, 1.0]),
        u=t(rng.normal(0, 0.02, (n, 3))), n=n)


def _force(w, route):
    s = w["s"]
    cfg = EngineConfig(scf=SCFConfig.md(), pair_kernel=route,
                       spread_method="torch")
    return ADMPPmeForce(s["box"], s["axis_types"], s["axis_indices"],
                        s["covalent_map"], 4.0, 1e-4, 2, lpol=True,
                        config=cfg, device="cpu", dtype=torch.float64)


def _field_and_matvec(w, force):
    """The field of the permanent multipoles on the dipoles (the 'pol' pass
    at zero dipoles: the gradient of the polarizable energy in u) and the
    matvec A u (the 'uu' pass: the gradient of the u-quadratic energy)."""
    sc = w["scales"]
    u0 = torch.zeros(w["n"], 3, dtype=torch.float64, requires_grad=True)
    e = tpme.energy_pme(
        w["positions"], w["box"], w["pairs"], w["q_local"], u0, w["pol"],
        w["tholes"], sc, sc, sc, force.covalent_map, force.axis_type,
        force.axis_indices, force.pme_recip, force.kappa, 2, True,
        force.config)
    v = w["u"].clone().requires_grad_(True)
    e_uu = force.energy_uu(w["positions"], w["box"], w["pairs"], v,
                           w["pol"], w["tholes"], sc)
    return torch.autograd.grad(e, u0)[0], torch.autograd.grad(e_uu, v)[0]


def test_scf_field_matvec_and_step_on_3000_atoms(monkeypatch, water3k):
    _indexed_route(monkeypatch)
    w = water3k
    sc = w["scales"]
    out = {}
    for route in ("auto", "torch"):
        force = _force(w, route)
        field, matvec = _field_and_matvec(w, force)
        e, g = force.get_forces(w["positions"], w["box"], w["pairs"],
                                w["q_local"], w["pol"], w["tholes"], sc, sc,
                                sc)
        out[route] = (field, matvec, e, g, force.U_ind.clone(),
                      force.n_cycle)
    (f_k, m_k, e_k, g_k, u_k, n_k), (f_p, m_p, e_p, g_p, u_p, n_p) = (
        out["auto"], out["torch"])
    assert rel_err(f_k, f_p) < 1e-11
    assert rel_err(m_k.detach(), m_p.detach()) < 1e-11
    assert abs(float(e_k) - float(e_p)) <= 1e-11 * abs(float(e_p))
    assert rel_err(g_k, g_p) < 1e-11
    assert rel_err(u_k, u_p) < 1e-11
    assert n_k == n_p > 0
