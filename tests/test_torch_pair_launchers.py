"""The pair launchers' one-pass validation (admp_tpu_torch/ops/cuda/pairs.py).

Each launcher (K1 ``launch_pair_fwd``, K2 ``launch_pair_bwd``, K3
``launch_pair_hvp``, K3b ``launch_pair_third``) raises ValueError before it builds or launches
anything on tables its kernel cannot take: a kind or lmax it has no template
for, a wrong shape, a CPU tensor, float64 or a non-contiguous table. The
error names the first failure, in the order kind, lmax, every input's shape
(K1/K2: the packed table, i, j, the scale rows, the scalars; K3/K3b: the
gathered rows g_i, g_j, the scale rows, the scalars), then every input's
type, so each case shows here on the CPU; the kernels themselves are held
on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from admp_tpu_torch.ops.cuda import pairs as P

C = 20


def _inputs(kind="pol", lmax=2):
    rng = np.random.default_rng(3)
    f = P._width(lmax, kind)
    t = lambda *shape: torch.as_tensor(  # noqa: E731
        rng.normal(size=shape), dtype=torch.float32)
    return t(C, f), t(C, f), t(P._n_scl(kind), C), t(P.N_SCAL), t(C)


def _launch(launcher, g_i, g_j, scl, scal, ct, lmax, kind):
    """The launcher on the tables; K1/K2 read g_i as their packed table,
    pair p at rows (p, p)."""
    idx = torch.arange(C)
    if launcher == "fwd":
        return P.launch_pair_fwd(g_i, idx, idx, scl, scal, lmax, kind)
    if launcher == "bwd":
        return P.launch_pair_bwd(g_i, idx, idx, scl, scal, ct, lmax, kind)
    if launcher == "hvp":
        return P.launch_pair_hvp(g_i, g_j, scl, scal, ct, g_i, g_j, scl, scal,
                                 lmax, kind)
    return P.launch_pair_third(g_i, g_j, scl, scal, ct, g_i, g_j, scl, scal,
                               g_i, g_j, scl, scal, ct, lmax, kind)


def _strided(x):
    """x's values in a non-contiguous tensor of the same shape."""
    wide = x.new_empty(*x.shape[:-1], 2 * x.shape[-1])
    wide[..., ::2] = x
    return wide[..., ::2]


CASES = {
    # case: (what changes in (g_i, g_j, scl, scal, ct, lmax, kind), the
    # words the error carries; {rows}: the first input's name)
    "cpu": (lambda g, h, s, k, c: (g, h, s, k, c, 2, "pol"),
            "contiguous float32 CUDA"),
    "float64": (lambda g, h, s, k, c: (g.double(), h, s, k, c, 2, "pol"),
                "contiguous float32 CUDA"),
    "non_contiguous": (lambda g, h, s, k, c: (_strided(g), h, s, k, c, 2,
                                              "pol"),
                       "contiguous float32 CUDA"),
    "wrong_width": (lambda g, h, s, k, c: (g[:, :12].contiguous(), h, s, k,
                                           c, 2, "pol"), "{rows}: shape"),
    "lmax_3": (lambda g, h, s, k, c: (g, h, s, k, c, 3, "pol"), "lmax=3"),
    "kind": (lambda g, h, s, k, c: (g, h, s, k, c, 2, "quad"), "kind='quad'"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("launcher", ["fwd", "bwd", "hvp", "third"])
def test_pair_launcher_refuses_what_its_kernel_cannot_take(launcher, case):
    change, words = CASES[case]
    fn = getattr(P, f"launch_pair_{launcher}")
    before = fn.launches
    rows = "table" if launcher in ("fwd", "bwd") else "g_i"
    with pytest.raises(ValueError, match=words.format(rows=rows)):
        _launch(launcher, *change(*_inputs()))
    assert fn.launches == before


def _indexed_inputs(kind="pol", lmax=2, n=8):
    g_i, _, scl, scal, ct = _inputs(kind, lmax)
    rng = np.random.default_rng(4)
    idx = lambda: torch.as_tensor(rng.integers(0, n, C))  # noqa: E731
    return g_i[:n].contiguous(), idx(), idx(), scl, scal, ct


INDEXED_CASES = {
    # case: (what changes in (table, i, j, scl, scal, ct, lmax, kind), the
    # words the error carries)
    "cpu": (lambda t, i, j, s, k, c: (t, i, j, s, k, c, 2, "pol"),
            "table: needs a contiguous float32 CUDA"),
    "float64": (lambda t, i, j, s, k, c: (t.double(), i, j, s, k, c, 2,
                                          "pol"),
                "table: needs a contiguous float32 CUDA"),
    "non_contiguous": (lambda t, i, j, s, k, c: (_strided(t), i, j, s, k, c,
                                                 2, "pol"),
                       "table: needs a contiguous float32 CUDA"),
    "wrong_width": (lambda t, i, j, s, k, c: (t[:, :12].contiguous(), i, j,
                                              s, k, c, 2, "pol"),
                    r"table: shape \(8, 12\), expected \(N, 17\)"),
    "short_j": (lambda t, i, j, s, k, c: (t, i, j[:-1], s, k, c, 2, "pol"),
                r"j: shape \(19,\), expected \(20,\)"),
    "short_scl": (lambda t, i, j, s, k, c: (t, i, j, s[:, 1:], k, c, 2,
                                            "pol"),
                  r"scl: shape \(3, 19\), expected \(3, 20\)"),
    "lmax_3": (lambda t, i, j, s, k, c: (t, i, j, s, k, c, 3, "pol"),
               "lmax=3"),
    "kind": (lambda t, i, j, s, k, c: (t, i, j, s, k, c, 2, "quad"),
             "kind='quad'"),
}


@pytest.mark.parametrize("case", sorted(INDEXED_CASES))
@pytest.mark.parametrize("launcher", ["fwd", "bwd"])
def test_indexed_pair_launcher_refuses_what_its_kernel_cannot_take(launcher,
                                                                   case):
    change, words = INDEXED_CASES[case]
    table, i, j, scl, scal, ct, lmax, kind = change(*_indexed_inputs())
    fn = getattr(P, f"launch_pair_{launcher}")
    before = fn.launches
    with pytest.raises(ValueError, match=words):
        if launcher == "fwd":
            P.launch_pair_fwd(table, i, j, scl, scal, lmax, kind)
        else:
            P.launch_pair_bwd(table, i, j, scl, scal, ct, lmax, kind)
    assert fn.launches == before
