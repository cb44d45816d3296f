"""The pair launchers' one-pass validation (admp_tpu_torch/ops/cuda/pairs.py).

Each launcher (K1 ``launch_pair_fwd``, K2 ``launch_pair_bwd``, K3
``launch_pair_hvp``, K3b ``launch_pair_third``) raises ValueError before it builds or launches
anything on tables its kernel cannot take: a kind or lmax it has no template
for, a wrong shape, a CPU tensor, float64 or a non-contiguous table. The
error names the first failure, in the order kind, lmax, then each table in
turn (g_i first), its shape and then its type, so each case shows here on
the CPU; the kernels themselves are held on the card
(tests/test_torch_kernels_cuda.py).
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
    if launcher == "fwd":
        return P.launch_pair_fwd(g_i, g_j, scl, scal, lmax, kind)
    if launcher == "bwd":
        return P.launch_pair_bwd(g_i, g_j, scl, scal, ct, lmax, kind)
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
    # words the error carries)
    "cpu": (lambda g, h, s, k, c: (g, h, s, k, c, 2, "pol"),
            "contiguous float32 CUDA"),
    "float64": (lambda g, h, s, k, c: (g.double(), h, s, k, c, 2, "pol"),
                "contiguous float32 CUDA"),
    "non_contiguous": (lambda g, h, s, k, c: (_strided(g), h, s, k, c, 2,
                                              "pol"),
                       "contiguous float32 CUDA"),
    "wrong_width": (lambda g, h, s, k, c: (g[:, :12].contiguous(), h, s, k,
                                           c, 2, "pol"), "g_i: shape"),
    "lmax_3": (lambda g, h, s, k, c: (g, h, s, k, c, 3, "pol"), "lmax=3"),
    "kind": (lambda g, h, s, k, c: (g, h, s, k, c, 2, "quad"), "kind='quad'"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("launcher", ["fwd", "bwd", "hvp", "third"])
def test_pair_launcher_refuses_what_its_kernel_cannot_take(launcher, case):
    change, words = CASES[case]
    fn = getattr(P, f"launch_pair_{launcher}")
    before = fn.launches
    with pytest.raises(ValueError, match=words):
        _launch(launcher, *change(*_inputs()))
    assert fn.launches == before
