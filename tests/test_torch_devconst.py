"""The force call's constants kept on the device (admp_tpu_torch/utils/
devconst.py): each equals, bit for bit, the tensor its site built on the
host at every call before (the grid sizes, the stencil's term index, the
Hermitian weights, the tile sizes, kappa, the self energy's factors, the
DFT matrices); one key gives one tensor, and the dtype or the values
another; no constant is written over a step's forward and backward; a
constant first built under inference mode can still be saved for a
backward; a tensor kappa keeps its gradient."""

import numpy as np
import pytest
import torch

from admp_tpu_torch.models import pme
from admp_tpu_torch.ops import reciprocal as R
from admp_tpu_torch.ops import selfenergy
from admp_tpu_torch.ops.cuda import spread as S
from admp_tpu_torch.utils import devconst
from admp_tpu_torch.utils.devconst import device_values as values
from test_torch_tracing import _Water

DTYPES = [torch.float32, torch.float64]
CPU = torch.device("cpu")


def _same(a, b):
    return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


def _old_hermitian(k3, dtype, device):
    k3h = k3 // 2 + 1
    w = torch.full((k3h,), 2.0, dtype=dtype, device=device)
    w[0] = 1.0
    if k3 % 2 == 0:
        w[k3h - 1] = 1.0
    return w


def _old_self_factor(kappa, lmax, dtype, device):
    n_harm = (lmax + 1) ** 2
    l_list = np.array([0] + [1] * 3 + [2] * 5)[:n_harm]
    l_fac2 = np.array([1] + [3] * 3 + [15] * 5)[:n_harm]
    factor = kappa / np.sqrt(np.pi) * (2.0 * kappa**2) ** l_list / l_fac2
    return torch.as_tensor(factor, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_each_constant_is_the_old_construction(dtype):
    for grid in ((30, 32, 36), (25, 27, 35), (320, 320, 320)):
        assert _same(values(grid, dtype, CPU),
                     torch.as_tensor(grid, dtype=dtype, device=CPU))
        assert _same(values(grid, torch.int64, CPU),
                     torch.tensor(grid, device=CPU))
        assert _same(R._hermitian_weights(grid[2], dtype, CPU),
                     _old_hermitian(grid[2], dtype, CPU))
    assert _same(values(S.TILE, torch.int64, CPU),
                 torch.tensor(S.TILE, device=CPU))
    tab = torch.randn(7, 3, 6, 3, dtype=dtype)
    for n_terms in (1, 4, 10):
        index = R._term_index(n_terms, CPU)
        for c in range(3):
            old = [t[c] for t in R._SEP_TERMS[:n_terms]]
            assert _same(index[c], torch.tensor(old))
            assert _same(tab[:, index[c], :, c], tab[:, old, :, c])
    box = torch.tensor([[21.3, 0.4, 0.0], [0.0, 20.9, 0.3], [0.2, 0.0, 22.1]],
                       dtype=dtype)
    for kappa in (0.7296, 0.657065221219616, np.float64(0.31)):
        old = torch.as_tensor(kappa, dtype=dtype).reshape(1)
        assert _same(pme._pair_scalars(kappa, box)[:1], old)
        for lmax in (0, 1, 2):
            assert _same(selfenergy._self_factor(kappa, (lmax + 1) ** 2,
                                                 dtype, CPU),
                         _old_self_factor(kappa, lmax, dtype, CPU))
    like = torch.zeros(2, dtype=dtype)
    for k, n_out in ((8, 5), (9, 9)):
        m, c = np.arange(n_out)[:, None], np.arange(k)[None, :]
        ang = 2.0 * np.pi * (m * c % k) / k
        cos, sin = R._dft_mats(k, n_out, like)
        assert _same(cos, like.new_tensor(np.cos(ang)))
        assert _same(sin, like.new_tensor(np.sin(ang)))


def test_one_key_gives_one_tensor():
    a = values((30, 32, 36), torch.float32, CPU)
    assert values([30, 32, 36], torch.float32, CPU) is a
    assert values((30, 32, 36), torch.float32, "cpu") is a
    b = values((30, 32, 36), torch.float64, CPU)
    c = values((30, 32, 40), torch.float32, CPU)
    assert b is not a and b.dtype == torch.float64
    assert c is not a and not torch.equal(c, a)
    w = R._hermitian_weights(36, torch.float32, CPU)
    assert R._hermitian_weights(36, torch.float32, CPU) is w
    assert R._hermitian_weights(36, torch.float64, CPU) is not w
    assert R._hermitian_weights(35, torch.float32, CPU) is not w
    assert R._term_index(10, CPU) is R._term_index(10, CPU)
    assert R._term_index(4, CPU) is not R._term_index(10, CPU)
    f = selfenergy._self_factor(0.7, 9, torch.float32, CPU)
    assert selfenergy._self_factor(0.7, 9, torch.float32, CPU) is f
    assert selfenergy._self_factor(0.71, 9, torch.float32, CPU) is not f
    assert selfenergy._self_factor(0.7, 4, torch.float32, CPU) is not f


@pytest.mark.parametrize("lpol", [False, True], ids=["fixed", "pol"])
def test_no_constant_is_written_by_a_step(lpol):
    w = _Water(lpol)
    w.force_fn(w.positions, None)
    store = dict(devconst._STORE)
    assert store
    versions = {k: t._version for k, t in store.items()}
    e, f, _ = w.force_fn(w.positions, None)
    assert torch.isfinite(f).all()
    for k, t in store.items():
        assert devconst._STORE[k] is t
        assert t._version == versions[k], k
        assert not t.requires_grad, k


def test_a_constant_built_in_inference_mode_is_saved_for_backward():
    key = ("test.inference_mode", 1.25)
    with torch.inference_mode():
        c = devconst.device_constant(key, lambda: [1.25, 2.5],
                                     torch.float64, CPU)
    assert not c.is_inference()
    x = torch.ones(2, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad((x * c).sum(), x)
    assert torch.equal(g, c)


def test_a_tensor_kappa_keeps_its_gradient():
    box = torch.eye(3, dtype=torch.float64) * 20.0
    kappa = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    scal = pme._pair_scalars(kappa, box)
    (g,) = torch.autograd.grad(scal[0], kappa)
    assert float(g) == 1.0
