"""K8, the local frames and the multipole rotation on one CUDA kernel pair
(``csrc/frames.cu``, ``ops/cuda/frames.py``), and its dispatch, on the CPU.

The dispatch: ``global_multipoles`` on CPU tensors, float32 and float64, is
the plain chain bit for bit, forward and gradient; K8's wrapper
(``kernel_global_multipoles``) raises on a CPU tensor; the plain chain
still records the spans ``frames`` and ``frames.bwd`` and launches nothing.
The double backward's recomputation (``frames_vjp_vjp_torch``) against a
central difference of the plain VJP in float64.

The kernel's per-site source compiled as host code with the host's C++
compiler behind a small shim for the CUDA keywords (atomics become plain
adds), its C entries emulated by loops over the sites and the thread blocks,
and put in place of the card's (``ops/cuda/entries._entries``), so the real
launchers and autograd Functions run on CPU tensors: the forward and the
gradients (positions, q_local, the box through its inverse) against the plain
chain in float64 within the card tests' bounds, on the random system of
tests/test_torch_kernels_cuda.py (every axis type, -1 anchors, a y anchor
wrapped to site n - 1, zero directions) at lmax 0, 1 and 2 and on a water
box; only the gradients asked for; lmax 0; the launch counters, one each
way; a force-matching loss's gradient through the double backward, and a
third derivative. Those skip where no C++ compiler is found.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from admp_tpu_torch.ops import frames as F
from admp_tpu_torch.ops.cuda import entries
from admp_tpu_torch.ops.cuda import frames as K8
from admp_tpu_torch.ops.harmonics import rot_local2global_components
from admp_tpu_torch.utils import profiling
from admp_tpu_torch.utils.linalg3 import inv3x3
from tests.test_torch_kernels_cuda import (
    FRAMES_CASES,
    _frames_force_matching,
    _frames_grads,
    _frames_route,
    _frames_system,
    _frames_water,
    _rel,
)

CPU = torch.device("cpu")
CSRC = pathlib.Path(K8.__file__).resolve().parents[2] / "csrc"

# the CUDA keywords and intrinsics frames.cu's per-site functions use, for
# one host thread
SHIM = r"""
#pragma once
#define __device__
#define __forceinline__ inline
inline float atomicAdd(float* p, float v) { float o = *p; *p += v; return o; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
"""

# the C entries of the card, as loops over the sites and the thread blocks
# (the box inverted once, as each of the card's threads inverts it)
HARNESS = r"""
#include "frames.cu"
extern "C" int admp_frames_block_size() { return kBlock; }
extern "C" int admp_frames_fwd(const float* pos, const float* box, const float* q,
                               const int64_t* types, const int64_t* anchors, float* out, int n,
                               int lmax, void*) {
  float binv[9];
  inv3(box, binv);
  for (int i = 0; i < n; ++i) {
    if (lmax == 0) frames_site_fwd<0>(i, n, pos, box, binv, q, types, anchors, out);
    else if (lmax == 1) frames_site_fwd<1>(i, n, pos, box, binv, q, types, anchors, out);
    else if (lmax == 2) frames_site_fwd<2>(i, n, pos, box, binv, q, types, anchors, out);
    else return -1;
  }
  return 0;
}
template <int L, bool B>
void bwd(const float* pos, const float* box, const float* binv, const float* q,
         const int64_t* types, const int64_t* anchors, const float* g, float* d_pos, float* dq,
         float* blocks, int n) {
  for (int b = 0; b * kBlock < n; ++b) {
    float s[kNBox] = {0};
    for (int i = b * kBlock; i < n && i < (b + 1) * kBlock; ++i) {
      float gb[kNBox] = {0};
      frames_site_bwd<L, B>(i, n, pos, box, binv, q, types, anchors, g, d_pos, dq, gb);
      for (int k = 0; k < kNBox; ++k) s[k] += gb[k];
    }
    if (B)
      for (int k = 0; k < kNBox; ++k) blocks[b * kNBox + k] = s[k];
  }
}
extern "C" int admp_frames_bwd(const float* pos, const float* box, const float* q,
                               const int64_t* types, const int64_t* anchors, const float* g,
                               float* d_pos, float* dq, float* blocks, int n, int lmax, void*) {
  if (lmax < 0 || lmax > 2) return -1;
  float binv[9];
  inv3(box, binv);
  if (d_pos)
    for (int k = 0; k < 3 * n; ++k) d_pos[k] = 0.f;
#define ARGS pos, box, binv, q, types, anchors, g, d_pos, dq, blocks, n
  if (blocks) {
    if (lmax == 0) bwd<0, true>(ARGS);
    else if (lmax == 1) bwd<1, true>(ARGS);
    else bwd<2, true>(ARGS);
  } else {
    if (lmax == 0) bwd<0, false>(ARGS);
    else if (lmax == 1) bwd<1, false>(ARGS);
    else bwd<2, false>(ARGS);
  }
  return 0;
#undef ARGS
}
extern "C" void frames_inv3(const float* m, float* r) { inv3(m, r); }
"""

NAMES = ("admp_frames_fwd", "admp_frames_bwd", "admp_frames_block_size")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this machine")
    d = tmp_path_factory.mktemp("frames_host")
    (d / "shim.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libframes_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-include",
                    str(d / "shim.h"), f"-I{CSRC}", str(d / "harness.cpp"),
                    "-o", str(lib)], check=True, capture_output=True)
    return ctypes.PyDLL(str(lib))


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The launchers and Functions of ops/cuda/frames.py on CPU tensors,
    over the host-compiled entries; global_multipoles routes float32 there,
    as it routes float32 CUDA tensors on the card."""
    for name in NAMES:
        fn = getattr(host_lib, name)
        fn.restype = ctypes.c_int
        monkeypatch.setitem(entries._entries, name, fn)
    monkeypatch.setattr(K8, "_raw_stream", lambda dev: 0)
    monkeypatch.setattr(K8, "_block_size", [])
    monkeypatch.setattr(K8, "_fits", lambda dev, n, lmax, tensors: (
        0 <= lmax <= 2 and all(
            t.dtype is dt and t.shape == shape and t.is_contiguous()
            for t, shape, dt in tensors)))
    monkeypatch.setattr(F, "use_kernel",
                        lambda method, x, what: x.dtype == torch.float32)


def _system(name, lmax):
    return (_frames_water(CPU) if name == "water"
            else _frames_system(CPU, lmax))


def _plain_chain(positions, box, q, types, anchors, lmax):
    return rot_local2global_components(
        q, F.local_frames_components(positions, box, types, anchors), lmax)


# ---------------------------------------------------------------------------
# The dispatch and the plain chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,lmax", FRAMES_CASES)
def test_auto_on_cpu_is_the_plain_chain_bitwise(name, lmax, dtype):
    pos, box, q, types, anchors = _system(name, lmax)
    x = pos.to(dtype).requires_grad_(True)
    before = K8.launch_frames_fwd.launches
    got = F.global_multipoles(x, box.to(dtype), q.to(dtype), types, anchors,
                              lmax)
    (g_got,) = torch.autograd.grad(got.square().sum(), x)
    assert K8.launch_frames_fwd.launches == before
    y = pos.to(dtype).requires_grad_(True)
    want = _plain_chain(y, box.to(dtype), q.to(dtype), types, anchors, lmax)
    (g_want,) = torch.autograd.grad(want.square().sum(), y)
    assert torch.equal(got, want)
    assert torch.equal(g_got, g_want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_refuses_cpu_tensors(dtype):
    """K8's wrapper names what it cannot take: a CPU tensor (in float64 as
    in float32), an lmax past 2; nothing is launched."""
    pos, box, q, types, anchors = _frames_water(CPU, dtype)
    before = K8.launch_frames_fwd.launches
    with pytest.raises(ValueError, match="positions: needs a contiguous"):
        K8.kernel_global_multipoles(pos, box, q, types, anchors, 2)
    with pytest.raises(ValueError, match="lmax=3"):
        K8.kernel_global_multipoles(pos, box, q, types, anchors, 3)
    assert K8.launch_frames_fwd.launches == before


def test_plain_chain_records_the_frames_spans():
    pos, box, q, types, anchors = _frames_water(CPU)
    x = pos.requires_grad_(True)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = F.global_multipoles(x, box, q, types, anchors, 2)
        torch.autograd.grad(out.square().sum(), x)
    snap = profiling.snapshot()
    profiling.reset()
    assert snap["spans"]["frames"]["count"] == 1
    assert snap["spans"]["frames.bwd"]["count"] == 1
    assert "frames.kernel" not in snap["counters"]
    assert profiling._OPEN == []


@pytest.mark.parametrize("lmax", [1, 2])
def test_double_backward_recompute_matches_a_central_difference(lmax):
    """frames_vjp_vjp_torch, the backward of K8's backward, against a
    central difference of the plain VJP (frames_vjp_torch) along a random
    direction of (g, positions, box, q_local), float64: 1e-6
    relative (at step 1e-6 the difference's truncation reads ~3e-8, and it
    falls as the step squared)."""
    pos, box, q, types, anchors = _frames_system(CPU, lmax, torch.float64)
    rng = np.random.default_rng(2)
    rand = lambda t: torch.tensor(rng.standard_normal(tuple(t.shape)),  # noqa
                                  dtype=torch.float64)
    g = rand(q)
    x = [g, pos, box, q]
    hs = [rand(t) for t in x[1:]]
    with torch.no_grad():
        got = K8.frames_vjp_vjp_torch(*x, types, anchors, lmax, *hs)
    dirs = [rand(t) for t in x]
    step = 1e-6

    def phi(s):
        xs = [t + s * d for t, d in zip(x, dirs)]
        firsts = K8.frames_vjp_torch(*xs, types, anchors, lmax)
        return sum(float((f * h).sum()) for f, h in zip(firsts, hs))

    want = (phi(step) - phi(-step)) / (2 * step)
    have = sum(float((a * d).sum()) for a, d in zip(got, dirs))
    assert abs(have - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# The kernel's source on the host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,lmax", FRAMES_CASES)
def test_host_kernel_matches_plain(on_host, name, lmax):
    """The launchers and FramesFn over the host-compiled body against the
    plain chain in float64, under the card test's bounds; one launch each
    way."""
    system = _system(name, lmax)
    f0, b0 = K8.launch_frames_fwd.launches, K8.launch_frames_bwd.launches
    kern = _frames_grads(system, "cuda", torch.float32)
    assert K8.launch_frames_fwd.launches - f0 == 1
    assert K8.launch_frames_bwd.launches - b0 == 1
    plain = _frames_grads(system, "torch", torch.float32)
    truth = _frames_grads(system, "torch", torch.float64)
    for what, k, p, t, floor in zip(("q_global", "positions", "box",
                                     "q_local"), kern, plain, truth,
                                    (1e-6, 1e-5, 1e-5, 1e-5)):
        assert bool(torch.isfinite(k).all()), what
        tol = max(floor, 2 * _rel(p, t))
        assert _rel(k, t) <= tol, (what, _rel(k, t), tol)


def test_host_kernel_backward_matches_the_plain_vjp(on_host):
    """K8's backward alone: the positions', the box's (its inverse's part
    folded in by the kernel) and q_local's gradients against the plain VJP
    in float64."""
    pos, box, q, types, anchors = _frames_system(CPU, 2)
    g = torch.tensor(np.random.default_rng(4).standard_normal(
        tuple(q.shape)), dtype=torch.float32)
    got = K8.launch_frames_bwd(pos, box, q, types, anchors, g, 2)
    want = K8.frames_vjp_torch(*(t.double() for t in (g, pos, box, q)),
                               types, anchors, 2)
    plain = K8.frames_vjp_torch(g, pos, box, q, types, anchors, 2)
    for what, k, p, t in zip(("positions", "box", "q_local"), got, plain,
                             want):
        tol = max(1e-5, 2 * _rel(p, t))
        assert _rel(k, t) <= tol, (what, _rel(k, t), tol)


def test_host_kernel_inverts_the_box_as_inv3x3(host_lib):
    """The box inverse each of K8's threads computes is inv3x3's in float32
    bit for bit (each product, sum and quotient rounded on its own), on the
    test systems' boxes and on random triclinic ones."""
    rng = np.random.default_rng(9)
    boxes = [_frames_system(CPU, 2)[1], _frames_water(CPU)[1]] + [
        torch.tensor(np.diag(rng.uniform(5, 60, 3))
                     + np.tril(rng.uniform(-3, 3, (3, 3)), -1),
                     dtype=torch.float32) for _ in range(20)]
    fn = host_lib.frames_inv3
    fn.restype = None
    for box in boxes:
        box = box.contiguous()
        got = torch.empty(3, 3)
        fn(ctypes.c_void_p(box.data_ptr()), ctypes.c_void_p(got.data_ptr()))
        assert torch.equal(got, inv3x3(box)), box


def test_host_kernel_at_lmax_0_copies_the_charges(on_host):
    """At lmax 0 (which the paths never send) the multipoles are the
    charges: the forward copies them, the backward passes g on and gives
    the positions and the box zero gradients."""
    pos, box, q, types, anchors = _frames_system(CPU, 0)
    assert torch.equal(K8.launch_frames_fwd(pos, box, q, types, anchors, 0),
                       q)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    d_pos, d_box, d_q = K8.launch_frames_bwd(pos, box, q, types, anchors, g,
                                             0)
    assert torch.equal(d_q, g)
    for d in (d_pos, d_box):
        assert not bool(d.any())


def test_host_kernel_returns_only_the_gradients_asked_for(on_host):
    pos, box, q, types, anchors = _frames_water(CPU)
    anchors = anchors.long()
    g = torch.ones_like(q)
    d_pos, d_box, d_q = K8.launch_frames_bwd(
        pos, box, q, types, anchors, g, 2, want_pos=False, want_box=False,
        want_q=True)
    assert d_pos is None and d_box is None
    assert d_q.shape == q.shape
    x = pos.clone().requires_grad_(True)
    out = K8.kernel_global_multipoles(x, box, q, types, anchors, 2)
    assert out.grad_fn is not None
    (dx,) = torch.autograd.grad(out.sum(), x)
    assert dx.shape == pos.shape
    ql = q.clone().requires_grad_(True)
    (dq,) = torch.autograd.grad(
        K8.kernel_global_multipoles(pos, box, ql, types, anchors, 2).sum(),
        ql)
    assert torch.equal(dq, d_q)


def test_host_kernel_counts_its_launches_under_a_profiler(on_host):
    pos, box, q, types, anchors = _frames_water(CPU)
    x = pos.requires_grad_(True)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = F.global_multipoles(x, box, q, types, anchors, 2)
        torch.autograd.grad(out.square().sum(), x)
    snap = profiling.snapshot()
    profiling.reset()
    assert snap["counters"]["frames.kernel"] == 2
    assert snap["spans"]["frames"]["count"] == 1
    assert snap["spans"]["frames.bwd"]["count"] == 1
    assert profiling._OPEN == []


@pytest.mark.parametrize("name,lmax", FRAMES_CASES)
def test_host_kernel_double_backward(on_host, name, lmax):
    """A force-matching loss's gradient through FramesFn and FramesBwdFn
    (whose backward recomputes the plain chain) against the plain chain in
    float64, under the card test's bound."""
    system = _system(name, lmax)
    kern = _frames_force_matching(system, "cuda", torch.float32)
    plain = _frames_force_matching(system, "torch", torch.float32)
    truth = _frames_force_matching(system, "torch", torch.float64)
    for what, k, p, t in zip(("q_local", "positions"), kern, plain, truth):
        tol = max(1e-5, 2 * _rel(p, t))
        assert _rel(k, t) <= tol, (what, _rel(k, t), tol)


def _third(system, method, dtype):
    """The derivative w.r.t. the positions of the force-matching loss's
    q_local gradient along a fixed direction: a third derivative of the
    multipoles' energy, through FramesBwdFn's backward asked for a graph."""
    pos, box, q, types, anchors = system
    lmax = int(round(q.shape[1] ** 0.5)) - 1
    x, ql = (t.detach().to(dtype).requires_grad_(True) for t in (pos, q))
    rng = np.random.default_rng(12)
    w, v = (torch.tensor(rng.standard_normal(tuple(q.shape)), dtype=dtype)
            for _ in range(2))
    qg = _frames_route(method)(x, box.to(dtype), ql, types, anchors, lmax)
    (g,) = torch.autograd.grad((w * qg + 0.5 * qg * qg).sum(), x,
                               create_graph=True)
    (gq,) = torch.autograd.grad((g * g).sum(), ql, create_graph=True)
    return torch.autograd.grad((gq * v).sum(), x)[0]


@pytest.mark.parametrize("name,lmax", FRAMES_CASES)
def test_host_kernel_third_derivative(on_host, name, lmax):
    """Differentiable to any order: a third derivative through K8 against
    the plain chain in float64, under the card test's bound."""
    system = _system(name, lmax)
    k = _third(system, "cuda", torch.float32)
    p = _third(system, "torch", torch.float32)
    t = _third(system, "torch", torch.float64)
    tol = max(1e-5, 2 * _rel(p, t))
    assert _rel(k, t) <= tol, (_rel(k, t), tol)
