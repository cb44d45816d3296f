"""The pair kernels' device source on the host: ``csrc/pair_energy.cuh``,
compiled with the host's C++ compiler behind a small shim for the CUDA
keywords, with a loop over the pairs in place of the grid.

K2's mixed-mode gradient body (``pair_grad_mixed`` at S = float) is held
against autograd of the plain version ``pair_energies_torch`` in float32,
every output within 1e-5 relative RMSE (the card's gate), for all seven
(kind, lmax) on the cuda tests' tables and on the tables crafted onto each
branch of the pair energy. Its S = Dual1 instantiation, K3's body (the
derivatives of its outputs along a direction), is held against the plain
HVP in float64 within max(1e-4, 2 x the plain float32 HVP's error), K3's own
gate, on both sets of tables. Its S = Hyper instantiation
(``pair_grad_parts``), K3b's body (the VJP of K3), is held against the
plain third derivative ``pair_third_torch`` in float64 under the same gate,
on both sets of tables, with both directions also kept off the Thole
columns of the sites of pol 1e-9 (the third derivative of the damping width
(pol_i pol_j)^(1/6) there is beyond float32's range in any implementation,
and the plain float32 version's own error is taken over its finite
entries). Skips where no C++ compiler is found.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from admp_tpu_torch.ops.cuda import pairs as P
from tests.test_torch_kernels_cuda import _branch_tables, _rel, _tables

CSRC = pathlib.Path(P.__file__).resolve().parents[2] / "csrc"
KINDS = [("perm", 0), ("perm", 1), ("perm", 2), ("pol", 0), ("pol", 1),
         ("pol", 2), ("uu", 1)]

# the CUDA keywords and intrinsics pair_energy.cuh uses, for one host thread
SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct HostDim3 { unsigned x, y, z; };
static HostDim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
typedef void* cudaStream_t;
inline float __shfl_down_sync(unsigned, float, int) { return 0.f; }
inline void __syncthreads() {}
using std::floor;
"""

# every pair in turn; the scalar gradients summed over all pairs
HARNESS = r"""
#include "pair_energy.cuh"
template <int KIND, int LMAX, class S>
void grad(const float* gi, const float* gj, const float* scl, const float* scal,
          const float* ct, const float* cgi, const float* cgj, const float* cscl,
          const float* cscal, float* dgi, float* dgj, float* dscl, float* dct,
          float* dscal, int C) {
  constexpr int F = Layout<KIND, LMAX>::F;
  for (int k = 0; k < kNScal; ++k) dscal[k] = 0.f;
  for (int p = 0; p < C; ++p) {
    float sg[kNScal] = {0};
    const size_t r = static_cast<size_t>(p) * F;
    pair_grad_mixed<KIND, LMAX, S>(p, C, gi + r, gj + r, scl, scal, ct,
                                   cgi ? cgi + r : nullptr, cgj ? cgj + r : nullptr,
                                   cscl, cscal, dgi + r, dgj + r, dscl, dct, sg);
    for (int k = 0; k < kNScal; ++k) dscal[k] += sg[k];
  }
}
template <class S>
int grad_any(int kind, int lmax, const float* gi, const float* gj, const float* scl,
             const float* scal, const float* ct, const float* cgi, const float* cgj,
             const float* cscl, const float* cscal, float* dgi, float* dgj, float* dscl,
             float* dct, float* dscal, int C) {
#define ARGS gi, gj, scl, scal, ct, cgi, cgj, cscl, cscal, dgi, dgj, dscl, dct, dscal, C
  if (kind == kUU) { grad<kUU, 0, S>(ARGS); return 0; }
  switch (kind * 3 + lmax) {
    case 0: grad<kPerm, 0, S>(ARGS); return 0;
    case 1: grad<kPerm, 1, S>(ARGS); return 0;
    case 2: grad<kPerm, 2, S>(ARGS); return 0;
    case 3: grad<kPol, 0, S>(ARGS); return 0;
    case 4: grad<kPol, 1, S>(ARGS); return 0;
    case 5: grad<kPol, 2, S>(ARGS); return 0;
  }
  return -1;
#undef ARGS
}
// K3b's body: both output parts, the scalar sums of part J at dscal[19 J]
template <int KIND, int LMAX>
void third(const float* gi, const float* gj, const float* scl, const float* scal,
           const float* ct, const float* cgi, const float* cgj, const float* cscl,
           const float* cscal, const float* hgi, const float* hgj, const float* hscl,
           const float* hscal, const float* hct, float* dgi, float* dgj, float* dscl,
           float* dct, float* dcgi, float* dcgj, float* dcscl, float* dscal, int C) {
  constexpr int F = Layout<KIND, LMAX>::F;
  for (int k = 0; k < 2 * kNScal; ++k) dscal[k] = 0.f;
  for (int p = 0; p < C; ++p) {
    float sg[2][kNScal] = {{0}};
    const size_t r = static_cast<size_t>(p) * F;
    float* const oi[2] = {dgi + r, dcgi + r};
    float* const oj[2] = {dgj + r, dcgj + r};
    float* const os[2] = {dscl, dcscl};
    pair_grad_parts<KIND, LMAX, Hyper>(p, C, gi + r, gj + r, scl, scal, ct, cgi + r, cgj + r,
                                       cscl, cscal, hgi + r, hgj + r, hscl, hscal, hct, oi,
                                       oj, os, dct, sg);
    for (int k = 0; k < kNScal; ++k) {
      dscal[k] += sg[0][k];
      dscal[kNScal + k] += sg[1][k];
    }
  }
}
extern "C" int host_pair_third(int kind, int lmax, const float* gi, const float* gj,
                               const float* scl, const float* scal, const float* ct,
                               const float* cgi, const float* cgj, const float* cscl,
                               const float* cscal, const float* hgi, const float* hgj,
                               const float* hscl, const float* hscal, const float* hct,
                               float* dgi, float* dgj, float* dscl, float* dct, float* dcgi,
                               float* dcgj, float* dcscl, float* dscal, int C) {
#define ARGS gi, gj, scl, scal, ct, cgi, cgj, cscl, cscal, hgi, hgj, hscl, hscal, hct, dgi, \
             dgj, dscl, dct, dcgi, dcgj, dcscl, dscal, C
  if (kind == kUU) { third<kUU, 0>(ARGS); return 0; }
  switch (kind * 3 + lmax) {
    case 0: third<kPerm, 0>(ARGS); return 0;
    case 1: third<kPerm, 1>(ARGS); return 0;
    case 2: third<kPerm, 2>(ARGS); return 0;
    case 3: third<kPol, 0>(ARGS); return 0;
    case 4: third<kPol, 1>(ARGS); return 0;
    case 5: third<kPol, 2>(ARGS); return 0;
  }
  return -1;
#undef ARGS
}
extern "C" int host_pair_grad(int dual, int kind, int lmax, const float* gi,
                              const float* gj, const float* scl, const float* scal,
                              const float* ct, const float* cgi, const float* cgj,
                              const float* cscl, const float* cscal, float* dgi,
                              float* dgj, float* dscl, float* dct, float* dscal, int C) {
  return dual ? grad_any<Dual1>(kind, lmax, gi, gj, scl, scal, ct, cgi, cgj, cscl, cscal,
                                dgi, dgj, dscl, dct, dscal, C)
              : grad_any<float>(kind, lmax, gi, gj, scl, scal, ct, cgi, cgj, cscl, cscal,
                                dgi, dgj, dscl, dct, dscal, C);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this machine")
    d = tmp_path_factory.mktemp("pair_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "harness.cc").write_text(HARNESS)
    so = d / "libpairhost.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", f"-I{d}",
                    f"-I{CSRC}", "-o", str(so), str(d / "harness.cc")],
                   check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(str(so))


def _host_grad(lib, tables, lmax, kind, directions=None):
    """(d_gi, d_gj, d_scl, d_scal[, d_ct]) of the host body: its gradient
    (S = float), or with ``directions`` its derivative along them."""
    g_i, g_j, scl, scal, ct = tables
    out = [torch.empty_like(g_i), torch.empty_like(g_j), torch.empty_like(scl),
           torch.empty_like(ct), torch.empty(P.N_SCAL)]
    cs = directions if directions is not None else [None] * 4
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    status = lib.host_pair_grad(
        int(directions is not None), P.KINDS[kind], lmax,
        *map(ptr, (g_i, g_j, scl, scal, ct, *cs, *out)), g_i.shape[0])
    assert status == 0
    d_gi, d_gj, d_scl, d_ct, d_scal = out
    return (d_gi, d_gj, d_scl, d_scal) + ((d_ct,) if directions is not None
                                          else ())


def _tables_of(which, kind, lmax):
    make = _branch_tables if which == "branches" else _tables
    return make(torch.device("cpu"), kind, lmax)


@pytest.mark.parametrize("which", ["plain", "branches"])
@pytest.mark.parametrize("kind,lmax", KINDS)
def test_pair_backward_body_matches_autograd(host_lib, kind, lmax, which):
    tables = _tables_of(which, kind, lmax)
    g_i, g_j, scl, scal, ct = tables
    out_k = _host_grad(host_lib, tables, lmax, kind)
    leaves = [t.clone().requires_grad_(True) for t in (g_i, g_j, scl, scal)]
    out_p = torch.autograd.grad(
        (P.pair_energies_torch(*leaves, lmax, kind) * ct).sum(), leaves)
    for name, a, b in zip(("g_i", "g_j", "scl", "scal"), out_k, out_p):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))
    masked = scl[1] <= 0.5
    assert bool((out_k[2][1] == 0).all())  # the mask row
    assert bool((out_k[0][masked] == 0).all() and (out_k[1][masked] == 0).all())


def _hold_dual_body(lib, kind, lmax, which):
    """The S = Dual1 body (K3's) on the ``which`` tables against the plain
    HVP in float64, within K3's gate."""
    tables = _tables_of(which, kind, lmax)
    cs = P.hvp_directions(tables[:4], kind, seed=5)
    out_k = _host_grad(lib, tables, lmax, kind, cs)
    out_64 = P.pair_hvp_torch(*(t.double() for t in (*tables, *cs)), lmax, kind)
    out_32 = P.pair_hvp_torch(*tables, *cs, lmax, kind)
    for name, a, b, c in zip(("g_i", "g_j", "scl", "scal", "ct"), out_k, out_32,
                             out_64):
        assert bool(torch.isfinite(a).all()), name
        tol = max(1e-4, 2 * _rel(b, c))
        assert _rel(a, c) <= tol, (name, _rel(a, c), tol)


@pytest.mark.parametrize("kind,lmax", KINDS)
def test_pair_backward_body_in_dual_arithmetic_gives_the_hvp(host_lib, kind,
                                                              lmax):
    _hold_dual_body(host_lib, kind, lmax, "branches")


@pytest.mark.parametrize("kind,lmax", KINDS)
def test_pair_hvp_body_on_the_plain_tables(host_lib, kind, lmax):
    _hold_dual_body(host_lib, kind, lmax, "plain")


def _third_directions(tables, kind, seed):
    """K3b's two directions: P.hvp_directions for K3's (c) and for its
    cotangents (h, with a standard-normal h_ct), each also zero on the Thole
    columns of the sites of pol below 1e-6."""
    x = tables[:4]
    cs = P.hvp_directions(x, kind, seed=seed)
    hs = P.hvp_directions(x, kind, seed=seed + 1)
    hs.append(torch.tensor(np.random.default_rng(seed + 2).standard_normal(
        x[0].shape[0]), dtype=torch.float32))
    if kind != "perm":
        for d in (cs, hs):
            for g, c in zip(x[:2], d[:2]):
                c[g[:, -2] < 1e-6, -2:] = 0.0
    return cs, hs


def _host_third(lib, tables, cs, hs, lmax, kind):
    """The cotangents of K3's nine inputs from the host K3b body."""
    g_i, g_j, scl, scal, ct = tables
    out = [torch.empty_like(g_i), torch.empty_like(g_j), torch.empty_like(scl),
           torch.empty_like(ct), torch.empty_like(g_i), torch.empty_like(g_j),
           torch.empty_like(scl), torch.empty(2 * P.N_SCAL)]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    status = lib.host_pair_third(P.KINDS[kind], lmax,
                                 *map(ptr, (g_i, g_j, scl, scal, ct, *cs, *hs,
                                            *out)), g_i.shape[0])
    assert status == 0
    d_gi, d_gj, d_scl, d_ct, d_cgi, d_cgj, d_cscl, d_scal = out
    return (d_gi, d_gj, d_scl, d_scal[:P.N_SCAL], d_ct, d_cgi, d_cgj, d_cscl,
            d_scal[P.N_SCAL:])


@pytest.mark.parametrize("which", ["plain", "branches"])
@pytest.mark.parametrize("kind,lmax", KINDS)
def test_pair_third_body_in_hyper_dual_arithmetic(host_lib, kind, lmax, which):
    tables = _tables_of(which, kind, lmax)
    cs, hs = _third_directions(tables, kind, seed=5)
    out_k = _host_third(host_lib, tables, cs, hs, lmax, kind)
    f64 = lambda ts: [t.double() for t in ts]  # noqa: E731
    out_64 = P.pair_third_torch(*f64(tables), *f64(cs), *f64(hs), lmax, kind)
    out_32 = P.pair_third_torch(*tables, *cs, *hs, lmax, kind)
    names = ("g_i", "g_j", "scl", "scal", "ct", "c_gi", "c_gj", "c_scl",
             "c_scal")
    for name, a, b, c in zip(names, out_k, out_32, out_64):
        assert bool(torch.isfinite(a).all()), name
        ok = torch.isfinite(b)
        tol = max(1e-4, 2 * _rel(b[ok], c[ok]))
        assert _rel(a, c) <= tol, (name, _rel(a, c), tol)
    masked = tables[2][1] <= 0.5
    for k in (0, 1, 5, 6):  # a masked pair's rows
        assert bool((out_k[k][masked] == 0).all())
