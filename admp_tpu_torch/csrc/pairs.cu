// Fused real-space pair kernels of admp_tpu_torch, for sm_90a.
//
// K1 pair_fwd_kernel replaces admp_tpu/ops/pallas/pairs.py _make_fwd_kernel
// (:330); K2 pair_bwd_kernel replaces _make_bwd_kernel (:343). One thread per
// pair. Both run the per-pair energy of pair_energy.cuh: `float` in the
// forward, Dual<kTangents> (forward-mode dual numbers) in the backward,
// which re-runs it in ceil(NV / kTangents) passes over the pair's NV
// independent inputs. The minimum-image wrap is chain-ruled by hand: floor()
// has zero derivative, so the position gradient is (binv . box)-mapped dE/dd
// and the box / box-inverse gradients follow from the fractional coordinates.
//
// Bound on the card: arithmetic and registers, not bytes. A pair reads
// 2F+3 floats and writes one (forward) or 2F+n_scl (backward); the dual
// passes multiply the forward arithmetic by ~(kTangents+1) * passes and spill
// the dual arrays to local memory (L1-resident). The scalar gradients are
// reduced per block in a fixed order (warp shuffles, then shared memory) into
// an (n_blocks, 19) buffer that the wrapper sums: deterministic, no atomics.
//
// C interface (loaded with ctypes; each entry returns cudaGetLastError(), or
// -1 for an unsupported (kind, lmax)):
//   admp_pair_fwd(gi, gj, scl, scal, e, C, kind, lmax, stream)
//   admp_pair_bwd(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks,
//                 C, kind, lmax, stream)
//   admp_pair_block_size()
// kind: 0 'perm', 1 'pol', 2 'uu'. Row layouts are documented in
// admp_tpu_torch/ops/cuda/pairs.py.

#include "pair_energy.cuh"

namespace {

constexpr int kTangents = 4;

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ g, int p, float* out) {
#pragma unroll
  for (int k = 0; k < F; ++k) out[k] = g[static_cast<size_t>(p) * F + k];
}

template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock)
pair_fwd_kernel(const float* __restrict__ gi, const float* __restrict__ gj,
                const float* __restrict__ scl, const float* __restrict__ scal,
                float* __restrict__ e, int C) {
  using L = Layout<KIND, LMAX>;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= C) return;
  if (!(scl[C + p] > 0.5f)) {
    e[p] = 0.f;
    return;
  }
  float a[L::F], b[L::F];
  load_row<L::F>(gi, p, a);
  load_row<L::F>(gj, p, b);
  const Wrapped<float> w = wrap(a, b, scal + 1, scal + 10);
  const bool degenerate = (a[1] == b[1]) && (a[2] == b[2]);
  float s[L::NS];
  s[0] = scl[p];
  if constexpr (L::NS > 1) s[1] = scl[2 * C + p];
  e[p] = pair_energy<float, KIND, LMAX>(w.d[0], w.d[1], w.d[2], degenerate, a + 3, b + 3, s,
                                        scal[0]);
}

template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock)
pair_bwd_kernel(const float* __restrict__ gi, const float* __restrict__ gj,
                const float* __restrict__ scl, const float* __restrict__ scal,
                const float* __restrict__ ct, float* __restrict__ dgi,
                float* __restrict__ dgj, float* __restrict__ dscl,
                float* __restrict__ dscal_blocks, int C) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float sg[kNScal];
#pragma unroll
  for (int k = 0; k < kNScal; ++k) sg[k] = 0.f;
  if (p < C)
    pair_grad<KIND, LMAX, float, kTangents>(p, C, gi, gj, scl, scal, ct, nullptr, nullptr,
                                            nullptr, nullptr, dgi, dgj, dscl, nullptr, sg);
  reduce_scalars(sg, dscal_blocks);
}

template <int KIND, int LMAX>
int launch_fwd(const float* gi, const float* gj, const float* scl, const float* scal, float* e,
               int C, cudaStream_t stream) {
  const int grid = (C + kBlock - 1) / kBlock;
  pair_fwd_kernel<KIND, LMAX><<<grid, kBlock, 0, stream>>>(gi, gj, scl, scal, e, C);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int LMAX>
int launch_bwd(const float* gi, const float* gj, const float* scl, const float* scal,
               const float* ct, float* dgi, float* dgj, float* dscl, float* dscal_blocks, int C,
               cudaStream_t stream) {
  const int grid = (C + kBlock - 1) / kBlock;
  pair_bwd_kernel<KIND, LMAX><<<grid, kBlock, 0, stream>>>(gi, gj, scl, scal, ct, dgi, dgj,
                                                          dscl, dscal_blocks, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admp_pair_block_size() { return kBlock; }

extern "C" int admp_pair_fwd(const float* gi, const float* gj, const float* scl,
                             const float* scal, float* e, int C, int kind, int lmax,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lmax < 0 || lmax > 2) return -1;
  if (kind == kUU) return launch_fwd<kUU, 0>(gi, gj, scl, scal, e, C, s);
  switch (kind * 3 + lmax) {
    case 0: return launch_fwd<kPerm, 0>(gi, gj, scl, scal, e, C, s);
    case 1: return launch_fwd<kPerm, 1>(gi, gj, scl, scal, e, C, s);
    case 2: return launch_fwd<kPerm, 2>(gi, gj, scl, scal, e, C, s);
    case 3: return launch_fwd<kPol, 0>(gi, gj, scl, scal, e, C, s);
    case 4: return launch_fwd<kPol, 1>(gi, gj, scl, scal, e, C, s);
    case 5: return launch_fwd<kPol, 2>(gi, gj, scl, scal, e, C, s);
    default: return -1;
  }
}

extern "C" int admp_pair_bwd(const float* gi, const float* gj, const float* scl,
                             const float* scal, const float* ct, float* dgi, float* dgj,
                             float* dscl, float* dscal_blocks, int C, int kind, int lmax,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lmax < 0 || lmax > 2) return -1;
  if (kind == kUU)
    return launch_bwd<kUU, 0>(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks, C, s);
  switch (kind * 3 + lmax) {
    case 0: return launch_bwd<kPerm, 0>(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks, C, s);
    case 1: return launch_bwd<kPerm, 1>(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks, C, s);
    case 2: return launch_bwd<kPerm, 2>(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks, C, s);
    case 3: return launch_bwd<kPol, 0>(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks, C, s);
    case 4: return launch_bwd<kPol, 1>(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks, C, s);
    case 5: return launch_bwd<kPol, 2>(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks, C, s);
    default: return -1;
  }
}
