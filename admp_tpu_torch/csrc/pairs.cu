// Fused real-space pair kernels of admp_tpu_torch, for sm_90a.
//
// K1 pair_fwd_kernel replaces admp_tpu/ops/pallas/pairs.py _make_fwd_kernel
// (:330); K2 pair_bwd_kernel replaces _make_bwd_kernel (:343), which takes
// jax.grad of the pair energy inside the kernel body (reverse mode). One
// thread per pair. K1 runs the per-pair energy of pair_energy.cuh in
// `float`. K2 runs its mixed-mode gradient (pair_energy_grad): one float
// forward, a hand reverse through the bilinear contractions and the
// transposed rotations, and forward mode only over the narrow inputs (the
// 3 components of the displacement through the frame and the rotations;
// the coefficient functions' 3 or 7 scalar inputs), from the same templated
// source as the energy. Its first version ran the whole forward in
// Dual<4> over all ~15-34 inputs of a pair, 9 passes for 'pol' lmax 2: ~45x
// K1's work. The minimum-image wrap is chain-ruled by hand: floor() has zero
// derivative, so the position gradient is (binv . box)-mapped dE/dd and the
// box / box-inverse gradients follow from the fractional coordinates.
//
// Bound on the card: arithmetic, registers and latency, not bytes. A pair
// reads 2F+3 floats and writes one (forward) or 2F+n_scl (backward). K2
// keeps its intermediates in registers (168-250 unbounded at lmax 2), so
// its launch bounds trade a few hundred bytes of L1-resident spills for
// more blocks per SM (bwd_min_blocks), and it stages its two output rows
// per pair in shared memory, so that a block stores them coalesced. The
// scalar gradients are reduced per block in a fixed order (warp shuffles,
// then shared memory) into an (n_blocks, 19) buffer that the wrapper sums:
// deterministic, no atomics.
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

// K2's blocks per SM for the register allocator: 'pol' lmax 2 takes 250
// registers unbounded, 2 blocks per SM, and 50,176 pairs then need two
// waves; at 3 blocks (168 registers, ~200 bytes of spills) they fit one,
// 0.0153 ms of device time against 0.0227 (4 blocks: 0.0189). 'perm' lmax 2
// (168 registers unbounded) runs best at 4 (128 registers, ~150 bytes of
// spills): 0.199 against 0.224 ms at 98k. H100, chip_smoke.py --kernels
// (PERF.md, Findings).
__host__ __device__ constexpr int bwd_min_blocks(int kind, int lmax) {
  return kind == kPerm && lmax == 2 ? 4 : 3;
}

// K2: one thread per pair; each thread's two output rows are staged in
// shared memory and the block stores them as two contiguous runs (store_rows)
template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock, bwd_min_blocks(KIND, LMAX))
pair_bwd_kernel(const float* __restrict__ gi, const float* __restrict__ gj,
                const float* __restrict__ scl, const float* __restrict__ scal,
                const float* __restrict__ ct, float* __restrict__ dgi,
                float* __restrict__ dgj, float* __restrict__ dscl,
                float* __restrict__ dscal_blocks, int C) {
  constexpr int F = Layout<KIND, LMAX>::F;
  __shared__ float s_out[2][kBlock * F];
  const int p0 = blockIdx.x * kBlock;
  const int p = p0 + threadIdx.x;
  float sg[kNScal];
#pragma unroll
  for (int k = 0; k < kNScal; ++k) sg[k] = 0.f;
  if (p < C) {
    const size_t row = static_cast<size_t>(p) * F;
    pair_grad_mixed<KIND, LMAX, float>(p, C, gi + row, gj + row, scl, scal, ct, nullptr,
                                       nullptr, nullptr, nullptr, s_out[0] + threadIdx.x * F,
                                       s_out[1] + threadIdx.x * F, dscl, nullptr, sg);
  }
  __syncthreads();
  store_rows<F>(s_out, p0, C, dgi, dgj);
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
