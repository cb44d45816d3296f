// The pair kernel's Hessian-vector kernel (K3) of admp_tpu_torch, for sm_90a.
//
// Replaces admp_tpu/ops/pallas/pairs.py _make_hvp_kernel (:445, launched by
// _pair_bwd_op_bwd :569): the VJP of the backward K2, B(x, ct) = ct J_e(x),
// at cotangents c = (cgi, cgj, cscl, cscal) of its outputs. Per pair it
// returns d_x = ct H_e(x) c for both rows and the scale rows, d_ct = J_e(x) c,
// and the per-block sums of d_x for the 19 scalars (kappa, box, box inverse).
//
// Design: K2's own body in one-tangent duals, as the TPU kernel takes
// jax.jvp of its gradient inside the body. pair_grad_mixed (pair_energy.cuh),
// K2's mixed-mode gradient, runs at S = Dual1: every input of the pair
// carries its entry of c as a tangent (raw = a - b gets cgi - cgj, box and
// box inverse get cscal), so each gradient entry comes out with its
// derivative along c, the HVP entry, and the energy with J c. The hand chain
// rule of the wrap runs in Dual1 too, which keeps the position x box,
// position x box-inverse and box x box-inverse terms of the virial. The first
// version ran the energy in Dual<2, Dual1> over every input of the pair: 17
// passes of the whole forward for 'pol' lmax 2.
//
// Bound on the card: arithmetic, registers and latency, not bytes (a pair
// reads 4F + 2 n_scl + 2 floats and writes 2F + n_scl + 1). Dual1 doubles
// every value of K2's body, so the body spills past the 255-register cap;
// hvp_min_blocks sets the blocks per SM the register allocator plans for. As
// K2, each thread stages its two output rows in shared memory and the block
// stores them coalesced (store_rows); the scalar gradients are reduced per
// block in a fixed order (reduce_scalars), deterministic, no atomics.
//
// C interface (loaded with ctypes; returns cudaGetLastError(), or -1 for an
// unsupported (kind, lmax)):
//   admp_pair_hvp(gi, gj, scl, scal, ct, cgi, cgj, cscl, cscal,
//                 dgi, dgj, dscl, dct, dscal_blocks, C, kind, lmax, stream)
//   admp_pair_hvp_block_size()
// kind: 0 'perm', 1 'pol', 2 'uu'; the layouts are K2's.

#include "pair_energy.cuh"

namespace {

// K3's blocks per SM for the register allocator (launch bounds)
__host__ __device__ constexpr int hvp_min_blocks(int kind, int lmax) {
  return kind == kPerm ? 2 : 3;
}

template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock, hvp_min_blocks(KIND, LMAX))
pair_hvp_kernel(const float* __restrict__ gi, const float* __restrict__ gj,
                const float* __restrict__ scl, const float* __restrict__ scal,
                const float* __restrict__ ct, const float* __restrict__ cgi,
                const float* __restrict__ cgj, const float* __restrict__ cscl,
                const float* __restrict__ cscal, float* __restrict__ dgi,
                float* __restrict__ dgj, float* __restrict__ dscl, float* __restrict__ dct,
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
    pair_grad_mixed<KIND, LMAX, Dual1>(p, C, gi + row, gj + row, scl, scal, ct, cgi + row,
                                       cgj + row, cscl, cscal, s_out[0] + threadIdx.x * F,
                                       s_out[1] + threadIdx.x * F, dscl, dct, sg);
  }
  __syncthreads();
  store_rows<F>(s_out, p0, C, dgi, dgj);
  reduce_scalars(sg, dscal_blocks);
}

struct HvpArgs {
  const float *gi, *gj, *scl, *scal, *ct, *cgi, *cgj, *cscl, *cscal;
  float *dgi, *dgj, *dscl, *dct, *dscal_blocks;
  int C;
};

template <int KIND, int LMAX>
int launch_hvp(const HvpArgs& a, cudaStream_t stream) {
  const int grid = (a.C + kBlock - 1) / kBlock;
  pair_hvp_kernel<KIND, LMAX><<<grid, kBlock, 0, stream>>>(
      a.gi, a.gj, a.scl, a.scal, a.ct, a.cgi, a.cgj, a.cscl, a.cscal, a.dgi, a.dgj, a.dscl,
      a.dct, a.dscal_blocks, a.C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admp_pair_hvp_block_size() { return kBlock; }

extern "C" int admp_pair_hvp(const float* gi, const float* gj, const float* scl,
                             const float* scal, const float* ct, const float* cgi,
                             const float* cgj, const float* cscl, const float* cscal,
                             float* dgi, float* dgj, float* dscl, float* dct,
                             float* dscal_blocks, int C, int kind, int lmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HvpArgs a{gi, gj, scl, scal, ct, cgi, cgj, cscl, cscal, dgi, dgj, dscl, dct,
                  dscal_blocks, C};
  if (lmax < 0 || lmax > 2) return -1;
  if (kind == kUU) return launch_hvp<kUU, 0>(a, s);
  switch (kind * 3 + lmax) {
    case 0: return launch_hvp<kPerm, 0>(a, s);
    case 1: return launch_hvp<kPerm, 1>(a, s);
    case 2: return launch_hvp<kPerm, 2>(a, s);
    case 3: return launch_hvp<kPol, 0>(a, s);
    case 4: return launch_hvp<kPol, 1>(a, s);
    case 5: return launch_hvp<kPol, 2>(a, s);
    default: return -1;
  }
}
