// The pair HVP's backward (K3b) of admp_tpu_torch, for sm_90a: the pair
// energies' third derivative.
//
// admp_tpu has no TPU kernel for it: it takes this derivative on its XLA
// route only, where JAX differentiates the plain pair energies three times
// (admp_tpu/ops/realspace.py), when a force-matching loss is differentiated
// through the exact implicit adjoint (SCFConfig.adjoint_fixed_iters). The
// Pallas HVP (admp_tpu/ops/pallas/pairs.py _pair_bwd_op_bwd :569) has no VJP.
//
// K3 (csrc/pair_hvp.cu) maps (x, ct, c) to (ct H c, J c), x the pair tables
// (g_i, g_j, scl, scal), c a direction of each. K3b is its VJP at cotangents
// (h, hct) of those two outputs. Per pair it returns
//   the cotangent of x:   ct T[c, h] + hct H c   (dgi, dgj, dscl, dscal)
//   the cotangent of ct:  h^T H c                (dct)
//   the cotangent of c:   ct H h + hct grad e    (dcgi, dcgj, dcscl, dcscal)
// with the scalar cotangents (kappa, box, box inverse) summed per block.
//
// Design: K2's mixed-mode body once more (pair_grad_parts in
// pair_energy.cuh), at S = Hyper = Dual<1, Dual1>: every input carries its
// entry of c as the eps tangent and of h as the delta tangent, and ct carries
// hct as its delta tangent. One pass gives the gradient's eps part (H c, K3's
// output), its delta part (ct H h + hct grad e, the cotangent of c) and its
// eps-delta part (ct T[c, h] + hct H c, the cotangent of x), and the energy's
// eps-delta part h^T H c.
//
// Bound on the card: arithmetic, registers and latency. Hyper quadruples
// every value of K2's body, so it spills heavily; this first version is the
// plain one, for correctness (its spills are in chip_smoke.py's phase 1 log).
// As K3, each thread stages its four output rows in shared memory and the
// block stores them coalesced (store_rows); the scalar cotangents are reduced
// per block in a fixed order (reduce_scalars), deterministic, no atomics.
//
// C interface (loaded with ctypes; returns cudaGetLastError(), or -1 for an
// unsupported (kind, lmax)):
//   admp_pair_third(gi, gj, scl, scal, ct, cgi, cgj, cscl, cscal,
//                   hgi, hgj, hscl, hscal, hct, dgi, dgj, dscl, dct,
//                   dcgi, dcgj, dcscl, dscal_blocks, C, kind, lmax, stream)
//   admp_pair_third_block_size()
// kind: 0 'perm', 1 'pol', 2 'uu'; the layouts are K2's. dscal_blocks is
// (blocks, 2, 19): per block, the scalars' cotangent of x, then of c.

#include "pair_energy.cuh"

namespace {

template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock, 1)
pair_third_kernel(const float* __restrict__ gi, const float* __restrict__ gj,
                  const float* __restrict__ scl, const float* __restrict__ scal,
                  const float* __restrict__ ct, const float* __restrict__ cgi,
                  const float* __restrict__ cgj, const float* __restrict__ cscl,
                  const float* __restrict__ cscal, const float* __restrict__ hgi,
                  const float* __restrict__ hgj, const float* __restrict__ hscl,
                  const float* __restrict__ hscal, const float* __restrict__ hct,
                  float* __restrict__ dgi, float* __restrict__ dgj, float* __restrict__ dscl,
                  float* __restrict__ dct, float* __restrict__ dcgi, float* __restrict__ dcgj,
                  float* __restrict__ dcscl, float* __restrict__ dscal_blocks, int C) {
  constexpr int F = Layout<KIND, LMAX>::F;
  // [part][row i / row j]: part 0 the cotangent of the tables, 1 of c
  __shared__ float s_out[2][2][kBlock * F];
  const int p0 = blockIdx.x * kBlock;
  const int p = p0 + threadIdx.x;
  float sg[2][kNScal];
#pragma unroll
  for (int k = 0; k < kNScal; ++k) {
    sg[0][k] = 0.f;
    sg[1][k] = 0.f;
  }
  if (p < C) {
    const size_t row = static_cast<size_t>(p) * F;
    float* const oi[2] = {s_out[0][0] + threadIdx.x * F, s_out[1][0] + threadIdx.x * F};
    float* const oj[2] = {s_out[0][1] + threadIdx.x * F, s_out[1][1] + threadIdx.x * F};
    float* const os[2] = {dscl, dcscl};
    pair_grad_parts<KIND, LMAX, Hyper>(p, C, gi + row, gj + row, scl, scal, ct, cgi + row,
                                       cgj + row, cscl, cscal, hgi + row, hgj + row, hscl,
                                       hscal, hct, oi, oj, os, dct, sg);
  }
  __syncthreads();
  store_rows<F>(s_out[0], p0, C, dgi, dgj);
  store_rows<F>(s_out[1], p0, C, dcgi, dcgj);
  // reduce_scalars writes block b's sums at its pointer + 19 b: part j of
  // block b lands at (2 b + j) 19
  float* const blocks = dscal_blocks + static_cast<size_t>(blockIdx.x) * kNScal;
  reduce_scalars(sg[0], blocks);
  __syncthreads();  // the first sums are read from reduce_scalars' staging
  reduce_scalars(sg[1], blocks + kNScal);
}

struct ThirdArgs {
  const float *gi, *gj, *scl, *scal, *ct, *cgi, *cgj, *cscl, *cscal, *hgi, *hgj, *hscl, *hscal,
      *hct;
  float *dgi, *dgj, *dscl, *dct, *dcgi, *dcgj, *dcscl, *dscal_blocks;
  int C;
};

template <int KIND, int LMAX>
int launch_third(const ThirdArgs& a, cudaStream_t stream) {
  const int grid = (a.C + kBlock - 1) / kBlock;
  pair_third_kernel<KIND, LMAX><<<grid, kBlock, 0, stream>>>(
      a.gi, a.gj, a.scl, a.scal, a.ct, a.cgi, a.cgj, a.cscl, a.cscal, a.hgi, a.hgj, a.hscl,
      a.hscal, a.hct, a.dgi, a.dgj, a.dscl, a.dct, a.dcgi, a.dcgj, a.dcscl, a.dscal_blocks, a.C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admp_pair_third_block_size() { return kBlock; }

extern "C" int admp_pair_third(const float* gi, const float* gj, const float* scl,
                               const float* scal, const float* ct, const float* cgi,
                               const float* cgj, const float* cscl, const float* cscal,
                               const float* hgi, const float* hgj, const float* hscl,
                               const float* hscal, const float* hct, float* dgi, float* dgj,
                               float* dscl, float* dct, float* dcgi, float* dcgj, float* dcscl,
                               float* dscal_blocks, int C, int kind, int lmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ThirdArgs a{gi,  gj,  scl,   scal, ct,  cgi, cgj,  cscl, cscal, hgi,  hgj,   hscl,
                    hscal, hct, dgi, dgj, dscl, dct, dcgi, dcgj, dcscl, dscal_blocks, C};
  if (lmax < 0 || lmax > 2) return -1;
  if (kind == kUU) return launch_third<kUU, 0>(a, s);
  switch (kind * 3 + lmax) {
    case 0: return launch_third<kPerm, 0>(a, s);
    case 1: return launch_third<kPerm, 1>(a, s);
    case 2: return launch_third<kPerm, 2>(a, s);
    case 3: return launch_third<kPol, 0>(a, s);
    case 4: return launch_third<kPol, 1>(a, s);
    case 5: return launch_third<kPol, 2>(a, s);
    default: return -1;
  }
}
