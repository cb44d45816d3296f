// The pair kernel's Hessian-vector kernel (K3) of admp_tpu_torch, for sm_90a.
//
// Replaces admp_tpu/ops/pallas/pairs.py _make_hvp_kernel (:445, launched by
// _pair_bwd_op_bwd :569): the VJP of the backward K2, B(x, ct) = ct J_e(x),
// at cotangents c = (cgi, cgj, cscl, cscal) of its outputs. Per pair it
// returns d_x = ct H_e(x) c for both rows and the scale rows, d_ct = J_e(x) c,
// and the per-block sums of d_x for the 19 scalars (kappa, box, box inverse).
//
// Design: forward mode over K2's function. pair_grad (pair_energy.cuh), the
// forward-mode gradient body K2 ran before its mixed-mode one, is evaluated
// in Dual1 arithmetic: every input of the pair carries its entry
// of c as a tangent (the wrap's inputs too: raw = a - b gets cgi - cgj, box
// and box inverse get cscal), so each gradient entry comes out with its
// derivative along c, which is the HVP entry, and the energy with J c. The
// hand chain rule of the wrap runs in Dual1 as well, which keeps the
// position x box, position x box-inverse and box x box-inverse second
// derivatives of the virial. One thread per pair, ceil(NV / kHvpTangents)
// passes of Dual<kHvpTangents, Dual1>.
//
// Bound on the card: arithmetic and registers. The nested dual doubles every
// value of pair_grad's passes, so K3 takes 2 tangents a pass to hold the
// register footprint; the dual arrays spill to local
// memory (L1-resident). A pair reads 4F+2 n_scl+2 floats and writes
// 2F+n_scl+1.
//
// C interface (loaded with ctypes; returns cudaGetLastError(), or -1 for an
// unsupported (kind, lmax)):
//   admp_pair_hvp(gi, gj, scl, scal, ct, cgi, cgj, cscl, cscal,
//                 dgi, dgj, dscl, dct, dscal_blocks, C, kind, lmax, stream)
//   admp_pair_hvp_block_size()
// kind: 0 'perm', 1 'pol', 2 'uu'; the layouts are K2's.

#include "pair_energy.cuh"

namespace {

constexpr int kHvpTangents = 2;

template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock)
pair_hvp_kernel(const float* __restrict__ gi, const float* __restrict__ gj,
                const float* __restrict__ scl, const float* __restrict__ scal,
                const float* __restrict__ ct, const float* __restrict__ cgi,
                const float* __restrict__ cgj, const float* __restrict__ cscl,
                const float* __restrict__ cscal, float* __restrict__ dgi,
                float* __restrict__ dgj, float* __restrict__ dscl, float* __restrict__ dct,
                float* __restrict__ dscal_blocks, int C) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float sg[kNScal];
#pragma unroll
  for (int k = 0; k < kNScal; ++k) sg[k] = 0.f;
  if (p < C)
    pair_grad<KIND, LMAX, Dual1, kHvpTangents>(p, C, gi, gj, scl, scal, ct, cgi, cgj, cscl,
                                               cscal, dgi, dgj, dscl, dct, sg);
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
