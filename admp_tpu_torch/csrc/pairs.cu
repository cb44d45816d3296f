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
// reads its two rows, table[i[p]] and table[j[p]], from the packed (N, F)
// atom table through the pair list (4.7-6.7 MB at 98,304 atoms: it stays in
// L2), and 3 scale floats; it writes one float (forward) or adds 2F into
// the table's gradient (backward). No (C, F) table of gathered rows is made,
// nor an index_add of one. K2 keeps its intermediates in registers (168-250
// unbounded at lmax 2), so its launch bounds trade a few hundred bytes of
// L1-resident spills for more blocks per SM (bwd_min_blocks). It stages its
// two output rows per pair in shared memory, then adds them into a (N, ld)
// gradient table (ld = F rounded up to 4 floats, so that each row is
// 16-byte aligned; the launcher hands autograd its first F columns), zeroed
// on the stream by the C entry (cudaMemsetAsync): the i side per warp, where
// runs of equal i (~27 pairs an atom in an i-sorted list) are summed by a
// segmented shuffle and added by one float4 atomic per run and 4 columns;
// the j side one float4 atomic per pair and 4 columns, from the staged rows
// in shared memory so that a warp's atomics cover adjacent columns. Runs
// are taken between neighbouring lanes, so any pair order is right; an
// i-sorted list only makes it cheaper. The atomics' order varies, so the
// gradient table is not bitwise repeatable. The scalar gradients are
// reduced per block in a fixed order (warp shuffles, then shared memory)
// into an (n_blocks, 19) buffer that the wrapper sums: deterministic, no
// atomics. A masked pair, and a pair whose i or j lies outside [0, N) (a
// list's padding slot), reads no row, has energy 0 and adds nothing.
//
// C interface (loaded with ctypes; each entry returns cudaGetLastError(), or
// -1 for an unsupported (kind, lmax)):
//   admp_pair_fwd(table, i, j, scl, scal, e, N, C, kind, lmax, stream)
//   admp_pair_bwd(table, i, j, scl, scal, ct, dtab, dscl, dscal_blocks, N,
//                 C, kind, lmax, stream)
//   admp_pair_block_size()
// table (N, F), i and j (C,) int64; dtab (N, ld) is zeroed and added into
// (nullptr: the table's gradient is not wanted), dscl (n_scl, C) is written
// (nullptr: not wanted). kind: 0 'perm', 1 'pol', 2 'uu'. Row layouts are
// documented in admp_tpu_torch/ops/cuda/pairs.py.

#include <stdint.h>

#include "pair_energy.cuh"

namespace {

// Row r of a (rows, F) table
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ g, size_t r, float* out) {
#pragma unroll
  for (int k = 0; k < F; ++k) out[k] = g[r * F + k];
}

// Whether row r lies in a table of n rows (a padding slot, index n, does not)
__device__ __forceinline__ bool in_table(int64_t r, int n) {
  return static_cast<uint64_t>(r) < static_cast<uint64_t>(n);
}

// Columns of a row of the gradient table: F rounded up to 4
__host__ __device__ constexpr int padded(int f) { return (f + 3) / 4 * 4; }

template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock)
pair_fwd_kernel(const float* __restrict__ table, const int64_t* __restrict__ i,
                const int64_t* __restrict__ j, const float* __restrict__ scl,
                const float* __restrict__ scal, float* __restrict__ e, int N, int C) {
  using L = Layout<KIND, LMAX>;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= C) return;
  const int64_t ri = i[p], rj = j[p];
  if (!(scl[C + p] > 0.5f) || !in_table(ri, N) || !in_table(rj, N)) {
    e[p] = 0.f;
    return;
  }
  float a[L::F], b[L::F];
  load_row<L::F>(table, static_cast<size_t>(ri), a);
  load_row<L::F>(table, static_cast<size_t>(rj), b);
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

// Entry c of a staged row of F floats, 0 in the padding columns
template <int F>
__device__ __forceinline__ float staged(const float* row, int c) {
  return c < F ? row[c] : 0.f;
}

// K2's adds of a block's staged rows (s_out[0] the i rows, s_out[1] the j
// rows, thread t at row t) into the gradient table dtab (N, LD): key_i,
// this thread's i (-1 for a masked pair or one past C); s_kj, each
// pair's j (-1 likewise). The i side: each warp's runs of equal i between
// neighbouring lanes summed by a segmented suffix scan of shuffles, one
// float4 atomic per run and 4 columns from the run's first lane. The j
// side: one float4 atomic per pair and 4 columns, lanes over adjacent
// columns. Every thread of the block calls it, after the staging's barrier.
template <int F>
__device__ __forceinline__ void add_rows(const float (&s_out)[2][kBlock * F], int key_i,
                                         const int* s_kj, int p0, int C,
                                         float* __restrict__ dtab) {
  constexpr int LD = padded(F);
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int before = __shfl_up_sync(kAll, key_i, 1);
  const bool head = lane == 0 || before != key_i;
  const unsigned later = __ballot_sync(kAll, head) & ~((2u << lane) - 1u);
  const int end = later ? __ffs(later) - 2 : 31;  // this run's last lane
  const float* row = s_out[0] + threadIdx.x * F;
#pragma unroll
  for (int c = 0; c < LD; c += 4) {
    float v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      v[m] = staged<F>(row, c + m);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float w = __shfl_down_sync(kAll, v[m], o);
        if (lane + o <= end) v[m] += w;
      }
    }
    if (head && key_i >= 0)
      atomicAdd(reinterpret_cast<float4*>(dtab + static_cast<size_t>(key_i) * LD + c),
                make_float4(v[0], v[1], v[2], v[3]));
  }
  const int n = (C - p0 < kBlock ? C - p0 : kBlock) * (LD / 4);
  for (int u = threadIdx.x; u < n; u += kBlock) {
    const int q = u / (LD / 4), c = 4 * (u - q * (LD / 4));
    const int kj = s_kj[q];
    if (kj < 0) continue;
    const float* r = s_out[1] + q * F;
    atomicAdd(reinterpret_cast<float4*>(dtab + static_cast<size_t>(kj) * LD + c),
              make_float4(staged<F>(r, c), staged<F>(r, c + 1), staged<F>(r, c + 2),
                          staged<F>(r, c + 3)));
  }
}

// K2: one thread per pair; each thread's two output rows are staged in
// shared memory, then the block adds them into the gradient table (add_rows)
template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock, bwd_min_blocks(KIND, LMAX))
pair_bwd_kernel(const float* __restrict__ table, const int64_t* __restrict__ i,
                const int64_t* __restrict__ j, const float* __restrict__ scl,
                const float* __restrict__ scal, const float* __restrict__ ct,
                float* __restrict__ dtab, float* __restrict__ dscl,
                float* __restrict__ dscal_blocks, int N, int C) {
  using L = Layout<KIND, LMAX>;
  constexpr int F = L::F;
  __shared__ float s_out[2][kBlock * F];
  __shared__ int s_kj[kBlock];
  const int p0 = blockIdx.x * kBlock;
  const int p = p0 + threadIdx.x;
  float sg[kNScal];
#pragma unroll
  for (int k = 0; k < kNScal; ++k) sg[k] = 0.f;
  int key_i = -1, key_j = -1;
  if (p < C) {
    const int64_t ri = i[p], rj = j[p];
    float* const oi = s_out[0] + threadIdx.x * F;
    float* const oj = s_out[1] + threadIdx.x * F;
    if (in_table(ri, N) && in_table(rj, N)) {
      if (scl[C + p] > 0.5f) {
        key_i = static_cast<int>(ri);
        key_j = static_cast<int>(rj);
      }
      pair_grad_mixed<KIND, LMAX, float>(p, C, table + ri * F, table + rj * F, scl, scal, ct,
                                         nullptr, nullptr, nullptr, nullptr, oi, oj, dscl,
                                         nullptr, sg);
    } else {  // outside the table: a masked pair
      float* const poi[1] = {oi};
      float* const poj[1] = {oj};
      float* const pdscl[1] = {dscl};
      zero_pair<L, 1>(p, C, poi, poj, pdscl, nullptr);
    }
  }
  s_kj[threadIdx.x] = key_j;
  __syncthreads();
  if (dtab != nullptr) add_rows<F>(s_out, key_i, s_kj, p0, C, dtab);
  reduce_scalars(sg, dscal_blocks);
}

struct FwdArgs {
  const float* table;
  const int64_t *i, *j;
  const float *scl, *scal;
  float* e;
  int N, C;
};

struct BwdArgs {
  const float* table;
  const int64_t *i, *j;
  const float *scl, *scal, *ct;
  float *dtab, *dscl, *dscal_blocks;
  int N, C;
};

template <int KIND, int LMAX>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const int grid = (a.C + kBlock - 1) / kBlock;
  pair_fwd_kernel<KIND, LMAX>
      <<<grid, kBlock, 0, stream>>>(a.table, a.i, a.j, a.scl, a.scal, a.e, a.N, a.C);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, int LMAX>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr int LD = padded(Layout<KIND, LMAX>::F);
  if (a.dtab != nullptr)
    cudaMemsetAsync(a.dtab, 0, sizeof(float) * LD * static_cast<size_t>(a.N), stream);
  if (a.C == 0) return static_cast<int>(cudaGetLastError());
  const int grid = (a.C + kBlock - 1) / kBlock;
  pair_bwd_kernel<KIND, LMAX><<<grid, kBlock, 0, stream>>>(
      a.table, a.i, a.j, a.scl, a.scal, a.ct, a.dtab, a.dscl, a.dscal_blocks, a.N, a.C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admp_pair_block_size() { return kBlock; }

extern "C" int admp_pair_fwd(const float* table, const int64_t* i, const int64_t* j,
                             const float* scl, const float* scal, float* e, int N, int C,
                             int kind, int lmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{table, i, j, scl, scal, e, N, C};
  if (lmax < 0 || lmax > 2) return -1;
  if (kind == kUU) return launch_fwd<kUU, 0>(a, s);
  switch (kind * 3 + lmax) {
    case 0: return launch_fwd<kPerm, 0>(a, s);
    case 1: return launch_fwd<kPerm, 1>(a, s);
    case 2: return launch_fwd<kPerm, 2>(a, s);
    case 3: return launch_fwd<kPol, 0>(a, s);
    case 4: return launch_fwd<kPol, 1>(a, s);
    case 5: return launch_fwd<kPol, 2>(a, s);
    default: return -1;
  }
}

extern "C" int admp_pair_bwd(const float* table, const int64_t* i, const int64_t* j,
                             const float* scl, const float* scal, const float* ct, float* dtab,
                             float* dscl, float* dscal_blocks, int N, int C, int kind,
                             int lmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a{table, i, j, scl, scal, ct, dtab, dscl, dscal_blocks, N, C};
  if (lmax < 0 || lmax > 2) return -1;
  if (kind == kUU) return launch_bwd<kUU, 0>(a, s);
  switch (kind * 3 + lmax) {
    case 0: return launch_bwd<kPerm, 0>(a, s);
    case 1: return launch_bwd<kPerm, 1>(a, s);
    case 2: return launch_bwd<kPerm, 2>(a, s);
    case 3: return launch_bwd<kPol, 0>(a, s);
    case 4: return launch_bwd<kPol, 1>(a, s);
    case 5: return launch_bwd<kPol, 2>(a, s);
    default: return -1;
  }
}
