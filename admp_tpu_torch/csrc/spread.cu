// PME spread (K4) and its adjoint gather (K6) of admp_tpu_torch, for sm_90a.
//
// spread_kernel replaces admp_tpu/ops/pallas/spread.py _make_spread_kernel
// (:210, via _make_spread_dma_kernel :349 / _pallas_spread_impl :387);
// gather_kernel replaces _make_gather_kernel (:890, via
// _pallas_gather_slabs_impl :1165) and, at K3 % 128 == 0, the XLA row gather
// _row_gather_impl (:1291) that admp_tpu takes there on the TPU.
//
// K4: one thread per (atom, stencil point); the channels loop inside it. It
// computes the periodic flat mesh index from the atom's base index m_u0 and
// atomically adds each channel's stencil value into the f32 mesh. There are
// no slab buckets, capacities or overflow fallbacks: on the card atomics
// replace the TPU's VMEM slab accumulators. Bound by memory traffic and
// atomic throughput: it reads 4 bytes of stencil value per (atom, point,
// channel) and issues one f32 atomicAdd; consecutive threads hold
// consecutive z points of one atom, so both the reads and the atomics of a
// warp hit neighbouring addresses of one mesh row.
//
// K6: one lane per stencil row (atom, x, y) wraps the row's x and y indices
// and its first z once (a remainder only off the axis), for every channel,
// where the first version took three remainders per point. A warp's 32 rows
// hold 32 order values per channel, in output order; the warp reads and
// writes them in order rounds of 32 consecutive values, each lane taking its
// value's row offsets from the row's lane by shuffle. So the lanes of a
// round read consecutive z of a few rows (a run, unless the row wraps at K3;
// an axis shorter than the stencil takes each z by its remainder) and store
// one 128-byte span per channel. (A lane reading its own row instead puts 32
// rows under each load: it lost to one thread per point at C=3.) A pure
// selection, so exact: equal bit for bit to the plain gather, and the
// adjoint of K4. Bound by bytes: the N C order^3 values written and the mesh
// points the stencils touch. At 3,000 atoms the call is host-bound: see the
// launchers in ops/cuda/spread.py.
//
// The meshes K4/K6 serve under 'auto' stay in the 50 MB L2: the
// electrostatic (96, 96, 128) or 128^3 mesh (4.7 / 8.4 MB, C=1, order 6) and
// the dispersion 3 x 128^3 mesh (25 MB, C=3, order 4 or 6). A larger order-6
// mesh (the 98k-atom box at 256^3 and 320^3) goes to the tiled pair of
// spread_tiled.cu instead. The channel offset ch * plane is a 64-bit product.
//
// C interface (ctypes; each entry returns cudaGetLastError(), or -1 for an
// unsupported (order, channels)):
//   admp_spread(m_u0, q, mesh, N, n_ch, order, K1, K2, K3, stream)
//     m_u0 (N, 3) int32, q (N, n_ch, order^3) f32 -> mesh (n_ch, K1, K2, K3)
//     f32, accumulated into (the caller zeroes it)
//   admp_gather(m_u0, mesh, out, N, n_ch, order, K1, K2, K3, stream)
//     mesh (n_ch, K1, K2, K3) f32 -> out (N, n_ch, order^3) f32

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ int wrap_index(int x, int k) {
  const int r = x % k;
  return r < 0 ? r + k : r;
}

template <int ORDER>
__device__ __forceinline__ long long stencil_flat_index(const int* __restrict__ m, int pt, int k1,
                                                       int k2, int k3) {
  constexpr int kHalf = ORDER / 2;
  const int a = pt / (ORDER * ORDER);
  const int b = (pt / ORDER) % ORDER;
  const int c = pt % ORDER;
  const int i1 = wrap_index(m[0] + a - kHalf, k1);
  const int i2 = wrap_index(m[1] + b - kHalf, k2);
  const int i3 = wrap_index(m[2] + c - kHalf, k3);
  return (static_cast<long long>(i1) * k2 + i2) * k3 + i3;
}

template <int ORDER, int NCH>
__global__ void __launch_bounds__(kBlock)
spread_kernel(const int* __restrict__ m_u0, const float* __restrict__ q, float* __restrict__ mesh,
              int n, int k1, int k2, int k3) {
  constexpr int kPts = ORDER * ORDER * ORDER;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n) * kPts) return;
  const int atom = static_cast<int>(t / kPts);
  const int pt = static_cast<int>(t % kPts);
  const long long flat = stencil_flat_index<ORDER>(m_u0 + 3 * atom, pt, k1, k2, k3);
  const long long plane = static_cast<long long>(k1) * k2 * k3;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
    atomicAdd(mesh + ch * plane + flat, q[(static_cast<long long>(atom) * NCH + ch) * kPts + pt]);
}

// x's periodic index on an axis of k points; the remainder only off the axis
__device__ __forceinline__ int wrap_fast(int x, int k) {
  return static_cast<unsigned>(x) < static_cast<unsigned>(k) ? x : wrap_index(x, k);
}

// Warp w owns the stencil rows 32w .. 32w + 31 (row t: atom t / order^2,
// then x, y). Lane l wraps row 32w + l: its (x, y) offset in a channel plane
// and its first z. In round j, lane l takes value j 32 + l of the warp's
// rows, row (j 32 + l) / order, from that row's lane by shuffle, and copies
// it in every channel: out[atom][ch][x][y][z], so a round's 32 values in one
// channel are consecutive floats within an atom.
template <int ORDER, int NCH>
__global__ void __launch_bounds__(kBlock)
gather_kernel(const int* __restrict__ m_u0, const float* __restrict__ mesh,
              float* __restrict__ out, int n, int k1, int k2, int k3) {
  constexpr int kRows = ORDER * ORDER;  // stencil rows of an atom
  constexpr int kPts = kRows * ORDER;
  constexpr int kHalf = ORDER / 2;
  const long long rows = static_cast<long long>(n) * kRows;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x - lane;
  if (row0 >= rows) return;  // the whole warp
  const long long t = row0 + lane;
  long long start = 0;  // the row's offset in a channel plane at z = 0
  int z0 = 0;
  if (t < rows) {
    const int atom = static_cast<int>(t / kRows), row = static_cast<int>(t % kRows);
    const int* m = m_u0 + 3 * atom;
    const int i1 = wrap_fast(m[0] + row / ORDER - kHalf, k1);
    const int i2 = wrap_fast(m[1] + row % ORDER - kHalf, k2);
    z0 = wrap_fast(m[2] - kHalf, k3);
    start = (static_cast<long long>(i1) * k2 + i2) * k3;
  }
  const long long left = rows - row0;
  const int live = (left < 32 ? static_cast<int>(left) : 32) * ORDER;  // values per channel
  const long long plane = static_cast<long long>(k1) * k2 * k3;
#pragma unroll
  for (int j = 0; j < ORDER; ++j) {
    const int k = j * 32 + lane, src = k / ORDER, c = k % ORDER;
    const long long s = __shfl_sync(0xffffffffu, start, src);
    int z = __shfl_sync(0xffffffffu, z0, src) + c;
    if (z >= k3) z %= k3;
    const long long r = row0 + src;  // the value's (atom, row): out[atom][ch][row][c]
    const long long o = r * ORDER + c + r / kRows * (NCH - 1) * kPts;
    if (k < live) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) out[o + ch * kPts] = mesh[ch * plane + s + z];
    }
  }
}

template <int ORDER, int NCH>
int launch_spread(const int* m_u0, const float* q, float* mesh, int n, int k1, int k2, int k3,
                  cudaStream_t s) {
  const long long threads = static_cast<long long>(n) * ORDER * ORDER * ORDER;
  const int grid = static_cast<int>((threads + kBlock - 1) / kBlock);
  spread_kernel<ORDER, NCH><<<grid, kBlock, 0, s>>>(m_u0, q, mesh, n, k1, k2, k3);
  return static_cast<int>(cudaGetLastError());
}

template <int ORDER, int NCH>
int launch_gather(const int* m_u0, const float* mesh, float* out, int n, int k1, int k2, int k3,
                  cudaStream_t s) {
  const long long threads = static_cast<long long>(n) * ORDER * ORDER;  // one per row
  const int grid = static_cast<int>((threads + kBlock - 1) / kBlock);
  gather_kernel<ORDER, NCH><<<grid, kBlock, 0, s>>>(m_u0, mesh, out, n, k1, k2, k3);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admp_spread(const int* m_u0, const float* q, float* mesh, int n, int n_ch,
                           int order, int k1, int k2, int k3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 6 && n_ch == 1) return launch_spread<6, 1>(m_u0, q, mesh, n, k1, k2, k3, s);
  if (order == 6 && n_ch == 3) return launch_spread<6, 3>(m_u0, q, mesh, n, k1, k2, k3, s);
  if (order == 4 && n_ch == 1) return launch_spread<4, 1>(m_u0, q, mesh, n, k1, k2, k3, s);
  if (order == 4 && n_ch == 3) return launch_spread<4, 3>(m_u0, q, mesh, n, k1, k2, k3, s);
  return -1;
}

extern "C" int admp_gather(const int* m_u0, const float* mesh, float* out, int n, int n_ch,
                           int order, int k1, int k2, int k3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 6 && n_ch == 1) return launch_gather<6, 1>(m_u0, mesh, out, n, k1, k2, k3, s);
  if (order == 6 && n_ch == 3) return launch_gather<6, 3>(m_u0, mesh, out, n, k1, k2, k3, s);
  if (order == 4 && n_ch == 1) return launch_gather<4, 1>(m_u0, mesh, out, n, k1, k2, k3, s);
  if (order == 4 && n_ch == 3) return launch_gather<4, 3>(m_u0, mesh, out, n, k1, k2, k3, s);
  return -1;
}
