// PME spread (K4) and its adjoint gather (K6) of admp_tpu_torch, for sm_90a.
//
// spread_kernel replaces admp_tpu/ops/pallas/spread.py _make_spread_kernel
// (:210, via _make_spread_dma_kernel :349 / _pallas_spread_impl :387);
// gather_kernel replaces _make_gather_kernel (:890, via
// _pallas_gather_slabs_impl :1165) and, at K3 % 128 == 0, the XLA row gather
// _row_gather_impl (:1291) that admp_tpu takes there on the TPU.
//
// Both work by stencil rows (atom, x, y). One lane per row wraps the row's x
// and y indices and its first z once (a remainder only off the axis), for
// every channel, where K4's and K6's first versions took three remainders
// and a 64-bit division per point. A warp's 32 rows hold 32 order values per
// channel, in q's order ([atom][ch][x][y][z]); the warp takes them in order
// rounds of 32 consecutive values, each lane taking its value's row offsets
// from the row's lane by shuffle. So the lanes of a round touch consecutive
// z of a few rows of the mesh (a run, unless the row wraps at K3; K4 wraps
// z by one compare, and by a remainder only on an axis shorter than the
// stencil) and one 128-byte span of q per channel. (A lane walking its own row
// instead puts 32 rows under each access: it lost to one thread per point
// at C=3.)
//
// K4 adds the values into the f32 mesh with atomics whose results are unused
// (reductions, RED). There are no slab buckets, capacities or overflow
// fallbacks: on the card atomics replace the TPU's VMEM slab accumulators,
// and the C entry zeroes the mesh on the stream first (cudaMemsetAsync), as
// the TPU kernel zeroes its accumulators. Bound by the reductions'
// throughput in L2, then by bytes (the mesh zeroed, the N C order^3 values
// read). The rounds keep a row's run of values in one warp instruction: one
// thread per row, 32 rows under each instruction, took 1.7x as long at the
// MD shapes and 1.8x at 98k (H100, PERF.md). Where K3 % 4 == 0 (every mesh
// of the paths), spread_vec_kernel adds them as aligned float4 windows, one
// vector reduction for up to four values: 0.0044 ms of kernel time at the
// MD shapes against 0.0049 for the scalar rounds and 0.0051 for the first
// version's one thread per point. spread_kernel, the scalar rounds, takes
// the other axes.
//
// K6 copies each value out of the mesh and stores a round's 32 values per
// channel as one 128-byte span. A pure selection, so exact: equal bit for
// bit to the plain gather, and the adjoint of K4. Bound by bytes: the N C
// order^3 values written and the mesh points the stencils touch. At 3,000
// atoms both calls are host-bound: see the launchers in ops/cuda/spread.py.
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
//     f32, zeroed on the stream (cudaMemsetAsync), then accumulated into
//     (N = 0: zeroed only; the caller allocates it, of any contents)
//   admp_gather(m_u0, mesh, out, N, n_ch, order, K1, K2, K3, stream)
//     mesh (n_ch, K1, K2, K3) f32 -> out (N, n_ch, order^3) f32

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ int wrap_index(int x, int k) {
  const int r = x % k;
  return r < 0 ? r + k : r;
}

// x's periodic index on an axis of k points; the remainder only off the axis
__device__ __forceinline__ int wrap_fast(int x, int k) {
  return static_cast<unsigned>(x) < static_cast<unsigned>(k) ? x : wrap_index(x, k);
}

// z0 + c (z0 in [0, k), c < ORDER) on an axis of k points: one compare, a
// remainder only on an axis shorter than the stencil
template <int ORDER>
__device__ __forceinline__ int wrap_z(int z, int k) {
  if (z < k) return z;
  return k >= ORDER ? z - k : z % k;
}

// Warp w owns the stencil rows 32w .. 32w + 31 (row t: atom t / order^2,
// then x, y). Lane l wraps row 32w + l: its (x, y) offset in a channel plane,
// its first z and its first value in q. In round j, lane l takes value
// j 32 + l of the warp's rows, row (j 32 + l) / order, from that row's lane
// by shuffle, and adds it into every channel: q[atom][ch][x][y][z], so a
// round's 32 values in one channel are consecutive floats within an atom.
template <int ORDER, int NCH>
__global__ void __launch_bounds__(kBlock)
spread_kernel(const int* __restrict__ m_u0, const float* __restrict__ q, float* __restrict__ mesh,
              int n, int k1, int k2, int k3) {
  constexpr int kRows = ORDER * ORDER;  // stencil rows of an atom
  constexpr int kPts = kRows * ORDER;
  constexpr int kHalf = ORDER / 2;
  const long long rows = static_cast<long long>(n) * kRows;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x - lane;
  if (row0 >= rows) return;  // the whole warp
  const long long t = row0 + lane;
  long long start = 0;  // the row's offset in a channel plane at z = 0
  long long first = 0;  // the row's first value in q (channel 0)
  int z0 = 0;
  if (t < rows) {
    const int atom = static_cast<int>(t / kRows), row = static_cast<int>(t % kRows);
    const int* m = m_u0 + 3 * atom;
    const int i1 = wrap_fast(m[0] + row / ORDER - kHalf, k1);
    const int i2 = wrap_fast(m[1] + row % ORDER - kHalf, k2);
    z0 = wrap_fast(m[2] - kHalf, k3);
    start = (static_cast<long long>(i1) * k2 + i2) * k3;
    first = static_cast<long long>(atom) * NCH * kPts + row * ORDER;
  }
  const long long left = rows - row0;
  const int live = (left < 32 ? static_cast<int>(left) : 32) * ORDER;  // values per channel
  const long long plane = static_cast<long long>(k1) * k2 * k3;
#pragma unroll
  for (int j = 0; j < ORDER; ++j) {
    const int k = j * 32 + lane, src = k / ORDER, c = k % ORDER;
    const long long s = __shfl_sync(0xffffffffu, start, src);
    const long long o = __shfl_sync(0xffffffffu, first, src) + c;
    const int z = wrap_z<ORDER>(__shfl_sync(0xffffffffu, z0, src) + c, k3);
    if (k < live) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) atomicAdd(mesh + ch * plane + s + z, q[o + ch * kPts]);
    }
  }
}

// K4 where K3 % 4 == 0 (and K3 >= 12): the same rows, their values added as
// 16-byte-aligned float4 windows (a vector reduction, RED.v4: one request
// where the scalar rounds make four). Row r's values z0 .. z0 + ORDER - 1
// lie in the windows of 4 from z0 - z0 % 4 on, 2 or 3 of them at order 6,
// 1 or 2 at order 4, with zeros in the slots the row does not hold; a window
// past K3 wraps whole (K3 % 4 == 0, so none straddles it). The warp gives
// each of its 32 rows kWin window slots; in round j, lane l takes slot
// j 32 + l, row (j 32 + l) / kWin, its offsets from the row's lane by
// shuffle, and reads the window's values from q (consecutive lanes, the
// consecutive windows of a few rows).
template <int ORDER, int NCH>
__global__ void __launch_bounds__(kBlock)
spread_vec_kernel(const int* __restrict__ m_u0, const float* __restrict__ q,
                  float* __restrict__ mesh, int n, int k1, int k2, int k3) {
  constexpr int kRows = ORDER * ORDER;  // stencil rows of an atom
  constexpr int kPts = kRows * ORDER;
  constexpr int kHalf = ORDER / 2;
  constexpr int kWin = (ORDER + 6) / 4;  // window slots of a row
  const long long rows = static_cast<long long>(n) * kRows;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x - lane;
  if (row0 >= rows) return;  // the whole warp
  const long long t = row0 + lane;
  long long start = 0;  // the row's offset in a channel plane at z = 0
  long long first = 0;  // the row's first value in q (channel 0)
  int z0 = 0;
  if (t < rows) {
    const int atom = static_cast<int>(t / kRows), row = static_cast<int>(t % kRows);
    const int* m = m_u0 + 3 * atom;
    const int i1 = wrap_fast(m[0] + row / ORDER - kHalf, k1);
    const int i2 = wrap_fast(m[1] + row % ORDER - kHalf, k2);
    z0 = wrap_fast(m[2] - kHalf, k3);
    start = (static_cast<long long>(i1) * k2 + i2) * k3;
    first = static_cast<long long>(atom) * NCH * kPts + row * ORDER;
  }
  const long long left = rows - row0;
  const int live = left < 32 ? static_cast<int>(left) : 32;  // rows of the warp
  const long long plane = static_cast<long long>(k1) * k2 * k3;
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const int k = j * 32 + lane, src = k / kWin, w = k % kWin;
    const long long s = __shfl_sync(0xffffffffu, start, src);
    const long long o = __shfl_sync(0xffffffffu, first, src);
    const int z = __shfl_sync(0xffffffffu, z0, src);
    const int lo = 4 * w - z % 4;  // the window's first slot, as a value index
    if (src < live && lo < ORDER) {
      int base = z + lo;  // 4-aligned
      if (base >= k3) base -= k3;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const float* v = q + o + ch * kPts;
        const float4 x = make_float4(lo >= 0 ? v[lo] : 0.f,
                                     lo >= -1 && lo + 1 < ORDER ? v[lo + 1] : 0.f,
                                     lo >= -2 && lo + 2 < ORDER ? v[lo + 2] : 0.f,
                                     lo + 3 < ORDER ? v[lo + 3] : 0.f);
        atomicAdd(reinterpret_cast<float4*>(mesh + ch * plane + s + base), x);
      }
    }
  }
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
  const size_t bytes = sizeof(float) * NCH * static_cast<size_t>(k1) * k2 * k3;
  const cudaError_t zeroed = cudaMemsetAsync(mesh, 0, bytes, s);
  if (zeroed != cudaSuccess || n <= 0) return static_cast<int>(zeroed);
  const long long threads = static_cast<long long>(n) * ORDER * ORDER;  // one per row
  const int grid = static_cast<int>((threads + kBlock - 1) / kBlock);
  if (k3 % 4 == 0 && k3 >= 12 && reinterpret_cast<uintptr_t>(mesh) % 16 == 0)
    spread_vec_kernel<ORDER, NCH><<<grid, kBlock, 0, s>>>(m_u0, q, mesh, n, k1, k2, k3);
  else
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
