// Tiled PME spread (K5) and its adjoint gather (K7) of admp_tpu_torch, for
// sm_90a: the large-mesh pair, for meshes that do not fit the 50 MB L2.
//
// spread_tiled_kernel replaces admp_tpu/ops/pallas/spread.py
// _pallas_spread2d_impl (:718, via spread_blocks_2d :836 and
// spread_blocks_2d_multi :1401), the (x, y)-blocked spread that admp_tpu's
// 'auto' takes once the 1-D slab accumulator no longer fits VMEM (the
// 98,304-atom box at 256^3 and 320^3). gather_tiled_kernel replaces
// _make_gather_kernel_mxu (:949, reached through _pallas_gather2d_impl :1063
// with variant="mxu"), K6's function on the same block decomposition from
// one staged window per atom.
//
// The mesh is cut into core tiles of kT1 x kT2 x kT3 points (x, y, z; the
// last tile of an axis may be partial). The atoms are binned by the tile of
// their wrapped base index b = (m_u0 - order/2) mod K, stably sorted by bin
// (ops/cuda/spread.tile_bins, plain PyTorch, shared with the plain
// versions); an atom's stencil covers b .. b + order - 1 on each axis.
//
// K5, owner computes. One block owns one core tile and writes each of its
// points exactly once, so the mesh needs no memset and no atomics. Its
// thread (y, z) owns the kT1 points of one x-column in registers. The atoms
// that can reach the core lie in the source bins: the tiles whose bases lie
// in [c - order + 1, c + kT - 1] mod K on each axis, at most 3 per axis (8
// at 320^3). What bounds it is latency, not bytes: at 98,304 atoms on 320^3
// a block owns the work of ~19 atoms, drawn from ~50 in 8 bins. So the
// block gathers everything in three dependent rounds of loads:
//   1. plan: lane s of warp 0 reads source bin s's [offsets[src],
//      offsets[src + 1]) and a warp scan lays the bins end to end (bins in
//      source order, atoms in sorted order);
//   2. one thread per listed atom loads its base; the atoms whose base lies
//      in the core's halo'd window ((kT + order - 1) per axis: 38% of the
//      listed ones at 320^3) load their id and are compacted, in order, by a
//      ballot and a block prefix into the stage;
//   3. every thread issues asynchronous copies (cp.async, 16 bytes where the
//      stencil rows are 16-byte aligned, else 4) of the staged atoms'
//      stencil rows into shared memory, and the block waits once.
// The accumulation then reads shared memory only: 4 barriers in all for a
// block whose atoms fit the stage. The stage holds a compile-time number of
// rows per (order, C) (stage_rows, under the 48 KB of static shared memory);
// a block whose window holds more atoms walks its list in chunks, in the
// same order, so the sum at a point is taken in the same order on every run
// and the mesh is bit-identical from run to run. No bin has a capacity: the
// TPU kernel's buckets fell back to a scatter on overflow
// (spread.py:846-850). Each staged atom keeps its window coordinate
// w = (b - c + order - 1) mod K; a thread's point p takes stencil index
// p + order - 1 - w and, on an axis shorter than the halo'd tile
// (K < kT + order - 1), also its images K, 2K, ... below it.
//
// K7. One block per bin: it stages the cotangent window of its tile plus
// the halo ((kT1 + order - 1) x (kT2 + order - 1) x (kT3 + order - 1) per
// channel, periodic wrap by index) in shared memory with coalesced loads;
// each (atom, stencil point) thread reads its value there and writes it to
// the atom's row in original order (through the bins' permutation). A pure
// selection: equal bit for bit to the plain gather. The TPU kernel's one-hot
// MXU z-contraction existed because Mosaic cannot pick unaligned lanes; a
// shared-memory read does the pick here, exactly (a TF32 one-hot product
// would round the cotangents).
//
// Bytes: K5 reads the stencil values (N C order^3 f32) and writes the whole
// mesh once; it stages each atom in ~3 blocks ((kT + order - 1)^3 / kT^3 at
// order 6), mostly from L2. K7 reads each core tile with its halo,
// (1 + (order-1)/kT)^3 of the mesh (~3x at order 6), and writes N C order^3
// values. Flat mesh offsets are 64-bit (3 x 320^3 = 98M).
//
// C interface (ctypes; each returns cudaGetLastError(), -1 for an
// unsupported (order, channels), -2 for a tile shape other than the one
// compiled here):
//   admp_spread_tiled(base, perm, offsets, q, mesh, n_ch, order, K1, K2, K3,
//                     T1, T2, T3, stream)
//     base (N, 3) int32 wrapped bases in bin order, perm (N,) int32 atom of
//     each sorted slot, offsets (n_tiles + 1,) int32 bin starts,
//     q (N, n_ch, order^3) f32 in atom order -> mesh (n_ch, K1, K2, K3) f32,
//     every point written
//   admp_gather_tiled(base, perm, offsets, mesh, out, n_ch, order, K1, K2,
//                     K3, T1, T2, T3, stream)
//     mesh (n_ch, K1, K2, K3) f32 -> out (N, n_ch, order^3) f32 in atom order

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT1 = 8, kT2 = 8, kT3 = 32;  // core tile (x, y, z)
constexpr int kThreads = kT2 * kT3;        // K5: one thread per (y, z) column
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 27;               // K5: source bins of a tile, <= 3 per axis
constexpr int kStageBytes = 41472;         // K5: stencil rows staged per chunk

// K5's stage: rows of C order^3 floats; 48 at (6, 1), 16 at (6, 3), 64 at
// order 4 (54 at (4, 3))
__host__ __device__ constexpr int stage_rows(int order, int nch) {
  const int rows = kStageBytes / (4 * nch * order * order * order);
  return rows < 64 ? rows : 64;
}

// x in [0, 2^31): its periodic index on an axis of k points
__device__ __forceinline__ int wrap_up(int x, int k) { return x < k ? x : x % k; }

// The tiles along one axis whose bases can reach the core of tile t: those
// in [t * tile - halo, t * tile + tile - 1] (mod k), walked from `first`,
// `count` of them (no tile twice). A window as long as the axis takes all.
__device__ __forceinline__ void source_tiles(int t, int tile, int k, int nt, int halo,
                                             int& first, int& count) {
  if (tile + halo >= k || nt == 1) {
    first = 0;
    count = nt;
    return;
  }
  int start = t * tile - halo;
  if (start < 0) start += k;
  first = start / tile;
  count = t - first;
  if (count < 0) count += nt;
  count += 1;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Adds n staged atoms to the thread's x-column at (py, pz) of the core, in
// staged order. s_w: each atom's window coordinates; s_q: its stencil rows.
// A point p takes stencil index d = p + order - 1 - w and its images d - K,
// d - 2K, ... that are >= 0; WIDE (every axis at least kT + order - 1 long)
// has no images, and then the loops below run at most once. py is uniform
// over a warp (kT3 = 32), so the y test does not diverge.
template <int ORDER, int NCH, bool WIDE>
__device__ __forceinline__ void accumulate(float (&acc)[NCH][kT1], const float* s_q,
                                           const int4* s_w, int n, int py, int pz, int k1,
                                           int k2, int k3) {
  constexpr int kPts = ORDER * ORDER * ORDER;
  constexpr int kHalo = ORDER - 1;
  for (int a = 0; a < n; ++a) {
    const int4 w = s_w[a];
    for (int yy = py + kHalo - w.y; yy >= 0; yy -= k2) {
      if (yy < ORDER) {
        for (int zz = pz + kHalo - w.z; zz >= 0; zz -= k3) {
          if (zz < ORDER) {
            const float* qa = s_q + a * NCH * kPts + yy * ORDER + zz;
#pragma unroll
            for (int x = 0; x < kT1; ++x) {
              for (int xx = x + kHalo - w.x; xx >= 0; xx -= k1) {
                if (xx < ORDER) {
#pragma unroll
                  for (int ch = 0; ch < NCH; ++ch)
                    acc[ch][x] += qa[ch * kPts + xx * ORDER * ORDER];
                }
                if (WIDE) break;
              }
            }
          }
          if (WIDE) break;
        }
      }
      if (WIDE) break;
    }
  }
}

template <int ORDER, int NCH>
__global__ void __launch_bounds__(kThreads)
spread_tiled_kernel(const int* __restrict__ base, const int* __restrict__ perm,
                    const int* __restrict__ offsets, const float* __restrict__ q,
                    float* __restrict__ mesh, int k1, int k2, int k3, int nt1, int nt2,
                    int nt3, int vec16) {
  constexpr int kPts = ORDER * ORDER * ORDER;
  constexpr int kRow = NCH * kPts;  // floats per staged row, a multiple of 4
  constexpr int kHalo = ORDER - 1;
  constexpr int kRows = stage_rows(ORDER, NCH);
  static_assert(kHalo < kT1 && kHalo < kT2 && kHalo < kT3, "<= 3 source tiles per axis");
  static_assert(kT3 == 32, "one warp per (y) row of the core");
  static_assert(kRow % 4 == 0, "16-byte rows");
  static_assert(kRows > 0 && kRows <= kThreads, "a chunk fits one pass of the block");
  __shared__ __align__(16) float s_q[kRows * kRow];
  __shared__ int4 s_w[kRows];  // window coordinates (x, y, z) of each staged atom
  __shared__ int s_id[kRows];
  __shared__ int s_lo[kMaxBins], s_start[kMaxBins + 1];
  __shared__ int s_kept[kWarps], s_next;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x;
  const int t3 = tile % nt3, t2 = (tile / nt3) % nt2, t1 = tile / (nt3 * nt2);
  const int c1 = t1 * kT1, c2 = t2 * kT2, c3 = t3 * kT3;
  const int py = tid / kT3, pz = tid % kT3;
  const bool live = c2 + py < k2 && c3 + pz < k3;
  const bool wide = k1 >= kT1 + kHalo && k2 >= kT2 + kHalo && k3 >= kT3 + kHalo;

  // 1. plan: lane s of warp 0 reads source bin s; a scan lays them end to end
  if (warp == 0) {
    int f1, n1, f2, n2, f3, n3;
    source_tiles(t1, kT1, k1, nt1, kHalo, f1, n1);
    source_tiles(t2, kT2, k2, nt2, kHalo, f2, n2);
    source_tiles(t3, kT3, k3, nt3, kHalo, f3, n3);
    int lo = 0, cnt = 0;
    if (lane < n1 * n2 * n3) {
      const int s3 = lane % n3, s2 = (lane / n3) % n2, s1 = lane / (n3 * n2);
      const int src = (((f1 + s1) % nt1) * nt2 + (f2 + s2) % nt2) * nt3 + (f3 + s3) % nt3;
      lo = offsets[src];
      cnt = offsets[src + 1] - lo;
    }
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane < kMaxBins) {
      s_lo[lane] = lo;
      s_start[lane] = incl - cnt;
    }
    if (lane == 31) s_start[kMaxBins] = incl;  // the length of the list
  }
  __syncthreads();

  float acc[NCH][kT1];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int x = 0; x < kT1; ++x) acc[ch][x] = 0.f;

  const int total = s_start[kMaxBins];
  for (int r0 = 0; r0 < total;) {
    // 2. thread g: listed atom r0 + g, its window coordinates, and its id if
    // its base lies in the window; the kept atoms take stage slots in order
    const int g = r0 + tid;
    int4 w = make_int4(0, 0, 0, 0);
    int id = 0;
    bool keep = false;
    if (g < total) {
      int b = 0;
      while (s_start[b + 1] <= g) ++b;
      const int a = s_lo[b] + g - s_start[b];
      w = make_int4(wrap_up(base[3 * a] - c1 + kHalo + k1, k1),
                    wrap_up(base[3 * a + 1] - c2 + kHalo + k2, k2),
                    wrap_up(base[3 * a + 2] - c3 + kHalo + k3, k3), 0);
      keep = w.x < kT1 + kHalo && w.y < kT2 + kHalo && w.z < kT3 + kHalo;
      if (keep) id = perm[a];
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_kept[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u)), kept = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int c = s_kept[v];
      if (v < warp) slot += c;
      kept += c;
    }
    if (keep && slot < kRows) {
      s_w[slot] = w;
      s_id[slot] = id;
    }
    if (keep && slot == kRows) s_next = g;  // the first atom of the next chunk
    __syncthreads();
    // 3. their stencil rows, all copies in flight at once
    const int n = min(kept, kRows);
    if (vec16) {
      constexpr int kVec = kRow / 4;
      for (int p = tid; p < n * kVec; p += kThreads) {
        const int r = p / kVec, c = 4 * (p - r * kVec);
        cp_async16(s_q + r * kRow + c, q + static_cast<long long>(s_id[r]) * kRow + c);
      }
    } else {
      for (int p = tid; p < n * kRow; p += kThreads) {
        const int r = p / kRow, c = p - r * kRow;
        cp_async4(s_q + r * kRow + c, q + static_cast<long long>(s_id[r]) * kRow + c);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (live) {
      if (wide)
        accumulate<ORDER, NCH, true>(acc, s_q, s_w, n, py, pz, k1, k2, k3);
      else
        accumulate<ORDER, NCH, false>(acc, s_q, s_w, n, py, pz, k1, k2, k3);
    }
    r0 = kept > kRows ? s_next : r0 + kThreads;
    if (r0 < total) __syncthreads();  // the stage has been read
  }
  if (!live) return;
  const long long plane = static_cast<long long>(k1) * k2 * k3;
  const int p2 = c2 + py, p3 = c3 + pz;
#pragma unroll
  for (int x = 0; x < kT1; ++x) {
    const int p1 = c1 + x;
    if (p1 >= k1) break;
    const long long flat = (static_cast<long long>(p1) * k2 + p2) * k3 + p3;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) mesh[ch * plane + flat] = acc[ch][x];
  }
}

template <int ORDER, int NCH>
__global__ void __launch_bounds__(kThreads)
gather_tiled_kernel(const int* __restrict__ base, const int* __restrict__ perm,
                    const int* __restrict__ offsets, const float* __restrict__ mesh,
                    float* __restrict__ out, int k1, int k2, int k3, int nt2, int nt3) {
  constexpr int kPts = ORDER * ORDER * ORDER;
  constexpr int kHalo = ORDER - 1;
  constexpr int R1 = kT1 + kHalo, R2 = kT2 + kHalo, R3 = kT3 + kHalo;
  constexpr int kWin = R1 * R2 * R3;
  __shared__ float s_win[kWin];

  const int tile = blockIdx.x;
  const int lo = offsets[tile], hi = offsets[tile + 1];
  if (lo == hi) return;
  const int t3 = tile % nt3, t2 = (tile / nt3) % nt2, t1 = tile / (nt3 * nt2);
  const int c1 = t1 * kT1, c2 = t2 * kT2, c3 = t3 * kT3;
  const long long plane = static_cast<long long>(k1) * k2 * k3;
  const int n_out = (hi - lo) * kPts;

  for (int ch = 0; ch < NCH; ++ch) {
    if (ch) __syncthreads();  // the previous channel's reads are done
    const float* m = mesh + ch * plane;
    for (int r = threadIdx.x; r < kWin; r += kThreads) {
      const int r3 = r % R3, r2 = (r / R3) % R2, r1 = r / (R3 * R2);
      const long long g = (static_cast<long long>(wrap_up(c1 + r1, k1)) * k2 +
                           wrap_up(c2 + r2, k2)) * k3 + wrap_up(c3 + r3, k3);
      s_win[r] = m[g];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_out; k += kThreads) {
      const int a = lo + k / kPts, pt = k % kPts;
      const int l1 = base[3 * a] - c1 + pt / (ORDER * ORDER);
      const int l2 = base[3 * a + 1] - c2 + (pt / ORDER) % ORDER;
      const int l3 = base[3 * a + 2] - c3 + pt % ORDER;
      out[(static_cast<long long>(perm[a]) * NCH + ch) * kPts + pt] =
          s_win[(l1 * R2 + l2) * R3 + l3];
    }
  }
}

int n_tiles(int k, int t) { return (k + t - 1) / t; }

template <int ORDER, int NCH>
int launch_spread(const int* base, const int* perm, const int* offsets, const float* q,
                  float* mesh, int k1, int k2, int k3, cudaStream_t s) {
  const int nt1 = n_tiles(k1, kT1), nt2 = n_tiles(k2, kT2), nt3 = n_tiles(k3, kT3);
  const int vec16 = (reinterpret_cast<std::uintptr_t>(q) & 15) == 0;
  spread_tiled_kernel<ORDER, NCH><<<nt1 * nt2 * nt3, kThreads, 0, s>>>(
      base, perm, offsets, q, mesh, k1, k2, k3, nt1, nt2, nt3, vec16);
  return static_cast<int>(cudaGetLastError());
}

template <int ORDER, int NCH>
int launch_gather(const int* base, const int* perm, const int* offsets, const float* mesh,
                  float* out, int k1, int k2, int k3, cudaStream_t s) {
  const int nt1 = n_tiles(k1, kT1), nt2 = n_tiles(k2, kT2), nt3 = n_tiles(k3, kT3);
  gather_tiled_kernel<ORDER, NCH><<<nt1 * nt2 * nt3, kThreads, 0, s>>>(
      base, perm, offsets, mesh, out, k1, k2, k3, nt2, nt3);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admp_spread_tiled(const int* base, const int* perm, const int* offsets,
                                 const float* q, float* mesh, int n_ch, int order, int k1,
                                 int k2, int k3, int t1, int t2, int t3, void* stream) {
  if (t1 != kT1 || t2 != kT2 || t3 != kT3) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 6 && n_ch == 1) return launch_spread<6, 1>(base, perm, offsets, q, mesh, k1, k2, k3, s);
  if (order == 6 && n_ch == 3) return launch_spread<6, 3>(base, perm, offsets, q, mesh, k1, k2, k3, s);
  if (order == 4 && n_ch == 1) return launch_spread<4, 1>(base, perm, offsets, q, mesh, k1, k2, k3, s);
  if (order == 4 && n_ch == 3) return launch_spread<4, 3>(base, perm, offsets, q, mesh, k1, k2, k3, s);
  return -1;
}

extern "C" int admp_gather_tiled(const int* base, const int* perm, const int* offsets,
                                 const float* mesh, float* out, int n_ch, int order, int k1,
                                 int k2, int k3, int t1, int t2, int t3, void* stream) {
  if (t1 != kT1 || t2 != kT2 || t3 != kT3) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order == 6 && n_ch == 1) return launch_gather<6, 1>(base, perm, offsets, mesh, out, k1, k2, k3, s);
  if (order == 6 && n_ch == 3) return launch_gather<6, 3>(base, perm, offsets, mesh, out, k1, k2, k3, s);
  if (order == 4 && n_ch == 1) return launch_gather<4, 1>(base, perm, offsets, mesh, out, k1, k2, k3, s);
  if (order == 4 && n_ch == 3) return launch_gather<4, 3>(base, perm, offsets, mesh, out, k1, k2, k3, s);
  return -1;
}
