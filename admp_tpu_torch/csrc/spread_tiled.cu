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
// thread (y, z) owns the kT1 points of one x-column in registers. The block
// walks the bins of the tiles whose atoms can reach its core (the bases in
// [c - order + 1, c + kT - 1] mod K on each axis), stages their bases and
// atom ids in shared memory, and each thread adds the stencil values of
// every staged atom that covers its points. The sum at a point runs over
// the bins in a fixed order and over the atoms in sorted order: the mesh is
// the same on every run. TPU buckets had capacities and a scatter fallback
// on overflow (spread.py:846-850); here a block loops over however many
// atoms its bins hold.
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
// Bound on the card: bytes. K5 reads the stencil values (N C order^3 f32)
// and writes the whole mesh once; K7 reads each core tile with its halo,
// (1 + (order-1)/kT)^3 of the mesh (~3x at order 6), and writes
// N C order^3 values. Flat mesh offsets are 64-bit (3 x 320^3 = 98M).
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

namespace {

constexpr int kT1 = 8, kT2 = 8, kT3 = 32;  // core tile (x, y, z)
constexpr int kThreads = kT2 * kT3;        // K5: one thread per (y, z) column
constexpr int kStage = kThreads;           // atoms staged per pass

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

template <int ORDER, int NCH>
__global__ void __launch_bounds__(kThreads)
spread_tiled_kernel(const int* __restrict__ base, const int* __restrict__ perm,
                    const int* __restrict__ offsets, const float* __restrict__ q,
                    float* __restrict__ mesh, int k1, int k2, int k3, int nt1, int nt2,
                    int nt3) {
  constexpr int kPts = ORDER * ORDER * ORDER;
  constexpr int kHalo = ORDER - 1;
  __shared__ int s_b1[kStage], s_b2[kStage], s_b3[kStage], s_id[kStage];

  const int tile = blockIdx.x;
  const int t3 = tile % nt3, t2 = (tile / nt3) % nt2, t1 = tile / (nt3 * nt2);
  const int c1 = t1 * kT1, c2 = t2 * kT2, c3 = t3 * kT3;
  const int p2 = c2 + static_cast<int>(threadIdx.x) / kT3;
  const int p3 = c3 + static_cast<int>(threadIdx.x) % kT3;
  const bool live = p2 < k2 && p3 < k3;

  float acc[NCH][kT1];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int x = 0; x < kT1; ++x) acc[ch][x] = 0.f;

  int f1, n1, f2, n2, f3, n3;
  source_tiles(t1, kT1, k1, nt1, kHalo, f1, n1);
  source_tiles(t2, kT2, k2, nt2, kHalo, f2, n2);
  source_tiles(t3, kT3, k3, nt3, kHalo, f3, n3);

  for (int s1 = 0; s1 < n1; ++s1) {
    const int u1 = (f1 + s1) % nt1;
    for (int s2 = 0; s2 < n2; ++s2) {
      const int u2 = (f2 + s2) % nt2;
      for (int s3 = 0; s3 < n3; ++s3) {
        const int src = (u1 * nt2 + u2) * nt3 + (f3 + s3) % nt3;
        const int lo = offsets[src], hi = offsets[src + 1];
        for (int a0 = lo; a0 < hi; a0 += kStage) {
          const int na = min(kStage, hi - a0);
          __syncthreads();  // the previous pass has finished reading the stage
          if (static_cast<int>(threadIdx.x) < na) {
            const int a = a0 + threadIdx.x;
            s_b1[threadIdx.x] = base[3 * a];
            s_b2[threadIdx.x] = base[3 * a + 1];
            s_b3[threadIdx.x] = base[3 * a + 2];
            s_id[threadIdx.x] = perm[a];
          }
          __syncthreads();
          if (!live) continue;
          for (int a = 0; a < na; ++a) {
            int dy = p2 - s_b2[a];
            if (dy < 0) dy += k2;
            if (dy >= ORDER) continue;
            int dz = p3 - s_b3[a];
            if (dz < 0) dz += k3;
            if (dz >= ORDER) continue;
            int dx0 = c1 - s_b1[a];
            if (dx0 < 0) dx0 += k1;
            const float* qa = q + static_cast<long long>(s_id[a]) * NCH * kPts;
            // an axis shorter than the stencil covers a point more than once
            for (int yy = dy; yy < ORDER; yy += k2) {
              for (int zz = dz; zz < ORDER; zz += k3) {
#pragma unroll
                for (int x = 0; x < kT1; ++x) {
                  for (int xx = wrap_up(dx0 + x, k1); xx < ORDER; xx += k1) {
                    const int pt = (xx * ORDER + yy) * ORDER + zz;
#pragma unroll
                    for (int ch = 0; ch < NCH; ++ch) acc[ch][x] += qa[ch * kPts + pt];
                  }
                }
              }
            }
          }
        }
      }
    }
  }
  if (!live) return;
  const long long plane = static_cast<long long>(k1) * k2 * k3;
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
  spread_tiled_kernel<ORDER, NCH><<<nt1 * nt2 * nt3, kThreads, 0, s>>>(
      base, perm, offsets, q, mesh, k1, k2, k3, nt1, nt2, nt3);
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
