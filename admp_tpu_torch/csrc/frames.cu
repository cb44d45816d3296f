// Local frames and the rotation of the multipoles into the global frame (K8)
// of admp_tpu_torch, forward and backward, for sm_90a.
//
// Replaces, on the card, the plain chain of ops/frames.global_multipoles:
// local_frames_components (admp_tpu/ops/frames.py) and
// rot_local2global_components (ops/harmonics.py). admp_tpu has no Pallas
// kernel here: XLA fuses the chain on the TPU. Run op by op on the card, the
// chain is ~360 launches over every site, autograd's as many again, and the
// backward of its anchor gathers (positions[at]) is a deterministic
// index-put that accumulates duplicate rows one after another: every site
// without a y anchor stores -1, which the chain wraps to site n-1 and gathers
// for every site, so the backward adds N zero rows into that one row.
//
// One thread per site; each inverts the box in registers. frames_fwd_kernel
// reads the site's position, its axis type and only the anchors that type
// uses (ZThenX, Bisector: z, x; ZBisect,
// ThreeFold: z, x, y; ZOnly: z; NoAxisType: none), wraps each anchor index
// as Python does (-1 is site n-1), builds the frame in registers (the
// minimum-image wrap through inv(box), the bisector, z-bisect and three-fold
// rules, Gram-Schmidt, y = z x x), rotates the (lmax + 1)^2 local harmonics
// into the global frame and writes them: (N, (lmax + 1)^2) and nothing else.
// frames_bwd_kernel recomputes the frame and runs its reverse by hand: the
// transposed rotation gives the local multipoles' gradient, the rotation's
// derivative in the frame runs back through Gram-Schmidt, the rules, the
// normalisations and the wrap into the gradients of the site's and its
// anchors' positions (float atomics into a zeroed (N, 3); the C entry zeroes
// it on the stream) and of the box, the part through its inverse folded in
// (d inv = -inv d(box) inv; 9 sums per thread block in a fixed order, added
// up by the launcher). An anchor that a site does not use is never read or
// written.
//
// Built with --fmad=false (ops/cuda/build.py): each product and sum rounds on
// its own, as the plain chain's elementwise ops round them on the card, and
// the forward takes the chain's operations in its order, so that it is the
// chain's float32 result on the card bit for bit (the box inverse too, inv3).
//
// The plain chain's semantics, kept: a vector of squared norm under 1e-12
// normalises to zero with a zero gradient (its double where); ZOnly's x is
// unit x or unit y by the rounded (half to even) |z_x|, with no gradient;
// NoAxisType is the identity frame; an axis type outside 0..5 is ZThenX.
// Bound by bytes: each site reads its position, its anchors' positions, its
// type and anchors and (lmax + 1)^2 multipoles, and writes as many.
//
// C interface (ctypes; each entry returns cudaGetLastError(), or -1 for an
// lmax outside 0..2):
//   admp_frames_fwd(pos, box, q, types, anchors, out, N, lmax, stream)
//     pos (N, 3), box (3, 3), q (N, H) f32, types (N,) int64, anchors
//     (N, 3) int64 (z, x, y; -1 absent) -> out (N, H) f32, H = (lmax + 1)^2
//   admp_frames_bwd(pos, box, q, types, anchors, g, d_pos, d_q,
//                   d_box_blocks, N, lmax, stream)
//     g (N, H) f32, the cotangent of out -> d_pos (N, 3) (zeroed here),
//     d_q (N, H), d_box_blocks (ceil(N / admp_frames_block_size()), 9):
//     per block, the box's gradient; each output may be null, and is then
//     not computed
//   admp_frames_block_size() -> sites per thread block
//
// The per-site functions compile as host code too, behind a shim for the
// CUDA keywords (tests/test_torch_frames_kernel.py).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include <math.h>

#include <cstdint>

namespace {

constexpr int kBlock = 128;
constexpr int kNBox = 9;  // the box's gradient
constexpr int kBisector = 1, kZBisect = 2, kThreeFold = 3, kZOnly = 4, kNoAxis = 5;
constexpr float kEps = 1e-12f;
// ops/harmonics.py's RT3, truncated as there, and its two derived constants
constexpr float kRt3 = 1.73205080757f;
constexpr float kHalfRt3 = 1.73205080757 / 2.0;
constexpr float kInvHalfRt3 = 2.0 / 1.73205080757;
// x / RT3 as PyTorch's CUDA kernels divide a tensor by a scalar: the product
// with the scalar's float reciprocal
constexpr float kInvRt3 = 1.f / kRt3;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// 1 / |v|, or 0 where |v|^2 < 1e-12 (the plain chain's double where)
__device__ __forceinline__ float inv_norm(V3 v) {
  const float nsq = dot(v, v);
  return nsq < kEps ? 0.f : 1.f / sqrtf(nsq);
}

// the cotangent of v from that of v * inv_norm(v): zero where inv is 0
__device__ __forceinline__ V3 unit_bwd(V3 v, float inv, V3 ub) {
  const float t = dot(ub, v) * inv * inv * inv;
  return {inv * ub.x - t * v.x, inv * ub.y - t * v.y, inv * ub.z - t * v.z};
}

// r = inv(m), 3x3 row-major, by the adjugate as utils/linalg3.inv3x3 and
// bit for bit with it: each product, sum and quotient rounded on its own, as
// PyTorch's elementwise ops round them (no contraction into FMAs)
__device__ __forceinline__ float dif2(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));  // a b - c d
}

__device__ __forceinline__ void inv3(const float* m, float* r) {
  const float c00 = dif2(m[4], m[8], m[5], m[7]), c01 = dif2(m[5], m[6], m[3], m[8]),
              c02 = dif2(m[3], m[7], m[4], m[6]), c10 = dif2(m[2], m[7], m[1], m[8]),
              c11 = dif2(m[0], m[8], m[2], m[6]), c12 = dif2(m[1], m[6], m[0], m[7]),
              c20 = dif2(m[1], m[5], m[2], m[4]), c21 = dif2(m[2], m[3], m[0], m[5]),
              c22 = dif2(m[0], m[4], m[1], m[3]);
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(m[0], c00), __fmul_rn(m[1], c01)),
                              __fmul_rn(m[2], c02));
  const float adj[9] = {c00, c10, c20, c01, c11, c21, c02, c12, c22};
  for (int k = 0; k < 9; ++k) r[k] = __fdiv_rn(adj[k], det);
}

__device__ __forceinline__ int wrap_index(int64_t a, int n) {
  const int64_t r = a % n;
  return static_cast<int>(r < 0 ? r + n : r);
}

// One anchor's direction: the raw difference, its fractional coordinates
// before (sr) and after the minimum-image wrap, the wrapped difference and
// its 1 / norm.
struct Anchor {
  int at;
  V3 raw, sr, s, d;
  float inv;
};

__device__ __forceinline__ void anchor_fwd(const float* pos, V3 p, int at, const float* box,
                                           const float* binv, Anchor& a) {
  a.at = at;
  a.raw = {pos[3 * at] - p.x, pos[3 * at + 1] - p.y, pos[3 * at + 2] - p.z};
  float sr[3], s[3];
  for (int c = 0; c < 3; ++c) {
    sr[c] = a.raw.x * binv[c] + a.raw.y * binv[3 + c] + a.raw.z * binv[6 + c];
    s[c] = sr[c] - floorf(sr[c] + 0.5f);
  }
  a.sr = {sr[0], sr[1], sr[2]};
  a.s = {s[0], s[1], s[2]};
  a.d = {s[0] * box[0] + s[1] * box[3] + s[2] * box[6],
         s[0] * box[1] + s[1] * box[4] + s[2] * box[7],
         s[0] * box[2] + s[1] * box[5] + s[2] * box[8]};
  a.inv = inv_norm(a.d);
}

// The reverse of anchor_fwd at the unit vector's cotangent ub: returns the
// raw difference's cotangent r; with BOX adds the box's gradient to gb:
// s (x) db from d = s box, and from s = raw inv the inverse's raw (x) sb,
// which d inv = -inv d(box) inv turns into -(inv^T raw) (x) (inv sb) =
// -sr (x) r.
template <bool BOX>
__device__ __forceinline__ V3 anchor_bwd(const Anchor& a, V3 ub, const float* box,
                                         const float* binv, float* gb) {
  const V3 db = unit_bwd(a.d, a.inv, ub);
  float sb[3];
  for (int c = 0; c < 3; ++c) sb[c] = db.x * box[3 * c] + db.y * box[3 * c + 1] + db.z * box[3 * c + 2];
  const V3 r = {sb[0] * binv[0] + sb[1] * binv[1] + sb[2] * binv[2],
                sb[0] * binv[3] + sb[1] * binv[4] + sb[2] * binv[5],
                sb[0] * binv[6] + sb[1] * binv[7] + sb[2] * binv[8]};
  if (BOX) {
    const float dbv[3] = {db.x, db.y, db.z}, rv[3] = {r.x, r.y, r.z};
    const float sv[3] = {a.s.x, a.s.y, a.s.z}, srv[3] = {a.sr.x, a.sr.y, a.sr.z};
    for (int c = 0; c < 3; ++c)
      for (int k = 0; k < 3; ++k) gb[3 * c + k] += sv[c] * dbv[k] - srv[c] * rv[k];
  }
  return r;
}

// A site's frame and what its reverse needs. Rows ex, ey, ez are the local
// axes: v_local = F v_global.
struct Frame {
  int type;
  Anchor za, xa, ya;
  V3 sum;     // Bisector, ThreeFold: z before its normalisation; ZBisect: x
  float sum_inv;
  V3 z, x0;   // z and x before Gram-Schmidt
  float proj;
  V3 w;       // x0 - z (x0 . z)
  float w_inv;
  V3 ex, ey, ez;
};

__device__ __forceinline__ void frame_fwd(int i, int n, const float* pos, const int64_t* types,
                                          const int64_t* anchors, const float* box,
                                          const float* binv, Frame& f) {
  const int t = static_cast<int>(types[i]);
  f.type = t;
  if (t == kNoAxis) {
    f.ex = {1.f, 0.f, 0.f};
    f.ey = {0.f, 1.f, 0.f};
    f.ez = {0.f, 0.f, 1.f};
    return;
  }
  const V3 p = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2]};
  const int64_t* an = anchors + 3 * static_cast<int64_t>(i);
  anchor_fwd(pos, p, wrap_index(an[0], n), box, binv, f.za);
  const V3 zu = mul(f.za.d, f.za.inv);
  V3 xu;
  if (t == kZOnly) {
    const float r = rintf(fabsf(zu.x));
    xu = {1.f - r, r, 0.f};
  } else {
    anchor_fwd(pos, p, wrap_index(an[1], n), box, binv, f.xa);
    xu = mul(f.xa.d, f.xa.inv);
  }
  V3 z = zu, x = xu;
  if (t == kBisector) {
    f.sum = add(zu, xu);
    f.sum_inv = inv_norm(f.sum);
    z = mul(f.sum, f.sum_inv);
  } else if (t == kZBisect || t == kThreeFold) {
    anchor_fwd(pos, p, wrap_index(an[2], n), box, binv, f.ya);
    const V3 yu = mul(f.ya.d, f.ya.inv);
    f.sum = t == kZBisect ? add(xu, yu) : add(add(zu, xu), yu);
    f.sum_inv = inv_norm(f.sum);
    if (t == kZBisect)
      x = mul(f.sum, f.sum_inv);
    else
      z = mul(f.sum, f.sum_inv);
  }
  f.z = z;
  f.x0 = x;
  f.proj = dot(x, z);
  f.w = sub(x, mul(z, f.proj));
  f.w_inv = inv_norm(f.w);
  f.ex = mul(f.w, f.w_inv);
  f.ez = z;
  f.ey = cross(z, f.ex);
}

__device__ __forceinline__ void add3(float* p, V3 v) {
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
}

// The reverse of frame_fwd at the rows' cotangents: the positions' gradient
// into d_pos (atomics; skipped where d_pos is null), with BOX the box's into
// gb.
template <bool BOX>
__device__ __forceinline__ void frame_bwd(int i, const Frame& f, V3 exb, V3 eyb, V3 ezb,
                                          const float* box, const float* binv, float* d_pos,
                                          float* gb) {
  const int t = f.type;
  if (t == kNoAxis) return;
  // ey = ez x ex
  V3 zb = add(ezb, cross(f.ex, eyb));
  exb = add(exb, cross(eyb, f.z));
  // ex = w / |w|, w = x0 - z proj, proj = x0 . z
  const V3 wb = unit_bwd(f.w, f.w_inv, exb);
  const float pb = -dot(wb, f.z);
  V3 x0b = add(wb, mul(f.z, pb));
  zb = add(sub(zb, mul(wb, f.proj)), mul(f.x0, pb));
  // the rules
  V3 zub = zb, xub = x0b, yub = {0.f, 0.f, 0.f};
  if (t == kBisector) {
    const V3 sb = unit_bwd(f.sum, f.sum_inv, zb);
    zub = sb;
    xub = add(x0b, sb);
  } else if (t == kZBisect) {
    const V3 sb = unit_bwd(f.sum, f.sum_inv, x0b);
    xub = sb;
    yub = sb;
  } else if (t == kThreeFold) {
    const V3 sb = unit_bwd(f.sum, f.sum_inv, zb);
    zub = sb;
    xub = add(x0b, sb);
    yub = sb;
  }
  // the anchors: d(raw) = d(pos[at]) - d(pos[i])
  V3 self = {0.f, 0.f, 0.f};
  V3 r = anchor_bwd<BOX>(f.za, zub, box, binv, gb);
  if (d_pos) add3(d_pos + 3 * static_cast<int64_t>(f.za.at), r);
  self = sub(self, r);
  if (t != kZOnly) {
    r = anchor_bwd<BOX>(f.xa, xub, box, binv, gb);
    if (d_pos) add3(d_pos + 3 * static_cast<int64_t>(f.xa.at), r);
    self = sub(self, r);
  }
  if (t == kZBisect || t == kThreeFold) {
    r = anchor_bwd<BOX>(f.ya, yub, box, binv, gb);
    if (d_pos) add3(d_pos + 3 * static_cast<int64_t>(f.ya.at), r);
    self = sub(self, r);
  }
  if (d_pos) add3(d_pos + 3 * static_cast<int64_t>(i), self);
}

// G = F^T (G[a][k] = F[k][a]): the rotation from the local into the global
// frame acts on Cartesian vectors as v' = G v and on tensors as T' = G T G^T
__device__ __forceinline__ void transpose_frame(const Frame& f, float G[3][3]) {
  const V3 e[3] = {f.ex, f.ey, f.ez};
  for (int k = 0; k < 3; ++k) {
    G[0][k] = e[k].x;
    G[1][k] = e[k].y;
    G[2][k] = e[k].z;
  }
}

// the traceless quadrupole tensor of the l = 2 harmonics q[4..9)
__device__ __forceinline__ void quad_tensor(const float* q, float T[3][3]) {
  const float q20 = q[4], q21c = q[5], q21s = q[6], q22c = q[7], q22s = q[8];
  T[0][0] = -0.5f * q20 + kHalfRt3 * q22c;
  T[1][1] = -0.5f * q20 - kHalfRt3 * q22c;
  T[2][2] = q20;
  T[0][1] = T[1][0] = kHalfRt3 * q22s;
  T[0][2] = T[2][0] = kHalfRt3 * q21c;
  T[1][2] = T[2][1] = kHalfRt3 * q21s;
}

// harmonic order [Q00, Q10(z), Q11c(x), Q11s(y), Q20, Q21c, Q21s, Q22c, Q22s]
template <int LMAX>
__device__ __forceinline__ void rotate_fwd(const float G[3][3], const float* q, float* out) {
  out[0] = q[0];
  if (LMAX >= 1) {
    const float c[3] = {q[2], q[3], q[1]};
    float l[3];
    for (int a = 0; a < 3; ++a) l[a] = G[a][0] * c[0] + G[a][1] * c[1] + G[a][2] * c[2];
    out[1] = l[2];
    out[2] = l[0];
    out[3] = l[1];
  }
  if (LMAX >= 2) {
    float T[3][3], U[3][3], Tp[3][3];
    quad_tensor(q, T);
    for (int a = 0; a < 3; ++a)
      for (int j = 0; j < 3; ++j) U[a][j] = G[a][0] * T[0][j] + G[a][1] * T[1][j] + G[a][2] * T[2][j];
    for (int a = 0; a < 3; ++a)
      for (int b = a; b < 3; ++b) Tp[a][b] = U[a][0] * G[b][0] + U[a][1] * G[b][1] + U[a][2] * G[b][2];
    out[4] = Tp[2][2];
    out[5] = kInvHalfRt3 * Tp[0][2];
    out[6] = kInvHalfRt3 * Tp[1][2];
    out[7] = (Tp[0][0] - Tp[1][1]) * kInvRt3;
    out[8] = kInvHalfRt3 * Tp[0][1];
  }
}

// The reverse of rotate_fwd at the cotangent g: the local multipoles'
// gradient into dq (skipped where null) and G's added into Gb.
template <int LMAX>
__device__ __forceinline__ void rotate_bwd(const float G[3][3], const float* q, const float* g,
                                           float* dq, float Gb[3][3]) {
  float d[9];
  d[0] = g[0];
  if (LMAX >= 1) {
    const float c[3] = {q[2], q[3], q[1]};
    const float lb[3] = {g[2], g[3], g[1]};
    float cb[3];
    for (int k = 0; k < 3; ++k) {
      cb[k] = G[0][k] * lb[0] + G[1][k] * lb[1] + G[2][k] * lb[2];
      for (int a = 0; a < 3; ++a) Gb[a][k] += lb[a] * c[k];
    }
    d[1] = cb[2];
    d[2] = cb[0];
    d[3] = cb[1];
  }
  if (LMAX >= 2) {
    float T[3][3], U[3][3];
    quad_tensor(q, T);
    for (int a = 0; a < 3; ++a)
      for (int j = 0; j < 3; ++j) U[a][j] = G[a][0] * T[0][j] + G[a][1] * T[1][j] + G[a][2] * T[2][j];
    // the cotangent of T' (upper triangle: the entries the outputs read)
    float Tpb[3][3] = {{g[7] / kRt3, kInvHalfRt3 * g[8], kInvHalfRt3 * g[5]},
                       {0.f, -g[7] / kRt3, kInvHalfRt3 * g[6]},
                       {0.f, 0.f, g[4]}};
    // T'[a][b] = sum_j U[a][j] G[b][j]
    float Ub[3][3];
    for (int a = 0; a < 3; ++a)
      for (int j = 0; j < 3; ++j) {
        Ub[a][j] = Tpb[a][0] * G[0][j] + Tpb[a][1] * G[1][j] + Tpb[a][2] * G[2][j];
        Gb[a][j] += Tpb[0][a] * U[0][j] + Tpb[1][a] * U[1][j] + Tpb[2][a] * U[2][j];
      }
    // U[a][j] = sum_k G[a][k] T[k][j]
    float Tb[3][3];
    for (int k = 0; k < 3; ++k)
      for (int j = 0; j < 3; ++j) Tb[k][j] = G[0][k] * Ub[0][j] + G[1][k] * Ub[1][j] + G[2][k] * Ub[2][j];
    for (int a = 0; a < 3; ++a)
      for (int k = 0; k < 3; ++k) Gb[a][k] += Ub[a][0] * T[k][0] + Ub[a][1] * T[k][1] + Ub[a][2] * T[k][2];
    d[4] = -0.5f * Tb[0][0] - 0.5f * Tb[1][1] + Tb[2][2];
    d[5] = kHalfRt3 * (Tb[0][2] + Tb[2][0]);
    d[6] = kHalfRt3 * (Tb[1][2] + Tb[2][1]);
    d[7] = kHalfRt3 * Tb[0][0] - kHalfRt3 * Tb[1][1];
    d[8] = kHalfRt3 * (Tb[0][1] + Tb[1][0]);
  }
  if (dq)
    for (int k = 0; k < (LMAX + 1) * (LMAX + 1); ++k) dq[k] = d[k];
}

// The forward of one site: its global multipoles into out[i].
template <int LMAX>
__device__ __forceinline__ void frames_site_fwd(int i, int n, const float* pos, const float* box,
                                                const float* binv, const float* q,
                                                const int64_t* types, const int64_t* anchors,
                                                float* out) {
  constexpr int H = (LMAX + 1) * (LMAX + 1);
  const int64_t r = static_cast<int64_t>(i) * H;
  float G[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
  if (LMAX > 0) {
    Frame f;
    frame_fwd(i, n, pos, types, anchors, box, binv, f);
    transpose_frame(f, G);
  }
  float o[H];
  rotate_fwd<LMAX>(G, q + r, o);
  for (int k = 0; k < H; ++k) out[r + k] = o[k];
}

// The backward of one site: dq[i], the positions' gradient (atomics) and,
// with BOX, the box's added into gb.
template <int LMAX, bool BOX>
__device__ __forceinline__ void frames_site_bwd(int i, int n, const float* pos, const float* box,
                                                const float* binv, const float* q,
                                                const int64_t* types, const int64_t* anchors,
                                                const float* g, float* d_pos, float* dq,
                                                float* gb) {
  constexpr int H = (LMAX + 1) * (LMAX + 1);
  const int64_t r = static_cast<int64_t>(i) * H;
  float G[3][3] = {{1.f, 0.f, 0.f}, {0.f, 1.f, 0.f}, {0.f, 0.f, 1.f}};
  Frame f;
  if (LMAX > 0) {
    frame_fwd(i, n, pos, types, anchors, box, binv, f);
    transpose_frame(f, G);
  }
  float Gb[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  rotate_bwd<LMAX>(G, q + r, g + r, dq ? dq + r : nullptr, Gb);
  if (LMAX > 0 && (d_pos || BOX)) {
    // Gb -> the rows' cotangents: G[a][k] = F[k][a]
    const V3 exb = {Gb[0][0], Gb[1][0], Gb[2][0]};
    const V3 eyb = {Gb[0][1], Gb[1][1], Gb[2][1]};
    const V3 ezb = {Gb[0][2], Gb[1][2], Gb[2][2]};
    frame_bwd<BOX>(i, f, exb, eyb, ezb, box, binv, d_pos, gb);
  }
}

#ifdef __CUDACC__

template <int LMAX>
__global__ void __launch_bounds__(kBlock)
    frames_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ box,
                      const float* __restrict__ q,
                      const int64_t* __restrict__ types, const int64_t* __restrict__ anchors,
                      float* __restrict__ out, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  float bx[9], bi[9];
  for (int k = 0; k < 9; ++k) bx[k] = box[k];
  inv3(bx, bi);
  frames_site_fwd<LMAX>(i, n, pos, bx, bi, q, types, anchors, out);
}

template <int LMAX, bool BOX>
__global__ void __launch_bounds__(kBlock)
    frames_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ box,
                      const float* __restrict__ q,
                      const int64_t* __restrict__ types, const int64_t* __restrict__ anchors,
                      const float* __restrict__ g, float* d_pos, float* __restrict__ dq,
                      float* __restrict__ d_box_blocks, int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  float bx[9], bi[9];
  for (int k = 0; k < 9; ++k) bx[k] = box[k];
  inv3(bx, bi);
  float gb[kNBox];
  for (int k = 0; k < kNBox; ++k) gb[k] = 0.f;
  if (i < n) frames_site_bwd<LMAX, BOX>(i, n, pos, bx, bi, q, types, anchors, g, d_pos, dq, gb);
  if (!BOX) return;
  // the block's sums of the 9 box scalars, in a fixed order
  __shared__ float part[kBlock / 32][kNBox];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k = 0; k < kNBox; ++k) {
    float v = gb[k];
    for (int o = 16; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kNBox) {
    float s = 0.f;
    for (int w = 0; w < kBlock / 32; ++w) s += part[w][threadIdx.x];
    d_box_blocks[static_cast<int64_t>(blockIdx.x) * kNBox + threadIdx.x] = s;
  }
}

template <int LMAX>
void launch_bwd(const float* pos, const float* box, const float* q, const int64_t* types,
                const int64_t* anchors, const float* g, float* d_pos, float* dq,
                float* d_box_blocks, int n, cudaStream_t s) {
  const int blocks = (n + kBlock - 1) / kBlock;
  if (d_box_blocks)
    frames_bwd_kernel<LMAX, true><<<blocks, kBlock, 0, s>>>(pos, box, q, types, anchors, g, d_pos,
                                                             dq, d_box_blocks, n);
  else
    frames_bwd_kernel<LMAX, false><<<blocks, kBlock, 0, s>>>(pos, box, q, types, anchors, g,
                                                              d_pos, dq, nullptr, n);
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

extern "C" int admp_frames_block_size() { return kBlock; }

extern "C" int admp_frames_fwd(const float* pos, const float* box, const float* q,
                               const int64_t* types, const int64_t* anchors, float* out, int n,
                               int lmax, void* stream) {
  if (lmax < 0 || lmax > 2) return -1;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kBlock - 1) / kBlock;
  if (lmax == 0)
    frames_fwd_kernel<0><<<blocks, kBlock, 0, s>>>(pos, box, q, types, anchors, out, n);
  else if (lmax == 1)
    frames_fwd_kernel<1><<<blocks, kBlock, 0, s>>>(pos, box, q, types, anchors, out, n);
  else
    frames_fwd_kernel<2><<<blocks, kBlock, 0, s>>>(pos, box, q, types, anchors, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int admp_frames_bwd(const float* pos, const float* box, const float* q,
                               const int64_t* types, const int64_t* anchors, const float* g,
                               float* d_pos, float* dq, float* d_box_blocks, int n, int lmax,
                               void* stream) {
  if (lmax < 0 || lmax > 2) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_pos) cudaMemsetAsync(d_pos, 0, sizeof(float) * 3 * static_cast<size_t>(n), s);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (lmax == 0)
    launch_bwd<0>(pos, box, q, types, anchors, g, d_pos, dq, d_box_blocks, n, s);
  else if (lmax == 1)
    launch_bwd<1>(pos, box, q, types, anchors, g, d_pos, dq, d_box_blocks, n, s);
  else
    launch_bwd<2>(pos, box, q, types, anchors, g, d_pos, dq, d_box_blocks, n, s);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
