// Fused real-space pair kernels of admp_tpu_torch, for sm_90a.
//
// K1 pair_fwd_kernel replaces admp_tpu/ops/pallas/pairs.py _make_fwd_kernel
// (:330); K2 pair_bwd_kernel replaces _make_bwd_kernel (:343). One thread per
// pair. The per-pair energy (pair_energy below) is written once, templated
// over its scalar type: `float` in the forward, Dual<kTangents> (forward-mode
// dual numbers) in the backward, which re-runs it in ceil(NV / kTangents)
// passes, each seeding kTangents of the pair's NV independent inputs (the
// wrapped displacement, both sites' features, the differentiable scale rows
// and kappa). The minimum-image wrap is chain-ruled by hand: floor() has zero
// derivative, so the position gradient is (binv . box)-mapped dE/dd and the
// box / box-inverse gradients follow from the fractional coordinates.
//
// Bound on the card: arithmetic and registers, not bytes. A pair reads
// 2F+3 floats and writes one (forward) or 2F+n_scl (backward); the dual
// passes multiply the forward arithmetic by ~(kTangents+1) * passes and spill
// the dual arrays to local memory (L1-resident). The scalar gradients are
// reduced per block in a fixed order (warp shuffles, then shared memory) into
// an (n_blocks, 19) buffer that the wrapper sums: deterministic, no atomics.
//
// C interface (loaded with ctypes; each entry returns cudaGetLastError(), or
// -1 for an unsupported (kind, lmax)):
//   admp_pair_fwd(gi, gj, scl, scal, e, C, kind, lmax, stream)
//   admp_pair_bwd(gi, gj, scl, scal, ct, dgi, dgj, dscl, dscal_blocks,
//                 C, kind, lmax, stream)
//   admp_pair_block_size()
// kind: 0 'perm', 1 'pol', 2 'uu'. Row layouts are documented in
// admp_tpu_torch/ops/cuda/pairs.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;
constexpr int kNScal = 19;
constexpr int kTangents = 4;

constexpr int kPerm = 0;
constexpr int kPol = 1;
constexpr int kUU = 2;

constexpr float kDielectric = 1389.35455846f;
constexpr float kSqrtPi = 1.7724538509055159f;
constexpr float kTholeWidth = 0.3f;
constexpr float kRt3 = 1.73205080757f;  // ops/harmonics.RT3 (truncated)
constexpr float kInvRt3x2 = static_cast<float>(2.0 / 1.73205080757);
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kTwoOverSqrtPi = static_cast<float>(2.0 / 1.7724538509055159);

// ---------------------------------------------------------------------------
// Forward-mode dual numbers
// ---------------------------------------------------------------------------

template <int N>
struct Dual {
  float v;
  float d[N];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(float x) : v(x) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = 0.f;
  }
};

template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v + b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(float a, const Dual<N>& b) {
  Dual<N> r = b;
  r.v = a + b.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(const Dual<N>& a, float b) {
  Dual<N> r = a;
  r.v = a.v - b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float a, const Dual<N>& b) {
  return b * a;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
  const float inv = 1.f / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(const Dual<N>& a, float b) {
  Dual<N> r;
  r.v = a.v / b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / b;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a / b.v;
  const float g = -r.v / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = g * b.d[k];
  return r;
}

// Elementary functions: the float overloads are the forward's, the Dual
// overloads carry the exact derivative of the same call.
__device__ __forceinline__ float val(float x) { return x; }
template <int N>
__device__ __forceinline__ float val(const Dual<N>& x) { return x.v; }

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ float derfc(float x) { return erfcf(x); }
__device__ __forceinline__ float dpow(float x, float p) { return powf(x, p); }

template <int N>
__device__ __forceinline__ Dual<N> scale_tangent(float v, float g, const Dual<N>& x) {
  Dual<N> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = g * x.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dsqrt(const Dual<N>& x) {
  const float s = sqrtf(x.v);
  return scale_tangent(s, 0.5f / s, x);
}
template <int N>
__device__ __forceinline__ Dual<N> dexp(const Dual<N>& x) {
  const float e = expf(x.v);
  return scale_tangent(e, e, x);
}
template <int N>
__device__ __forceinline__ Dual<N> derfc(const Dual<N>& x) {
  return scale_tangent(erfcf(x.v), -kTwoOverSqrtPi * expf(-x.v * x.v), x);
}
template <int N>
__device__ __forceinline__ Dual<N> dpow(const Dual<N>& x, float p) {
  const float v = powf(x.v, p);
  return scale_tangent(v, p * v / x.v, x);
}

// ---------------------------------------------------------------------------
// The per-pair energy (same physics as admp_tpu_torch/ops/realspace.py)
// ---------------------------------------------------------------------------

template <int KIND, int LMAX>
struct Layout {
  static constexpr int NH = (LMAX + 1) * (LMAX + 1);
  // table columns: x, y, z + features
  static constexpr int F = KIND == kUU ? 8 : 3 + NH + (KIND == kPol ? 5 : 0);
  static constexpr int NF = F - 3;
  static constexpr int NSCL = KIND == kPol ? 3 : 2;  // rows of scl
  // differentiable scale rows: s[0] <- row 0 (mscale; pscale for 'uu'),
  // s[1] <- row 2 (pscale, 'pol'); row 1 is the mask
  static constexpr int NS = KIND == kPol ? 2 : 1;
  // independent inputs of one pair: wrapped d(3), both sites' features,
  // the scale rows, kappa
  static constexpr int NV = 3 + 2 * NF + NS + 1;
};

__device__ __forceinline__ int scale_row(int k) { return k == 0 ? 0 : 2; }

template <class T, int LMAX>
__device__ __forceinline__ void rotate_harm(const T* q, const T* f, T* out) {
  out[0] = q[0];
  if constexpr (LMAX >= 1) {
    const T cx = q[2], cy = q[3], cz = q[1];
    out[2] = f[0] * cx + f[1] * cy + f[2] * cz;
    out[3] = f[3] * cx + f[4] * cy + f[5] * cz;
    out[1] = f[6] * cx + f[7] * cy + f[8] * cz;
  }
  if constexpr (LMAX >= 2) {
    const float h = kRt3 / 2.0f;
    const T txx = -0.5f * q[4] + h * q[7];
    const T tyy = -0.5f * q[4] - h * q[7];
    const T tzz = q[4];
    const T txy = h * q[8];
    const T txz = h * q[5];
    const T tyz = h * q[6];
    // T' = F T F^T via u[a] = F[a] . T (T symmetric)
    const T ux_x = f[0] * txx + f[1] * txy + f[2] * txz;
    const T ux_y = f[0] * txy + f[1] * tyy + f[2] * tyz;
    const T ux_z = f[0] * txz + f[1] * tyz + f[2] * tzz;
    const T uy_x = f[3] * txx + f[4] * txy + f[5] * txz;
    const T uy_y = f[3] * txy + f[4] * tyy + f[5] * tyz;
    const T uy_z = f[3] * txz + f[4] * tyz + f[5] * tzz;
    const T uz_x = f[6] * txx + f[7] * txy + f[8] * txz;
    const T uz_y = f[6] * txy + f[7] * tyy + f[8] * tyz;
    const T uz_z = f[6] * txz + f[7] * tyz + f[8] * tzz;
    const T tpxx = ux_x * f[0] + ux_y * f[1] + ux_z * f[2];
    const T tpyy = uy_x * f[3] + uy_y * f[4] + uy_z * f[5];
    const T tpzz = uz_x * f[6] + uz_y * f[7] + uz_z * f[8];
    const T tpxy = ux_x * f[3] + ux_y * f[4] + ux_z * f[5];
    const T tpxz = ux_x * f[6] + ux_y * f[7] + ux_z * f[8];
    const T tpyz = uy_x * f[6] + uy_y * f[7] + uy_z * f[8];
    out[4] = tpzz;
    out[5] = kInvRt3x2 * tpxz;
    out[6] = kInvRt3x2 * tpyz;
    out[7] = (tpxx - tpyy) / kRt3;
    out[8] = kInvRt3x2 * tpxy;
  }
}

// harmonic-order (z, x, y) dipole -> QI frame, harmonic order
template <class T>
__device__ __forceinline__ void rotate_dipole(const T* u, const T* f, T* out) {
  const T cx = u[1], cy = u[2], cz = u[0];
  out[1] = f[0] * cx + f[1] * cy + f[2] * cz;
  out[2] = f[3] * cx + f[4] * cy + f[5] * cz;
  out[0] = f[6] * cx + f[7] * cy + f[8] * cz;
}

template <class T>
__device__ __forceinline__ T damping_width(const T& pol_i, const T& pol_j) {
  const T prod = pol_i * pol_j;
  if (val(prod) <= 1e-36f) return T(1e-6f);
  return dpow(prod, 1.0f / 6.0f);
}

template <class T>
__device__ __forceinline__ T thole_width(const T& pscale, const T& t1, const T& t2) {
  const T uu = (pscale - 1e-3f) / 1e-5f;
  T clipped = uu;
  if (val(uu) < -60.f) clipped = T(-60.f);
  if (val(uu) > 60.f) clipped = T(60.f);
  const T w0 = 1.0f / (dexp(clipped) + 1.0f);
  return w0 * kTholeWidth + (1.0f - w0) * (t1 + t2);
}

// a * min(r / max(dmp, 1e-8), 1e8)
template <class T>
__device__ __forceinline__ T thole_argument(const T& r, const T& dmp, const T& a) {
  const T dmp_safe = val(dmp) > 1e-8f ? dmp : T(1e-8f);
  T u = r / dmp_safe;
  if (val(u) > 1e8f) u = T(1e8f);
  return a * u;
}

template <class T>
__device__ __forceinline__ T exp_damping(const T& au) {
  return val(au) < 50.f ? dexp(-au) : T(0.f);
}

template <class T>
struct PermCoef {
  T cc, cd, dd0, dd1, cq, dq0, dq1, qq0, qq1, qq2;
};

template <class T, int LMAX>
__device__ __forceinline__ void perm_coefficients(const T& r, const T& kr, const T& x,
                                                  const T& mscale, PermCoef<T>& c) {
  const T r_inv = 1.0f / r;
  const T d1 = kDielectric * r_inv;
  const T d2 = d1 * r_inv;
  const T d3 = d2 * r_inv;
  const T d4 = d3 * r_inv;
  const T d5 = d4 * r_inv;
  const T kr2 = kr * kr;
  const T kr3 = kr2 * kr;
  const T kr5 = kr3 * kr2;
  const T s2 = (mscale - 1.0f) + derfc(kr);
  const T s2x = s2 + kr * x;
  const T s3 = s2x + (2.0f / 3.0f) * kr3 * x;
  const T s4 = s3 + (4.0f / 15.0f) * kr5 * x;
  c.cc = d1 * s2;
  if constexpr (LMAX >= 1) {
    c.cd = d2 * s2x;
    c.dd0 = (-2.0f / 3.0f) * d3 * (3.0f * s3 + kr3 * x);
    c.dd1 = d3 * s2x;
  }
  if constexpr (LMAX >= 2) {
    c.cq = d3 * s3;
    c.dq0 = d4 * (3.0f * s3 + (4.0f / 3.0f) * kr5 * x);
    c.dq1 = (-kSqrt3) * d4 * s3;
    c.qq0 = d5 * (6.0f * s4 + (4.0f / 45.0f) * (-3.0f + 10.0f * kr2) * kr5 * x);
    c.qq1 = (-(4.0f / 15.0f)) * d5 * (15.0f * s4 + kr5 * x);
    c.qq2 = d5 * s3;
  }
}

template <class T, int LMAX>
__device__ __forceinline__ T energy_perm(const T* qi, const T* qj, const PermCoef<T>& c) {
  T e = c.cc * qj[0] * qi[0];
  if constexpr (LMAX >= 1) {
    e = e + c.cd * (qj[1] * qi[0] - qj[0] * qi[1]);
    e = e + c.dd0 * qj[1] * qi[1];
    e = e + c.dd1 * (qj[2] * qi[2] + qj[3] * qi[3]);
  }
  if constexpr (LMAX >= 2) {
    e = e + c.cq * (qj[0] * qi[4] + qj[4] * qi[0]);
    e = e + c.dq0 * (qj[1] * qi[4] - qj[4] * qi[1]);
    e = e + c.dq1 * (qj[2] * qi[5] - qj[5] * qi[2] + qj[3] * qi[6] - qj[6] * qi[3]);
    e = e + c.qq0 * qj[4] * qi[4];
    e = e + c.qq1 * (qj[5] * qi[5] + qj[6] * qi[6]);
    e = e + c.qq2 * (qj[7] * qi[7] + qj[8] * qi[8]);
  }
  return e;
}

template <class T>
struct IndCoef {
  T cud, dud0, dud1, udq0, udq1, udud0, udud1;
};

template <class T, int LMAX>
__device__ __forceinline__ void induced_coefficients(const T& r, const T& t1, const T& t2,
                                                     const T& dmp, const T& pscale,
                                                     const T& kappa, IndCoef<T>& c) {
  const T au = thole_argument(r, dmp, thole_width(pscale, t1, t2));
  const T exp_au = exp_damping(au);
  const T au2 = au * au;
  const T au3 = au2 * au;
  const T au4 = au3 * au;
  const T tcm = -exp_au * (1.0f + au + 0.5f * au2);
  const T td0m = -exp_au * (1.0f + au + 0.5f * au2 + au3 / 4.0f);
  const T tq0m = -exp_au * (1.0f + au + 0.5f * au2 + au3 / 6.0f + au4 / 18.0f);
  const T tq1m = -exp_au * (1.0f + au + 0.5f * au2 + au3 / 6.0f);
  const T r_inv = 1.0f / r;
  const T d2 = kDielectric * r_inv * r_inv;
  const T d3 = d2 * r_inv;
  const T d4 = d3 * r_inv;
  const T kr = kappa * r;
  const T kr2 = kr * kr;
  const T kr3 = kr2 * kr;
  const T kr5 = kr3 * kr2;
  const T x = 2.0f * dexp(-kr2) / kSqrtPi;
  const T ps1 = pscale - 1.0f;
  const T e2 = derfc(kr) + kr * x;
  const T e3 = e2 + (2.0f / 3.0f) * kr3 * x;
  c.cud = 2.0f * d2 * (pscale * tcm + ps1 + e2);
  if constexpr (LMAX >= 1) {
    c.dud0 = (-4.0f / 3.0f) * d3 * (3.0f * (pscale * td0m + ps1 + e3) + kr3 * x);
    c.dud1 = 2.0f * d3 * (pscale * tcm + ps1 + e2);
  }
  if constexpr (LMAX >= 2) {
    c.udq0 = 2.0f * d4 * (3.0f * (pscale * tq0m + ps1 + e3) + (4.0f / 3.0f) * kr5 * x);
    c.udq1 = (-2.0f * kSqrt3) * d4 * (pscale * tq1m + ps1 + e3);
  }
  c.udud0 = (-2.0f / 3.0f) * d3 * (3.0f * (td0m + e3) + kr3 * x);
  c.udud1 = d3 * (tcm + e2);
}

template <class T, int LMAX>
__device__ __forceinline__ T energy_induced(const T* qi, const T* qj, const T* ui, const T* uj,
                                            const IndCoef<T>& c) {
  T e_ju = -c.cud * qj[0] * ui[0];
  T e_iu = c.cud * qi[0] * uj[0];
  if constexpr (LMAX >= 1) {
    e_ju = e_ju + c.dud0 * qj[1] * ui[0] + c.dud1 * (qj[2] * ui[1] + qj[3] * ui[2]);
    e_iu = e_iu + c.dud0 * qi[1] * uj[0] + c.dud1 * (qi[2] * uj[1] + qi[3] * uj[2]);
  }
  if constexpr (LMAX >= 2) {
    e_ju = e_ju - c.udq0 * qj[4] * ui[0] - c.udq1 * (qj[5] * ui[1] + qj[6] * ui[2]);
    e_iu = e_iu + c.udq0 * qi[4] * uj[0] + c.udq1 * (qi[5] * uj[1] + qi[6] * uj[2]);
  }
  const T e_uu = c.udud0 * uj[0] * ui[0] + c.udud1 * (uj[1] * ui[1] + uj[2] * ui[2]);
  return 0.5f * (e_ju + e_iu) + e_uu;
}

template <class T>
__device__ __forceinline__ void uu_coefficients(const T& r, const T& t1, const T& t2,
                                                const T& dmp, const T& pscale, const T& kappa,
                                                T& m0, T& m1) {
  const T au = thole_argument(r, dmp, thole_width(pscale, t1, t2));
  const T exp_au = exp_damping(au);
  const T au2 = au * au;
  const T au3 = au2 * au;
  const T td0m = -exp_au * (1.0f + au + 0.5f * au2 + au3 / 4.0f);
  const T td1m = -exp_au * (1.0f + au + 0.5f * au2);
  const T r_inv = 1.0f / r;
  const T d3 = kDielectric * r_inv * r_inv * r_inv;
  const T kr = kappa * r;
  const T kr2 = kr * kr;
  const T kr3 = kr2 * kr;
  const T x = 2.0f * dexp(-kr2) / kSqrtPi;
  const T e2 = derfc(kr) + kr * x;
  const T e3 = e2 + (2.0f / 3.0f) * kr3 * x;
  m0 = (-2.0f / 3.0f) * d3 * (3.0f * (td0m + e3) + kr3 * x);
  m1 = d3 * (td1m + e2);
}

// Energy of one unmasked pair from its wrapped displacement d, the raw-y/z
// degeneracy flag, the two feature rows (columns 3.. of the table), the
// differentiable scale rows and kappa.
template <class T, int KIND, int LMAX>
__device__ __forceinline__ T pair_energy(const T& dx, const T& dy, const T& dz,
                                         bool degenerate, const T* fi, const T* fj,
                                         const T* s, const T& kappa) {
  const T r = dsqrt(dx * dx + dy * dy + dz * dz);
  const T rinv = 1.0f / r;
  if constexpr (KIND == kUU) {
    // features: u_harm (z, x, y), pol, thole; radial projection, no frame
    const T ui_z = (fi[1] * dx + fi[2] * dy + fi[0] * dz) * rinv;
    const T uj_z = (fj[1] * dx + fj[2] * dy + fj[0] * dz) * rinv;
    const T ui_dot_uj = fi[1] * fj[1] + fi[2] * fj[2] + fi[0] * fj[0];
    const T dmp = damping_width(fi[3], fj[3]);
    T m0, m1;
    uu_coefficients(r, fi[4], fj[4], dmp, s[0], kappa, m0, m1);
    return (m0 - m1) * uj_z * ui_z + m1 * ui_dot_uj;
  } else {
    constexpr int NH = Layout<KIND, LMAX>::NH;
    // quasi-internal frame: z along d, x from a degeneracy-aware seed
    T f[9];
    f[6] = dx * rinv;
    f[7] = dy * rinv;
    f[8] = dz * rinv;
    const float seedx = degenerate ? 0.f : 1.f;
    T vx = f[6] + seedx;
    T vy = f[7] + (1.f - seedx);
    T vz = f[8];
    const T dot = f[6] * vx + f[7] * vy + f[8] * vz;
    vx = vx - f[6] * dot;
    vy = vy - f[7] * dot;
    vz = vz - f[8] * dot;
    const T nsq = vx * vx + vy * vy + vz * vz;
    const T ninv = val(nsq) < 1e-12f ? T(0.f) : 1.0f / dsqrt(nsq);
    f[0] = vx * ninv;
    f[1] = vy * ninv;
    f[2] = vz * ninv;
    f[3] = f[7] * f[2] - f[8] * f[1];
    f[4] = f[8] * f[0] - f[6] * f[2];
    f[5] = f[6] * f[1] - f[7] * f[0];
    T qi[NH], qj[NH];
    rotate_harm<T, LMAX>(fi, f, qi);
    rotate_harm<T, LMAX>(fj, f, qj);
    const T kr = kappa * r;
    const T x = 2.0f * dexp(-(kr * kr)) / kSqrtPi;
    PermCoef<T> pc;
    perm_coefficients<T, LMAX>(r, kr, x, s[0], pc);
    T e = energy_perm<T, LMAX>(qi, qj, pc);
    if constexpr (KIND == kPol) {
      T ui[3], uj[3];
      rotate_dipole(fi + NH, f, ui);
      rotate_dipole(fj + NH, f, uj);
      const T dmp = damping_width(fi[NH + 3], fj[NH + 3]);
      IndCoef<T> ic;
      induced_coefficients<T, LMAX>(r, fi[NH + 4], fj[NH + 4], dmp, s[1], kappa, ic);
      e = e + energy_induced<T, LMAX>(qi, qj, ui, uj, ic);
    }
    return e;
  }
}

// ---------------------------------------------------------------------------
// Minimum-image wrap (box and inverse row-major, as the 19 scalars hold them)
// ---------------------------------------------------------------------------

struct Wrapped {
  float raw[3];  // gi - gj
  float s[3];    // wrapped fractional coordinates
  float d[3];    // wrapped Cartesian displacement
};

__device__ __forceinline__ Wrapped wrap(const float* a, const float* b, const float* box,
                                        const float* binv) {
  Wrapped w;
#pragma unroll
  for (int m = 0; m < 3; ++m) w.raw[m] = a[m] - b[m];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s = w.raw[0] * binv[c] + w.raw[1] * binv[3 + c] + w.raw[2] * binv[6 + c];
    w.s[c] = s - floorf(s + 0.5f);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) w.d[k] = w.s[0] * box[k] + w.s[1] * box[3 + k] + w.s[2] * box[6 + k];
  return w;
}

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
  const Wrapped w = wrap(a, b, scal + 1, scal + 10);
  const bool degenerate = (a[1] == b[1]) && (a[2] == b[2]);
  float s[L::NS];
  s[0] = scl[p];
  if constexpr (L::NS > 1) s[1] = scl[2 * C + p];
  e[p] = pair_energy<float, KIND, LMAX>(w.d[0], w.d[1], w.d[2], degenerate, a + 3, b + 3, s,
                                        scal[0]);
}

using D = Dual<kTangents>;

__device__ __forceinline__ D seed(float v, int slot) {
  D r(v);
#pragma unroll
  for (int t = 0; t < kTangents; ++t) r.d[t] = (t == slot) ? 1.f : 0.f;
  return r;
}

template <int KIND, int LMAX>
__global__ void __launch_bounds__(kBlock)
pair_bwd_kernel(const float* __restrict__ gi, const float* __restrict__ gj,
                const float* __restrict__ scl, const float* __restrict__ scal,
                const float* __restrict__ ct, float* __restrict__ dgi,
                float* __restrict__ dgj, float* __restrict__ dscl,
                float* __restrict__ dscal_blocks, int C) {
  using L = Layout<KIND, LMAX>;
  static_assert(kTangents >= 3, "the first pass must cover the displacement");
  constexpr int F = L::F;
  constexpr int NF = L::NF;
  constexpr int NS = L::NS;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float sg[kNScal];
#pragma unroll
  for (int k = 0; k < kNScal; ++k) sg[k] = 0.f;

  const bool active = p < C;
  const bool live = active && scl[C + p] > 0.5f;
  if (active && !live) {
    for (int k = 0; k < F; ++k) {
      dgi[static_cast<size_t>(p) * F + k] = 0.f;
      dgj[static_cast<size_t>(p) * F + k] = 0.f;
    }
    for (int r = 0; r < L::NSCL; ++r) dscl[r * C + p] = 0.f;
  }
  if (live) {
    float a[F], b[F];
    load_row<F>(gi, p, a);
    load_row<F>(gj, p, b);
    const float* box = scal + 1;
    const float* binv = scal + 10;
    const Wrapped w = wrap(a, b, box, binv);
    const bool degenerate = (a[1] == b[1]) && (a[2] == b[2]);
    const float ctp = ct[p];
    float sv[NS];
    sv[0] = scl[p];
    if constexpr (NS > 1) sv[1] = scl[2 * C + p];
    float gd[3] = {0.f, 0.f, 0.f};

    for (int off = 0; off < L::NV; off += kTangents) {
      D dd[3], fi[NF], fj[NF], s[NS];
      int v = -off;
#pragma unroll
      for (int m = 0; m < 3; ++m) dd[m] = seed(w.d[m], v++);
#pragma unroll
      for (int m = 0; m < NF; ++m) fi[m] = seed(a[3 + m], v++);
#pragma unroll
      for (int m = 0; m < NF; ++m) fj[m] = seed(b[3 + m], v++);
#pragma unroll
      for (int m = 0; m < NS; ++m) s[m] = seed(sv[m], v++);
      const D kp = seed(scal[0], v);
      const D e = pair_energy<D, KIND, LMAX>(dd[0], dd[1], dd[2], degenerate, fi, fj, s, kp);
#pragma unroll
      for (int t = 0; t < kTangents; ++t) {
        const int k = off + t;
        if (k >= L::NV) break;
        const float g = ctp * e.d[t];
        if (k < 3) {
          gd[k] = g;
        } else if (k < 3 + NF) {
          dgi[static_cast<size_t>(p) * F + k] = g;  // feature k-3 is column k
        } else if (k < 3 + 2 * NF) {
          dgj[static_cast<size_t>(p) * F + (k - NF)] = g;
        } else if (k < 3 + 2 * NF + NS) {
          dscl[scale_row(k - 3 - 2 * NF) * C + p] = g;
        } else {
          sg[0] += g;  // kappa
        }
      }
    }
    // hand chain rule of the wrap: d = s' box, s' = s - floor(s + 1/2),
    // s = raw binv (floor has zero derivative)
    float gs[3];  // dE/ds'
#pragma unroll
    for (int c = 0; c < 3; ++c) gs[c] = box[3 * c] * gd[0] + box[3 * c + 1] * gd[1] + box[3 * c + 2] * gd[2];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float g = binv[3 * m] * gs[0] + binv[3 * m + 1] * gs[1] + binv[3 * m + 2] * gs[2];
      dgi[static_cast<size_t>(p) * F + m] = g;
      dgj[static_cast<size_t>(p) * F + m] = -g;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sg[1 + 3 * c + k] += gd[k] * w.s[c];       // box[c][k]
        sg[10 + 3 * k + c] += gs[c] * w.raw[k];    // binv[k][c]
      }
    }
    dscl[C + p] = 0.f;  // the mask row
  }

  // per-block scalar gradients, fixed reduction order
  __shared__ float red[kBlock / 32][kNScal];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kNScal; ++k) {
    float v = sg[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kNScal) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) t += red[w][threadIdx.x];
    dscal_blocks[blockIdx.x * kNScal + threadIdx.x] = t;
  }
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
