// The per-pair energy of admp_tpu_torch's real-space pair kernels and the
// gradient body shared by K2 (csrc/pairs.cu) and K3 (csrc/pair_hvp.cu).
//
// The energy of one pair (pair_energy below) is written once, templated over
// its scalar type. Forward-mode dual numbers Dual<N, S> carry N tangents over
// a base scalar S, which is `float` or itself a one-tangent dual (Dual1), so
// the same source gives the energy (float), its gradient (Dual<N, float>,
// K2) and the derivative of that gradient along one direction
// (Dual<N, Dual1>, K3). The gradient body pair_grad runs in ceil(NV / N)
// passes, each seeding N of the pair's NV independent inputs (the wrapped
// displacement, both sites' features, the differentiable scale rows and
// kappa), and chain-rules the minimum-image wrap by hand in S arithmetic.
// Row layouts are documented in admp_tpu_torch/ops/cuda/pairs.py.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;
constexpr int kNScal = 19;

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
// Forward-mode dual numbers over a base scalar S (float, or Dual1)
// ---------------------------------------------------------------------------

template <int N, class S = float>
struct Dual {
  S v;
  S d[N];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(float x) : v(x) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = S(0.f);
  }
};

using Dual1 = Dual<1>;

template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator+(const Dual<N, S>& a, const Dual<N, S>& b) {
  Dual<N, S> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator+(const Dual<N, S>& a, float b) {
  Dual<N, S> r = a;
  r.v = a.v + b;
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator+(float a, const Dual<N, S>& b) {
  Dual<N, S> r = b;
  r.v = a + b.v;
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator-(const Dual<N, S>& a) {
  Dual<N, S> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator-(const Dual<N, S>& a, const Dual<N, S>& b) {
  Dual<N, S> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator-(const Dual<N, S>& a, float b) {
  Dual<N, S> r = a;
  r.v = a.v - b;
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator-(float a, const Dual<N, S>& b) {
  Dual<N, S> r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -b.d[k];
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator*(const Dual<N, S>& a, const Dual<N, S>& b) {
  Dual<N, S> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator*(const Dual<N, S>& a, float b) {
  Dual<N, S> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b;
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator*(float a, const Dual<N, S>& b) {
  return b * a;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator/(const Dual<N, S>& a, const Dual<N, S>& b) {
  Dual<N, S> r;
  r.v = a.v / b.v;
  const S inv = 1.f / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator/(const Dual<N, S>& a, float b) {
  Dual<N, S> r;
  r.v = a.v / b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / b;
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> operator/(float a, const Dual<N, S>& b) {
  Dual<N, S> r;
  r.v = a / b.v;
  const S g = -r.v / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = g * b.d[k];
  return r;
}

// Elementary functions: the float overloads are the forward's, the Dual
// overloads carry the exact derivative of the same call, recursively over
// the base scalar.
__device__ __forceinline__ float val(float x) { return x; }
template <int N, class S>
__device__ __forceinline__ float val(const Dual<N, S>& x) { return val(x.v); }

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ float derfc(float x) { return erfcf(x); }
__device__ __forceinline__ float dpow(float x, float p) { return powf(x, p); }

template <int N, class S>
__device__ __forceinline__ Dual<N, S> scale_tangent(const S& v, const S& g, const Dual<N, S>& x) {
  Dual<N, S> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = g * x.d[k];
  return r;
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> dsqrt(const Dual<N, S>& x) {
  const S s = dsqrt(x.v);
  return scale_tangent(s, 0.5f / s, x);
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> dexp(const Dual<N, S>& x) {
  const S e = dexp(x.v);
  return scale_tangent(e, e, x);
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> derfc(const Dual<N, S>& x) {
  const S g = -kTwoOverSqrtPi * dexp(-(x.v * x.v));
  return scale_tangent(derfc(x.v), g, x);
}
template <int N, class S>
__device__ __forceinline__ Dual<N, S> dpow(const Dual<N, S>& x, float p) {
  const S v = dpow(x.v, p);
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

template <class S>
struct Wrapped {
  S raw[3];  // gi - gj
  S s[3];    // wrapped fractional coordinates
  S d[3];    // wrapped Cartesian displacement
};

// floor() acts on the value only: its derivative is zero
template <class S>
__device__ __forceinline__ Wrapped<S> wrap(const S* a, const S* b, const S* box, const S* binv) {
  Wrapped<S> w;
#pragma unroll
  for (int m = 0; m < 3; ++m) w.raw[m] = a[m] - b[m];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const S s = w.raw[0] * binv[c] + w.raw[1] * binv[3 + c] + w.raw[2] * binv[6 + c];
    w.s[c] = s - floorf(val(s) + 0.5f);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) w.d[k] = w.s[0] * box[k] + w.s[1] * box[3 + k] + w.s[2] * box[6 + k];
  return w;
}

// ---------------------------------------------------------------------------
// The gradient body of K2 (S = float) and K3 (S = Dual1)
// ---------------------------------------------------------------------------

// An input of the pair as S: its value, and for Dual1 its tangent t[k] (the
// cotangent direction K3 differentiates along).
template <class S>
__device__ __forceinline__ S lift(float v, const float* t, size_t k);
template <>
__device__ __forceinline__ float lift<float>(float v, const float*, size_t) { return v; }
template <>
__device__ __forceinline__ Dual1 lift<Dual1>(float v, const float* t, size_t k) {
  Dual1 r;
  r.v = v;
  r.d[0] = t[k];
  return r;
}

// The part of a gradient entry that is written out: its value (K2), or its
// derivative along the direction (K3)
__device__ __forceinline__ float part(float x) { return x; }
__device__ __forceinline__ float part(const Dual1& x) { return x.d[0]; }

template <int NT, class S>
__device__ __forceinline__ Dual<NT, S> seed(const S& v, int slot) {
  Dual<NT, S> r;
  r.v = v;
#pragma unroll
  for (int t = 0; t < NT; ++t) r.d[t] = S(t == slot ? 1.f : 0.f);
  return r;
}

// For pair p: the gradient of ct[p] * e_p with respect to both rows, the
// scale rows and (accumulated into sg) the 19 scalars, evaluated in S. With
// S = Dual1 every input carries its entry of the direction (cgi, cgj, cscl,
// cscal), so part() of each gradient entry is that entry of ct H c, and
// part(e) is J c, written to dct. The per-pair outputs of a masked pair are
// zeros.
template <int KIND, int LMAX, class S, int NT>
__device__ __forceinline__ void pair_grad(
    int p, int C, const float* __restrict__ gi, const float* __restrict__ gj,
    const float* __restrict__ scl, const float* __restrict__ scal,
    const float* __restrict__ ct, const float* __restrict__ cgi,
    const float* __restrict__ cgj, const float* __restrict__ cscl,
    const float* __restrict__ cscal, float* __restrict__ dgi, float* __restrict__ dgj,
    float* __restrict__ dscl, float* __restrict__ dct, float* sg) {
  using L = Layout<KIND, LMAX>;
  using D = Dual<NT, S>;
  constexpr int F = L::F;
  constexpr int NF = L::NF;
  constexpr int NS = L::NS;
  const size_t row = static_cast<size_t>(p) * F;
  if (!(scl[C + p] > 0.5f)) {
    for (int k = 0; k < F; ++k) {
      dgi[row + k] = 0.f;
      dgj[row + k] = 0.f;
    }
    for (int r = 0; r < L::NSCL; ++r) dscl[r * C + p] = 0.f;
    if (dct != nullptr) dct[p] = 0.f;
    return;
  }
  S a[F], b[F], box[9], binv[9];
#pragma unroll
  for (int k = 0; k < F; ++k) {
    a[k] = lift<S>(gi[row + k], cgi, row + k);
    b[k] = lift<S>(gj[row + k], cgj, row + k);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    box[k] = lift<S>(scal[1 + k], cscal, 1 + k);
    binv[k] = lift<S>(scal[10 + k], cscal, 10 + k);
  }
  const Wrapped<S> w = wrap(a, b, box, binv);
  const bool degenerate = (val(a[1]) == val(b[1])) && (val(a[2]) == val(b[2]));
  const float ctp = ct[p];
  S sv[NS];
  sv[0] = lift<S>(scl[p], cscl, p);
  if constexpr (NS > 1) sv[1] = lift<S>(scl[2 * C + p], cscl, 2 * C + p);
  const S kappa = lift<S>(scal[0], cscal, 0);
  S gd[3];

  for (int off = 0; off < L::NV; off += NT) {
    D dd[3], fi[NF], fj[NF], s[NS];
    int v = -off;
#pragma unroll
    for (int m = 0; m < 3; ++m) dd[m] = seed<NT>(w.d[m], v++);
#pragma unroll
    for (int m = 0; m < NF; ++m) fi[m] = seed<NT>(a[3 + m], v++);
#pragma unroll
    for (int m = 0; m < NF; ++m) fj[m] = seed<NT>(b[3 + m], v++);
#pragma unroll
    for (int m = 0; m < NS; ++m) s[m] = seed<NT>(sv[m], v++);
    const D kp = seed<NT>(kappa, v);
    const D e = pair_energy<D, KIND, LMAX>(dd[0], dd[1], dd[2], degenerate, fi, fj, s, kp);
    if (off == 0 && dct != nullptr) dct[p] = part(e.v);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int k = off + t;
      if (k >= L::NV) break;
      const S g = ctp * e.d[t];
      if (k < 3) {
        gd[k] = g;
      } else if (k < 3 + NF) {
        dgi[row + k] = part(g);  // feature k-3 is column k
      } else if (k < 3 + 2 * NF) {
        dgj[row + (k - NF)] = part(g);
      } else if (k < 3 + 2 * NF + NS) {
        dscl[scale_row(k - 3 - 2 * NF) * C + p] = part(g);
      } else {
        sg[0] += part(g);  // kappa
      }
    }
  }
  // hand chain rule of the wrap: d = s' box, s' = s - floor(s + 1/2),
  // s = raw binv (floor has zero derivative); in S, so that K3 keeps the
  // position x box, position x box-inverse and box x box-inverse terms
  S gs[3];  // dE/ds'
#pragma unroll
  for (int c = 0; c < 3; ++c) gs[c] = box[3 * c] * gd[0] + box[3 * c + 1] * gd[1] + box[3 * c + 2] * gd[2];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const S g = binv[3 * m] * gs[0] + binv[3 * m + 1] * gs[1] + binv[3 * m + 2] * gs[2];
    dgi[row + m] = part(g);
    dgj[row + m] = -part(g);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sg[1 + 3 * c + k] += part(gd[k] * w.s[c]);     // box[c][k]
      sg[10 + 3 * k + c] += part(gs[c] * w.raw[k]);  // binv[k][c]
    }
  }
  dscl[C + p] = 0.f;  // the mask row
}

// Per-block sums of the 19 scalar gradients into dscal_blocks[blockIdx.x],
// in a fixed order (warp shuffles, then shared memory): deterministic, no
// atomics. Every thread of the block calls it.
__device__ __forceinline__ void reduce_scalars(float* sg, float* __restrict__ dscal_blocks) {
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

}  // namespace
