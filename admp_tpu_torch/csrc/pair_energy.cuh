// The per-pair energy of admp_tpu_torch's real-space pair kernels and the
// gradient bodies of K2 (csrc/pairs.cu) and K3 (csrc/pair_hvp.cu).
//
// The energy of one pair (pair_energy below) is written once, templated over
// its scalar type. Forward-mode dual numbers Dual<N, S> carry N tangents over
// a base scalar S, which is `float` or itself a one-tangent dual (Dual1).
// The gradient body, pair_grad_mixed / pair_energy_grad, is mixed mode, each
// sweep in the direction with few inputs: a forward in S that keeps the
// frame, the rotated harmonics and the coefficients; a reverse by hand
// through the bilinear contractions (perm_adjoint, induced_adjoint) and the
// transposed rotations (rotate_harm_t, rotate_dipole_t) for the features;
// and the same templated source in forward mode over the narrow inputs only
// (Dual<3> over the displacement through the frame and the rotations,
// Dual<3> and Dual<7> over the coefficient functions' scalar inputs), so
// each branch of the forward takes autograd's side. K2 runs it at S = float;
// K3 runs the same body at S = Dual1, every input carrying its entry of a
// direction, which gives each gradient entry's derivative along it; K3b (K3's
// backward, csrc/pair_third.cu) at S = Hyper = Dual<1, Dual1>, every input
// carrying its entries of two directions. The minimum-image wrap is
// chain-ruled by hand in S arithmetic (wrap_grad). Row layouts are documented
// in admp_tpu_torch/ops/cuda/pairs.py.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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
  // a constant of a dual base scalar (tangents zero)
  template <class U = S, typename std::enable_if<!std::is_same<U, float>::value, int>::type = 0>
  __device__ __forceinline__ Dual(const S& x) : v(x) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = S(0.f);
  }
};

using Dual1 = Dual<1>;
// a hyper-dual: the outer tangent (eps) and the inner one (delta) over float
using Hyper = Dual<1, Dual1>;

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

// A dual over a dual base scalar B' = Dual<M, B> times a B': the products a
// gradient body in base scalar S = Dual<M, B> takes between its S values and
// its Dual<N, S> passes (for S = float the float overloads above do)
template <int N, int M, class B>
__device__ __forceinline__ Dual<N, Dual<M, B>> operator*(const Dual<N, Dual<M, B>>& a,
                                                        const Dual<M, B>& b) {
  Dual<N, Dual<M, B>> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b;
  return r;
}
template <int N, int M, class B>
__device__ __forceinline__ Dual<N, Dual<M, B>> operator*(const Dual<M, B>& a,
                                                        const Dual<N, Dual<M, B>>& b) {
  return b * a;
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
};

__device__ __forceinline__ int scale_row(int k) { return k == 0 ? 0 : 2; }

// q (harmonic order) -> QI frame f; the harmonics may be of another scalar
// type Q than the frame (K2 rotates its S features by a frame that is a
// dual over the displacement)
template <class T, int LMAX, class Q = T>
__device__ __forceinline__ void rotate_harm(const Q* q, const T* f, T* out) {
  out[0] = q[0];
  if constexpr (LMAX >= 1) {
    const Q cx = q[2], cy = q[3], cz = q[1];
    out[2] = f[0] * cx + f[1] * cy + f[2] * cz;
    out[3] = f[3] * cx + f[4] * cy + f[5] * cz;
    out[1] = f[6] * cx + f[7] * cy + f[8] * cz;
  }
  if constexpr (LMAX >= 2) {
    const float h = kRt3 / 2.0f;
    const Q txx = -0.5f * q[4] + h * q[7];
    const Q tyy = -0.5f * q[4] - h * q[7];
    const Q tzz = q[4];
    const Q txy = h * q[8];
    const Q txz = h * q[5];
    const Q tyz = h * q[6];
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
template <class T, class Q = T>
__device__ __forceinline__ void rotate_dipole(const Q* u, const T* f, T* out) {
  const Q cx = u[1], cy = u[2], cz = u[0];
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

// Whether T is K3b's scalar (Hyper) or a dual over it
template <class T>
constexpr bool kOverHyper = false;
template <>
constexpr bool kOverHyper<Hyper> = true;
template <int N>
constexpr bool kOverHyper<Dual<N, Hyper>> = true;

// The Thole damping terms -exp(-au) (1 + au + au^2/2 [+ au^3/4]) (cm, d0m)
// and -exp(-au) (1 + au + au^2/2 + au^3/6 [+ au^4/18]) (q1m, q0m), the
// exponential cut to zero past au = 50. In K3b's hyper-duals the
// polynomials' tangents overflow float there (au ~ 1e7 at a zero-pol site,
// and the sigmoid's slope scales each tangent by 1e5), and zero times that
// is not zero, so they are not formed there; K2's and K3's code is as it
// was.
template <class T>
struct Damping {
  T cm, d0m, q0m, q1m;
};

template <class T>
__device__ __forceinline__ Damping<T> thole_damping(const T& au) {
  Damping<T> t;
  if constexpr (kOverHyper<T>) {
    if (!(val(au) < 50.f)) {
      t.cm = t.d0m = t.q0m = t.q1m = T(0.f);
      return t;
    }
  }
  const T exp_au = val(au) < 50.f ? dexp(-au) : T(0.f);
  const T au2 = au * au;
  const T au3 = au2 * au;
  const T au4 = au3 * au;
  t.cm = -exp_au * (1.0f + au + 0.5f * au2);
  t.d0m = -exp_au * (1.0f + au + 0.5f * au2 + au3 / 4.0f);
  t.q0m = -exp_au * (1.0f + au + 0.5f * au2 + au3 / 6.0f + au4 / 18.0f);
  t.q1m = -exp_au * (1.0f + au + 0.5f * au2 + au3 / 6.0f);
  return t;
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
  const Damping<T> t = thole_damping(thole_argument(r, dmp, thole_width(pscale, t1, t2)));
  const T &tcm = t.cm, &td0m = t.d0m, &tq0m = t.q0m, &tq1m = t.q1m;
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
  const Damping<T> t = thole_damping(thole_argument(r, dmp, thole_width(pscale, t1, t2)));
  const T &td0m = t.d0m, &td1m = t.cm;
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

// The quasi-internal frame f (rows: local x, y, z) of displacement d: z
// along d, x from a degeneracy-aware seed (``degenerate``: the raw y and z
// of the two sites are equal) orthogonalized against z, y = z x x
template <class T>
__device__ __forceinline__ void qi_frame(const T& dx, const T& dy, const T& dz, const T& rinv,
                                         bool degenerate, T* f) {
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
    T f[9];
    qi_frame(dx, dy, dz, rinv, degenerate, f);
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
// The gradient body's inputs in S, its masked pairs and the wrap's chain rule
// ---------------------------------------------------------------------------

// An input of the pair as S: its value; for Dual1 its tangent t[k] (the
// cotangent direction K3 differentiates along); for Hyper t[k] as the eps
// tangent and h[k] as the delta tangent (K3b's two directions).
template <class S>
__device__ __forceinline__ S lift(float v, const float* t, const float* h, size_t k);
template <>
__device__ __forceinline__ float lift<float>(float v, const float*, const float*, size_t) {
  return v;
}
template <>
__device__ __forceinline__ Dual1 lift<Dual1>(float v, const float* t, const float*, size_t k) {
  Dual1 r;
  r.v = v;
  r.d[0] = t[k];
  return r;
}
template <>
__device__ __forceinline__ Hyper lift<Hyper>(float v, const float* t, const float* h, size_t k) {
  Hyper r;
  r.v.v = v;
  r.v.d[0] = h[k];
  r.d[0].v = t[k];
  r.d[0].d[0] = 0.f;
  return r;
}

// The cotangent ct of a pair's energy as the body multiplies by it: a float,
// except in K3b, where it carries the delta tangent h (the cotangent of K3's
// output J c)
template <class S>
struct CtOf {
  using type = float;
  static __device__ __forceinline__ float lift(float v, const float*, size_t) { return v; }
};
template <>
struct CtOf<Hyper> {
  using type = Hyper;
  static __device__ __forceinline__ Hyper lift(float v, const float* h, size_t k) {
    Hyper r(v);
    r.v.d[0] = h[k];
    return r;
  }
};

// The parts of a gradient entry that are written out: its value (K2), its
// derivative along the direction (K3), or in K3b part 0, the eps-delta part
// (the cotangent of K3's table inputs), and part 1, the delta part (the
// cotangent of K3's direction inputs)
template <class S>
constexpr int kParts = 1;
template <>
constexpr int kParts<Hyper> = 2;

template <int J>
__device__ __forceinline__ float part(float x) { return x; }
template <int J>
__device__ __forceinline__ float part(const Dual1& x) { return x.d[0]; }
template <int J>
__device__ __forceinline__ float part(const Hyper& x) { return J == 0 ? x.d[0].d[0] : x.v.d[0]; }

template <int NT, class S>
__device__ __forceinline__ Dual<NT, S> seed(const S& v, int slot) {
  Dual<NT, S> r;
  r.v = v;
#pragma unroll
  for (int t = 0; t < NT; ++t) r.d[t] = S(t == slot ? 1.f : 0.f);
  return r;
}

// The per-pair outputs of a masked pair: zeros (oi[J], oj[J]: its two
// output rows of part J)
template <class L, int NP>
__device__ __forceinline__ void zero_pair(int p, int C, float* const* oi, float* const* oj,
                                          float* const* dscl, float* __restrict__ dct) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    for (int k = 0; k < L::F; ++k) {
      oi[j][k] = 0.f;
      oj[j][k] = 0.f;
    }
    if (dscl[j] != nullptr)
      for (int r = 0; r < L::NSCL; ++r) dscl[j][r * C + p] = 0.f;
  }
  if (dct != nullptr) dct[p] = 0.f;
}

// Hand chain rule of the wrap, from gd = d(ct e)/dd: d = s' box,
// s' = s - floor(s + 1/2), s = raw binv (floor has zero derivative); in S,
// so that K3 keeps the position x box, position x box-inverse and box x
// box-inverse terms. Writes the position columns of the output rows oi[J],
// oj[J] of each part J, adds the box and box-inverse gradients to sg[J].
template <class S>
__device__ __forceinline__ void wrap_grad(const Wrapped<S>& w, const S* box, const S* binv,
                                          const S* gd, float* const* oi, float* const* oj,
                                          float (*sg)[kNScal]) {
  S gs[3];  // dE/ds'
#pragma unroll
  for (int c = 0; c < 3; ++c) gs[c] = box[3 * c] * gd[0] + box[3 * c + 1] * gd[1] + box[3 * c + 2] * gd[2];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const S g = binv[3 * m] * gs[0] + binv[3 * m + 1] * gs[1] + binv[3 * m + 2] * gs[2];
    oi[0][m] = part<0>(g);
    oj[0][m] = -part<0>(g);
    if constexpr (kParts<S> > 1) {
      oi[1][m] = part<1>(g);
      oj[1][m] = -part<1>(g);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const S b = gd[k] * w.s[c], v = gs[c] * w.raw[k];
      sg[0][1 + 3 * c + k] += part<0>(b);   // box[c][k]
      sg[0][10 + 3 * k + c] += part<0>(v);  // binv[k][c]
      if constexpr (kParts<S> > 1) {
        sg[1][1 + 3 * c + k] += part<1>(b);
        sg[1][10 + 3 * k + c] += part<1>(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The gradient body of K2 (S = float) and K3 (S = Dual1): mixed mode
// ---------------------------------------------------------------------------

// The transpose of rotate_harm's linear map q -> out at a fixed frame f:
// the adjoint g of out -> the adjoint of q. Written out, since the
// truncated kRt3 makes the map only nearly orthogonal (its inverse is not
// its transpose). For l = 2, T' = F T F^T: the adjoint of the symmetric T
// is F^T G F with G the symmetric adjoint of T' (off the diagonal, half of
// the adjoint of the one entry rotate_harm computes), and each off-diagonal
// entry of T appears twice in T.
template <class T, int LMAX>
__device__ __forceinline__ void rotate_harm_t(const T* g, const T* f, T* out) {
  out[0] = g[0];
  if constexpr (LMAX >= 1) {
    out[2] = f[0] * g[2] + f[3] * g[3] + f[6] * g[1];  // cx = q[2]
    out[3] = f[1] * g[2] + f[4] * g[3] + f[7] * g[1];  // cy = q[3]
    out[1] = f[2] * g[2] + f[5] * g[3] + f[8] * g[1];  // cz = q[1]
  }
  if constexpr (LMAX >= 2) {
    const float h = kRt3 / 2.0f;
    // G, the symmetric adjoint of T'
    const T gzz = g[4];
    const T gxz = (0.5f * kInvRt3x2) * g[5];
    const T gyz = (0.5f * kInvRt3x2) * g[6];
    const T gxx = g[7] / kRt3;
    const T gyy = -gxx;
    const T gxy = (0.5f * kInvRt3x2) * g[8];
    // W = G F (rows a of G, columns d of F)
    T w[9];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      w[d] = gxx * f[d] + gxy * f[3 + d] + gxz * f[6 + d];
      w[3 + d] = gxy * f[d] + gyy * f[3 + d] + gyz * f[6 + d];
      w[6 + d] = gxz * f[d] + gyz * f[3 + d] + gzz * f[6 + d];
    }
    // M = F^T W: the adjoint of the symmetric T, M[c][d] = sum_a F[a][c] W[a][d]
    const T mxx = f[0] * w[0] + f[3] * w[3] + f[6] * w[6];
    const T myy = f[1] * w[1] + f[4] * w[4] + f[7] * w[7];
    const T mzz = f[2] * w[2] + f[5] * w[5] + f[8] * w[8];
    const T mxy = f[0] * w[1] + f[3] * w[4] + f[6] * w[7];
    const T mxz = f[0] * w[2] + f[3] * w[5] + f[6] * w[8];
    const T myz = f[1] * w[2] + f[4] * w[5] + f[7] * w[8];
    // back through txx = -q4/2 + h q7, tyy = -q4/2 - h q7, tzz = q4,
    // txy = h q8, txz = h q5, tyz = h q6
    out[4] = mzz - 0.5f * (mxx + myy);
    out[7] = h * (mxx - myy);
    out[8] = (2.0f * h) * mxy;
    out[5] = (2.0f * h) * mxz;
    out[6] = (2.0f * h) * myz;
  }
}

// The transpose of rotate_dipole's map at a fixed frame f
template <class T>
__device__ __forceinline__ void rotate_dipole_t(const T* g, const T* f, T* out) {
  out[1] = f[0] * g[1] + f[3] * g[2] + f[6] * g[0];  // cx = u[1]
  out[2] = f[1] * g[1] + f[4] * g[2] + f[7] * g[0];  // cy = u[2]
  out[0] = f[2] * g[1] + f[5] * g[2] + f[8] * g[0];  // cz = u[0]
}

// The reverse of energy_perm: its adjoints with respect to qi, qj (gqi =
// T^T qj, gqj = T qi for e = qj^T T qi) and each coefficient (its bracket)
template <class T, int LMAX>
__device__ __forceinline__ void perm_adjoint(const T* qi, const T* qj, const PermCoef<T>& c,
                                             T* gqi, T* gqj, PermCoef<T>& g) {
  gqi[0] = c.cc * qj[0];
  gqj[0] = c.cc * qi[0];
  g.cc = qj[0] * qi[0];
  if constexpr (LMAX >= 1) {
    gqi[0] = gqi[0] + c.cd * qj[1];
    gqi[1] = c.dd0 * qj[1] - c.cd * qj[0];
    gqi[2] = c.dd1 * qj[2];
    gqi[3] = c.dd1 * qj[3];
    gqj[0] = gqj[0] - c.cd * qi[1];
    gqj[1] = c.cd * qi[0] + c.dd0 * qi[1];
    gqj[2] = c.dd1 * qi[2];
    gqj[3] = c.dd1 * qi[3];
    g.cd = qj[1] * qi[0] - qj[0] * qi[1];
    g.dd0 = qj[1] * qi[1];
    g.dd1 = qj[2] * qi[2] + qj[3] * qi[3];
  }
  if constexpr (LMAX >= 2) {
    gqi[0] = gqi[0] + c.cq * qj[4];
    gqi[1] = gqi[1] - c.dq0 * qj[4];
    gqi[2] = gqi[2] - c.dq1 * qj[5];
    gqi[3] = gqi[3] - c.dq1 * qj[6];
    gqi[4] = c.cq * qj[0] + c.dq0 * qj[1] + c.qq0 * qj[4];
    gqi[5] = c.dq1 * qj[2] + c.qq1 * qj[5];
    gqi[6] = c.dq1 * qj[3] + c.qq1 * qj[6];
    gqi[7] = c.qq2 * qj[7];
    gqi[8] = c.qq2 * qj[8];
    gqj[0] = gqj[0] + c.cq * qi[4];
    gqj[1] = gqj[1] + c.dq0 * qi[4];
    gqj[2] = gqj[2] + c.dq1 * qi[5];
    gqj[3] = gqj[3] + c.dq1 * qi[6];
    gqj[4] = c.cq * qi[0] - c.dq0 * qi[1] + c.qq0 * qi[4];
    gqj[5] = c.qq1 * qi[5] - c.dq1 * qi[2];
    gqj[6] = c.qq1 * qi[6] - c.dq1 * qi[3];
    gqj[7] = c.qq2 * qi[7];
    gqj[8] = c.qq2 * qi[8];
    g.cq = qj[0] * qi[4] + qj[4] * qi[0];
    g.dq0 = qj[1] * qi[4] - qj[4] * qi[1];
    g.dq1 = qj[2] * qi[5] - qj[5] * qi[2] + qj[3] * qi[6] - qj[6] * qi[3];
    g.qq0 = qj[4] * qi[4];
    g.qq1 = qj[5] * qi[5] + qj[6] * qi[6];
    g.qq2 = qj[7] * qi[7] + qj[8] * qi[8];
  }
}

// The reverse of energy_induced: adds its adjoints with respect to qi, qj to
// gqi, gqj; sets those of ui, uj and of each coefficient
template <class T, int LMAX>
__device__ __forceinline__ void induced_adjoint(const T* qi, const T* qj, const T* ui,
                                                const T* uj, const IndCoef<T>& c, T* gqi,
                                                T* gqj, T* gui, T* guj, IndCoef<T>& g) {
  // e = e_ju / 2 + e_iu / 2 + e_uu
  gui[0] = (-0.5f) * c.cud * qj[0] + c.udud0 * uj[0];
  gui[1] = c.udud1 * uj[1];
  gui[2] = c.udud1 * uj[2];
  guj[0] = 0.5f * c.cud * qi[0] + c.udud0 * ui[0];
  guj[1] = c.udud1 * ui[1];
  guj[2] = c.udud1 * ui[2];
  gqj[0] = gqj[0] - 0.5f * c.cud * ui[0];
  gqi[0] = gqi[0] + 0.5f * c.cud * uj[0];
  g.cud = 0.5f * (qi[0] * uj[0] - qj[0] * ui[0]);
  g.udud0 = uj[0] * ui[0];
  g.udud1 = uj[1] * ui[1] + uj[2] * ui[2];
  if constexpr (LMAX >= 1) {
    gui[0] = gui[0] + 0.5f * c.dud0 * qj[1];
    gui[1] = gui[1] + 0.5f * c.dud1 * qj[2];
    gui[2] = gui[2] + 0.5f * c.dud1 * qj[3];
    guj[0] = guj[0] + 0.5f * c.dud0 * qi[1];
    guj[1] = guj[1] + 0.5f * c.dud1 * qi[2];
    guj[2] = guj[2] + 0.5f * c.dud1 * qi[3];
    gqj[1] = gqj[1] + 0.5f * c.dud0 * ui[0];
    gqj[2] = gqj[2] + 0.5f * c.dud1 * ui[1];
    gqj[3] = gqj[3] + 0.5f * c.dud1 * ui[2];
    gqi[1] = gqi[1] + 0.5f * c.dud0 * uj[0];
    gqi[2] = gqi[2] + 0.5f * c.dud1 * uj[1];
    gqi[3] = gqi[3] + 0.5f * c.dud1 * uj[2];
    g.dud0 = 0.5f * (qj[1] * ui[0] + qi[1] * uj[0]);
    g.dud1 = 0.5f * (qj[2] * ui[1] + qj[3] * ui[2] + qi[2] * uj[1] + qi[3] * uj[2]);
  }
  if constexpr (LMAX >= 2) {
    gui[0] = gui[0] - 0.5f * c.udq0 * qj[4];
    gui[1] = gui[1] - 0.5f * c.udq1 * qj[5];
    gui[2] = gui[2] - 0.5f * c.udq1 * qj[6];
    guj[0] = guj[0] + 0.5f * c.udq0 * qi[4];
    guj[1] = guj[1] + 0.5f * c.udq1 * qi[5];
    guj[2] = guj[2] + 0.5f * c.udq1 * qi[6];
    gqj[4] = gqj[4] - 0.5f * c.udq0 * ui[0];
    gqj[5] = gqj[5] - 0.5f * c.udq1 * ui[1];
    gqj[6] = gqj[6] - 0.5f * c.udq1 * ui[2];
    gqi[4] = gqi[4] + 0.5f * c.udq0 * uj[0];
    gqi[5] = gqi[5] + 0.5f * c.udq1 * uj[1];
    gqi[6] = gqi[6] + 0.5f * c.udq1 * uj[2];
    g.udq0 = 0.5f * (qi[4] * uj[0] - qj[4] * ui[0]);
    g.udq1 = 0.5f * (qi[5] * uj[1] + qi[6] * uj[2] - qj[5] * ui[1] - qj[6] * ui[2]);
  }
}

// sum_k g_k c_k over the coefficients of LMAX: a pair energy's coefficient
// part, with the brackets g held fixed (e is linear in the coefficients)
template <class T, class D, int LMAX>
__device__ __forceinline__ D perm_contract(const PermCoef<T>& g, const PermCoef<D>& c) {
  D e = g.cc * c.cc;
  if constexpr (LMAX >= 1) e = e + g.cd * c.cd + g.dd0 * c.dd0 + g.dd1 * c.dd1;
  if constexpr (LMAX >= 2)
    e = e + g.cq * c.cq + g.dq0 * c.dq0 + g.dq1 * c.dq1 + g.qq0 * c.qq0 + g.qq1 * c.qq1 +
        g.qq2 * c.qq2;
  return e;
}

template <class T, class D, int LMAX>
__device__ __forceinline__ D induced_contract(const IndCoef<T>& g, const IndCoef<D>& c) {
  D e = g.cud * c.cud + g.udud0 * c.udud0 + g.udud1 * c.udud1;
  if constexpr (LMAX >= 1) e = e + g.dud0 * c.dud0 + g.dud1 * c.dud1;
  if constexpr (LMAX >= 2) e = e + g.udq0 * c.udq0 + g.udq1 * c.udq1;
  return e;
}

// The gradient of one unmasked pair's energy e with respect to its wrapped
// displacement d (gd), both feature rows (gfi, gfj), the differentiable
// scale rows (gs) and kappa (gk), and e itself; the inputs as pair_energy
// takes them. Each sweep goes in the direction that has few inputs:
//   1. the forward in S, its intermediates kept: r, the frame, the rotated
//      harmonics and dipoles, the coefficients;
//   2. reverse by hand through the bilinear contractions (perm_adjoint,
//      induced_adjoint, the uu projection): the adjoints of the rotated
//      values and of the coefficients;
//   3. the features' gradients through the transposes of the rotations;
//   4. forward mode over the narrow inputs, from the same templated source
//      as the energy: the coefficient functions over their scalar inputs
//      (r, kappa, the scale row, and for the Thole terms t_i, t_j, pol_i,
//      pol_j: 3 and 7 tangents), contracted with the coefficients' adjoints;
//      then the frame and the rotations over the 3 components of d,
//      contracted with the rotated values' adjoints, and r with dE/dr.
// Every branch of the forward (the degenerate seed, the frame guard, the
// damping floor, the sigmoid and Thole clips, the thole_damping cut) runs in
// the same source in step 4, so each takes autograd's side of it.
template <class S, int KIND, int LMAX>
__device__ __forceinline__ void pair_energy_grad(const S* d, bool degenerate, const S* fi,
                                                 const S* fj, const S* s, const S& kappa,
                                                 S* gd, S* gfi, S* gfj, S* gs, S& gk, S& e) {
  using D3 = Dual<3, S>;
  using D7 = Dual<7, S>;
  const S r = dsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  const S rinv = 1.0f / r;
  D3 dd[3];  // d over itself, for the last sweep
#pragma unroll
  for (int m = 0; m < 3; ++m) dd[m] = seed<3>(d[m], m);
  S gr;
  if constexpr (KIND == kUU) {
    // features: u_harm (z, x, y), pol, thole; radial projection, no frame
    const S ui_z = (fi[1] * d[0] + fi[2] * d[1] + fi[0] * d[2]) * rinv;
    const S uj_z = (fj[1] * d[0] + fj[2] * d[1] + fj[0] * d[2]) * rinv;
    const S ui_dot_uj = fi[1] * fj[1] + fi[2] * fj[2] + fi[0] * fj[0];
    const S dmp = damping_width(fi[3], fj[3]);
    S m0, m1;
    uu_coefficients(r, fi[4], fj[4], dmp, s[0], kappa, m0, m1);
    // e = m0 (uj_z ui_z) + m1 (ui.uj - uj_z ui_z)
    const S g_uiz = (m0 - m1) * uj_z, g_ujz = (m0 - m1) * ui_z;
    const S gm0 = uj_z * ui_z, gm1 = ui_dot_uj - uj_z * ui_z;
    gfi[1] = g_uiz * d[0] * rinv + m1 * fj[1];
    gfi[2] = g_uiz * d[1] * rinv + m1 * fj[2];
    gfi[0] = g_uiz * d[2] * rinv + m1 * fj[0];
    gfj[1] = g_ujz * d[0] * rinv + m1 * fi[1];
    gfj[2] = g_ujz * d[1] * rinv + m1 * fi[2];
    gfj[0] = g_ujz * d[2] * rinv + m1 * fi[0];
    {
      const D7 r7 = seed<7>(r, 0), k7 = seed<7>(kappa, 1), p7 = seed<7>(s[0], 2);
      const D7 dmp7 = damping_width(seed<7>(fi[3], 5), seed<7>(fj[3], 6));
      D7 m07, m17;
      uu_coefficients(r7, seed<7>(fi[4], 3), seed<7>(fj[4], 4), dmp7, p7, k7, m07, m17);
      const D7 eu = gm0 * m07 + gm1 * m17;
      e = eu.v;
      gr = eu.d[0];
      gk = eu.d[1];
      gs[0] = eu.d[2];
      gfi[4] = eu.d[3];
      gfj[4] = eu.d[4];
      gfi[3] = eu.d[5];
      gfj[3] = eu.d[6];
    }
    const D3 r3 = dsqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
    const D3 rinv3 = 1.0f / r3;
    const D3 ui3 = (fi[1] * dd[0] + fi[2] * dd[1] + fi[0] * dd[2]) * rinv3;
    const D3 uj3 = (fj[1] * dd[0] + fj[2] * dd[1] + fj[0] * dd[2]) * rinv3;
    const D3 acc = g_uiz * ui3 + g_ujz * uj3 + gr * r3;
#pragma unroll
    for (int m = 0; m < 3; ++m) gd[m] = acc.d[m];
  } else {
    constexpr int NH = Layout<KIND, LMAX>::NH;
    // 1. the forward
    S f[9];
    qi_frame(d[0], d[1], d[2], rinv, degenerate, f);
    S qi[NH], qj[NH];
    rotate_harm<S, LMAX>(fi, f, qi);
    rotate_harm<S, LMAX>(fj, f, qj);
    const S kr = kappa * r;
    const S x = 2.0f * dexp(-(kr * kr)) / kSqrtPi;
    PermCoef<S> pc;
    perm_coefficients<S, LMAX>(r, kr, x, s[0], pc);
    // 2. reverse through the contractions
    S gqi[NH], gqj[NH];
    PermCoef<S> gpc;
    perm_adjoint<S, LMAX>(qi, qj, pc, gqi, gqj, gpc);
    S gui[3], guj[3];
    IndCoef<S> gic;
    if constexpr (KIND == kPol) {
      S ui[3], uj[3];
      rotate_dipole(fi + NH, f, ui);
      rotate_dipole(fj + NH, f, uj);
      const S dmp = damping_width(fi[NH + 3], fj[NH + 3]);
      IndCoef<S> ic;
      induced_coefficients<S, LMAX>(r, fi[NH + 4], fj[NH + 4], dmp, s[1], kappa, ic);
      induced_adjoint<S, LMAX>(qi, qj, ui, uj, ic, gqi, gqj, gui, guj, gic);
      // 3. the dipoles' gradients
      rotate_dipole_t(gui, f, gfi + NH);
      rotate_dipole_t(guj, f, gfj + NH);
    }
    // 3. the harmonics' gradients
    rotate_harm_t<S, LMAX>(gqi, f, gfi);
    rotate_harm_t<S, LMAX>(gqj, f, gfj);
    // 4. the coefficients over (r, kappa, mscale) ...
    {
      const D3 k3 = seed<3>(kappa, 1), m3 = seed<3>(s[0], 2);
      const D3 rr = seed<3>(r, 0);
      const D3 kr3 = k3 * rr;
      const D3 x3 = 2.0f * dexp(-(kr3 * kr3)) / kSqrtPi;
      PermCoef<D3> c3;
      perm_coefficients<D3, LMAX>(rr, kr3, x3, m3, c3);
      const D3 ep = perm_contract<S, D3, LMAX>(gpc, c3);
      e = ep.v;
      gr = ep.d[0];
      gk = ep.d[1];
      gs[0] = ep.d[2];
    }
    // ... and over (r, kappa, pscale, t_i, t_j, pol_i, pol_j)
    if constexpr (KIND == kPol) {
      const D7 r7 = seed<7>(r, 0), k7 = seed<7>(kappa, 1), p7 = seed<7>(s[1], 2);
      const D7 dmp7 = damping_width(seed<7>(fi[NH + 3], 5), seed<7>(fj[NH + 3], 6));
      IndCoef<D7> c7;
      induced_coefficients<D7, LMAX>(r7, seed<7>(fi[NH + 4], 3), seed<7>(fj[NH + 4], 4), dmp7,
                                     p7, k7, c7);
      const D7 ei = induced_contract<S, D7, LMAX>(gic, c7);
      e = e + ei.v;
      gr = gr + ei.d[0];
      gk = gk + ei.d[1];
      gs[1] = ei.d[2];
      gfi[NH + 4] = ei.d[3];
      gfj[NH + 4] = ei.d[4];
      gfi[NH + 3] = ei.d[5];
      gfj[NH + 3] = ei.d[6];
    }
    // 4. the frame and the rotations over d
    const D3 r3 = dsqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
    const D3 rinv3 = 1.0f / r3;
    D3 f3[9];
    qi_frame(dd[0], dd[1], dd[2], rinv3, degenerate, f3);
    D3 acc = gr * r3;
    D3 q3[NH];
    rotate_harm<D3, LMAX, S>(fi, f3, q3);
#pragma unroll
    for (int k = 0; k < NH; ++k) acc = acc + gqi[k] * q3[k];
    rotate_harm<D3, LMAX, S>(fj, f3, q3);
#pragma unroll
    for (int k = 0; k < NH; ++k) acc = acc + gqj[k] * q3[k];
    if constexpr (KIND == kPol) {
      D3 u3[3];
      rotate_dipole<D3, S>(fi + NH, f3, u3);
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = acc + gui[k] * u3[k];
      rotate_dipole<D3, S>(fj + NH, f3, u3);
#pragma unroll
      for (int k = 0; k < 3; ++k) acc = acc + guj[k] * u3[k];
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) gd[m] = acc.d[m];
  }
}

// For pair p: the gradient of ct[p] e_p with respect to both rows, the
// scale rows and (accumulated into sg) the 19 scalars, from the mixed-mode
// gradient pair_energy_grad, evaluated in S. K2's body at S = float; K3's at
// S = Dual1, where every input carries its entry of the direction (ci, cj,
// cscl, cscal), so part() of each gradient entry is that entry of ct H c,
// and part(e) is J c, written to dct. K3b's at S = Hyper: every input also
// carries its entry of a second direction (hi, hj, hscl, hscal) as the delta
// tangent, and ct its entry of hct; part 0 of each gradient entry is then
// that entry of ct T[c, h] + hct H c, part 1 that of ct H h + hct grad e, and
// part 0 of e is h^T H c, written to dct. ri, rj: the pair's two input rows;
// ci, cj, hi, hj: their direction rows (read where S carries them); oi[J],
// oj[J]: its two output rows of part J (the kernels stage them in shared
// memory), dscl[J] and sg[J] its scale rows and scalars of part J (dscl[0]
// nullptr: the scale rows' gradient is not wanted, and no part is written).
// The per-pair outputs of a masked pair are zeros.
template <int KIND, int LMAX, class S>
__device__ __forceinline__ void pair_grad_parts(
    int p, int C, const float* __restrict__ ri, const float* __restrict__ rj,
    const float* __restrict__ scl, const float* __restrict__ scal,
    const float* __restrict__ ct, const float* __restrict__ ci,
    const float* __restrict__ cj, const float* __restrict__ cscl,
    const float* __restrict__ cscal, const float* __restrict__ hi,
    const float* __restrict__ hj, const float* __restrict__ hscl,
    const float* __restrict__ hscal, const float* __restrict__ hct, float* const* oi,
    float* const* oj, float* const* dscl, float* __restrict__ dct, float (*sg)[kNScal]) {
  using L = Layout<KIND, LMAX>;
  constexpr int F = L::F;
  constexpr int NF = L::NF;
  constexpr int NS = L::NS;
  constexpr int NP = kParts<S>;
  if (!(scl[C + p] > 0.5f)) {
    zero_pair<L, NP>(p, C, oi, oj, dscl, dct);
    return;
  }
  S a[F], b[F], box[9], binv[9];
#pragma unroll
  for (int k = 0; k < F; ++k) {
    a[k] = lift<S>(ri[k], ci, hi, k);
    b[k] = lift<S>(rj[k], cj, hj, k);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    box[k] = lift<S>(scal[1 + k], cscal, hscal, 1 + k);
    binv[k] = lift<S>(scal[10 + k], cscal, hscal, 10 + k);
  }
  const Wrapped<S> w = wrap(a, b, box, binv);
  const bool degenerate = (val(a[1]) == val(b[1])) && (val(a[2]) == val(b[2]));
  const typename CtOf<S>::type ctp = CtOf<S>::lift(ct[p], hct, p);
  S sv[NS];
  sv[0] = lift<S>(scl[p], cscl, hscl, p);
  if constexpr (NS > 1) sv[1] = lift<S>(scl[2 * C + p], cscl, hscl, 2 * C + p);
  const S kappa = lift<S>(scal[0], cscal, hscal, 0);
  S gd[3], gfi[NF], gfj[NF], gs[NS], gk, e;
  pair_energy_grad<S, KIND, LMAX>(w.d, degenerate, a + 3, b + 3, sv, kappa, gd, gfi, gfj, gs,
                                  gk, e);
  if (dct != nullptr) dct[p] = part<0>(e);
#pragma unroll
  for (int m = 0; m < NF; ++m) {
    const S x = ctp * gfi[m], y = ctp * gfj[m];
    oi[0][3 + m] = part<0>(x);
    oj[0][3 + m] = part<0>(y);
    if constexpr (NP > 1) {
      oi[1][3 + m] = part<1>(x);
      oj[1][3 + m] = part<1>(y);
    }
  }
  if (dscl[0] != nullptr) {
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const S x = ctp * gs[m];
      dscl[0][scale_row(m) * C + p] = part<0>(x);
      if constexpr (NP > 1) dscl[1][scale_row(m) * C + p] = part<1>(x);
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) dscl[j][C + p] = 0.f;  // the mask row
  }
  {
    const S x = ctp * gk;  // kappa
    sg[0][0] += part<0>(x);
    if constexpr (NP > 1) sg[1][0] += part<1>(x);
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) gd[m] = ctp * gd[m];
  wrap_grad(w, box, binv, gd, oi, oj, sg);
}

// K2's and K3's body (S = float, Dual1): pair_grad_parts with one part, the
// outputs as single rows
template <int KIND, int LMAX, class S>
__device__ __forceinline__ void pair_grad_mixed(
    int p, int C, const float* __restrict__ ri, const float* __restrict__ rj,
    const float* __restrict__ scl, const float* __restrict__ scal,
    const float* __restrict__ ct, const float* __restrict__ ci,
    const float* __restrict__ cj, const float* __restrict__ cscl,
    const float* __restrict__ cscal, float* __restrict__ oi, float* __restrict__ oj,
    float* __restrict__ dscl, float* __restrict__ dct, float* sg) {
  static_assert(kParts<S> == 1, "K3b's body is pair_grad_parts");
  float* const poi[1] = {oi};
  float* const poj[1] = {oj};
  float* const pdscl[1] = {dscl};
  pair_grad_parts<KIND, LMAX, S>(p, C, ri, rj, scl, scal, ct, ci, cj, cscl, cscal, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, poi, poj, pdscl, dct,
                                 reinterpret_cast<float(*)[kNScal]>(sg));
}

// A block's output rows, staged by its threads in s_out[0] and s_out[1]
// (thread t at row t, F floats each), stored from pair p0 on as two
// contiguous runs: coalesced, where a thread's own row stores would put 32
// rows under each store of a warp. Every thread of the block calls it, after
// the barrier that ends the staging.
template <int F>
__device__ __forceinline__ void store_rows(const float (&s_out)[2][kBlock * F], int p0, int C,
                                           float* __restrict__ oi, float* __restrict__ oj) {
  const int n = (C - p0 < kBlock ? C - p0 : kBlock) * F;
  const size_t first = static_cast<size_t>(p0) * F;
  for (int k = threadIdx.x; k < n; k += kBlock) {
    oi[first + k] = s_out[0][k];
    oj[first + k] = s_out[1][k];
  }
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
