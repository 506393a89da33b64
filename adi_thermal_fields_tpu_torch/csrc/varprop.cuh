// Device helpers of the variable-property kernels K5-K8 and K15-K20:
// property tables as clamp-sums, the harmonic face mean, the Picard
// radiative film, the explicit theta term and the stream-reading row.
//
// A table reaches a kernel by value as a small POD struct (kernel
// parameter space, __grid_constant__: no local copy) holding at most
// kMaxSeg segments -- 32 breakpoints.  The host (solvers/varprop.py
// table_segments) computes the slopes in float64 and drops the segments
// with no value change; here they are held at the field's type T:
//   v(x) = v0 + sum_i s_i * clamp(x - p_i, 0, dp_i)     (dp_i > 0)
//        +      sum_i s_i * (x > p_i)                  (dp_i == 0: a step)
// in table order, as the plain versions evaluate them.
#pragma once

#include "common.cuh"

namespace atf {

constexpr int kMaxSeg = 31;

template <typename T>
struct Table {
  int n;            // segments in use
  T v0;
  T p[kMaxSeg];
  T dp[kMaxSeg];
  T s[kMaxSeg];
};

// Fills `tab` from the host buffer [v0, p0, dp0, s0, p1, ...], the
// segments past n with zero slopes (p 0, dp 1, s 0: they add 0); false
// when the segment count is out of range.
template <typename T>
inline bool make_table(const double* buf, int n, Table<T>* tab) {
  if (n < 0 || n > kMaxSeg || buf == nullptr) return false;
  tab->n = n;
  tab->v0 = (T)buf[0];
  for (int i = 0; i < kMaxSeg; ++i) {
    tab->p[i] = i < n ? (T)buf[1 + 3 * i] : T(0);
    tab->dp[i] = i < n ? (T)buf[2 + 3 * i] : T(1);
    tab->s[i] = i < n ? (T)buf[3 + 3 * i] : T(0);
  }
  return true;
}

template <typename T>
__device__ __forceinline__ T clamp_sum(const Table<T>& tab, T x) {
  T acc = tab.v0;
#pragma unroll
  for (int i = 0; i < kMaxSeg; ++i) {
    if (i >= tab.n) break;
    if (tab.dp[i] > T(0)) {
      T c = x - tab.p[i];
      c = c > T(0) ? c : T(0);
      c = c < tab.dp[i] ? c : tab.dp[i];
      acc = acc + tab.s[i] * c;
    } else {
      acc = acc + ((x > tab.p[i]) ? tab.s[i] : T(0));
    }
  }
  return acc;
}

// 2 a b / (a + b), zero where the sum is not positive.
template <typename T>
__device__ __forceinline__ T harm(T a, T b) {
  const T den = a + b;
  return den > T(0) ? T(2) * a * b / den : T(0);
}

// eps*sigma*(Tk + Tik)*(Tk^2 + Tik^2) with Tk = x + 273.15; the host
// passes rc = eps*sigma, tik and tik2 = Tik^2 rounded as its plain version
// forms them.
template <typename T>
__device__ __forceinline__ T rad_film(T x, T rc, T tik, T tik2) {
  const T tk = x + T(273.15);
  return rc * (tk + tik) * (tk * tk + tik2);
}

// The same three functions with one IEEE rounding per operation (the _rn
// helpers of common.cuh, never contracted into an FMA), in the plain
// versions' order: K8 (both forms), K15 and K16 evaluate k, cp, the faces
// and the films bit for bit as their plain versions do with them.  (K5
// keeps the contracted ones above: on these it ran 9% slower, PERF.md.)
//
// kUnroll: how far the segment loop unrolls (fully by default; a kernel
// that inlines many evaluations, K8, keeps it rolled: its code, and its
// build, stay small).
template <typename T, int kUnroll = kMaxSeg>
__device__ __forceinline__ T clamp_sum_rn(const Table<T>& tab, T x) {
  T acc = tab.v0;
#pragma unroll (kUnroll)
  for (int i = 0; i < kMaxSeg; ++i) {
    if (i >= tab.n) break;
    if (tab.dp[i] > T(0)) {
      T c = sub(x, tab.p[i]);
      c = c > T(0) ? c : T(0);
      c = c < tab.dp[i] ? c : tab.dp[i];
      acc = add(acc, mul(tab.s[i], c));
    } else {
      acc = add(acc, (x > tab.p[i]) ? tab.s[i] : T(0));
    }
  }
  return acc;
}

// clamp_sum_rn over the first K segments without a branch, for tables of
// at most K segments (make_table pads the rest with zero slopes, which add
// 0): s*(x > p) for a step is s*1 or s*0, so the sum is clamp_sum_rn's bit
// for bit.
template <typename T, int K>
__device__ __forceinline__ T clamp_sum_rn_upto(const Table<T>& tab, T x) {
  T acc = tab.v0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    T c = sub(x, tab.p[i]);
    c = c > T(0) ? c : T(0);
    c = c < tab.dp[i] ? c : tab.dp[i];
    c = tab.dp[i] > T(0) ? c : ((x > tab.p[i]) ? T(1) : T(0));
    acc = add(acc, mul(tab.s[i], c));
  }
  return acc;
}

// A property table at t.  kSeg > 0: the tables have at most kSeg
// segments, summed without a branch (clamp_sum_rn_upto); 0: any table,
// the segment loop rolled (unrolled, the many inlined evaluations of K8
// and K16 took the build from seconds to minutes and ran slower).
template <int kSeg, typename T>
__device__ __forceinline__ T table(const Table<T>& tab, T t) {
  if constexpr (kSeg > 0) {
    return clamp_sum_rn_upto<T, kSeg>(tab, t);
  } else {
    return clamp_sum_rn<T, 1>(tab, t);
  }
}

template <typename T>
__device__ __forceinline__ T harm_rn(T a, T b) {
  const T den = add(a, b);
  return den > T(0) ? div(mul(mul(T(2), a), b), den) : T(0);
}

template <typename T>
__device__ __forceinline__ T rad_film_rn(T x, T rc, T tik, T tik2) {
  const T tk = add(x, T(273.15));
  return mul(mul(rc, add(tk, tik)), add(mul(tk, tk), tik2));
}

// One axis of the explicit varprop theta pass (K6, K20):
// iv*(f_lo*(t_lo - t) + f_hi*(t_hi - t)), neighbours and faces zero past
// the domain edge.
template <typename T>
__device__ __forceinline__ T vp_face_term(T f_lo, T f_hi, T t_lo, T t_hi,
                                          T t, T iv) {
  return mul(add(mul(f_lo, sub(t_lo, t)), mul(f_hi, sub(t_hi, t))), iv);
}

// The explicit varprop theta pass of one cell (the _vp_rhs_kernel order,
// pallas_varprop.py:403-462): the faces x, then y, then z, and
//   d = t + (cw*gain)*acc,  gain = w*inm;
// the caller adds (cd*gain)*src.  K6 forms its rows' right-hand sides
// with it and K20 writes it as R0, so the two agree bit for bit (the
// unfused step, K20 -> K7x, equals the fused K6).
template <typename T>
__device__ __forceinline__ T vp_theta_d(T t, T fx_lo, T fx_hi, T tx_lo,
                                        T tx_hi, T fy_lo, T fy_hi, T ty_lo,
                                        T ty_hi, T fz_lo, T fz_hi, T tz_lo,
                                        T tz_hi, T gain, T cw, T iv_x,
                                        T iv_y, T iv_z) {
  T acc = vp_face_term(fx_lo, fx_hi, tx_lo, tx_hi, t, iv_x);
  acc = add(acc, vp_face_term(fy_lo, fy_hi, ty_lo, ty_hi, t, iv_y));
  acc = add(acc, vp_face_term(fz_lo, fz_hi, tz_lo, tz_hi, t, iv_z));
  return add(t, mul(mul(cw, gain), acc));
}

// One implicit row of the stream-reading varprop sweeps (K6, K7 and its x
// entry, K19; the rows of pallas_varprop._varprop_kernel :142-197):
//   tw = tg*w, a = -tw*f_lo, c = -tw*f_hi,
//   sink = (sk*h)*((2-low-high)*inm), sw = sink*w,
//   b = 1 + tw*(f_lo + f_hi) + sw, d += sw*t_inf,
// code bits 1/2/8 of sweep_code, one rounding per operation in the plain
// version's order (solvers/varprop._varprop_solve).  The kernels solve the
// rows on the split-line core (csrc/split_line.cuh).
template <typename T>
__device__ __forceinline__ void vp_row_coeffs(unsigned c, T f_lo, T f_hi,
                                              T wv, T hv, T d, T tg, T sk,
                                              T t_inf, T& a, T& b, T& cc,
                                              T& dd) {
  const T low = bit<T>(c, kLow);
  const T high = bit<T>(c, kHigh);
  const T inm = bit<T>(c, kInMask);
  const T sink = mul(mul(sk, hv), mul(sub(sub(T(2), low), high), inm));
  const T tw = mul(tg, wv);
  a = mul(-tw, f_lo);
  cc = mul(-tw, f_hi);
  const T sw = mul(sink, wv);
  b = add(add(T(1), mul(tw, add(f_lo, f_hi))), sw);
  dd = add(d, mul(sw, t_inf));
}

}  // namespace atf
