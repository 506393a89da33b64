// The split-line core of the masked tridiagonal sweeps (K1, K2, K4).
//
// A line of n rows is cut into chunks of M rows, one chunk per thread:
//   (a) `Chunk::load` forms the chunk's rows in registers (a, c and b from a
//       16-entry table of the code's low bits, `fill_row_table`; the right-
//       hand side from the caller's `src`) and eliminates inside the chunk
//       (a downward pass, then an upward one), leaving its first and last
//       rows coupled only to the neighbouring chunks;
//   (b) those two rows of every chunk form a reduced tridiagonal system with
//       a unit diagonal: `seg_eliminate` folds a thread's consecutive chunks
//       to two rows, `pcr_reduced` (shared memory) or `warp_reduced` (warp
//       shuffles) solve the rest by cyclic reduction, `seg_finish` fills the
//       folded rows back in;
//   (c) `Chunk::x` back-substitutes each row from the chunk's registers.
// csrc/sweeps.cu explains the method, its pivoting and its rounding; the
// kernels that use it say how they lay lines and chunks over threads.
#pragma once

#include "common.cuh"

namespace {

template <typename C>
struct RowParams {
  C tg, dt, t_inf, rob_c;
};

// 1/x: the hardware's approximate reciprocal at float32 (within 1 ulp;
// every denominator here is >= 1 - |a| |c'| > 0), a division at float64.
__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double rcp(double x) { return 1.0 / x; }

// The row coefficients that depend on the code's low four bits alone:
// a, c, b (less dt*coeff when a coefficient field is given) and, plan-lite,
// dt*cf*t_inf; one entry per code in [0, 16), filled by threads 0-15.
// `pin_code` (plan-lite only): every bit-4 row has b = 1, the pin rule of
// fused_sweep_axis2_v2 (has_pin=True), which K2 takes when it is given
// plan-lite inputs alone.
template <typename C>
__device__ __forceinline__ void fill_row_table(C* tab, int t,
                                               const RowParams<C>& p,
                                               bool has_coeff, bool pin_code) {
  const C low = atf::bit<C>(t, atf::kLow);
  const C high = atf::bit<C>(t, atf::kHigh);
  tab[t] = -p.tg * low;
  tab[16 + t] = -p.tg * high;
  const C b0 = C(1) + p.tg * (low + high);
  if (has_coeff) {
    tab[32 + t] = b0;
    tab[48 + t] = C(0);
  } else {
    const C inm = atf::bit<C>(t, atf::kInMask);
    const C dtcf = p.dt * (p.rob_c * ((C(2) - low - high) * inm));
    tab[32 + t] = (pin_code && (t & atf::kPin)) ? C(1) : b0 + dtcf;
    tab[48 + t] = dtcf * p.t_inf;
  }
}

// One row of the system from its code and field values (the fold and pin).
template <typename C, bool kPinFromCode>
__device__ __forceinline__ void form_row(unsigned c, C r, bool has_coeff,
                                         C cfv, bool has_q, C q, bool has_pin,
                                         C dv, const RowParams<C>& p,
                                         const C* tab, C& a, C& b, C& cc,
                                         C& d) {
  const unsigned c4 = c & 15u;
  a = tab[c4];
  cc = tab[16 + c4];
  const bool pin = has_pin && (c & atf::kPin);
  if (has_q) r = r + p.dt * q;
  if (pin) r = dv;
  if (has_coeff) {
    const C dtcf = pin ? C(0) : p.dt * cfv;
    b = tab[32 + c4] + dtcf;
    d = r + dtcf * p.t_inf;
  } else {
    b = tab[32 + c4];
    d = r + tab[48 + c4];
  }
  if (kPinFromCode ? (c & atf::kPin) != 0u : pin) b = C(1);
}

// Phases (a) and (c) of one chunk of M rows (M >= 4).  `src(k, code, r,
// cf, q, dv)` fills row k's inputs (all zero past the line's end: an
// identity row).
template <typename C, int M, bool kPinFromCode>
struct Chunk {
  C a[M], c[M], d[M];

  template <typename Src>
  __device__ __forceinline__ void load(const Src& src, int64_t row0,
                                       int64_t n, bool has_coeff, bool has_q,
                                       bool has_pin, const RowParams<C>& p,
                                       const C* tab) {
    C b[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      unsigned cd;
      C r, cf, q, dv;
      src(k, cd, r, cf, q, dv);
      form_row<C, kPinFromCode>(cd, r, has_coeff, cf, has_q, q, has_pin, dv,
                                p, tab, a[k], b[k], c[k], d[k]);
      if (row0 + k == 0) a[k] = C(0);
      if (row0 + k == n - 1) c[k] = C(0);
    }
    // downward: row k >= 1 becomes a'_k x_first + x_k + c'_k x_{k+1} = d'_k
    C r = rcp(b[0]);
    a[0] *= r;
    c[0] *= r;
    d[0] *= r;
    r = rcp(b[1]);
    a[1] *= r;
    c[1] *= r;
    d[1] *= r;
#pragma unroll
    for (int k = 2; k < M; ++k) {
      r = rcp(b[k] - a[k] * c[k - 1]);
      d[k] = r * (d[k] - a[k] * d[k - 1]);
      a[k] = -r * (a[k] * a[k - 1]);
      c[k] = r * c[k];
    }
    // upward: rows 1..M-2 couple to x_first and x_last only; row 0 to the
    // previous chunk's last unknown and x_last
#pragma unroll
    for (int k = M - 3; k >= 1; --k) {
      d[k] = d[k] - c[k] * d[k + 1];
      a[k] = a[k] - c[k] * a[k + 1];
      c[k] = -c[k] * c[k + 1];
    }
    r = rcp(C(1) - c[0] * a[1]);
    d[0] = r * (d[0] - c[0] * d[1]);
    a[0] = r * a[0];
    c[0] = -r * (c[0] * c[1]);
  }

  __device__ __forceinline__ C x(int k, C x_first, C x_last) const {
    if (k == 0) return x_first;
    if (k == M - 1) return x_last;
    return d[k] - a[k] * x_first - c[k] * x_last;
  }

  // the chunk's two rows of the reduced system (rows 2j, 2j+1 at stride s)
  __device__ __forceinline__ void put_reduced(C* A, C* Cc, C* D, int64_t i0,
                                              int64_t i1) const {
    A[i0] = a[0];
    Cc[i0] = c[0];
    D[i0] = d[0];
    A[i1] = a[M - 1];
    Cc[i1] = c[M - 1];
    D[i1] = d[M - 1];
  }
};

// Phase (b): parallel cyclic reduction (PCR) of the reduced system.  Step
// s folds rows i-s and i+s into row i (unit diagonal kept), so after
// ceil(log2 rows) steps every row stands alone and D holds the unknowns.
// Rows ping-pong between (A, Cc, D) and the scratch (A2, Cc2, D2); this
// thread updates rows first, first+step, ...; `sync` orders the steps
// (the block's or the warp's barrier).  Returns the array holding x.
template <typename C, typename Sync>
__device__ __forceinline__ C* pcr_reduced(C* A, C* Cc, C* D, C* A2, C* Cc2,
                                          C* D2, int rows, int stride,
                                          int base, int first, int step,
                                          const Sync& sync) {
  for (int s = 1; s < rows; s *= 2) {
    for (int i = first; i < rows; i += step) {
      const int o = base + i * stride;
      const C a = A[o], c = Cc[o];
      C am = C(0), cm = C(0), dm = C(0), ap = C(0), cp = C(0), dp = C(0);
      if (i >= s) {
        const int om = o - s * stride;
        am = A[om];
        cm = Cc[om];
        dm = D[om];
      }
      if (i + s < rows) {
        const int op = o + s * stride;
        ap = A[op];
        cp = Cc[op];
        dp = D[op];
      }
      const C inv = rcp(C(1) - a * cm - c * ap);
      A2[o] = -(a * am) * inv;
      Cc2[o] = -(c * cp) * inv;
      D2[o] = (D[o] - a * dm - c * dp) * inv;
    }
    sync();
    C* t = A;
    A = A2;
    A2 = t;
    t = Cc;
    Cc = Cc2;
    Cc2 = t;
    t = D;
    D = D2;
    D2 = t;
  }
  return D;
}

// The chunk elimination again, on `cnt` unit-diagonal rows of the reduced
// system at A/Cc/D[o0 + k*st] (in place): a thread's consecutive chunks
// reduce to the first and last of their rows, coupled to the neighbouring
// threads' rows only.  `seg_finish` fills the inner rows once those two
// are known.
template <typename C>
__device__ __forceinline__ void seg_eliminate(C* A, C* Cc, C* D, int o0,
                                              int st, int cnt) {
  for (int k = 2; k < cnt; ++k) {
    const int o = o0 + k * st, op = o - st;
    const C a = A[o];
    const C r = rcp(C(1) - a * Cc[op]);
    D[o] = r * (D[o] - a * D[op]);
    A[o] = -r * (a * A[op]);
    Cc[o] = r * Cc[o];
  }
  for (int k = cnt - 3; k >= 1; --k) {
    const int o = o0 + k * st, on = o + st;
    const C c = Cc[o];
    D[o] = D[o] - c * D[on];
    A[o] = A[o] - c * A[on];
    Cc[o] = -c * Cc[on];
  }
  if (cnt >= 3) {
    const int o1 = o0 + st;
    const C c0 = Cc[o0];
    const C r = rcp(C(1) - c0 * A[o1]);
    D[o0] = r * (D[o0] - c0 * D[o1]);
    A[o0] = r * A[o0];
    Cc[o0] = -r * (c0 * Cc[o1]);
  }
}

template <typename C>
__device__ __forceinline__ void seg_finish(const C* A, const C* Cc, C* D,
                                           int o0, int st, int cnt, C u0,
                                           C u1) {
  for (int k = 1; k < cnt - 1; ++k) {
    const int o = o0 + k * st;
    D[o] = D[o] - A[o] * u0 - Cc[o] * u1;
  }
  D[o0] = u0;
  D[o0 + (cnt - 1) * st] = u1;
}

// Phase (b) for a line of 32 chunks, one per lane, in registers: each
// lane's last unknown absorbs its own first row and the next lane's (one
// step of cyclic reduction), the 32 rows left go through PCR over warp
// shuffles, and each first unknown follows from its row.  (a0, c0, d0)
// and (a1, c1, d1): the lane's first and last reduced rows.
template <typename C>
__device__ __forceinline__ void warp_reduced(C a0, C c0, C d0, C a1, C c1,
                                             C d1, int lane, C& u0, C& u1) {
  constexpr unsigned kAll = 0xffffffffu;
  C na = __shfl_down_sync(kAll, a0, 1);
  C nc = __shfl_down_sync(kAll, c0, 1);
  C nd = __shfl_down_sync(kAll, d0, 1);
  if (lane == 31) na = nc = nd = C(0);
  C inv = rcp(C(1) - a1 * c0 - c1 * na);
  C A = -(a1 * a0) * inv;
  C Cc = -(c1 * nc) * inv;
  C D = (d1 - a1 * d0 - c1 * nd) * inv;
#pragma unroll
  for (int s = 1; s < 32; s *= 2) {
    C am = __shfl_up_sync(kAll, A, s), cm = __shfl_up_sync(kAll, Cc, s);
    C dm = __shfl_up_sync(kAll, D, s);
    C ap = __shfl_down_sync(kAll, A, s), cp = __shfl_down_sync(kAll, Cc, s);
    C dp = __shfl_down_sync(kAll, D, s);
    if (lane < s) am = cm = dm = C(0);
    if (lane + s >= 32) ap = cp = dp = C(0);
    inv = rcp(C(1) - A * cm - Cc * ap);
    const C nA = -(A * am) * inv, nC = -(Cc * cp) * inv;
    D = (D - A * dm - Cc * dp) * inv;
    A = nA;
    Cc = nC;
  }
  u1 = D;
  C prev = __shfl_up_sync(kAll, u1, 1);
  if (lane == 0) prev = C(0);
  u0 = d0 - a0 * prev - c0 * u1;
}

// The largest dynamic shared memory a block may take (H100: 227 KB), less
// 1 KB for the kernels' static row table.
inline int smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes - 1024;
}

}  // namespace
