// The split-line core of the tridiagonal sweeps K1, K2, K4, K6-K8, K19,
// K17, K21 and K24-K26 (with csrc/split_staged.cuh for their contiguous z:
// K10 and K26 too) and,
// through csrc/split_cyclic.cuh, the periodic phi sweeps K11 and K16.
//
// A line of n rows is cut into chunks of M rows, one chunk per thread:
//   (a) `Chunk::load` forms the chunk's rows in registers (a, c and b from a
//       16-entry table of the code's low bits, `fill_row_table`; the right-
//       hand side from the caller's `src`; K1, K2, K4), `Chunk::load_rows`
//       takes them from the caller's row former (K6-K8, K10, K17, K19,
//       K21, K24-K26) and
//       `load_cyclic` (csrc/split_cyclic.cuh) those of a periodic line
//       (K11, K16), and all
//       eliminate inside the chunk (a downward pass, then an upward one),
//       leaving its first and last rows coupled only to the neighbouring
//       chunks;
//   (b) those two rows of every chunk form a reduced tridiagonal system with
//       a unit diagonal: `seg_eliminate` folds a thread's consecutive chunks
//       to two rows, `pcr_reduced` (shared memory) or `warp_reduced` (warp
//       shuffles) solve the rest by cyclic reduction, `seg_finish` fills the
//       folded rows back in (with a second right-hand side where kTwo: the
//       periodic lines' Sherman-Morrison column);
//   (c) `Chunk::x` back-substitutes each row from the chunk's registers.
// csrc/sweeps.cu explains the method, its pivoting and its rounding; the
// kernels that use it say how they lay lines and chunks over threads.
// kDiv (K11, K16): rounded divisions (atf::div) where the others multiply
// by the hardware's reciprocal, whose stiff rings amplify each rounding.
#pragma once

#include <type_traits>

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

// x / den as the core takes it: x times rcp(den), or where kDiv a rounded
// division.  neg(x) is -(x / den).
template <typename C, bool kDiv>
struct Over {
  C v;   // den where kDiv, else its reciprocal
  __device__ __forceinline__ explicit Over(C den) {
    if constexpr (kDiv) {
      v = den;
    } else {
      v = rcp(den);
    }
  }
  __device__ __forceinline__ C operator()(C x) const {
    if constexpr (kDiv) {
      return atf::div(x, v);
    } else {
      return v * x;
    }
  }
  __device__ __forceinline__ C neg(C x) const {
    if constexpr (kDiv) {
      return -atf::div(x, v);
    } else {
      return -v * x;
    }
  }
};

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

struct NoCheck {
  template <typename A>
  __device__ __forceinline__ void operator()(const A&, const A&,
                                             const A&) const {}
};

// Phases (a) and (c) of one chunk of M rows (M >= 4).  `load_rows` takes
// the rows from the caller's former, `rows(k, a, b, c, d)`, called for
// k = 0, 1, ..., M-1 in that order (a former may carry a value from row to
// row; rows past the line's end must be identity rows); `load` forms them
// from the code table (K1, K2, K4): `src(k, code, r, cf, q, dv)` fills row
// k's inputs (all zero past the line's end: an identity row);
// `load_cyclic` (csrc/split_cyclic.cuh) those of a periodic line.
template <typename C, int M, bool kPinFromCode, bool kDiv = false>
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
    eliminate(b);
  }

  // `check(a, b, c)`, where given, sees the chunk's rows once all are
  // formed, before they are eliminated (K17's and K21's stiffness test)
  template <typename Rows, typename Check = NoCheck>
  __device__ __forceinline__ void load_rows(const Rows& rows, int64_t row0,
                                            int64_t n,
                                            const Check& check = Check()) {
    C b[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      rows(k, a[k], b[k], c[k], d[k]);
      if (row0 + k == 0) a[k] = C(0);
      if (row0 + k == n - 1) c[k] = C(0);
    }
    check(a, b, c);
    eliminate(b);
  }

  // the downward and upward passes over the chunk's rows (diagonal b)
  __device__ __forceinline__ void eliminate(C (&b)[M]) {
    // downward: row k >= 1 becomes a'_k x_first + x_k + c'_k x_{k+1} = d'_k
    Over<C, kDiv> r(b[0]);
    a[0] = r(a[0]);
    c[0] = r(c[0]);
    d[0] = r(d[0]);
    r = Over<C, kDiv>(b[1]);
    a[1] = r(a[1]);
    c[1] = r(c[1]);
    d[1] = r(d[1]);
#pragma unroll
    for (int k = 2; k < M; ++k) {
      r = Over<C, kDiv>(b[k] - a[k] * c[k - 1]);
      d[k] = r(d[k] - a[k] * d[k - 1]);
      a[k] = r.neg(a[k] * a[k - 1]);
      c[k] = r(c[k]);
    }
    // upward: rows 1..M-2 couple to x_first and x_last only; row 0 to the
    // previous chunk's last unknown and x_last
#pragma unroll
    for (int k = M - 3; k >= 1; --k) {
      d[k] = d[k] - c[k] * d[k + 1];
      a[k] = a[k] - c[k] * a[k + 1];
      c[k] = -c[k] * c[k + 1];
    }
    r = Over<C, kDiv>(C(1) - c[0] * a[1]);
    d[0] = r(d[0] - c[0] * d[1]);
    a[0] = r(a[0]);
    c[0] = r.neg(c[0] * c[1]);
  }

  __device__ __forceinline__ C x(int k, C x_first, C x_last) const {
    if (k == 0) return x_first;
    if (k == M - 1) return x_last;
    return d[k] - a[k] * x_first - c[k] * x_last;
  }

  // row k of a second solution whose right-hand side is zero inside the
  // chunk (the periodic lines' z: csrc/split_cyclic.cuh)
  __device__ __forceinline__ C xz(int k, C x_first, C x_last) const {
    if (k == 0) return x_first;
    if (k == M - 1) return x_last;
    return -a[k] * x_first - c[k] * x_last;
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
// are known.  kTwo: Dz, a second right-hand side, alongside D.
template <typename C, bool kDiv = false, bool kTwo = false>
__device__ __forceinline__ void seg_eliminate(C* A, C* Cc, C* D, int o0,
                                              int st, int cnt,
                                              C* Dz = nullptr) {
  for (int k = 2; k < cnt; ++k) {
    const int o = o0 + k * st, op = o - st;
    const C a = A[o];
    const Over<C, kDiv> r(C(1) - a * Cc[op]);
    D[o] = r(D[o] - a * D[op]);
    if constexpr (kTwo) Dz[o] = r(Dz[o] - a * Dz[op]);
    A[o] = r.neg(a * A[op]);
    Cc[o] = r(Cc[o]);
  }
  for (int k = cnt - 3; k >= 1; --k) {
    const int o = o0 + k * st, on = o + st;
    const C c = Cc[o];
    D[o] = D[o] - c * D[on];
    if constexpr (kTwo) Dz[o] = Dz[o] - c * Dz[on];
    A[o] = A[o] - c * A[on];
    Cc[o] = -c * Cc[on];
  }
  if (cnt >= 3) {
    const int o1 = o0 + st;
    const C c0 = Cc[o0];
    const Over<C, kDiv> r(C(1) - c0 * A[o1]);
    D[o0] = r(D[o0] - c0 * D[o1]);
    if constexpr (kTwo) Dz[o0] = r(Dz[o0] - c0 * Dz[o1]);
    A[o0] = r(A[o0]);
    Cc[o0] = r.neg(c0 * Cc[o1]);
  }
}

template <typename C, bool kTwo = false>
__device__ __forceinline__ void seg_finish(const C* A, const C* Cc, C* D,
                                           int o0, int st, int cnt, C u0,
                                           C u1, C* Dz = nullptr,
                                           C v0 = C(0), C v1 = C(0)) {
  for (int k = 1; k < cnt - 1; ++k) {
    const int o = o0 + k * st;
    D[o] = D[o] - A[o] * u0 - Cc[o] * u1;
    if constexpr (kTwo) Dz[o] = Dz[o] - A[o] * v0 - Cc[o] * v1;
  }
  D[o0] = u0;
  D[o0 + (cnt - 1) * st] = u1;
  if constexpr (kTwo) {
    Dz[o0] = v0;
    Dz[o0 + (cnt - 1) * st] = v1;
  }
}

// Phase (b) for a line of 32 chunks, one per lane, in registers: each
// lane's last unknown absorbs its own first row and the next lane's (one
// step of cyclic reduction), the 32 rows left go through PCR over warp
// shuffles, and each first unknown follows from its row.  (a0, c0, d0)
// and (a1, c1, d1): the lane's first and last reduced rows; kTwo: z0, z1
// their second right-hand side, whose solution goes to v[0], v[1].
template <typename C, bool kDiv = false, bool kTwo = false>
__device__ __forceinline__ void warp_reduced(C a0, C c0, C d0, C a1, C c1,
                                             C d1, int lane, C& u0, C& u1,
                                             C z0 = C(0), C z1 = C(0),
                                             C* v = nullptr) {
  constexpr unsigned kAll = 0xffffffffu;
  C na = __shfl_down_sync(kAll, a0, 1);
  C nc = __shfl_down_sync(kAll, c0, 1);
  C nd = __shfl_down_sync(kAll, d0, 1);
  C nz = C(0);
  if constexpr (kTwo) nz = __shfl_down_sync(kAll, z0, 1);
  if (lane == 31) na = nc = nd = nz = C(0);
  Over<C, kDiv> inv(C(1) - a1 * c0 - c1 * na);
  C A = inv.neg(a1 * a0);
  C Cc = inv.neg(c1 * nc);
  C D = inv(d1 - a1 * d0 - c1 * nd);
  C Z = C(0);
  if constexpr (kTwo) Z = inv(z1 - a1 * z0 - c1 * nz);
#pragma unroll
  for (int s = 1; s < 32; s *= 2) {
    C am = __shfl_up_sync(kAll, A, s), cm = __shfl_up_sync(kAll, Cc, s);
    C dm = __shfl_up_sync(kAll, D, s);
    C ap = __shfl_down_sync(kAll, A, s), cp = __shfl_down_sync(kAll, Cc, s);
    C dp = __shfl_down_sync(kAll, D, s);
    C zm = C(0), zp = C(0);
    if constexpr (kTwo) {
      zm = __shfl_up_sync(kAll, Z, s);
      zp = __shfl_down_sync(kAll, Z, s);
    }
    if (lane < s) am = cm = dm = zm = C(0);
    if (lane + s >= 32) ap = cp = dp = zp = C(0);
    inv = Over<C, kDiv>(C(1) - A * cm - Cc * ap);
    const C nA = inv.neg(A * am), nC = inv.neg(Cc * cp);
    D = inv(D - A * dm - Cc * dp);
    if constexpr (kTwo) Z = inv(Z - A * zm - Cc * zp);
    A = nA;
    Cc = nC;
  }
  u1 = D;
  C prev = __shfl_up_sync(kAll, u1, 1);
  if (lane == 0) prev = C(0);
  u0 = d0 - a0 * prev - c0 * u1;
  if constexpr (kTwo) {
    v[1] = Z;
    C zprev = __shfl_up_sync(kAll, Z, 1);
    if (lane == 0) zprev = C(0);
    v[0] = z0 - a0 * zprev - c0 * Z;
  }
}

// Phase (b) on warp shuffles (W <= 32): each thread's 2R reduced rows (its
// R consecutive chunks) reduce to their first and last (`seg_eliminate`);
// each line's 2W segment rows then go through one warp, lane s holding
// segment s's first and last rows (`warp_reduced`; lanes past W hold
// identity rows), so the block meets at two barriers (K1's PCR across the
// warps in shared memory takes one a step); then the inner rows follow.
// S2 holds 3 x 2W x 33 values (rows of 32 lines, padded so that the
// lanes' writes hit distinct banks and their reads at most two a bank);
// kTwo: 4 x 2W x 33, the right-hand side Dz solved alongside D.
template <typename C, bool kDiv = false, bool kTwo = false>
__device__ __forceinline__ void block_reduced_warps(C* A, C* Cc, C* D,
                                                    C* S2, int lane, int w,
                                                    int W, int R,
                                                    C* Dz = nullptr) {
  const int o0 = (2 * w * R) * 32 + lane, cnt = 2 * R;
  seg_eliminate<C, kDiv, kTwo>(A, Cc, D, o0, 32, cnt, Dz);
  const int last = o0 + (cnt - 1) * 32;
  C* Sa = S2;
  C* Sc = Sa + 2 * W * 33;
  C* Sd = Sc + 2 * W * 33;
  C* Sz = Sd + 2 * W * 33;
  const int f = (2 * w) * 33 + lane, l = f + 33;
  Sa[f] = A[o0];
  Sc[f] = Cc[o0];
  Sd[f] = D[o0];
  Sa[l] = A[last];
  Sc[l] = Cc[last];
  Sd[l] = D[last];
  if constexpr (kTwo) {
    Sz[f] = Dz[o0];
    Sz[l] = Dz[last];
  }
  __syncthreads();
  for (int line = w; line < 32; line += W) {     // lane = segment
    const bool seg = lane < W;
    const int g = (2 * lane) * 33 + line, h = g + 33;
    C u0, u1, v[2];
    warp_reduced<C, kDiv, kTwo>(
        seg ? Sa[g] : C(0), seg ? Sc[g] : C(0), seg ? Sd[g] : C(0),
        seg ? Sa[h] : C(0), seg ? Sc[h] : C(0), seg ? Sd[h] : C(0), lane, u0,
        u1, kTwo && seg ? Sz[g] : C(0), kTwo && seg ? Sz[h] : C(0), v);
    if (seg) {
      Sd[g] = u0;
      Sd[h] = u1;
      if constexpr (kTwo) {
        Sz[g] = v[0];
        Sz[h] = v[1];
      }
    }
  }
  __syncthreads();
  if constexpr (kTwo) {                          // this thread's rows
    seg_finish<C, true>(A, Cc, D, o0, 32, cnt, Sd[f], Sd[l], Dz, Sz[f],
                        Sz[l]);
  } else {
    seg_finish(A, Cc, D, o0, 32, cnt, Sd[f], Sd[l]);
  }
}

// Staging for the kernels that own a line per warp (K2, K8; K13's tiles):
// cp.async copies of 4, 8 or 16 bytes into shared memory, and the padded
// layout of a group of W lines.
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  } else {                                       // 16 bytes, past the L1
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one element into the tile: asynchronous where the types agree in a 4- or
// 8-byte word, else a plain load (bfloat16)
template <typename T, typename S>
__device__ __forceinline__ void stage(T* dst, const S* src) {
  if constexpr (std::is_same_v<T, S> && sizeof(S) >= 4) {
    cp_async(dst, src, (int)sizeof(S));
  } else if constexpr (std::is_same_v<T, S>) {
    *dst = *src;
  } else {
    *dst = atf::ld(src);
  }
}

// The shared-memory layout of one staged group of W lines.
struct ZLayout {
  int W, pitch, cpitch;          // elements per line: values, code bytes
  size_t x_bytes, f_bytes, c_bytes, buf_bytes;
};

template <typename S, typename C, int M>
ZLayout z_layout(int W, int64_t n, int nfields) {
  ZLayout L;
  const int nch = (int)atf::cdiv(n, M);
  L.W = W;
  L.pitch = nch * (M + 1);
  L.cpitch = nch * (M + 4);
  auto up16 = [](size_t b) { return (b + 15) / 16 * 16; };
  L.x_bytes = up16((size_t)W * L.pitch * sizeof(C));
  L.f_bytes = up16((size_t)W * L.pitch * sizeof(S));
  L.c_bytes = up16((size_t)W * L.cpitch);
  L.buf_bytes = L.x_bytes + nfields * L.f_bytes + L.c_bytes;
  return L;
}

template <typename C>
size_t z_reduced_bytes(int W, int R) {
  return 6 * sizeof(C) * (size_t)W * 2 * 32 * R;
}

// The largest dynamic shared memory a block may take (H100: 227 KB), less
// 1 KB for the kernels' static row table.
inline int smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes - 1024;
}

// Rows r and r + 1 of a warp's 32 adjacent bfloat16 lines by one 4-byte
// load a lane: lanes 0-15 load the line pair (2h, 2h + 1) of row r, lanes
// 16-31 that of row r + 1, at p[q + (r or r + 1)*rs] with q the pair's
// offset (even, as rs); each lane takes its own line's two values by
// shuffle (v[0] row r, v[1] row r + 1).  `ok`: the pair is read (rows in
// [0, n)), else its values are 0.  A warp's load moves 128 bytes, not 64:
// at bfloat16 the strided sweeps are bound by the loads in flight, not
// bytes (one 2-byte load a value ran K25 at 0.55 ms against 0.42, K24 at
// 1.15 against 1.00; PERF.md section 6).  K6's rows at bfloat16
// (csrc/varprop_sweeps.cu) read theirs the same way.
__device__ __forceinline__ void ld_pair(const __nv_bfloat16* p, int64_t q,
                                        int64_t rs, int64_t r, int64_t n,
                                        bool ok, float (&v)[2]) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t row = r + (lane >> 4);
  uint32_t w = 0;
  if (ok && row >= 0 && row < n) {
    w = *reinterpret_cast<const uint32_t*>(p + q + row * rs);
  }
  const uint32_t lo = __shfl_sync(kAll, w, lane >> 1);
  const uint32_t hi = __shfl_sync(kAll, w, 16 + (lane >> 1));
  v[0] = __uint_as_float(lane & 1 ? lo & 0xffff0000u : lo << 16);
  v[1] = __uint_as_float(lane & 1 ? hi & 0xffff0000u : hi << 16);
}

// the pair this lane loads: (its line's offset - lane) + 2 (lane % 16), and
// whether the pair holds lines (both or neither: B2 even)
__device__ __forceinline__ int64_t pair_offset(int64_t base) {
  const int lane = threadIdx.x & 31;
  return base - lane + 2 * (lane & 15);
}
__device__ __forceinline__ bool pair_valid(bool valid) {
  const int lane = threadIdx.x & 31;
  return ((__ballot_sync(0xffffffffu, valid) >> (2 * (lane & 15))) & 1u) !=
         0u;
}

// ---------------------------------------------------------------------------
// A split-line sweep along a strided axis with the caller's rows (K6, K7,
// K7x, K24, K25; K8's and the staged kernel's lines too long to stage)
// ---------------------------------------------------------------------------
//
// K1's layout (csrc/sweeps.cu): a warp's lanes are 32 lines adjacent in B2,
// so a row's loads and stores are coalesced; the block's W warps split the
// lines' chunks, warp w owning chunks [w R, (w+1) R).  Phase (b) runs on
// warp shuffles (`block_reduced_warps`, as K4); phase (c) takes a thread's
// chunks but the last from their eliminated inner rows, kept in shared
// memory where they fit (kKeepRows: lines of up to 512 rows at float32,
// 256 at float64), else forms them again, as K1 reloads its inputs: from
// one value a row that the row former kept in shared memory in phase (a)
// where it keeps one (kKeepRhs: K6 and K24 their right-hand sides, the
// stencil's result, as K4 does; up to 1,024 rows at float32, 512 at
// float64), else from its inputs.  `Rows` forms a chunk: `rows.load(ch,
// base, rs, row0, n, valid)` loads and eliminates rows row0 .. row0 + M - 1
// of the line whose row i lies at base + i*rs (identity rows past n, and
// for a lane
// past the last line, `valid` false); a former that keeps a value a row
// (`kKeepsRhs`) also takes `load(..., kept, stride)` (kept[k*stride]:
// row k's value, stored where kept is not null; a former that replays
// takes `stiff` after them) and `reload(..., kept, stride)`, which forms
// the rows again from them.  Memory: the reduced rows (A, Cc, D: 2WR rows
// of 32 lines) in shared memory, or (kGlobal, lines too long for it) in
// `gred`, then phase (b)'s segment rows (3 x 2W x 33).  M = 8 rows a thread
// (16, then global reduced rows, where a line's reduced rows would not
// fit: past 2,048 and 4,096 rows at float32, 1,024 and 2,048 at
// float64); one block an SM, of W = 32 warps at float32 (64 registers)
// and 16 at float64.  On the H100 (PERF.md §6, K7 at 512^3) 32 warps of
// 8-row chunks (two chunks a thread, one formed again in phase (c)) ran
// 8-12% faster than two 16-warp blocks an SM (four chunks a thread), and
// 16-row chunks (128 registers) 30% slower; keeping the first chunk's
// eliminated rows instead of forming them again took another 19%.
template <typename C>
constexpr int kSplitWarps = sizeof(C) == 4 ? 32 : 16;

// The block's warps and the blocks an SM its registers are held to
// (__launch_bounds__): Rows::kWarps and Rows::kMinBlocks where the former
// sets them (K24, K25), else kSplitWarps<C> and 1.  With more than one
// block an SM, a line's rows are kept only where that many blocks' shared
// memory fits.
template <typename Rows, typename C, typename = void>
struct SplitShape {
  static constexpr int kWarps = kSplitWarps<C>, kBlocks = 1;
};
template <typename Rows, typename C>
struct SplitShape<Rows, C, std::void_t<decltype(Rows::kWarps)>> {
  static constexpr int kWarps = Rows::kWarps, kBlocks = Rows::kMinBlocks;
};

// What shared memory keeps of a thread's chunks but the last for phase
// (c): nothing (they are formed again from the inputs), their eliminated
// inner rows (a', c', d': (R-1) x (M-2) x 3 values a thread), or the row
// former's value of each row ((R-1) x M values a thread).
constexpr int kKeepNone = 0, kKeepRows = 1, kKeepRhs = 2;

// Rows::kKeepsRhs where the former keeps a value a row (K6, K24), else
// false.
template <typename Rows, typename = void>
struct KeepsRhs : std::false_type {};
template <typename Rows>
struct KeepsRhs<Rows, std::void_t<decltype(Rows::kKeepsRhs)>>
    : std::bool_constant<Rows::kKeepsRhs> {};

// Rows::kReplay where the former replays stiff blocks (K17, K21 and K24-K26
// at float32), else false: a block with a row past the former's ratio solves
// its lines again in Thomas order (`Rows::replay`, csrc/field_rows.cuh)
// instead of phases (b) and (c).
template <typename Rows, typename = void>
struct StiffRows : std::false_type {};
template <typename Rows>
struct StiffRows<Rows, std::void_t<decltype(Rows::kReplay)>>
    : std::bool_constant<Rows::kReplay> {};

template <typename C>
size_t split_smem_bytes(int W, int R, int M, bool global, int keep) {
  const size_t kept = keep == kKeepRows  ? (size_t)(M - 2) * 3
                      : keep == kKeepRhs ? (size_t)M
                                         : 0;
  return sizeof(C) * ((size_t)33 * 3 * 2 * W +
                      (global ? 0 : (size_t)32 * 3 * 2 * W * R) +
                      (size_t)32 * W * (R - 1) * kept);
}

template <typename S, typename C, typename Rows, int M, bool kGlobal,
          int kKeep>
__global__ void __launch_bounds__(32 * SplitShape<Rows, C>::kWarps,
                                  SplitShape<Rows, C>::kBlocks)
    split_strided_kernel(const __grid_constant__ Rows rows,
                         S* __restrict__ out, int64_t n, int64_t B2,
                         int64_t ls, int64_t rs, int R,
                         C* __restrict__ gred, int64_t key) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int red = 2 * W * R;                      // reduced rows per line
  C* A = kGlobal ? gred + (size_t)blockIdx.x * 3 * red * 32
                 : reinterpret_cast<C*>(atf_smem);
  C* Cc = A + red * 32;
  C* D = Cc + red * 32;
  C* S2 = kGlobal ? reinterpret_cast<C*>(atf_smem) : D + red * 32;
  // value v of inner row k of the thread's chunk r (kKeepRows); the
  // former's values of chunk r, row k at [k * blockDim.x] (kKeepRhs)
  C* keep = S2 + 3 * 2 * W * 33;
  auto kept = [&](int r, int k, int v) -> C& {
    return keep[((r * (M - 2) + k - 1) * 3 + v) * blockDim.x + threadIdx.x];
  };
  auto kept_rhs = [&](int r) {
    return keep + (size_t)r * M * blockDim.x + threadIdx.x;
  };

  const int64_t gpb = atf::cdiv(B2, 32);          // line groups per b1
  const int64_t b1 = blockIdx.x / gpb;
  const int64_t b2 = (blockIdx.x - b1 * gpb) * 32 + lane;
  const bool valid = b2 < B2;
  const int64_t base = b1 * n * B2 + b2 * ls;

  Chunk<C, M, false> ch;
  bool stiff = false;
  auto eliminate = [&](int j) {
    if constexpr (StiffRows<Rows>::value) {
      rows.load(ch, base, rs, (int64_t)j * M, n, valid, stiff);
    } else {
      rows.load(ch, base, rs, (int64_t)j * M, n, valid);
    }
  };
  auto store = [&](int j) {
    const C x0 = D[(2 * j) * 32 + lane];
    const C xl = D[(2 * j + 1) * 32 + lane];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = (int64_t)j * M + k;
      if (valid && i < n) {
        atf::st(&out[base + i * rs], ch.x(k, x0, xl), key, base + i * rs);
      }
    }
  };

  for (int r = 0; r < R; ++r) {                  // (a)
    const int j = w * R + r;
    if constexpr (kKeep == kKeepRhs) {
      C* const kr = r < R - 1 ? kept_rhs(r) : nullptr;
      if constexpr (StiffRows<Rows>::value) {
        rows.load(ch, base, rs, (int64_t)j * M, n, valid, kr,
                  (int)blockDim.x, stiff);
      } else {
        rows.load(ch, base, rs, (int64_t)j * M, n, valid, kr,
                  (int)blockDim.x);
      }
    } else {
      eliminate(j);
    }
    ch.put_reduced(A, Cc, D, (2 * j) * 32 + lane, (2 * j + 1) * 32 + lane);
    if (kKeep == kKeepRows && r < R - 1) {
#pragma unroll
      for (int k = 1; k < M - 1; ++k) {
        kept(r, k, 0) = ch.a[k];
        kept(r, k, 1) = ch.c[k];
        kept(r, k, 2) = ch.d[k];
      }
    }
  }
  if constexpr (StiffRows<Rows>::value) {          // Thomas order instead
    if (__syncthreads_or(stiff)) {
      if (w == 0) {
        rows.replay(out, base, rs, n, valid,
                    reinterpret_cast<C*>(atf_smem));
      }
      return;
    }
  }
  block_reduced_warps(A, Cc, D, S2, lane, w, W, R);   // (b)
  store(w * R + R - 1);                          // (c), last chunk first
  for (int r = 0; r < R - 1; ++r) {
    if constexpr (kKeep == kKeepRows) {
#pragma unroll
      for (int k = 1; k < M - 1; ++k) {
        ch.a[k] = kept(r, k, 0);
        ch.c[k] = kept(r, k, 1);
        ch.d[k] = kept(r, k, 2);
      }
    } else if constexpr (kKeep == kKeepRhs) {
      rows.reload(ch, base, rs, (int64_t)(w * R + r) * M, n, valid,
                  kept_rhs(r), (int)blockDim.x);
    } else {
      eliminate(w * R + r);
    }
    store(w * R + r);
  }
}

template <typename C, typename Rows, int M, bool kGlobal,
          int kKeep = kKeepNone, typename S = C>
cudaError_t launch_split_strided_m(const Rows& rows, S* out, int64_t B1,
                                   int64_t n, int64_t B2, int64_t ls,
                                   int64_t rs, cudaStream_t stream,
                                   int64_t key = -1) {
  static_assert(std::is_same_v<S, C> || !StiffRows<Rows>::value,
                "the Thomas-order replay writes d' into out at C");
  const int W = (int)atf::imin(SplitShape<Rows, C>::kWarps, atf::cdiv(n, M));
  const int R = (int)atf::cdiv(n, (int64_t)W * M);
  size_t smem = split_smem_bytes<C>(W, R, M, kGlobal, kKeep);
  if constexpr (StiffRows<Rows>::value) {        // a stiff block's replay
    smem = smem > Rows::replay_bytes(n) ? smem : Rows::replay_bytes(n);
  }
  const int64_t blocks = B1 * atf::cdiv(B2, 32);
  C* gred = nullptr;
  if (kGlobal) {
    const size_t bytes = sizeof(C) * (size_t)blocks * 3 * 2 * W * R * 32;
    const cudaError_t err =
        cudaMallocAsync(reinterpret_cast<void**>(&gred), bytes, stream);
    if (err != cudaSuccess) return err;
  }
  auto* kernel = split_strided_kernel<S, C, Rows, M, kGlobal, kKeep>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(rows, out, n, B2, ls,
                                                      rs, R, gred, key);
  if (kGlobal) {
    const cudaError_t launch_err = cudaGetLastError();
    const cudaError_t free_err = cudaFreeAsync(gred, stream);
    return launch_err != cudaSuccess ? launch_err : free_err;
  }
  return cudaSuccess;
}

// Lines b2 of groups b1 of a (B1, n, B2) field (line b2 of group b1 at
// b1*n*B2 + b2*ls, rows rs apart), solved with `rows`' rows at C into
// `out` (a storage type S: through atf::st with `key`, the cell's offset
// its counter).
template <typename C, typename Rows, typename S>
cudaError_t launch_split_strided(const Rows& rows, S* out, int64_t B1,
                                 int64_t n, int64_t B2, int64_t ls,
                                 int64_t rs, int device, cudaStream_t stream,
                                 int64_t key = -1) {
  using Shape = SplitShape<Rows, C>;
  auto fits = [&](int M, int keep) {
    const int W = (int)atf::imin(Shape::kWarps, atf::cdiv(n, M));
    return split_smem_bytes<C>(W, (int)atf::cdiv(n, (int64_t)W * M), M,
                               false, keep) <=
           (size_t)smem_limit(device) / Shape::kBlocks;
  };
  if (fits(8, kKeepRows)) {
    return launch_split_strided_m<C, Rows, 8, false, kKeepRows>(
        rows, out, B1, n, B2, ls, rs, stream, key);
  }
  if constexpr (KeepsRhs<Rows>::value) {
    if (fits(8, kKeepRhs)) {
      return launch_split_strided_m<C, Rows, 8, false, kKeepRhs>(
          rows, out, B1, n, B2, ls, rs, stream, key);
    }
  }
  if (fits(8, kKeepNone)) {
    return launch_split_strided_m<C, Rows, 8, false>(rows, out, B1, n, B2,
                                                     ls, rs, stream, key);
  }
  if (fits(16, false)) {
    return launch_split_strided_m<C, Rows, 16, false>(rows, out, B1, n, B2,
                                                      ls, rs, stream, key);
  }
  return launch_split_strided_m<C, Rows, 16, true>(rows, out, B1, n, B2, ls,
                                                   rs, stream, key);
}

}  // namespace
