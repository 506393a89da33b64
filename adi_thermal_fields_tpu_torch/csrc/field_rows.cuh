// The rows of the open stream-reading sweeps K21 (a/b/c/d fields) and K17
// (five physical streams) for the split-line core: the strided kernel of
// csrc/split_line.cuh (`load`: row i of the line at base + i*rs) and the
// staged kernel of csrc/split_staged.cuh (`load_staged`: the line's rows
// in shared memory).  Rows past the line's end are identity rows;
// `Chunk::load_rows` drops a[0] and c[n-1] (solvers/thomas.thomas
// semantics).
//
// Stiff lines: a Thomas solve and a split solve of the same rows part by
// about the condition number times a rounding, which grows with the rows'
// ratio (|a| + |c|) / (b - |a| - |c|).  On the H100 (scripts/open_tune.py,
// PERF.md section 6, PR 14), every block split, the largest distance from
// the plain version over five seeds was 6.2 float32 ulp of the output's
// scale for blocks of ratio 12-16, 6.8 at 16-24, 10.2 at 24-32 and 17 past
// 128, past the gate of 8; at float64 1e-11 K at ratio 90.  So at float32
// (kReplay) a line with a row past kOpenStiff is solved again in Thomas
// order (`open_replay`): thomas's operations, one rounding each, so its
// plain version bit for bit -- on the strided kernel its block's 32 lines
// by warp 0, on the staged kernel the lines it flags, by
// `staged_replay_kernel` (csrc/split_staged.cuh), 32 lines a warp.
#pragma once

#include <type_traits>

#include "split_cyclic.cuh"
#include "split_staged.cuh"

namespace {

// The stiffness ratio past which a block is replayed (PERF.md section 6,
// PR 14: scripts/open_tune.py on the H100).
constexpr double kOpenStiff = 16.0;

// A row past the ratio: off > kOpenStiff (b - off), off = |a| + |c|, as
// off > q b with q = kOpenStiff / (1 + kOpenStiff) (a[0] and c[n-1] do not
// count).  `Chunk::load_rows` runs it on a chunk's rows once all are
// formed: run as each row is formed, it held the strided kernel's loads
// back (K21 at 384^3: 0.69 against 0.51 ms, PERF.md section 6).
// `Ratio::kStiff` the ratio (K10's former its own: csrc/masked.cu).
struct OpenRatio {
  static constexpr double kStiff = kOpenStiff;
};

template <typename Ratio = OpenRatio>
struct StiffCheck {
  bool& stiff;
  template <typename A>
  __device__ __forceinline__ void operator()(const A& a, const A& b,
                                             const A& c) const {
    constexpr int M = sizeof(A) / sizeof(a[0]);
    const float q = float(Ratio::kStiff / (1.0 + Ratio::kStiff));
#pragma unroll
    for (int k = 0; k < M; ++k) {
      stiff = stiff || fabsf(a[k]) + fabsf(c[k]) > q * b[k];
    }
  }
};

// The check where the former replays (float32), else none.
template <bool kReplay, typename Ratio = OpenRatio>
__device__ __forceinline__ auto stiff_check(bool& stiff) {
  if constexpr (kReplay) {
    return StiffCheck<Ratio>{stiff};
  } else {
    return NoCheck{};
  }
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned b;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(b));
  return b;
}

// Rows a replay segment holds where a line's c' does not fit in shared
// memory: about sqrt(n), so that its c' and the checkpoints fit in
// open_replay_bytes.
__host__ __device__ inline int64_t replay_segment(int64_t n) {
  int64_t s = 1;
  while (s * s < n) ++s;
  return s;
}

// The least shared memory of a strided replay: a segment's c' and one
// checkpoint a segment, for 32 lines.
template <typename C>
size_t open_replay_bytes(int64_t n) {
  return sizeof(C) * 32 * (size_t)(2 * replay_segment(n) + 1);
}

// The strided kernel's replay (warp 0 of a stiff block; lanes = lines):
// thomas along the line at base + i*rs, `row(i, a, b, c, d)` forming row
// i.  d' goes to out and becomes x there; c' stays in shared memory `sm`,
// the whole line's where it fits, else a segment's, formed again from a
// checkpoint of c' (kept every S rows in the forward pass) before the
// segment's back substitution.  kRecip: thomas(reciprocal=True)'s order,
// one rounded reciprocal a row that c and d - a d' are multiplied by (K26),
// else two rounded divisions.
template <bool kRecip = false, typename C, typename RowFn>
__device__ __noinline__ void open_replay(const RowFn& row, C* out,
                                         int64_t base, int64_t rs, int64_t n,
                                         bool valid, C* sm) {
  using atf::div;
  using atf::mul;
  using atf::sub;
  const int lane = threadIdx.x & 31;
  const int64_t cap = dynamic_smem_bytes() / (32 * sizeof(C));
  const int64_t S = n + 1 <= cap ? n : replay_segment(n);
  const int64_t nseg = atf::cdiv(n, S);
  C* ck = sm + lane;                             // checkpoints of c'
  C* seg = sm + nseg * 32 + lane;                // a segment's c'
  if (!valid) return;
  C cp = C(0), dp = C(0);
#pragma unroll 4
  for (int64_t i = 0; i < n; ++i) {
    if (i % S == 0) ck[(i / S) * 32] = cp;
    C a, b, c, d;
    row(i, a, b, c, d);
    const C den = sub(b, mul(a, cp));
    if constexpr (kRecip) {
      const C inv = div(C(1), den);
      cp = mul(c, inv);
      dp = mul(sub(d, mul(a, dp)), inv);
    } else {
      cp = div(c, den);
      dp = div(sub(d, mul(a, dp)), den);
    }
    out[base + i * rs] = dp;
    if (nseg == 1) seg[i * 32] = cp;
  }
  C x = C(0);
  for (int64_t k = nseg - 1; k >= 0; --k) {
    const int64_t i0 = k * S, i1 = atf::imin(n, i0 + S);
    if (nseg > 1) {                              // c' of the segment again
      cp = ck[k * 32];
#pragma unroll 4
      for (int64_t i = i0; i < i1; ++i) {
        C a, b, c, d;
        row(i, a, b, c, d);
        if constexpr (kRecip) {
          cp = mul(c, div(C(1), sub(b, mul(a, cp))));
        } else {
          cp = div(c, sub(b, mul(a, cp)));
        }
        seg[(i - i0) * 32] = cp;
      }
    }
    for (int64_t i = i1 - 1; i >= i0; --i) {
      const int64_t o = base + i * rs;
      x = sub(out[o], mul(seg[(i - i0) * 32], x));
      out[o] = x;
    }
  }
}

// K21: the rows as given; the right-hand side d is staged into the
// solution's tile, a, b and c beside it.
template <typename T>
struct FieldRows {
  static constexpr int kStreams = 3;
  static constexpr int kCols = 0;
  static constexpr bool kReplay = std::is_same_v<T, float>;
  static size_t replay_bytes(int64_t n) { return open_replay_bytes<T>(n); }
  const T* rhs;                                  // d
  const T* abc[kStreams];

  __device__ __forceinline__ const T* stream(int t) const { return abc[t]; }
  __device__ __forceinline__ const T* col(int) const { return nullptr; }

  __device__ __forceinline__ void row(int64_t off, T& a, T& b, T& c,
                                      T& d) const {
    a = __ldg(abc[0] + off);
    b = __ldg(abc[1] + off);
    c = __ldg(abc[2] + off);
    d = __ldg(rhs + off);
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    bool stiff = false;
    load(ch, base, rs, row0, n, valid, stiff);
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, bool& stiff) const {
    ch.load_rows(
        [&](int k, T& a, T& b, T& c, T& d) {
          const int64_t i = row0 + k;
          if (!valid || i >= n) {
            a = c = d = T(0);
            b = T(1);
            return;
          }
          row(base + i * rs, a, b, c, d);
        },
        row0, n, stiff_check<kReplay>(stiff));
  }

  __device__ __forceinline__ void replay(T* out, int64_t base, int64_t rs,
                                         int64_t n, bool valid,
                                         T* sm) const {
    open_replay(
        [&](int64_t i, T& a, T& b, T& c, T& d) {
          row(base + i * rs, a, b, c, d);
        },
        out, base, rs, n, valid, sm);
  }

  template <int M>
  __device__ __forceinline__ void load_staged(Chunk<T, M, false>& ch,
                                              const T* x, const T* f, int fs,
                                              const T* cols, int cs,
                                              const uint8_t*, int j,
                                              int64_t nv, bool& stiff) const {
    const int64_t row0 = (int64_t)j * M;
    const int s0 = j * (M + 1);
    ch.load_rows(
        [&](int k, T& a, T& b, T& c, T& d) {
          if (row0 + k >= nv) {
            a = c = d = T(0);
            b = T(1);
            return;
          }
          const int s = s0 + k;
          a = f[s];
          b = f[fs + s];
          c = f[2 * fs + s];
          d = x[s];
        },
        row0, nv, stiff_check<kReplay>(stiff));
  }
};

// K17's row i from the lo face f_lo (the previous row's hi face, 0 at row
// 0), the hi face f_hi, dw, sink, srhs and the metric glo[i], ghi[i], one
// rounding per operation in the plain version's order
// (solvers/vpfields.py vp_fields_sweep_strided_plain):
//   al = glo*f_lo; ch = ghi*f_hi; a = -dw*al; c = -dw*ch;
//   b = 1 + dw*((al + ch) + sink); d = rhs + dw*srhs
template <typename T>
__device__ __forceinline__ void vp_field_row(T gl, T gh, T f_lo, T f_hi,
                                             T w, T sink, T rhs, T srhs,
                                             T& a, T& b, T& c, T& d) {
  const T al = atf::mul(gl, f_lo);
  const T ch = atf::mul(gh, f_hi);
  a = atf::mul(-w, al);
  c = atf::mul(-w, ch);
  b = atf::add(T(1), atf::mul(w, atf::add(atf::add(al, ch), sink)));
  d = atf::add(rhs, atf::mul(w, srhs));
}

// K17: the rhs staged into the solution's tile, fhi, dw, sink and srhs
// beside it, glo and ghi staged once a block (the strided kernel: glo[i]
// and ghi[i] through the read-only cache, the same for all lanes).  A chunk's
// first f_lo is fhi[row0 - 1] (0 at row 0), each row's f_hi carried on to
// the next row.
template <typename T>
struct VpFieldRows {
  static constexpr int kStreams = 4;
  static constexpr int kCols = 2;                // glo, ghi
  static constexpr bool kReplay = std::is_same_v<T, float>;
  static size_t replay_bytes(int64_t n) { return open_replay_bytes<T>(n); }
  const T* rhs;
  const T* fs4[kStreams];                        // fhi, dw, sink, srhs
  const T* glo;
  const T* ghi;

  __device__ __forceinline__ const T* stream(int t) const { return fs4[t]; }
  __device__ __forceinline__ const T* col(int t) const {
    return t == 0 ? glo : ghi;
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    bool stiff = false;
    load(ch, base, rs, row0, n, valid, stiff);
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, bool& stiff) const {
    T f_lo = (valid && row0 > 0 && row0 < n)
                 ? __ldg(fs4[0] + base + (row0 - 1) * rs)
                 : T(0);
    ch.load_rows(
        [&](int k, T& a, T& b, T& c, T& d) {
          const int64_t i = row0 + k;
          if (!valid || i >= n) {
            a = c = d = T(0);
            b = T(1);
            return;
          }
          const int64_t off = base + i * rs;
          const T f_hi = __ldg(fs4[0] + off);
          vp_field_row(__ldg(glo + i), __ldg(ghi + i), f_lo, f_hi,
                       __ldg(fs4[1] + off), __ldg(fs4[2] + off),
                       __ldg(rhs + off), __ldg(fs4[3] + off), a, b, c, d);
          f_lo = f_hi;
        },
        row0, n, stiff_check<kReplay>(stiff));
  }

  __device__ __forceinline__ void replay(T* out, int64_t base, int64_t rs,
                                         int64_t n, bool valid,
                                         T* sm) const {
    open_replay(
        [&](int64_t i, T& a, T& b, T& c, T& d) {
          const int64_t off = base + i * rs;
          const T f_lo = i > 0 ? __ldg(fs4[0] + off - rs) : T(0);
          vp_field_row(__ldg(glo + i), __ldg(ghi + i), f_lo,
                       __ldg(fs4[0] + off), __ldg(fs4[1] + off),
                       __ldg(fs4[2] + off), __ldg(rhs + off),
                       __ldg(fs4[3] + off), a, b, c, d);
        },
        out, base, rs, n, valid, sm);
  }

  template <int M>
  __device__ __forceinline__ void load_staged(Chunk<T, M, false>& ch,
                                              const T* x, const T* f, int fs,
                                              const T* cols, int cs,
                                              const uint8_t*, int j,
                                              int64_t nv, bool& stiff) const {
    const int64_t row0 = (int64_t)j * M;
    const int s0 = j * (M + 1);
    // row0 - 1 is the previous chunk's last row, slot s0 - 2
    T f_lo = (row0 > 0 && row0 < nv) ? f[s0 - 2] : T(0);
    ch.load_rows(
        [&](int k, T& a, T& b, T& c, T& d) {
          const int64_t i = row0 + k;
          if (i >= nv) {
            a = c = d = T(0);
            b = T(1);
            return;
          }
          const int s = s0 + k;
          const T f_hi = f[s];
          vp_field_row(cols[s], cols[cs + s], f_lo, f_hi, f[fs + s],
                       f[2 * fs + s], x[s], f[3 * fs + s], a, b, c, d);
          f_lo = f_hi;
        },
        row0, nv, stiff_check<kReplay>(stiff));
  }
};

// K22's and K18's stiffness ratio (csrc/split_cyclic.cuh; the two solve the
// same rows in the cylindrical step's `fields` and `kernels` tiers): a
// block of 32 lines with a row past |a| + |c| > kCyclicFieldStiff *
// (b - |a| - |c|) is solved in Thomas order, bit for bit cyclic_thomas.
// 12: every block split, over five seeds and five time steps
// (scripts/cyclic_tune.py on the H100, PERF.md section 6), blocks below 12 of
// chip_smoke.py's phase 8 rows stayed within 7.3e-4 K and 4.2 float32
// ulp of scale of the plain version (P8_TOL 1e-3 K, KERNEL_TOL_ULP 8: a
// quarter spare), blocks of 12-16 reached 8.5e-4 K; the Douglas step's
// own rows (theta*dw) reached 1.34e-3 K and 6.2 ulp below 12.  At float64
// too: split, a full disk's axis rings (ratio past 1000) part by 2.7e-8 K,
// past P8_TOL's 1e-9.
constexpr double kCyclicFieldStiff = 12.0;

// K22: the periodic rows as given, row 0's a the wrap coupling beta and
// row n-1's c alpha.
template <typename T>
struct FieldCyclicRows {
  static constexpr double kStiff = kCyclicFieldStiff;
  static constexpr bool kChunkTest = true;
  const T* a;
  const T* b;
  const T* c;
  const T* d;

  template <int M, typename F>
  __device__ __forceinline__ void each(const CycLine& L, int64_t row0,
                                       F&& f) const {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = row0 + k;
      if (i < L.n) {
        const int64_t off = L.at(i);
        f(k, __ldg(a + off), __ldg(b + off), __ldg(c + off), __ldg(d + off));
      }
    }
  }
};

// K18: the rows of vp_fields_cyclic_phi_plain one rounding at a time from
// the lo faces flo (row i's hi face is flo[i + 1 mod n]: a chunk reads flo
// at rows row0 .. row0 + M, the last mod n), dw, sink, srhs and one metric
// geo a ring (b1):
//   al = dw*(geo*f_lo); ch = dw*(geo*f_hi); a = -al; c = -ch;
//   b = 1 + dw*(geo*(f_lo + f_hi) + sink); d = rhs + dw*srhs
template <typename T>
struct VpFieldCyclicRows {
  static constexpr double kStiff = kCyclicFieldStiff;
  static constexpr bool kChunkTest = true;
  const T* rhs;
  const T* flo;
  const T* dw;
  const T* sink;
  const T* srhs;
  const T* geo;

  template <int M, typename F>
  __device__ __forceinline__ void each(const CycLine& L, int64_t row0,
                                       F&& f) const {
    using atf::add;
    using atf::mul;
    const int64_t n = L.n;
    if (row0 >= n) return;
    const T g = __ldg(geo + L.b1);
    T f_lo = __ldg(flo + L.at(row0));
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = row0 + k;
      if (i < n) {
        const int64_t off = L.at(i);
        const T f_hi = __ldg(flo + (i + 1 < n ? off + L.rs : L.at(0)));
        const T w = __ldg(dw + off);
        const T al = mul(w, mul(g, f_lo));
        const T ch = mul(w, mul(g, f_hi));
        const T b =
            add(T(1), mul(w, add(mul(g, add(f_lo, f_hi)), __ldg(sink + off))));
        f(k, -al, b, -ch, add(__ldg(rhs + off), mul(w, __ldg(srhs + off))));
        f_lo = f_hi;
      }
    }
  }
};

}  // namespace
