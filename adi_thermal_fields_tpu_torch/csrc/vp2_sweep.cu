// K8: the tier-2 variable-property sweep along the contiguous z axis, each
// line split across a warp; its Cartesian form and its general form on one
// kernel.  K15 and its y entry: the general form's rows along a strided
// axis (below).
//
// Replaces adi_thermal_fields_tpu/solvers/pallas_vp2.py fused_vp2_sweep
// with nat_rhs_out=True (:402; streaming call site :611, body _vp2_kernel
// :201-389).  The Cartesian form (the Cartesian varprop step's z sweep):
// symmetric columns glo = ghi and gs_lo = gs_hi, films h_lo = h_hi = h, no
// domain-edge films.  The general form (the cylindrical varprop BE step's
// z sweep, where the JAX step moves its z code to (z, r, phi); here the
// code stays in the natural layout): per-row columns glo, ghi (coupling,
// zero at Dirichlet rows, whose film bits the code clears: identity rows)
// and gsl, gsh (film metrics), h_lo != h_hi, and the domain-edge films at
// rows 0 and n-1, each against its own radiative ambient, gated by bit 8
// (csrc/vp2_films.cuh).  From the rhs, T^n and a 1-byte code
// (build_vp2_code, bits 1 = hi coupling live, 2/4 = lo/hi face exposed, 8
// = active), per row r of a pencil:
//   k_r = k(T_r); f_hi = bit1 ? harm(k_r, k_{r+1}) : 0; f_lo = previous
//   row's f_hi; hr = eps*sigma*(Tk+Tik)(Tk^2+Tik^2) (0 without radiation);
//   sink = bit2*gsl*(h_lo + hr) + bit4*gsh*(h_hi + hr); srhs = sink*t_inf
//   (+ the edge films at rows 0 and n-1);
//   al = glo*f_lo; ch = ghi*f_hi; coup = al + ch + sink;
//   w_r = coup > 0 ? cp(T_r)*inv_dtor : 1       (scaled-row elimination,
//   b = w_r + coup; d = rhs*w_r + srhs           pallas_vp2.py:335-349)
//   and a = -al, c = -ch.
// The coup > 0 gate is right for films >= 0 only; the callers refuse
// negative films.  The system is strictly diagonally dominant: b - |a| -
// |c| = w_r + sink > 0 (cp > 0), and a row with coup = 0 is an identity row;
// so, as for K1 (csrc/sweeps.cu), neither level of the split solve needs
// pivoting.
//
// What bounds it on the H100: memory -- read rhs (4) + T (4) + code (1),
// write x (4) = 13 B/cell at float32; k, cp, the faces and the films live
// in registers only.  The first version ran one warp per block over 32
// pencils, staged [32 pencils x 32 rows] tiles and sent c' and d' through
// global scratch (+16 B/cell): 16-27% of its byte model (the general form
// kept that design until PR 16: 12.7% on the cylindrical tube).  Design:
// K2's on the split-line core (csrc/split_line.cuh; csrc/sweeps.cu
// explains it): a warp owns one line, its lanes the chunks of M rows; the
// persistent block stages its lines of rhs, T and code with cp.async,
// double-buffered across the line groups it walks, each chunk padded so
// that the lanes' strided reads hit distinct banks; phase (a) forms the
// chunk's rows in registers and eliminates inside it, (b) solves the
// reduced rows on the warp (registers and shuffles for one chunk a lane,
// PCR in shared memory for more), (c) writes the solution back into the
// staged rhs, which leaves in coalesced rows.  c' and d' never leave the
// SM.  k(T) is evaluated once a row: a chunk's k at rows row0 - 1 and
// row0 + M comes from the neighbouring lanes by shuffle; with more than
// one chunk a lane (lines over 32 M rows) lanes 0 and 31 evaluate the row
// across the seam between rounds themselves, and phase (c) forms the
// earlier rounds' rows again, as K2 reloads them.  A line of at most 16
// chunks shares its warp with others (32 / chunks lines a warp: a line's
// end rows couple to nothing, so one reduced solve serves them all).  A
// line too long to stage with two blocks an SM (~5,100 rows at float32,
// ~2,700 at float64) goes to the core's strided kernel on the z layout
// (lanes = lines n apart, rows contiguous, reduced rows in global memory),
// where a chunk evaluates its neighbours' k itself: no length is refused.
// The general form's per-row columns (two where ghi is glo and gsh is
// gsl, as the step passes them, else four) are staged once a block in the
// chunks' padded layout beside the reduced rows; its groups of lines are
// staged single-buffered (kK8GenBuffers: its rows cost more to form, and
// the shared memory a second buffer takes held the (64, 512, 1024) tube to
// 4 blocks an SM, 0.92 against 0.80 ms); on lines of more than one round
// its earlier rounds' eliminated rows are kept in shared memory for phase
// (c) instead of formed again (the tube 0.84 -> 0.70 ms); at float32 a
// line with a row past kK8Stiff is flagged and solved again in Thomas
// order by a second kernel, bit for bit the plain version.  It takes the hardware reciprocal as the
// Cartesian form: rounded divisions (the periodic sweeps' kDiv) took the
// tube's split solve from 0.88 to 1.22-1.34 ms for at most 25% less
// distance from the plain version (PERF.md §6).
// What holds it at a third of its byte model on the H100 (PERF.md §6):
// latency, not bytes or arithmetic -- 128 registers leave 16 warps an SM,
// each lane forms and eliminates 16 rows in sequence (a rounded division
// a face), and rounding each operation once costs nothing measurable
// against FMA-contracted helpers.  cp(T) is evaluated at every row and
// selected where coup > 0 (under a branch, evaluated where coup > 0 alone,
// K8 ran 1.27x slower), and tables of up to four segments are summed
// without a branch (6% faster).  A variant in which the block formed its
// lines' rows together, cell by cell into shared memory (k, then the
// faces, then b and d), and the lanes only eliminated them, ran 1.7x
// slower.  The general form holds under a fifth of its byte model on the
// tube's 1,024-row lines (two 16-row chunks a lane; 153 registers; one
// 32-row chunk a lane ran slower, 1.03 ms).
//
// K15 replaces fused_vp2_sweep in its solve-leading forms (the pipelined
// body _vp2_pipe_kernel :1109, call site :539, and the streaming body
// _vp2_kernel :201 at call site :611 without nat_rhs_out): the solve along
// the strided axis of a C-contiguous field viewed as (B1, n, B2) -- r of
// the natural (r, phi, z) field, (1, nr, nphi*nz) -- with the general
// form's rows (per-row columns, h_lo != h_hi, the edge films at rows 0 and
// n-1; the rhs is T itself where the caller passes none: the first sweep
// of the backward-Euler step).  K15's y entry ("K15y") replaces
// fused_vp2_sweep_axis1 (:1029, body _vp2_axis1_kernel :903): the
// Cartesian y solve of the natural (x, y, z) field, (nx, ny, nz), with
// constant columns (glo = ghi = theta/dy^2, gsl = gsh = 1/dy), h_lo = h_hi
// and no edge films.  Both form `Vp2GenRows`' rows: short lines (the
// cylindrical r) in a march of a thread a line with c' in shared memory,
// long ones (K15y's 512-row y lines) on the core's strided kernel
// (csrc/split_line.cuh), each line split across the block's warps; c'
// and d' never take a field-sized buffer.  Byte model (float32): T (4) +
// code (1) (+ rhs 4) in, x (4) out = 9 B/cell without an rhs (the step's
// K15), 13 with one; the march moves d' through the L2 beside it.  Their
// first version marched a thread a pencil with c' in the output and d'
// in a field-sized scratch buffer, both read back (~25 B/cell).
//
// Rounding: k, cp, the faces and the films repeat the plain version
// (solvers/vp2.py) bit for bit (the _rn helpers of varprop.cuh); the split
// solve is not Thomas order and takes the hardware reciprocal at float32:
// a few float32 ulp of the output's scale from the plain version
// (chip_smoke.py KERNEL_TOL_ULP = 8).  float64 divides.
#include <type_traits>

#include "field_rows.cuh"
#include "vp2_films.cuh"

namespace {

using atf::add;
using atf::mul;

// Tables of at most kK8SmallSeg segments are summed without a branch.
constexpr int kK8SmallSeg = 4;

template <typename T>
struct Vp2Params {
  atf::Table<T> ktab, ctab;
  T glo, gs, inv_dtor, h, t_inf, rc, tik, tik2;
  int rad;
};

// K8's general form: the films of csrc/vp2_films.cuh and the per-row
// columns glo, ghi (coupling) and gsl, gsh (film metrics), n values each.
template <typename T>
struct Vp2GenParams {
  atf::Table<T> ktab, ctab;
  Films<T> f;
  const T* col[4];
  int two;         // ghi is glo and gsh is gsl: two columns staged
};

// K8's general form at float32: a line with a row past |a| + |c| >
// kK8Stiff (b - |a| - |c|) is solved again in Thomas order, bit for bit
// its plain version (csrc/field_rows.cuh says why), the staged kernel's
// flagged lines by `staged_replay_kernel`, the strided kernel's block by
// its warp 0.  12: every line split, over five seeds and dt x1-10 on
// chip_smoke.py phase 8's tube and disk (scripts/vp_split_tune.py --bins,
// PERF.md section 6), lines below 12 stayed within 8.5e-4 K (4.8 float32
// ulp of scale) of the plain version (P8_TOL 1e-3 K), lines of 12-16
// reached 1.1e-3 K, of 24-32 1.7e-3 (9.6 ulp).  At float64 no line is
// replayed: 8.6e-12 K at ratio 90.  The cylindrical step's rows at its dt
// stay below 9.
constexpr double kK8Stiff = 12.0;

struct K8StiffCheck {
  bool& stiff;
  template <typename A>
  __device__ __forceinline__ void operator()(const A& a, const A& b,
                                             const A& c) const {
    constexpr int M = sizeof(A) / sizeof(a[0]);
    const float q = float(kK8Stiff / (1.0 + kK8Stiff));
#pragma unroll
    for (int k = 0; k < M; ++k) {
      stiff = stiff || fabsf(a[k]) + fabsf(c[k]) > q * b[k];
    }
  }
};

// the general form's test where it replays (float32), else none
template <typename T>
__device__ __forceinline__ auto k8_check(bool& stiff) {
  if constexpr (std::is_same_v<T, float>) {
    return K8StiffCheck{stiff};
  } else {
    return NoCheck{};
  }
}

// A row of K8's general form from its T, code byte and rhs, its faces
// and its columns, the edge films where it is row 0 (first) or row n-1
// (last) (solvers/vp2.py _open_plain, one rounding per operation).
template <int kSeg, typename T>
__device__ __forceinline__ void gen_row(const Vp2GenParams<T>& p, T tc,
                                        unsigned cd, T r, T f_lo, T f_hi,
                                        T glo, T ghi, T gsl, T gsh,
                                        bool first, bool last, T& a, T& b,
                                        T& c, T& d) {
  T sink, srhs;
  open_films(cd, tc, gsl, gsh, first, last, p.f, sink, srhs);
  const T al = mul(glo, f_lo);
  const T ch = mul(ghi, f_hi);
  const T coup = add(add(al, ch), sink);
  // cp at every row, selected where coup > 0 (as the Cartesian form)
  const T cp = atf::table<kSeg>(p.ctab, tc);
  const T w = coup > T(0) ? mul(cp, p.f.inv_dtor) : T(1);
  a = -al;
  c = -ch;
  b = add(w, coup);
  d = add(mul(r, w), srhs);
}

// Forms and eliminates the chunk of rows row0 .. row0 + M - 1 (identity
// rows past n).  tat(k), cat(k), rat(k): row k's T, code byte and rhs,
// asked for rows below n only; col(t, k): row k's column t (glo, ghi, gsl,
// gsh; the general form only); kf, kl: k(T) at rows row0 and row0 + M - 1
// (where below n); k_prev, cd_prev: k(T) and the code at row0 - 1 (row0 >
// 0); k_after: k(T) at row0 + M (where below n).  `p`: Vp2Params (the
// Cartesian form) or Vp2GenParams (the general form's rows, gen_row).
template <int kSeg, typename T, int M, bool kDiv, typename Prm,
          typename TAt, typename CAt, typename RAt, typename ColAt,
          typename Check = NoCheck>
__device__ __forceinline__ void vp2_chunk(
    Chunk<T, M, false, kDiv>& ch, const TAt& tat, const CAt& cat,
    const RAt& rat, const ColAt& col, int64_t row0, int64_t n, T kf, T kl,
    T k_prev, unsigned cd_prev, T k_after, const Prm& p,
    const Check& check = Check()) {
  T k_cur = kf;
  // the previous row's f_hi, from the same two k values
  T f_lo = (row0 > 0 && (cd_prev & 1u)) ? atf::harm_rn(k_prev, kf) : T(0);
  ch.load_rows(
      [&](int k, T& a, T& b, T& c, T& d) {
        const int64_t i = row0 + k;
        if (i >= n) {
          a = c = d = T(0);
          b = T(1);
          return;
        }
        const T tc = tat(k);
        const unsigned cd = cat(k);
        T k_nxt;
        if (i == n - 1) {          // replicated, as the plain version has
          k_nxt = k_cur;           // it (bit 1 is clear there)
        } else if (k == M - 1) {
          k_nxt = k_after;
        } else if (k == M - 2) {
          k_nxt = kl;
        } else {
          k_nxt = atf::table<kSeg>(p.ktab, tat(k + 1));
        }
        const T f_hi = (cd & 1u) ? atf::harm_rn(k_cur, k_nxt) : T(0);
        if constexpr (std::is_same_v<Prm, Vp2Params<T>>) {
          const T hr =
              p.rad ? atf::rad_film_rn(tc, p.rc, p.tik, p.tik2) : T(0);
          const T hh = add(p.h, hr);
          const T sink = add(mul(mul(atf::bit<T>(cd, 2u), p.gs), hh),
                             mul(mul(atf::bit<T>(cd, 4u), p.gs), hh));
          const T al = mul(p.glo, f_lo);
          const T ch_hi = mul(p.glo, f_hi);
          const T coup = add(add(al, ch_hi), sink);
          // cp at every row, selected where coup > 0: a branch here cost
          // more than the evaluations it saves
          const T cp = atf::table<kSeg>(p.ctab, tc);
          const T wr = coup > T(0) ? mul(cp, p.inv_dtor) : T(1);
          a = -al;
          c = -ch_hi;
          b = add(wr, coup);
          d = add(mul(rat(k), wr), mul(sink, p.t_inf));
        } else {
          // row 0 only ever at k = 0: the unrolled rows past it carry no
          // test of the first edge film
          gen_row<kSeg>(p, tc, cd, rat(k), f_lo, f_hi, col(0, k), col(1, k),
                        col(2, k), col(3, k), k == 0 && row0 == 0,
                        i == n - 1, a, b, c, d);
        }
        f_lo = f_hi;
        k_cur = k_nxt;
      },
      row0, n, check);
}

// The rows of K8 for the core's strided kernel (lines too long to stage):
// a chunk evaluates k at its neighbouring rows itself.
template <typename T>
struct Vp2Rows {
  const T* rhs;
  const T* Tf;
  const uint8_t* code;
  Vp2Params<T> p;

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    const int64_t nv = valid ? n : 0;       // no line: identity rows
    auto at = [&](int64_t i) { return base + i * rs; };
    auto kat = [&](int64_t i) {
      return (i >= 0 && i < nv) ? atf::table<0>(p.ktab, __ldg(Tf + at(i)))
                                : T(0);
    };
    const unsigned cd_prev =
        (row0 > 0 && row0 - 1 < nv) ? __ldg(code + at(row0 - 1)) : 0u;
    vp2_chunk<0, T, M>(
        ch, [&](int k) { return __ldg(Tf + at(row0 + k)); },
        [&](int k) { return (unsigned)__ldg(code + at(row0 + k)); },
        [&](int k) { return __ldg(rhs + at(row0 + k)); },
        [](int, int) { return T(0); }, row0, nv, kat(row0),
        kat(row0 + M - 1), kat(row0 - 1), cd_prev, kat(row0 + M), p);
  }
};

// The rows of K8's general form: for the core's strided kernel (`load`,
// lines too long to stage; the columns through the read-only cache) and
// the Thomas-order replay of stiff lines (`replay`, kReplay: float32),
// which forms row i from rows i - 1, i and i + 1 in global memory.
template <typename T, int kSeg>
struct Vp2GenRows {
  static constexpr bool kReplay = std::is_same_v<T, float>;
  static size_t replay_bytes(int64_t n) { return open_replay_bytes<T>(n); }
  const T* rhs;
  const T* Tf;
  const uint8_t* code;
  Vp2GenParams<T> p;

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
    const int64_t nv = valid ? n : 0;       // no line: identity rows
    auto at = [&](int64_t i) { return base + i * rs; };
    auto kat = [&](int64_t i) {
      return (i >= 0 && i < nv)
                 ? atf::table<kSeg>(p.ktab, __ldg(Tf + at(i)))
                 : T(0);
    };
    const unsigned cd_prev =
        (row0 > 0 && row0 - 1 < nv) ? __ldg(code + at(row0 - 1)) : 0u;
    vp2_chunk<kSeg, T, M>(
        ch, [&](int k) { return __ldg(Tf + at(row0 + k)); },
        [&](int k) { return (unsigned)__ldg(code + at(row0 + k)); },
        [&](int k) { return __ldg(rhs + at(row0 + k)); },
        [&](int t, int k) { return __ldg(p.col[t] + row0 + k); }, row0, nv,
        kat(row0), kat(row0 + M - 1), kat(row0 - 1), cd_prev,
        kat(row0 + M), p, k8_check<T>(stiff));
  }

  __device__ __forceinline__ void replay(T* out, int64_t base, int64_t rs,
                                         int64_t n, bool valid,
                                         T* sm) const {
    // row i after row i - 1 (the replay's passes run in order) takes k at
    // row i and its lo face from that row: one table evaluation a row
    int64_t prev = -2;
    T k_up = T(0), f_prev = T(0);
    open_replay(
        [&](int64_t i, T& a, T& b, T& c, T& d) {
          const int64_t o = base + i * rs;
          const T tc = __ldg(Tf + o);
          const unsigned cd = __ldg(code + o);
          T kc, f_lo;
          if (i == prev + 1) {
            kc = k_up;
            f_lo = f_prev;
          } else {
            kc = atf::table<kSeg>(p.ktab, tc);
            f_lo = (i > 0 && (__ldg(code + o - rs) & 1u))
                       ? atf::harm_rn(
                             atf::table<kSeg>(p.ktab, __ldg(Tf + o - rs)), kc)
                       : T(0);
          }
          // the last row's neighbour replicates it (bit 1 is clear there)
          const T kn =
              i + 1 < n ? atf::table<kSeg>(p.ktab, __ldg(Tf + o + rs)) : kc;
          const T f_hi = (cd & 1u) ? atf::harm_rn(kc, kn) : T(0);
          gen_row<kSeg>(p, tc, cd, __ldg(rhs + o), f_lo, f_hi,
                        __ldg(p.col[0] + i), __ldg(p.col[1] + i),
                        __ldg(p.col[2] + i), __ldg(p.col[3] + i), i == 0,
                        i == n - 1, a, b, c, d);
          prev = i;
          k_up = kn;
          f_prev = f_hi;
        },
        out, base, rs, n, valid, sm);
  }
};

// K8's launch shape: two warps a block, M = 16 rows a lane (8 for lines of
// up to kK8M8Rows rows), as K2; a line is staged where a block of one line
// takes at most kK8StageKB of shared memory (two blocks an SM), else it
// goes to the core's strided kernel (at 8192 rows, float32, 2.3x faster
// than one staged line an SM).
constexpr int kK8Lines = 2;
constexpr int kK8M8Rows = 256;
constexpr int kK8StageKB = 113;
// K8's general form stages its groups of lines in kK8GenBuffers buffers
// (the Cartesian form in two: the next group's copy overlaps this one's
// solve): one buffer leaves room for more blocks an SM, whose rows cost
// more to form.
constexpr int kK8GenBuffers = 1;

// The kernel of both forms (kGen: the general form, with its columns
// staged once a block after the warps' reduced rows and, at float32, a
// flag byte a line for the stiff lines' replay).
template <bool kGen, typename T, int M, int kSeg, typename Prm>
__device__ __forceinline__ void vp2_z_body(
    const T* __restrict__ rhs, const T* __restrict__ Tf,
    const uint8_t* __restrict__ code, T* __restrict__ out,
    uint8_t* __restrict__ flags, int64_t npen, int64_t n, int R, int P,
    ZLayout L, int code_async, const Prm& p) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kBufs = kGen ? kK8GenBuffers : 2;
  extern __shared__ __align__(16) unsigned char atf_smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = L.W;                             // lines a group: P a warp
  const int rows = 2 * 32 * R;
  // P > 1 (lines of at most 16 chunks): the warp's lanes hold P lines, nch
  // lanes each; a line's first and last rows couple to nothing beyond it,
  // so one reduced solve over the warp solves them all
  const int nch = (int)atf::cdiv(n, M);
  const int lq = P > 1 ? lane / nch : 0;         // the lane's line
  const int lj = P > 1 ? lane - lq * nch : lane; // and its chunk (R = 1)
  unsigned char* red = atf_smem + kBufs * L.buf_bytes;
  T* A = reinterpret_cast<T*>(red) + (size_t)w * 6 * rows;
  T* Cc = A + rows;
  T* D = Cc + rows;                              // then PCR's scratch
  // the general form's columns (two or four), in the chunks' padded layout
  T* cols = reinterpret_cast<T*>(red) + (size_t)(blockDim.x >> 5) * 6 * rows;

  auto X = [&](int buf) {
    return reinterpret_cast<T*>(atf_smem + buf * L.buf_bytes);
  };
  auto TT = [&](int buf) {
    return reinterpret_cast<T*>(atf_smem + buf * L.buf_bytes + L.x_bytes);
  };
  auto CT = [&](int buf) {
    return reinterpret_cast<uint8_t*>(atf_smem + buf * L.buf_bytes +
                                      L.x_bytes + L.f_bytes);
  };
  auto vidx = [](int64_t i) { return (int)(i / M * (M + 1) + i % M); };
  auto cidx = [](int64_t i) { return (int)(i / M * (M + 4) + i % M); };

  const int64_t G = atf::cdiv(npen, W);
  auto stage_group = [&](int64_t g, int buf) {
    T* x = X(buf);
    T* tt = TT(buf);
    uint8_t* ct = CT(buf);
    for (int q = 0; q < W; ++q) {
      const int64_t pen = g * W + q;
      if (pen >= npen) break;
      const int64_t g0 = pen * n;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        const int s = q * L.pitch + vidx(i);
        stage<T, T>(x + s, rhs + g0 + i);
        stage<T, T>(tt + s, Tf + g0 + i);
      }
      if (code_async) {
        for (int64_t i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
          cp_async(ct + q * L.cpitch + cidx(i), code + g0 + i, 4);
        }
      } else {
        for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
          ct[q * L.cpitch + cidx(i)] = code[g0 + i];
        }
      }
    }
    cp_async_commit();
  };

  if constexpr (kGen) {                          // once a block
    const int nc = p.two ? 2 : 4;
    for (int t = 0; t < nc; ++t) {
      const T* src = p.col[p.two ? 2 * t : t];
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        cols[t * L.pitch + vidx(i)] = __ldg(src + i);
      }
    }
  }
  int o1 = 0, o2 = 0, o3 = 0;                    // columns ghi, gsl, gsh
  // the general form on lines of R > 1 rounds: the eliminated inner rows
  // of a lane's chunks but the last round's, kept for phase (c) after the
  // columns instead of formed again
  T* kept = nullptr;
  if constexpr (kGen) {
    o1 = p.two ? 0 : L.pitch;
    o2 = (p.two ? 1 : 2) * L.pitch;
    o3 = (p.two ? 1 : 3) * L.pitch;
    kept = cols + (p.two ? 2 : 4) * L.pitch +
           (size_t)w * (R - 1) * (M - 2) * 3 * 32;
  }
  auto keep = [&](int r, int k, int v) -> T& {
    return kept[((r * (M - 2) + k - 1) * 3 + v) * 32 + lane];
  };

  int buf = 0;
  int64_t g = blockIdx.x;
  if (g < G) stage_group(g, 0);
  for (; g < G; g += gridDim.x, buf ^= kBufs - 1) {
    if (kBufs == 2 && g + gridDim.x < G) {
      stage_group(g + gridDim.x, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (g * W + w * P < npen) {                  // the warp has a line
      const int64_t pen = g * W + w * P + lq;
      // a lane past the warp's lines or the field's: identity rows
      const int64_t nv = (lq < P && pen < npen) ? n : 0;
      T* x = X(buf) + (w * P + lq) * L.pitch;
      const T* tt = TT(buf) + (w * P + lq) * L.pitch;
      const uint8_t* ct = CT(buf) + (w * P + lq) * L.cpitch;
      Chunk<T, M, false> ch;
      bool stiff = false;
      // (a) for chunk j (every lane of the warp together: shuffles)
      auto eliminate = [&](int j) {
        const int64_t row0 = (int64_t)j * M;
        const T* tj = tt + j * (M + 1);
        const uint8_t* cj = ct + j * (M + 4);
        const T* xj = x + j * (M + 1);
        const T kf = row0 < nv ? atf::table<kSeg>(p.ktab, tj[0]) : T(0);
        const T kl =
            row0 + M - 1 < nv ? atf::table<kSeg>(p.ktab, tj[M - 1]) : T(0);
        T k_prev = __shfl_up_sync(kAll, kl, 1);
        T k_after = __shfl_down_sync(kAll, kf, 1);
        // the seams between rounds: the row across lies in another round
        const bool lo = lane == 0 && row0 > 0 && row0 - 1 < nv;
        const bool hi = lane == 31 && row0 + M < nv;
        if (lo || hi) {
          const T kk =
              atf::table<kSeg>(p.ktab, tt[vidx(lo ? row0 - 1 : row0 + M)]);
          if (lo) {
            k_prev = kk;
          } else {
            k_after = kk;
          }
        }
        const unsigned cd_prev =
            (row0 > 0 && row0 - 1 < nv) ? ct[cidx(row0 - 1)] : 0u;
        if constexpr (kGen) {
          const T* gj = cols + j * (M + 1);
          vp2_chunk<kSeg, T, M>(
              ch, [&](int k) { return tj[k]; },
              [&](int k) { return (unsigned)cj[k]; },
              [&](int k) { return xj[k]; },
              [&](int t, int k) {
                return gj[(t == 0 ? 0 : t == 1 ? o1 : t == 2 ? o2 : o3) + k];
              },
              row0, nv, kf, kl, k_prev, cd_prev, k_after, p,
              k8_check<T>(stiff));
        } else {
          vp2_chunk<kSeg, T, M>(
              ch, [&](int k) { return tj[k]; },
              [&](int k) { return (unsigned)cj[k]; },
              [&](int k) { return xj[k]; }, [](int, int) { return T(0); },
              row0, nv, kf, kl, k_prev, cd_prev, k_after, p);
        }
      };
      // the general form at float32: flag the line of a stiff chunk
      auto flag = [&] {
        if constexpr (kGen && std::is_same_v<T, float>) {
          const unsigned all = __ballot_sync(kAll, stiff);
          const unsigned mine =
              P > 1 ? ((1u << nch) - 1u) << (lq * nch) : kAll;
          if (lj == 0 && nv > 0) flags[pen] = (all & mine) != 0u;
        }
      };
      auto put_x = [&](int j, T x0, T xl) {
#pragma unroll
        for (int k = 0; k < M; ++k) {
          if ((int64_t)j * M + k < nv) x[j * (M + 1) + k] = ch.x(k, x0, xl);
        }
      };
      if (R == 1) {                              // lines of <= 32 chunks
        eliminate(lj);                           // (a)
        flag();
        T x0, xl;                                // (b) in registers
        warp_reduced(ch.a[0], ch.c[0], ch.d[0], ch.a[M - 1], ch.c[M - 1],
                     ch.d[M - 1], lane, x0, xl);
        put_x(lj, x0, xl);                       // (c), into the rhs tile
      } else {
        for (int r = 0; r < R; ++r) {            // (a): lanes = chunks
          const int j = r * 32 + lane;
          eliminate(j);
          ch.put_reduced(A, Cc, D, 2 * j, 2 * j + 1);
          if constexpr (kGen) {
            if (r < R - 1) {
#pragma unroll
              for (int k = 1; k < M - 1; ++k) {
                keep(r, k, 0) = ch.a[k];
                keep(r, k, 1) = ch.c[k];
                keep(r, k, 2) = ch.d[k];
              }
            }
          }
        }
        flag();
        __syncwarp();                            // (b), the warp
        const T* Xr = pcr_reduced(A, Cc, D, D + rows, D + 2 * rows,
                                  D + 3 * rows, rows, 1, 0, lane, 32,
                                  [] { __syncwarp(); });
        __syncwarp();
        auto put = [&](int j) { put_x(j, Xr[2 * j], Xr[2 * j + 1]); };
        put((R - 1) * 32 + lane);                // (c), into the rhs tile
        for (int r = 0; r < R - 1; ++r) {
          if constexpr (kGen) {
#pragma unroll
            for (int k = 1; k < M - 1; ++k) {
              ch.a[k] = keep(r, k, 0);
              ch.c[k] = keep(r, k, 1);
              ch.d[k] = keep(r, k, 2);
            }
          } else {
            eliminate(r * 32 + lane);
          }
          put(r * 32 + lane);
        }
      }
    }
    __syncthreads();
    // coalesced stores of the group's solution
    for (int q = 0; q < W; ++q) {
      const int64_t pq = g * W + q;
      if (pq >= npen) break;
      const T* x = X(buf) + q * L.pitch;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        out[pq * n + i] = x[vidx(i)];
      }
    }
    __syncthreads();
    if (kBufs == 1 && g + gridDim.x < G) stage_group(g + gridDim.x, 0);
  }
}

template <typename T, int M, int kSeg>
__global__ void __launch_bounds__(32 * kK8Lines) vp2_sweep_z_kernel(
    const T* __restrict__ rhs, const T* __restrict__ Tf,
    const uint8_t* __restrict__ code, T* __restrict__ out, int64_t npen,
    int64_t n, int R, int P, ZLayout L, int code_async,
    const __grid_constant__ Vp2Params<T> p) {
  vp2_z_body<false, T, M, kSeg>(rhs, Tf, code, out, nullptr, npen, n, R, P,
                                L, code_async, p);
}

template <typename T, int M, int kSeg>
__global__ void __launch_bounds__(32 * kK8Lines) vp2_sweep_z_general_kernel(
    const T* __restrict__ rhs, const T* __restrict__ Tf,
    const uint8_t* __restrict__ code, T* __restrict__ out,
    uint8_t* __restrict__ flags, int64_t npen, int64_t n, int R, int P,
    ZLayout L, int code_async, const __grid_constant__ Vp2GenParams<T> p) {
  vp2_z_body<true, T, M, kSeg>(rhs, Tf, code, out, flags, npen, n, R, P, L,
                               code_async, p);
}

// Both forms' launch (Prm: Vp2Params, the Cartesian form, or Vp2GenParams,
// the general form; `flags`: the general form's npen bytes at float32).
template <typename T, int M, int kSeg, typename Prm>
cudaError_t launch_vp2_z_m(const T* rhs, const T* Tf, const uint8_t* code,
                           T* out, uint8_t* flags, int64_t npen, int64_t n,
                           const Prm& p, int device, cudaStream_t stream) {
  constexpr bool kGen = !std::is_same_v<Prm, Vp2Params<T>>;
  const int R = (int)atf::cdiv(n, 32 * M);
  // lines of at most 16 chunks: P lines a warp
  const int nch = (int)atf::cdiv(n, M);
  const int P = nch <= 16 ? 32 / nch : 1;
  size_t col_bytes = 0, kept_bytes = 0;         // the general form's
  if constexpr (kGen) {                          // columns and kept rows
    col_bytes = sizeof(T) * (p.two ? 2 : 4) * z_layout<T, T, M>(1, n, 1).pitch;
    kept_bytes = sizeof(T) * (size_t)(R - 1) * (M - 2) * 3 * 32;
  }
  const int bufs = kGen ? kK8GenBuffers : 2;
  auto bytes = [&](int nw) {                     // nw warps a block
    return bufs * z_layout<T, T, M>(nw * P, n, 1).buf_bytes +
           z_reduced_bytes<T>(nw, R) + col_bytes + nw * kept_bytes;
  };
  if (bytes(1) > (size_t)atf::imin(smem_limit(device), kK8StageKB * 1024)) {
    // such lines are long: past shared memory for the core's reduced rows
    if constexpr (kGen) {
      return launch_split_strided_m<T, Vp2GenRows<T, 0>, 16, true>(
          Vp2GenRows<T, 0>{rhs, Tf, code, p}, out, 1, n, npen, n, 1, stream);
    } else {
      return launch_split_strided_m<T, Vp2Rows<T>, 16, true>(
          Vp2Rows<T>{rhs, Tf, code, p}, out, 1, n, npen, n, 1, stream);
    }
  }
  int nw = kK8Lines;
  while (nw > 1 && bytes(nw) > 100 * 1024) nw /= 2;
  const int W = nw * P;                          // lines a group
  const size_t smem = bytes(nw);
  const ZLayout L = z_layout<T, T, M>(W, n, 1);
  const int code_async =
      (n % 4 == 0) && (reinterpret_cast<uintptr_t>(code) % 4 == 0);
  auto run = [&](auto* kernel, auto... args) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * nw,
                                                  smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int64_t groups = atf::cdiv(npen, W);
    const int64_t blocks = atf::imin(
        groups, (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1));
    kernel<<<(unsigned)blocks, 32 * nw, smem, stream>>>(args...);
  };
  if constexpr (kGen) {
    run(vp2_sweep_z_general_kernel<T, M, kSeg>, rhs, Tf, code, out, flags,
        npen, n, R, P, L, code_async, p);
    if constexpr (Vp2GenRows<T, kSeg>::kReplay) {  // the flagged lines
      const size_t rsmem = Vp2GenRows<T, kSeg>::replay_bytes(n);
      auto* replay = staged_replay_kernel<T, Vp2GenRows<T, kSeg>>;
      cudaFuncSetAttribute(replay,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)rsmem);
      replay<<<(unsigned)atf::cdiv(npen, 32), 32, rsmem, stream>>>(
          Vp2GenRows<T, kSeg>{rhs, Tf, code, p}, out, flags, npen, n);
    }
  } else {
    run(vp2_sweep_z_kernel<T, M, kSeg>, rhs, Tf, code, out, npen, n, R, P, L,
        code_async, p);
  }
  return cudaSuccess;
}

// M and the table's summation for a line of n rows
template <typename T, typename Prm>
cudaError_t launch_vp2_z(const void* rhs, const void* Tf, const void* code,
                         void* out, void* flags, int64_t npen, int64_t n,
                         int kn, int cn, const Prm& p, int device,
                         cudaStream_t stream) {
  auto* r = static_cast<const T*>(rhs);
  auto* t = static_cast<const T*>(Tf);
  auto* c = static_cast<const uint8_t*>(code);
  auto* o = static_cast<T*>(out);
  auto* fl = static_cast<uint8_t*>(flags);
  const bool small = kn <= kK8SmallSeg && cn <= kK8SmallSeg;
  if (n > kK8M8Rows) {
    return small ? launch_vp2_z_m<T, 16, kK8SmallSeg>(r, t, c, o, fl, npen,
                                                      n, p, device, stream)
                 : launch_vp2_z_m<T, 16, 0>(r, t, c, o, fl, npen, n, p,
                                            device, stream);
  }
  return small ? launch_vp2_z_m<T, 8, kK8SmallSeg>(r, t, c, o, fl, npen, n,
                                                   p, device, stream)
               : launch_vp2_z_m<T, 8, 0>(r, t, c, o, fl, npen, n, p, device,
                                         stream);
}

template <typename T>
cudaError_t launch_vp2_sweep_z(const void* rhs, const void* Tf,
                               const void* code, void* out, int64_t npen,
                               int64_t n, const double* ktab, int kn,
                               const double* ctab, int cn, double glo,
                               double gs, double inv_dtor, double h,
                               double t_inf, double rc, double tik,
                               double tik2, int with_rad, int device,
                               cudaStream_t stream) {
  Vp2Params<T> p;
  atf::make_table(ktab, kn, &p.ktab);
  atf::make_table(ctab, cn, &p.ctab);
  p.glo = (T)glo;
  p.gs = (T)gs;
  p.inv_dtor = (T)inv_dtor;
  p.h = (T)h;
  p.t_inf = (T)t_inf;
  p.rc = (T)rc;
  p.tik = (T)tik;
  p.tik2 = (T)tik2;
  p.rad = with_rad;
  return launch_vp2_z<T>(rhs, Tf, code, out, nullptr, npen, n, kn, cn, p,
                         device, stream);
}

template <typename T>
cudaError_t launch_vp2_sweep_z_general(
    const void* rhs, const void* Tf, const void* code, const void* glo,
    const void* ghi, const void* gsl, const void* gsh, void* out,
    void* flags, int64_t npen, int64_t n, const double* ktab, int kn,
    const double* ctab, int cn, double inv_dtor, double h_lo, double h_hi,
    double tinf, double rc, double tik, double tik2, int with_rad,
    const double* edges, int device, cudaStream_t stream) {
  Vp2GenParams<T> p;
  atf::make_table(ktab, kn, &p.ktab);
  atf::make_table(ctab, cn, &p.ctab);
  p.f = make_films<T>(inv_dtor, h_lo, h_hi, tinf, rc, tik, tik2, with_rad,
                      edges);
  p.col[0] = static_cast<const T*>(glo);
  p.col[1] = static_cast<const T*>(ghi);
  p.col[2] = static_cast<const T*>(gsl);
  p.col[3] = static_cast<const T*>(gsh);
  p.two = glo == ghi && gsl == gsh;
  return launch_vp2_z<T>(rhs, Tf, code, out, flags, npen, n, kn, cn, p,
                         device, stream);
}

// K15 and K15y: the general form's rows along a strided axis of a (B1, n,
// B2) field (lines B2 apart, rows B2 apart).  Lines of up to kK15MarchRows
// rows: `vp2_march_kernel`, a thread a line in Thomas order (thomas's
// divisions), adjacent threads on adjacent lines, k(T) once a row, c' in
// shared memory and d' through the output, which the backward pass reads
// back (from the L2), bit for bit the plain version: kK15MarchGroup rows'
// loads in flight at a time, registers held to kK15MarchBlocks blocks an
// SM, kK15MarchThreads threads a block on lines of up to kK15MarchCells /
// kK15MarchThreads rows (c' takes 32 KB a block at float32), half as many
// on lines up to twice as long, and so on down to one warp a block (c'
// kept to kK15MarchCells values a block).  Longer lines: the core's
// strided kernel, `launch_split_strided` (K17's r sweep's layout: lanes =
// 32 lines adjacent in B2; its launch shape: M = 8 rows a thread, 32 warps at
// float32, one block an SM, which beat M = 4 and 16, 8 and 16 warps and
// two blocks an SM), the reduced system on warp shuffles, the eliminated
// rows of a thread's earlier chunks kept in shared memory; float32 blocks
// with a row past kK8Stiff are solved again in Thomas order by their warp
// 0, bit for bit the plain version.  kK15MarchRows is where the two
// cross on the H100 (PERF.md section 6; scripts/cyl_be_tune.py
// --crossover, tubes of the step's kind with n-row r lines, ~2^25 cells):
// the march 0.46-0.58 ms up to 96 rows against the split kernel's
// 0.52-0.63, then 0.66-1.28 against 0.50-0.69 from 112 to 256 rows.  The
// split kernel parted from the plain version by 6.2-6.9 float32 ulp of
// scale (1.0-1.2e-3 K, past chip_smoke.py's P8_TOL) at every length from
// 64 to 256 rows; the march is bit for bit.
constexpr int kK15MarchRows = 96;
constexpr int kK15MarchCells = 8192;
constexpr int kK15MarchThreads = 128;
constexpr int kK15MarchGroup = 4;
constexpr int kK15MarchBlocks = 7;

// B1*B2 lines of n rows B2 apart, a thread a line (gen_row's rows, thomas's
// order: c' = c/(b - a c'), d' = (d - a d')/(b - a c')).  The forward pass
// takes kK15MarchGroup rows at a time: their loads (T a row ahead, the
// code and the rhs; the columns, the same for every line, come from the
// L1) go out together, so that the memory's latency is met once a group,
// not once a row.  kK15MarchBlocks: the blocks an SM its registers are
// held to.
template <typename T, int kSeg>
__global__ void __launch_bounds__(kK15MarchThreads, kK15MarchBlocks)
    vp2_march_kernel(
    const __grid_constant__ Vp2GenRows<T, kSeg> rows, T* __restrict__ out,
    int64_t B1, int64_t n, int64_t B2) {
  using atf::div;
  using atf::sub;
  constexpr int G = kK15MarchGroup;
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* cps = reinterpret_cast<T*>(atf_smem) + threadIdx.x;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B1 * B2) return;
  const int64_t b1 = p / B2;
  const int64_t base = b1 * n * B2 + (p - b1 * B2);
  const Vp2GenParams<T>& g = rows.p;
  T cp = T(0), dp = T(0), f_lo = T(0);
  T t_cur = __ldg(rows.Tf + base);
  T k_cur = atf::table<kSeg>(g.ktab, t_cur);
  for (int64_t i0 = 0; i0 < n; i0 += G) {
    T t_up[G], r[G];
    unsigned cd[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {                // the group's loads
      const int64_t i = i0 + k, off = base + i * B2;
      if (i < n) {
        t_up[k] = i + 1 < n ? __ldg(rows.Tf + off + B2) : T(0);
        cd[k] = __ldg(rows.code + off);
        r[k] = __ldg(rows.rhs + off);
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int64_t i = i0 + k;
      if (i < n) {
        // the last row's neighbour replicates it (bit 1 is clear there)
        const T k_up =
            i + 1 < n ? atf::table<kSeg>(g.ktab, t_up[k]) : k_cur;
        const T f_hi = (cd[k] & 1u) ? atf::harm_rn(k_cur, k_up) : T(0);
        T a, b, c, d;
        gen_row<kSeg>(g, t_cur, cd[k], r[k], f_lo, f_hi,
                      __ldg(g.col[0] + i), __ldg(g.col[1] + i),
                      __ldg(g.col[2] + i), __ldg(g.col[3] + i), i == 0,
                      i == n - 1, a, b, c, d);
        const T den = sub(b, mul(a, cp));
        cp = div(c, den);
        dp = div(sub(d, mul(a, dp)), den);
        cps[i * blockDim.x] = cp;
        out[base + i * B2] = dp;
        f_lo = f_hi;
        t_cur = t_up[k];
        k_cur = k_up;
      }
    }
  }
  T x = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    x = sub(out[off], mul(cps[i * blockDim.x], x));
    out[off] = x;
  }
}

template <typename T>
cudaError_t launch_vp2_sweep_strided(
    const void* rhs, const void* Tf, const void* code, const void* glo,
    const void* ghi, const void* gsl, const void* gsh, void* out, int64_t B1,
    int64_t n, int64_t B2, const double* ktab, int kn, const double* ctab,
    int cn, double inv_dtor, double h_lo, double h_hi, double tinf,
    double rc, double tik, double tik2, int with_rad, const double* edges,
    int device, cudaStream_t stream) {
  Vp2GenParams<T> p;
  atf::make_table(ktab, kn, &p.ktab);
  atf::make_table(ctab, cn, &p.ctab);
  p.f = make_films<T>(inv_dtor, h_lo, h_hi, tinf, rc, tik, tik2, with_rad,
                      edges);
  p.col[0] = static_cast<const T*>(glo);
  p.col[1] = static_cast<const T*>(ghi);
  p.col[2] = static_cast<const T*>(gsl);
  p.col[3] = static_cast<const T*>(gsh);
  p.two = glo == ghi && gsl == gsh;
  auto* r = static_cast<const T*>(rhs);
  auto* t = static_cast<const T*>(Tf);
  auto* c = static_cast<const uint8_t*>(code);
  auto* o = static_cast<T*>(out);
  auto launch = [&](auto seg) {
    constexpr int kSeg = decltype(seg)::value;
    const Vp2GenRows<T, kSeg> gen{r, t, c, p};
    if (n <= kK15MarchRows) {
      int threads = kK15MarchThreads;
      while (threads > 32 && (int64_t)threads * n > kK15MarchCells) {
        threads /= 2;
      }
      const size_t smem = sizeof(T) * threads * (size_t)n;
      auto* kernel = vp2_march_kernel<T, kSeg>;
      atf::allow_dynamic_smem(kernel, smem);
      kernel<<<(unsigned)atf::cdiv(B1 * B2, threads), threads, smem,
               stream>>>(gen, o, B1, n, B2);
      return cudaSuccess;
    }
    return launch_split_strided<T>(gen, o, B1, n, B2, 1, B2, device,
                                   stream);
  };
  if (kn <= kK8SmallSeg && cn <= kK8SmallSeg) {
    return launch(std::integral_constant<int, kK8SmallSeg>{});
  }
  return launch(std::integral_constant<int, 0>{});
}

bool tables_ok(int kn, int cn) {
  return kn >= 0 && kn <= atf::kMaxSeg && cn >= 0 && cn <= atf::kMaxSeg;
}

}  // namespace

ATF_API int atf_vp2_sweep_z(int dtype, int device, const void* rhs,
                            const void* Tf, const void* code, void* out,
                            int64_t npen, int64_t n, const double* ktab,
                            int kn, const double* ctab, int cn, double glo,
                            double gs, double inv_dtor, double h,
                            double t_inf, double rc, double tik, double tik2,
                            int with_rad, void* stream) {
  if (!tables_ok(kn, cn)) return (int)cudaErrorInvalidValue;
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_vp2_sweep_z<T>(
                   rhs, Tf, code, out, npen, n, ktab, kn, ctab, cn, glo, gs,
                   inv_dtor, h, t_inf, rc, tik, tik2, with_rad, device,
                   (cudaStream_t)stream))));
}

// K8's general form; `flags`: npen bytes at float32 (the stiff lines'
// flags), unused at float64.
ATF_API int atf_vp2_sweep_z_general(
    int dtype, int device, const void* rhs, const void* Tf, const void* code,
    const void* glo, const void* ghi, const void* gsl, const void* gsh,
    void* out, void* flags, int64_t npen, int64_t n, const double* ktab,
    int kn, const double* ctab, int cn, double inv_dtor, double h_lo,
    double h_hi, double tinf, double rc, double tik, double tik2,
    int with_rad, const double* edges, void* stream) {
  if (!tables_ok(kn, cn) || (dtype == atf::kF32 && flags == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_vp2_sweep_z_general<T>(
                   rhs, Tf, code, glo, ghi, gsl, gsh, out, flags, npen, n,
                   ktab, kn, ctab, cn, inv_dtor, h_lo, h_hi, tinf, rc, tik,
                   tik2, with_rad, edges, device, (cudaStream_t)stream))));
}

// K15 and its y entry: the (B1, n, B2) field's lines along axis 1 (rhs may
// be T itself).
ATF_API int atf_vp2_sweep_strided(
    int dtype, int device, const void* rhs, const void* Tf, const void* code,
    const void* glo, const void* ghi, const void* gsl, const void* gsh,
    void* out, int64_t B1, int64_t n, int64_t B2, const double* ktab, int kn,
    const double* ctab, int cn, double inv_dtor, double h_lo, double h_hi,
    double tinf, double rc, double tik, double tik2, int with_rad,
    const double* edges, void* stream) {
  if (!tables_ok(kn, cn)) return (int)cudaErrorInvalidValue;
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_vp2_sweep_strided<T>(
                   rhs, Tf, code, glo, ghi, gsl, gsh, out, B1, n, B2, ktab,
                   kn, ctab, cn, inv_dtor, h_lo, h_hi, tinf, rc, tik, tik2,
                   with_rad, edges, device, (cudaStream_t)stream))));
}
