// K12, K13 and K14: the constant-row sweeps of the unmasked cylindrical
// step (r, z and the periodic phi solve).
//
// K12 replaces adi_thermal_fields_tpu/solvers/pallas_sweeps.py
//    fused_sweep_const (:1567) in its axis-0 form (call site :1641, body
//    _const_sweep_kernel :1479): the tridiagonal solve along axis 0 of a
//    C-contiguous (n, B) field -- r of the natural (r, phi, z) field -- with
//    per-row scalar a, b, c and a per-row rhs addition radd.
// K13 replaces fused_sweep_const with nat_rhs_out=True (call site :1605,
//    body _const_sweep_kernel_nat :1512): the same rows along the
//    CONTIGUOUS last axis (z of the natural field).
// K14 replaces the fused_cyclic_const family -- fused_cyclic_const (:1727,
//    body :1659), fused_cyclic_const_axis1 (:1851, body :1770) and
//    fused_cyclic_const_nat (:1958, body :1888), one function in three TPU
//    layouts -- in the natural layout: the periodic solve (I - fac L_per) x
//    = d along axis 1 of a (B1, n, B2) field (phi), one fac per B1 index
//    (per ring; every caller broadcasts it over z).
//
// The recurrence (the Pallas bodies' reciprocal-multiply form):
//   inv_i = 1/(b_i - a_i cp_{i-1}),  cp_i = c_i inv_i,
//   d'_i = (d_i + radd_i - a_i d'_{i-1}) inv_i,  x_i = d'_i - cp_i x_{i+1}.
// The coefficients depend on the row only (K14: on the ring and the row),
// so inv and cp are the same for every line.  K12 and K13 take them from a
// table built once by `const_table_kernel` (one thread, _row_factors'
// order; the step keeps one for its r rows and one for its z rows, each
// for its dt), which also records the rows' stiffness ratio.  K14 also
// solves the Sherman-Morrison system
// B z = u (a = c = -fac, b = 1 + 2 fac, gamma = -b, b_0 = 2b, b_{n-1} = b
// - a a/gamma, u = gamma e_0 + a e_{n-1}), so a line carries only y and
// x = y - z (y_0 + a y_{n-1}/gamma)/(1 + z_0 + a z_{n-1}/gamma); its ring's
// inv, cp, z and the fix-up's denominator come from a table built once a
// ring by `cyclic_const_table_kernel` (the step keeps it for its dt).
//
// Rounding: the tables take every operation as one IEEE rounding
// (atf::add/sub/mul/div, the _rn intrinsics) in the order of the plain
// versions in solvers/const_sweeps.py, which compute inv and cp once per
// row the same way, so table and plain version agree bit for bit; so does
// K12's march (forward's and the back substitution's roundings on the
// table's factors).  K12 past its march, K13 and K14 split each line across
// warps (not Thomas order): a few float32 ulp of the output's scale from
// their plain versions (K14: up to 3 on rings whose stiffness ratio 2 fac
// = (|a| + |c|)/(b - |a| - |c|) stays below 128, up to 10 past 1024 on
// 4096-row lines; PERF.md section 6).  K14 solves the rings past kK14Stiff
// (a full disk's innermost rings at 0.5 mm cells) in Thomas order, bit for
// bit, K13 a table past kK13Stiff and K12 one past kK12Stiff.
//
// What bounds them on the H100: memory.  The byte model (float32) reads rhs
// 4 and writes x 4 = 8 B/cell (the coefficient vectors add < 0.01 B/cell).
//   K12: lines of up to kK12MarchRows rows march a thread a line (adjacent
//        threads on adjacent lines: every row load is coalesced), the
//        loads of the line's first kK12RegRows rows unrolled ahead of the
//        chain into registers, the rows past them copied by cp.async into
//        the thread's column of shared memory, d' kept where its row is,
//        the table's factors staged once a block in shared memory: the
//        field is read once and written once, and no line
//        divides.  Longer lines are split as K14's: a tile's lanes are 32
//        adjacent lines, its warps consecutive runs of rows kept in
//        registers (lines of up to 32 kK12Warps rows at float32, 16
//        kK12Warps at float64; past that each pass reads its rows again,
//        d' through the output: 24 B/cell), the carries through shared
//        memory.  Its first version ran a thread a line after thread 0 of
//        every block had formed the rows' factors in a serial chain of
//        divisions, with d' through the output (16 B/cell).
//   K13: a block takes a tile of 32 z lines, contiguous in global memory,
//        and stages it by cp.async into shared memory (16 bytes a copy,
//        the chunks XOR-swizzled, where the lines are whole 16-byte
//        chunks; else 4 or 8 bytes a copy into rows of an odd pitch);
//        then lane = line and warp = a run of rows, as in K14: the
//        forward and backward passes with their carries run on the
//        staged tile, in place, and the tile goes back to global memory
//        coalesced: the field is read once and written once, the table's
//        factors come through the read-only cache, and no line divides.
//        Lines too long to stage (past kK13StageKB of shared memory:
//        1,600 rows at float32) read their rows from global memory in
//        each pass, d' through the output (20 B/cell).  Its
//        first version ran one warp of 32 pencils a block whose lane 0
//        first formed every row's factors in a serial chain of divisions,
//        with d' through the output (16 B/cell, ~15 warps an SM).
//   K14: a tile's lanes are 32 lines adjacent in z of one ring, its warps
//        consecutive runs of phi rows, kept in registers (lines of up to
//        32 kK14Warps rows at float32, 16 kK14Warps at float64): the field
//        is read once and written once, the table's factors come through
//        the read-only cache (the same address across a warp), the
//        carries between the runs through shared memory, and no line
//        divides.  The blocks are persistent and load their next tile's
//        rows before solving this one (on the H100 the (128, 512, 512)
//        annulus took 0.30 ms a block a tile, 0.21 so; PERF.md section 6).
//        Longer lines read their rows again in each pass (24 B/cell).
//        Its first version marched a thread a pencil (y' through the
//        output, read back twice: 20 B/cell) after thread 0 of every
//        block had formed the ring's factors in a serial chain of
//        divisions.
#include <tuple>

#include "split_line.cuh"

namespace {

using atf::add;
using atf::div;
using atf::mul;
using atf::sub;

// d'_i from d'_{i-1}
template <typename T>
__device__ __forceinline__ T forward(T d, T radd, T a, T inv, T dp) {
  return mul(sub(add(d, radd), mul(a, dp)), inv);
}

// ---------------------------------------------------------------------------
// The run-and-carry solve of K12, K13 and K14: a line's rows split into
// runs, one a warp (lanes = lines).  Forward: a pass from zero gives each
// run's last l and the row-only multiplier G (the product of -a_i inv_i);
// the runs' carries chain through shared memory, D = l + G D; a second
// pass from the run's D gives d'.  Backward: the same with x_i = d'_i -
// cp_i x_{i+1} (m, and H the product of -cp_i).  No division on a line.
// ---------------------------------------------------------------------------

// one row of a forward pass: l from the row before, and G
template <typename T>
__device__ __forceinline__ void run_forward(T v, T ai, T iv, T& l, T& G) {
  l = (v - ai * l) * iv;
  G = G * (-ai * iv);
}

// one row of a backward pass: m from the row after, and H
template <typename T>
__device__ __forceinline__ void run_backward(T v, T ci, T& m, T& H) {
  m = v - ci * m;
  H = H * -ci;
}

// the carry into warp w's run: D of the runs before it (sL: their l, 32
// lines a run; sG: their G)
template <typename T>
__device__ __forceinline__ T carry_forward(const T* sL, const T* sG, int w,
                                           int lane) {
  T dp = T(0);
#pragma unroll 4
  for (int v = 0; v < w; ++v) dp = sL[v * 32 + lane] + sG[v] * dp;
  return dp;
}

// the backward chain over the W runs, last first: y_in (the carry into
// warp w's run, from the runs after it) and, returned, y at row 0
template <typename T>
__device__ __forceinline__ T carry_backward(const T* sM, const T* sH, int w,
                                            int W, int lane, T& y_in) {
  T y = T(0);
#pragma unroll 4
  for (int v = W - 1; v >= 0; --v) {
    if (v == w) y_in = y;
    y = sM[v * 32 + lane] + sH[v] * y;
  }
  return y;
}

// ---------------------------------------------------------------------------
// The row table of K12 and K13
// ---------------------------------------------------------------------------
//
// `const_table_kernel` (one thread, _row_factors' order): inv and cp (n
// values each), then one value (the wrappers' K13_TAIL): the rows'
// stiffness ratio, the largest (|a_i| + |c_i|)/(b_i - |a_i| - |c_i|) (a_0
// and c_{n-1} do not count; infinity where the denominator is not
// positive).
template <typename T>
__global__ void const_table_kernel(const T* __restrict__ a,
                                   const T* __restrict__ b,
                                   const T* __restrict__ c,
                                   T* __restrict__ tab, int64_t n) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  T cprev = T(0), ratio = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const T iv = div(T(1), sub(b[i], mul(a[i], cprev)));
    cprev = mul(c[i], iv);
    tab[i] = iv;
    tab[n + i] = cprev;
    const T off = add(i == 0 ? T(0) : fabs(a[i]),
                      i == n - 1 ? T(0) : fabs(c[i]));
    const T den = sub(b[i], off);
    const T r = den > T(0) ? div(off, den) : T(INFINITY);
    ratio = r > ratio ? r : ratio;
  }
  tab[2 * n] = ratio;
}

// the table's stiffness ratio
template <typename T>
__device__ __forceinline__ T table_ratio(const T* __restrict__ tab,
                                         int64_t n) {
  return __ldg(tab + 2 * n);
}

// ---------------------------------------------------------------------------
// K12: the constant-row r sweep
// ---------------------------------------------------------------------------
//
// K12's march (lines of up to kK12MarchRows rows at float32,
// kK12MarchRows64 at float64, a thread a line): the first rows of each
// line in registers (NR: 8, 16, 32 or 64 at float32, up to kK12RegRows;
// half of that at float64), unrolled, the rest in shared memory (a column
// of blockDim.x values a row), kK12MarchThreads threads a block.
// kK12MarchRows, kK12MarchRows64: where the march and the split kernel
// cross on the H100 (PERF.md section 6; scripts/cyl_be_tune.py
// --crossover, r lines of n rows of phase 7's annulus kind, ~2^25 cells):
// the march 0.120-0.164 ms from 16 to 256 rows against the split
// kernel's 0.226-0.274, a tie at 384 (160 KB of shared memory a block);
// at float64 0.218-0.242 up to 128 rows against 0.268-0.364, a tie at
// 160.  Every row in registers took 0.199 ms at 128 rows (179 registers).
constexpr int kK12MarchRows = 256;
constexpr int kK12MarchRows64 = 128;
constexpr int kK12RegRows = 64;
constexpr int kK12MarchThreads = 128;

template <typename T>
struct K12March {
  static constexpr int kRows =
      sizeof(T) == 4 ? kK12MarchRows : kK12MarchRows64;
  static constexpr int kRegRows =
      sizeof(T) == 4 ? kK12RegRows : kK12RegRows / 2;
};

// K12's stiffness ratio: a table past it is solved in Thomas order past
// the march, bit for bit const_sweep_strided_plain.  1024, as K13's: with
// every table split, over five seeds and dt x1-1000 on chip_smoke.py
// phase 7's shapes, the spiral app's r rows and 512-row lines
// (scripts/cyl_be_tune.py, PERF.md section 6), tables below 1024 stayed
// within 5.1 float32 ulp of scale of the plain version (the gate is 8),
// those of 2261 reached 8.6.
constexpr double kK12Stiff = 1024.0;

// The split kernel's warps and the blocks an SM its registers are held to
// (as K14's).
constexpr int kK12Warps = 16;
constexpr int kK12Blocks = 1;

// B lines of n rows B apart, a thread a line, in Thomas order on the
// table's factors (forward's and the back substitution's roundings: the
// plain version's).  The block stages a, radd, inv and cp in shared
// memory.  Each thread first sends its line's rows past NR by cp.async
// into its column of shared memory, then loads its first NR rows into
// registers (the loop is unrolled: all the loads are in flight together)
// and runs the chain over them while the copies land; d' stays where its
// row is, and the back substitution writes x once.
template <typename T, int NR>
__global__ void __launch_bounds__(kK12MarchThreads)
    const_march_kernel(const T* __restrict__ rhs, const T* __restrict__ a,
                       const T* __restrict__ radd, const T* __restrict__ tab,
                       T* __restrict__ out, int64_t n, int64_t B) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* sa = reinterpret_cast<T*>(atf_smem);        // a, radd, inv, cp
  T* sr = sa + n;
  T* si = sr + n;
  T* sc = si + n;
  T* sd = sc + n + threadIdx.x;                  // rows NR..n-1 of the line
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < B;
  if (valid) {
    for (int64_t i = NR; i < n; ++i) {
      cp_async(sd + (i - NR) * blockDim.x, rhs + i * B + p, (int)sizeof(T));
    }
  }
  cp_async_commit();
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    sa[i] = __ldg(a + i);
    sr[i] = __ldg(radd + i);
    si[i] = __ldg(tab + i);
    sc[i] = __ldg(tab + n + i);
  }
  __syncthreads();
  if (!valid) return;
  T d[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (i < n) d[i] = rhs[(int64_t)i * B + p];
  }
  T dp = T(0);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (i < n) {
      dp = forward(d[i], sr[i], sa[i], si[i], dp);
      d[i] = dp;
    }
  }
  cp_async_wait<0>();
#pragma unroll 4
  for (int64_t i = NR; i < n; ++i) {
    T& v = sd[(i - NR) * blockDim.x];
    dp = forward(v, sr[i], sa[i], si[i], dp);
    v = dp;
  }
  T x = T(0);
#pragma unroll 4
  for (int64_t i = n - 1; i >= NR; --i) {
    x = sub(sd[(i - NR) * blockDim.x], mul(sc[i], x));
    out[i * B + p] = x;
  }
#pragma unroll
  for (int i = NR - 1; i >= 0; --i) {
    if (i < n) {
      x = sub(d[i], mul(sc[i], x));
      out[(int64_t)i * B + p] = x;
    }
  }
}

// Line p of a table past kK12Stiff in Thomas order, its rows read from
// global memory and d' through the output: the plain version's roundings.
template <typename T>
__device__ __noinline__ void const_thomas_strided(
    const T* __restrict__ rhs, const T* __restrict__ a,
    const T* __restrict__ radd, const T* __restrict__ tab,
    T* __restrict__ out, int64_t p, int64_t n, int64_t B) {
  T dp = T(0);
  for (int64_t i = 0; i < n; ++i) {
    dp = forward(rhs[i * B + p], __ldg(radd + i), __ldg(a + i),
                 __ldg(tab + i), dp);
    out[i * B + p] = dp;
  }
  T x = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    x = sub(out[i * B + p], mul(__ldg(tab + n + i), x));
    out[i * B + p] = x;
  }
}

// Lines past the march: a tile's lanes are 32 adjacent lines (p = 32 t +
// lane), the block's W warps taking consecutive runs of R*M rows (kRegs:
// R = 1, the rows kept in registers; else each pass reads them again, d'
// through the output), solved by run and carry (above, the order of K13),
// the blocks persistent (as many as fit on the card), each walking tiles
// gridDim.x apart and, with kRegs, loading its rows of the next tile
// before it solves this one.  A table past kK12Stiff: every thread marches
// lines in Thomas order instead.
template <typename T, int M, bool kRegs>
__global__ void __launch_bounds__(32 * kK12Warps, kK12Blocks)
    const_split_kernel(const T* __restrict__ rhs, const T* __restrict__ a,
                       const T* __restrict__ radd, const T* __restrict__ tab,
                       T* __restrict__ out, int64_t n, int64_t B, int R) {
  __shared__ T sL[32 * kK12Warps], sM[32 * kK12Warps], sG[kK12Warps],
      sH[kK12Warps];
  if (table_ratio(tab, n) > T(kK12Stiff)) {      // Thomas order
    for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < B;
         p += (int64_t)gridDim.x * blockDim.x) {
      const_thomas_strided(rhs, a, radd, tab, out, p, n, B);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const T* inv = tab;
  const T* cp = tab + n;
  const int64_t tiles = atf::cdiv(B, 32);
  const int64_t i0 = (int64_t)w * R * M;        // the run's first row
  auto coef = [&](int64_t i) { return i == 0 ? T(0) : __ldg(a + i); };
  T next[kRegs ? M : 1];
  auto prefetch = [&](int64_t t) {
    if (t >= tiles) return;
    const int64_t p = t * 32 + lane;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = i0 + k;
      next[k] = (p < B && i < n) ? rhs[i * B + p] : T(0);
    }
  };
  if constexpr (kRegs) prefetch(blockIdx.x);

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t p = t * 32 + lane;
    const bool valid = p < B;
    T d[kRegs ? M : 1];
    if constexpr (kRegs) {
#pragma unroll
      for (int k = 0; k < M; ++k) d[k] = next[k];
      prefetch(t + gridDim.x);
    }
    // row i's rhs (k: its place in the run's registers), or d' after the
    // forward passes
    auto value = [&](int64_t i, int k) {
      if constexpr (kRegs) {
        return d[k];
      } else {
        return valid ? rhs[i * B + p] : T(0);
      }
    };
    auto dprime = [&](int64_t i, int k) {
      if constexpr (kRegs) {
        return d[k];
      } else {
        return valid ? out[i * B + p] : T(0);
      }
    };

    T l = T(0), G = T(1);                        // forward from zero
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          run_forward(value(i, k) + __ldg(radd + i), coef(i), __ldg(inv + i),
                      l, G);
        }
      }
    }
    sL[threadIdx.x] = l;
    if (lane == 0) sG[w] = G;
    __syncthreads();
    T dp = carry_forward(sL, sG, w, lane);       // forward again: d'
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          dp = (value(i, k) + __ldg(radd + i) - coef(i) * dp) *
               __ldg(inv + i);
          if constexpr (kRegs) {
            d[k] = dp;
          } else if (valid) {
            out[i * B + p] = dp;
          }
        }
      }
    }
    T m = T(0), H = T(1);                        // backward from zero
    for (int r = R - 1; r >= 0; --r) {
#pragma unroll
      for (int k = M - 1; k >= 0; --k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) run_backward(dprime(i, k), __ldg(cp + i), m, H);
      }
    }
    sM[threadIdx.x] = m;
    if (lane == 0) sH[w] = H;
    __syncthreads();
    T y = T(0);                                  // backward again: x
    carry_backward(sM, sH, w, W, lane, y);
    for (int r = R - 1; r >= 0; --r) {
#pragma unroll
      for (int k = M - 1; k >= 0; --k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          y = dprime(i, k) - __ldg(cp + i) * y;
          if (valid) out[i * B + p] = y;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K13: the constant-row z sweep
// ---------------------------------------------------------------------------
//
// K13's stiffness ratio: a table past it is solved in Thomas order, bit
// for bit const_sweep_z_plain.  1024: with every table split, over five
// seeds and dt x1-100 on chip_smoke.py phase 7's shapes, the spiral app's
// z rows and 8192-row lines (scripts/cyl_be_tune.py, PERF.md section 6),
// tables below 1024 stayed within 5.3 float32 ulp of scale of the plain
// version (the gate is 8), those of 1130 and 2261 reached 6.1 and 6.8;
// the plain version lay as far from the float64 solve as the split one.
// The steps' tables sit at 2.3 (phase 7) and 22.6 (the spiral app).
constexpr double kK13Stiff = 1024.0;

// The block's warps (at most: every warp takes at least one row), the
// unrolling of its passes and the most shared memory a staged tile may
// take.
constexpr int kK13Warps = 16;
constexpr int kK13Unroll = 8;
constexpr int kK13StageKB = 200;

// A tile: 32 lines (the lanes; pen0 its first), warp w taking rows [w R,
// (w + 1) R).  kStaged: the tile is staged into shared memory by cp.async
// (line q's row i at q * pitch + i, pitch = n | 1: odd, so that the
// lanes' rows fall in distinct banks), solved there in place and stored
// back coalesced; else each pass reads the rows from global memory and d'
// goes through the output.  A table past kK13Stiff: warp 0 marches each
// line in Thomas order with forward's and the back substitution's
// roundings (the plain version's).  A block a tile: the blocks an SM (three
// at 512 rows) load, solve and store out of phase, which kept the memory
// busier than persistent blocks that stage their next tile while solving
// this one (one block an SM; PERF.md section 6).
template <typename T, bool kStaged>
__global__ void __launch_bounds__(32 * kK13Warps)
    const_sweep_z_kernel(const T* __restrict__ rhs, const T* __restrict__ a,
                         const T* __restrict__ radd,
                         const T* __restrict__ tab, T* __restrict__ out,
                         int64_t npen, int64_t n, int R) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  __shared__ T sL[32 * kK13Warps], sM[32 * kK13Warps], sG[kK13Warps],
      sH[kK13Warps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t pen0 = (int64_t)blockIdx.x * 32;
  const int np = (int)atf::imin(32, npen - pen0);
  const bool valid = lane < np;
  const int64_t pitch = n | 1;
  T* tile = reinterpret_cast<T*>(atf_smem);
  // each thread's elements of the tile's np lines, in global order
  auto tile_loop = [&](auto&& f) {
    int64_t q = 0, i = threadIdx.x;
    while (i >= n) {
      i -= n;
      ++q;
    }
    while (q < np) {
      f(q, i);
      i += blockDim.x;
      while (i >= n) {
        i -= n;
        ++q;
      }
    }
  };
  if constexpr (kStaged) {
    tile_loop([&](int64_t q, int64_t i) {
      stage(tile + q * pitch + i, rhs + (pen0 + q) * n + i);
    });
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const T* src = kStaged ? tile + lane * pitch : rhs + (pen0 + lane) * n;
  T* dst = kStaged ? tile + lane * pitch : out + (pen0 + lane) * n;
  const T* inv = tab;
  const T* cp = tab + n;

  if (table_ratio(tab, n) > T(kK13Stiff)) {       // Thomas order
    if (w == 0 && valid) {
      T dp = T(0);
      for (int64_t i = 0; i < n; ++i) {
        dp = forward(src[i], __ldg(radd + i), __ldg(a + i), __ldg(inv + i),
                     dp);
        dst[i] = dp;
      }
      T x = T(0);
      for (int64_t i = n - 1; i >= 0; --i) {
        x = sub(dst[i], mul(__ldg(cp + i), x));
        dst[i] = x;
      }
    }
  } else {
    const int64_t i0 = (int64_t)w * R;
    const int64_t i1 = atf::imin(n, i0 + R);
    auto coef = [&](int64_t i) { return i == 0 ? T(0) : __ldg(a + i); };
    T l = T(0), G = T(1);                        // forward from zero
#pragma unroll kK13Unroll
    for (int64_t i = i0; i < i1; ++i) {
      run_forward(valid ? src[i] + __ldg(radd + i) : T(0), coef(i),
                  __ldg(inv + i), l, G);
    }
    sL[threadIdx.x] = l;
    if (lane == 0) sG[w] = G;
    __syncthreads();
    T dp = carry_forward(sL, sG, w, lane);       // forward again: d'
    if (valid) {
#pragma unroll kK13Unroll
      for (int64_t i = i0; i < i1; ++i) {
        dp = (src[i] + __ldg(radd + i) - coef(i) * dp) * __ldg(inv + i);
        dst[i] = dp;
      }
    }
    T m = T(0), H = T(1);                        // backward from zero
#pragma unroll kK13Unroll
    for (int64_t i = i1 - 1; i >= i0; --i) {
      run_backward(valid ? dst[i] : T(0), __ldg(cp + i), m, H);
    }
    sM[threadIdx.x] = m;
    if (lane == 0) sH[w] = H;
    __syncthreads();
    T y = T(0);                                  // backward again: x
    carry_backward(sM, sH, w, W, lane, y);
    if (valid) {
#pragma unroll kK13Unroll
      for (int64_t i = i1 - 1; i >= i0; --i) {
        y = dst[i] - __ldg(cp + i) * y;
        dst[i] = y;
      }
    }
  }
  if constexpr (kStaged) {                       // the tile back, coalesced
    __syncthreads();
    tile_loop([&](int64_t q, int64_t i) {
      out[(pen0 + q) * n + i] = tile[q * pitch + i];
    });
  }
}

// 16 bytes of a line: V = 4 float32 or 2 float64 rows.
template <typename T>
struct alignas(16) Rows16 {
  static constexpr int V = 16 / sizeof(T);
  T v[V];
};

// chunk c of a (16-byte aligned) vector through the read-only cache
template <typename T>
__device__ __forceinline__ Rows16<T> ld16(const T* p, int64_t c) {
  Rows16<T> r;
  if constexpr (sizeof(T) == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p) + c);
    r.v[0] = x.x;
    r.v[1] = x.y;
    r.v[2] = x.z;
    r.v[3] = x.w;
  } else {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p) + c);
    r.v[0] = x.x;
    r.v[1] = x.y;
  }
  return r;
}

// K13 on lines of a whole number of 16-byte chunks (n a multiple of V,
// every vector 16-byte aligned): const_sweep_z_kernel's solve, in the same
// order, on a tile staged 16 bytes a copy.  Line q's chunk c lies at q *
// pc + (c ^ (q & 7)) (pc: the chunks a line, rounded up to 8): XOR-swizzled
// within its group of eight, so that the eight lanes of a quarter warp,
// reading one chunk each of eight lines, hit distinct banks; each pass
// reads and writes a chunk (V rows) at a time, and takes the coefficients
// a chunk at a time too.  Runs are whole chunks (R a multiple of V).
template <typename T>
__global__ void __launch_bounds__(32 * kK13Warps)
    const_sweep_z_vec_kernel(const T* __restrict__ rhs,
                             const T* __restrict__ a,
                             const T* __restrict__ radd,
                             const T* __restrict__ tab, T* __restrict__ out,
                             int64_t npen, int64_t n, int R) {
  using C16 = Rows16<T>;
  constexpr int V = C16::V;
  extern __shared__ __align__(16) unsigned char atf_smem[];
  __shared__ T sL[32 * kK13Warps], sM[32 * kK13Warps], sG[kK13Warps],
      sH[kK13Warps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t pen0 = (int64_t)blockIdx.x * 32;
  const int np = (int)atf::imin(32, npen - pen0);
  const int64_t nc = n / V;
  const int64_t pc = atf::cdiv(nc, 8) * 8;
  C16* tile = reinterpret_cast<C16*>(atf_smem);
  auto at = [&](int64_t q, int64_t c) { return q * pc + (c ^ (q & 7)); };
  // each thread's chunks of the tile's np lines, in global order
  auto chunk_loop = [&](auto&& f) {
    int64_t q = 0, c = threadIdx.x;
    while (c >= nc) {
      c -= nc;
      ++q;
    }
    while (q < np) {
      f(q, c);
      c += blockDim.x;
      while (c >= nc) {
        c -= nc;
        ++q;
      }
    }
  };
  chunk_loop([&](int64_t q, int64_t c) {
    cp_async(tile + at(q, c), rhs + (pen0 + q) * n + c * V, 16);
  });
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const T* inv = tab;
  const T* cp = tab + n;

  if (table_ratio(tab, n) > T(kK13Stiff)) {       // Thomas order
    if (w == 0 && lane < np) {
      auto el = [&](int64_t i) -> T& {
        return tile[at(lane, i / V)].v[i % V];
      };
      T dp = T(0);
      for (int64_t i = 0; i < n; ++i) {
        dp = forward(el(i), __ldg(radd + i), __ldg(a + i), __ldg(inv + i),
                     dp);
        el(i) = dp;
      }
      T x = T(0);
      for (int64_t i = n - 1; i >= 0; --i) {
        x = sub(el(i), mul(__ldg(cp + i), x));
        el(i) = x;
      }
    }
  } else {
    const int64_t c0 = (int64_t)w * (R / V);
    const int64_t c1 = atf::imin(nc, c0 + R / V);
    auto coef = [&](const C16& av, int64_t c, int k) {
      return c == 0 && k == 0 ? T(0) : av.v[k];
    };
    T l = T(0), G = T(1);                        // forward from zero
    for (int64_t c = c0; c < c1; ++c) {
      const C16 x = tile[at(lane, c)], ra = ld16(radd, c), av = ld16(a, c),
                iv = ld16(inv, c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        run_forward(x.v[k] + ra.v[k], coef(av, c, k), iv.v[k], l, G);
      }
    }
    sL[threadIdx.x] = l;
    if (lane == 0) sG[w] = G;
    __syncthreads();
    T dp = carry_forward(sL, sG, w, lane);       // forward again: d'
    for (int64_t c = c0; c < c1; ++c) {
      C16 x = tile[at(lane, c)];
      const C16 ra = ld16(radd, c), av = ld16(a, c), iv = ld16(inv, c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        dp = (x.v[k] + ra.v[k] - coef(av, c, k) * dp) * iv.v[k];
        x.v[k] = dp;
      }
      tile[at(lane, c)] = x;
    }
    T m = T(0), H = T(1);                        // backward from zero
    for (int64_t c = c1 - 1; c >= c0; --c) {
      const C16 x = tile[at(lane, c)], cv = ld16(cp, c);
#pragma unroll
      for (int k = V - 1; k >= 0; --k) run_backward(x.v[k], cv.v[k], m, H);
    }
    sM[threadIdx.x] = m;
    if (lane == 0) sH[w] = H;
    __syncthreads();
    T y = T(0);                                  // backward again: x
    carry_backward(sM, sH, w, W, lane, y);
    for (int64_t c = c1 - 1; c >= c0; --c) {
      C16 x = tile[at(lane, c)];
      const C16 cv = ld16(cp, c);
#pragma unroll
      for (int k = V - 1; k >= 0; --k) {
        y = x.v[k] - cv.v[k] * y;
        x.v[k] = y;
      }
      tile[at(lane, c)] = x;
    }
  }
  __syncthreads();                               // the tile back, coalesced
  chunk_loop([&](int64_t q, int64_t c) {
    reinterpret_cast<C16*>(out + (pen0 + q) * n)[c] = tile[at(q, c)];
  });
}

// ---------------------------------------------------------------------------
// K14: the periodic phi solve
// ---------------------------------------------------------------------------
//
// The ring's table (`cyclic_const_table_kernel`, one thread a ring, in
// cyclic_const_phi_plain's order): inv, cp and z (n values each), then
// kK14Tail values: den = 1 + z_0 + a z_{n-1}/gamma, e = a/gamma and 1/den.
constexpr int kK14Tail = 3;

// K14's stiffness ratio: a ring whose rows' (|a| + |c|)/(b - |a| - |c|) =
// 2 fac exceeds it is solved in Thomas order.  128: with every ring split,
// rings below it stayed within 3.0 float32 ulp of the output's scale of
// the plain version, rings of 128-1024 within 5.4, past 1024 up to 10.4
// (5 seeds, dt x1-10, chip_smoke.py phase 7's shapes, the spiral app's
// ring and 4096-row lines; scripts/cyl_be_tune.py, PERF.md section 6).
constexpr double kK14Stiff = 128.0;

template <typename T>
__global__ void cyclic_const_table_kernel(const T* __restrict__ fac,
                                          T* __restrict__ tab, int64_t B1,
                                          int64_t n) {
  const int64_t ring = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ring >= B1) return;
  T* inv = tab + ring * (3 * n + kK14Tail);
  T* cp = inv + n;
  T* zv = cp + n;
  T* tail = zv + n;
  const T f = fac[ring];
  const T a = -f;
  const T b = add(T(1), mul(T(2), f));
  const T gamma = -b;
  const T b0 = mul(T(2), b);
  const T bn = sub(b, div(mul(a, a), gamma));
  T cprev = T(0), dz = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const T ai = (i == 0) ? T(0) : a;
    const T ci = (i == n - 1) ? T(0) : a;
    const T bi = (i == n - 1) ? bn : ((i == 0) ? b0 : b);
    const T ui = (i == n - 1) ? a : ((i == 0) ? gamma : T(0));
    const T iv = div(T(1), sub(bi, mul(ai, cprev)));
    cprev = mul(ci, iv);
    dz = mul(sub(ui, mul(ai, dz)), iv);
    inv[i] = iv;
    cp[i] = cprev;
    zv[i] = dz;
  }
  T z = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    z = sub(zv[i], mul(cp[i], z));
    zv[i] = z;
  }
  const T den = add(add(T(1), zv[0]), div(mul(a, zv[n - 1]), gamma));
  tail[0] = den;
  tail[1] = div(a, gamma);
  tail[2] = div(T(1), den);
}

// A line of a ring past kK14Stiff in Thomas order with the table's
// factors, one rounding each: cyclic_const_phi_plain bit for bit.  y' goes
// through the output, which is read back twice (for y_0 and y_{n-1}, then
// for x).
template <typename T>
__device__ __noinline__ void cyclic_const_thomas(
    const T* __restrict__ rhs, const T* __restrict__ tr, T a,
    T* __restrict__ out, int64_t base, int64_t n, int64_t B2) {
  const T* inv = tr;
  const T* cp = tr + n;
  const T* zv = tr + 2 * n;
  const T gamma = -add(T(1), mul(T(2), -a));
  T dy = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    const T ai = (i == 0) ? T(0) : a;
    dy = mul(sub(rhs[off], mul(ai, dy)), __ldg(inv + i));
    out[off] = dy;
  }
  T y = T(0), yn = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    y = sub(out[base + i * B2], mul(__ldg(cp + i), y));
    if (i == n - 1) yn = y;
  }
  const T fact = div(add(y, div(mul(a, yn), gamma)), __ldg(tr + 3 * n));
  y = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    y = sub(out[off], mul(__ldg(cp + i), y));
    out[off] = sub(y, mul(fact, __ldg(zv + i)));
  }
}

// The block's warps and the blocks an SM its registers are held to: 16
// warps, one block an SM (120 registers at 32 rows a thread) against 32
// warps (64 registers, 16 rows a thread) and two blocks of 16 (spills):
// 0.208-0.214 against 0.213-0.220 and 0.254 ms on the (128, 512, 512)
// annulus (scripts/cyl_be_tune.py, PERF.md section 6).
constexpr int kK14Warps = 16;
constexpr int kK14Blocks = 1;

// A tile: 32 lines adjacent in z (the lanes) of one ring, the block's W
// warps taking consecutive runs of R*M phi rows (kRegs: R = 1, the rows
// kept in registers; else each pass reads them again, d' through the
// output), solved by run and carry (above), the backward chain ending at
// y_0; y_{n-1} = d'_{n-1} comes from the last warp.  Then
// x = y - fact z with fact = (y_0 + e y_{n-1}) / den: no division on a
// line.  A ring past kK14Stiff goes to the Thomas order instead.  The
// blocks are persistent (as many as fit on the card), each walking tiles
// gridDim.x apart; with kRegs a thread loads its rows of the next tile
// before it solves this one, so the loads fly while it computes.
template <typename T, int M, bool kRegs>
__global__ void __launch_bounds__(32 * kK14Warps, kK14Blocks)
    cyclic_const_phi_kernel(const T* __restrict__ rhs,
                            const T* __restrict__ fac,
                            const T* __restrict__ tab, T* __restrict__ out,
                            int64_t B1, int64_t n, int64_t B2, int R) {
  __shared__ T sL[32 * kK14Warps], sM[32 * kK14Warps], sG[kK14Warps],
      sH[kK14Warps], sYn[32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t groups = atf::cdiv(B2, 32);
  const int64_t tiles = B1 * groups;
  const int64_t i0 = (int64_t)w * R * M;        // the run's first row
  // the tile's ring and the lane's line (b2 >= B2: no line)
  auto line = [&](int64_t t, int64_t& ring, int64_t& b2) {
    ring = t / groups;
    b2 = (t - ring * groups) * 32 + lane;
  };
  T next[kRegs ? M : 1];
  auto prefetch = [&](int64_t t) {
    if (t >= tiles) return;
    int64_t ring, b2;
    line(t, ring, b2);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = i0 + k;
      next[k] = (b2 < B2 && i < n) ? rhs[ring * n * B2 + i * B2 + b2] : T(0);
    }
  };
  if constexpr (kRegs) prefetch(blockIdx.x);

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    int64_t ring, b2;
    line(t, ring, b2);
    const bool valid = b2 < B2;
    const int64_t base = ring * n * B2 + b2;
    const T* tr = tab + ring * (3 * n + kK14Tail);
    const T* inv = tr;
    const T* cp = tr + n;
    const T* zv = tr + 2 * n;
    const T f = __ldg(fac + ring);
    const T a = -f;
    T d[kRegs ? M : 1];
    if constexpr (kRegs) {
#pragma unroll
      for (int k = 0; k < M; ++k) d[k] = next[k];
      prefetch(t + gridDim.x);
    }
    if (T(2) * f > T(kK14Stiff)) {
      if (w == 0 && valid) cyclic_const_thomas(rhs, tr, a, out, base, n, B2);
      continue;
    }
    auto load = [&](int64_t i) { return valid ? rhs[base + i * B2] : T(0); };

    T l = T(0), G = T(1);                        // forward from zero
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          T v;
          if constexpr (kRegs) {
            v = d[k];
          } else {
            v = load(i);
          }
          run_forward(v, i == 0 ? T(0) : a, __ldg(inv + i), l, G);
        }
      }
    }
    sL[threadIdx.x] = l;
    if (lane == 0) sG[w] = G;
    __syncthreads();
    T dp = carry_forward(sL, sG, w, lane);       // D of the runs before
    bool last = false;
    for (int r = 0; r < R; ++r) {                // forward again: d'
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          T v;
          if constexpr (kRegs) {
            v = d[k];
          } else {
            v = load(i);
          }
          const T ai = i == 0 ? T(0) : a;
          dp = (v - ai * dp) * __ldg(inv + i);
          if constexpr (kRegs) {
            d[k] = dp;
          } else if (valid) {
            out[base + i * B2] = dp;
          }
          last = i == n - 1;
        }
      }
    }
    if (last) sYn[lane] = dp;                    // y_{n-1} = d'_{n-1}

    T m = T(0), H = T(1);                        // backward from zero
    for (int r = R - 1; r >= 0; --r) {
#pragma unroll
      for (int k = M - 1; k >= 0; --k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          T v;
          if constexpr (kRegs) {
            v = d[k];
          } else {
            v = valid ? out[base + i * B2] : T(0);
          }
          run_backward(v, __ldg(cp + i), m, H);
        }
      }
    }
    sM[threadIdx.x] = m;
    if (lane == 0) sH[w] = H;
    __syncthreads();
    T y_in = T(0);                               // the chain down to y_0
    T y = carry_backward(sM, sH, w, W, lane, y_in);
    const T fact = (y + __ldg(tr + 3 * n + 1) * sYn[lane]) *
                   __ldg(tr + 3 * n + 2);
    y = y_in;                                    // backward again: x
    for (int r = R - 1; r >= 0; --r) {
#pragma unroll
      for (int k = M - 1; k >= 0; --k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          T v;
          if constexpr (kRegs) {
            v = d[k];
          } else {
            v = valid ? out[base + i * B2] : T(0);
          }
          y = v - __ldg(cp + i) * y;
          if (valid) out[base + i * B2] = y - fact * __ldg(zv + i);
        }
      }
    }
  }
}

// The march's shared memory: the four coefficient vectors and the rows
// past NR of the block's lines.
template <typename T>
size_t const_march_smem(int64_t n, int NR) {
  const int64_t shared_rows = n > NR ? n - NR : 0;
  return sizeof(T) *
         (4 * (size_t)n + (size_t)shared_rows * kK12MarchThreads);
}

template <typename T, int NR>
cudaError_t launch_const_march(const T* rhs, const T* a, const T* radd,
                               const T* tab, T* out, int64_t n, int64_t B,
                               cudaStream_t stream) {
  const int threads = kK12MarchThreads;
  const size_t smem = const_march_smem<T>(n, NR);
  auto* kernel = const_march_kernel<T, NR>;
  atf::allow_dynamic_smem(kernel, smem);
  kernel<<<(unsigned)atf::cdiv(B, threads), threads, smem, stream>>>(
      rhs, a, radd, tab, out, n, B);
  return cudaSuccess;
}

template <typename T, int M, bool kRegs>
cudaError_t launch_const_split(const T* rhs, const T* a, const T* radd,
                               const T* tab, T* out, int64_t n, int64_t B,
                               int device, cudaStream_t stream) {
  // every warp takes at least one row
  const int R = kRegs ? 1 : (int)atf::cdiv(n, (int64_t)kK12Warps * M);
  const int W = (int)atf::cdiv(n, (int64_t)R * M);
  auto* kernel = const_split_kernel<T, M, kRegs>;
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * W, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t blocks = atf::imin(
      atf::cdiv(B, 32), (int64_t)(per_sm > 0 ? per_sm : 1) *
                            (sms > 0 ? sms : 1));
  kernel<<<(unsigned)blocks, 32 * W, 0, stream>>>(rhs, a, radd, tab, out, n,
                                                  B, R);
  return cudaSuccess;
}

// K12: the (n, B) field's lines along axis 0, the march up to
// K12March<T>::kRows rows (where its shared memory fits); past it the
// split kernel with M rows a thread, the fewest that keep a line in
// registers within kK12Warps warps (at most 32 at float32, 16 at float64),
// else 16 rows a thread read again in each pass.
template <typename T>
cudaError_t launch_const_sweep_strided(const void* rhs, const void* a,
                                       const void* radd, const void* tab,
                                       void* out, int64_t n, int64_t B,
                                       int device, cudaStream_t stream) {
  auto* r = static_cast<const T*>(rhs);
  auto* av = static_cast<const T*>(a);
  auto* ra = static_cast<const T*>(radd);
  auto* t = static_cast<const T*>(tab);
  auto* o = static_cast<T*>(out);
  constexpr int kRegRows = K12March<T>::kRegRows;
  if (n <= K12March<T>::kRows &&
      const_march_smem<T>(n, kRegRows) <= (size_t)smem_limit(device)) {
    auto args = std::make_tuple(r, av, ra, t, o, n, B, stream);
    if (n <= 8) return std::apply(launch_const_march<T, 8>, args);
    if (n <= 16) return std::apply(launch_const_march<T, 16>, args);
    if (n <= 32 || kRegRows == 32) {
      return std::apply(launch_const_march<T, 32>, args);
    }
    return std::apply(launch_const_march<T, kRegRows>, args);
  }
  auto args = std::make_tuple(r, av, ra, t, o, n, B, device, stream);
  auto fits = [&](int M) { return atf::cdiv(n, M) <= kK12Warps; };
  if (fits(4)) return std::apply(launch_const_split<T, 4, true>, args);
  if (fits(8)) return std::apply(launch_const_split<T, 8, true>, args);
  if (fits(16)) return std::apply(launch_const_split<T, 16, true>, args);
  if (sizeof(T) == 4 && fits(32)) {
    return std::apply(
        launch_const_split<T, sizeof(T) == 4 ? 32 : 16, true>, args);
  }
  return std::apply(launch_const_split<T, 16, false>, args);
}

// K13: lines of n rows split into runs over W warps; the tile staged where
// it takes at most kK13StageKB (and the card's limit) of shared memory, 16
// bytes a copy where the lines and vectors allow it.
template <typename T>
cudaError_t launch_const_sweep_z(const void* rhs, const void* a,
                                 const void* radd, const void* tab,
                                 void* out, int64_t npen, int64_t n,
                                 int device, cudaStream_t stream) {
  constexpr int V = Rows16<T>::V;
  const unsigned blocks = (unsigned)atf::cdiv(npen, 32);
  const size_t limit = atf::imin(smem_limit(device), kK13StageKB * 1024);
  auto* r = static_cast<const T*>(rhs);
  auto* av = static_cast<const T*>(a);
  auto* ra = static_cast<const T*>(radd);
  auto* t = static_cast<const T*>(tab);
  auto* o = static_cast<T*>(out);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const size_t vec_smem = 16 * 32 * (size_t)(atf::cdiv(n / V, 8) * 8);
  if (n % V == 0 && aligned(rhs) && aligned(a) && aligned(radd) &&
      aligned(tab) && aligned(out) && vec_smem <= limit) {
    const int R = (int)(atf::cdiv(atf::cdiv(n, kK13Warps), V) * V);
    const int W = (int)atf::cdiv(n, R);
    auto* kernel = const_sweep_z_vec_kernel<T>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)vec_smem);
    kernel<<<blocks, 32 * W, vec_smem, stream>>>(r, av, ra, t, o, npen, n,
                                                 R);
    return cudaSuccess;
  }
  const int R = (int)atf::cdiv(n, atf::imin(kK13Warps, n));
  const int W = (int)atf::cdiv(n, R);             // every warp a row or more
  const size_t smem = sizeof(T) * 32 * (size_t)(n | 1);
  if (smem <= limit) {
    auto* kernel = const_sweep_z_kernel<T, true>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<blocks, 32 * W, smem, stream>>>(r, av, ra, t, o, npen, n, R);
  } else {
    const_sweep_z_kernel<T, false><<<blocks, 32 * W, 0, stream>>>(
        r, av, ra, t, o, npen, n, R);
  }
  return cudaSuccess;
}

template <typename T>
void launch_const_table(const void* a, const void* b, const void* c,
                        void* tab, int64_t n, cudaStream_t stream) {
  const_table_kernel<T><<<1, 32, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(tab), n);
}

template <typename T, int M, bool kRegs>
void launch_cyclic_const_phi_m(const T* rhs, const T* fac, const T* tab,
                               T* out, int64_t B1, int64_t n, int64_t B2,
                               int device, cudaStream_t stream) {
  // every warp takes at least one row
  const int R =
      kRegs ? 1 : (int)atf::cdiv(n, (int64_t)kK14Warps * M);
  const int W = (int)atf::cdiv(n, (int64_t)R * M);
  auto* kernel = cyclic_const_phi_kernel<T, M, kRegs>;
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * W, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t tiles = B1 * atf::cdiv(B2, 32);
  const int64_t blocks = atf::imin(
      tiles, (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1));
  kernel<<<(unsigned)blocks, 32 * W, 0, stream>>>(rhs, fac, tab, out, B1, n,
                                                  B2, R);
}

// M: the fewest rows a thread that keep a line in registers within
// kK14Warps warps (at most 32 rows a thread at float32, 16 at float64),
// else 16 rows a thread read again in each pass.
template <typename T>
void launch_cyclic_const_phi(const void* rhs, const void* fac,
                             const void* tab, void* out, int64_t B1,
                             int64_t n, int64_t B2, int device,
                             cudaStream_t stream) {
  auto* r = static_cast<const T*>(rhs);
  auto* f = static_cast<const T*>(fac);
  auto* t = static_cast<const T*>(tab);
  auto* o = static_cast<T*>(out);
  auto fits = [&](int M) { return atf::cdiv(n, M) <= kK14Warps; };
  auto args = std::make_tuple(r, f, t, o, B1, n, B2, device, stream);
  if (fits(4)) {
    std::apply(launch_cyclic_const_phi_m<T, 4, true>, args);
  } else if (fits(8)) {
    std::apply(launch_cyclic_const_phi_m<T, 8, true>, args);
  } else if (fits(16)) {
    std::apply(launch_cyclic_const_phi_m<T, 16, true>, args);
  } else if (sizeof(T) == 4 && fits(32)) {
    std::apply(launch_cyclic_const_phi_m<T, sizeof(T) == 4 ? 32 : 16, true>,
               args);
  } else {
    std::apply(launch_cyclic_const_phi_m<T, 16, false>, args);
  }
}

template <typename T>
void launch_cyclic_const_table(const void* fac, void* tab, int64_t B1,
                               int64_t n, cudaStream_t stream) {
  const int threads = 128;
  cyclic_const_table_kernel<T>
      <<<(unsigned)atf::cdiv(B1, threads), threads, 0, stream>>>(
          static_cast<const T*>(fac), static_cast<T*>(tab), B1, n);
}

}  // namespace

ATF_API int atf_const_sweep_strided(int dtype, int device, const void* rhs,
                                    const void* a, const void* radd,
                                    const void* tab, void* out, int64_t n,
                                    int64_t B, void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF(launch_const_sweep_strided<T>(
                   rhs, a, radd, tab, out, n, B, device,
                   (cudaStream_t)stream)));
}

ATF_API int atf_const_sweep_z(int dtype, int device, const void* rhs,
                              const void* a, const void* radd,
                              const void* tab, void* out, int64_t npen,
                              int64_t n, void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF(launch_const_sweep_z<T>(
                   rhs, a, radd, tab, out, npen, n, device,
                   (cudaStream_t)stream)));
}

// K12's and K13's row table, 2n + 1 values.
ATF_API int atf_const_sweep_table(int dtype, int device, const void* a,
                                  const void* b, const void* c, void* tab,
                                  int64_t n, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_const_table<T>(a, b, c, tab, n,
                                     (cudaStream_t)stream));
}

ATF_API int atf_cyclic_const_phi(int dtype, int device, const void* rhs,
                                 const void* fac, const void* tab, void* out,
                                 int64_t B1, int64_t n, int64_t B2,
                                 void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_cyclic_const_phi<T>(rhs, fac, tab, out, B1, n, B2,
                                          device, (cudaStream_t)stream));
}

// K14's table, (B1, 3n + kK14Tail) values.
ATF_API int atf_cyclic_const_table(int dtype, int device, const void* fac,
                                   void* tab, int64_t B1, int64_t n,
                                   void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_cyclic_const_table<T>(fac, tab, B1, n,
                                            (cudaStream_t)stream));
}
