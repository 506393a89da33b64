// K9, K10 and K11: the masked-Robin sweeps of the cylindrical step.
//
// K9 replaces adi_thermal_fields_tpu/solvers/pallas_fields.py
//    fused_masked_sweep (:655) in its solve-leading forms (the pipelined
//    body _masked_sweep_pipe_kernel :520, call site :744, and the streaming
//    body _masked_sweep_kernel :373, which compute the same thing): the
//    solve along axis 0 of a C-contiguous (n, B) field -- r of the natural
//    (r, phi, z) field, B = nphi*nz.
// K10 replaces fused_masked_sweep with nat_rhs_out=True (call site :802,
//    body :373 with the in-kernel relayout :447-451, :507-513): the same
//    rows along the CONTIGUOUS last axis of the natural field (z).  Unlike
//    the JAX z sweep, K10 also reads code, sink and srhs in the natural
//    layout, so the cylindrical step transposes nothing.
// K11 replaces fused_masked_cyclic_axis1 (:977, call site :1005, body
//    _masked_cyclic_axis1_kernel :820): the mask-broken PERIODIC solve
//    along axis 1 of a (B1, n, B2) field -- phi of the natural field.
//
// Row i of every sweep, from the code byte (bits 1/2 = coupling to i-1/i+1,
// 4 = pinned row, 8 = in-mask), the per-cell Robin sink and srhs (sink*T_inf
// on live rows, the pin value on pinned rows) and the per-row geometry
// glo/ghi (K11: one geo per line, glo = ghi = geo):
//   a = -fac*glo*low, c = -fac*ghi*high, b = 1 + fac*(glo*low + ghi*high
//   + sink), d = pin ? srhs : (inmask ? rhs + fac*srhs : ambient)
// (the in-kernel prefold; void and pinned rows are identity rows; K11 forms
// b as 1 - (a + c) + fac*sink, its plain version's order).  K11's wrap
// couplings (row 0's a, row n-1's c) come out by Sherman-Morrison in the
// gauge of cyclic_thomas (gamma = -b_0, beta = a_0, alpha = c_{n-1}).
//
// Rounding: K9's march repeats its plain version's operations (the row
// formulas of solvers/masked.py, then thomas: divisions, not reciprocal
// multiplies) one IEEE rounding at a time, with the _rn intrinsics, which
// nvcc never contracts into an FMA: bit for bit.  K9's longer lines, K10
// and K11 form their
// rows so too, but solve them split across threads (below), which parts
// from the Thomas order by about the condition number times a rounding.
// K11: up to 6 float32 ulp of the output's scale on rings whose rows stay
// below a stiffness ratio of 12, more on stiffer ones (~140 ulp on a full
// disk's second ring, fac*geo ~ 520 at 0.5 mm cells); a block of lines
// with a row past its stiffness ratio (kK11Stiff) is solved in Thomas
// order instead, bit for bit its plain version.  K10: kK10Stiff below.
//
// What bounds them on the H100: memory.  The byte model (float32) reads
// rhs 4 + code 1 + sink 4 + srhs 4 and writes x 4 = 17 B/cell per sweep.
//   K9:  one thread per (phi, z) pencil on lines of up to kK9MarchRows
//        rows (the r lines of every cylindrical configuration in the repo
//        are 64 rows or fewer): adjacent threads take adjacent lines, so
//        every row load is coalesced; kK9MarchGroup rows' loads go out
//        together; c' stays in shared memory and d' in registers (the rows
//        unrolled to a compile-time maximum), so the field is read once
//        and x written once: 17 B/cell.  glo[i]/ghi[i] are the same for
//        every thread of a row (broadcast loads through the read-only
//        cache).  Longer lines: the core's strided split kernel on
//        `MaskedRows` (K10's long lines' path), float32 blocks past
//        kK10Stiff replayed in Thomas order.
//   K10: the staged split-line kernel of csrc/split_staged.cuh (K19's
//        layout): a warp a line, its lanes the line's chunks (32 rows a
//        lane on the tube's 1,024-row lines, one chunk a lane, the
//        reduced rows in registers; several lines a warp below 16
//        chunks), the persistent block's lines, their sink and srhs and
//        their code bytes staged by cp.async one group of lines at a
//        time, glo and ghi once a block; `MaskedRows` forms the rows from
//        the tiles.  Nothing of the solve leaves the SM but x: 17 B/cell
//        (+1 flag byte a line at float32; float32 lines past kK10Stiff
//        replay in Thomas order, a lane a line, rows from global memory).
//        What holds it near half of its byte model on the tube: latency
//        -- a 32-row chunk a lane (255 registers) at 8 warps an SM.  The
//        first K10 ran one warp a block, a lane a line's serial
//        recurrence, staging [32 lines x 32 rows] tiles with plain loads
//        and sending c' and d' through global scratch (~33 B/cell, 10-12
//        warps an SM waiting on two divisions a row).  Lines too long to
//        stage (past ~5,000 rows) go to the core's strided kernel.
//   K11: the periodic split-line kernel of csrc/split_cyclic.cuh on K7's
//        layout: a warp's lanes are 32 phi lines adjacent in z (every row
//        load and store coalesced), the block's 32 warps split each line's
//        8-row chunks; `MaskedCyclicRows` forms the rows in registers,
//        Sherman-Morrison's second right-hand side enters only the reduced
//        system, and nothing of the solve leaves the SM but x: 17 B/cell
//        (the first K11 marched one thread a pencil with c', y and z in
//        global memory, ~48 B/cell more, 65,536 threads at (64, 512,
//        1024)).  Stiff blocks replay the Thomas order with the rows formed
//        again, about five split blocks' time each (PERF.md section 6).
//        What holds the split solve at a quarter of its byte model:
//        latency -- the rounded divisions (three a row; the hardware
//        reciprocal parted K16 from its plain version by 1.3e-3 K on the
//        tube, past its gate) and 64 registers a thread at 32 warps.
#include "field_rows.cuh"

namespace {

using atf::add;
using atf::div;
using atf::mul;
using atf::sub;

// d of a row: the pin value, the live rhs + fac*srhs, or the ambient
template <typename T>
__device__ __forceinline__ T prefold(unsigned code, T rhs, T srhs, T fac,
                                     T ambient) {
  if (code & atf::kPin) return srhs;
  return (code & atf::kInMask) ? add(rhs, mul(fac, srhs)) : ambient;
}

// the masked-Robin row of K9/K10 (masked_sweep_*_plain): a, b, c, d
template <typename T>
__device__ __forceinline__ void masked_row(unsigned code, T glo, T ghi,
                                           T sink, T rhs, T srhs, T fac,
                                           T ambient, T& a, T& b, T& c,
                                           T& d) {
  const T al = mul(glo, atf::bit<T>(code, atf::kLow));
  const T ch = mul(ghi, atf::bit<T>(code, atf::kHigh));
  a = mul(-fac, al);
  c = mul(-fac, ch);
  b = add(T(1), mul(fac, add(add(al, ch), sink)));
  d = prefold(code, rhs, srhs, fac, ambient);
}

// one Thomas elimination step: c' and d' from the previous row's
template <typename T>
__device__ __forceinline__ void eliminate(T a, T b, T c, T d, T& cp,
                                          T& dp) {
  const T denom = sub(b, mul(a, cp));
  cp = div(c, denom);
  dp = div(sub(d, mul(a, dp)), denom);
}

// K10's stiffness ratio (csrc/field_rows.cuh): at float32 a line with a
// row past |a| + |c| > kK10Stiff * (b - |a| - |c|) is solved again in
// Thomas order, bit for bit masked_sweep_z_plain.  16: every line split,
// over five seeds and dt x1-10 on chip_smoke.py phase 6's tube, disk and
// the spiral app's ring (scripts/open_tune.py, PERF.md section 6), lines
// below 16 stayed within 6.2 float32 ulp of scale of the plain version
// (the gate is 8), lines of 16-24 reached 8.4, of 48-64 27.6.  The masked
// step's tube sits near 2.3 at its dt, the app's ring near 9 at the same
// dt (23 at the app's own 0.05 s: replayed).  At float64 nothing replays.
constexpr double kK10Stiff = 16.0;

// K10's rows for the staged split-line kernel (csrc/split_staged.cuh) and,
// on lines too long to stage, the strided one: exactly masked_row and
// prefold, one rounding each, so the rows of masked_sweep_z_plain bit for
// bit; rhs staged into the solution's tile, sink and srhs beside it, the
// code bytes in their own tile, glo and ghi once a block.
template <typename T>
struct MaskedRows {
  static constexpr int kStreams = 2;             // sink, srhs
  static constexpr int kCols = 2;                // glo, ghi
  static constexpr bool kCode = true;
  // one staged group of lines at a time (csrc/split_staged.cuh): 39 KB a
  // block on the tube instead of 67, so 4 blocks an SM at 255 registers
  // instead of 3; the tube 0.353 against 0.576-0.599 ms, 0.30 against 0.54
  // in the masked step (PERF.md section 6)
  static constexpr int kBuffers = 1;
  static constexpr bool kReplay = std::is_same_v<T, float>;
  static constexpr double kStiff = kK10Stiff;
  static size_t replay_bytes(int64_t n) { return open_replay_bytes<T>(n); }
  const T* rhs;
  const uint8_t* code;
  const T* sink;
  const T* srhs;
  const T* glo;
  const T* ghi;
  T fac, ambient;

  __device__ __forceinline__ const T* stream(int t) const {
    return t == 0 ? sink : srhs;
  }
  __device__ __forceinline__ const T* col(int t) const {
    return t == 0 ? glo : ghi;
  }

  // row i of the line, at offset off
  __device__ __forceinline__ void row(int64_t off, int64_t i, T& a, T& b,
                                      T& c, T& d) const {
    masked_row<T>(__ldg(code + off), __ldg(glo + i), __ldg(ghi + i),
                  __ldg(sink + off), __ldg(rhs + off), __ldg(srhs + off),
                  fac, ambient, a, b, c, d);
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
          row(base + i * rs, i, a, b, c, d);
        },
        row0, n, stiff_check<kReplay, MaskedRows>(stiff));
  }

  // thomas's operations, eliminate's order: two rounded divisions a row
  __device__ __forceinline__ void replay(T* out, int64_t base, int64_t rs,
                                         int64_t n, bool valid,
                                         T* sm) const {
    open_replay(
        [&](int64_t i, T& a, T& b, T& c, T& d) {
          row(base + i * rs, i, a, b, c, d);
        },
        out, base, rs, n, valid, sm);
  }

  template <int M>
  __device__ __forceinline__ void load_staged(Chunk<T, M, false>& ch,
                                              const T* x, const T* f, int fs,
                                              const T* cols, int cs,
                                              const uint8_t* ct, int j,
                                              int64_t nv, bool& stiff) const {
    const int64_t row0 = (int64_t)j * M;
    const int s0 = j * (M + 1);
    const int c0 = j * (M + 4);
    ch.load_rows(
        [&](int k, T& a, T& b, T& c, T& d) {
          if (row0 + k >= nv) {
            a = c = d = T(0);
            b = T(1);
            return;
          }
          const int s = s0 + k;
          masked_row<T>(ct[c0 + k], cols[s], cols[cs + s], f[s], x[s],
                        f[fs + s], fac, ambient, a, b, c, d);
        },
        row0, nv, stiff_check<kReplay, MaskedRows>(stiff));
  }
};

// K11's stiffness ratio (csrc/split_cyclic.cuh): a block of lines with a
// row past |a| + |c| > kK11Stiff * (b - |a| - |c|) is solved in Thomas
// order, bit for bit masked_cyclic_phi_plain.  12: every block split, over
// five seeds and two time steps (scripts/cyclic_tune.py, PERF.md section
// 6), blocks below 12 stayed within 6.0 float32 ulp of scale of the plain
// version (the gate is 8: a quarter spare), blocks of 12-16 reached 8.1.
constexpr double kK11Stiff = 12.0;

// K11's rows for the periodic split solve (csrc/split_cyclic.cuh): the
// rows of masked_cyclic_phi_plain one rounding at a time, geo one value a
// line ((B1, B2), b1 * B2 + b2).
template <typename T>
struct MaskedCyclicRows {
  static constexpr double kStiff = kK11Stiff;
  const T* rhs;
  const uint8_t* code;
  const T* sink;
  const T* srhs;
  const T* geo;
  T fac, ambient;

  template <int M, typename F>
  __device__ __forceinline__ void each(const CycLine& L, int64_t row0,
                                       F&& f) const {
    const T fg = mul(-fac, __ldg(geo + L.b1 * L.rs + L.b2));
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = row0 + k;
      if (i < L.n) {
        const int64_t off = L.at(i);
        const unsigned cd = __ldg(code + off);
        const T a = (cd & atf::kLow) ? fg : T(0);
        const T c = (cd & atf::kHigh) ? fg : T(0);
        const T b = add(sub(T(1), add(a, c)), mul(fac, __ldg(sink + off)));
        f(k, a, b, c,
          prefold(cd, __ldg(rhs + off), __ldg(srhs + off), fac, ambient));
      }
    }
  }
};

// K9's march (lines of up to kK9MarchRows rows, a thread a line): the
// rows unrolled to NR, a compile-time maximum (8, 16, 32, 64 or 128 rows),
// d' in NR registers, c' in shared memory (blockDim.x * n values a block),
// kK9MarchThreads threads a block, registers held to kK9MarchBlocks
// blocks an SM at float32 (125 registers at 64 rows; kK9MarchBlocks64 at
// float64, 214).  kK9MarchRows: where the march and the split kernel cross
// on the H100 (PERF.md section 6; scripts/cyl_be_tune.py --crossover,
// n-row r lines of tubes of phase 6's kind, ~2^25 cells): the march 0.366
// and 0.371 ms at 37 and 64 rows against the split kernel's 0.523 and
// 0.441, then 1.07-1.17 against 0.43-0.52 from 72 to 128 rows (its 128
// registers of d' leave one block an SM).  On the tube, 128 threads and
// four blocks an SM, or an L2 prefetch of the rows a group ahead, took
// the same time within the noise (0.36-0.37 ms).
constexpr int kK9MarchRows = 64;
constexpr int kK9MarchThreads = 256;
constexpr int kK9MarchGroup = 4;
constexpr int kK9MarchBlocks = 2;
constexpr int kK9MarchBlocks64 = 1;
static_assert(kK9MarchRows <= 128, "d' of a line in at most 128 registers");

// At float64 the march takes lines of up to 64 rows (128 doubles of d'
// would not fit in a thread's 255 registers).  kBlocks: the blocks an SM
// the registers of a march of NR rows are held to (one past 64 rows).
template <typename T, int NR = 0>
struct K9March {
  static constexpr int kRows =
      sizeof(T) == 4 || kK9MarchRows < 64 ? kK9MarchRows : 64;
  static constexpr int kBlocks = NR > 64         ? 1
                                 : sizeof(T) == 4 ? kK9MarchBlocks
                                                  : kK9MarchBlocks64;
};

// B lines of n <= NR rows B apart (masked_row's rows, thomas's order:
// eliminate), a thread a line.  The forward pass takes kK9MarchGroup rows
// at a time, and loads the next group's inputs (the code, sink, rhs and
// srhs) before it eliminates this group's rows, so that the memory's
// latency is met once a group and hidden behind the divisions; the
// backward pass reads c' from shared memory and d' from registers and
// writes x: nothing of the solve but x goes to global memory.
template <typename T, int NR>
__global__ void __launch_bounds__(kK9MarchThreads, K9March<T, NR>::kBlocks)
    masked_march_kernel(const __grid_constant__ MaskedRows<T> rows,
                        T* __restrict__ out, int64_t n, int64_t B) {
  constexpr int G = kK9MarchGroup;
  static_assert(NR % G == 0, "whole groups of rows");
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* cps = reinterpret_cast<T*>(atf_smem) + threadIdx.x;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  unsigned cd[2][G];
  T sk[2][G], r[2][G], sr[2][G];
  auto load = [&](int i0, int s) {               // a group's inputs
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int64_t off = (int64_t)(i0 + k) * B + p;
      if (i0 + k < n) {
        cd[s][k] = __ldg(rows.code + off);
        sk[s][k] = __ldg(rows.sink + off);
        r[s][k] = __ldg(rows.rhs + off);
        sr[s][k] = __ldg(rows.srhs + off);
      }
    }
  };
  T cp = T(0), dp = T(0), dps[NR];
  load(0, 0);
#pragma unroll
  for (int i0 = 0; i0 < NR; i0 += G) {
    if (i0 < n) {
      const int s = (i0 / G) & 1;
      if (i0 + G < NR) load(i0 + G, s ^ 1);     // the next group's loads
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int i = i0 + k;
        if (i < n) {
          T a, b, c, d;
          masked_row<T>(cd[s][k], __ldg(rows.glo + i), __ldg(rows.ghi + i),
                        sk[s][k], r[s][k], sr[s][k], rows.fac,
                        rows.ambient, a, b, c, d);
          eliminate(a, b, c, d, cp, dp);
          cps[i * blockDim.x] = cp;
          dps[i] = dp;
        }
      }
    }
  }
  T x = T(0);
#pragma unroll
  for (int i = NR - 1; i >= 0; --i) {
    if (i < n) {
      x = sub(dps[i], mul(cps[i * blockDim.x], x));
      out[(int64_t)i * B + p] = x;
    }
  }
}

template <typename T, int NR>
cudaError_t launch_masked_march(const MaskedRows<T>& rows, T* out, int64_t n,
                                int64_t B, cudaStream_t stream) {
  const int threads = kK9MarchThreads;
  const size_t smem = sizeof(T) * threads * (size_t)n;
  auto* kernel = masked_march_kernel<T, NR>;
  atf::allow_dynamic_smem(kernel, smem);
  kernel<<<(unsigned)atf::cdiv(B, threads), threads, smem, stream>>>(
      rows, out, n, B);
  return cudaSuccess;
}

// K9: the (n, B) field's lines along axis 0, the march up to
// K9March<T>::kRows rows, the strided split kernel past it.
template <typename T>
cudaError_t launch_masked_sweep_strided(const MaskedRows<T>& rows, T* out,
                                        int64_t n, int64_t B, int device,
                                        cudaStream_t stream) {
  if (n <= K9March<T>::kRows) {
    if (n <= 8) return launch_masked_march<T, 8>(rows, out, n, B, stream);
    if (n <= 16) return launch_masked_march<T, 16>(rows, out, n, B, stream);
    if (n <= 32) return launch_masked_march<T, 32>(rows, out, n, B, stream);
    if (n <= 64) return launch_masked_march<T, 64>(rows, out, n, B, stream);
    if constexpr (K9March<T>::kRows > 64) {
      return launch_masked_march<T, 128>(rows, out, n, B, stream);
    }
  }
  // lines 1 apart, rows B apart
  return launch_split_strided<T>(rows, out, 1, n, B, 1, B, device, stream);
}

}  // namespace

ATF_API int atf_masked_sweep_strided(int dtype, int device, const void* rhs,
                                     const void* code, const void* sink,
                                     const void* srhs, const void* glo,
                                     const void* ghi, void* out, int64_t n,
                                     int64_t B, double fac, double ambient,
                                     void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_masked_sweep_strided<T>(
                   MaskedRows<T>{static_cast<const T*>(rhs),
                                 static_cast<const uint8_t*>(code),
                                 static_cast<const T*>(sink),
                                 static_cast<const T*>(srhs),
                                 static_cast<const T*>(glo),
                                 static_cast<const T*>(ghi), (T)fac,
                                 (T)ambient},
                   static_cast<T*>(out), n, B, device,
                   (cudaStream_t)stream))));
}

ATF_API int atf_masked_sweep_z(int dtype, int device, const void* rhs,
                               const void* code, const void* sink,
                               const void* srhs, const void* glo,
                               const void* ghi, void* out, void* flags,
                               int64_t npen, int64_t n, double fac,
                               double ambient, void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_split_staged<T, MaskedRows<T>>(
                   MaskedRows<T>{static_cast<const T*>(rhs),
                                 static_cast<const uint8_t*>(code),
                                 static_cast<const T*>(sink),
                                 static_cast<const T*>(srhs),
                                 static_cast<const T*>(glo),
                                 static_cast<const T*>(ghi), (T)fac,
                                 (T)ambient},
                   static_cast<T*>(out), static_cast<uint8_t*>(flags), npen,
                   n, device, (cudaStream_t)stream))));
}

ATF_API int atf_masked_cyclic_phi(int dtype, int device, const void* rhs,
                                  const void* code, const void* sink,
                                  const void* srhs, const void* geo,
                                  void* out, int64_t B1, int64_t n,
                                  int64_t B2, double fac, double ambient,
                                  void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_split_cyclic<T>(
                   MaskedCyclicRows<T>{static_cast<const T*>(rhs),
                                       static_cast<const uint8_t*>(code),
                                       static_cast<const T*>(sink),
                                       static_cast<const T*>(srhs),
                                       static_cast<const T*>(geo), (T)fac,
                                       (T)ambient},
                   static_cast<T*>(out), B1, n, B2, device,
                   (cudaStream_t)stream))));
}
