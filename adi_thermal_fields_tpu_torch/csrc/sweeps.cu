// K1 and K2: the masked implicit ADI sweeps, each line split across threads.
//
// K1 replaces adi_thermal_fields_tpu/solvers/pallas_sweeps.py
//    fused_sweep_axis0_v2 (:686) and fused_sweep_axis1_v2 (:1363):
//    the masked tridiagonal solve along a STRIDED axis of a C-contiguous
//    field viewed as (B1, n, B2) -- x: (1, nx, ny*nz), y: (nx, ny, nz); and
//    (`zxy`) a (z, x, y) permuted field as (1, nz, nx*ny).
// K1's v1 entry ("K1v1", `pin_from_code`) replaces pallas_sweeps.py
//    fused_sweep_axis0 (:289) and fused_sweep_axis1 (:215), the
//    field-coefficient sweeps of the public fused_sweep (:2025).
// K2 replaces pallas_sweeps.py fused_sweep_axis2_v2 (:950): the solve along
//    the CONTIGUOUS z axis of the natural field.  It takes K1's inputs too
//    (coefficient field, Neumann flux, Dirichlet values), so the field plan
//    solves z in the natural layout with no permuted copy of the state.
//
// Row system (both kernels), from the per-cell code byte
// (bits 1/2 = coupling to i-1/i+1, 4 = Dirichlet pin, 8 = in-mask):
//   a = -tg*low, c = -tg*high, cf = coeff (field) or
//   rob_c*(2-low-high)*inmask (plan-lite), b = 1 + tg*(low+high) + dt*cf,
//   d = rhs + dt*cf*t_inf; pinned rows have b = 1.  The Neumann source
//   folds in as rhs += dt*qflux and the Dirichlet value as rhs = dir_val on
//   pinned rows with cf = 0 there (fused_sweep_axis0_v2 :714-720).  The v1
//   pin rule (kPinFromCode): a row with code bit 4 is ALWAYS an identity
//   row (b = 1, :116-121), while cf is zeroed and the rhs replaced only
//   when dir_val is given (:298-303).  K2 given plan-lite inputs alone
//   pins every bit-4 row too (b = 1, d = rhs + dt*cf*t_inf), as
//   fused_sweep_axis2_v2 (has_pin=True) does; with any field it follows
//   fused_sweep_axis0_v2.  Rows 0 and n-1 drop their outward
//   couplings (a_0 = c_{n-1} = 0), as the Thomas solve ignores them.
//
// What bounds them on the H100: memory.  The byte model reads each input
// once and writes x once: 9 B/cell plan-lite, 13 with the Neumann field,
// 21 with coefficient, Neumann and Dirichlet fields (5 and 11 at
// bfloat16).  A tridiagonal solve has no product for the tensor cores to
// take; they play no part.  The first versions ran one thread per line
// (a serial Thomas recurrence) and sent c' and d' through global scratch,
// ~25-29 B/cell, and at 256^3 the 65,536 lines of a y sweep filled a
// quarter of the card.
//
// The split-line solve (the partition or SPIKE method).  A line of n rows
// is cut into chunks of M rows, one chunk per thread:
//   (a) the thread loads its chunk's rows once, forms (a, b, c, d) in
//       registers (a, c and b from a 16-entry table of the code's low
//       bits) and eliminates inside the chunk (the "modified Thomas" of
//       Laszlo, Giles and Appleyard: a downward pass, then an upward one),
//       leaving every row as
//         a'_k x_first + x_k + c'_k x_last = d'_k    (0 < k < M-1)
//       and the chunk's first and last rows coupled only to the
//       neighbouring chunks' last and first unknowns;
//   (b) those two rows of every chunk form a reduced tridiagonal system of
//       2 x (chunks per line) rows with a unit diagonal, solved in parallel
//       (`pcr_reduced`, `warp_reduced`: cyclic reduction, log2 steps);
//   (c) each thread back-substitutes its chunk from registers and writes
//       x once.
// c' and d' never reach global memory.  The systems are strictly
// diagonally dominant (b >= 1 + |a| + |c|; pinned and void rows have
// a = c = 0), so neither level needs pivoting.  `Chunk` (phases a and c)
// and the reduced solves (phase b) are that core (csrc/split_line.cuh,
// shared with K4), templated on the compute type and the pin rule; every
// entry (float32, float64, bfloat16, K1v1) shares it.  A thread with
// more than one chunk (R rounds) keeps the last one in registers and
// reloads the others in (c).
//   K1: a warp spans 32 lines adjacent in B2 (lane = line: every row load
//       and store is a coalesced 128 B at float32); the block's W warps
//       split the lines' rows, warp w owning chunks [w R, (w+1) R).  In
//       (b) each thread first folds its R chunks' 2R rows to two
//       (`seg_eliminate`), so PCR runs over 2W rows per line across the
//       warps.  M = 8, W = 16 (64 registers at float32, no spills; two
//       blocks per SM); M = 16 where a line's reduced rows would not fit
//       in shared memory at 8, and for longer lines (over 4,096 rows at
//       float32, 1,792 at float64) the reduced rows go to a global buffer
//       of 6/M of the field's cells, taken and freed on the stream.
//   K2: a warp owns one line, its lanes the chunks (lane-strided rows).
//       The block stages its W lines of every input in shared memory with
//       cp.async (4- and 8-byte elements; bytes and bfloat16 by plain
//       loads), double-buffered across the groups of W lines a persistent
//       block walks, so the next group's copies fly while this one solves.
//       Each chunk of M rows is padded by one element (the code bytes by
//       four), so the lanes' strided reads hit distinct banks.  With one
//       chunk per lane (n <= 32 M) the reduced system never leaves
//       registers: one step of cyclic reduction, then PCR over warp
//       shuffles.  The solution goes back into the staged rhs and leaves in
//       coalesced rows.  M = 16 (8 for n <= 256), W = 2.  A line too long
//       to stage alone (~5,800 rows at float32 with every field, ~3,000 at
//       float64) goes to K1's kernel on the z layout (lanes = lines n
//       apart, rows contiguous), so no length is refused.
// On the H100 (PERF.md §6) one thread per line solving the
// reduced system serially in shared memory ran K2 1.3-1.6x slower than
// PCR and K1 within a few percent of it; the launch shapes above were the
// fastest of M in {8, 16} x W in {1..16}.  An earlier K2 variant that held
// whole lines' c' and d' in shared memory left one warp per SM and ran
// 1.5-4.3x slower than global scratch; here a line has 32 threads (K2) or
// W (K1), and shared memory holds inputs (K2) and reduced rows only.
//
// Rounding: the split solve is not Thomas order, and its float32
// reciprocals are the hardware's approximation (`rcp`, within one ulp), so
// a kernel no longer repeats its plain version to within 0.68 ulp; it
// stays within a few float32 ulp of the output's scale (2.7-3.9 on the
// H100; chip_smoke.py KERNEL_TOL_ULP = 8).
//
// Types: the field (rhs, coeff, qflux, dir_val, out) is stored as S and
// solved in C (common.cuh ATF_DISPATCH_STATE): float32 and float64 solve
// at their own type; a bfloat16 field is widened on load, solved at
// float32 and narrowed on the final store, to nearest or stochastically
// (`key`; the JAX kernels' rng_seed), at the cell's natural linear index.
#include "common.cuh"
#include "split_line.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: strided lines; lane = line, warps = chunks
// ---------------------------------------------------------------------------

// Memory: the reduced rows (A, Cc, D: 2WR rows of 32 lines) in shared
// memory, or (kGlobal, lines too long for it) in `gred`, 3 x 2WR x 32 per
// block; then, in shared memory, the warps' segment rows (2W rows) and
// their PCR scratch.
template <typename C>
size_t strided_smem_bytes(int W, int R, bool global) {
  return sizeof(C) * (size_t)32 * ((global ? 0 : 3 * 2 * W * R) + 6 * 2 * W);
}

// Line b2 of group b1 starts at b1*n*B2 + b2*ls and its rows lie rs apart:
// (ls, rs) = (1, B2) for the strided axes, (n, 1) for K2's long z lines.
template <typename S, typename C, int M, bool kPinFromCode, bool kGlobal>
__global__ void __launch_bounds__(512) sweep_strided_kernel(
    const S* __restrict__ rhs, const uint8_t* __restrict__ code,
    const S* __restrict__ coeff, const S* __restrict__ qflux,
    const S* __restrict__ dirv, S* __restrict__ out, int64_t n, int64_t B2,
    int64_t ls, int64_t rs, int R, RowParams<C> p, int64_t key, int zxy,
    int pin_code, C* __restrict__ gred) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  __shared__ C tab[64];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int rows = 2 * W * R;                     // reduced rows per line
  C* A = kGlobal ? gred + (size_t)blockIdx.x * 3 * rows * 32
                 : reinterpret_cast<C*>(atf_smem);
  C* Cc = A + rows * 32;
  C* D = Cc + rows * 32;
  C* S2 = kGlobal ? reinterpret_cast<C*>(atf_smem)
                  : D + rows * 32;                // segment rows, scratch

  const int64_t gpb = atf::cdiv(B2, 32);          // line groups per b1
  const int64_t b1 = blockIdx.x / gpb;
  const int64_t b2 = (blockIdx.x - b1 * gpb) * 32 + lane;
  const bool valid = b2 < B2;
  const int64_t base = b1 * n * B2 + b2 * ls;
  const bool has_coeff = coeff != nullptr, has_q = qflux != nullptr;
  const bool has_pin = dirv != nullptr;
  if (threadIdx.x < 16) {
    fill_row_table(tab, threadIdx.x, p, has_coeff, pin_code != 0);
  }
  __syncthreads();

  Chunk<C, M, kPinFromCode> ch;
  auto eliminate = [&](int j) {
    const int64_t row0 = (int64_t)j * M;
    auto src = [&](int k, unsigned& cd, C& r, C& cf, C& q, C& dv) {
      const int64_t i = row0 + k;
      const bool in = valid && i < n;
      const int64_t off = base + i * rs;
      cd = in ? code[off] : 0u;
      r = in ? atf::ld(rhs + off) : C(0);
      cf = (in && has_coeff) ? atf::ld(coeff + off) : C(0);
      q = (in && has_q) ? atf::ld(qflux + off) : C(0);
      dv = (in && has_pin) ? atf::ld(dirv + off) : C(0);
    };
    ch.load(src, row0, n, has_coeff, has_q, has_pin, p, tab);
  };
  auto store = [&](int j) {
    const C x0 = D[(2 * j) * 32 + lane];
    const C xl = D[(2 * j + 1) * 32 + lane];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = (int64_t)j * M + k;
      if (valid && i < n) {
        const int64_t off = base + i * rs;
        atf::st(out + off, ch.x(k, x0, xl), key,
                zxy ? (b1 * B2 + b2) * n + i : off);
      }
    }
  };

  for (int r = 0; r < R; ++r) {                  // (a)
    const int j = w * R + r;
    eliminate(j);
    ch.put_reduced(A, Cc, D, (2 * j) * 32 + lane, (2 * j + 1) * 32 + lane);
  }
  // (b): this thread's 2R reduced rows (its R consecutive chunks) reduce
  // to their first and last; those 2W rows per line go through PCR across
  // the warps; then the inner rows follow
  const int o0 = (2 * w * R) * 32 + lane, cnt = 2 * R;
  seg_eliminate(A, Cc, D, o0, 32, cnt);
  const int last = o0 + (cnt - 1) * 32;
  const int f = (2 * w) * 32 + lane, l = f + 32;
  C* A2 = S2;
  C* C2 = A2 + 2 * W * 32;
  C* D2 = C2 + 2 * W * 32;
  A2[f] = A[o0];
  C2[f] = Cc[o0];
  D2[f] = D[o0];
  A2[l] = A[last];
  C2[l] = Cc[last];
  D2[l] = D[last];
  __syncthreads();
  const C* X2 = pcr_reduced(A2, C2, D2, D2 + 2 * W * 32, D2 + 4 * W * 32,
                            D2 + 6 * W * 32, 2 * W, 32, lane, w, W,
                            [] { __syncthreads(); });
  seg_finish(A, Cc, D, o0, 32, cnt, X2[f], X2[l]);   // this thread's rows
  store(w * R + R - 1);                          // (c), last chunk first
  for (int r = 0; r < R - 1; ++r) {
    eliminate(w * R + r);
    store(w * R + r);
  }
}

// ---------------------------------------------------------------------------
// K2: contiguous lines; warp = line, lanes = chunks, inputs staged
// ---------------------------------------------------------------------------

template <typename S, typename C, int M>
__global__ void __launch_bounds__(256) sweep_z_kernel(
    const S* __restrict__ rhs, const uint8_t* __restrict__ code,
    const S* __restrict__ coeff, const S* __restrict__ qflux,
    const S* __restrict__ dirv, S* __restrict__ out, int64_t npen, int64_t n,
    int R, ZLayout L, int code_async, int pin_code, RowParams<C> p,
    int64_t key) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  __shared__ C tab[64];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = L.W;
  const int rows = 2 * 32 * R;
  const bool has_coeff = coeff != nullptr, has_q = qflux != nullptr;
  const bool has_pin = dirv != nullptr;
  const S* fsrc[3] = {coeff, qflux, dirv};
  int fslot[3];
  {
    int s = 0;
    for (int f = 0; f < 3; ++f) fslot[f] = fsrc[f] ? s++ : -1;
  }
  const int nf = (has_coeff ? 1 : 0) + (has_q ? 1 : 0) + (has_pin ? 1 : 0);
  unsigned char* red = atf_smem + 2 * L.buf_bytes;
  C* A = reinterpret_cast<C*>(red) + (size_t)w * 6 * rows;
  C* Cc = A + rows;
  C* D = Cc + rows;                              // then PCR's scratch

  auto X = [&](int buf) {
    return reinterpret_cast<C*>(atf_smem + buf * L.buf_bytes);
  };
  auto F = [&](int buf, int slot) {
    return reinterpret_cast<S*>(atf_smem + buf * L.buf_bytes + L.x_bytes +
                                slot * L.f_bytes);
  };
  auto CT = [&](int buf) {
    return reinterpret_cast<uint8_t*>(atf_smem + buf * L.buf_bytes +
                                      L.x_bytes + nf * L.f_bytes);
  };
  auto vidx = [](int64_t i) { return (int)(i / M * (M + 1) + i % M); };
  auto cidx = [](int64_t i) { return (int)(i / M * (M + 4) + i % M); };

  const int64_t G = atf::cdiv(npen, W);
  auto stage_group = [&](int64_t g, int buf) {
    C* x = X(buf);
    uint8_t* ct = CT(buf);
    for (int q = 0; q < W; ++q) {
      const int64_t pen = g * W + q;
      if (pen >= npen) break;
      const int64_t g0 = pen * n;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        const int s = q * L.pitch + vidx(i);
        stage<C, S>(x + s, rhs + g0 + i);
        for (int f = 0; f < 3; ++f) {
          if (fslot[f] >= 0) {
            stage<S, S>(F(buf, fslot[f]) + s, fsrc[f] + g0 + i);
          }
        }
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

  if (threadIdx.x < 16) {
    fill_row_table(tab, threadIdx.x, p, has_coeff, pin_code != 0);
  }
  int buf = 0;
  int64_t g = blockIdx.x;
  if (g < G) stage_group(g, 0);
  for (; g < G; g += gridDim.x, buf ^= 1) {
    if (g + gridDim.x < G) {
      stage_group(g + gridDim.x, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int64_t pen = g * W + w;
    if (pen < npen) {
      C* x = X(buf) + w * L.pitch;
      const uint8_t* ct = CT(buf) + w * L.cpitch;
      const S* fl[3];
      for (int f = 0; f < 3; ++f) {
        fl[f] = fslot[f] >= 0 ? F(buf, fslot[f]) + w * L.pitch : nullptr;
      }
      Chunk<C, M, false> ch;
      auto eliminate = [&](int j) {
        const int64_t row0 = (int64_t)j * M;
        auto src = [&](int k, unsigned& cd, C& r, C& cf, C& q, C& dv) {
          const bool in = row0 + k < n;
          const int s = j * (M + 1) + k;
          cd = in ? ct[j * (M + 4) + k] : 0u;
          r = in ? x[s] : C(0);
          cf = (in && has_coeff) ? atf::ld(fl[0] + s) : C(0);
          q = (in && has_q) ? atf::ld(fl[1] + s) : C(0);
          dv = (in && has_pin) ? atf::ld(fl[2] + s) : C(0);
        };
        ch.load(src, row0, n, has_coeff, has_q, has_pin, p, tab);
      };
      auto put_x = [&](int j, C x0, C xl) {
#pragma unroll
        for (int k = 0; k < M; ++k) {
          if ((int64_t)j * M + k < n) x[j * (M + 1) + k] = ch.x(k, x0, xl);
        }
      };
      if (R == 1) {                              // a line of 32 chunks
        eliminate(lane);                         // (a)
        C x0, xl;                                // (b) in registers
        warp_reduced(ch.a[0], ch.c[0], ch.d[0], ch.a[M - 1], ch.c[M - 1],
                     ch.d[M - 1], lane, x0, xl);
        put_x(lane, x0, xl);                     // (c), into the rhs tile
      } else {
        for (int r = 0; r < R; ++r) {            // (a): lanes = chunks
          const int j = r * 32 + lane;
          eliminate(j);
          ch.put_reduced(A, Cc, D, 2 * j, 2 * j + 1);
        }
        __syncwarp();                            // (b), the warp
        const C* X = pcr_reduced(A, Cc, D, D + rows, D + 2 * rows,
                                 D + 3 * rows, rows, 1, 0, lane, 32,
                                 [] { __syncwarp(); });
        __syncwarp();
        auto put = [&](int j) { put_x(j, X[2 * j], X[2 * j + 1]); };
        put((R - 1) * 32 + lane);                // (c), into the rhs tile
        for (int r = 0; r < R - 1; ++r) {
          eliminate(r * 32 + lane);
          put(r * 32 + lane);
        }
      }
    }
    __syncthreads();
    // coalesced stores of the group's solution
    for (int q = 0; q < W; ++q) {
      const int64_t pq = g * W + q;
      if (pq >= npen) break;
      const C* x = X(buf) + q * L.pitch;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        atf::st(out + pq * n + i, x[vidx(i)], key, pq * n + i);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// K1's launch shape: W warps per block, M rows per thread.  M = 8 where a
// line's reduced rows fit in shared memory, else 16, and past that the
// reduced rows go to global memory (lines over 4,096 rows at float32, 1,792
// at float64).  The fastest of M in {8, 16} x W in {1..16} at 256^3 and
// 512^3 on the H100 (PERF.md §6).
constexpr int kK1Warps = 16;

int k1_warps(int64_t n, int M) {
  return (int)atf::imin(kK1Warps, atf::cdiv(n, M));
}

template <typename C>
bool k1_fits(int64_t n, int M, int device) {
  const int W = k1_warps(n, M);
  return strided_smem_bytes<C>(W, (int)atf::cdiv(n, (int64_t)W * M), false)
         <= (size_t)smem_limit(device);
}

template <typename S, typename C, int M, bool kPin, bool kGlobal>
cudaError_t launch_strided_m(const void* rhs, const void* code,
                             const void* coeff, const void* qflux,
                             const void* dirv, void* out, int64_t B1,
                             int64_t n, int64_t B2, int64_t ls, int64_t rs,
                             RowParams<C> p, int64_t key, int zxy,
                             int pin_code, cudaStream_t stream) {
  const int W = k1_warps(n, M);
  const int R = (int)atf::cdiv(n, (int64_t)W * M);
  const size_t smem = strided_smem_bytes<C>(W, R, kGlobal);
  const int64_t blocks = B1 * atf::cdiv(B2, 32);
  C* gred = nullptr;
  if (kGlobal) {
    const size_t bytes = sizeof(C) * (size_t)blocks * 3 * 2 * W * R * 32;
    const cudaError_t err =
        cudaMallocAsync(reinterpret_cast<void**>(&gred), bytes, stream);
    if (err != cudaSuccess) return err;
  }
  auto* kernel = sweep_strided_kernel<S, C, M, kPin, kGlobal>;
  // the static row table counts against the same 48 KB default: opt in
  // whatever the size
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(
      static_cast<const S*>(rhs), static_cast<const uint8_t*>(code),
      static_cast<const S*>(coeff), static_cast<const S*>(qflux),
      static_cast<const S*>(dirv), static_cast<S*>(out), n, B2, ls, rs, R, p,
      key, zxy, pin_code, gred);
  if (kGlobal) {
    const cudaError_t launch_err = cudaGetLastError();
    const cudaError_t free_err = cudaFreeAsync(gred, stream);
    return launch_err != cudaSuccess ? launch_err : free_err;
  }
  return cudaSuccess;
}

template <typename S, typename C>
cudaError_t launch_sweep_strided(const void* rhs, const void* code,
                                 const void* coeff, const void* qflux,
                                 const void* dirv, void* out, int64_t B1,
                                 int64_t n, int64_t B2, int64_t ls,
                                 int64_t rs, RowParams<C> p, int64_t key,
                                 int zxy, int pin_from_code, int pin_code,
                                 int device, cudaStream_t stream) {
#define ATF_K1(MM, GLOBAL)                                                   \
  return pin_from_code                                                       \
             ? launch_strided_m<S, C, MM, true, GLOBAL>(                     \
                   rhs, code, coeff, qflux, dirv, out, B1, n, B2, ls, rs, p,  \
                   key, zxy, pin_code, stream)                               \
             : launch_strided_m<S, C, MM, false, GLOBAL>(                    \
                   rhs, code, coeff, qflux, dirv, out, B1, n, B2, ls, rs, p,  \
                   key, zxy, pin_code, stream)
  if (k1_fits<C>(n, 8, device)) ATF_K1(8, false);
  if (k1_fits<C>(n, 16, device)) ATF_K1(16, false);
  ATF_K1(16, true);
#undef ATF_K1
}

// K2's launch shape: two lines per block (one where a staged group would
// pass 100 KB), M = 16 rows per lane, or 8 for lines of up to 256 rows;
// tuned on the H100 as K1's.  A line too long to stage even alone (~5,800
// rows at float32 with every field, ~3,000 at float64) is solved by K1's
// kernel on the z layout (lines n apart, rows contiguous).
constexpr int kK2Lines = 2;

template <typename S, typename C, int M>
cudaError_t launch_z_m(const void* rhs, const void* code, const void* coeff,
                       const void* qflux, const void* dirv, void* out,
                       int64_t npen, int64_t n, RowParams<C> p, int64_t key,
                       int pin_code, int device, cudaStream_t stream) {
  const int nf = (coeff ? 1 : 0) + (qflux ? 1 : 0) + (dirv ? 1 : 0);
  const int R = (int)atf::cdiv(n, 32 * M);
  auto bytes = [&](int W) {
    return 2 * z_layout<S, C, M>(W, n, nf).buf_bytes +
           z_reduced_bytes<C>(W, R);
  };
  if (bytes(1) > (size_t)smem_limit(device)) {
    return launch_sweep_strided<S, C>(rhs, code, coeff, qflux, dirv, out, 1,
                                      n, npen, n, 1, p, key, 0, 0, pin_code,
                                      device, stream);
  }
  int W = kK2Lines;
  while (W > 1 && bytes(W) > 100 * 1024) W /= 2;
  const size_t smem = bytes(W);
  const ZLayout L = z_layout<S, C, M>(W, n, nf);
  auto* kernel = sweep_z_kernel<S, C, M>;
  // the static row table counts against the same 48 KB default: opt in
  // whatever the size
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * W,
                                                smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t groups = atf::cdiv(npen, W);
  const int64_t blocks = atf::imin(groups, (int64_t)(per_sm > 0 ? per_sm : 1)
                                               * (sms > 0 ? sms : 1));
  const int code_async =
      (n % 4 == 0) && (reinterpret_cast<uintptr_t>(code) % 4 == 0);
  kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(
      static_cast<const S*>(rhs), static_cast<const uint8_t*>(code),
      static_cast<const S*>(coeff), static_cast<const S*>(qflux),
      static_cast<const S*>(dirv), static_cast<S*>(out), npen, n, R, L,
      code_async, pin_code, p, key);
  return cudaSuccess;
}

template <typename S, typename C>
cudaError_t launch_sweep_z(const void* rhs, const void* code,
                           const void* coeff, const void* qflux,
                           const void* dirv, void* out, int64_t npen,
                           int64_t n, RowParams<C> p, int64_t key,
                           int device, cudaStream_t stream) {
  // plan-lite inputs alone: fused_sweep_axis2_v2's pin rule
  const int pin_code = !coeff && !qflux && !dirv;
  if (n > 8 * 32) {
    return launch_z_m<S, C, 16>(rhs, code, coeff, qflux, dirv, out, npen, n,
                                p, key, pin_code, device, stream);
  }
  return launch_z_m<S, C, 8>(rhs, code, coeff, qflux, dirv, out, npen, n, p,
                             key, pin_code, device, stream);
}

}  // namespace

ATF_API int atf_sweep_strided(int dtype, int device, const void* rhs,
                              const void* code, const void* coeff,
                              const void* qflux, const void* dirv, void* out,
                              int64_t B1, int64_t n, int64_t B2, double tg,
                              double dt, double t_inf, double rob_c,
                              int64_t key, int zxy, int pin_from_code,
                              void* stream) {
  ATF_DISPATCH_STATE(
      dtype, device,
      ATF_RETURN_IF((launch_sweep_strided<S, C>(
          rhs, code, coeff, qflux, dirv, out, B1, n, B2, 1, B2,
          RowParams<C>{(C)tg, (C)dt, (C)t_inf, (C)rob_c}, key, zxy,
          pin_from_code, 0, device, (cudaStream_t)stream))));
}

ATF_API int atf_sweep_z(int dtype, int device, const void* rhs,
                        const void* code, const void* coeff,
                        const void* qflux, const void* dirv, void* out,
                        int64_t npen, int64_t n, double tg, double dt,
                        double t_inf, double rob_c, int64_t key,
                        void* stream) {
  ATF_DISPATCH_STATE(dtype, device,
                     ATF_RETURN_IF((launch_sweep_z<S, C>(
                         rhs, code, coeff, qflux, dirv, out, npen, n,
                         RowParams<C>{(C)tg, (C)dt, (C)t_inf, (C)rob_c}, key,
                         device, (cudaStream_t)stream))));
}

ATF_API const char* atf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
