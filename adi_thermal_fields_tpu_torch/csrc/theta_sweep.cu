// K4: the explicit theta-pass stencil fused into the plan-lite x-sweep.
//
// Replaces adi_thermal_fields_tpu/solvers/pallas_theta_sweep.py
// fused_theta_sweep_axis0 (:454): the ring-buffer kernel _theta_sweep_ring
// (:551, body :249) and the halo-DMA kernel (body :54) compute the same
// function.
//   U = A_x^{-1} [ (I + c_exp L) T + dt*cf*t_inf ]
// with L the mask-aware Laplacian and A_x the plan-lite masked tridiagonal
// along x.  The neighbour masks come from the x-sweep code of
// sweep_code(stencil_bits=True): bits 1/2 = x-1/x+1 coupling, 8 = in-mask,
// 16/32 = y-1/y+1, 64/128 = z-1/z+1 -- no mask array is read.  The stencil
// terms accumulate x, then y, then z, as in K3, and each row's result is
// the right-hand side of its row: R0 never reaches device memory.
//
// What bounds it on the H100: memory, 9 B/cell (read T and the code, write
// U; 5 at bfloat16).  The first version marched one thread along each
// (y, z) pencil with a serial Thomas recurrence and sent c' and d' through
// two field-sized scratch tensors, 25 B/cell.  Design: K1's x sweep on the
// split-line core (csrc/split_line.cuh, csrc/sweeps.cu explains it): a
// warp's lanes are 32 lines adjacent in z, so every row load and store is
// coalesced; the block's W warps split the lines' rows into chunks of M;
// phase (a) forms each row's right-hand side from the stencil and
// eliminates inside the chunk, (b) solves the reduced system across the
// warps, (c) back-substitutes and writes U once.  c' and d' never leave the
// SM.  The stencil's neighbours:
//   x+-1: the chunk's own rows, plus one halo row each side (M + 2 rows of
//         T per chunk; the halo rows are other chunks' rows, from L1/L2);
//   z+-1: the neighbouring lanes, by warp shuffle; lanes 0 and 31 load
//         their outer neighbour (the next line groups') from memory.  Lane
//         b2 + 1 is z + 1 only inside a y row: at z = nz - 1 the bit is
//         clear and the shuffled value is dropped, never multiplied;
//   y+-1: loads at off -+ nz, lines of the blocks 16 groups away at 512^3,
//         in flight at the same time: L2 hits.
// A neighbour is read only where its bit is set, so no load leaves the
// field; lanes past the last line take part in the shuffles with zeros.
// Phase (b) runs each line's reduced system on one warp's shuffles, so the
// block meets at two barriers (K1 runs PCR across the warps in shared
// memory, a barrier a step).  Phase (c) forms again the rows of a
// thread's chunks but the last, from their right-hand sides kept in phase
// (a), one value per row, beside the reduced rows in shared memory:
// computing the stencil again instead, as K1 reloads its inputs, ran 1.26x
// slower at 512^3 (PERF.md §6).  Lines past shared memory (over 1,024 rows
// at float32, 512 at float64) keep both in a global buffer, taken and freed
// on the stream.
//
// Rounding: the split solve is not Thomas order and its float32
// reciprocals are approximate (csrc/sweeps.cu): a few float32 ulp of the
// output's scale from the plain version (chip_smoke.py KERNEL_TOL_ULP = 8).
// A bfloat16 T is read widened, the stencil and the solve run at float32,
// and U is stored to nearest or stochastically (common.cuh) at the cell's
// natural index.
#include "common.cuh"
#include "split_line.cuh"

namespace {

template <typename C>
struct Stencil {
  C c_exp, iv_x, iv_y, iv_z;
};

// One row's right-hand side, T + (c_exp*inm) * (Lx + Ly + Lz) T, from the
// row's code c, its T (tc) and its x neighbours (tlo, thi).  A neighbour
// counts where its bit is set: its T is taken by a select, not multiplied
// by the 0/1 bit, and the bits are counted by popc -- the same sums as
// the plain version's 0/1 multiplies.  z+-1 come from the neighbouring
// lanes: every lane of the warp must call this together.
template <typename S, typename C>
__device__ __forceinline__ C stencil_rhs(const S* __restrict__ Tf,
                                         unsigned c, C tlo, C tc, C thi,
                                         int64_t off, int64_t nz, int lane,
                                         const Stencil<C>& sc) {
  constexpr unsigned kAll = 0xffffffffu;
  const C xlo = (c & atf::kLow) ? tlo : C(0);
  const C xhi = (c & atf::kHigh) ? thi : C(0);
  C acc = (xlo + xhi - C(__popc(c & (atf::kLow | atf::kHigh))) * tc) *
          sc.iv_x;
  const C ylo = (c & atf::kNb1Lo) ? atf::ld(Tf + off - nz) : C(0);
  const C yhi = (c & atf::kNb1Hi) ? atf::ld(Tf + off + nz) : C(0);
  acc = acc + (ylo + yhi - C(__popc(c & (atf::kNb1Lo | atf::kNb1Hi))) * tc) *
                  sc.iv_y;
  C zlo = __shfl_up_sync(kAll, tc, 1);
  C zhi = __shfl_down_sync(kAll, tc, 1);
  if (lane == 0) zlo = (c & atf::kNb2Lo) ? atf::ld(Tf + off - 1) : C(0);
  if (lane == 31) zhi = (c & atf::kNb2Hi) ? atf::ld(Tf + off + 1) : C(0);
  zlo = (c & atf::kNb2Lo) ? zlo : C(0);
  zhi = (c & atf::kNb2Hi) ? zhi : C(0);
  acc = acc + (zlo + zhi - C(__popc(c & (atf::kNb2Lo | atf::kNb2Hi))) * tc) *
                  sc.iv_z;
  return tc + ((c & atf::kInMask) ? sc.c_exp : C(0)) * acc;
}

// K4's launch shape: W = 16 warps a block, M = 8 rows a thread (a 512-row
// line: R = 4 chunks a thread, three kept); at float32 and bfloat16 two
// blocks an SM (64 registers a thread), so that one block's loads overlap
// the other's reduced solve; float64 (~120 registers) one.  The fastest
// of W in {8, 16, 32}, with phase (b) across the block or on warp
// shuffles, at 256^3 and 512^3 on the H100 (PERF.md §6).
constexpr int kK4Warps = 16;
constexpr int kK4Rows = 8;
template <typename C>
constexpr int kK4Blocks = sizeof(C) == 4 ? 2 : 1;

// K1's strided layout on the x lines of the natural field: line b2 (a
// (y, z) pencil) at b2, rows B2 = ny*nz apart.  Memory: the reduced rows
// (A, Cc, D; 3 x 2WR rows of 32 lines) and the right-hand sides of each
// thread's first R - 1 chunks (`keep`, W (R-1) M rows of 32 lines) in
// shared memory, or (kGlobal, lines too long for it) in `gred`; then, in
// shared memory, phase (b)'s segment rows (3 x 2W x 33).
template <typename S, typename C, int M, bool kGlobal>
__global__ void __launch_bounds__(32 * kK4Warps, kK4Blocks<C>)
    theta_sweep_kernel(
    const S* __restrict__ Tf, const uint8_t* __restrict__ code,
    S* __restrict__ out, int64_t n, int64_t nz, int64_t B2, int R,
    Stencil<C> sc, RowParams<C> p, int64_t key, C* __restrict__ gred) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  __shared__ C tab[64];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int rows = 2 * W * R;                     // reduced rows per line
  const size_t block_vals = (size_t)32 * (3 * rows + W * (R - 1) * M);
  C* A = kGlobal ? gred + blockIdx.x * block_vals
                 : reinterpret_cast<C*>(atf_smem);
  C* Cc = A + rows * 32;
  C* D = Cc + rows * 32;
  C* S2 = kGlobal ? reinterpret_cast<C*>(atf_smem)
                  : D + rows * 32 + W * (R - 1) * M * 32;
  C* keep = D + rows * 32 + (size_t)w * (R - 1) * M * 32 + lane;

  const int64_t b2 = (int64_t)blockIdx.x * 32 + lane;
  const bool valid = b2 < B2;
  if (threadIdx.x < 16) {
    fill_row_table(tab, threadIdx.x, p, false, false);
  }
  __syncthreads();

  Chunk<C, M, false> ch;
  // phase (a): chunk j's rows from the stencil, their right-hand sides
  // kept in `slot` (the thread's last chunk, slot R - 1, stays in
  // registers)
  auto eliminate = [&](int j, int slot) {
    const int64_t row0 = (int64_t)j * M;
    uint32_t cw[(M + 3) / 4] = {};                // the M code bytes
    C t[M + 2];                                   // T at rows row0-1..row0+M
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = row0 + k;
      const bool in = valid && i < n;
      cw[k / 4] |= (in ? (uint32_t)code[i * B2 + b2] : 0u) << (8 * (k % 4));
      t[k + 1] = in ? atf::ld(Tf + i * B2 + b2) : C(0);
    }
    auto cd = [&](int k) { return (cw[k / 4] >> (8 * (k % 4))) & 0xffu; };
    // the x halo rows: a set bit implies the neighbour row exists
    t[0] = (cd(0) & atf::kLow) ? atf::ld(Tf + (row0 - 1) * B2 + b2) : C(0);
    t[M + 1] = (cd(M - 1) & atf::kHigh)
                   ? atf::ld(Tf + (row0 + M) * B2 + b2) : C(0);
    auto src = [&](int k, unsigned& c, C& r, C& cf, C& q, C& dv) {
      c = cd(k);
      cf = q = dv = C(0);
      r = stencil_rhs(Tf, c, t[k], t[k + 1], t[k + 2], (row0 + k) * B2 + b2,
                      nz, lane, sc);
      if (slot < R - 1) keep[(slot * M + k) * 32] = r;
    };
    ch.load(src, row0, n, false, false, false, p, tab);
  };
  // phase (c): chunk j's rows again from the kept right-hand sides
  auto reload = [&](int j, int slot) {
    const int64_t row0 = (int64_t)j * M;
    auto src = [&](int k, unsigned& c, C& r, C& cf, C& q, C& dv) {
      const int64_t i = row0 + k;
      c = (valid && i < n) ? code[i * B2 + b2] : 0u;
      r = keep[(slot * M + k) * 32];
      cf = q = dv = C(0);
    };
    ch.load(src, row0, n, false, false, false, p, tab);
  };
  auto store = [&](int j) {
    const C x0 = D[(2 * j) * 32 + lane];
    const C xl = D[(2 * j + 1) * 32 + lane];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = (int64_t)j * M + k;
      if (valid && i < n) {
        const int64_t off = i * B2 + b2;
        atf::st(out + off, ch.x(k, x0, xl), key, off);
      }
    }
  };

  for (int r = 0; r < R; ++r) {                  // (a)
    const int j = w * R + r;
    eliminate(j, r);
    ch.put_reduced(A, Cc, D, (2 * j) * 32 + lane, (2 * j + 1) * 32 + lane);
  }
  block_reduced_warps(A, Cc, D, S2, lane, w, W, R);   // (b)
  store(w * R + R - 1);                          // (c), last chunk first
  for (int r = 0; r < R - 1; ++r) {
    reload(w * R + r, r);
    store(w * R + r);
  }
}

// Values of the reduced rows and kept right-hand sides of one block.
template <typename C>
size_t k4_block_vals(int W, int R) {
  return (size_t)32 * (3 * 2 * W * R + W * (R - 1) * kK4Rows);
}

template <typename S, typename C, bool kGlobal>
cudaError_t launch_theta_m(const void* Tf, const void* code, void* out,
                           int64_t nx, int64_t B2, int64_t nz, int W, int R,
                           Stencil<C> sc, RowParams<C> p, int64_t key,
                           cudaStream_t stream) {
  const int64_t blocks = atf::cdiv(B2, 32);
  const size_t smem = sizeof(C) * ((size_t)33 * 3 * 2 * W +
                                   (kGlobal ? 0 : k4_block_vals<C>(W, R)));
  C* gred = nullptr;
  if (kGlobal) {
    const size_t bytes = sizeof(C) * (size_t)blocks * k4_block_vals<C>(W, R);
    const cudaError_t err =
        cudaMallocAsync(reinterpret_cast<void**>(&gred), bytes, stream);
    if (err != cudaSuccess) return err;
  }
  auto* kernel = theta_sweep_kernel<S, C, kK4Rows, kGlobal>;
  // the static row table counts against the same 48 KB default: opt in
  // whatever the size
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(
      static_cast<const S*>(Tf), static_cast<const uint8_t*>(code),
      static_cast<S*>(out), nx, nz, B2, R, sc, p, key, gred);
  if (kGlobal) {
    const cudaError_t launch_err = cudaGetLastError();
    const cudaError_t free_err = cudaFreeAsync(gred, stream);
    return launch_err != cudaSuccess ? launch_err : free_err;
  }
  return cudaSuccess;
}

template <typename S, typename C>
cudaError_t launch_theta_sweep(const void* Tf, const void* code, void* out,
                               int64_t nx, int64_t ny, int64_t nz,
                               Stencil<C> sc, RowParams<C> p, int64_t key,
                               int device, cudaStream_t stream) {
  const int W = (int)atf::imin(kK4Warps, atf::cdiv(nx, kK4Rows));
  const int R = (int)atf::cdiv(nx, (int64_t)W * kK4Rows);
  const int64_t B2 = ny * nz;
  const size_t smem = sizeof(C) * ((size_t)33 * 3 * 2 * W +
                                   k4_block_vals<C>(W, R));
  if (smem <= (size_t)smem_limit(device)) {
    return launch_theta_m<S, C, false>(Tf, code, out, nx, B2, nz, W, R, sc,
                                       p, key, stream);
  }
  return launch_theta_m<S, C, true>(Tf, code, out, nx, B2, nz, W, R, sc, p,
                                    key, stream);
}

}  // namespace

ATF_API int atf_theta_sweep(int dtype, int device, const void* Tf,
                            const void* code, void* out, int64_t nx,
                            int64_t ny, int64_t nz, double c_exp,
                            double iv_x, double iv_y, double iv_z,
                            double tg, double dt, double t_inf, double rob_c,
                            int64_t key, void* stream) {
  ATF_DISPATCH_STATE(dtype, device,
                     ATF_RETURN_IF((launch_theta_sweep<S, C>(
                         Tf, code, out, nx, ny, nz,
                         Stencil<C>{(C)c_exp, (C)iv_x, (C)iv_y, (C)iv_z},
                         RowParams<C>{(C)tg, (C)dt, (C)t_inf, (C)rob_c},
                         key, device, (cudaStream_t)stream))));
}
