// K1 and K2: the masked implicit ADI sweeps.
//
// K1 replaces adi_thermal_fields_tpu/solvers/pallas_sweeps.py
//    fused_sweep_axis0_v2 (:686) and fused_sweep_axis1_v2 (:1363):
//    the masked tridiagonal solve along a STRIDED axis of a C-contiguous
//    field viewed as (B1, n, B2) -- x: (1, nx, ny*nz), y: (nx, ny, nz), and
//    the transposed z of the field plan: (1, nz, nx*ny).
// K2 replaces pallas_sweeps.py fused_sweep_axis2_v2 (:950): the plan-lite
//    solve along the CONTIGUOUS z axis of the natural field.
//
// Row system (both kernels), from the per-cell code byte
// (bits 1/2 = coupling to i-1/i+1, 4 = Dirichlet pin, 8 = in-mask):
//   a = -tg*low, c = -tg*high, cf = coeff (field) or
//   rob_c*(2-low-high)*inmask (plan-lite), b = 1 + tg*(low+high) + dt*cf,
//   d = rhs + dt*cf*t_inf; pinned rows have b = 1.  K1 folds the Neumann
//   source (rhs += dt*qflux) and the Dirichlet value (rhs = dir_val on
//   pinned rows, cf = 0 there) as fused_sweep_axis0_v2 does (:714-720).
//
// K1's v1 entry ("K1v1", `pin_from_code`) replaces pallas_sweeps.py
//    fused_sweep_axis0 (:289, body _sweep_kernel :101) and
//    fused_sweep_axis1 (:215, body _sweep_kernel_axis1 :147), the
//    field-coefficient sweeps of the public fused_sweep (:2025).  Their
//    pin rule differs: a row with code bit 4 is ALWAYS an identity row
//    (b = 1, :116-121), while cf is zeroed and the rhs replaced by dir_val
//    only when dir_val is given (:298-303).  Without dir_val a pinned row
//    keeps d = rhs + dt*coeff*t_inf.  The v2 kernels pin only with dir_val
//    (:771).  The v1 kernels pad n and the batch with identity rows; K1
//    needs no padding (back substitution starts from x = 0).
//
// Types: the field (rhs, coeff, qflux, dir_val, out) is stored as S and
// solved in C (common.cuh ATF_DISPATCH_STATE): float32 and float64 solve
// at their own type; a bfloat16 field is widened on load, solved at
// float32 (c' and d' stay float32) and narrowed on the final store, to
// nearest or stochastically (`key`; the JAX kernels' rng_seed), at the
// cell's natural linear index.
//
// What bounds them on the H100: memory.  The TPU kernels keep c' and d' in
// VMEM and move 9-13 B/cell (5-7 at bfloat16).  Here:
//   K1: one thread per pencil; threads adjacent in the batch read adjacent
//       addresses, so every row load is coalesced.  c' and d' live in
//       scratch tensors of the compute type (global memory), and back
//       substitution writes x: ~25-29 B/cell at float32, ~21 at bfloat16.
//   K2: one thread per pencil would make every load strided.  A block of
//       one warp owns 32 pencils and stages [32 pencils x 32 rows] tiles of
//       rhs and code through shared memory with coalesced loads; each lane
//       runs its pencil's recurrence from the tile.  c' and d' go to global
//       scratch through the same coalesced tiles (~25 B/cell), so a block
//       needs ~10 KB of shared memory and many warps share an SM.  Keeping
//       c' and d' of whole lines in shared memory instead (9 B/cell) leaves
//       one warp per SM at 512 rows (~140 KB per block); on the H100 that
//       variant measured 1.5x slower at 256^3 and 4.3x slower at 512^3
//       (PERF.md), so it was dropped.
// A simple kernel first: no TMA, no multi-warp split of a line.
#include "common.cuh"

namespace {

// zxy: the field is the (z, x, y) permutation of the natural field (B1 = 1,
// n = nz): the natural index of row i of pencil p is p*n + i.
// kPinFromCode: the v1 pin rule (K1v1), a compile-time switch so that K1's
// own entries compile as before.
template <typename S, typename C, bool kPinFromCode>
__global__ void __launch_bounds__(256) sweep_strided_kernel(
    const S* __restrict__ rhs, const uint8_t* __restrict__ code,
    const S* __restrict__ coeff, const S* __restrict__ qflux,
    const S* __restrict__ dirv, S* __restrict__ out, C* __restrict__ cpbuf,
    C* __restrict__ dpbuf, int64_t B1, int64_t n, int64_t B2, C tg, C dt,
    C t_inf, C rob_c, int64_t key, int zxy) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B1 * B2) return;
  const int64_t b1 = p / B2;
  const int64_t base = b1 * n * B2 + (p - b1 * B2);
  const bool has_pin = dirv != nullptr;

  C cp = C(0), dp = C(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    const unsigned c = code[off];
    const C low = atf::bit<C>(c, atf::kLow);
    const C high = atf::bit<C>(c, atf::kHigh);
    const bool pin = has_pin && (c & atf::kPin);
    C r = atf::ld(rhs + off);
    if (qflux != nullptr) r = r + dt * atf::ld(qflux + off);
    if (pin) r = atf::ld(dirv + off);
    C cf;
    if (coeff != nullptr) {
      cf = pin ? C(0) : atf::ld(coeff + off);
    } else {
      cf = rob_c * ((C(2) - low - high) * atf::bit<C>(c, atf::kInMask));
    }
    const C a = -tg * low;
    const C cc = -tg * high;
    const C dtcf = dt * cf;
    C b = C(1) + tg * (low + high) + dtcf;
    if (kPinFromCode ? (c & atf::kPin) != 0u : pin) b = C(1);
    const C dd = r + dtcf * t_inf;
    const C inv = C(1) / (b - a * cp);
    cp = cc * inv;
    dp = (dd - a * dp) * inv;
    cpbuf[off] = cp;
    dpbuf[off] = dp;
  }
  C x = C(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    x = dpbuf[off] - cpbuf[off] * x;
    atf::st(out + off, x, key, zxy ? p * n + i : off);
  }
}

constexpr int kPencils = 32;     // pencils per K2 block (one warp)
constexpr int kChunk = 32;       // rows per staged tile
constexpr int kPitch = kChunk + 1;  // padded tile row: conflict-free lanes

template <typename C>
constexpr size_t z_smem_bytes() {
  // rhs / c' / x tile and d' tile (C), then the code tile (bytes)
  return 2 * sizeof(C) * kPencils * kPitch + kPencils * kPitch;
}

template <typename S, typename C>
__global__ void __launch_bounds__(kPencils) sweep_z_kernel(
    const S* __restrict__ rhs, const uint8_t* __restrict__ code,
    S* __restrict__ out, C* __restrict__ cpbuf, C* __restrict__ dpbuf,
    int64_t npen, int64_t n, C tg, C dt, C t_inf, C rob_c, int64_t key) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  C* tile = reinterpret_cast<C*>(atf_smem);         // rhs, then c', then x
  C* tile2 = tile + kPencils * kPitch;              // d'
  uint8_t* ctile = reinterpret_cast<uint8_t*>(tile2 + kPencils * kPitch);

  const int lane = threadIdx.x;
  const int64_t pen0 = (int64_t)blockIdx.x * kPencils;
  const int np = (int)atf::imin(kPencils, npen - pen0);

  // forward elimination, chunk by chunk: stage rhs and code (lane = row),
  // recur (lane = pencil), write c' and d' back (lane = row)
  C cp = C(0), dp = C(0);
  for (int64_t k0 = 0; k0 < n; k0 += kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        tile[q * kPitch + lane] = atf::ld(rhs + g);
        ctile[q * kPitch + lane] = code[g];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = 0; j < cz; ++j) {
        const unsigned c = ctile[lane * kPitch + j];
        const C low = atf::bit<C>(c, atf::kLow);
        const C high = atf::bit<C>(c, atf::kHigh);
        const C cf =
            rob_c * ((C(2) - low - high) * atf::bit<C>(c, atf::kInMask));
        const C a = -tg * low;
        const C cc = -tg * high;
        const C dtcf = dt * cf;
        C b = C(1) + tg * (low + high) + dtcf;
        if (c & atf::kPin) b = C(1);
        const C dd = tile[lane * kPitch + j] + dtcf * t_inf;
        const C inv = C(1) / (b - a * cp);
        cp = cc * inv;
        dp = (dd - a * dp) * inv;
        tile[lane * kPitch + j] = cp;
        tile2[lane * kPitch + j] = dp;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        cpbuf[g] = tile[q * kPitch + lane];
        dpbuf[g] = tile2[q * kPitch + lane];
      }
    }
    __syncwarp();
  }

  // back substitution, last chunk first
  C x = C(0);
  for (int64_t k0 = (n - 1) / kChunk * kChunk; k0 >= 0; k0 -= kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        tile[q * kPitch + lane] = cpbuf[g];
        tile2[q * kPitch + lane] = dpbuf[g];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = cz - 1; j >= 0; --j) {
        x = tile2[lane * kPitch + j] - tile[lane * kPitch + j] * x;
        tile[lane * kPitch + j] = x;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        atf::st(out + g, tile[q * kPitch + lane], key, g);
      }
    }
    __syncwarp();
  }
}

template <typename S, typename C>
void launch_sweep_strided(const void* rhs, const void* code,
                          const void* coeff, const void* qflux,
                          const void* dirv, void* out, void* cpbuf,
                          void* dpbuf, int64_t B1, int64_t n, int64_t B2,
                          double tg, double dt, double t_inf, double rob_c,
                          int64_t key, int zxy, int pin_from_code,
                          cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(B1 * B2, threads);
  auto* kernel = pin_from_code ? sweep_strided_kernel<S, C, true>
                               : sweep_strided_kernel<S, C, false>;
  kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const S*>(rhs), static_cast<const uint8_t*>(code),
      static_cast<const S*>(coeff), static_cast<const S*>(qflux),
      static_cast<const S*>(dirv), static_cast<S*>(out),
      static_cast<C*>(cpbuf), static_cast<C*>(dpbuf), B1, n, B2, (C)tg,
      (C)dt, (C)t_inf, (C)rob_c, key, zxy);
}

template <typename S, typename C>
void launch_sweep_z(const void* rhs, const void* code, void* out,
                    void* cpbuf, void* dpbuf, int64_t npen, int64_t n,
                    double tg, double dt, double t_inf, double rob_c,
                    int64_t key, cudaStream_t stream) {
  const int64_t blocks = atf::cdiv(npen, kPencils);
  sweep_z_kernel<S, C><<<(unsigned)blocks, kPencils, z_smem_bytes<C>(),
                         stream>>>(
      static_cast<const S*>(rhs), static_cast<const uint8_t*>(code),
      static_cast<S*>(out), static_cast<C*>(cpbuf), static_cast<C*>(dpbuf),
      npen, n, (C)tg, (C)dt, (C)t_inf, (C)rob_c, key);
}

}  // namespace

ATF_API int atf_sweep_strided(int dtype, int device, const void* rhs,
                              const void* code, const void* coeff,
                              const void* qflux, const void* dirv, void* out,
                              void* cpbuf, void* dpbuf, int64_t B1,
                              int64_t n, int64_t B2, double tg, double dt,
                              double t_inf, double rob_c, int64_t key,
                              int zxy, int pin_from_code, void* stream) {
  ATF_DISPATCH_STATE(dtype, device,
                     launch_sweep_strided<S, C>(
                         rhs, code, coeff, qflux, dirv, out, cpbuf, dpbuf,
                         B1, n, B2, tg, dt, t_inf, rob_c, key, zxy,
                         pin_from_code, (cudaStream_t)stream));
}

ATF_API int atf_sweep_z(int dtype, int device, const void* rhs,
                        const void* code, void* out, void* cpbuf,
                        void* dpbuf, int64_t npen, int64_t n, double tg,
                        double dt, double t_inf, double rob_c, int64_t key,
                        void* stream) {
  ATF_DISPATCH_STATE(dtype, device,
                     launch_sweep_z<S, C>(rhs, code, out, cpbuf, dpbuf, npen,
                                          n, tg, dt, t_inf, rob_c, key,
                                          (cudaStream_t)stream));
}

ATF_API const char* atf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
