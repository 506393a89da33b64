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
// What bounds them on the H100: memory.  The TPU kernels keep c' and d' in
// VMEM and move 9-13 B/cell.  Here:
//   K1: one thread per pencil; threads adjacent in the batch read adjacent
//       addresses, so every row load is coalesced.  c' lives in the output
//       buffer and d' in a scratch tensor (global memory), and back
//       substitution overwrites c' with x: ~25-29 B/cell, no shared memory.
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

template <typename T>
__global__ void __launch_bounds__(256) sweep_strided_kernel(
    const T* __restrict__ rhs, const uint8_t* __restrict__ code,
    const T* __restrict__ coeff, const T* __restrict__ qflux,
    const T* __restrict__ dirv, T* __restrict__ out, T* __restrict__ dpbuf,
    int64_t B1, int64_t n, int64_t B2, T tg, T dt, T t_inf, T rob_c) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B1 * B2) return;
  const int64_t b1 = p / B2;
  const int64_t base = b1 * n * B2 + (p - b1 * B2);
  const bool has_pin = dirv != nullptr;

  T cp = T(0), dp = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    const unsigned c = code[off];
    const T low = atf::bit<T>(c, atf::kLow);
    const T high = atf::bit<T>(c, atf::kHigh);
    const bool pin = has_pin && (c & atf::kPin);
    T r = rhs[off];
    if (qflux != nullptr) r = r + dt * qflux[off];
    if (pin) r = dirv[off];
    T cf;
    if (coeff != nullptr) {
      cf = pin ? T(0) : coeff[off];
    } else {
      cf = rob_c * ((T(2) - low - high) * atf::bit<T>(c, atf::kInMask));
    }
    const T a = -tg * low;
    const T cc = -tg * high;
    const T dtcf = dt * cf;
    T b = T(1) + tg * (low + high) + dtcf;
    if (pin) b = T(1);
    const T dd = r + dtcf * t_inf;
    const T inv = T(1) / (b - a * cp);
    cp = cc * inv;
    dp = (dd - a * dp) * inv;
    out[off] = cp;
    dpbuf[off] = dp;
  }
  T x = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    x = dpbuf[off] - out[off] * x;
    out[off] = x;
  }
}

constexpr int kPencils = 32;     // pencils per K2 block (one warp)
constexpr int kChunk = 32;       // rows per staged tile
constexpr int kPitch = kChunk + 1;  // padded tile row: conflict-free lanes

template <typename T>
constexpr size_t z_smem_bytes() {
  // rhs / c' / x tile and d' tile (T), then the code tile (bytes)
  return 2 * sizeof(T) * kPencils * kPitch + kPencils * kPitch;
}

template <typename T>
__global__ void __launch_bounds__(kPencils) sweep_z_kernel(
    const T* __restrict__ rhs, const uint8_t* __restrict__ code,
    T* __restrict__ out, T* __restrict__ dpbuf, int64_t npen, int64_t n,
    T tg, T dt, T t_inf, T rob_c) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* tile = reinterpret_cast<T*>(atf_smem);         // rhs, then c', then x
  T* tile2 = tile + kPencils * kPitch;              // d'
  uint8_t* ctile = reinterpret_cast<uint8_t*>(tile2 + kPencils * kPitch);

  const int lane = threadIdx.x;
  const int64_t pen0 = (int64_t)blockIdx.x * kPencils;
  const int np = (int)atf::imin(kPencils, npen - pen0);

  // forward elimination, chunk by chunk: stage rhs and code (lane = row),
  // recur (lane = pencil), write c' and d' back (lane = row)
  T cp = T(0), dp = T(0);
  for (int64_t k0 = 0; k0 < n; k0 += kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        tile[q * kPitch + lane] = rhs[g];
        ctile[q * kPitch + lane] = code[g];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = 0; j < cz; ++j) {
        const unsigned c = ctile[lane * kPitch + j];
        const T low = atf::bit<T>(c, atf::kLow);
        const T high = atf::bit<T>(c, atf::kHigh);
        const T cf =
            rob_c * ((T(2) - low - high) * atf::bit<T>(c, atf::kInMask));
        const T a = -tg * low;
        const T cc = -tg * high;
        const T dtcf = dt * cf;
        T b = T(1) + tg * (low + high) + dtcf;
        if (c & atf::kPin) b = T(1);
        const T dd = tile[lane * kPitch + j] + dtcf * t_inf;
        const T inv = T(1) / (b - a * cp);
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
        out[g] = tile[q * kPitch + lane];
        dpbuf[g] = tile2[q * kPitch + lane];
      }
    }
    __syncwarp();
  }

  // back substitution, last chunk first
  T x = T(0);
  for (int64_t k0 = (n - 1) / kChunk * kChunk; k0 >= 0; k0 -= kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        tile[q * kPitch + lane] = out[g];
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
        out[(pen0 + q) * n + k0 + lane] = tile[q * kPitch + lane];
      }
    }
    __syncwarp();
  }
}

template <typename T>
void launch_sweep_strided(const void* rhs, const void* code,
                          const void* coeff, const void* qflux,
                          const void* dirv, void* out, void* scratch,
                          int64_t B1, int64_t n, int64_t B2, double tg,
                          double dt, double t_inf, double rob_c,
                          cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(B1 * B2, threads);
  sweep_strided_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(rhs), static_cast<const uint8_t*>(code),
      static_cast<const T*>(coeff), static_cast<const T*>(qflux),
      static_cast<const T*>(dirv), static_cast<T*>(out),
      static_cast<T*>(scratch), B1, n, B2, (T)tg, (T)dt, (T)t_inf,
      (T)rob_c);
}

template <typename T>
void launch_sweep_z(const void* rhs, const void* code, void* out,
                    void* scratch, int64_t npen, int64_t n, double tg,
                    double dt, double t_inf, double rob_c,
                    cudaStream_t stream) {
  const int64_t blocks = atf::cdiv(npen, kPencils);
  sweep_z_kernel<T><<<(unsigned)blocks, kPencils, z_smem_bytes<T>(),
                      stream>>>(
      static_cast<const T*>(rhs), static_cast<const uint8_t*>(code),
      static_cast<T*>(out), static_cast<T*>(scratch), npen, n, (T)tg,
      (T)dt, (T)t_inf, (T)rob_c);
}

}  // namespace

ATF_API int atf_sweep_strided(int dtype, int device, const void* rhs,
                              const void* code, const void* coeff,
                              const void* qflux, const void* dirv, void* out,
                              void* scratch, int64_t B1, int64_t n,
                              int64_t B2, double tg, double dt, double t_inf,
                              double rob_c, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_sweep_strided<T>(rhs, code, coeff, qflux, dirv, out,
                                       scratch, B1, n, B2, tg, dt, t_inf,
                                       rob_c, (cudaStream_t)stream));
}

ATF_API int atf_sweep_z(int dtype, int device, const void* rhs,
                        const void* code, void* out, void* scratch,
                        int64_t npen, int64_t n, double tg, double dt,
                        double t_inf, double rob_c, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_sweep_z<T>(rhs, code, out, scratch, npen, n, tg, dt,
                                 t_inf, rob_c, (cudaStream_t)stream));
}

ATF_API const char* atf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
