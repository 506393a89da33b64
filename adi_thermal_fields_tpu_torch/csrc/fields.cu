// K21 and K22: tridiagonal solves with general field coefficients.
//
// K21 replaces adi_thermal_fields_tpu/solvers/pallas_fields.py
//     fused_tridiag_fields (:129, body _field_kernel :40): Thomas on
//     a/b/c/d fields (solvers/thomas.thomas semantics: a[0] and c[n-1]
//     ignored).  Two entry points on the natural field:
//       strided: the solve along the middle axis of a (B1, n, B2) view --
//         x of (x, y, z) as (1, nx, ny*nz), y as (nx, ny, nz), the
//         cylindrical r and phi;
//       z: the solve along the contiguous last axis, (npen, n).
// K22 replaces pallas_fields.py fused_cyclic_fields (:311, body
//     _cyclic_field_kernel :179): the periodic solve along the middle
//     axis of a (B1, n, B2) view (phi of the natural cylindrical field).
//     The wrap couplings are alpha = c[n-1] and beta = a[0] with the gauge
//     gamma = -b[0] (solvers/thomas.cyclic_thomas), entered by
//     Sherman-Morrison in atf::CyclicSolve (shared with K18).
//     The JAX wrapper pads the batch with identity systems and sets their
//     gamma to -1 (:335-337); nothing is padded here, and a real system
//     with b[0] = 0 is as singular in the gauge as it is in cyclic_thomas.
//
// Every operation is one IEEE rounding in thomas / cyclic_thomas order, so
// the kernels repeat their plain versions bit for bit.
//
// What bounds them on the H100: memory -- read a, b, c, d (16) and write x
// (4): 20 B/cell (float32), plus the global scratch: K21 c' and d' (+16
// B/cell, through the output and one scratch field), K22 c', y and z of
// the double solve (~+36).  The strided entries give one thread to each
// pencil; threads adjacent in B2 read adjacent addresses, so row loads
// coalesce when B2 is large (x, y, cylindrical r and phi).  The z entry
// follows K8 and K19: one warp owns 32 pencils and stages [32 pencils x 32
// rows] tiles of a, b, c, d through shared memory with coalesced loads
// (lane = row), then each lane runs its pencil's recurrence from the tiles
// (lane = pencil; padded pitch, conflict-free); c' and d' pass to global
// scratch through the c and d tiles.
#include "common.cuh"

namespace {

using atf::div;
using atf::mul;
using atf::sub;

constexpr int kPencils = 32;        // z entry: pencils per block (one warp)
constexpr int kChunk = 32;          // rows per staged tile
constexpr int kPitch = kChunk + 1;  // padded tile row

template <typename T>
__global__ void __launch_bounds__(256) tridiag_strided_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ c, const T* __restrict__ d, T* __restrict__ out,
    T* __restrict__ dpbuf, int64_t B1, int64_t n, int64_t B2) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B1 * B2) return;
  const int64_t b1 = p / B2;
  const int64_t base = b1 * n * B2 + (p - b1 * B2);
  T cp = T(0), dp = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    const T ai = a[off];
    const T denom = sub(b[off], mul(ai, cp));
    cp = div(c[off], denom);
    dp = div(sub(d[off], mul(ai, dp)), denom);
    out[off] = cp;
    dpbuf[off] = dp;
  }
  T x = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    x = sub(dpbuf[off], mul(out[off], x));
    out[off] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPencils) tridiag_z_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ c, const T* __restrict__ d, T* __restrict__ out,
    T* __restrict__ dpbuf, int64_t npen, int64_t n) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* atile = reinterpret_cast<T*>(atf_smem);
  T* btile = atile + kPencils * kPitch;
  T* ctile = btile + kPencils * kPitch;      // c, then c', then x
  T* dtile = ctile + kPencils * kPitch;      // d, then d'

  const int lane = threadIdx.x;
  const int64_t pen0 = (int64_t)blockIdx.x * kPencils;
  const int np = (int)atf::imin(kPencils, npen - pen0);
  const int row = lane * kPitch;

  T cp = T(0), dp = T(0);
  for (int64_t k0 = 0; k0 < n; k0 += kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        const int s = q * kPitch + lane;
        atile[s] = a[g];
        btile[s] = b[g];
        ctile[s] = c[g];
        dtile[s] = d[g];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = 0; j < cz; ++j) {
        const T aj = atile[row + j];
        const T denom = sub(btile[row + j], mul(aj, cp));
        cp = div(ctile[row + j], denom);
        dp = div(sub(dtile[row + j], mul(aj, dp)), denom);
        ctile[row + j] = cp;
        dtile[row + j] = dp;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        out[g] = ctile[q * kPitch + lane];
        dpbuf[g] = dtile[q * kPitch + lane];
      }
    }
    __syncwarp();
  }

  T x = T(0);
  for (int64_t k0 = (n - 1) / kChunk * kChunk; k0 >= 0; k0 -= kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        ctile[q * kPitch + lane] = out[g];
        dtile[q * kPitch + lane] = dpbuf[g];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = cz - 1; j >= 0; --j) {
        x = sub(dtile[row + j], mul(ctile[row + j], x));
        ctile[row + j] = x;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        out[(pen0 + q) * n + k0 + lane] = ctile[q * kPitch + lane];
      }
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(128) cyclic_strided_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ c, const T* __restrict__ d, T* __restrict__ out,
    T* __restrict__ cpbuf, T* __restrict__ zbuf, int64_t B1, int64_t n,
    int64_t B2) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B1 * B2) return;
  const int64_t b1 = p / B2;
  const int64_t base = b1 * n * B2 + (p - b1 * B2);
  atf::CyclicSolve<T> solve(n, out, cpbuf, zbuf);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    solve.row(i, off, a[off], b[off], c[off], d[off]);
  }
  solve.finish(base, B2);
}

template <typename T>
void launch_tridiag_strided(const void* a, const void* b, const void* c,
                            const void* d, void* out, void* scratch,
                            int64_t B1, int64_t n, int64_t B2,
                            cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(B1 * B2, threads);
  tridiag_strided_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(d),
      static_cast<T*>(out), static_cast<T*>(scratch), B1, n, B2);
}

template <typename T>
void launch_tridiag_z(const void* a, const void* b, const void* c,
                      const void* d, void* out, void* scratch, int64_t npen,
                      int64_t n, cudaStream_t stream) {
  const size_t smem = 4 * sizeof(T) * kPencils * kPitch;
  atf::allow_dynamic_smem(tridiag_z_kernel<T>, smem);
  const int64_t blocks = atf::cdiv(npen, kPencils);
  tridiag_z_kernel<T><<<(unsigned)blocks, kPencils, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(d),
      static_cast<T*>(out), static_cast<T*>(scratch), npen, n);
}

template <typename T>
void launch_cyclic_strided(const void* a, const void* b, const void* c,
                           const void* d, void* out, void* cpbuf, void* zbuf,
                           int64_t B1, int64_t n, int64_t B2,
                           cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = atf::cdiv(B1 * B2, threads);
  cyclic_strided_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(d),
      static_cast<T*>(out), static_cast<T*>(cpbuf), static_cast<T*>(zbuf),
      B1, n, B2);
}

}  // namespace

ATF_API int atf_tridiag_fields_strided(int dtype, int device, const void* a,
                                       const void* b, const void* c,
                                       const void* d, void* out,
                                       void* scratch, int64_t B1, int64_t n,
                                       int64_t B2, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_tridiag_strided<T>(a, b, c, d, out, scratch, B1, n, B2,
                                         (cudaStream_t)stream));
}

ATF_API int atf_tridiag_fields_z(int dtype, int device, const void* a,
                                 const void* b, const void* c, const void* d,
                                 void* out, void* scratch, int64_t npen,
                                 int64_t n, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_tridiag_z<T>(a, b, c, d, out, scratch, npen, n,
                                   (cudaStream_t)stream));
}

ATF_API int atf_cyclic_fields(int dtype, int device, const void* a,
                              const void* b, const void* c, const void* d,
                              void* out, void* cpbuf, void* zbuf, int64_t B1,
                              int64_t n, int64_t B2, void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  ATF_DISPATCH(dtype, device,
               launch_cyclic_strided<T>(a, b, c, d, out, cpbuf, zbuf, B1, n,
                                        B2, (cudaStream_t)stream));
}
