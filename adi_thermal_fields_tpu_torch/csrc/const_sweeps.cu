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
// so inv and cp are the same for every line: one thread of each block
// computes them into shared memory before the lines start, and each line
// carries only d'.  K14 also solves the Sherman-Morrison system B z = u
// there (a = c = -fac, b = 1 + 2 fac, gamma = -b, b_0 = 2b, b_{n-1} = b -
// a a/gamma, u = gamma e_0 + a e_{n-1}), so a line carries only y and
// x = y - z (y_0 + a y_{n-1}/gamma)/(1 + z_0 + a z_{n-1}/gamma).
//
// Rounding: every operation is one IEEE rounding (atf::add/sub/mul/div, the
// _rn intrinsics) in the order of the plain versions in
// solvers/const_sweeps.py, which compute inv, cp (and K14's z) once per row
// or ring the same way, so kernel and plain version agree bit for bit.  On
// a full disk at 0.5 mm cells the phi fac reaches hundreds in the second
// ring, and a solve multiplies one rounding difference by ~4 fac.
//
// What bounds them on the H100: memory.  The byte model (float32) reads rhs
// 4 and writes x 4 = 8 B/cell (the coefficient vectors add < 0.01 B/cell).
//   K12: one thread per (phi, z) pencil; adjacent threads read adjacent
//        addresses.  d' goes through the output (+8 B/cell round trip).
//   K13: one warp owns 32 pencils and stages [32 pencils x 32 rows] tiles
//        of rhs, d' and x through shared memory (coalesced, lane = row),
//        then each lane recurs along its pencil (lane = pencil; padded
//        pitch); d' goes through the output (K2/K10's design).
//   K14: one thread per (r, z) pencil, blocks of one ring (grid y) and 128
//        consecutive z; y goes through the output, and the line is read
//        twice backwards (first for y_0 and y_{n-1}, then again to write x)
//        instead of storing y: rhs in, y out, y in twice, x out = 20 B/cell.
// A simple kernel first: no TMA, no split of a line across threads.
#include "common.cuh"

namespace {

using atf::add;
using atf::div;
using atf::mul;
using atf::sub;

// inv_i and cp_i of a constant-row tridiagonal system (one thread)
template <typename T>
__device__ void row_factors(const T* __restrict__ a, const T* __restrict__ b,
                            const T* __restrict__ c, int64_t n,
                            T* __restrict__ inv, T* __restrict__ cp) {
  T cprev = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const T iv = div(T(1), sub(b[i], mul(a[i], cprev)));
    cprev = mul(c[i], iv);
    inv[i] = iv;
    cp[i] = cprev;
  }
}

// d'_i from d'_{i-1}
template <typename T>
__device__ __forceinline__ T forward(T d, T radd, T a, T inv, T dp) {
  return mul(sub(add(d, radd), mul(a, dp)), inv);
}

template <typename T>
__global__ void __launch_bounds__(256) const_sweep_strided_kernel(
    const T* __restrict__ rhs, const T* __restrict__ a,
    const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ radd, T* __restrict__ out, int64_t n, int64_t B) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* inv = reinterpret_cast<T*>(atf_smem);
  T* cp = inv + n;
  if (threadIdx.x == 0) row_factors(a, b, c, n, inv, cp);
  __syncthreads();
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  T dp = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = i * B + p;
    dp = forward(rhs[off], __ldg(radd + i), __ldg(a + i), inv[i], dp);
    out[off] = dp;
  }
  T x = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = i * B + p;
    x = sub(out[off], mul(cp[i], x));
    out[off] = x;
  }
}

constexpr int kPencils = 32;        // pencils per K13 block (one warp)
constexpr int kChunk = 32;          // rows per staged tile
constexpr int kPitch = kChunk + 1;  // padded tile row: conflict-free lanes

template <typename T>
size_t z_smem_bytes(int64_t n) {
  // the rhs / d' / x tile, then inv and cp
  return sizeof(T) * (kPencils * kPitch + 2 * n);
}

template <typename T>
__global__ void __launch_bounds__(kPencils) const_sweep_z_kernel(
    const T* __restrict__ rhs, const T* __restrict__ a,
    const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ radd, T* __restrict__ out, int64_t npen,
    int64_t n) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* tile = reinterpret_cast<T*>(atf_smem);
  T* inv = tile + kPencils * kPitch;
  T* cp = inv + n;
  const int lane = threadIdx.x;
  if (lane == 0) row_factors(a, b, c, n, inv, cp);
  __syncwarp();

  const int64_t pen0 = (int64_t)blockIdx.x * kPencils;
  const int np = (int)atf::imin(kPencils, npen - pen0);
  const int row = lane * kPitch;

  // forward, chunk by chunk: stage rhs (lane = row), recur (lane =
  // pencil), write d' (lane = row)
  T dp = T(0);
  for (int64_t k0 = 0; k0 < n; k0 += kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        tile[q * kPitch + lane] = rhs[(pen0 + q) * n + k0 + lane];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = 0; j < cz; ++j) {
        const int64_t i = k0 + j;
        dp = forward(tile[row + j], __ldg(radd + i), __ldg(a + i), inv[i],
                     dp);
        tile[row + j] = dp;
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

  // back substitution, last chunk first
  T x = T(0);
  for (int64_t k0 = (n - 1) / kChunk * kChunk; k0 >= 0; k0 -= kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        tile[q * kPitch + lane] = out[(pen0 + q) * n + k0 + lane];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = cz - 1; j >= 0; --j) {
        x = sub(tile[row + j], mul(cp[k0 + j], x));
        tile[row + j] = x;
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

constexpr int kPhiThreads = 128;    // z pencils per K14 block

template <typename T>
__global__ void __launch_bounds__(kPhiThreads) cyclic_const_phi_kernel(
    const T* __restrict__ rhs, const T* __restrict__ fac,
    T* __restrict__ out, int64_t n, int64_t B2) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* inv = reinterpret_cast<T*>(atf_smem);
  T* cp = inv + n;
  T* zv = cp + n;
  __shared__ T s_a, s_gamma, s_den;
  const int64_t ring = blockIdx.y;

  // the ring's system (cyclic_const_phi_plain's per-ring vectors): inv,
  // cp, and z of B z = u, then the denominator of the fix-up factor
  if (threadIdx.x == 0) {
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
    s_a = a;
    s_gamma = gamma;
    s_den = add(add(T(1), zv[0]), div(mul(a, zv[n - 1]), gamma));
  }
  __syncthreads();

  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= B2) return;
  const int64_t base = ring * n * B2 + k;
  const T a = s_a;
  // forward: y' in the output
  T dy = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    const T ai = (i == 0) ? T(0) : a;
    dy = mul(sub(rhs[off], mul(ai, dy)), inv[i]);
    out[off] = dy;
  }
  // backward for y_0 and y_{n-1} (= y'_{n-1}, cp_{n-1} = 0)
  T y = T(0), yn = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    y = sub(out[base + i * B2], mul(cp[i], y));
    if (i == n - 1) yn = y;
  }
  const T fact = div(add(y, div(mul(a, yn), s_gamma)), s_den);
  // backward again: the same y, and x = y - fact z
  y = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    y = sub(out[off], mul(cp[i], y));
    out[off] = sub(y, mul(fact, zv[i]));
  }
}

template <typename T>
void launch_const_sweep_strided(const void* rhs, const void* a,
                                const void* b, const void* c,
                                const void* radd, void* out, int64_t n,
                                int64_t B, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(B, threads);
  const size_t smem = 2 * n * sizeof(T);
  atf::allow_dynamic_smem(const_sweep_strided_kernel<T>, smem);
  const_sweep_strided_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(radd), static_cast<T*>(out), n, B);
}

template <typename T>
void launch_const_sweep_z(const void* rhs, const void* a, const void* b,
                          const void* c, const void* radd, void* out,
                          int64_t npen, int64_t n, cudaStream_t stream) {
  const int64_t blocks = atf::cdiv(npen, kPencils);
  const size_t smem = z_smem_bytes<T>(n);
  atf::allow_dynamic_smem(const_sweep_z_kernel<T>, smem);
  const_sweep_z_kernel<T><<<(unsigned)blocks, kPencils, smem, stream>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(radd), static_cast<T*>(out), npen, n);
}

template <typename T>
void launch_cyclic_const_phi(const void* rhs, const void* fac, void* out,
                             int64_t B1, int64_t n, int64_t B2,
                             cudaStream_t stream) {
  const dim3 blocks((unsigned)atf::cdiv(B2, kPhiThreads), (unsigned)B1);
  const size_t smem = 3 * n * sizeof(T);
  atf::allow_dynamic_smem(cyclic_const_phi_kernel<T>, smem);
  cyclic_const_phi_kernel<T><<<blocks, kPhiThreads, smem, stream>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(fac),
      static_cast<T*>(out), n, B2);
}

}  // namespace

ATF_API int atf_const_sweep_strided(int dtype, int device, const void* rhs,
                                    const void* a, const void* b,
                                    const void* c, const void* radd,
                                    void* out, int64_t n, int64_t B,
                                    void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_const_sweep_strided<T>(rhs, a, b, c, radd, out, n, B,
                                             (cudaStream_t)stream));
}

ATF_API int atf_const_sweep_z(int dtype, int device, const void* rhs,
                              const void* a, const void* b, const void* c,
                              const void* radd, void* out, int64_t npen,
                              int64_t n, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_const_sweep_z<T>(rhs, a, b, c, radd, out, npen, n,
                                       (cudaStream_t)stream));
}

ATF_API int atf_cyclic_const_phi(int dtype, int device, const void* rhs,
                                 const void* fac, void* out, int64_t B1,
                                 int64_t n, int64_t B2, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_cyclic_const_phi<T>(rhs, fac, out, B1, n, B2,
                                          (cudaStream_t)stream));
}
