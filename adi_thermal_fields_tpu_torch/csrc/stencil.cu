// K3: the explicit theta-pass stencil.
//
// Replaces adi_thermal_fields_tpu/solvers/pallas_stencil.py theta_rhs (:115),
// body _theta_rhs_kernel (:47):
//   R0 = T + (c * M) * sum_ax inv_ax * (m_lo*T_lo + m_hi*T_hi - (m_lo+m_hi)*T)
// with M the cell's mask and m_lo/m_hi its neighbours' masks (0/1
// multiplies; 0 beyond the domain edge).  Void cells pass T through.  The
// accumulation order is the TPU kernel's: x, then y, then z.
//
// The field is stored as S and the stencil computed in C (float32 for a
// bfloat16 field, whose R0 is rounded to nearest or stochastically, as the
// JAX kernel's rng_seed asks; common.cuh).
//
// What bounds it on the H100: memory -- read T (4 B) + mask (1 B), write R0
// (4 B) = 9 B/cell for float32, 5 for bfloat16.  The first version ran one
// thread per cell and took (i, j, k) back from the flat index by 64-bit
// division (a software routine on the GPU), with seven 4-byte T and seven
// 1-byte mask loads per cell: 41% of the card's copy rate.  Design: a plane
// march, the JAX kernel's sequential grid over x planes (ring of planes)
// turned into a loop inside the block.
//   - A block of 32 x 8 threads owns a tile of 128 z by 8 y cells and
//     marches it along a segment of x; a thread owns 4 cells adjacent in z
//     and keeps their T and mask at x-1, x and x+1 in registers, rotating
//     them one plane per step, so each plane is loaded from memory once
//     (the segments' end planes twice).  The segments split x so that the
//     grid fills the card (about two waves of the blocks it holds).
//   - Loads are 16 bytes a thread along z (four floats; four mask bytes as
//     one 32-bit word; two 16-byte loads at float64, one 8-byte at
//     bfloat16) where nz % 4 == 0 and the pointers allow; else scalar.
//   - y+-1 are the rows of the neighbouring warps and blocks in the same
//     plane, loaded through L1/L2; z+-1 inside a thread's four cells are
//     registers, across threads a warp shuffle (lanes 0 and 31 load their
//     outer neighbour from memory).
//   - y and z come from blockIdx and threadIdx: the only 64-bit index
//     arithmetic is the plane offset i*ny*nz, and no division is done per
//     cell.
#include "common.cuh"

namespace {

constexpr int kQuad = 4;                 // cells a thread owns along z
constexpr int kRows = 8;                 // y rows (warps) a block owns
constexpr int kTileZ = 32 * kQuad;
constexpr int kK3Waves = 2;             // waves of blocks the x segments make

// Four cells along z at p into C (kVec: one 16-byte or 8-byte load per 16
// or 8 bytes, p aligned; else one load per cell, zero past `cnt`).
template <bool kVec>
__device__ __forceinline__ void ld4(const float* p, int cnt, float v[4]) {
  if (kVec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) v[q] = q < cnt ? p[q] : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void ld4(const double* p, int cnt, double v[4]) {
  if (kVec) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) v[q] = q < cnt ? p[q] : 0.0;
  }
}

template <bool kVec>
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, int cnt,
                                    float v[4]) {
  if (kVec) {
    // element 2m is the low half of word m (little-endian)
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) v[q] = q < cnt ? atf::ld(p + q) : 0.0f;
  }
}

// Four mask bytes as one word, byte q = cell q (0 past `cnt`).
template <bool kVec>
__device__ __forceinline__ uint32_t ld4(const uint8_t* p, int cnt) {
  if (kVec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < kQuad; ++q) {
    if (q < cnt) w |= (uint32_t)p[q] << (8 * q);
  }
  return w;
}

template <bool kVec>
__device__ __forceinline__ void st4(float* p, int cnt, const float v[4],
                                    int64_t, int64_t) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      if (q < cnt) p[q] = v[q];
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void st4(double* p, int cnt, const double v[4],
                                    int64_t, int64_t) {
  if (kVec) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      if (q < cnt) p[q] = v[q];
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void st4(__nv_bfloat16* p, int cnt,
                                    const float v[4], int64_t key,
                                    int64_t idx) {
  if (kVec) {
    uint32_t b[4];
#pragma unroll
    for (int q = 0; q < kQuad; ++q) b[q] = atf::bf16_bits(v[q], key, idx + q);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
  } else {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      if (q < cnt) atf::st(p + q, v[q], key, idx + q);
    }
  }
}

template <typename C>
__device__ __forceinline__ C mbit(uint32_t w, int q) {
  return ((w >> (8 * q)) & 0xffu) ? C(1) : C(0);
}

// A thread's four cells of one plane: T and the mask bytes.
template <typename C>
struct Quad {
  C t[kQuad];
  uint32_t m;
};

// Grid: (z tiles, y tiles, x segments of `seg` planes).  A warp is one y
// row of the tile, so a row past ny leaves whole warps; lanes past nz hold
// zeros and still take part in the shuffles.
template <typename S, typename C, bool kVec>
__global__ void __launch_bounds__(32 * kRows) theta_rhs_kernel(
    const S* __restrict__ Tf, const uint8_t* __restrict__ mask,
    S* __restrict__ out, int nx, int ny, int nz, int seg, C c, C iv_x,
    C iv_y, C iv_z, int64_t key) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x;
  const int j = blockIdx.y * kRows + threadIdx.y;
  if (j >= ny) return;                             // whole warps
  const int z0 = blockIdx.x * kTileZ + lane * kQuad;
  const int cnt = nz - z0;                         // cells of this thread
  const bool any = cnt > 0;
  const int jz = j * nz + z0;                      // < ny*nz < 2^31
  const int64_t plane = (int64_t)ny * nz;
  const int i0 = blockIdx.z * seg;
  const int i1 = min(i0 + seg, nx);

  // the thread's four cells at `off` (zero where `in` is false: beyond
  // the field's edge)
  auto load = [&](bool in, int64_t off, Quad<C>& v) {
    if (in) {
      ld4<kVec>(Tf + off, cnt, v.t);
      v.m = ld4<kVec>(mask + off, cnt);
    } else {
#pragma unroll
      for (int q = 0; q < kQuad; ++q) v.t[q] = C(0);
      v.m = 0u;
    }
  };

  Quad<C> lo, mid, hi, ylo, yhi;                  // planes x-1, x, x+1
  load(any && i0 > 0, (i0 - 1) * plane + jz, lo);
  load(any, i0 * plane + jz, mid);
  for (int i = i0; i < i1; ++i) {
    const int64_t off = i * plane + jz;
    load(any && i + 1 < nx, off + plane, hi);
    // y neighbours: rows j-1 and j+1 of this plane
    load(any && j > 0, off - nz, ylo);
    load(any && j < ny - 1, off + nz, yhi);
    // z neighbours of the thread's first and last cells: the next lanes'
    // cells, or (lanes 0 and 31) memory; zero beyond the edge
    C tzl = __shfl_up_sync(kAll, mid.t[kQuad - 1], 1);
    uint32_t mzl = __shfl_up_sync(kAll, mid.m >> 24, 1);
    C tzh = __shfl_down_sync(kAll, mid.t[0], 1);
    uint32_t mzh = __shfl_down_sync(kAll, mid.m & 0xffu, 1);
    if (lane == 0) {
      const bool in = any && z0 > 0;
      tzl = in ? atf::ld(Tf + off - 1) : C(0);
      mzl = in ? mask[off - 1] : 0u;
    }
    if (lane == 31) {
      const bool in = cnt > kQuad;
      tzh = in ? atf::ld(Tf + off + kQuad) : C(0);
      mzh = in ? mask[off + kQuad] : 0u;
    }

    // the first version's operations in its order (x, then y, then z)
    C r[kQuad];
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      const C Tc = mid.t[q];
      C ml = mbit<C>(lo.m, q), mh = mbit<C>(hi.m, q);
      const C sx = ml * lo.t[q] + mh * hi.t[q];
      C acc = (sx - (ml + mh) * Tc) * iv_x;
      ml = mbit<C>(ylo.m, q);
      mh = mbit<C>(yhi.m, q);
      const C sy = ml * ylo.t[q] + mh * yhi.t[q];
      acc = acc + (sy - (ml + mh) * Tc) * iv_y;
      const C tl = q > 0 ? mid.t[q - 1] : tzl;
      const C th = q < kQuad - 1 ? mid.t[q + 1] : tzh;
      ml = q > 0 ? mbit<C>(mid.m, q - 1) : (mzl ? C(1) : C(0));
      mh = q < kQuad - 1 ? mbit<C>(mid.m, q + 1) : (mzh ? C(1) : C(0));
      const C sz = ml * tl + mh * th;
      acc = acc + (sz - (ml + mh) * Tc) * iv_z;
      r[q] = Tc + (c * mbit<C>(mid.m, q)) * acc;
    }
    if (any) st4<kVec>(out + off, cnt, r, key, off);
    lo = mid;
    mid = hi;
  }
}

// Launches `kernel` with x cut into segments of planes: about two waves
// of the blocks the card holds at once.
template <typename S, typename C, typename K>
cudaError_t launch_march(K kernel, const void* Tf, const void* mask,
                         void* out, int64_t nx, int64_t ny, int64_t nz,
                         double c, double iv_x, double iv_y, double iv_z,
                         int64_t key, int device, cudaStream_t stream) {
  const int64_t tz = atf::cdiv(nz, kTileZ), ty = atf::cdiv(ny, kRows);
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kRows,
                                                0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = kK3Waves * (int64_t)(per_sm > 0 ? per_sm : 1) *
                       (sms > 0 ? sms : 1);
  const int64_t nseg =
      atf::imin(atf::imin(atf::cdiv(want, tz * ty), nx), 65535);
  const int seg = (int)atf::cdiv(nx, nseg);
  kernel<<<dim3((unsigned)tz, (unsigned)ty, (unsigned)atf::cdiv(nx, seg)),
           dim3(32, kRows), 0, stream>>>(
      static_cast<const S*>(Tf), static_cast<const uint8_t*>(mask),
      static_cast<S*>(out), (int)nx, (int)ny, (int)nz, seg, (C)c, (C)iv_x,
      (C)iv_y, (C)iv_z, key);
  return cudaSuccess;
}

template <typename S, typename C>
cudaError_t launch_theta_rhs(const void* Tf, const void* mask, void* out,
                             int64_t nx, int64_t ny, int64_t nz, double c,
                             double iv_x, double iv_y, double iv_z,
                             int64_t key, int device, cudaStream_t stream) {
  if (nx * ny * nz == 0) return cudaSuccess;
  // 32-bit (y, z) offsets and x planes; the grid's y limit
  if (ny * nz >= ((int64_t)1 << 31) || nx >= ((int64_t)1 << 31) ||
      atf::cdiv(ny, kRows) > 65535) {
    return cudaErrorInvalidValue;
  }
  auto aligned = [](const void* p, size_t b) {
    return reinterpret_cast<uintptr_t>(p) % b == 0;
  };
  const bool vec = nz % kQuad == 0 && aligned(Tf, kQuad * sizeof(S)) &&
                   aligned(out, kQuad * sizeof(S)) && aligned(mask, kQuad);
  return vec ? launch_march<S, C>(theta_rhs_kernel<S, C, true>, Tf, mask,
                                  out, nx, ny, nz, c, iv_x, iv_y, iv_z, key,
                                  device, stream)
             : launch_march<S, C>(theta_rhs_kernel<S, C, false>, Tf, mask,
                                  out, nx, ny, nz, c, iv_x, iv_y, iv_z, key,
                                  device, stream);
}

}  // namespace

ATF_API int atf_theta_rhs(int dtype, int device, const void* Tf,
                          const void* mask, void* out, int64_t nx,
                          int64_t ny, int64_t nz, double c, double iv_x,
                          double iv_y, double iv_z, int64_t key,
                          void* stream) {
  ATF_DISPATCH_STATE(dtype, device,
                     ATF_RETURN_IF((launch_theta_rhs<S, C>(
                         Tf, mask, out, nx, ny, nz, c, iv_x, iv_y, iv_z, key,
                         device, (cudaStream_t)stream))));
}
