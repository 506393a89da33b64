// K5: the variable-property fields pass, and its bfloat16 entry K5b.
//
// Replaces adi_thermal_fields_tpu/solvers/pallas_varprop.py varprop_fields
// (:1274), body _vp_fields_kernel (:1223): from T and the uint8 mask, in
// the natural (x, y, z) layout,
//   fx[i] = harm(k(T[i-1]), k(T[i])) * m[i-1] * m[i]   (0 at the low edge;
//   fy, fz likewise along y and z), w = 1/(rho*cp(T)),
//   h = eps*sigma*(Tk+Tik)(Tk^2+Tik^2) + h_conv       (optional),
// with k and cp clamp-sum tables (varprop.cuh).  Types: S storage, C
// compute (common.cuh ATF_DISPATCH_STATE): a bfloat16 T (K5b) is widened
// to float32, every output computed at float32 and stored at bfloat16
// rounded to nearest, as the JAX kernel computes at float32 and casts to
// T's dtype (the fields pass has no stochastic store).  The helpers are
// the contracted ones (clamp_sum, harm, rad_film: FMAs), within a few
// float32 ulp of the plain version: on the one-rounding-per-operation
// `_rn` helpers K5 repeated its plain version bit for bit but ran 7-11%
// slower at 512^3 (1.856-1.902 against 1.717-1.738 ms, 1.941-1.967
// against 1.761-1.771 with the film; scripts/vp_bf16_ab.py's "K5 on _rn",
// PERF.md section 6): it is bound by instructions, not bytes, and an FMA
// a segment counts.
//
// What bounds it on the H100: memory -- read T (4 B) + mask (1 B), write
// fx, fy, fz, w (16 B) [+ h (4 B)] = 21/25 B/cell for float32, 11/13 at
// bfloat16.  Design: one thread per cell, threads adjacent in z
// (coalesced).  The TPU kernel carries the previous x-plane's k in VMEM;
// here each thread re-evaluates k at its x-1, y-1 and z-1 neighbours
// instead (a few operations per segment -- cheaper than a plane carry
// across blocks); the neighbour loads hit L1/L2.  Neighbour k is evaluated
// only where both cells are in-mask.  K5b, where the z rows pair up (nz
// even, the fields 4-byte aligned), takes two cells of a z row a thread:
// every access a 4-byte pair (the mask's a 2-byte one), the second cell's
// z face from the first cell's k, half the memory instructions.
#include "varprop.cuh"

namespace {

template <typename S, typename C>
__global__ void __launch_bounds__(256) varprop_fields_kernel(
    const S* __restrict__ Tf, const uint8_t* __restrict__ mask,
    S* __restrict__ fx, S* __restrict__ fy, S* __restrict__ fz,
    S* __restrict__ w, S* __restrict__ h, int64_t nx, int64_t ny,
    int64_t nz, const __grid_constant__ atf::Table<C> ktab,
    const __grid_constant__ atf::Table<C> ctab, C rho, C rc, C tik, C tik2,
    C hconv) {
  constexpr int64_t kNearest = -1;   // the fields are rounded to nearest
  const int64_t plane = ny * nz;
  const int64_t ncell = nx * plane;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < ncell; idx += stride) {
    const int64_t i = idx / plane;
    const int64_t jk = idx - i * plane;
    const int64_t j = jk / nz;
    const int64_t k = jk - j * nz;
    const C t = atf::ld(Tf + idx);
    const bool m = mask[idx] != 0;
    const C kc = atf::clamp_sum(ktab, t);
    atf::st(w + idx, C(1) / (rho * atf::clamp_sum(ctab, t)), kNearest,
            idx);
    if (h != nullptr) {
      atf::st(h + idx, atf::rad_film(t, rc, tik, tik2) + hconv, kNearest,
              idx);
    }
    // the face toward the neighbour at idx - off: harm(k_nb, k), 0 unless
    // both cells are in-mask
    auto face = [&](bool has_lo, int64_t off) {
      if (!m || !has_lo || mask[idx - off] == 0) return C(0);
      return atf::harm(atf::clamp_sum(ktab, atf::ld(Tf + idx - off)), kc);
    };
    atf::st(fx + idx, face(i > 0, plane), kNearest, idx);
    atf::st(fy + idx, face(j > 0, nz), kNearest, idx);
    atf::st(fz + idx, face(k > 0, 1), kNearest, idx);
  }
}

// K5b on two cells (idx, idx + 1) of a z row a thread: T, its x-1 and y-1
// neighbours and every output as bfloat16 pairs, the masks as byte pairs,
// the first cell's z-1 neighbour alone; the same arithmetic as
// varprop_fields_kernel, each output rounded to nearest.
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ unsigned ld_mask2(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__global__ void __launch_bounds__(256) varprop_fields_pair_kernel(
    const __nv_bfloat16* __restrict__ Tf, const uint8_t* __restrict__ mask,
    __nv_bfloat16* __restrict__ fx, __nv_bfloat16* __restrict__ fy,
    __nv_bfloat16* __restrict__ fz, __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ h, int64_t nx, int64_t ny, int64_t nz,
    const __grid_constant__ atf::Table<float> ktab,
    const __grid_constant__ atf::Table<float> ctab, float rho, float rc,
    float tik, float tik2, float hconv) {
  const int64_t plane = ny * nz;
  const int64_t npair = nx * plane / 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < npair; q += stride) {
    const int64_t idx = 2 * q;
    const int64_t i = idx / plane;
    const int64_t jk = idx - i * plane;
    const int64_t j = jk / nz;
    const int64_t k = jk - j * nz;            // even: the pair's first cell
    const float2 t = ld2(Tf + idx);
    const unsigned m = ld_mask2(mask + idx);
    const bool m0 = (m & 0xffu) != 0u, m1 = (m >> 8) != 0u;
    const float k0 = atf::clamp_sum(ktab, t.x);
    const float k1 = atf::clamp_sum(ktab, t.y);
    st2(w + idx, 1.0f / (rho * atf::clamp_sum(ctab, t.x)),
        1.0f / (rho * atf::clamp_sum(ctab, t.y)));
    if (h != nullptr) {
      st2(h + idx, atf::rad_film(t.x, rc, tik, tik2) + hconv,
          atf::rad_film(t.y, rc, tik, tik2) + hconv);
    }
    // the faces toward the pair at idx - off (x, y): harm(k_nb, k), 0
    // unless both cells are in-mask
    auto faces = [&](__nv_bfloat16* out, bool has_lo, int64_t off) {
      float f0 = 0.0f, f1 = 0.0f;
      if (has_lo && (m0 || m1)) {
        const unsigned mn = ld_mask2(mask + idx - off);
        const float2 tn = ld2(Tf + idx - off);
        if (m0 && (mn & 0xffu) != 0u) {
          f0 = atf::harm(atf::clamp_sum(ktab, tn.x), k0);
        }
        if (m1 && (mn >> 8) != 0u) {
          f1 = atf::harm(atf::clamp_sum(ktab, tn.y), k1);
        }
      }
      st2(out + idx, f0, f1);
    };
    faces(fx, i > 0, plane);
    faces(fy, j > 0, nz);
    float f0 = 0.0f;
    if (m0 && k > 0 && mask[idx - 1] != 0) {
      f0 = atf::harm(atf::clamp_sum(ktab, atf::ld(Tf + idx - 1)), k0);
    }
    st2(fz + idx, f0, m0 && m1 ? atf::harm(k0, k1) : 0.0f);
  }
}

template <typename S, typename C>
void launch_varprop_fields(const void* Tf, const void* mask, void* fx,
                           void* fy, void* fz, void* w, void* h, int64_t nx,
                           int64_t ny, int64_t nz, const double* ktab,
                           int kn, const double* ctab, int cn, double rho,
                           double rc, double tik, double tik2, double hconv,
                           cudaStream_t stream) {
  atf::Table<C> kt, ct;
  atf::make_table(ktab, kn, &kt);
  atf::make_table(ctab, cn, &ct);
  const int threads = 256;
  if constexpr (sizeof(S) == 2) {
    auto word = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 4 == 0;
    };
    if (nz % 2 == 0 && word(Tf) && word(fx) && word(fy) && word(fz) &&
        word(w) && word(h) && reinterpret_cast<uintptr_t>(mask) % 2 == 0) {
      const int64_t blocks =
          atf::imin(atf::cdiv(nx * ny * nz / 2, threads), (int64_t)1 << 20);
      varprop_fields_pair_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
          static_cast<const S*>(Tf), static_cast<const uint8_t*>(mask),
          static_cast<S*>(fx), static_cast<S*>(fy), static_cast<S*>(fz),
          static_cast<S*>(w), static_cast<S*>(h), nx, ny, nz, kt, ct,
          (C)rho, (C)rc, (C)tik, (C)tik2, (C)hconv);
      return;
    }
  }
  const int64_t blocks =
      atf::imin(atf::cdiv(nx * ny * nz, threads), (int64_t)1 << 20);
  varprop_fields_kernel<S, C><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const S*>(Tf), static_cast<const uint8_t*>(mask),
      static_cast<S*>(fx), static_cast<S*>(fy), static_cast<S*>(fz),
      static_cast<S*>(w), static_cast<S*>(h), nx, ny, nz, kt, ct, (C)rho,
      (C)rc, (C)tik, (C)tik2, (C)hconv);
}

}  // namespace

ATF_API int atf_varprop_fields(int dtype, int device, const void* Tf,
                               const void* mask, void* fx, void* fy,
                               void* fz, void* w, void* h, int64_t nx,
                               int64_t ny, int64_t nz, const double* ktab,
                               int kn, const double* ctab, int cn,
                               double rho, double rc, double tik,
                               double tik2, double hconv, void* stream) {
  if (kn < 0 || kn > atf::kMaxSeg || cn < 0 || cn > atf::kMaxSeg) {
    return (int)cudaErrorInvalidValue;
  }
  ATF_DISPATCH_STATE(dtype, device,
                     launch_varprop_fields<S, C>(
                         Tf, mask, fx, fy, fz, w, h, nx, ny, nz, ktab, kn,
                         ctab, cn, rho, rc, tik, tik2, hconv,
                         (cudaStream_t)stream));
}
