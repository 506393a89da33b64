// K5: the variable-property fields pass.
//
// Replaces adi_thermal_fields_tpu/solvers/pallas_varprop.py varprop_fields
// (:1274), body _vp_fields_kernel (:1223): from T and the uint8 mask, in
// the natural (x, y, z) layout,
//   fx[i] = harm(k(T[i-1]), k(T[i])) * m[i-1] * m[i]   (0 at the low edge;
//   fy, fz likewise along y and z), w = 1/(rho*cp(T)),
//   h = eps*sigma*(Tk+Tik)(Tk^2+Tik^2) + h_conv       (optional),
// with k and cp clamp-sum tables (varprop.cuh).
//
// What bounds it on the H100: memory -- read T (4 B) + mask (1 B), write
// fx, fy, fz, w (16 B) [+ h (4 B)] = 21/25 B/cell for float32.  Design:
// one thread per cell, threads adjacent in z (coalesced).  The TPU kernel
// carries the previous x-plane's k in VMEM; here each thread re-evaluates
// k at its x-1, y-1 and z-1 neighbours instead (a few FMAs per segment --
// cheaper than a plane carry across blocks); the neighbour loads hit
// L1/L2.  Neighbour k is evaluated only where both cells are in-mask.
#include "varprop.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) varprop_fields_kernel(
    const T* __restrict__ Tf, const uint8_t* __restrict__ mask,
    T* __restrict__ fx, T* __restrict__ fy, T* __restrict__ fz,
    T* __restrict__ w, T* __restrict__ h, int64_t nx, int64_t ny,
    int64_t nz, const __grid_constant__ atf::Table<T> ktab,
    const __grid_constant__ atf::Table<T> ctab, T rho, T rc, T tik, T tik2,
    T hconv) {
  const int64_t plane = ny * nz;
  const int64_t ncell = nx * plane;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < ncell; idx += stride) {
    const int64_t i = idx / plane;
    const int64_t jk = idx - i * plane;
    const int64_t j = jk / nz;
    const int64_t k = jk - j * nz;
    const T t = Tf[idx];
    const bool m = mask[idx] != 0;
    const T kc = atf::clamp_sum(ktab, t);
    w[idx] = T(1) / (rho * atf::clamp_sum(ctab, t));
    if (h != nullptr) h[idx] = atf::rad_film(t, rc, tik, tik2) + hconv;
    T f = T(0);
    if (m && i > 0 && mask[idx - plane] != 0) {
      f = atf::harm(atf::clamp_sum(ktab, Tf[idx - plane]), kc);
    }
    fx[idx] = f;
    f = T(0);
    if (m && j > 0 && mask[idx - nz] != 0) {
      f = atf::harm(atf::clamp_sum(ktab, Tf[idx - nz]), kc);
    }
    fy[idx] = f;
    f = T(0);
    if (m && k > 0 && mask[idx - 1] != 0) {
      f = atf::harm(atf::clamp_sum(ktab, Tf[idx - 1]), kc);
    }
    fz[idx] = f;
  }
}

template <typename T>
void launch_varprop_fields(const void* Tf, const void* mask, void* fx,
                           void* fy, void* fz, void* w, void* h, int64_t nx,
                           int64_t ny, int64_t nz, const double* ktab,
                           int kn, const double* ctab, int cn, double rho,
                           double rc, double tik, double tik2, double hconv,
                           cudaStream_t stream) {
  atf::Table<T> kt, ct;
  atf::make_table(ktab, kn, &kt);
  atf::make_table(ctab, cn, &ct);
  const int threads = 256;
  const int64_t blocks =
      atf::imin(atf::cdiv(nx * ny * nz, threads), (int64_t)1 << 20);
  varprop_fields_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(Tf), static_cast<const uint8_t*>(mask),
      static_cast<T*>(fx), static_cast<T*>(fy), static_cast<T*>(fz),
      static_cast<T*>(w), static_cast<T*>(h), nx, ny, nz, kt, ct, (T)rho,
      (T)rc, (T)tik, (T)tik2, (T)hconv);
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
  ATF_DISPATCH(dtype, device,
               launch_varprop_fields<T>(Tf, mask, fx, fy, fz, w, h, nx, ny,
                                        nz, ktab, kn, ctab, cn, rho, rc, tik,
                                        tik2, hconv, (cudaStream_t)stream));
}
