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
// (4 B) = 9 B/cell for float32, 5 for bfloat16; the six neighbour reads
// hit L1/L2.  Design: one thread per cell, threads adjacent in z, so the
// centre, y and x neighbour loads are coalesced and the z neighbours are
// the same lines shifted by one element.  No shared-memory tiling in this
// first version.
#include "common.cuh"

namespace {

template <typename S, typename C>
__global__ void __launch_bounds__(256) theta_rhs_kernel(
    const S* __restrict__ Tf, const uint8_t* __restrict__ mask,
    S* __restrict__ out, int64_t nx, int64_t ny, int64_t nz, C c, C iv_x,
    C iv_y, C iv_z, int64_t key) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = ny * nz;
  if (idx >= nx * plane) return;
  const int64_t i = idx / plane;
  const int64_t jk = idx - i * plane;
  const int64_t j = jk / nz;
  const int64_t k = jk - j * nz;

  const C Tc = atf::ld(Tf + idx);
  const C Mc = mask[idx] ? C(1) : C(0);

  // neighbour (mask, value): zero beyond the domain edge
  C ml = C(0), mh = C(0), tl = C(0), th = C(0);
  if (i > 0) {
    ml = mask[idx - plane] ? C(1) : C(0);
    tl = atf::ld(Tf + idx - plane);
  }
  if (i < nx - 1) {
    mh = mask[idx + plane] ? C(1) : C(0);
    th = atf::ld(Tf + idx + plane);
  }
  const C sx = ml * tl + mh * th;
  C acc = (sx - (ml + mh) * Tc) * iv_x;

  ml = mh = tl = th = C(0);
  if (j > 0) {
    ml = mask[idx - nz] ? C(1) : C(0);
    tl = atf::ld(Tf + idx - nz);
  }
  if (j < ny - 1) {
    mh = mask[idx + nz] ? C(1) : C(0);
    th = atf::ld(Tf + idx + nz);
  }
  const C sy = ml * tl + mh * th;
  acc = acc + (sy - (ml + mh) * Tc) * iv_y;

  ml = mh = tl = th = C(0);
  if (k > 0) {
    ml = mask[idx - 1] ? C(1) : C(0);
    tl = atf::ld(Tf + idx - 1);
  }
  if (k < nz - 1) {
    mh = mask[idx + 1] ? C(1) : C(0);
    th = atf::ld(Tf + idx + 1);
  }
  const C sz = ml * tl + mh * th;
  acc = acc + (sz - (ml + mh) * Tc) * iv_z;

  atf::st(out + idx, Tc + (c * Mc) * acc, key, idx);
}

template <typename S, typename C>
void launch_theta_rhs(const void* Tf, const void* mask, void* out,
                      int64_t nx, int64_t ny, int64_t nz, double c,
                      double iv_x, double iv_y, double iv_z, int64_t key,
                      cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(nx * ny * nz, threads);
  theta_rhs_kernel<S, C><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const S*>(Tf), static_cast<const uint8_t*>(mask),
      static_cast<S*>(out), nx, ny, nz, (C)c, (C)iv_x, (C)iv_y, (C)iv_z,
      key);
}

}  // namespace

ATF_API int atf_theta_rhs(int dtype, int device, const void* Tf,
                          const void* mask, void* out, int64_t nx,
                          int64_t ny, int64_t nz, double c, double iv_x,
                          double iv_y, double iv_z, int64_t key,
                          void* stream) {
  ATF_DISPATCH_STATE(dtype, device,
                     launch_theta_rhs<S, C>(Tf, mask, out, nx, ny, nz, c,
                                            iv_x, iv_y, iv_z, key,
                                            (cudaStream_t)stream));
}
