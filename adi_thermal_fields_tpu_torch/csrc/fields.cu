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
// K21 runs the split-line core (csrc/split_line.cuh; csrc/sweeps.cu
// explains the method) on its rows as given (`FieldRows`,
// csrc/field_rows.cuh): the strided entry on the core's strided kernel
// (K7's layout: a warp's lanes are 32 lines adjacent in B2, so every row
// load is coalesced; the block's warps split the lines' chunks), the z
// entry on the staged kernel of csrc/split_staged.cuh (K19's layout: a, b,
// c and d staged with cp.async, a warp a line, lines past their staging on
// the strided kernel along z).  The split solve is not Thomas order and
// takes the hardware reciprocal at float32 (divisions at float64): a few
// float32 ulp of the output's scale from the plain version
// (chip_smoke.py KERNEL_TOL_ULP = 8); at float32 the lines of a block with
// a row past the stiffness ratio are solved again in Thomas order, bit for
// bit (csrc/field_rows.cuh; the z entry flags them in the caller's byte a
// line and a second kernel replays them).  K22 repeats cyclic_thomas one
// IEEE rounding at a time, bit for bit its plain version.
//
// What bounds them on the H100: memory -- read a, b, c, d (16) and write x
// (4): 20 B/cell (float32).  K21 moves nothing else below its shared-memory
// lengths; K22 one thread to each pencil (threads adjacent in B2 read
// adjacent addresses), c', y and z of the double solve in global scratch
// (~+36).
#include "field_rows.cuh"

namespace {

template <typename T>
FieldRows<T> field_rows(const void* a, const void* b, const void* c,
                        const void* d) {
  return FieldRows<T>{static_cast<const T*>(d),
                      {static_cast<const T*>(a), static_cast<const T*>(b),
                       static_cast<const T*>(c)}};
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
                                       const void* d, void* out, int64_t B1,
                                       int64_t n, int64_t B2, void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_split_strided<T, FieldRows<T>>(
                   field_rows<T>(a, b, c, d), static_cast<T*>(out), B1, n,
                   B2, 1, B2, device, (cudaStream_t)stream))));
}

ATF_API int atf_tridiag_fields_z(int dtype, int device, const void* a,
                                 const void* b, const void* c, const void* d,
                                 void* out, void* flags, int64_t npen,
                                 int64_t n, void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_split_staged<T, FieldRows<T>>(
                   field_rows<T>(a, b, c, d), static_cast<T*>(out),
                   static_cast<uint8_t*>(flags), npen, n, device,
                   (cudaStream_t)stream))));
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
