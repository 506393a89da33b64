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
//     axis of a (B1, n, B2) view (phi of the natural cylindrical field;
//     any axis).  The wrap couplings are alpha = c[n-1] and beta = a[0]
//     with the gauge gamma = -b[0] (solvers/thomas.cyclic_thomas).  The
//     JAX wrapper pads the batch with identity systems and sets their
//     gamma to -1 (:335-337); nothing is padded here, and a real system
//     with b[0] = 0 is as singular in the gauge as it is in cyclic_thomas.
//
// Both take their rows as given from csrc/field_rows.cuh.  K21 runs the
// split-line core (csrc/split_line.cuh; csrc/sweeps.cu explains the
// method) with `FieldRows`: the strided entry on the core's strided
// kernel (K7's layout: a warp's lanes are 32 lines adjacent in B2, so
// every row load is coalesced; the block's warps split the lines'
// chunks), the z entry on the staged kernel of csrc/split_staged.cuh
// (K19's layout: a, b, c and d staged with cp.async, a warp a line, lines
// past their staging on the strided kernel along z); the hardware
// reciprocal at float32, divisions at float64.  K22 runs the periodic
// split-line kernel of csrc/split_cyclic.cuh with `FieldCyclicRows` (the
// same layout, Sherman-Morrison's second right-hand side in the reduced
// system only, rounded divisions); an axis with B2 = 1 (the last) leaves
// 31 lanes of each warp idle.  Neither is Thomas order: a few float32 ulp
// of the output's scale from the plain version (chip_smoke.py
// KERNEL_TOL_ULP = 8); at float32 the lines of a block with a row past the
// former's stiffness ratio (kOpenStiff, kCyclicFieldStiff) are solved
// again in Thomas order, bit for bit (the z entry flags them in the
// caller's byte a line and a second kernel replays them).
//
// What bounds them on the H100: memory -- read a, b, c, d (16) and write x
// (4): 20 B/cell (float32), nothing else below their shared-memory
// lengths.
#include "field_rows.cuh"

namespace {

template <typename T>
FieldRows<T> field_rows(const void* a, const void* b, const void* c,
                        const void* d) {
  return FieldRows<T>{static_cast<const T*>(d),
                      {static_cast<const T*>(a), static_cast<const T*>(b),
                       static_cast<const T*>(c)}};
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
                              void* out, int64_t B1, int64_t n, int64_t B2,
                              void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_split_cyclic<T>(
                   FieldCyclicRows<T>{static_cast<const T*>(a),
                                      static_cast<const T*>(b),
                                      static_cast<const T*>(c),
                                      static_cast<const T*>(d)},
                   static_cast<T*>(out), B1, n, B2, device,
                   (cudaStream_t)stream))));
}
