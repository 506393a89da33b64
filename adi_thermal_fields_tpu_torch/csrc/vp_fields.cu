// K17 and K18: the five-stream variable-property sweeps of the cylindrical
// step (Douglas-Gunn, and backward Euler with property callables).
//
// K17 replaces adi_thermal_fields_tpu/solvers/pallas_vpfields.py
//     fused_vp_fields_sweep (:190; pipelined site :273 with body
//     _vp_fields_pipe_kernel :628, streaming site :324 with body
//     _vp_fields_kernel :53, which compute the same thing): the open solve
//     along the middle axis of (B1, n, B2) streams (r of the natural (r,
//     phi, z) field as (1, nr, nphi*nz)) and, in a second entry, along the
//     contiguous last axis (z of the natural field; the JAX step solves z
//     on the (z, r, phi) transposes, JAX step/cylindrical_varprop.py:571).
// K18 replaces fused_vp_fields_cyclic_axis1 (:525, site :611, body
//     _vp_cyclic_axis1_kernel :342) with fhi=None: the PERIODIC solve along
//     axis 1 of (B1, n, B2) streams -- phi of the natural field, the hi
//     faces derived from the lo faces by periodicity.
//
// From the streams rhs, the face conductivity (K17: fhi, the lo face
// carried from the previous row; K18: flo, fhi[i] = flo[i+1 mod n]),
// dw = dt/(rho cp), sink and srhs, and the metric (K17: per-row glo/ghi;
// K18: one geo per ring), row i is
//   K17: al = glo*f_lo; ch = ghi*f_hi; a = -dw*al; c = -dw*ch;
//        b = 1 + dw*(al + ch + sink); d = rhs + dw*srhs
//   K18: al = dw*(geo*flo); ch = dw*(geo*fhi); a = -al; c = -ch;
//        b = 1 + dw*(geo*(flo + fhi) + sink); d = rhs + dw*srhs
// one IEEE rounding per operation in the plain version's order, so the
// rows equal the plain versions' (solvers/vpfields.py) bit for bit; the
// row formers are in csrc/field_rows.cuh (`VpFieldRows`,
// `VpFieldCyclicRows`).  Both solve them split across threads, so neither
// is Thomas order: a few float32 ulp of the output's scale from the plain
// versions, and at float32 the lines of a block with a row past the
// former's stiffness ratio are solved again in Thomas order, bit for bit.
//   K17 on the split-line core (csrc/split_line.cuh; csrc/sweeps.cu
//        explains the method): r on the core's strided kernel (K7's
//        layout), z on the staged kernel of csrc/split_staged.cuh (K19's
//        layout: five streams staged with cp.async, a warp a line; lines
//        past their staging on the strided kernel along z; glo and ghi
//        staged once a block); the hardware reciprocal at float32,
//        divisions at float64; stiff past kOpenStiff.
//   K18 on the periodic split-line kernel of csrc/split_cyclic.cuh (K11's
//        and K16's: K7's layout, Sherman-Morrison's second right-hand side
//        in the reduced system only, rounded divisions); stiff past
//        kCyclicFieldStiff, shared with K22.
//
// What bounds them on the H100: memory.  The byte model (float32) reads
// five streams (20) and writes x (4): 24 B/cell, and neither moves anything
// else below its shared-memory lengths (K17's z one flag byte a line).
#include "field_rows.cuh"

namespace {

template <typename T>
VpFieldRows<T> vp_field_rows(const void* rhs, const void* fhi,
                             const void* dw, const void* sink,
                             const void* srhs, const void* glo,
                             const void* ghi) {
  return VpFieldRows<T>{
      static_cast<const T*>(rhs),
      {static_cast<const T*>(fhi), static_cast<const T*>(dw),
       static_cast<const T*>(sink), static_cast<const T*>(srhs)},
      static_cast<const T*>(glo), static_cast<const T*>(ghi)};
}

}  // namespace

ATF_API int atf_vp_fields_sweep_strided(int dtype, int device,
                                        const void* rhs, const void* fhi,
                                        const void* dw, const void* sink,
                                        const void* srhs, const void* glo,
                                        const void* ghi, void* out,
                                        int64_t B1, int64_t n, int64_t B2,
                                        void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_split_strided<T, VpFieldRows<T>>(
                   vp_field_rows<T>(rhs, fhi, dw, sink, srhs, glo, ghi),
                   static_cast<T*>(out), B1, n, B2, 1, B2, device,
                   (cudaStream_t)stream))));
}

ATF_API int atf_vp_fields_sweep_z(int dtype, int device, const void* rhs,
                                  const void* fhi, const void* dw,
                                  const void* sink, const void* srhs,
                                  const void* glo, const void* ghi,
                                  void* out, void* flags, int64_t npen,
                                  int64_t n, void* stream) {
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_split_staged<T, VpFieldRows<T>>(
                   vp_field_rows<T>(rhs, fhi, dw, sink, srhs, glo, ghi),
                   static_cast<T*>(out), static_cast<uint8_t*>(flags), npen,
                   n, device, (cudaStream_t)stream))));
}

ATF_API int atf_vp_fields_cyclic_phi(int dtype, int device, const void* rhs,
                                     const void* flo, const void* dw,
                                     const void* sink, const void* srhs,
                                     const void* geo, void* out, int64_t B1,
                                     int64_t n, int64_t B2, void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_split_cyclic<T>(
                   VpFieldCyclicRows<T>{static_cast<const T*>(rhs),
                                        static_cast<const T*>(flo),
                                        static_cast<const T*>(dw),
                                        static_cast<const T*>(sink),
                                        static_cast<const T*>(srhs),
                                        static_cast<const T*>(geo)},
                   static_cast<T*>(out), B1, n, B2, device,
                   (cudaStream_t)stream))));
}
