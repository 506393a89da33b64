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
// rows equal the plain versions' (solvers/vpfields.py) bit for bit.
//   K17 solves them on the split-line core (`VpFieldRows`,
//        csrc/field_rows.cuh; csrc/sweeps.cu explains the method): r on
//        the core's strided kernel (K7's layout), z on the staged kernel of
//        csrc/split_staged.cuh (K19's layout: five streams staged with
//        cp.async, a warp a line; lines past their staging on the strided
//        kernel along z; glo and ghi staged once a block).  The split
//        solve is not Thomas order and takes the hardware reciprocal at
//        float32 (divisions at float64): a few float32 ulp of the output's
//        scale from the plain version; at float32 stiff blocks are solved
//        again in Thomas order, as K21's (csrc/field_rows.cuh).
//   K18 repeats cyclic_thomas one rounding at a time (atf::CyclicSolve,
//        shared with K22), bit for bit its plain version.
//
// What bounds them on the H100: memory.  The byte model (float32) reads
// five streams (20) and writes x (4): 24 B/cell.
//   K17: nothing else below its shared-memory lengths.
//   K18: one thread per (r, z) pencil, coalesced over z; c', y and z of the
//        double solve in global memory.
#include "field_rows.cuh"

namespace {

using atf::add;
using atf::mul;

template <typename T>
__global__ void __launch_bounds__(128) vp_fields_cyclic_phi_kernel(
    const T* __restrict__ rhs, const T* __restrict__ flo,
    const T* __restrict__ dw, const T* __restrict__ sink,
    const T* __restrict__ srhs, const T* __restrict__ geo,
    T* __restrict__ out, T* __restrict__ cpbuf, T* __restrict__ zbuf,
    int64_t B1, int64_t n, int64_t B2) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B1 * B2) return;
  const int64_t b1 = p / B2;
  const int64_t base = b1 * n * B2 + (p - b1 * B2);
  const T g = __ldg(geo + b1);

  const T f_first = flo[base];
  T f_next = f_first;
  atf::CyclicSolve<T> solve(n, out, cpbuf, zbuf);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    const T f_lo = f_next;
    f_next = (i + 1 < n) ? flo[off + B2] : f_first;
    const T f_hi = f_next;
    const T w = dw[off];
    const T al = mul(w, mul(g, f_lo));
    const T ch = mul(w, mul(g, f_hi));
    const T b = add(T(1), mul(w, add(mul(g, add(f_lo, f_hi)), sink[off])));
    solve.row(i, off, -al, b, -ch, add(rhs[off], mul(w, srhs[off])));
  }
  solve.finish(base, B2);
}

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

template <typename T>
void launch_vp_fields_cyclic_phi(const void* rhs, const void* flo,
                                 const void* dw, const void* sink,
                                 const void* srhs, const void* geo, void* out,
                                 void* cpbuf, void* zbuf, int64_t B1,
                                 int64_t n, int64_t B2,
                                 cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = atf::cdiv(B1 * B2, threads);
  vp_fields_cyclic_phi_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(flo),
      static_cast<const T*>(dw), static_cast<const T*>(sink),
      static_cast<const T*>(srhs), static_cast<const T*>(geo),
      static_cast<T*>(out), static_cast<T*>(cpbuf), static_cast<T*>(zbuf),
      B1, n, B2);
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
                                     const void* geo, void* out, void* cpbuf,
                                     void* zbuf, int64_t B1, int64_t n,
                                     int64_t B2, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_vp_fields_cyclic_phi<T>(rhs, flo, dw, sink, srhs, geo,
                                              out, cpbuf, zbuf, B1, n, B2,
                                              (cudaStream_t)stream));
}
