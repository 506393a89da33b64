// K17 and K18: the five-stream variable-property sweeps of the cylindrical
// step (Douglas-Gunn, and backward Euler with property callables).
//
// K17 replaces adi_thermal_fields_tpu/solvers/pallas_vpfields.py
//     fused_vp_fields_sweep (:190; pipelined site :273 with body
//     _vp_fields_pipe_kernel :628, streaming site :324 with body
//     _vp_fields_kernel :53, which compute the same thing): the open solve
//     along axis 0 of C-contiguous (n, B) streams -- r of the natural
//     (r, phi, z) field, and z on its (z, r, phi) permutation.
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
// and K18's wrap couplings enter by Sherman-Morrison (atf::CyclicSolve,
// shared with K22).  Each kernel repeats its plain version
// (solvers/vpfields.py, then thomas / cyclic_thomas) one IEEE rounding at a
// time with the _rn helpers.
//
// What bounds them on the H100: memory.  The byte model (float32) reads
// five streams (20) and writes x (4): 24 B/cell.
//   K17: one thread per pencil, every row load coalesced; c' in the output
//        and d' in a scratch field (+16 B/cell of global round trip).
//   K18: one thread per (r, z) pencil, coalesced over z; c', y and z of the
//        double solve in global memory, like K11.
#include "common.cuh"

namespace {

using atf::add;
using atf::div;
using atf::mul;
using atf::sub;

template <typename T>
__global__ void __launch_bounds__(256) vp_fields_sweep_strided_kernel(
    const T* __restrict__ rhs, const T* __restrict__ fhi,
    const T* __restrict__ dw, const T* __restrict__ sink,
    const T* __restrict__ srhs, const T* __restrict__ glo,
    const T* __restrict__ ghi, T* __restrict__ out, T* __restrict__ dpbuf,
    int64_t n, int64_t B) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  T cp = T(0), dp = T(0), f_lo = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = i * B + p;
    const T f_hi = fhi[off];
    const T w = dw[off];
    const T al = mul(__ldg(glo + i), f_lo);
    const T ch = mul(__ldg(ghi + i), f_hi);
    const T a = mul(-w, al);
    const T c = mul(-w, ch);
    const T b = add(T(1), mul(w, add(add(al, ch), sink[off])));
    const T d = add(rhs[off], mul(w, srhs[off]));
    const T denom = sub(b, mul(a, cp));
    cp = div(c, denom);
    dp = div(sub(d, mul(a, dp)), denom);
    out[off] = cp;
    dpbuf[off] = dp;
    f_lo = f_hi;
  }
  T x = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = i * B + p;
    x = sub(dpbuf[off], mul(out[off], x));
    out[off] = x;
  }
}

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
void launch_vp_fields_sweep_strided(const void* rhs, const void* fhi,
                                    const void* dw, const void* sink,
                                    const void* srhs, const void* glo,
                                    const void* ghi, void* out,
                                    void* scratch, int64_t n, int64_t B,
                                    cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(B, threads);
  vp_fields_sweep_strided_kernel<T><<<(unsigned)blocks, threads, 0,
                                      stream>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(fhi),
      static_cast<const T*>(dw), static_cast<const T*>(sink),
      static_cast<const T*>(srhs), static_cast<const T*>(glo),
      static_cast<const T*>(ghi), static_cast<T*>(out),
      static_cast<T*>(scratch), n, B);
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
                                        void* scratch, int64_t n, int64_t B,
                                        void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_vp_fields_sweep_strided<T>(rhs, fhi, dw, sink, srhs,
                                                 glo, ghi, out, scratch, n,
                                                 B, (cudaStream_t)stream));
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
