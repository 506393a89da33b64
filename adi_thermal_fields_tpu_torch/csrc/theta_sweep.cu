// K4: the explicit theta-pass stencil fused into the plan-lite x-sweep.
//
// Replaces adi_thermal_fields_tpu/solvers/pallas_theta_sweep.py
// fused_theta_sweep_axis0 (:454): the ring-buffer kernel _theta_sweep_ring
// (:551, body :249) and the halo-DMA kernel (body :54) compute the same
// function.
//   U = A_x^{-1} [ (I + c_exp L) T + dt*cf*t_inf ]
// with L the mask-aware Laplacian and A_x the plan-lite masked tridiagonal
// along x.  The neighbour masks come from the x-sweep code of
// sweep_code(stencil_bits=True): bits 1/2 = x-1/x+1 coupling, 8 = in-mask,
// 16/32 = y-1/y+1, 64/128 = z-1/z+1 -- no mask array is read.  The stencil
// terms accumulate x, then y, then z, as in K3, and feed the recurrence
// directly: R0 never reaches device memory.
//
// What bounds it on the H100: memory.  Design: K1's thread-per-(y, z)-pencil
// march along x.  The pencil's own x-1, x and x+1 values stay in registers;
// the y+-1 and z+-1 values are read from global memory, coalesced along z
// (neighbouring pencils re-read each other's lines through L1/L2).  c' is
// kept in the output buffer and d' in a scratch tensor, as in K1.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) theta_sweep_kernel(
    const T* __restrict__ Tf, const uint8_t* __restrict__ code,
    T* __restrict__ out, T* __restrict__ dpbuf, int64_t nx, int64_t ny,
    int64_t nz, T c_exp, T iv_x, T iv_y, T iv_z, T tg, T dt, T t_inf,
    T rob_c) {
  const int64_t plane = ny * nz;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;

  T cp = T(0), dp = T(0);
  T t_lo = T(0);          // T at x-1 (0 before the first row)
  T t_c = Tf[p];          // T at x
  for (int64_t i = 0; i < nx; ++i) {
    const int64_t off = i * plane + p;
    const T t_hi = (i + 1 < nx) ? Tf[off + plane] : T(0);
    const unsigned c = code[off];
    const T low = atf::bit<T>(c, atf::kLow);
    const T high = atf::bit<T>(c, atf::kHigh);
    const T inm = atf::bit<T>(c, atf::kInMask);

    // explicit theta pass: x, then y, then z (a set bit implies the
    // neighbour is inside the domain)
    const T sx = low * t_lo + high * t_hi;
    T acc = (sx - (low + high) * t_c) * iv_x;
    const T m_ylo = atf::bit<T>(c, atf::kNb1Lo);
    const T m_yhi = atf::bit<T>(c, atf::kNb1Hi);
    const T t_ylo = (c & atf::kNb1Lo) ? Tf[off - nz] : T(0);
    const T t_yhi = (c & atf::kNb1Hi) ? Tf[off + nz] : T(0);
    const T sy = m_ylo * t_ylo + m_yhi * t_yhi;
    acc = acc + (sy - (m_ylo + m_yhi) * t_c) * iv_y;
    const T m_zlo = atf::bit<T>(c, atf::kNb2Lo);
    const T m_zhi = atf::bit<T>(c, atf::kNb2Hi);
    const T t_zlo = (c & atf::kNb2Lo) ? Tf[off - 1] : T(0);
    const T t_zhi = (c & atf::kNb2Hi) ? Tf[off + 1] : T(0);
    const T sz = m_zlo * t_zlo + m_zhi * t_zhi;
    acc = acc + (sz - (m_zlo + m_zhi) * t_c) * iv_z;
    const T d = t_c + (c_exp * inm) * acc;

    // plan-lite sweep row (as K1 in lite mode)
    const T cf = rob_c * ((T(2) - low - high) * inm);
    const T a = -tg * low;
    const T cc = -tg * high;
    const T dtcf = dt * cf;
    const T b = T(1) + tg * (low + high) + dtcf;
    const T dd = d + dtcf * t_inf;
    const T inv = T(1) / (b - a * cp);
    cp = cc * inv;
    dp = (dd - a * dp) * inv;
    out[off] = cp;
    dpbuf[off] = dp;

    t_lo = t_c;
    t_c = t_hi;
  }
  T x = T(0);
  for (int64_t i = nx - 1; i >= 0; --i) {
    const int64_t off = i * plane + p;
    x = dpbuf[off] - out[off] * x;
    out[off] = x;
  }
}

template <typename T>
void launch_theta_sweep(const void* Tf, const void* code, void* out,
                        void* scratch, int64_t nx, int64_t ny, int64_t nz,
                        double c_exp, double iv_x, double iv_y, double iv_z,
                        double tg, double dt, double t_inf, double rob_c,
                        cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(ny * nz, threads);
  theta_sweep_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(Tf), static_cast<const uint8_t*>(code),
      static_cast<T*>(out), static_cast<T*>(scratch), nx, ny, nz, (T)c_exp,
      (T)iv_x, (T)iv_y, (T)iv_z, (T)tg, (T)dt, (T)t_inf, (T)rob_c);
}

}  // namespace

ATF_API int atf_theta_sweep(int dtype, int device, const void* Tf,
                            const void* code, void* out, void* scratch,
                            int64_t nx, int64_t ny, int64_t nz, double c_exp,
                            double iv_x, double iv_y, double iv_z, double tg,
                            double dt, double t_inf, double rob_c,
                            void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_theta_sweep<T>(Tf, code, out, scratch, nx, ny, nz,
                                     c_exp, iv_x, iv_y, iv_z, tg, dt, t_inf,
                                     rob_c, (cudaStream_t)stream));
}
