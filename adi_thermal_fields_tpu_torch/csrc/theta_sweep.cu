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
// (neighbouring pencils re-read each other's lines through L1/L2).  c' and
// d' are kept in scratch tensors of the compute type, as in K1; a bfloat16
// T is read widened, solved at float32 and U stored rounded to nearest or
// stochastically (common.cuh).
#include "common.cuh"

namespace {

template <typename S, typename C>
__global__ void __launch_bounds__(256) theta_sweep_kernel(
    const S* __restrict__ Tf, const uint8_t* __restrict__ code,
    S* __restrict__ out, C* __restrict__ cpbuf, C* __restrict__ dpbuf,
    int64_t nx, int64_t ny, int64_t nz, C c_exp, C iv_x, C iv_y, C iv_z,
    C tg, C dt, C t_inf, C rob_c, int64_t key) {
  const int64_t plane = ny * nz;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;

  C cp = C(0), dp = C(0);
  C t_lo = C(0);               // T at x-1 (0 before the first row)
  C t_c = atf::ld(Tf + p);     // T at x
  for (int64_t i = 0; i < nx; ++i) {
    const int64_t off = i * plane + p;
    const C t_hi = (i + 1 < nx) ? atf::ld(Tf + off + plane) : C(0);
    const unsigned c = code[off];
    const C low = atf::bit<C>(c, atf::kLow);
    const C high = atf::bit<C>(c, atf::kHigh);
    const C inm = atf::bit<C>(c, atf::kInMask);

    // explicit theta pass: x, then y, then z (a set bit implies the
    // neighbour is inside the domain)
    const C sx = low * t_lo + high * t_hi;
    C acc = (sx - (low + high) * t_c) * iv_x;
    const C m_ylo = atf::bit<C>(c, atf::kNb1Lo);
    const C m_yhi = atf::bit<C>(c, atf::kNb1Hi);
    const C t_ylo = (c & atf::kNb1Lo) ? atf::ld(Tf + off - nz) : C(0);
    const C t_yhi = (c & atf::kNb1Hi) ? atf::ld(Tf + off + nz) : C(0);
    const C sy = m_ylo * t_ylo + m_yhi * t_yhi;
    acc = acc + (sy - (m_ylo + m_yhi) * t_c) * iv_y;
    const C m_zlo = atf::bit<C>(c, atf::kNb2Lo);
    const C m_zhi = atf::bit<C>(c, atf::kNb2Hi);
    const C t_zlo = (c & atf::kNb2Lo) ? atf::ld(Tf + off - 1) : C(0);
    const C t_zhi = (c & atf::kNb2Hi) ? atf::ld(Tf + off + 1) : C(0);
    const C sz = m_zlo * t_zlo + m_zhi * t_zhi;
    acc = acc + (sz - (m_zlo + m_zhi) * t_c) * iv_z;
    const C d = t_c + (c_exp * inm) * acc;

    // plan-lite sweep row (as K1 in lite mode)
    const C cf = rob_c * ((C(2) - low - high) * inm);
    const C a = -tg * low;
    const C cc = -tg * high;
    const C dtcf = dt * cf;
    const C b = C(1) + tg * (low + high) + dtcf;
    const C dd = d + dtcf * t_inf;
    const C inv = C(1) / (b - a * cp);
    cp = cc * inv;
    dp = (dd - a * dp) * inv;
    cpbuf[off] = cp;
    dpbuf[off] = dp;

    t_lo = t_c;
    t_c = t_hi;
  }
  C x = C(0);
  for (int64_t i = nx - 1; i >= 0; --i) {
    const int64_t off = i * plane + p;
    x = dpbuf[off] - cpbuf[off] * x;
    atf::st(out + off, x, key, off);
  }
}

template <typename S, typename C>
void launch_theta_sweep(const void* Tf, const void* code, void* out,
                        void* cpbuf, void* dpbuf, int64_t nx, int64_t ny,
                        int64_t nz, double c_exp, double iv_x, double iv_y,
                        double iv_z, double tg, double dt, double t_inf,
                        double rob_c, int64_t key, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(ny * nz, threads);
  theta_sweep_kernel<S, C><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const S*>(Tf), static_cast<const uint8_t*>(code),
      static_cast<S*>(out), static_cast<C*>(cpbuf), static_cast<C*>(dpbuf),
      nx, ny, nz, (C)c_exp, (C)iv_x, (C)iv_y, (C)iv_z, (C)tg, (C)dt,
      (C)t_inf, (C)rob_c, key);
}

}  // namespace

ATF_API int atf_theta_sweep(int dtype, int device, const void* Tf,
                            const void* code, void* out, void* cpbuf,
                            void* dpbuf, int64_t nx, int64_t ny, int64_t nz,
                            double c_exp, double iv_x, double iv_y,
                            double iv_z, double tg, double dt, double t_inf,
                            double rob_c, int64_t key, void* stream) {
  ATF_DISPATCH_STATE(dtype, device,
                     launch_theta_sweep<S, C>(
                         Tf, code, out, cpbuf, dpbuf, nx, ny, nz, c_exp,
                         iv_x, iv_y, iv_z, tg, dt, t_inf, rob_c, key,
                         (cudaStream_t)stream));
}
