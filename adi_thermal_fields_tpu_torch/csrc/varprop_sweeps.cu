// K6, K7 and K20: the variable-property passes that read prebuilt face
// streams.
//
// K6 replaces adi_thermal_fields_tpu/solvers/pallas_varprop.py
//    fused_varprop_theta_sweep (:1066), body _vp_ring_kernel (:821): the
//    explicit varprop theta pass fused into the x sweep,
//      d = T + (cw*w*inm) * sum_ax iv_ax*(f_lo*(T_lo - T) + f_hi*(T_hi - T))
//          [+ (cd*w*inm) * src],
//    faces x, then y, then z (the _vp_rhs_kernel order, :403-462), with
//    f_lo = fc[i] and f_hi = fc[i+1] (zero past the domain edge).
// K7 replaces pallas_varprop.py fused_varprop_sweep_axis1 (:718), body
//    _varprop_kernel_axis1 (:560): the sweep along the STRIDED y axis of
//    the natural field, viewed as (B1, n, B2) = (nx, ny, nz).  Its x entry
//    ("K7x") takes x as (1, nx, ny*nz): the solve-leading form of
//    fused_varprop_sweep (:251, body _varprop_kernel :60), the same rows.
// K20 replaces pallas_varprop.py varprop_theta_rhs (:471), body
//    _vp_rhs_kernel (:403): K6's explicit pass alone, R0 = d, with the
//    in-mask factor read from a uint8 mask.  Like the reference it leaves
//    the Robin flux out of R0 (the films enter the implicit rows only).
//
// Row system (K6, K7): atf::vp_row_coeffs (varprop.cuh), code bits 1/2/8
// of sweep_code (plain bits, no stencil bits: the faces carry the
// masking), h a per-cell film stream or the scalar rob_c; one IEEE
// rounding per operation in the plain versions' order (solvers/varprop.py),
// so the rows equal the plain version's bit for bit.  With tw, w and the
// faces >= 0 the rows are strictly diagonally dominant (b >= 1 + |a| + |c|).
//
// What bounds them on the H100: memory.  Traffic (float32): K6 reads T (4,
// the y/z neighbours through L1/L2) + code (1) + fx/fy/fz/w (16) [+ h 4]
// [+ src 4] and writes U (4): 25-33 B/cell; K7 reads rhs + code + fc + w
// [+ h] and writes x: 17-21 B/cell.  K20 marches along x like K6 (T and fx
// carried in registers) and moves T + fx/fy/fz/w (20) + mask (1) [+ src 4]
// + R0 (4): 25-29 B/cell.
//   K6, K20 and K7x: one thread owns a pencil and reads fc[i+1] ahead,
//      carrying it to the next row as f_lo; threads adjacent in z read
//      adjacent addresses, so every row load is coalesced.  c' lives in the
//      output buffer and d' in a scratch tensor (+16 B/cell), and back
//      substitution overwrites c' with x; the Thomas recurrence repeats the
//      plain version bit for bit (atf::vp_row), which the unfused step's
//      K20 -> K7x must, to equal the fused K6 bit for bit.
//   K7: K1's layout on the split-line core (csrc/split_line.cuh,
//      `split_strided_kernel`; csrc/sweeps.cu explains the method): lanes
//      are 32 lines adjacent in z, the block's 32 warps (16 at float64)
//      split each line's chunks of 8 rows, each chunk's rows are formed
//      and eliminated in registers (a chunk of M rows reads fc at M + 1
//      rows), the reduced rows are solved on warp shuffles, and x is
//      written once; up to 512 rows a line at float32 (256 at float64) a
//      thread's first chunk waits, eliminated, in shared memory meanwhile,
//      so each input is read once.  c' and d' never reach global memory.
//      The first version ran K7x's pencil kernel on y (one thread a
//      pencil, IEEE divisions, c'/d' scratch).  The split solve is not
//      Thomas order and takes the hardware reciprocal at float32: a few
//      float32 ulp of the output's scale from the plain version
//      (chip_smoke.py KERNEL_TOL_ULP = 8); float64 divides.  Lines past
//      shared memory keep their reduced rows in a global buffer: no length
//      is refused.
#include "split_line.cuh"
#include "varprop.cuh"

namespace {

using atf::add;
using atf::mul;

// kRhsOnly: K20 (write R0, in-mask factor from the uint8 mask, no solve);
// else K6.
template <typename T, bool kRhsOnly>
__global__ void __launch_bounds__(256) vp_theta_sweep_kernel(
    const T* __restrict__ Tf, const uint8_t* __restrict__ code,
    const T* __restrict__ fx, const T* __restrict__ fy,
    const T* __restrict__ fz, const T* __restrict__ w,
    const T* __restrict__ h, const T* __restrict__ src,
    const uint8_t* __restrict__ mask, T* __restrict__ out,
    T* __restrict__ dpbuf, int64_t nx, int64_t ny, int64_t nz, T cw, T cd,
    T iv_x, T iv_y, T iv_z, T tg, T sk, T t_inf, T rob_c) {
  const int64_t plane = ny * nz;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int64_t j = p / nz;
  const int64_t k = p - j * nz;
  const bool has_ylo = j > 0, has_yhi = j + 1 < ny;
  const bool has_zlo = k > 0, has_zhi = k + 1 < nz;

  T cp = T(0), dp = T(0);
  T t_lo = T(0);              // T at x-1 (0 before the first row)
  T t_c = Tf[p];              // T at x
  T fx_lo = fx[p];            // face (x-1, x)
  for (int64_t i = 0; i < nx; ++i) {
    const int64_t off = i * plane + p;
    const bool has_xhi = i + 1 < nx;
    const T t_hi = has_xhi ? Tf[off + plane] : T(0);
    const T fx_hi = has_xhi ? fx[off + plane] : T(0);

    // explicit theta pass: x, then y, then z
    T acc = atf::vp_face_term(fx_lo, fx_hi, t_lo, t_hi, t_c, iv_x);
    acc = add(acc, atf::vp_face_term(
                       fy[off], has_yhi ? fy[off + nz] : T(0),
                       has_ylo ? Tf[off - nz] : T(0),
                       has_yhi ? Tf[off + nz] : T(0), t_c, iv_y));
    acc = add(acc, atf::vp_face_term(
                       fz[off], has_zhi ? fz[off + 1] : T(0),
                       has_zlo ? Tf[off - 1] : T(0),
                       has_zhi ? Tf[off + 1] : T(0), t_c, iv_z));
    const T wv = w[off];
    unsigned c = 0u;
    T inm;
    if constexpr (kRhsOnly) {
      inm = mask[off] ? T(1) : T(0);
    } else {
      c = code[off];
      inm = atf::bit<T>(c, atf::kInMask);
    }
    const T gain = mul(wv, inm);
    T d = add(t_c, mul(mul(cw, gain), acc));
    if (src != nullptr) d = add(d, mul(mul(cd, gain), src[off]));

    if constexpr (kRhsOnly) {
      out[off] = d;
    } else {
      atf::vp_row(c, fx_lo, fx_hi, wv, h != nullptr ? h[off] : rob_c, d,
                  tg, sk, t_inf, cp, dp);
      out[off] = cp;
      dpbuf[off] = dp;
    }

    t_lo = t_c;
    t_c = t_hi;
    fx_lo = fx_hi;
  }
  if constexpr (!kRhsOnly) {
    T x = T(0);
    for (int64_t i = nx - 1; i >= 0; --i) {
      const int64_t off = i * plane + p;
      x = atf::sub(dpbuf[off], mul(out[off], x));
      out[off] = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) vp_sweep_strided_kernel(
    const T* __restrict__ rhs, const uint8_t* __restrict__ code,
    const T* __restrict__ fc, const T* __restrict__ w,
    const T* __restrict__ h, T* __restrict__ out, T* __restrict__ dpbuf,
    int64_t B1, int64_t n, int64_t B2, T tg, T sk, T t_inf, T rob_c) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B1 * B2) return;
  const int64_t b1 = p / B2;
  const int64_t base = b1 * n * B2 + (p - b1 * B2);

  T cp = T(0), dp = T(0);
  T f_lo = fc[base];
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    const T f_hi = (i + 1 < n) ? fc[off + B2] : T(0);
    atf::vp_row(code[off], f_lo, f_hi, w[off],
                h != nullptr ? h[off] : rob_c, rhs[off], tg, sk, t_inf, cp,
                dp);
    out[off] = cp;
    dpbuf[off] = dp;
    f_lo = f_hi;
  }
  T x = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    x = atf::sub(dpbuf[off], mul(out[off], x));
    out[off] = x;
  }
}

// K7's rows for the core's strided kernel: f_hi = fc[i+1] is carried to
// the next row as f_lo.
template <typename T>
struct VpRows {
  const T* rhs;
  const uint8_t* code;
  const T* fc;
  const T* w;
  const T* h;
  T tg, sk, t_inf, rob_c;

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    T f_lo = (valid && row0 < n) ? __ldg(fc + base + row0 * rs) : T(0);
    ch.load_rows(
        [&](int k, T& a, T& b, T& c, T& d) {
          const int64_t i = row0 + k;
          if (!valid || i >= n) {
            a = c = d = T(0);
            b = T(1);
            return;
          }
          const int64_t off = base + i * rs;
          const T f_hi = (i + 1 < n) ? __ldg(fc + off + rs) : T(0);
          atf::vp_row_coeffs<T>(__ldg(code + off), f_lo, f_hi,
                                __ldg(w + off),
                                h != nullptr ? __ldg(h + off) : rob_c,
                                __ldg(rhs + off), tg, sk, t_inf, a, b, c, d);
          f_lo = f_hi;
        },
        row0, n);
  }
};

template <typename T, bool kRhsOnly>
void launch_vp_theta_sweep(const void* Tf, const void* code, const void* fx,
                           const void* fy, const void* fz, const void* w,
                           const void* h, const void* src, const void* mask,
                           void* out, void* scratch, int64_t nx, int64_t ny,
                           int64_t nz, double cw, double cd, double iv_x,
                           double iv_y, double iv_z, double tg, double sk,
                           double t_inf, double rob_c, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(ny * nz, threads);
  vp_theta_sweep_kernel<T, kRhsOnly><<<(unsigned)blocks, threads, 0,
                                       stream>>>(
      static_cast<const T*>(Tf), static_cast<const uint8_t*>(code),
      static_cast<const T*>(fx), static_cast<const T*>(fy),
      static_cast<const T*>(fz), static_cast<const T*>(w),
      static_cast<const T*>(h), static_cast<const T*>(src),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out),
      static_cast<T*>(scratch), nx, ny, nz, (T)cw, (T)cd, (T)iv_x, (T)iv_y,
      (T)iv_z, (T)tg, (T)sk, (T)t_inf, (T)rob_c);
}

template <typename T>
void launch_vp_sweep_strided(const void* rhs, const void* code,
                             const void* fc, const void* w, const void* h,
                             void* out, void* scratch, int64_t B1, int64_t n,
                             int64_t B2, double tg, double sk, double t_inf,
                             double rob_c, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(B1 * B2, threads);
  vp_sweep_strided_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(rhs), static_cast<const uint8_t*>(code),
      static_cast<const T*>(fc), static_cast<const T*>(w),
      static_cast<const T*>(h), static_cast<T*>(out),
      static_cast<T*>(scratch), B1, n, B2, (T)tg, (T)sk, (T)t_inf,
      (T)rob_c);
}

}  // namespace

ATF_API int atf_varprop_theta_sweep(
    int dtype, int device, const void* Tf, const void* code, const void* fx,
    const void* fy, const void* fz, const void* w, const void* h,
    const void* src, void* out, void* scratch, int64_t nx, int64_t ny,
    int64_t nz, double cw, double cd, double iv_x, double iv_y, double iv_z,
    double tg, double sk, double t_inf, double rob_c, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_vp_theta_sweep<T, false>(
                   Tf, code, fx, fy, fz, w, h, src, nullptr, out, scratch,
                   nx, ny, nz, cw, cd, iv_x, iv_y, iv_z, tg, sk, t_inf, rob_c,
                   (cudaStream_t)stream));
}

ATF_API int atf_varprop_theta_rhs(int dtype, int device, const void* Tf,
                                  const void* fx, const void* fy,
                                  const void* fz, const void* w,
                                  const void* mask, const void* src,
                                  void* out, int64_t nx, int64_t ny,
                                  int64_t nz, double cw, double cd,
                                  double iv_x, double iv_y, double iv_z,
                                  void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  ATF_DISPATCH(dtype, device,
               launch_vp_theta_sweep<T, true>(
                   Tf, nullptr, fx, fy, fz, w, nullptr, src, mask, out,
                   nullptr, nx, ny, nz, cw, cd, iv_x, iv_y, iv_z, 0.0, 0.0,
                   0.0, 0.0, (cudaStream_t)stream));
}

ATF_API int atf_varprop_sweep_y(int dtype, int device, const void* rhs,
                                const void* code, const void* fc,
                                const void* w, const void* h, void* out,
                                int64_t B1, int64_t n, int64_t B2, double tg,
                                double sk, double t_inf, double rob_c,
                                void* stream) {
  ATF_DISPATCH(
      dtype, device,
      ATF_RETURN_IF((launch_split_strided<T, VpRows<T>>(
          VpRows<T>{static_cast<const T*>(rhs),
                    static_cast<const uint8_t*>(code),
                    static_cast<const T*>(fc), static_cast<const T*>(w),
                    static_cast<const T*>(h), (T)tg, (T)sk, (T)t_inf,
                    (T)rob_c},
          static_cast<T*>(out), B1, n, B2, 1, B2, device,
          (cudaStream_t)stream))));
}

ATF_API int atf_varprop_sweep_strided(int dtype, int device, const void* rhs,
                                      const void* code, const void* fc,
                                      const void* w, const void* h,
                                      void* out, void* scratch, int64_t B1,
                                      int64_t n, int64_t B2, double tg,
                                      double sk, double t_inf, double rob_c,
                                      void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_vp_sweep_strided<T>(rhs, code, fc, w, h, out, scratch,
                                          B1, n, B2, tg, sk, t_inf, rob_c,
                                          (cudaStream_t)stream));
}
