// K6, K7, K7x and K20: the variable-property passes that read prebuilt
// face streams.
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
// Row system (K6, K7, K7x): atf::vp_row_coeffs (varprop.cuh), code bits
// 1/2/8 of sweep_code (plain bits, no stencil bits: the faces carry the
// masking), h a per-cell film stream or the scalar rob_c; one IEEE
// rounding per operation in the plain versions' order (solvers/varprop.py),
// so the rows equal the plain version's bit for bit.  With tw, w and the
// faces >= 0 the rows are strictly diagonally dominant (b >= 1 + |a| + |c|).
//
// What bounds them on the H100: memory.  Traffic (float32): K6 reads T (4,
// the y/z neighbours through L1/L2) + code (1) + fx/fy/fz/w (16) [+ h 4]
// [+ src 4] and writes U (4): 25-33 B/cell; K7 and K7x read rhs + code +
// fc + w [+ h] and write x: 17-21 B/cell.  K20 moves T + fx/fy/fz/w (20) +
// mask (1) [+ src 4] + R0 (4): 25-29 B/cell.
//   K6, K7 and K7x: K1's layout on the split-line core (csrc/split_line.cuh,
//      `split_strided_kernel`; csrc/sweeps.cu explains the method): lanes
//      are 32 lines adjacent in z (the pencils (y, z) of an x sweep, the
//      z columns of a y sweep), so every row load and store is coalesced;
//      the block's 32 warps (16 at float64) split each line's chunks of 8
//      rows, each chunk's rows are formed and eliminated in registers, the
//      reduced rows are solved on warp shuffles, and x is written once; up
//      to 512 rows a line at float32 (256 at float64) a thread's first
//      chunk waits, eliminated, in shared memory meanwhile, so each input
//      is read once.  c' and d' never reach global memory.  Lines past
//      shared memory keep their reduced rows in a global buffer taken and
//      freed on the stream: no length is refused.
//   K6's rows (`VpThetaRows`) form each right-hand side from the stencil,
//      as K4 does (csrc/theta_sweep.cu):
//        x+-1: the chunk's own rows, T and fx carried from row to row, plus
//              one halo row of T each side and fx at row0 + M;
//        z+-1: T and fz[k+1] from the neighbouring lanes by warp shuffle;
//              lanes 0 and 31 load their outer neighbour.  Lane b2 + 1 is
//              z + 1 only inside a y row: the shuffled values are selected
//              by k + 1 < nz (and k > 0), never multiplied by it;
//        y+-1: T at off -+ nz and fy[j+1] at off + nz, from L1/L2.
//      The code has plain bits only, so a neighbour's presence comes from
//      the domain edges and a face past an edge is 0.  The right-hand side
//      is K20's (atf::vp_theta_d, one rounding per operation), so K6 and
//      K20 -> K7x, whose lines the core cuts into the same chunks by the
//      same rule from (nx, dtype), agree bit for bit: the step's
//      fuse_theta=False equals its fused form.  Where the core keeps no
//      eliminated rows (float64 lines of 257-512 rows, float32 of
//      513-1,024), K6 keeps each row's right-hand side instead and forms
//      its rows again from it in phase (c), without the stencil's loads
//      (K7x forms them again from R0: the same rows).  The first K6
//      marched one thread along each pencil (a Thomas recurrence, c' and
//      d' through the output and a field-sized scratch, +16 B/cell), 256
//      blocks at 256^3 for 132 SMs, and so did K7 and K7x at first.  On
//      the H100 (PERF.md §6) the core's launch shape ran K6 fastest: 8,
//      16 or 24 warps a block, 4- or 16-row chunks, blocks in y-major
//      order, two 16-warp blocks an SM keeping right-hand sides and a
//      warp over 2 y x 16 z lines (its y neighbours by shuffle) were
//      4-50% slower at 512^3, streaming-load hints no faster; without its
//      three y-neighbour loads (T at y-1 and y+1, fy at y+1: L2 traffic
//      no lane shares) K6 ran 15% faster.
//   K20: one thread per (y, z) pencil marching along x, T and fx carried
//      in registers, threads adjacent in z reading adjacent addresses.
// Rounding: K20 repeats its plain version bit for bit.  The split solve
// is not Thomas order and takes the hardware reciprocal at float32: K6,
// K7 and K7x are a few float32 ulp of the output's scale from their plain
// versions (chip_smoke.py KERNEL_TOL_ULP = 8); float64 divides.
#include "vp_rows.cuh"

namespace {

using atf::add;
using atf::mul;

// K20: R0 with the in-mask factor from the uint8 mask.
template <typename T>
__global__ void __launch_bounds__(256) vp_theta_rhs_kernel(
    const T* __restrict__ Tf, const T* __restrict__ fx,
    const T* __restrict__ fy, const T* __restrict__ fz,
    const T* __restrict__ w, const T* __restrict__ src,
    const uint8_t* __restrict__ mask, T* __restrict__ out, int64_t nx,
    int64_t ny, int64_t nz, T cw, T cd, T iv_x, T iv_y, T iv_z) {
  const int64_t plane = ny * nz;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int64_t j = p / nz;
  const int64_t k = p - j * nz;
  const bool has_ylo = j > 0, has_yhi = j + 1 < ny;
  const bool has_zlo = k > 0, has_zhi = k + 1 < nz;

  T t_lo = T(0);              // T at x-1 (0 before the first row)
  T t_c = Tf[p];              // T at x
  T fx_lo = fx[p];            // face (x-1, x)
  for (int64_t i = 0; i < nx; ++i) {
    const int64_t off = i * plane + p;
    const bool has_xhi = i + 1 < nx;
    const T t_hi = has_xhi ? Tf[off + plane] : T(0);
    const T fx_hi = has_xhi ? fx[off + plane] : T(0);
    const T gain = mul(w[off], mask[off] ? T(1) : T(0));
    T d = atf::vp_theta_d(
        t_c, fx_lo, fx_hi, t_lo, t_hi, fy[off],
        has_yhi ? fy[off + nz] : T(0), has_ylo ? Tf[off - nz] : T(0),
        has_yhi ? Tf[off + nz] : T(0), fz[off],
        has_zhi ? fz[off + 1] : T(0), has_zlo ? Tf[off - 1] : T(0),
        has_zhi ? Tf[off + 1] : T(0), gain, cw, iv_x, iv_y, iv_z);
    if (src != nullptr) d = add(d, mul(mul(cd, gain), src[off]));
    out[off] = d;
    t_lo = t_c;
    t_c = t_hi;
    fx_lo = fx_hi;
  }
}

// K6's rows for the core's strided kernel on the x lines of the natural
// field: (B1, n, B2) = (1, nx, ny*nz), line b2 = j*nz + k at base = b2,
// rows rs = ny*nz apart.  Every lane of a warp forms the same rows of its
// own line together (the z neighbours come by shuffle); a lane past the
// last line (`valid` false) takes part with zeros and forms identity rows.
// Where the core keeps a value a row (kKeepRhs), phase (a) keeps each
// row's right-hand side and phase (c) forms the row again from it and the
// row's own code, x faces, w and h, without the stencil's loads.
template <typename T>
struct VpThetaRows {
  const T* Tf;
  const uint8_t* code;
  const T* fx;
  const T* fy;
  const T* fz;
  const T* w;
  const T* h;
  const T* src;
  int64_t ny, nz;
  T cw, cd, iv_x, iv_y, iv_z, tg, sk, t_inf, rob_c;
  static constexpr bool kKeepsRhs = true;

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, T* kept = nullptr,
                                       int stride = 0) const {
    form<M, false>(ch, base, rs, row0, n, valid, kept, stride);
  }

  template <int M>
  __device__ __forceinline__ void reload(Chunk<T, M, false>& ch,
                                         int64_t base, int64_t rs,
                                         int64_t row0, int64_t n, bool valid,
                                         T* kept, int stride) const {
    form<M, true>(ch, base, rs, row0, n, valid, kept, stride);
  }

  // kAgain: the right-hand sides from kept[k*stride]; else from the
  // stencil, stored there where kept is not null
  template <int M, bool kAgain>
  __device__ __forceinline__ void form(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, T* kept,
                                       int stride) const {
    constexpr unsigned kAll = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int64_t j = base / nz;
    const int64_t kz = base - j * nz;
    const bool ylo = valid && j > 0, yhi = valid && j + 1 < ny;
    const bool zlo = valid && kz > 0, zhi = valid && kz + 1 < nz;
    const bool in0 = valid && row0 < n;
    // T at the row before the chunk, T and the lower x face at its first
    T t_lo = (!kAgain && in0 && row0 > 0) ? __ldg(Tf + base + (row0 - 1) * rs)
                                          : T(0);
    T t_c = (!kAgain && in0) ? __ldg(Tf + base + row0 * rs) : T(0);
    T f_lo = in0 ? __ldg(fx + base + row0 * rs) : T(0);
    ch.load_rows(
        [&](int k, T& a, T& b, T& c, T& d) {
          const int64_t i = row0 + k;
          if (i >= n) {                 // the same rows for the whole warp
            a = c = d = T(0);
            b = T(1);
            return;
          }
          const int64_t off = base + i * rs;
          const bool xhi = valid && i + 1 < n;
          const T f_hi = xhi ? __ldg(fx + off + rs) : T(0);
          const unsigned cv = valid ? __ldg(code + off) : 0u;
          const T wv = valid ? __ldg(w + off) : T(0);
          T dv;
          if constexpr (kAgain) {
            dv = kept[k * stride];
          } else {
            const T t_hi = xhi ? __ldg(Tf + off + rs) : T(0);
            const T fz_c = valid ? __ldg(fz + off) : T(0);
            T tz_lo = __shfl_up_sync(kAll, t_c, 1);
            T tz_hi = __shfl_down_sync(kAll, t_c, 1);
            T fz_hi = __shfl_down_sync(kAll, fz_c, 1);
            if (lane == 0) tz_lo = zlo ? __ldg(Tf + off - 1) : T(0);
            if (lane == 31) {
              tz_hi = zhi ? __ldg(Tf + off + 1) : T(0);
              fz_hi = zhi ? __ldg(fz + off + 1) : T(0);
            }
            tz_lo = zlo ? tz_lo : T(0);
            tz_hi = zhi ? tz_hi : T(0);
            fz_hi = zhi ? fz_hi : T(0);
            const T gain = mul(wv, atf::bit<T>(cv, atf::kInMask));
            dv = atf::vp_theta_d(
                t_c, f_lo, f_hi, t_lo, t_hi, valid ? __ldg(fy + off) : T(0),
                yhi ? __ldg(fy + off + nz) : T(0),
                ylo ? __ldg(Tf + off - nz) : T(0),
                yhi ? __ldg(Tf + off + nz) : T(0), fz_c, fz_hi, tz_lo, tz_hi,
                gain, cw, iv_x, iv_y, iv_z);
            if (src != nullptr && valid) {
              dv = add(dv, mul(mul(cd, gain), __ldg(src + off)));
            }
            if (kept != nullptr) kept[k * stride] = dv;
            t_lo = t_c;
            t_c = t_hi;
          }
          const T hv = (h != nullptr && valid) ? __ldg(h + off) : rob_c;
          atf::vp_row_coeffs<T>(cv, f_lo, f_hi, wv, hv, dv, tg, sk, t_inf, a,
                                b, c, d);
          f_lo = f_hi;
        },
        row0, n);
  }
};

template <typename T>
void launch_vp_theta_rhs(const void* Tf, const void* fx, const void* fy,
                         const void* fz, const void* w, const void* src,
                         const void* mask, void* out, int64_t nx, int64_t ny,
                         int64_t nz, double cw, double cd, double iv_x,
                         double iv_y, double iv_z, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(ny * nz, threads);
  vp_theta_rhs_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(Tf), static_cast<const T*>(fx),
      static_cast<const T*>(fy), static_cast<const T*>(fz),
      static_cast<const T*>(w), static_cast<const T*>(src),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), nx, ny, nz,
      (T)cw, (T)cd, (T)iv_x, (T)iv_y, (T)iv_z);
}

}  // namespace

ATF_API int atf_varprop_theta_sweep(
    int dtype, int device, const void* Tf, const void* code, const void* fx,
    const void* fy, const void* fz, const void* w, const void* h,
    const void* src, void* out, int64_t nx, int64_t ny, int64_t nz,
    double cw, double cd, double iv_x, double iv_y, double iv_z, double tg,
    double sk, double t_inf, double rob_c, void* stream) {
  ATF_DISPATCH(
      dtype, device,
      ATF_RETURN_IF((launch_split_strided<T, VpThetaRows<T>>(
          VpThetaRows<T>{
              static_cast<const T*>(Tf), static_cast<const uint8_t*>(code),
              static_cast<const T*>(fx), static_cast<const T*>(fy),
              static_cast<const T*>(fz), static_cast<const T*>(w),
              static_cast<const T*>(h), static_cast<const T*>(src), ny, nz,
              (T)cw, (T)cd, (T)iv_x, (T)iv_y, (T)iv_z, (T)tg, (T)sk,
              (T)t_inf, (T)rob_c},
          static_cast<T*>(out), 1, nx, ny * nz, 1, ny * nz, device,
          (cudaStream_t)stream))));
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
               launch_vp_theta_rhs<T>(Tf, fx, fy, fz, w, src, mask, out, nx,
                                      ny, nz, cw, cd, iv_x, iv_y, iv_z,
                                      (cudaStream_t)stream));
}

// K7 (y: (B1, n, B2) = (nx, ny, nz)) and K7x (x: (1, nx, ny*nz), on K6's
// launch shape: the core's rule from (n, dtype) alone).
ATF_API int atf_varprop_sweep_strided(int dtype, int device, const void* rhs,
                                      const void* code, const void* fc,
                                      const void* w, const void* h,
                                      void* out, int64_t B1, int64_t n,
                                      int64_t B2, double tg, double sk,
                                      double t_inf, double rob_c,
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
