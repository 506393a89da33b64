// K23-K26: the g-stream variable-property tier.
//
// K23 replaces adi_thermal_fields_tpu/solvers/pallas_gstreams.py
//     gstream_fields (:163), body _gfields_kernel (:73): from T, the uint8
//     mask and k(T), cp(T) clamp-sum tables (varprop.cuh), per axis
//       g_lo = tg*w*(harm(k_lo, k)*c_lo),  g_hi = tg*w*(harm(k, k_hi)*c_hi),
//       sw   = (sk*h*(w*m))*(2 - c_lo - c_hi),
//     with m the cell's mask, c_lo/c_hi the 0/1 couplings to the -1/+1
//     neighbour (both in-mask; 0 past the domain edge), w = 1/(rho*cp),
//     tg = theta*dt/d^2, sk = dt/d and the film h a constant, a stream, or
//     the radiative film rc*(Tk + Tik)*(Tk^2 + Tik^2) + h_conv evaluated
//     in registers; optionally src_pre = (dt*(w*m))*src.  Nine (ten)
//     streams at the state type, rounded to nearest.
// K24 replaces pallas_gstreams.py gstream_theta_sweep (:839), body
//     _gring_kernel (:665): U = A_x^{-1}[(I + rr*G) T (+ src_pre) +
//     sw_x*t_inf] with rr = (1-theta)/theta, the explicit sum taken x,
//     then y, then z as sum_ax (g_lo*(T_lo - T) + g_hi*(T_hi - T)).
// K25 replaces pallas_gstreams.py gstream_sweep_axis1 (:575), body
//     _gsweep_kernel_axis1 (:466): the sweep along the strided y axis of
//     the natural field, viewed as (B1, n, B2) = (nx, ny, nz).
// K26 replaces pallas_gstreams.py gstream_sweep (:376), body
//     _gsweep_kernel (:263), which JAX feeds the (z, x, y) transpose of the
//     field and of three streams (four transposes a step,
//     cartesian_varprop.py:516-520): here the sweep runs along the
//     contiguous z axis of the natural field, staged through shared memory
//     as K19 is, and the step transposes nothing.
//
// Rows (K24-K26): a = -g_lo, c = -g_hi, b = 1 + g_lo + g_hi + sw, d = rhs
// + sw*t_inf; no codes, no row lag (g_hi is already the cell's own upper
// face), and void cells are identity rows because their streams are zero.
// Eliminated with one reciprocal per row (inv = 1/(b + g_lo*c'); c' =
// -g_hi*inv; d' = (d + g_lo*d')*inv), the TPU kernels' order.  Every
// operation is one IEEE rounding (the _rn helpers) in the plain versions'
// order (solvers/gstreams.py): each kernel repeats its plain version bit
// for bit.  Types: S storage, C compute (common.cuh ATF_DISPATCH_STATE);
// a bfloat16 state solves at float32 and stores its result to nearest or
// stochastically (K24-K26, `key`), the streams always to nearest.
//
// What bounds them on the H100: memory.  Per cell at bfloat16 (float32):
// K23 reads T + mask and writes nine streams, 21 B (41); K24 reads T and
// seven streams and writes U, 18 B (36); K25 and K26 read rhs and three
// streams and write x, 10 B (20); the sweeps also move c' and d' as
// float32 scratch (+16 B).  Designs: K23 one thread per cell, threads
// adjacent in z (coalesced), each thread evaluating k at the in-mask
// neighbours it couples to; K24 K6's thread-per-(y, z)-pencil march along
// x, the pencil's own x-1, x and x+1 values in registers; K25 K7's
// thread-per-pencil strided sweep; K26 K19's warp of 32 pencils staging
// [32 pencils x 32 rows] tiles of every stream through shared memory.
#include "varprop.cuh"

namespace {

using atf::add;
using atf::div;
using atf::mul;
using atf::sub;

constexpr int kHConst = 0, kHStream = 1, kHRad = 2;   // film modes

// tw*(harm(ka, kb)*c) for the 0/1 coupling c: harm*1 is exact, and c = 0
// gives 0 without evaluating the neighbour's k
template <typename C>
__device__ __forceinline__ C gface(C tw, C ka, C kb, bool on) {
  return on ? mul(tw, atf::harm_rn(ka, kb)) : C(0);
}

template <typename S, typename C>
__global__ void __launch_bounds__(256) gstream_fields_kernel(
    const S* __restrict__ Tf, const uint8_t* __restrict__ mask,
    const S* __restrict__ h, const S* __restrict__ src,
    S* __restrict__ gxlo, S* __restrict__ gxhi, S* __restrict__ gylo,
    S* __restrict__ gyhi, S* __restrict__ gzlo, S* __restrict__ gzhi,
    S* __restrict__ swx, S* __restrict__ swy, S* __restrict__ swz,
    S* __restrict__ srcp, int64_t nx, int64_t ny, int64_t nz,
    const __grid_constant__ atf::Table<C> ktab,
    const __grid_constant__ atf::Table<C> ctab, C rho, C tgx, C tgy, C tgz,
    C skx, C sky, C skz, C hpar, C tik, C tik2, C hconv, C dt, int hmode) {
  const int64_t plane = ny * nz;
  const int64_t ncell = nx * plane;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < ncell; idx += stride) {
    const int64_t i = idx / plane;
    const int64_t jk = idx - i * plane;
    const int64_t j = jk / nz;
    const int64_t k = jk - j * nz;
    const C t = atf::ld(Tf + idx);
    const bool m = mask[idx] != 0;
    const C mf = m ? C(1) : C(0);
    const C kc = atf::clamp_sum_rn(ktab, t);
    const C w = div(C(1), mul(rho, atf::clamp_sum_rn(ctab, t)));

    // couplings to the -1/+1 neighbour along each axis
    const bool xl = m && i > 0 && mask[idx - plane] != 0;
    const bool xh = m && i + 1 < nx && mask[idx + plane] != 0;
    const bool yl = m && j > 0 && mask[idx - nz] != 0;
    const bool yh = m && j + 1 < ny && mask[idx + nz] != 0;
    const bool zl = m && k > 0 && mask[idx - 1] != 0;
    const bool zh = m && k + 1 < nz && mask[idx + 1] != 0;
    auto knb = [&](bool on, int64_t off) {
      return on ? atf::clamp_sum_rn(ktab, atf::ld(Tf + idx + off)) : C(0);
    };
    C tw = mul(tgx, w);
    atf::st(gxlo + idx, gface(tw, knb(xl, -plane), kc, xl), -1, idx);
    atf::st(gxhi + idx, gface(tw, kc, knb(xh, plane), xh), -1, idx);
    tw = mul(tgy, w);
    atf::st(gylo + idx, gface(tw, knb(yl, -nz), kc, yl), -1, idx);
    atf::st(gyhi + idx, gface(tw, kc, knb(yh, nz), yh), -1, idx);
    tw = mul(tgz, w);
    atf::st(gzlo + idx, gface(tw, knb(zl, -1), kc, zl), -1, idx);
    atf::st(gzhi + idx, gface(tw, kc, knb(zh, 1), zh), -1, idx);

    // Robin sinks: h * w * (exposed faces along the axis), in-mask only
    C hloc = hpar;
    if (hmode == kHStream) {
      hloc = atf::ld(h + idx);
    } else if (hmode == kHRad) {
      const C tk = add(t, C(273.15));
      hloc = add(mul(mul(hpar, add(tk, tik)), add(mul(tk, tk), tik2)),
                 hconv);
    }
    const C wm = mul(w, mf);
    const C hw = mul(hloc, wm);
    auto nexp = [](bool lo, bool hi) {
      return sub(sub(C(2), lo ? C(1) : C(0)), hi ? C(1) : C(0));
    };
    atf::st(swx + idx, mul(mul(skx, hw), nexp(xl, xh)), -1, idx);
    atf::st(swy + idx, mul(mul(sky, hw), nexp(yl, yh)), -1, idx);
    atf::st(swz + idx, mul(mul(skz, hw), nexp(zl, zh)), -1, idx);
    if (src != nullptr) {
      atf::st(srcp + idx, mul(mul(dt, wm), atf::ld(src + idx)), -1, idx);
    }
  }
}

// One g-stream row into the recurrence (c', d').
template <typename C>
__device__ __forceinline__ void grow(C lo, C hi, C sw, C d, C t_inf, C& cp,
                                     C& dp) {
  const C b = add(add(add(C(1), lo), hi), sw);
  const C dd = add(d, mul(sw, t_inf));
  const C inv = div(C(1), add(b, mul(lo, cp)));
  cp = mul(-hi, inv);
  dp = mul(add(dd, mul(lo, dp)), inv);
}

// One axis of the explicit pass: g_lo*(t_lo - t) + g_hi*(t_hi - t).
template <typename C>
__device__ __forceinline__ C gterm(C lo, C hi, C t_lo, C t_hi, C t) {
  return add(mul(lo, sub(t_lo, t)), mul(hi, sub(t_hi, t)));
}

template <typename S, typename C>
__global__ void __launch_bounds__(256) gstream_theta_sweep_kernel(
    const S* __restrict__ Tf, const S* __restrict__ gxlo,
    const S* __restrict__ gxhi, const S* __restrict__ gylo,
    const S* __restrict__ gyhi, const S* __restrict__ gzlo,
    const S* __restrict__ gzhi, const S* __restrict__ swx,
    const S* __restrict__ srcp, S* __restrict__ out, C* __restrict__ cpbuf,
    C* __restrict__ dpbuf, int64_t nx, int64_t ny, int64_t nz, C rr,
    C t_inf, int64_t key) {
  const int64_t plane = ny * nz;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int64_t j = p / nz;
  const int64_t k = p - j * nz;
  const bool has_ylo = j > 0, has_yhi = j + 1 < ny;
  const bool has_zlo = k > 0, has_zhi = k + 1 < nz;

  C cp = C(0), dp = C(0);
  C t_lo = C(0);               // T at x-1 (0 before the first row)
  C t_c = atf::ld(Tf + p);     // T at x
  for (int64_t i = 0; i < nx; ++i) {
    const int64_t off = i * plane + p;
    const C t_hi = (i + 1 < nx) ? atf::ld(Tf + off + plane) : C(0);
    const C lo = atf::ld(gxlo + off);
    const C hi = atf::ld(gxhi + off);
    // explicit pass: x, then y, then z (neighbours 0 past the edge)
    C acc = gterm(lo, hi, t_lo, t_hi, t_c);
    acc = add(acc, gterm(atf::ld(gylo + off), atf::ld(gyhi + off),
                         has_ylo ? atf::ld(Tf + off - nz) : C(0),
                         has_yhi ? atf::ld(Tf + off + nz) : C(0), t_c));
    acc = add(acc, gterm(atf::ld(gzlo + off), atf::ld(gzhi + off),
                         has_zlo ? atf::ld(Tf + off - 1) : C(0),
                         has_zhi ? atf::ld(Tf + off + 1) : C(0), t_c));
    C d = add(t_c, mul(rr, acc));
    if (srcp != nullptr) d = add(d, atf::ld(srcp + off));
    grow(lo, hi, atf::ld(swx + off), d, t_inf, cp, dp);
    cpbuf[off] = cp;
    dpbuf[off] = dp;
    t_lo = t_c;
    t_c = t_hi;
  }
  C x = C(0);
  for (int64_t i = nx - 1; i >= 0; --i) {
    const int64_t off = i * plane + p;
    x = sub(dpbuf[off], mul(cpbuf[off], x));
    atf::st(out + off, x, key, off);
  }
}

template <typename S, typename C>
__global__ void __launch_bounds__(256) gstream_sweep_strided_kernel(
    const S* __restrict__ rhs, const S* __restrict__ glo,
    const S* __restrict__ ghi, const S* __restrict__ sw,
    S* __restrict__ out, C* __restrict__ cpbuf, C* __restrict__ dpbuf,
    int64_t B1, int64_t n, int64_t B2, C t_inf, int64_t key) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B1 * B2) return;
  const int64_t b1 = p / B2;
  const int64_t base = b1 * n * B2 + (p - b1 * B2);
  C cp = C(0), dp = C(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    grow(atf::ld(glo + off), atf::ld(ghi + off), atf::ld(sw + off),
         atf::ld(rhs + off), t_inf, cp, dp);
    cpbuf[off] = cp;
    dpbuf[off] = dp;
  }
  C x = C(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    x = sub(dpbuf[off], mul(cpbuf[off], x));
    atf::st(out + off, x, key, off);
  }
}

constexpr int kPencils = 32;        // K26 pencils per block (one warp)
constexpr int kChunk = 32;          // rows per staged tile
constexpr int kPitch = kChunk + 1;  // padded tile row: conflict-free lanes

template <typename C>
constexpr size_t gz_smem_bytes() {
  // rhs / c' / x, d', g_lo, g_hi, sw tiles
  return 5 * sizeof(C) * kPencils * kPitch;
}

template <typename S, typename C>
__global__ void __launch_bounds__(kPencils) gstream_sweep_z_kernel(
    const S* __restrict__ rhs, const S* __restrict__ glo,
    const S* __restrict__ ghi, const S* __restrict__ sw,
    S* __restrict__ out, C* __restrict__ cpbuf, C* __restrict__ dpbuf,
    int64_t npen, int64_t n, C t_inf, int64_t key) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  C* tile = reinterpret_cast<C*>(atf_smem);     // rhs, then c', then x
  C* tile2 = tile + kPencils * kPitch;          // d'
  C* ltile = tile2 + kPencils * kPitch;         // g_lo
  C* htile = ltile + kPencils * kPitch;         // g_hi
  C* stile = htile + kPencils * kPitch;         // sw

  const int lane = threadIdx.x;
  const int64_t pen0 = (int64_t)blockIdx.x * kPencils;
  const int np = (int)atf::imin(kPencils, npen - pen0);
  const int row = lane * kPitch;

  // forward elimination, chunk by chunk: stage (lane = row), recur (lane =
  // pencil), write c' and d' back (lane = row)
  C cp = C(0), dp = C(0);
  for (int64_t k0 = 0; k0 < n; k0 += kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        const int s = q * kPitch + lane;
        tile[s] = atf::ld(rhs + g);
        ltile[s] = atf::ld(glo + g);
        htile[s] = atf::ld(ghi + g);
        stile[s] = atf::ld(sw + g);
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int jj = 0; jj < cz; ++jj) {
        grow(ltile[row + jj], htile[row + jj], stile[row + jj],
             tile[row + jj], t_inf, cp, dp);
        tile[row + jj] = cp;
        tile2[row + jj] = dp;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        cpbuf[g] = tile[q * kPitch + lane];
        dpbuf[g] = tile2[q * kPitch + lane];
      }
    }
    __syncwarp();
  }

  // back substitution, last chunk first
  C x = C(0);
  for (int64_t k0 = (n - 1) / kChunk * kChunk; k0 >= 0; k0 -= kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        tile[q * kPitch + lane] = cpbuf[g];
        tile2[q * kPitch + lane] = dpbuf[g];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int jj = cz - 1; jj >= 0; --jj) {
        x = sub(tile2[row + jj], mul(tile[row + jj], x));
        tile[row + jj] = x;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        atf::st(out + g, tile[q * kPitch + lane], key, g);
      }
    }
    __syncwarp();
  }
}

template <typename S, typename C>
void launch_gstream_fields(const void* Tf, const void* mask, const void* h,
                           const void* src, void* const* outs, int64_t nx,
                           int64_t ny, int64_t nz, const double* ktab,
                           int kn, const double* ctab, int cn,
                           const double* sc, int hmode,
                           cudaStream_t stream) {
  atf::Table<C> kt, ct;
  atf::make_table(ktab, kn, &kt);
  atf::make_table(ctab, cn, &ct);
  const int threads = 256;
  const int64_t blocks =
      atf::imin(atf::cdiv(nx * ny * nz, threads), (int64_t)1 << 20);
  auto o = [&](int q) { return static_cast<S*>(outs[q]); };
  gstream_fields_kernel<S, C><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const S*>(Tf), static_cast<const uint8_t*>(mask),
      static_cast<const S*>(h), static_cast<const S*>(src), o(0), o(1),
      o(2), o(3), o(4), o(5), o(6), o(7), o(8), o(9), nx, ny, nz, kt, ct,
      (C)sc[0], (C)sc[1], (C)sc[2], (C)sc[3], (C)sc[4], (C)sc[5], (C)sc[6],
      (C)sc[7], (C)sc[8], (C)sc[9], (C)sc[10], (C)sc[11], hmode);
}

}  // namespace

ATF_API int atf_gstream_fields(
    int dtype, int device, const void* Tf, const void* mask, const void* h,
    const void* src, void* gxlo, void* gxhi, void* gylo, void* gyhi,
    void* gzlo, void* gzhi, void* swx, void* swy, void* swz, void* srcp,
    int64_t nx, int64_t ny, int64_t nz, const double* ktab, int kn,
    const double* ctab, int cn, double rho, double tgx, double tgy,
    double tgz, double skx, double sky, double skz, double hpar, double tik,
    double tik2, double hconv, double dt, int hmode, void* stream) {
  if (hmode < kHConst || hmode > kHRad || (hmode == kHStream && !h) ||
      kn < 0 || kn > atf::kMaxSeg || cn < 0 || cn > atf::kMaxSeg ||
      (src != nullptr) != (srcp != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  void* const outs[10] = {gxlo, gxhi, gylo, gyhi, gzlo, gzhi,
                          swx, swy, swz, srcp};
  const double sc[12] = {rho, tgx, tgy, tgz, skx, sky,
                         skz, hpar, tik, tik2, hconv, dt};
  ATF_DISPATCH_STATE(dtype, device,
                     launch_gstream_fields<S, C>(
                         Tf, mask, h, src, outs, nx, ny, nz, ktab, kn, ctab,
                         cn, sc, hmode, (cudaStream_t)stream));
}

ATF_API int atf_gstream_theta_sweep(
    int dtype, int device, const void* Tf, const void* gxlo,
    const void* gxhi, const void* gylo, const void* gyhi, const void* gzlo,
    const void* gzhi, const void* swx, const void* srcp, void* out,
    void* cpbuf, void* dpbuf, int64_t nx, int64_t ny, int64_t nz, double rr,
    double t_inf, int64_t key, void* stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(ny * nz, threads);
  ATF_DISPATCH_STATE(
      dtype, device,
      gstream_theta_sweep_kernel<S, C><<<(unsigned)blocks, threads, 0,
                                         (cudaStream_t)stream>>>(
          static_cast<const S*>(Tf), static_cast<const S*>(gxlo),
          static_cast<const S*>(gxhi), static_cast<const S*>(gylo),
          static_cast<const S*>(gyhi), static_cast<const S*>(gzlo),
          static_cast<const S*>(gzhi), static_cast<const S*>(swx),
          static_cast<const S*>(srcp), static_cast<S*>(out),
          static_cast<C*>(cpbuf), static_cast<C*>(dpbuf), nx, ny, nz,
          (C)rr, (C)t_inf, key));
}

ATF_API int atf_gstream_sweep_strided(int dtype, int device, const void* rhs,
                                      const void* glo, const void* ghi,
                                      const void* sw, void* out, void* cpbuf,
                                      void* dpbuf, int64_t B1, int64_t n,
                                      int64_t B2, double t_inf, int64_t key,
                                      void* stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(B1 * B2, threads);
  ATF_DISPATCH_STATE(
      dtype, device,
      gstream_sweep_strided_kernel<S, C><<<(unsigned)blocks, threads, 0,
                                           (cudaStream_t)stream>>>(
          static_cast<const S*>(rhs), static_cast<const S*>(glo),
          static_cast<const S*>(ghi), static_cast<const S*>(sw),
          static_cast<S*>(out), static_cast<C*>(cpbuf),
          static_cast<C*>(dpbuf), B1, n, B2, (C)t_inf, key));
}

ATF_API int atf_gstream_sweep_z(int dtype, int device, const void* rhs,
                                const void* glo, const void* ghi,
                                const void* sw, void* out, void* cpbuf,
                                void* dpbuf, int64_t npen, int64_t n,
                                double t_inf, int64_t key, void* stream) {
  const int64_t blocks = atf::cdiv(npen, kPencils);
  ATF_DISPATCH_STATE(
      dtype, device,
      gstream_sweep_z_kernel<S, C><<<(unsigned)blocks, kPencils,
                                     gz_smem_bytes<C>(),
                                     (cudaStream_t)stream>>>(
          static_cast<const S*>(rhs), static_cast<const S*>(glo),
          static_cast<const S*>(ghi), static_cast<const S*>(sw),
          static_cast<S*>(out), static_cast<C*>(cpbuf),
          static_cast<C*>(dpbuf), npen, n, (C)t_inf, key));
}
