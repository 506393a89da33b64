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
//
// bfloat16 entries (K6b, K7b, K7xb, K20b): the streams at the state type S,
// widened on load, the rows and right-hand sides formed and solved at
// float32 (common.cuh ATF_DISPATCH_STATE), every result stored through
// atf::st with the caller's key: to nearest, or stochastically from the
// cell's natural index (solvers/rounding.py), as the JAX kernels round
// their bf16 stores with the TPU's generator (K20: `sr`, K6 and K7x:
// `sr + 1`, K7: `sr + 2`; pallas_varprop.py:459, 1050, 704, 227/238).  K6b
// keeps its right-hand sides at float32, as JAX's ring kernel does (:856),
// so at bfloat16 K20b -> K7xb (R0 stored at bfloat16) is not K6b bit for
// bit.  K6b, K7b and K7xb run 16 warps, two blocks an SM; K6b reads two
// rows of its lines a load where the rows pair up (VpThetaRows
// form_pairs, split_line.cuh ld_pair).  None is bound by bytes at
// bfloat16: each runs slower than its float32 kernel (PERF.md).  Byte
// models at bfloat16: K6b 15 B/cell with the h stream (T 2, code 1, four
// fields 8, h 2, out 2), K7b and K7xb 9 (11 with h), K20b 13.
#include <initializer_list>

#include "vp_rows.cuh"

namespace {

using atf::add;
using atf::mul;

// K20: R0 with the in-mask factor from the uint8 mask, stored at S
// through atf::st with the key (K20b: to nearest or stochastically, the
// cell's natural index its counter).
template <typename S, typename C>
__global__ void __launch_bounds__(256) vp_theta_rhs_kernel(
    const S* __restrict__ Tf, const S* __restrict__ fx,
    const S* __restrict__ fy, const S* __restrict__ fz,
    const S* __restrict__ w, const S* __restrict__ src,
    const uint8_t* __restrict__ mask, S* __restrict__ out, int64_t nx,
    int64_t ny, int64_t nz, C cw, C cd, C iv_x, C iv_y, C iv_z,
    int64_t key) {
  const int64_t plane = ny * nz;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int64_t j = p / nz;
  const int64_t k = p - j * nz;
  const bool has_ylo = j > 0, has_yhi = j + 1 < ny;
  const bool has_zlo = k > 0, has_zhi = k + 1 < nz;
  auto ld = [](const S* q) { return (C)atf::ld(q); };

  C t_lo = C(0);              // T at x-1 (0 before the first row)
  C t_c = ld(Tf + p);         // T at x
  C fx_lo = ld(fx + p);       // face (x-1, x)
  for (int64_t i = 0; i < nx; ++i) {
    const int64_t off = i * plane + p;
    const bool has_xhi = i + 1 < nx;
    const C t_hi = has_xhi ? ld(Tf + off + plane) : C(0);
    const C fx_hi = has_xhi ? ld(fx + off + plane) : C(0);
    const C gain = mul(ld(w + off), mask[off] ? C(1) : C(0));
    C d = atf::vp_theta_d(
        t_c, fx_lo, fx_hi, t_lo, t_hi, ld(fy + off),
        has_yhi ? ld(fy + off + nz) : C(0), has_ylo ? ld(Tf + off - nz) : C(0),
        has_yhi ? ld(Tf + off + nz) : C(0), ld(fz + off),
        has_zhi ? ld(fz + off + 1) : C(0), has_zlo ? ld(Tf + off - 1) : C(0),
        has_zhi ? ld(Tf + off + 1) : C(0), gain, cw, iv_x, iv_y, iv_z);
    if (src != nullptr) d = add(d, mul(mul(cd, gain), ld(src + off)));
    atf::st(out + off, d, key, off);
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
// row's own code, x faces, w and h, without the stencil's loads.  Types:
// the streams at the state type S, widened, the right-hand sides and rows
// at C; at bfloat16 (K6b) the right-hand side stays at float32 inside the
// kernel, as the JAX ring kernel keeps it (pallas_varprop.py:856-857),
// the block takes K24's shape (16 warps, two blocks an SM) and, where the
// rows pair up (`pairs`: nz even, the streams 4-byte aligned), a warp
// reads two rows of its lines with one 4-byte load a lane (form_pairs):
// at 384^3 (scripts/vp_bf16_ab.py, PERF.md section 6) K6b ran 1.31 ms
// so, against 1.40 with one row a load or with 32 warps, 1.73 with both.
template <typename S, typename C>
struct VpThetaRows {
  static constexpr int kWarps = sizeof(S) == 2 ? 16 : kSplitWarps<C>;
  static constexpr int kMinBlocks = sizeof(S) == 2 ? 2 : 1;
  const S* Tf;
  const uint8_t* code;
  const S* fx;
  const S* fy;
  const S* fz;
  const S* w;
  const S* h;
  const S* src;
  int64_t ny, nz;
  C cw, cd, iv_x, iv_y, iv_z, tg, sk, t_inf, rob_c;
  bool pairs;
  static constexpr bool kKeepsRhs = true;

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, C* kept = nullptr,
                                       int stride = 0) const {
    form<M, false>(ch, base, rs, row0, n, valid, kept, stride);
  }

  template <int M>
  __device__ __forceinline__ void reload(Chunk<C, M, false>& ch,
                                         int64_t base, int64_t rs,
                                         int64_t row0, int64_t n, bool valid,
                                         C* kept, int stride) const {
    form<M, true>(ch, base, rs, row0, n, valid, kept, stride);
  }

  // kAgain: the right-hand sides from kept[k*stride]; else from the
  // stencil, stored there where kept is not null
  template <int M, bool kAgain>
  __device__ __forceinline__ void form(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, C* kept,
                                       int stride) const {
    if constexpr (sizeof(S) == 2 && M % 2 == 0) {
      if (pairs) {
        form_pairs<M, kAgain>(ch, base, rs, row0, n, valid, kept, stride);
        return;
      }
    }
    constexpr unsigned kAll = 0xffffffffu;
    using atf::ldg;
    const int lane = threadIdx.x & 31;
    const int64_t j = base / nz;
    const int64_t kz = base - j * nz;
    const bool ylo = valid && j > 0, yhi = valid && j + 1 < ny;
    const bool zlo = valid && kz > 0, zhi = valid && kz + 1 < nz;
    const bool in0 = valid && row0 < n;
    // T at the row before the chunk, T and the lower x face at its first
    C t_lo = (!kAgain && in0 && row0 > 0) ? ldg(Tf + base + (row0 - 1) * rs)
                                          : C(0);
    C t_c = (!kAgain && in0) ? ldg(Tf + base + row0 * rs) : C(0);
    C f_lo = in0 ? ldg(fx + base + row0 * rs) : C(0);
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          const int64_t i = row0 + k;
          if (i >= n) {                 // the same rows for the whole warp
            a = c = d = C(0);
            b = C(1);
            return;
          }
          const int64_t off = base + i * rs;
          const bool xhi = valid && i + 1 < n;
          const C f_hi = xhi ? ldg(fx + off + rs) : C(0);
          const unsigned cv = valid ? __ldg(code + off) : 0u;
          const C wv = valid ? ldg(w + off) : C(0);
          C dv;
          if constexpr (kAgain) {
            dv = kept[k * stride];
          } else {
            const C t_hi = xhi ? ldg(Tf + off + rs) : C(0);
            const C fz_c = valid ? ldg(fz + off) : C(0);
            C tz_lo = __shfl_up_sync(kAll, t_c, 1);
            C tz_hi = __shfl_down_sync(kAll, t_c, 1);
            C fz_hi = __shfl_down_sync(kAll, fz_c, 1);
            if (lane == 0) tz_lo = zlo ? ldg(Tf + off - 1) : C(0);
            if (lane == 31) {
              tz_hi = zhi ? ldg(Tf + off + 1) : C(0);
              fz_hi = zhi ? ldg(fz + off + 1) : C(0);
            }
            tz_lo = zlo ? tz_lo : C(0);
            tz_hi = zhi ? tz_hi : C(0);
            fz_hi = zhi ? fz_hi : C(0);
            const C gain = mul(wv, atf::bit<C>(cv, atf::kInMask));
            dv = atf::vp_theta_d(
                t_c, f_lo, f_hi, t_lo, t_hi, valid ? ldg(fy + off) : C(0),
                yhi ? ldg(fy + off + nz) : C(0),
                ylo ? ldg(Tf + off - nz) : C(0),
                yhi ? ldg(Tf + off + nz) : C(0), fz_c, fz_hi, tz_lo, tz_hi,
                gain, cw, iv_x, iv_y, iv_z);
            if (src != nullptr && valid) {
              dv = add(dv, mul(mul(cd, gain), ldg(src + off)));
            }
            if (kept != nullptr) kept[k * stride] = dv;
            t_lo = t_c;
            t_c = t_hi;
          }
          const C hv = (h != nullptr && valid) ? ldg(h + off) : rob_c;
          atf::vp_row_coeffs<C>(cv, f_lo, f_hi, wv, hv, dv, tg, sk, t_inf, a,
                                b, c, d);
          f_lo = f_hi;
        },
        row0, n);
  }

  // form's rows with the streams read two rows at a time (bfloat16, M
  // even; GThetaRows::form_pairs' scheme, csrc/gstreams.cu): at an even
  // row k the upper x faces (rows k + 1, k + 2), w, h and the codes of rows
  // k and k + 1, and their right-hand sides from T at rows row0 + k - 1 ..
  // row0 + k + 2 (the first two carried from the last pair), their y
  // neighbours and faces and the z halo, one load a lane for both rows:
  // T left of lane 0's line (lanes 0, 1), T right of lane 31's (lanes 30,
  // 31) and its z face there (lanes 28, 29).  The same operations as form,
  // in its order.
  template <int M, bool kAgain>
  __device__ __forceinline__ void form_pairs(Chunk<C, M, false>& ch,
                                             int64_t base, int64_t rs,
                                             int64_t row0, int64_t n,
                                             bool valid, C* kept,
                                             int stride) const {
    constexpr unsigned kAll = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int64_t j = base / nz;
    const int64_t kz = base - j * nz;
    const bool zlo = valid && kz > 0, zhi = valid && kz + 1 < nz;
    const int64_t q0 = pair_offset(base);
    const bool pv = pair_valid(valid);
    const int64_t jp = q0 / nz;                  // the pair's y row
    const bool ylo = pv && jp > 0, yhi = pv && jp + 1 < ny;
    const int64_t b0 = base - lane, b31 = b0 + 31;
    const bool hlo = b0 % nz > 0, hhi = b31 < ny * nz && b31 % nz + 1 < nz;
    C t[2];                         // T at rows row0 + k - 1 and row0 + k
    if constexpr (!kAgain) ld_pair(Tf, q0, rs, row0 - 1, n, pv, t);
    C f_lo = (valid && row0 < n) ? atf::ldg(fx + base + row0 * rs) : C(0);
    C x[3][2], dv[2];       // upper x faces, w, h of rows k and k + 1
    unsigned cv[2];
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          const int64_t i = row0 + k;
          const int e = k % 2;
          if (e == 0) {
            ld_pair(fx, q0, rs, i + 1, n, pv, x[0]);
            ld_pair(w, q0, rs, i, n, pv, x[1]);
            if (h != nullptr) ld_pair(h, q0, rs, i, n, pv, x[2]);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              cv[u] = valid && i + u < n ? __ldg(code + base + (i + u) * rs)
                                         : 0u;
            }
            if constexpr (!kAgain) {
              C th[2], fy[2][2], fz[2], ty[2][2], sp[2] = {C(0), C(0)};
              ld_pair(Tf, q0, rs, i + 1, n, pv, th);
              ld_pair(this->fy, q0, rs, i, n, pv, fy[0]);
              ld_pair(this->fy, q0 + nz, rs, i, n, yhi, fy[1]);
              ld_pair(this->fz, q0, rs, i, n, pv, fz);
              ld_pair(Tf, q0 - nz, rs, i, n, ylo, ty[0]);
              ld_pair(Tf, q0 + nz, rs, i, n, yhi, ty[1]);
              if (src != nullptr) ld_pair(src, q0, rs, i, n, pv, sp);
              const C tr[4] = {t[0], t[1], th[0], th[1]};
              C hz = C(0);
              const int64_t r = i + (lane & 1);
              if (r < n && hlo && lane < 2) {
                hz = atf::ldg(Tf + b0 - 1 + r * rs);
              } else if (r < n && hhi && lane >= 30) {
                hz = atf::ldg(Tf + b31 + 1 + r * rs);
              } else if (r < n && hhi && (lane == 28 || lane == 29)) {
                hz = atf::ldg(this->fz + b31 + 1 + r * rs);
              }
              const C fx_lo[2] = {f_lo, x[0][0]};
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                C tz_lo = __shfl_up_sync(kAll, tr[1 + u], 1);
                C tz_hi = __shfl_down_sync(kAll, tr[1 + u], 1);
                C fz_hi = __shfl_down_sync(kAll, fz[u], 1);
                const C hl = __shfl_sync(kAll, hz, u);
                const C hh = __shfl_sync(kAll, hz, 30 + u);
                const C hf = __shfl_sync(kAll, hz, 28 + u);
                if (lane == 0) tz_lo = hl;
                if (lane == 31) {
                  tz_hi = hh;
                  fz_hi = hf;
                }
                const C gain = mul(x[1][u], atf::bit<C>(cv[u], atf::kInMask));
                C dd = atf::vp_theta_d(
                    tr[1 + u], fx_lo[u], x[0][u], tr[u], tr[2 + u],
                    fy[0][u], fy[1][u], ty[0][u], ty[1][u], fz[u],
                    zhi ? fz_hi : C(0), zlo ? tz_lo : C(0),
                    zhi ? tz_hi : C(0), gain, cw, iv_x, iv_y, iv_z);
                if (src != nullptr) dd = add(dd, mul(mul(cd, gain), sp[u]));
                dv[u] = valid ? dd : C(0);
              }
              t[0] = th[0];
              t[1] = th[1];
            }
          }
          if (i >= n) {                 // the same rows for the whole warp
            a = c = d = C(0);
            b = C(1);
            return;
          }
          C r;
          if constexpr (kAgain) {
            r = kept[k * stride];
          } else {
            r = dv[e];
            if (kept != nullptr) kept[k * stride] = r;
          }
          const C hv = (h != nullptr && valid) ? x[2][e] : rob_c;
          atf::vp_row_coeffs<C>(cv[e], f_lo, x[0][e], valid ? x[1][e] : C(0),
                                hv, r, tg, sk, t_inf, a, b, c, d);
          f_lo = x[0][e];
        },
        row0, n);
  }
};

template <typename S, typename C>
void launch_vp_theta_rhs(const void* Tf, const void* fx, const void* fy,
                         const void* fz, const void* w, const void* src,
                         const void* mask, void* out, int64_t nx, int64_t ny,
                         int64_t nz, double cw, double cd, double iv_x,
                         double iv_y, double iv_z, int64_t key,
                         cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(ny * nz, threads);
  vp_theta_rhs_kernel<S, C><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const S*>(Tf), static_cast<const S*>(fx),
      static_cast<const S*>(fy), static_cast<const S*>(fz),
      static_cast<const S*>(w), static_cast<const S*>(src),
      static_cast<const uint8_t*>(mask), static_cast<S*>(out), nx, ny, nz,
      (C)cw, (C)cd, (C)iv_x, (C)iv_y, (C)iv_z, key);
}

// K6b's rows in 4-byte pairs: nz even (no pair of lines straddles a y
// row) and every stream word aligned (split_line.cuh ld_pair); false at
// other types
bool rows_pair(int dtype, int64_t nz,
               std::initializer_list<const void*> ps) {
  bool pairs = dtype == atf::kBF16 && nz % 2 == 0;
  for (const void* q : ps) {
    pairs = pairs && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  }
  return pairs;
}

}  // namespace

ATF_API int atf_varprop_theta_sweep(
    int dtype, int device, const void* Tf, const void* code, const void* fx,
    const void* fy, const void* fz, const void* w, const void* h,
    const void* src, void* out, int64_t nx, int64_t ny, int64_t nz,
    double cw, double cd, double iv_x, double iv_y, double iv_z, double tg,
    double sk, double t_inf, double rob_c, int64_t key, void* stream) {
  const bool pairs = rows_pair(dtype, nz, {Tf, fx, fy, fz, w, h, src});
  ATF_DISPATCH_STATE(
      dtype, device,
      ATF_RETURN_IF((launch_split_strided<C, VpThetaRows<S, C>>(
          VpThetaRows<S, C>{
              static_cast<const S*>(Tf), static_cast<const uint8_t*>(code),
              static_cast<const S*>(fx), static_cast<const S*>(fy),
              static_cast<const S*>(fz), static_cast<const S*>(w),
              static_cast<const S*>(h), static_cast<const S*>(src), ny, nz,
              (C)cw, (C)cd, (C)iv_x, (C)iv_y, (C)iv_z, (C)tg, (C)sk,
              (C)t_inf, (C)rob_c, pairs},
          static_cast<S*>(out), 1, nx, ny * nz, 1, ny * nz, device,
          (cudaStream_t)stream, key))));
}

ATF_API int atf_varprop_theta_rhs(int dtype, int device, const void* Tf,
                                  const void* fx, const void* fy,
                                  const void* fz, const void* w,
                                  const void* mask, const void* src,
                                  void* out, int64_t nx, int64_t ny,
                                  int64_t nz, double cw, double cd,
                                  double iv_x, double iv_y, double iv_z,
                                  int64_t key, void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  ATF_DISPATCH_STATE(dtype, device,
                     launch_vp_theta_rhs<S, C>(Tf, fx, fy, fz, w, src, mask,
                                               out, nx, ny, nz, cw, cd, iv_x,
                                               iv_y, iv_z, key,
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
                                      int64_t key, void* stream) {
  ATF_DISPATCH_STATE(
      dtype, device,
      ATF_RETURN_IF((launch_split_strided<C, VpRows<S, C>>(
          VpRows<S, C>{static_cast<const S*>(rhs),
                       static_cast<const uint8_t*>(code),
                       static_cast<const S*>(fc), static_cast<const S*>(w),
                       static_cast<const S*>(h), (C)tg, (C)sk, (C)t_inf,
                       (C)rob_c},
          static_cast<S*>(out), B1, n, B2, 1, B2, device,
          (cudaStream_t)stream, key))));
}
