// K8: the tier-2 variable-property sweep along the contiguous z axis, each
// line split across a warp.
//
// Replaces adi_thermal_fields_tpu/solvers/pallas_vp2.py fused_vp2_sweep
// with nat_rhs_out=True (:402; streaming call site :611, body _vp2_kernel
// :201-389) as the Cartesian step uses it: symmetric columns glo = ghi and
// gs_lo = gs_hi, films h_lo = h_hi = h, no domain-edge films.  From the
// rhs, T^n and a 1-byte code (build_vp2_code, bits 1 = hi coupling live,
// 2/4 = lo/hi face exposed, 8 = active), per row r of a pencil:
//   k_r = k(T_r); f_hi = bit1 ? harm(k_r, k_{r+1}) : 0; f_lo = previous
//   row's f_hi; hh = h (+ eps*sigma*(Tk+Tik)(Tk^2+Tik^2) with radiation);
//   sink = bit2*gs*hh + bit4*gs*hh; srhs = sink*t_inf;
//   al = glo*f_lo; ch = glo*f_hi; coup = al + ch + sink;
//   w_r = coup > 0 ? cp(T_r)*inv_dtor : 1       (scaled-row elimination,
//   b = w_r + coup; d = rhs*w_r + srhs           pallas_vp2.py:335-349)
//   and a = -al, c = -ch.
// The coup > 0 gate is right for films >= 0 only; the callers refuse
// negative films.  The system is strictly diagonally dominant: b - |a| -
// |c| = w_r + sink > 0 (cp > 0), and a row with coup = 0 is an identity row;
// so, as for K1 (csrc/sweeps.cu), neither level of the split solve needs
// pivoting.
//
// What bounds it on the H100: memory -- read rhs (4) + T (4) + code (1),
// write x (4) = 13 B/cell at float32; k, cp, the faces and the films live
// in registers only.  The first version ran one warp per block over 32
// pencils, staged [32 pencils x 32 rows] tiles and sent c' and d' through
// global scratch (+16 B/cell): 16-27% of its byte model.  Design: K2's on
// the split-line core (csrc/split_line.cuh; csrc/sweeps.cu explains it):
// a warp owns one line, its lanes the chunks of M rows; the persistent
// block stages its lines of rhs, T and code with cp.async,
// double-buffered across the line groups it walks, each chunk padded so
// that the lanes' strided reads hit distinct banks; phase (a) forms the
// chunk's rows in registers and eliminates inside it, (b) solves the
// reduced rows on the warp (registers and shuffles for one chunk a lane,
// PCR in shared memory for more), (c) writes the solution back into the
// staged rhs, which leaves in coalesced rows.  c' and d' never leave the
// SM.  k(T) is evaluated once a row: a chunk's k at rows row0 - 1 and
// row0 + M comes from the neighbouring lanes by shuffle; with more than
// one chunk a lane (lines over 32 M rows) lanes 0 and 31 evaluate the row
// across the seam between rounds themselves, and phase (c) forms the
// earlier rounds' rows again, as K2 reloads them.  A line of at most 16
// chunks shares its warp with others (32 / chunks lines a warp: a line's
// end rows couple to nothing, so one reduced solve serves them all).  A
// line too long to stage with two blocks an SM (~5,100 rows at float32,
// ~2,700 at float64) goes to the core's strided kernel on the z layout
// (lanes = lines n apart, rows contiguous, reduced rows in global memory),
// where a chunk evaluates its neighbours' k itself: no length is refused.
// What holds it at a third of its byte model on the H100 (PERF.md §6):
// latency, not bytes or arithmetic -- 128 registers leave 16 warps an SM,
// each lane forms and eliminates 16 rows in sequence (a rounded division
// a face), and rounding each operation once costs nothing measurable
// against FMA-contracted helpers.  cp(T) is evaluated at every row and
// selected where coup > 0 (under a branch, evaluated where coup > 0 alone,
// K8 ran 1.27x slower), and tables of up to four segments are summed
// without a branch (6% faster).  A variant in which the block formed its
// lines' rows together, cell by cell into shared memory (k, then the
// faces, then b and d), and the lanes only eliminated them, ran 1.7x
// slower.
//
// Rounding: k, cp, the faces and the films repeat the plain version
// (solvers/vp2.py) bit for bit (the _rn helpers of varprop.cuh); the split
// solve is not Thomas order and takes the hardware reciprocal at float32:
// a few float32 ulp of the output's scale from the plain version
// (chip_smoke.py KERNEL_TOL_ULP = 8).  float64 divides.
#include "split_line.cuh"
#include "varprop.cuh"

namespace {

using atf::add;
using atf::mul;

// Tables of at most kK8SmallSeg segments are summed without a branch.
constexpr int kK8SmallSeg = 4;

template <typename T>
struct Vp2Params {
  atf::Table<T> ktab, ctab;
  T glo, gs, inv_dtor, h, t_inf, rc, tik, tik2;
  int rad;
};

// Forms and eliminates the chunk of rows row0 .. row0 + M - 1 (identity
// rows past n).  tat(k), cat(k), rat(k): row k's T, code byte and rhs,
// asked for rows below n only; kf, kl: k(T) at rows row0 and row0 + M - 1
// (where below n); k_prev, cd_prev: k(T) and the code at row0 - 1 (row0 >
// 0); k_after: k(T) at row0 + M (where below n).
template <int kSeg, typename T, int M, typename TAt, typename CAt,
          typename RAt>
__device__ __forceinline__ void vp2_chunk(Chunk<T, M, false>& ch,
                                          const TAt& tat, const CAt& cat,
                                          const RAt& rat, int64_t row0,
                                          int64_t n, T kf, T kl, T k_prev,
                                          unsigned cd_prev, T k_after,
                                          const Vp2Params<T>& p) {
  T k_cur = kf;
  // the previous row's f_hi, from the same two k values
  T f_lo = (row0 > 0 && (cd_prev & 1u)) ? atf::harm_rn(k_prev, kf) : T(0);
  ch.load_rows(
      [&](int k, T& a, T& b, T& c, T& d) {
        const int64_t i = row0 + k;
        if (i >= n) {
          a = c = d = T(0);
          b = T(1);
          return;
        }
        const T tc = tat(k);
        const unsigned cd = cat(k);
        T k_nxt;
        if (i == n - 1) {          // replicated, as the plain version has
          k_nxt = k_cur;           // it (bit 1 is clear there)
        } else if (k == M - 1) {
          k_nxt = k_after;
        } else if (k == M - 2) {
          k_nxt = kl;
        } else {
          k_nxt = atf::table<kSeg>(p.ktab, tat(k + 1));
        }
        const T f_hi = (cd & 1u) ? atf::harm_rn(k_cur, k_nxt) : T(0);
        const T hr = p.rad ? atf::rad_film_rn(tc, p.rc, p.tik, p.tik2) : T(0);
        const T hh = add(p.h, hr);
        const T sink = add(mul(mul(atf::bit<T>(cd, 2u), p.gs), hh),
                           mul(mul(atf::bit<T>(cd, 4u), p.gs), hh));
        const T al = mul(p.glo, f_lo);
        const T ch_hi = mul(p.glo, f_hi);
        const T coup = add(add(al, ch_hi), sink);
        // cp at every row, selected where coup > 0: a branch here cost
        // more than the evaluations it saves
        const T cp = atf::table<kSeg>(p.ctab, tc);
        const T wr = coup > T(0) ? mul(cp, p.inv_dtor) : T(1);
        a = -al;
        c = -ch_hi;
        b = add(wr, coup);
        d = add(mul(rat(k), wr), mul(sink, p.t_inf));
        f_lo = f_hi;
        k_cur = k_nxt;
      },
      row0, n);
}

// The rows of K8 for the core's strided kernel (lines too long to stage):
// a chunk evaluates k at its neighbouring rows itself.
template <typename T>
struct Vp2Rows {
  const T* rhs;
  const T* Tf;
  const uint8_t* code;
  Vp2Params<T> p;

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    const int64_t nv = valid ? n : 0;       // no line: identity rows
    auto at = [&](int64_t i) { return base + i * rs; };
    auto kat = [&](int64_t i) {
      return (i >= 0 && i < nv) ? atf::table<0>(p.ktab, __ldg(Tf + at(i)))
                                : T(0);
    };
    const unsigned cd_prev =
        (row0 > 0 && row0 - 1 < nv) ? __ldg(code + at(row0 - 1)) : 0u;
    vp2_chunk<0, T, M>(
        ch, [&](int k) { return __ldg(Tf + at(row0 + k)); },
        [&](int k) { return (unsigned)__ldg(code + at(row0 + k)); },
        [&](int k) { return __ldg(rhs + at(row0 + k)); }, row0, nv,
        kat(row0), kat(row0 + M - 1), kat(row0 - 1), cd_prev, kat(row0 + M),
        p);
  }
};

// K8's launch shape: two warps a block, M = 16 rows a lane (8 for lines of
// up to kK8M8Rows rows), as K2; a line is staged where a block of one line
// takes at most kK8StageKB of shared memory (two blocks an SM), else it
// goes to the core's strided kernel (at 8192 rows, float32, 2.3x faster
// than one staged line an SM).
constexpr int kK8Lines = 2;
constexpr int kK8M8Rows = 256;
constexpr int kK8StageKB = 113;

template <typename T, int M, int kSeg>
__global__ void __launch_bounds__(32 * kK8Lines) vp2_sweep_z_kernel(
    const T* __restrict__ rhs, const T* __restrict__ Tf,
    const uint8_t* __restrict__ code, T* __restrict__ out, int64_t npen,
    int64_t n, int R, int P, ZLayout L, int code_async,
    const __grid_constant__ Vp2Params<T> p) {
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char atf_smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = L.W;                             // lines a group: P a warp
  const int rows = 2 * 32 * R;
  // P > 1 (lines of at most 16 chunks): the warp's lanes hold P lines, nch
  // lanes each; a line's first and last rows couple to nothing beyond it,
  // so one reduced solve over the warp solves them all
  const int nch = (int)atf::cdiv(n, M);
  const int lq = P > 1 ? lane / nch : 0;         // the lane's line
  const int lj = P > 1 ? lane - lq * nch : lane; // and its chunk (R = 1)
  unsigned char* red = atf_smem + 2 * L.buf_bytes;
  T* A = reinterpret_cast<T*>(red) + (size_t)w * 6 * rows;
  T* Cc = A + rows;
  T* D = Cc + rows;                              // then PCR's scratch

  auto X = [&](int buf) {
    return reinterpret_cast<T*>(atf_smem + buf * L.buf_bytes);
  };
  auto TT = [&](int buf) {
    return reinterpret_cast<T*>(atf_smem + buf * L.buf_bytes + L.x_bytes);
  };
  auto CT = [&](int buf) {
    return reinterpret_cast<uint8_t*>(atf_smem + buf * L.buf_bytes +
                                      L.x_bytes + L.f_bytes);
  };
  auto vidx = [](int64_t i) { return (int)(i / M * (M + 1) + i % M); };
  auto cidx = [](int64_t i) { return (int)(i / M * (M + 4) + i % M); };

  const int64_t G = atf::cdiv(npen, W);
  auto stage_group = [&](int64_t g, int buf) {
    T* x = X(buf);
    T* tt = TT(buf);
    uint8_t* ct = CT(buf);
    for (int q = 0; q < W; ++q) {
      const int64_t pen = g * W + q;
      if (pen >= npen) break;
      const int64_t g0 = pen * n;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        const int s = q * L.pitch + vidx(i);
        stage<T, T>(x + s, rhs + g0 + i);
        stage<T, T>(tt + s, Tf + g0 + i);
      }
      if (code_async) {
        for (int64_t i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
          cp_async(ct + q * L.cpitch + cidx(i), code + g0 + i, 4);
        }
      } else {
        for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
          ct[q * L.cpitch + cidx(i)] = code[g0 + i];
        }
      }
    }
    cp_async_commit();
  };

  int buf = 0;
  int64_t g = blockIdx.x;
  if (g < G) stage_group(g, 0);
  for (; g < G; g += gridDim.x, buf ^= 1) {
    if (g + gridDim.x < G) {
      stage_group(g + gridDim.x, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (g * W + w * P < npen) {                  // the warp has a line
      const int64_t pen = g * W + w * P + lq;
      // a lane past the warp's lines or the field's: identity rows
      const int64_t nv = (lq < P && pen < npen) ? n : 0;
      T* x = X(buf) + (w * P + lq) * L.pitch;
      const T* tt = TT(buf) + (w * P + lq) * L.pitch;
      const uint8_t* ct = CT(buf) + (w * P + lq) * L.cpitch;
      Chunk<T, M, false> ch;
      // (a) for chunk j (every lane of the warp together: shuffles)
      auto eliminate = [&](int j) {
        const int64_t row0 = (int64_t)j * M;
        const T* tj = tt + j * (M + 1);
        const uint8_t* cj = ct + j * (M + 4);
        const T* xj = x + j * (M + 1);
        const T kf = row0 < nv ? atf::table<kSeg>(p.ktab, tj[0]) : T(0);
        const T kl =
            row0 + M - 1 < nv ? atf::table<kSeg>(p.ktab, tj[M - 1]) : T(0);
        T k_prev = __shfl_up_sync(kAll, kl, 1);
        T k_after = __shfl_down_sync(kAll, kf, 1);
        // the seams between rounds: the row across lies in another round
        const bool lo = lane == 0 && row0 > 0 && row0 - 1 < nv;
        const bool hi = lane == 31 && row0 + M < nv;
        if (lo || hi) {
          const T kk =
              atf::table<kSeg>(p.ktab, tt[vidx(lo ? row0 - 1 : row0 + M)]);
          if (lo) {
            k_prev = kk;
          } else {
            k_after = kk;
          }
        }
        const unsigned cd_prev =
            (row0 > 0 && row0 - 1 < nv) ? ct[cidx(row0 - 1)] : 0u;
        vp2_chunk<kSeg, T, M>(
            ch, [&](int k) { return tj[k]; },
            [&](int k) { return (unsigned)cj[k]; },
            [&](int k) { return xj[k]; }, row0, nv, kf, kl, k_prev, cd_prev,
            k_after, p);
      };
      auto put_x = [&](int j, T x0, T xl) {
#pragma unroll
        for (int k = 0; k < M; ++k) {
          if ((int64_t)j * M + k < nv) x[j * (M + 1) + k] = ch.x(k, x0, xl);
        }
      };
      if (R == 1) {                              // lines of <= 32 chunks
        eliminate(lj);                           // (a)
        T x0, xl;                                // (b) in registers
        warp_reduced(ch.a[0], ch.c[0], ch.d[0], ch.a[M - 1], ch.c[M - 1],
                     ch.d[M - 1], lane, x0, xl);
        put_x(lj, x0, xl);                       // (c), into the rhs tile
      } else {
        for (int r = 0; r < R; ++r) {            // (a): lanes = chunks
          const int j = r * 32 + lane;
          eliminate(j);
          ch.put_reduced(A, Cc, D, 2 * j, 2 * j + 1);
        }
        __syncwarp();                            // (b), the warp
        const T* Xr = pcr_reduced(A, Cc, D, D + rows, D + 2 * rows,
                                  D + 3 * rows, rows, 1, 0, lane, 32,
                                  [] { __syncwarp(); });
        __syncwarp();
        auto put = [&](int j) { put_x(j, Xr[2 * j], Xr[2 * j + 1]); };
        put((R - 1) * 32 + lane);                // (c), into the rhs tile
        for (int r = 0; r < R - 1; ++r) {
          eliminate(r * 32 + lane);
          put(r * 32 + lane);
        }
      }
    }
    __syncthreads();
    // coalesced stores of the group's solution
    for (int q = 0; q < W; ++q) {
      const int64_t pq = g * W + q;
      if (pq >= npen) break;
      const T* x = X(buf) + q * L.pitch;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        out[pq * n + i] = x[vidx(i)];
      }
    }
    __syncthreads();
  }
}

template <typename T, int M, int kSeg>
cudaError_t launch_vp2_z_m(const T* rhs, const T* Tf, const uint8_t* code,
                           T* out, int64_t npen, int64_t n,
                           const Vp2Params<T>& p, int device,
                           cudaStream_t stream) {
  const int R = (int)atf::cdiv(n, 32 * M);
  // lines of at most 16 chunks: P lines a warp
  const int nch = (int)atf::cdiv(n, M);
  const int P = nch <= 16 ? 32 / nch : 1;
  auto bytes = [&](int nw) {                     // nw warps a block
    return 2 * z_layout<T, T, M>(nw * P, n, 1).buf_bytes +
           z_reduced_bytes<T>(nw, R);
  };
  if (bytes(1) > (size_t)atf::imin(smem_limit(device), kK8StageKB * 1024)) {
    // such lines are long: past shared memory for the core's reduced rows
    return launch_split_strided_m<T, Vp2Rows<T>, 16, true>(
        Vp2Rows<T>{rhs, Tf, code, p}, out, 1, n, npen, n, 1, stream);
  }
  int nw = kK8Lines;
  while (nw > 1 && bytes(nw) > 100 * 1024) nw /= 2;
  const int W = nw * P;                          // lines a group
  const size_t smem = bytes(nw);
  const ZLayout L = z_layout<T, T, M>(W, n, 1);
  auto* kernel = vp2_sweep_z_kernel<T, M, kSeg>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * nw,
                                                smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t groups = atf::cdiv(npen, W);
  const int64_t blocks = atf::imin(groups, (int64_t)(per_sm > 0 ? per_sm : 1)
                                               * (sms > 0 ? sms : 1));
  const int code_async =
      (n % 4 == 0) && (reinterpret_cast<uintptr_t>(code) % 4 == 0);
  kernel<<<(unsigned)blocks, 32 * nw, smem, stream>>>(
      rhs, Tf, code, out, npen, n, R, P, L, code_async, p);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_vp2_sweep_z(const void* rhs, const void* Tf,
                               const void* code, void* out, int64_t npen,
                               int64_t n, const double* ktab, int kn,
                               const double* ctab, int cn, double glo,
                               double gs, double inv_dtor, double h,
                               double t_inf, double rc, double tik,
                               double tik2, int with_rad, int device,
                               cudaStream_t stream) {
  Vp2Params<T> p;
  atf::make_table(ktab, kn, &p.ktab);
  atf::make_table(ctab, cn, &p.ctab);
  p.glo = (T)glo;
  p.gs = (T)gs;
  p.inv_dtor = (T)inv_dtor;
  p.h = (T)h;
  p.t_inf = (T)t_inf;
  p.rc = (T)rc;
  p.tik = (T)tik;
  p.tik2 = (T)tik2;
  p.rad = with_rad;
  auto* r = static_cast<const T*>(rhs);
  auto* t = static_cast<const T*>(Tf);
  auto* c = static_cast<const uint8_t*>(code);
  auto* o = static_cast<T*>(out);
  const bool small = kn <= kK8SmallSeg && cn <= kK8SmallSeg;
  if (n > kK8M8Rows) {
    return small ? launch_vp2_z_m<T, 16, kK8SmallSeg>(r, t, c, o, npen, n, p,
                                                      device, stream)
                 : launch_vp2_z_m<T, 16, 0>(r, t, c, o, npen, n, p, device,
                                            stream);
  }
  return small ? launch_vp2_z_m<T, 8, kK8SmallSeg>(r, t, c, o, npen, n, p,
                                                   device, stream)
               : launch_vp2_z_m<T, 8, 0>(r, t, c, o, npen, n, p, device,
                                         stream);
}

}  // namespace

ATF_API int atf_vp2_sweep_z(int dtype, int device, const void* rhs,
                            const void* Tf, const void* code, void* out,
                            int64_t npen, int64_t n, const double* ktab,
                            int kn, const double* ctab, int cn, double glo,
                            double gs, double inv_dtor, double h,
                            double t_inf, double rc, double tik, double tik2,
                            int with_rad, void* stream) {
  if (kn < 0 || kn > atf::kMaxSeg || cn < 0 || cn > atf::kMaxSeg) {
    return (int)cudaErrorInvalidValue;
  }
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_vp2_sweep_z<T>(
                   rhs, Tf, code, out, npen, n, ktab, kn, ctab, cn, glo, gs,
                   inv_dtor, h, t_inf, rc, tik, tik2, with_rad, device,
                   (cudaStream_t)stream))));
}
