// K19: the stream-reading variable-property sweep along the contiguous z
// axis of the natural (x, y, z) field.
//
// Replaces adi_thermal_fields_tpu/solvers/pallas_varprop.py
// fused_varprop_sweep (:251, body _varprop_kernel :60) in its natural-z
// form (nat_rhs_out=True), the z solve of the Cartesian varprop step when
// the tier-2 sweep K8 does not apply: per-face or field films (h_axes,
// h_field), callable cp, float64 states.  The JAX kernel reads the rhs and
// writes the result in the natural layout but its code, fc, w and h
// streams z-leading (z, x, y), which the step makes with a transpose pair;
// here every stream is natural, so the step transposes nothing.
//
// Rows: atf::vp_row_coeffs (varprop.cuh), the rows of K6, K7 and K7x,
// from the rhs, the z sweep code (sweep_code(mask, None, 2) moved to the
// natural layout; bits 1/2/8), the pre-masked lower-face conductivity
// fc_z (K5), w = 1/(rho cp) and a film stream h or the scalar rob_c; one
// rounding per operation in the plain version's order, so the rows equal
// the plain version's bit for bit.  Row i's upper face is fc[i+1]: the
// TPU kernel runs one row lagged for it and finishes the last row with a
// zero upper face (:189-197); here it is the next staged slot, zero past
// the last row.
//
// What bounds it on the H100: memory -- read rhs (4) + code (1) + fc (4) +
// w (4) [+ h (4)], write x (4): 17 B/cell, 21 with h (float32).  The first
// version ran one warp per block over 32 pencils, staged [32 pencils x 32
// rows] tiles and sent c' and d' through global scratch (+16 B/cell):
// 16-33% of its byte model.  Design: K2's and K8's on the split-line core
// (csrc/split_line.cuh; csrc/sweeps.cu explains it): a warp owns one line,
// its lanes the chunks of M rows; the persistent block stages its lines of
// rhs, fc, w, h and code with cp.async, double-buffered across the line
// groups it walks, each chunk padded so that the lanes' strided reads hit
// distinct banks; phase (a) forms the chunk's rows in registers and
// eliminates inside it, (b) solves the reduced rows on the warp (registers
// and shuffles for one chunk a lane, PCR in shared memory for more), (c)
// writes the solution back into the staged rhs, which leaves in coalesced
// rows.  c' and d' never leave the SM.  A line of at most 16 chunks shares
// its warp with others (32 / chunks lines a warp: a line's end rows couple
// to nothing, so one reduced solve serves them all).  A line too long to
// stage with two blocks an SM (~3,100 rows at float32 with the h stream,
// ~1,600 at float64) goes to the core's strided kernel on the z layout
// (lanes = lines n apart, rows contiguous, K7's rows): no length is
// refused.
//
// Rounding: the split solve is not Thomas order and takes the hardware
// reciprocal at float32: a few float32 ulp of the output's scale from the
// plain version (chip_smoke.py KERNEL_TOL_ULP = 8).  float64 divides.
//
// bfloat16 (K19b): the staged split-line kernel of csrc/split_staged.cuh
// (K26's) with K19's rows (vp_rows.cuh VpZRows): the rhs and fc, w, h
// staged at bfloat16 in 4-byte pairs where the lines allow, the code bytes
// staged, the rows solved at float32, every cell stored through atf::st
// with the key (JAX's z store rounds with `sr + 3`,
// pallas_varprop.py:227/238); lines too long to stage take the core's
// strided kernel with K7's rows.  9 B/cell (rhs 2, code 1, fc 2, w 2, x
// 2), 11 with h.
#include "vp_rows.cuh"

namespace {

// K19's launch shape, K8's: two warps a block, M = 16 rows a lane (8 for
// lines of up to kK19M8Rows rows); a line is staged where a block of one
// line takes at most kK19StageKB of shared memory (two blocks an SM), else
// it goes to the core's strided kernel.
constexpr int kK19Lines = 2;
constexpr int kK19M8Rows = 256;
constexpr int kK19StageKB = 113;

template <typename T>
struct VpZParams {
  T tg, sk, t_inf, rob_c;
};

template <typename T, int M>
__global__ void __launch_bounds__(32 * kK19Lines) vp_sweep_z_kernel(
    const T* __restrict__ rhs, const uint8_t* __restrict__ code,
    const T* __restrict__ fc, const T* __restrict__ w,
    const T* __restrict__ h, T* __restrict__ out, int64_t npen, int64_t n,
    int R, int P, ZLayout L, int code_async, VpZParams<T> p) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  const int lane = threadIdx.x & 31;
  const int wp = threadIdx.x >> 5;
  const int W = L.W;                             // lines a group: P a warp
  const int rows = 2 * 32 * R;
  const bool has_h = h != nullptr;
  const int nf = has_h ? 3 : 2;                  // staged streams: fc, w, h
  // P > 1 (lines of at most 16 chunks): the warp's lanes hold P lines, nch
  // lanes each; a line's first and last rows couple to nothing beyond it,
  // so one reduced solve over the warp solves them all
  const int nch = (int)atf::cdiv(n, M);
  const int lq = P > 1 ? lane / nch : 0;         // the lane's line
  const int lj = P > 1 ? lane - lq * nch : lane; // and its chunk (R = 1)
  unsigned char* red = atf_smem + 2 * L.buf_bytes;
  T* A = reinterpret_cast<T*>(red) + (size_t)wp * 6 * rows;
  T* Cc = A + rows;
  T* D = Cc + rows;                              // then PCR's scratch

  auto X = [&](int buf) {
    return reinterpret_cast<T*>(atf_smem + buf * L.buf_bytes);
  };
  auto F = [&](int buf, int slot) {
    return reinterpret_cast<T*>(atf_smem + buf * L.buf_bytes + L.x_bytes +
                                slot * L.f_bytes);
  };
  auto CT = [&](int buf) {
    return reinterpret_cast<uint8_t*>(atf_smem + buf * L.buf_bytes +
                                      L.x_bytes + nf * L.f_bytes);
  };
  auto vidx = [](int64_t i) { return (int)(i / M * (M + 1) + i % M); };
  auto cidx = [](int64_t i) { return (int)(i / M * (M + 4) + i % M); };

  const int64_t G = atf::cdiv(npen, W);
  auto stage_group = [&](int64_t g, int buf) {
    T* x = X(buf);
    T* fs = F(buf, 0);
    T* ws = F(buf, 1);
    T* hs = F(buf, 2);
    uint8_t* ct = CT(buf);
    for (int q = 0; q < W; ++q) {
      const int64_t pen = g * W + q;
      if (pen >= npen) break;
      const int64_t g0 = pen * n;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        const int s = q * L.pitch + vidx(i);
        stage<T, T>(x + s, rhs + g0 + i);
        stage<T, T>(fs + s, fc + g0 + i);
        stage<T, T>(ws + s, w + g0 + i);
        if (has_h) stage<T, T>(hs + s, h + g0 + i);
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

    if (g * W + wp * P < npen) {                 // the warp has a line
      const int64_t pen = g * W + wp * P + lq;
      // a lane past the warp's lines or the field's: identity rows
      const int64_t nv = (lq < P && pen < npen) ? n : 0;
      const int lo = (wp * P + lq) * L.pitch;
      T* x = X(buf) + lo;
      const T* fs = F(buf, 0) + lo;
      const T* ws = F(buf, 1) + lo;
      const T* hs = F(buf, 2) + lo;
      const uint8_t* ct = CT(buf) + (wp * P + lq) * L.cpitch;
      Chunk<T, M, false> ch;
      // (a) for chunk j: row k's upper face is the next staged slot (the
      // next chunk's first past the chunk's last row)
      auto eliminate = [&](int j) {
        const int64_t row0 = (int64_t)j * M;
        const int s0 = j * (M + 1);
        T f_lo = row0 < nv ? fs[s0] : T(0);
        ch.load_rows(
            [&](int k, T& a, T& b, T& c, T& d) {
              const int64_t i = row0 + k;
              if (i >= nv) {
                a = c = d = T(0);
                b = T(1);
                return;
              }
              const int s = s0 + k;
              const T f_hi =
                  i + 1 < nv ? fs[k < M - 1 ? s + 1 : s + 2] : T(0);
              atf::vp_row_coeffs<T>(ct[j * (M + 4) + k], f_lo, f_hi, ws[s],
                                    has_h ? hs[s] : p.rob_c, x[s], p.tg,
                                    p.sk, p.t_inf, a, b, c, d);
              f_lo = f_hi;
            },
            row0, nv);
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
        // (c), into the rhs tile: the last round first, whose rows are
        // still in registers; the earlier rounds formed again (the rhs of
        // round r's chunks is not overwritten before they are)
        auto put = [&](int j) { put_x(j, Xr[2 * j], Xr[2 * j + 1]); };
        put((R - 1) * 32 + lane);
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

template <typename T, int M>
cudaError_t launch_vp_z_m(const VpRows<T, T>& rows, T* out, int64_t npen,
                          int64_t n, int device, cudaStream_t stream) {
  const int R = (int)atf::cdiv(n, 32 * M);
  // lines of at most 16 chunks: P lines a warp
  const int nch = (int)atf::cdiv(n, M);
  const int P = nch <= 16 ? 32 / nch : 1;
  const int nf = rows.h != nullptr ? 3 : 2;
  auto bytes = [&](int nw) {                     // nw warps a block
    return 2 * z_layout<T, T, M>(nw * P, n, nf).buf_bytes +
           z_reduced_bytes<T>(nw, R);
  };
  if (bytes(1) > (size_t)atf::imin(smem_limit(device), kK19StageKB * 1024)) {
    // lines n apart, rows contiguous
    return launch_split_strided<T, VpRows<T, T>>(rows, out, 1, n, npen, n,
                                                 1, device, stream);
  }
  int nw = kK19Lines;
  while (nw > 1 && bytes(nw) > 100 * 1024) nw /= 2;
  const int W = nw * P;                          // lines a group
  const size_t smem = bytes(nw);
  const ZLayout L = z_layout<T, T, M>(W, n, nf);
  auto* kernel = vp_sweep_z_kernel<T, M>;
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
      (n % 4 == 0) && (reinterpret_cast<uintptr_t>(rows.code) % 4 == 0);
  kernel<<<(unsigned)blocks, 32 * nw, smem, stream>>>(
      rows.rhs, rows.code, rows.fc, rows.w, rows.h, out, npen, n, R, P, L,
      code_async, VpZParams<T>{rows.tg, rows.sk, rows.t_inf, rows.rob_c});
  return cudaSuccess;
}

// K19b: a bfloat16 state on the staged split-line kernel (K26's,
// csrc/split_staged.cuh) with K19's rows (VpZRows), stored through
// atf::st with the key.
template <bool kH>
cudaError_t launch_vp_z_bf16(const VpRows<__nv_bfloat16, float>& rows,
                             __nv_bfloat16* out, int64_t npen, int64_t n,
                             int device, cudaStream_t stream, int64_t key) {
  return launch_split_staged<float, VpZRows<__nv_bfloat16, float, kH>>(
      VpZRows<__nv_bfloat16, float, kH>{rows}, out, nullptr, npen, n, device,
      stream, key);
}

// K19 at S = C (K19's staged kernel, M by the line's length), K19b at a
// bfloat16 state.
template <typename S, typename C>
cudaError_t launch_vp_z(const VpRows<S, C>& rows, S* out, int64_t npen,
                        int64_t n, int device, cudaStream_t stream,
                        int64_t key) {
  if constexpr (sizeof(S) == 2) {
    return rows.h != nullptr
               ? launch_vp_z_bf16<true>(rows, out, npen, n, device, stream,
                                        key)
               : launch_vp_z_bf16<false>(rows, out, npen, n, device, stream,
                                         key);
  } else {
    return n > kK19M8Rows
               ? launch_vp_z_m<C, 16>(rows, out, npen, n, device, stream)
               : launch_vp_z_m<C, 8>(rows, out, npen, n, device, stream);
  }
}

}  // namespace

ATF_API int atf_varprop_sweep_z(int dtype, int device, const void* rhs,
                                const void* code, const void* fc,
                                const void* w, const void* h, void* out,
                                int64_t npen, int64_t n, double tg,
                                double sk, double t_inf, double rob_c,
                                int64_t key, void* stream) {
  ATF_DISPATCH_STATE(
      dtype, device,
      const VpRows<S, C> rows{static_cast<const S*>(rhs),
                              static_cast<const uint8_t*>(code),
                              static_cast<const S*>(fc),
                              static_cast<const S*>(w),
                              static_cast<const S*>(h), (C)tg, (C)sk,
                              (C)t_inf, (C)rob_c};
      ATF_RETURN_IF((launch_vp_z<S, C>(rows, static_cast<S*>(out), npen, n,
                                       device, (cudaStream_t)stream,
                                       key))));
}
