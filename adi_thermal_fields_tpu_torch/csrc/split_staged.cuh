// The split-line core's staged sweep along the contiguous last axis, for
// row formers that read their rows from streams of the compute type alone
// (K17's natural z, K21's z entry).
//
// K19's design (csrc/varprop_z.cu; K2's and K8's layout): a warp owns one
// line, its lanes the chunks of M rows; the persistent block stages its
// lines' right-hand side and the former's kStreams streams with cp.async,
// double-buffered across the line groups it walks, each chunk padded so
// that the lanes' strided reads hit distinct banks; phase (a) forms the
// chunk's rows from the staged slots (`Rows::load_staged`) and eliminates
// inside it, (b) solves the reduced rows on the warp (registers and
// shuffles for one chunk a lane, PCR in shared memory for more), (c)
// writes the solution back into the staged right-hand side, which leaves
// in coalesced rows.  c' and d' never leave the SM.  A line of at most 16
// chunks shares its warp with others (32 / chunks lines a warp: a line's
// end rows couple to nothing, so one reduced solve serves them all).  A
// line too long to stage with two blocks an SM goes to the core's strided
// kernel on the z layout (lanes = lines n apart, rows contiguous,
// `Rows::load`): no length is refused.
//
// Stiff lines (Rows::kReplay): the kernel flags each line with a row past
// the former's ratio (`load_staged` sets `stiff`) in a byte a line, and
// `staged_replay_kernel` solves the flagged lines again in Thomas order
// (`Rows::replay`, 32 lines a warp, rows read from global memory), bit for
// bit the plain version; csrc/field_rows.cuh says why.
//
// `Rows`: `kStreams`, `rhs` (staged into the solution's tile), `stream(t)`
// for t < kStreams, `kCols` per-row columns `col(t)` (staged once a block:
// one value a row, the same for every line), `load_staged(ch, x, f, fs,
// cols, cs, j, nv, stiff)` (chunk j of a line whose right-hand side is
// staged at x, stream t at f + t*fs and column t at cols + t*cs, slot
// j*(M+1) + k for row j*M + k; identity rows from nv on), and the strided
// `load`, `kReplay`, `replay` and `replay_bytes` of csrc/split_line.cuh.
#pragma once

#include "split_line.cuh"

namespace {

// K19's launch shape: two warps a block, M = 16 rows a lane (8 for lines
// of up to kStagedM8Rows rows; at float32 32 for lines of kStagedM16Rows
// to 1,024 rows: one chunk a lane, the reduced rows in registers); a line
// is staged where a block of one line takes at most kStagedKB of shared
// memory (two blocks an SM), else it goes to the core's strided kernel.
constexpr int kStagedLines = 2;
constexpr int kStagedM8Rows = 256;
constexpr int kStagedM16Rows = 512;
constexpr int kStagedKB = 113;

template <typename T, typename Rows, int M>
__global__ void __launch_bounds__(32 * kStagedLines) split_staged_kernel(
    const __grid_constant__ Rows rows, T* __restrict__ out,
    uint8_t* __restrict__ flags, int64_t npen, int64_t n, int R, int P,
    ZLayout L) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  constexpr int nf = Rows::kStreams;
  const int lane = threadIdx.x & 31;
  const int wp = threadIdx.x >> 5;
  const int W = L.W;                             // lines a group: P a warp
  const int red = 2 * 32 * R;
  const int fs = (int)(L.f_bytes / sizeof(T));   // one stream's tile
  // P > 1 (lines of at most 16 chunks): the warp's lanes hold P lines, nch
  // lanes each
  const int nch = (int)atf::cdiv(n, M);
  const int lq = P > 1 ? lane / nch : 0;         // the lane's line
  const int lj = P > 1 ? lane - lq * nch : lane; // and its chunk (R = 1)
  T* A = reinterpret_cast<T*>(atf_smem + 2 * L.buf_bytes) +
         (size_t)wp * 6 * red;
  // the former's per-row columns (kCols), staged once in the chunks'
  // padded layout, column t at cols + t*L.pitch
  T* cols = reinterpret_cast<T*>(atf_smem + 2 * L.buf_bytes) +
            (size_t)(blockDim.x >> 5) * 6 * red;
  T* Cc = A + red;
  T* D = Cc + red;                               // then PCR's scratch

  auto X = [&](int buf) {
    return reinterpret_cast<T*>(atf_smem + buf * L.buf_bytes);
  };
  auto F = [&](int buf) {
    return reinterpret_cast<T*>(atf_smem + buf * L.buf_bytes + L.x_bytes);
  };
  auto vidx = [](int64_t i) { return (int)(i / M * (M + 1) + i % M); };

  const int64_t G = atf::cdiv(npen, W);
  auto stage_group = [&](int64_t g, int buf) {
    T* x = X(buf);
    T* f = F(buf);
    for (int q = 0; q < W; ++q) {
      const int64_t pen = g * W + q;
      if (pen >= npen) break;
      const int64_t g0 = pen * n;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        const int s = q * L.pitch + vidx(i);
        stage<T, T>(x + s, rows.rhs + g0 + i);
#pragma unroll
        for (int t = 0; t < nf; ++t) {
          stage<T, T>(f + t * fs + s, rows.stream(t) + g0 + i);
        }
      }
    }
    cp_async_commit();
  };

  int buf = 0;
  int64_t g = blockIdx.x;
#pragma unroll
  for (int t = 0; t < Rows::kCols; ++t) {
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      cols[t * L.pitch + vidx(i)] = __ldg(rows.col(t) + i);
    }
  }
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
      const T* f = F(buf) + lo;
      Chunk<T, M, false> ch;
      bool stiff = false;
      auto eliminate = [&](int j) {
        rows.load_staged(ch, x, f, fs, cols, L.pitch, j, nv, stiff);
      };
      auto put_x = [&](int j, T x0, T xl) {
#pragma unroll
        for (int k = 0; k < M; ++k) {
          if ((int64_t)j * M + k < nv) x[j * (M + 1) + k] = ch.x(k, x0, xl);
        }
      };
      if (R == 1) {                              // (a)
        eliminate(lj);
      } else {
        for (int r = 0; r < R; ++r) {            // lanes = chunks
          const int j = r * 32 + lane;
          eliminate(j);
          ch.put_reduced(A, Cc, D, 2 * j, 2 * j + 1);
        }
      }
      if constexpr (Rows::kReplay) {             // flag the stiff lines
        const unsigned all = __ballot_sync(0xffffffffu, stiff);
        const unsigned mine =
            P > 1 ? ((1u << nch) - 1u) << (lq * nch) : 0xffffffffu;
        if (lj == 0 && nv > 0) flags[pen] = (all & mine) != 0u;
      }
      if (R == 1) {                              // lines of <= 32 chunks
        T x0, xl;                                // (b) in registers
        warp_reduced(ch.a[0], ch.c[0], ch.d[0], ch.a[M - 1], ch.c[M - 1],
                     ch.d[M - 1], lane, x0, xl);
        put_x(lj, x0, xl);                       // (c), into the rhs tile
      } else {
        __syncwarp();                            // (b), the warp
        const T* Xr = pcr_reduced(A, Cc, D, D + red, D + 2 * red,
                                  D + 3 * red, red, 1, 0, lane, 32,
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

// The lines the staged kernel flagged, in Thomas order: a warp a block,
// its lanes 32 consecutive lines of the (npen, n) field (rows contiguous,
// lanes n apart), `Rows::replay` with the shared memory of a segment.
template <typename T, typename Rows>
__global__ void __launch_bounds__(32) staged_replay_kernel(
    const __grid_constant__ Rows rows, T* __restrict__ out,
    const uint8_t* __restrict__ flags, int64_t npen, int64_t n) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  const int64_t pen = (int64_t)blockIdx.x * 32 + threadIdx.x;
  const bool valid = pen < npen && flags[pen] != 0;
  if (!__any_sync(0xffffffffu, valid)) return;
  rows.replay(out, pen * n, 1, n, valid, reinterpret_cast<T*>(atf_smem));
}

template <typename T, typename Rows, int M>
cudaError_t launch_split_staged_m(const Rows& rows, T* out, uint8_t* flags,
                                  int64_t npen, int64_t n, int device,
                                  cudaStream_t stream) {
  const int R = (int)atf::cdiv(n, 32 * M);
  // lines of at most 16 chunks: P lines a warp
  const int nch = (int)atf::cdiv(n, M);
  const int P = nch <= 16 ? 32 / nch : 1;
  auto layout = [&](int W) {                     // no code bytes staged
    ZLayout L = z_layout<T, T, M>(W, n, Rows::kStreams);
    L.buf_bytes -= L.c_bytes;
    L.c_bytes = 0;
    return L;
  };
  auto bytes = [&](int nw) {                     // nw warps a block
    const ZLayout L = layout(nw * P);
    return 2 * L.buf_bytes + z_reduced_bytes<T>(nw, R) +
           sizeof(T) * Rows::kCols * L.pitch;
  };
  if (bytes(1) > (size_t)atf::imin(smem_limit(device), kStagedKB * 1024)) {
    // lines n apart, rows contiguous
    return launch_split_strided<T, Rows>(rows, out, 1, n, npen, n, 1, device,
                                         stream);
  }
  int nw = kStagedLines;
  while (nw > 1 && bytes(nw) > 100 * 1024) nw /= 2;
  const size_t smem = bytes(nw);
  auto* kernel = split_staged_kernel<T, Rows, M>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * nw,
                                                smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t groups = atf::cdiv(npen, (int64_t)nw * P);
  const int64_t blocks = atf::imin(groups, (int64_t)(per_sm > 0 ? per_sm : 1)
                                               * (sms > 0 ? sms : 1));
  kernel<<<(unsigned)blocks, 32 * nw, smem, stream>>>(
      rows, out, flags, npen, n, R, P, layout(nw * P));
  if constexpr (Rows::kReplay) {
    const size_t rsmem = Rows::replay_bytes(n);
    auto* replay = staged_replay_kernel<T, Rows>;
    cudaFuncSetAttribute(replay, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)rsmem);
    replay<<<(unsigned)atf::cdiv(npen, 32), 32, rsmem, stream>>>(
        rows, out, flags, npen, n);
  }
  return cudaSuccess;
}

// The npen lines of n contiguous rows of a C-contiguous (npen, n) field,
// solved with `rows`' rows into `out`; `flags`: npen bytes for the stiff
// lines' flags where Rows::kReplay (the caller's buffer: the kernels
// allocate nothing), else unused.
template <typename T, typename Rows>
cudaError_t launch_split_staged(const Rows& rows, T* out, uint8_t* flags,
                                int64_t npen, int64_t n, int device,
                                cudaStream_t stream) {
  if (n <= kStagedM8Rows) {
    return launch_split_staged_m<T, Rows, 8>(rows, out, flags, npen, n,
                                             device, stream);
  }
  if constexpr (sizeof(T) == 4) {
    if (n > kStagedM16Rows && n <= 1024) {
      return launch_split_staged_m<T, Rows, 32>(rows, out, flags, npen, n,
                                                device, stream);
    }
  }
  return launch_split_staged_m<T, Rows, 16>(rows, out, flags, npen, n,
                                            device, stream);
}

}  // namespace
