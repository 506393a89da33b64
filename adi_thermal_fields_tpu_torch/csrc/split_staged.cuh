// The split-line core's staged sweep along the contiguous last axis, for
// row formers that read their rows from streams of a storage type S and
// solve them at a compute type C (K17's natural z, K21's z entry: S = C;
// K26: a bfloat16 state solved at float32), and optionally from a code
// byte a row (K10).
//
// K19's design (csrc/varprop_z.cu; K2's and K8's layout): a warp owns one
// line, its lanes the chunks of M rows; the persistent block stages its
// lines' right-hand side and the former's kStreams streams with cp.async,
// double-buffered across the line groups it walks (single-buffered where
// the former asks: Rows::kBuffers), each chunk padded so
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
// Storage (S != C, bfloat16): the right-hand side and the streams are
// staged as S, chunks M + 2 values apart (`staged_stride`: rows in pairs
// of one 4-byte word, (M + 2) / 2 words a chunk, odd, so the lanes' reads
// still hit distinct banks), by 4-byte cp.async where every line starts
// on a word (n even, the streams word-aligned; plain loads otherwise:
// K26 at 384^3 took 0.94 ms with plain loads against 0.51 with pairs,
// PERF.md section 6); `load_staged` widens them with atf::ld, the
// solution has a tile of its own at C, and every cell leaves through
// atf::st(out, x, key, natural index): rounded to nearest (key < 0) or
// stochastically, as the plain version rounds (solvers/rounding.py).
//
// Code bytes (Rows::kCode): the former's `code` is staged too, chunks M +
// 4 bytes apart (ZLayout's cpitch), by 4-byte cp.async where n is a
// multiple of 4 and the codes word-aligned (K2's staging), and
// `load_staged` reads the line's code tile.
//
// Stiff lines (Rows::kReplay): the kernel flags each line with a row past
// the former's ratio (`load_staged` sets `stiff`) in a byte a line, and
// `staged_replay_kernel` solves the flagged lines again in Thomas order
// (`Rows::replay`, 32 lines a warp, rows read from global memory), bit for
// bit the plain version; csrc/field_rows.cuh says why.
//
// `Rows`: `kStreams`, `rhs` (staged into the solution's tile where S = C),
// `stream(t)` for t < kStreams, `kCols` per-row columns `col(t)` at C
// (staged once a block: one value a row, the same for every line),
// optionally `kCode` and `code`, `load_staged(ch, x, f, fs, cols, cs, ct,
// j, nv, stiff)` (chunk j of a line whose right-hand side is staged at x,
// stream t at f + t*fs, slot j*staged_stride + k for row j*M + k; column
// t at cols + t*cs, slot j*(M+1) + k; code bytes at ct, slot j*(M+4) + k;
// identity rows from nv on), and the strided `load`, `kReplay`, `replay`
// and `replay_bytes` of csrc/split_line.cuh.
#pragma once

#include "split_line.cuh"

namespace {

// K19's launch shape: two warps a block, M = 16 rows a lane (8 for lines
// of up to kStagedM8Rows rows, 12 up to kStagedM12Rows; at float32 32 for
// lines of kStagedM16Rows to 1,024 rows: one chunk a lane, the reduced
// rows in registers); a line
// is staged where a block of one line takes at most kStagedKB of shared
// memory (two blocks an SM), else it goes to the core's strided kernel.
constexpr int kStagedLines = 2;
constexpr int kStagedM8Rows = 256;
constexpr int kStagedM16Rows = 512;
constexpr int kStagedKB = 113;
// M = 12 for lines of kStagedM8Rows + 1 to kStagedM12Rows rows: 32 chunks
// at 384 rows, where M = 16 leaves a quarter of the lanes idle (K26 at
// 384^3: 0.43 against 0.51 ms at bfloat16, 0.54 against 0.59 at float32;
// PERF.md section 6); off where it equals kStagedM8Rows
constexpr int kStagedM12Rows = 384;

// Values between a staged S tile's chunks: M + 1 (odd: conflict-free
// strided reads), M + 2 for 2-byte types (rows in 4-byte pairs).
template <typename S, int M>
__host__ __device__ constexpr int staged_stride() {
  return sizeof(S) == 2 ? M + 2 : M + 1;
}

// Rows::kBuffers: the groups of lines staged at once, 2 (the next group's
// copy overlaps this one's solve) or 1 (room for more blocks an SM: K10,
// as K8's general form); 2 where the former names none (K26 ran no faster
// on one: 0.376 ms in the bf16 step either way, PERF.md section 6).
template <typename Rows, typename = void>
struct StagedBuffers : std::integral_constant<int, 2> {};
template <typename Rows>
struct StagedBuffers<Rows, std::void_t<decltype(Rows::kBuffers)>>
    : std::integral_constant<int, Rows::kBuffers> {};

// Rows::kCode where the former reads a code byte a row (K10), else false.
template <typename Rows, typename = void>
struct CodeRows : std::false_type {};
template <typename Rows>
struct CodeRows<Rows, std::void_t<decltype(Rows::kCode)>>
    : std::bool_constant<Rows::kCode> {};

template <typename S, typename C, typename Rows, int M>
__global__ void __launch_bounds__(32 * kStagedLines) split_staged_kernel(
    const __grid_constant__ Rows rows, S* __restrict__ out,
    uint8_t* __restrict__ flags, int64_t npen, int64_t n, int R, int P,
    ZLayout L, int64_t key) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  // S != C: the right-hand side staged as S after the streams, the
  // solution in the C tile
  constexpr bool kWide = !std::is_same_v<S, C>;
  constexpr bool kCd = CodeRows<Rows>::value;
  constexpr int kBufs = StagedBuffers<Rows>::value;
  constexpr int nf = Rows::kStreams;
  const int lane = threadIdx.x & 31;
  const int wp = threadIdx.x >> 5;
  const int W = L.W;                             // lines a group: P a warp
  const int red = 2 * 32 * R;
  const int fs = (int)(L.f_bytes / sizeof(S));   // one stream's tile
  // P > 1 (lines of at most 16 chunks): the warp's lanes hold P lines, nch
  // lanes each
  const int nch = (int)atf::cdiv(n, M);
  const int fp = kWide ? nch * staged_stride<S, M>() : L.pitch;
  const int lq = P > 1 ? lane / nch : 0;         // the lane's line
  const int lj = P > 1 ? lane - lq * nch : lane; // and its chunk (R = 1)
  C* A = reinterpret_cast<C*>(atf_smem + kBufs * L.buf_bytes) +
         (size_t)wp * 6 * red;
  // the former's per-row columns (kCols), staged once in the chunks'
  // padded layout, column t at cols + t*L.pitch
  C* cols = reinterpret_cast<C*>(atf_smem + kBufs * L.buf_bytes) +
            (size_t)(blockDim.x >> 5) * 6 * red;
  C* Cc = A + red;
  C* D = Cc + red;                               // then PCR's scratch

  auto X = [&](int buf) {
    return reinterpret_cast<C*>(atf_smem + buf * L.buf_bytes);
  };
  auto F = [&](int buf) {
    return reinterpret_cast<S*>(atf_smem + buf * L.buf_bytes + L.x_bytes);
  };
  auto CT = [&](int buf) {
    return atf_smem + buf * L.buf_bytes + L.x_bytes +
           (nf + (kWide ? 1 : 0)) * L.f_bytes;
  };
  auto vidx = [](int64_t i) { return (int)(i / M * (M + 1) + i % M); };
  auto sidx = [](int64_t i) {
    return (int)(i / M * staged_stride<S, M>() + i % M);
  };
  auto cidx = [](int64_t i) { return (int)(i / M * (M + 4) + i % M); };
  auto word = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 4 == 0;
  };
  // bfloat16 in 4-byte pairs: every line's first row on a word
  bool pairs = false;
  if constexpr (kWide) {
    pairs = n % 2 == 0 && word(rows.rhs);
#pragma unroll
    for (int t = 0; t < nf; ++t) pairs = pairs && word(rows.stream(t));
  }
  bool code_async = false;
  if constexpr (kCd) code_async = n % 4 == 0 && word(rows.code);

  const int64_t G = atf::cdiv(npen, W);
  auto stage_group = [&](int64_t g, int buf) {
    S* f = F(buf);
    for (int q = 0; q < W; ++q) {
      const int64_t pen = g * W + q;
      if (pen >= npen) break;
      const int64_t g0 = pen * n;
      if constexpr (kWide) {
        if (pairs) {
          for (int64_t i = 2 * threadIdx.x; i < n; i += 2 * blockDim.x) {
            const int s = q * fp + sidx(i);
            cp_async(f + nf * fs + s, rows.rhs + g0 + i, 4);
#pragma unroll
            for (int t = 0; t < nf; ++t) {
              cp_async(f + t * fs + s, rows.stream(t) + g0 + i, 4);
            }
          }
        } else {
          for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
            const int s = q * fp + sidx(i);
            stage<S, S>(f + nf * fs + s, rows.rhs + g0 + i);
#pragma unroll
            for (int t = 0; t < nf; ++t) {
              stage<S, S>(f + t * fs + s, rows.stream(t) + g0 + i);
            }
          }
        }
      } else {
        C* x = X(buf);
        for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
          const int s = q * L.pitch + vidx(i);
          stage<C, S>(x + s, rows.rhs + g0 + i);
#pragma unroll
          for (int t = 0; t < nf; ++t) {
            stage<S, S>(f + t * fs + s, rows.stream(t) + g0 + i);
          }
        }
      }
      if constexpr (kCd) {
        uint8_t* ct = CT(buf) + q * L.cpitch;
        if (code_async) {
          for (int64_t i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
            cp_async(ct + cidx(i), rows.code + g0 + i, 4);
          }
        } else {
          for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
            ct[cidx(i)] = rows.code[g0 + i];
          }
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
  for (; g < G; g += gridDim.x, buf ^= kBufs - 1) {
    if (kBufs == 2 && g + gridDim.x < G) {
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
      C* x = X(buf) + lo;
      const S* f = F(buf) + (wp * P + lq) * fp;
      const S* xr;                               // the staged rhs
      if constexpr (kWide) {
        xr = f + nf * fs;
      } else {
        xr = x;
      }
      const uint8_t* ct = CT(buf) + (wp * P + lq) * L.cpitch;
      Chunk<C, M, false> ch;
      bool stiff = false;
      auto eliminate = [&](int j) {
        rows.load_staged(ch, xr, f, fs, cols, L.pitch, ct, j, nv, stiff);
      };
      auto put_x = [&](int j, C x0, C xl) {
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
      if constexpr (StiffRows<Rows>::value) {    // flag the stiff lines
        const unsigned all = __ballot_sync(0xffffffffu, stiff);
        const unsigned mine =
            P > 1 ? ((1u << nch) - 1u) << (lq * nch) : 0xffffffffu;
        if (lj == 0 && nv > 0) flags[pen] = (all & mine) != 0u;
      }
      if (R == 1) {                              // lines of <= 32 chunks
        C x0, xl;                                // (b) in registers
        warp_reduced(ch.a[0], ch.c[0], ch.d[0], ch.a[M - 1], ch.c[M - 1],
                     ch.d[M - 1], lane, x0, xl);
        put_x(lj, x0, xl);                       // (c), into the x tile
      } else {
        __syncwarp();                            // (b), the warp
        const C* Xr = pcr_reduced(A, Cc, D, D + red, D + 2 * red,
                                  D + 3 * red, red, 1, 0, lane, 32,
                                  [] { __syncwarp(); });
        __syncwarp();
        // (c), into the x tile: the last round first, whose rows are
        // still in registers; the earlier rounds formed again (where S =
        // C the rhs of round r's chunks is not overwritten before they
        // are)
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
      const C* x = X(buf) + q * L.pitch;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        atf::st(&out[pq * n + i], x[vidx(i)], key, pq * n + i);
      }
    }
    __syncthreads();
    if (kBufs == 1 && g + gridDim.x < G) stage_group(g + gridDim.x, 0);
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

template <typename C, typename Rows, int M, typename S>
cudaError_t launch_split_staged_m(const Rows& rows, S* out, uint8_t* flags,
                                  int64_t npen, int64_t n, int device,
                                  cudaStream_t stream, int64_t key) {
  constexpr bool kWide = !std::is_same_v<S, C>;
  static_assert(!(kWide && StiffRows<Rows>::value),
                "the Thomas-order replay writes d' into out at C");
  const int R = (int)atf::cdiv(n, 32 * M);
  // lines of at most 16 chunks: P lines a warp
  const int nch = (int)atf::cdiv(n, M);
  const int P = nch <= 16 ? 32 / nch : 1;
  auto layout = [&](int W) {
    // S != C: the rhs as a stream of S, every S tile at staged_stride
    ZLayout L = z_layout<S, C, M>(W, n, Rows::kStreams + (kWide ? 1 : 0));
    if constexpr (kWide) {
      const int nfs = Rows::kStreams + 1;
      L.buf_bytes -= nfs * L.f_bytes;
      L.f_bytes = (sizeof(S) * (size_t)W * nch * staged_stride<S, M>() + 15)
                  / 16 * 16;
      L.buf_bytes += nfs * L.f_bytes;
    }
    if constexpr (!CodeRows<Rows>::value) {      // no code bytes staged
      L.buf_bytes -= L.c_bytes;
      L.c_bytes = 0;
    }
    return L;
  };
  auto bytes = [&](int nw) {                     // nw warps a block
    const ZLayout L = layout(nw * P);
    return StagedBuffers<Rows>::value * L.buf_bytes +
           z_reduced_bytes<C>(nw, R) + sizeof(C) * Rows::kCols * L.pitch;
  };
  if (bytes(1) > (size_t)atf::imin(smem_limit(device), kStagedKB * 1024)) {
    // lines n apart, rows contiguous
    return launch_split_strided<C, Rows>(rows, out, 1, n, npen, n, 1, device,
                                         stream, key);
  }
  int nw = kStagedLines;
  while (nw > 1 && bytes(nw) > 100 * 1024) nw /= 2;
  const size_t smem = bytes(nw);
  auto* kernel = split_staged_kernel<S, C, Rows, M>;
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
      rows, out, flags, npen, n, R, P, layout(nw * P), key);
  if constexpr (StiffRows<Rows>::value) {
    const size_t rsmem = Rows::replay_bytes(n);
    auto* replay = staged_replay_kernel<C, Rows>;
    cudaFuncSetAttribute(replay, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)rsmem);
    replay<<<(unsigned)atf::cdiv(npen, 32), 32, rsmem, stream>>>(
        rows, out, flags, npen, n);
  }
  return cudaSuccess;
}

// The npen lines of n contiguous rows of a C-contiguous (npen, n) field,
// solved with `rows`' rows at C into `out` (S: stored through atf::st with
// `key`, the cell's natural index its counter); `flags`: npen bytes for
// the stiff lines' flags where Rows::kReplay (the caller's buffer: the
// kernels allocate nothing), else unused.
template <typename C, typename Rows, typename S>
cudaError_t launch_split_staged(const Rows& rows, S* out, uint8_t* flags,
                                int64_t npen, int64_t n, int device,
                                cudaStream_t stream, int64_t key = -1) {
  if (n <= kStagedM8Rows) {
    return launch_split_staged_m<C, Rows, 8>(rows, out, flags, npen, n,
                                             device, stream, key);
  }
  if constexpr (kStagedM12Rows > kStagedM8Rows) {
    if (n <= kStagedM12Rows) {
      return launch_split_staged_m<C, Rows, 12>(rows, out, flags, npen, n,
                                                device, stream, key);
    }
  }
  if constexpr (sizeof(C) == 4) {
    if (n > kStagedM16Rows && n <= 1024) {
      return launch_split_staged_m<C, Rows, 32>(rows, out, flags, npen, n,
                                                device, stream, key);
    }
  }
  return launch_split_staged_m<C, Rows, 16>(rows, out, flags, npen, n,
                                            device, stream, key);
}

}  // namespace
