// The periodic split-line sweep of K11, K16, K18 and K22: a tridiagonal
// solve along the middle axis of a (B1, n, B2) field whose rows 0 and n-1
// couple across the wrap (phi of the natural (r, phi, z) field; K22 along
// any axis).
//
// Layout: K7's, the split-line core's strided kernel (csrc/split_line.cuh)
// with lines B2 apart: a warp's lanes are 32 lines adjacent in B2, so every
// row's load and store is coalesced; the block's W warps split the lines'
// chunks of M rows, warp w owning chunks [w R, (w+1) R).
//
// The wrap, by Sherman-Morrison in the gauge of solvers/thomas.cyclic_thomas:
// gamma = -b_0, beta = a_0 and alpha = c_{n-1} come out of the matrix,
// b_0 -= gamma and b_{n-1} -= alpha beta / gamma, and
// x = y - z (y_0 + beta y_{n-1}/gamma) / (1 + z_0 + beta z_{n-1}/gamma)
// with B y = d and B z = u, u = gamma e_0 + alpha e_{n-1}.  The second
// right-hand side costs the chunks nothing: u enters as couplings to two
// virtual unknowns, 0 in the solve for y and 1 in that for z -- row 0's
// a = -gamma, row n-1's c = -alpha, and the rows past n-1 of row n-1's chunk
// pass its last unknown on (x_k - x_{k+1} = 0), so that chunk's last
// unknown is the virtual one.  The chunks eliminate d alone; in the reduced
// system z's right-hand side is -a' of chunk 0's first row and -c' of row
// n-1's chunk's last row (both couplings then cleared), and phase (b)
// solves both columns (`block_reduced_warps<kTwo>`).  Inside a chunk z's
// right-hand side is zero, so phase (c) takes z_k = -a'_k z_first - c'_k
// z_last.  fact needs y and z at rows 0 and n-1: the thread of row n-1's
// chunk keeps that row's (a', c', d') and beta, gamma in shared memory;
// after phase (b) and one barrier every thread has them.  Row n-1's chunk
// forms row 0's a and b itself (b_{n-1} -= alpha beta / gamma needs them),
// one extra row.
//
// Stiff rings: a Thomas solve and a split solve of the same rows part by
// about the condition number times a rounding.  On the H100, every block
// split, over five seeds and two time steps (scripts/cyclic_tune.py,
// PERF.md section 6): up to 6 float32 ulp of the output's scale on blocks
// whose largest ratio (|a| + |c|) / (b - |a| - |c|) is below 12, 8.1 ulp
// (K11) and 1.1e-3 K (K16) between 12 and 16, ~140 ulp on a full disk's
// second ring: past the plain versions' gates (8 ulp, 1e-3 K).  The plain
// Thomas solve itself lies as far from the float64 solve of its rows.  So
// a block with a row past (|a| + |c|) > kStiff * (b - |a| - |c|) (the row
// former's rows and its constant Rows::kStiff, 12 for all four, decided
// after phase (a) with __syncthreads_or) solves its lines again in Thomas
// order instead, atf::ThomasStep and atf::sm_fact (cyclic_thomas's steps,
// one rounding each: its plain version bit for bit), with no line-length
// stream off chip: `replay_chain` where a thread keeps its rows on chip
// (every warp forms its rows, the elimination passes from warp to warp),
// else `replay` (one warp, (c', y', z') kept every S rows, each backward
// pass forming a segment's rows again from its checkpoint).  Both run
// three rounded divisions a row on one warp at a time: a chain block takes
// about five split blocks' time, a one-warp replay far more.
#pragma once

#include "split_line.cuh"

namespace {

// Line b2 of group b1 of a (B1, n, B2) field: row i at base + i * rs.
struct CycLine {
  int64_t base, rs, n, b1, b2;
  bool valid;   // false for a lane past the last line
  __device__ __forceinline__ int64_t at(int64_t i) const {
    return base + i * rs;
  }
};

// A periodic row former (K11 `MaskedCyclicRows` in csrc/masked.cu, K16
// `Vp2CyclicRows` in csrc/vp2_cyl.cu, K22 `FieldCyclicRows` and K18
// `VpFieldCyclicRows` in csrc/field_rows.cuh):
// `rows.template each<M>(line, row0, f)` forms the periodic rows row0 ..
// min(row0 + M, n) - 1 of a valid line in order and calls f(k, a, b, c, d)
// for each (row 0's a couples to x_{n-1}, row n-1's c to x_0), and
// `Rows::kStiff` is the stiffness ratio past which a block is replayed.
// A former with `Rows::kChunkTest` (K18, K22) has a chunk's rows tested
// once all are formed (a test between the rows' loads holds them back,
// as K21's did: PERF.md section 6), one without it (K11, K16) each row as
// it is formed.
template <typename Rows, typename = void>
struct ChunkTested : std::false_type {};
template <typename Rows>
struct ChunkTested<Rows, std::void_t<decltype(Rows::kChunkTest)>>
    : std::bool_constant<Rows::kChunkTest> {};

// Phase (a) of one chunk of a periodic line: the rows, the wrap moved out
// (beta, gamma from row 0; row 0 is formed first where the chunk holds it,
// else the caller formed it), the virtual couplings in, eliminated.
// `stiff` is set where a row of the line passes the former's stiffness
// ratio (Rows::kStiff).
template <typename C, int M, typename Rows>
__device__ __forceinline__ void load_cyclic(Chunk<C, M, false, true>& ch,
                                            const Rows& rows,
                                            const CycLine& L, int64_t row0,
                                            C& beta, C& gamma, bool& stiff) {
  const int64_t n = L.n;
  C b[M];
  const C pass = row0 < n ? C(-1) : C(0);    // rows past n-1 in its chunk
#pragma unroll
  for (int k = 0; k < M; ++k) {
    ch.a[k] = C(0);
    b[k] = C(1);
    ch.c[k] = row0 + k < n ? C(0) : pass;
    ch.d[k] = C(0);
  }
  if (L.valid) {
    rows.template each<M>(L, row0, [&](int k, C a, C bb, C c, C d) {
      ch.a[k] = a;
      b[k] = bb;
      ch.c[k] = c;
      ch.d[k] = d;
      if constexpr (!ChunkTested<Rows>::value) {
        const C off = fabs(a) + fabs(c);
        stiff = stiff || off > C(Rows::kStiff) * (bb - off);
      }
    });
    if constexpr (ChunkTested<Rows>::value) {     // the whole chunk's rows
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const C off = fabs(ch.a[k]) + fabs(ch.c[k]);
        stiff |= row0 + k < n && off > C(Rows::kStiff) * (b[k] - off);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int64_t i = row0 + k;
    if (i == 0) {
      beta = ch.a[k];
      gamma = -b[k];
      b[k] = atf::sub(b[k], gamma);
      ch.a[k] = -gamma;
    }
    if (i == n - 1) {
      const C alpha = ch.c[k];
      b[k] = atf::sub(b[k], atf::div(atf::mul(alpha, beta), gamma));
      ch.c[k] = -alpha;
    }
  }
  ch.eliminate(b);
}

// Rows a replay segment holds (a multiple of 16, so of M), from n: about
// sqrt(n) for the least shared memory, at least 64.
inline int replay_rows(int64_t n) {
  int s = 64;
  while ((int64_t)s * s < n) s += 16;
  return s;
}

// Shared memory of a replay: (c', y', z') after every segment and for each
// row of one segment, 32 lanes.
template <typename C>
size_t replay_bytes(int64_t n) {
  const int s = replay_rows(n);
  return sizeof(C) * 96 * ((size_t)atf::cdiv(n, s) + s);
}

// The line in Thomas order (warp 0 of a stiff block; lanes = lines).
template <typename C, int M, typename Rows>
__device__ __forceinline__ void replay(const Rows& rows, const CycLine& L,
                                       C* __restrict__ out, C* smem, int S) {
  const int lane = threadIdx.x & 31;
  const int64_t n = L.n;
  const int nseg = (int)atf::cdiv(n, S);
  C* ck = smem;                            // state after segment s: [s][3][32]
  C* buf = smem + (size_t)nseg * 96;       // a segment's rows: [row][3][32]
  C beta = C(0), gamma = C(-1);
  auto put = [&](C* p, const atf::ThomasStep<C>& t) {
    p[lane] = t.cp;
    p[32 + lane] = t.dy;
    p[64 + lane] = t.dz;
  };
  // forward, the state kept at the end of each segment
  atf::ThomasStep<C> t;
  for (int64_t row0 = 0; row0 < n; row0 += M) {
    if (L.valid) {
      rows.template each<M>(L, row0, [&](int k, C a, C b, C c, C d) {
        t.row(row0 + k, n, a, b, c, d, beta, gamma);
      });
    }
    if ((row0 + M) % S == 0 || row0 + M >= n) put(ck + (row0 / S) * 96, t);
  }
  // segment sg's rows again, from the state before it
  auto refill = [&](int sg) {
    atf::ThomasStep<C> s;
    if (sg > 0) {
      const C* p = ck + (sg - 1) * 96;
      s.cp = p[lane];
      s.dy = p[32 + lane];
      s.dz = p[64 + lane];
    }
    const int64_t r0 = (int64_t)sg * S, r1 = atf::imin(n, r0 + S);
    for (int64_t row0 = r0; row0 < r1; row0 += M) {
      if (L.valid) {
        rows.template each<M>(L, row0, [&](int k, C a, C b, C c, C d) {
          s.row(row0 + k, n, a, b, c, d, beta, gamma);
          put(buf + (row0 + k - r0) * 96, s);
        });
      }
    }
    return r1;
  };
  // backward: y into out, z to z_0; then fact; then z again and x
  C y = C(0), z = C(0), yn = C(0), zn = C(0);
  for (int sg = nseg - 1; sg >= 0; --sg) {
    const int64_t r1 = refill(sg);
    for (int64_t i = r1 - 1; i >= (int64_t)sg * S; --i) {
      const C* p = buf + (i - (int64_t)sg * S) * 96;
      y = atf::sub(p[32 + lane], atf::mul(p[lane], y));
      z = atf::sub(p[64 + lane], atf::mul(p[lane], z));
      if (i == n - 1) {
        yn = y;
        zn = z;
      }
      if (L.valid) out[L.at(i)] = y;
    }
  }
  const C fact = atf::sm_fact(y, z, yn, zn, beta, gamma);
  z = C(0);
  for (int sg = nseg - 1; sg >= 0; --sg) {
    const int64_t r1 = refill(sg);
    for (int64_t i = r1 - 1; i >= (int64_t)sg * S; --i) {
      const C* p = buf + (i - (int64_t)sg * S) * 96;
      z = atf::sub(p[64 + lane], atf::mul(p[lane], z));
      if (L.valid) {
        const int64_t o = L.at(i);
        out[o] = atf::sub(out[o], atf::mul(fact, z));
      }
    }
  }
}

// The lines in Thomas order with every warp of the block (a stiff block;
// lanes = lines, warp w's chunks as in the split solve): each thread forms
// its chunks' rows again (its last chunk in registers, the others in
// shared memory), the forward elimination passes from warp to warp in row
// order (the state after a warp's last row handed on in shared memory),
// the back substitution in reverse, each row's values replaced in place:
// (a, b, c, d), then (c', y', z'), then (y, z).  A turn's warp stages its
// last chunk in shared memory and runs its rows in a loop that is not
// unrolled (a smaller kernel, as fast as the unrolled one).  The serial
// Thomas steps bound it: ~0.25 ms a block of 512-row lines on the H100,
// five split blocks' time.  Fits where the chunks but each thread's last
// fit in shared memory (chain_bytes).
template <typename C, int M, typename Rows>
__device__ __forceinline__ void replay_chain(const Rows& rows,
                                             const CycLine& L,
                                             C* __restrict__ out, C* smem,
                                             int R) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int T = blockDim.x;
  const int64_t n = L.n;
  C* hand = smem;                                 // 5 x 32 handed on
  C* stage = smem + 5 * 32;                       // a turn's last chunk
  C* keep = stage + M * 4 * 32;                   // the other chunks
  // row k of chunk r: its four values at p[0], p[s], p[2 s], p[3 s]
  auto at = [&](int r, int k, int& s) -> C* {
    if (r == R - 1) {
      s = 32;
      return stage + k * 128 + lane;
    }
    s = T;
    return keep + (size_t)((r * M + k) * 4) * T + threadIdx.x;
  };
  C ra[M], rb[M], rc[M], rd[M];                   // the last chunk's rows
  for (int r = 0; r < R; ++r) {
    const int64_t row0 = (int64_t)(w * R + r) * M;
    if (L.valid && row0 < n) {
      rows.template each<M>(L, row0, [&](int k, C a, C b, C c, C d) {
        if (r == R - 1) {
          ra[k] = a;
          rb[k] = b;
          rc[k] = c;
          rd[k] = d;
        } else {
          int s;
          C* p = at(r, k, s);
          p[0] = a;
          p[s] = b;
          p[2 * s] = c;
          p[3 * s] = d;
        }
      });
    }
  }
  auto to_stage = [&]() {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      stage[k * 128 + lane] = ra[k];
      stage[k * 128 + 32 + lane] = rb[k];
      stage[k * 128 + 64 + lane] = rc[k];
      stage[k * 128 + 96 + lane] = rd[k];
    }
  };
  auto from_stage = [&]() {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      ra[k] = stage[k * 128 + lane];
      rc[k] = stage[k * 128 + 64 + lane];
      rd[k] = stage[k * 128 + 96 + lane];
    }
  };
  // forward, warp after warp: row values become (c', y', z')
  atf::ThomasStep<C> t;
  C beta = C(0), gamma = C(-1);
  for (int turn = 0; turn < W; ++turn) {
    if (w == turn) {
      if (turn > 0) {
        t.cp = hand[lane];
        t.dy = hand[32 + lane];
        t.dz = hand[64 + lane];
        beta = hand[96 + lane];
        gamma = hand[128 + lane];
      }
      to_stage();
#pragma unroll 1
      for (int j = 0; j < R * M; ++j) {
        const int r = j / M, k = j % M;
        const int64_t i = (int64_t)(w * R + r) * M + k;
        if (L.valid && i < n) {
          int s;
          C* p = at(r, k, s);
          t.row(i, n, p[0], p[s], p[2 * s], p[3 * s], beta, gamma);
          p[0] = t.cp;
          p[2 * s] = t.dy;
          p[3 * s] = t.dz;
        }
      }
      from_stage();
      hand[lane] = t.cp;
      hand[32 + lane] = t.dy;
      hand[64 + lane] = t.dz;
      hand[96 + lane] = beta;
      hand[128 + lane] = gamma;
    }
    __syncthreads();
  }
  // backward, warp after warp from the last: values become (y, z)
  C y = C(0), z = C(0), yn = C(0), zn = C(0);
  for (int turn = W - 1; turn >= 0; --turn) {
    if (w == turn) {
      if (turn < W - 1) {
        y = hand[lane];
        z = hand[32 + lane];
        yn = hand[64 + lane];
        zn = hand[96 + lane];
      }
      to_stage();
#pragma unroll 1
      for (int j = R * M - 1; j >= 0; --j) {
        const int r = j / M, k = j % M;
        const int64_t i = (int64_t)(w * R + r) * M + k;
        if (L.valid && i < n) {
          int s;
          C* p = at(r, k, s);
          const C cp = p[0];
          y = atf::sub(p[2 * s], atf::mul(cp, y));
          z = atf::sub(p[3 * s], atf::mul(cp, z));
          if (i == n - 1) {
            yn = y;
            zn = z;
          }
          p[2 * s] = y;
          p[3 * s] = z;
        }
      }
      from_stage();
      hand[lane] = y;
      hand[32 + lane] = z;
      hand[64 + lane] = yn;
      hand[96 + lane] = zn;
    }
    __syncthreads();
  }
  if (w == 0) hand[lane] = atf::sm_fact(y, z, yn, zn, beta, gamma);
  __syncthreads();
  const C fact = hand[lane];
  for (int r = 0; r < R; ++r) {                  // x = y - fact z
    const int64_t row0 = (int64_t)(w * R + r) * M;
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (L.valid && row0 + k < n) {
        int s;
        const C* p = at(r, k, s);
        const C yk = r == R - 1 ? rc[k] : p[2 * s];
        const C zk = r == R - 1 ? rd[k] : p[3 * s];
        out[L.at(row0 + k)] = atf::sub(yk, atf::mul(fact, zk));
      }
    }
  }
}

// Shared memory of replay_chain: the hand-on values, a turn's staged
// chunk and the rows of each thread's chunks but its last.
template <typename C>
size_t chain_bytes(int W, int R, int M) {
  return sizeof(C) * (5 * 32 + (size_t)4 * M * 32 +
                      (size_t)4 * M * (R - 1) * 32 * W);
}

// Shared memory of the split solve: phase (b)'s segment rows (4 x 2W x 33),
// the reduced rows (A, Cc, D, Dz: 2WR rows of 32 lines) unless kGlobal,
// row n-1's wrap values (5 x 32) and the kept rows (split_line.cuh).
template <typename C>
size_t cyclic_smem_bytes(int W, int R, int M, bool global, int keep) {
  const size_t kept = keep == kKeepRows ? (size_t)(M - 2) * 3 : 0;
  return sizeof(C) * ((size_t)33 * 4 * 2 * W +
                      (global ? 0 : (size_t)32 * 4 * 2 * W * R) + 5 * 32 +
                      (size_t)32 * W * (R - 1) * kept);
}

// The replay of a stiff block: `replay_chain` (S = -1) or `replay` with S
// rows a segment (S > 0).
template <typename C, typename Rows, int M, bool kGlobal, int kKeep>
__global__ void __launch_bounds__(32 * kSplitWarps<C>)
    split_cyclic_kernel(const __grid_constant__ Rows rows,
                        C* __restrict__ out, int64_t n, int64_t B2, int R,
                        int S, C* __restrict__ gred) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int red = 2 * W * R;                      // reduced rows per line
  C* A = kGlobal ? gred + (size_t)blockIdx.x * 4 * red * 32
                 : reinterpret_cast<C*>(atf_smem);
  C* Cc = A + red * 32;
  C* D = Cc + red * 32;
  C* Dz = D + red * 32;
  C* S2 = kGlobal ? reinterpret_cast<C*>(atf_smem) : Dz + red * 32;
  C* wrap = S2 + 4 * 2 * W * 33;   // beta, gamma, row n-1's a', c', d'
  C* keep = wrap + 5 * 32;
  auto kept = [&](int r, int k, int v) -> C& {
    return keep[((r * (M - 2) + k - 1) * 3 + v) * blockDim.x + threadIdx.x];
  };

  const int64_t gpb = atf::cdiv(B2, 32);          // line groups per b1
  const int64_t b1 = blockIdx.x / gpb;
  const int64_t b2 = (blockIdx.x - b1 * gpb) * 32 + lane;
  const CycLine L{b1 * n * B2 + b2, B2, n, b1, b2, b2 < B2};
  const int64_t jn = (n - 1) / M;                 // row n-1's chunk
  const int kn = (int)(n - 1 - jn * M);           // and its row there

  Chunk<C, M, false, true> ch;
  C beta = C(0), gamma = C(-1);
  bool stiff = false;
  auto eliminate = [&](int j) {
    if (j == jn && j > 0 && L.valid) {            // row 0's a and b
      rows.template each<1>(L, 0, [&](int, C a, C b, C, C) {
        beta = a;
        gamma = -b;
      });
    }
    load_cyclic(ch, rows, L, (int64_t)j * M, beta, gamma, stiff);
  };

  for (int r = 0; r < R; ++r) {                  // (a)
    const int j = w * R + r;
    eliminate(j);
    const int f = (2 * j) * 32 + lane, l = f + 32;
    ch.put_reduced(A, Cc, D, f, l);
    Dz[f] = C(0);
    Dz[l] = C(0);
    if (j == 0) {                                 // the virtual unknowns
      Dz[f] = -A[f];
      A[f] = C(0);
    }
    if (j == jn) {
      Dz[l] = -Cc[l];
      Cc[l] = C(0);
      // row n-1 = dw - aw x_first - cw x_last of its chunk
      C aw = kn == 0 ? C(-1) : C(0), cw = kn == M - 1 ? C(-1) : C(0);
      C dw = C(0);
#pragma unroll
      for (int k = 1; k < M - 1; ++k) {
        if (k == kn) {
          aw = ch.a[k];
          cw = ch.c[k];
          dw = ch.d[k];
        }
      }
      wrap[lane] = beta;
      wrap[32 + lane] = gamma;
      wrap[64 + lane] = aw;
      wrap[96 + lane] = cw;
      wrap[128 + lane] = dw;
    }
    if (kKeep == kKeepRows && r < R - 1) {
#pragma unroll
      for (int k = 1; k < M - 1; ++k) {
        kept(r, k, 0) = ch.a[k];
        kept(r, k, 1) = ch.c[k];
        kept(r, k, 2) = ch.d[k];
      }
    }
  }
  if (__syncthreads_or(stiff)) {                 // Thomas order instead
    if (S < 0) {
      replay_chain<C, M>(rows, L, out, reinterpret_cast<C*>(atf_smem), R);
    } else if (w == 0) {
      replay<C, M>(rows, L, out, reinterpret_cast<C*>(atf_smem), S);
    }
    return;
  }
  block_reduced_warps<C, true, true>(A, Cc, D, S2, lane, w, W, R, Dz);  // (b)
  __syncthreads();
  const int o = 2 * (int)jn * 32 + lane;
  const C aw = wrap[64 + lane], cw = wrap[96 + lane], dw = wrap[128 + lane];
  const C yn = dw - aw * D[o] - cw * D[o + 32];
  const C zn = -aw * Dz[o] - cw * Dz[o + 32];
  const C fact =
      atf::sm_fact(D[lane], Dz[lane], yn, zn, wrap[lane], wrap[32 + lane]);
  auto store = [&](int j) {                       // (c): x = y - fact z
    const int f = (2 * j) * 32 + lane;
    const C y0 = D[f], yl = D[f + 32], z0 = Dz[f], zl = Dz[f + 32];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = (int64_t)j * M + k;
      if (L.valid && i < n) {
        out[L.at(i)] = ch.x(k, y0, yl) - fact * ch.xz(k, z0, zl);
      }
    }
  };
  store(w * R + R - 1);                          // last chunk first
  for (int r = 0; r < R - 1; ++r) {
    if constexpr (kKeep == kKeepRows) {
#pragma unroll
      for (int k = 1; k < M - 1; ++k) {
        ch.a[k] = kept(r, k, 0);
        ch.c[k] = kept(r, k, 1);
        ch.d[k] = kept(r, k, 2);
      }
    } else {
      eliminate(w * R + r);
    }
    store(w * R + r);
  }
}

template <typename C, typename Rows, int M, bool kGlobal, int kKeep>
cudaError_t launch_split_cyclic_m(const Rows& rows, C* out, int64_t B1,
                                  int64_t n, int64_t B2, size_t smem, int S,
                                  cudaStream_t stream) {
  const int W = (int)atf::imin(kSplitWarps<C>, atf::cdiv(n, M));
  const int R = (int)atf::cdiv(n, (int64_t)W * M);
  const int64_t blocks = B1 * atf::cdiv(B2, 32);
  C* gred = nullptr;
  if (kGlobal) {
    const size_t bytes = sizeof(C) * (size_t)blocks * 4 * 2 * W * R * 32;
    const cudaError_t err =
        cudaMallocAsync(reinterpret_cast<void**>(&gred), bytes, stream);
    if (err != cudaSuccess) return err;
  }
  auto* kernel = split_cyclic_kernel<C, Rows, M, kGlobal, kKeep>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(rows, out, n, B2, R, S,
                                                      gred);
  if (kGlobal) {
    const cudaError_t launch_err = cudaGetLastError();
    const cudaError_t free_err = cudaFreeAsync(gred, stream);
    return launch_err != cudaSuccess ? launch_err : free_err;
  }
  return cudaSuccess;
}

// The periodic lines b2 of groups b1 of a (B1, n >= 2, B2) field, solved
// with `rows`' rows into `out`: 8-row chunks with the first chunks'
// eliminated rows kept, else formed again, else 16-row chunks with the
// reduced rows in global memory (past 1,536 rows at float32, 768 at
// float64); stiff blocks (Rows::kStiff) replayed in
// Thomas order.  Lines on which no replay fits in shared memory (past
// ~91,000 rows at float32, ~22,000 at float64) are refused
// (cudaErrorInvalidValue) rather than left to the split solve.
template <typename C, typename Rows>
cudaError_t launch_split_cyclic(const Rows& rows, C* out, int64_t B1,
                                int64_t n, int64_t B2, int device,
                                cudaStream_t stream) {
  const size_t limit = (size_t)smem_limit(device);
  if (replay_bytes<C>(n) > limit) return cudaErrorInvalidValue;
  // the shared memory of a launch shape and the replay it takes
  auto shape = [&](int M, bool global, int keep, int& S) {
    const int W = (int)atf::imin(kSplitWarps<C>, atf::cdiv(n, M));
    const int R = (int)atf::cdiv(n, (int64_t)W * M);
    const size_t b = cyclic_smem_bytes<C>(W, R, M, global, keep);
    const size_t cb = chain_bytes<C>(W, R, M);
    S = cb <= limit ? -1 : replay_rows(n);
    const size_t r = S < 0 ? cb : replay_bytes<C>(n);
    return r > b ? r : b;
  };
  int S = -1;
  size_t smem = shape(8, false, kKeepRows, S);
  if (smem <= limit) {
    return launch_split_cyclic_m<C, Rows, 8, false, kKeepRows>(
        rows, out, B1, n, B2, smem, S, stream);
  }
  smem = shape(8, false, kKeepNone, S);
  if (smem <= limit) {
    return launch_split_cyclic_m<C, Rows, 8, false, kKeepNone>(
        rows, out, B1, n, B2, smem, S, stream);
  }
  smem = shape(16, true, kKeepNone, S);
  return launch_split_cyclic_m<C, Rows, 16, true, kKeepNone>(
      rows, out, B1, n, B2, smem, S, stream);
}

}  // namespace
