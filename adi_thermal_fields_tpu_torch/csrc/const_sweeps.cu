// K12, K13 and K14: the constant-row sweeps of the unmasked cylindrical
// step (r, z and the periodic phi solve).
//
// K12 replaces adi_thermal_fields_tpu/solvers/pallas_sweeps.py
//    fused_sweep_const (:1567) in its axis-0 form (call site :1641, body
//    _const_sweep_kernel :1479): the tridiagonal solve along axis 0 of a
//    C-contiguous (n, B) field -- r of the natural (r, phi, z) field -- with
//    per-row scalar a, b, c and a per-row rhs addition radd.
// K13 replaces fused_sweep_const with nat_rhs_out=True (call site :1605,
//    body _const_sweep_kernel_nat :1512): the same rows along the
//    CONTIGUOUS last axis (z of the natural field).
// K14 replaces the fused_cyclic_const family -- fused_cyclic_const (:1727,
//    body :1659), fused_cyclic_const_axis1 (:1851, body :1770) and
//    fused_cyclic_const_nat (:1958, body :1888), one function in three TPU
//    layouts -- in the natural layout: the periodic solve (I - fac L_per) x
//    = d along axis 1 of a (B1, n, B2) field (phi), one fac per B1 index
//    (per ring; every caller broadcasts it over z).
//
// The recurrence (the Pallas bodies' reciprocal-multiply form):
//   inv_i = 1/(b_i - a_i cp_{i-1}),  cp_i = c_i inv_i,
//   d'_i = (d_i + radd_i - a_i d'_{i-1}) inv_i,  x_i = d'_i - cp_i x_{i+1}.
// The coefficients depend on the row only (K14: on the ring and the row),
// so inv and cp are the same for every line.  K12 and K13: one thread of
// each block computes them into shared memory before the lines start, and
// each line carries only d'.  K14 also solves the Sherman-Morrison system
// B z = u (a = c = -fac, b = 1 + 2 fac, gamma = -b, b_0 = 2b, b_{n-1} = b
// - a a/gamma, u = gamma e_0 + a e_{n-1}), so a line carries only y and
// x = y - z (y_0 + a y_{n-1}/gamma)/(1 + z_0 + a z_{n-1}/gamma); its ring's
// inv, cp, z and the fix-up's denominator come from a table built once a
// ring by `cyclic_const_table_kernel` (the step keeps it for its dt).
//
// Rounding: K12 and K13 take every operation as one IEEE rounding
// (atf::add/sub/mul/div, the _rn intrinsics) in the order of the plain
// versions in solvers/const_sweeps.py, which compute inv and cp once per
// row the same way, so kernel and plain version agree bit for bit; so does
// K14's table.  K14 splits each line across warps (not Thomas order): a
// few float32 ulp of the output's scale from its plain version (up to 3 on
// rings whose stiffness ratio 2 fac = (|a| + |c|)/(b - |a| - |c|) stays
// below 128, up to 10 past 1024 on 4096-row lines; PERF.md section 6).
// K14 solves the rings past kK14Stiff (a full disk's innermost rings at
// 0.5 mm cells) in Thomas order, bit for bit.
//
// What bounds them on the H100: memory.  The byte model (float32) reads rhs
// 4 and writes x 4 = 8 B/cell (the coefficient vectors add < 0.01 B/cell).
//   K12: one thread per (phi, z) pencil; adjacent threads read adjacent
//        addresses.  d' goes through the output (+8 B/cell round trip).
//   K13: one warp owns 32 pencils and stages [32 pencils x 32 rows] tiles
//        of rhs, d' and x through shared memory (coalesced, lane = row),
//        then each lane recurs along its pencil (lane = pencil; padded
//        pitch); d' goes through the output (K2/K10's design).
//   K14: a tile's lanes are 32 lines adjacent in z of one ring, its warps
//        consecutive runs of phi rows, kept in registers (lines of up to
//        32 kK14Warps rows at float32, 16 kK14Warps at float64): the field
//        is read once and written once, the table's factors come through
//        the read-only cache (the same address across a warp), the
//        carries between the runs through shared memory, and no line
//        divides.  The blocks are persistent and load their next tile's
//        rows before solving this one (on the H100 the (128, 512, 512)
//        annulus took 0.30 ms a block a tile, 0.21 so; PERF.md section 6).
//        Longer lines read their rows again in each pass (24 B/cell).
//        Its first version marched a thread a pencil (y' through the
//        output, read back twice: 20 B/cell) after thread 0 of every
//        block had formed the ring's factors in a serial chain of
//        divisions.
#include <tuple>

#include "common.cuh"

namespace {

using atf::add;
using atf::div;
using atf::mul;
using atf::sub;

// inv_i and cp_i of a constant-row tridiagonal system (one thread)
template <typename T>
__device__ void row_factors(const T* __restrict__ a, const T* __restrict__ b,
                            const T* __restrict__ c, int64_t n,
                            T* __restrict__ inv, T* __restrict__ cp) {
  T cprev = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const T iv = div(T(1), sub(b[i], mul(a[i], cprev)));
    cprev = mul(c[i], iv);
    inv[i] = iv;
    cp[i] = cprev;
  }
}

// d'_i from d'_{i-1}
template <typename T>
__device__ __forceinline__ T forward(T d, T radd, T a, T inv, T dp) {
  return mul(sub(add(d, radd), mul(a, dp)), inv);
}

template <typename T>
__global__ void __launch_bounds__(256) const_sweep_strided_kernel(
    const T* __restrict__ rhs, const T* __restrict__ a,
    const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ radd, T* __restrict__ out, int64_t n, int64_t B) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* inv = reinterpret_cast<T*>(atf_smem);
  T* cp = inv + n;
  if (threadIdx.x == 0) row_factors(a, b, c, n, inv, cp);
  __syncthreads();
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  T dp = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = i * B + p;
    dp = forward(rhs[off], __ldg(radd + i), __ldg(a + i), inv[i], dp);
    out[off] = dp;
  }
  T x = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = i * B + p;
    x = sub(out[off], mul(cp[i], x));
    out[off] = x;
  }
}

constexpr int kPencils = 32;        // pencils per K13 block (one warp)
constexpr int kChunk = 32;          // rows per staged tile
constexpr int kPitch = kChunk + 1;  // padded tile row: conflict-free lanes

template <typename T>
size_t z_smem_bytes(int64_t n) {
  // the rhs / d' / x tile, then inv and cp
  return sizeof(T) * (kPencils * kPitch + 2 * n);
}

template <typename T>
__global__ void __launch_bounds__(kPencils) const_sweep_z_kernel(
    const T* __restrict__ rhs, const T* __restrict__ a,
    const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ radd, T* __restrict__ out, int64_t npen,
    int64_t n) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* tile = reinterpret_cast<T*>(atf_smem);
  T* inv = tile + kPencils * kPitch;
  T* cp = inv + n;
  const int lane = threadIdx.x;
  if (lane == 0) row_factors(a, b, c, n, inv, cp);
  __syncwarp();

  const int64_t pen0 = (int64_t)blockIdx.x * kPencils;
  const int np = (int)atf::imin(kPencils, npen - pen0);
  const int row = lane * kPitch;

  // forward, chunk by chunk: stage rhs (lane = row), recur (lane =
  // pencil), write d' (lane = row)
  T dp = T(0);
  for (int64_t k0 = 0; k0 < n; k0 += kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        tile[q * kPitch + lane] = rhs[(pen0 + q) * n + k0 + lane];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = 0; j < cz; ++j) {
        const int64_t i = k0 + j;
        dp = forward(tile[row + j], __ldg(radd + i), __ldg(a + i), inv[i],
                     dp);
        tile[row + j] = dp;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        out[(pen0 + q) * n + k0 + lane] = tile[q * kPitch + lane];
      }
    }
    __syncwarp();
  }

  // back substitution, last chunk first
  T x = T(0);
  for (int64_t k0 = (n - 1) / kChunk * kChunk; k0 >= 0; k0 -= kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        tile[q * kPitch + lane] = out[(pen0 + q) * n + k0 + lane];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = cz - 1; j >= 0; --j) {
        x = sub(tile[row + j], mul(cp[k0 + j], x));
        tile[row + j] = x;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        out[(pen0 + q) * n + k0 + lane] = tile[q * kPitch + lane];
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K14: the periodic phi solve
// ---------------------------------------------------------------------------
//
// The ring's table (`cyclic_const_table_kernel`, one thread a ring, in
// cyclic_const_phi_plain's order): inv, cp and z (n values each), then
// kK14Tail values: den = 1 + z_0 + a z_{n-1}/gamma, e = a/gamma and 1/den.
constexpr int kK14Tail = 3;

// K14's stiffness ratio: a ring whose rows' (|a| + |c|)/(b - |a| - |c|) =
// 2 fac exceeds it is solved in Thomas order.  128: with every ring split,
// rings below it stayed within 3.0 float32 ulp of the output's scale of
// the plain version, rings of 128-1024 within 5.4, past 1024 up to 10.4
// (5 seeds, dt x1-10, chip_smoke.py phase 7's shapes, the spiral app's
// ring and 4096-row lines; scripts/cyl_be_tune.py, PERF.md section 6).
constexpr double kK14Stiff = 128.0;

template <typename T>
__global__ void cyclic_const_table_kernel(const T* __restrict__ fac,
                                          T* __restrict__ tab, int64_t B1,
                                          int64_t n) {
  const int64_t ring = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (ring >= B1) return;
  T* inv = tab + ring * (3 * n + kK14Tail);
  T* cp = inv + n;
  T* zv = cp + n;
  T* tail = zv + n;
  const T f = fac[ring];
  const T a = -f;
  const T b = add(T(1), mul(T(2), f));
  const T gamma = -b;
  const T b0 = mul(T(2), b);
  const T bn = sub(b, div(mul(a, a), gamma));
  T cprev = T(0), dz = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const T ai = (i == 0) ? T(0) : a;
    const T ci = (i == n - 1) ? T(0) : a;
    const T bi = (i == n - 1) ? bn : ((i == 0) ? b0 : b);
    const T ui = (i == n - 1) ? a : ((i == 0) ? gamma : T(0));
    const T iv = div(T(1), sub(bi, mul(ai, cprev)));
    cprev = mul(ci, iv);
    dz = mul(sub(ui, mul(ai, dz)), iv);
    inv[i] = iv;
    cp[i] = cprev;
    zv[i] = dz;
  }
  T z = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    z = sub(zv[i], mul(cp[i], z));
    zv[i] = z;
  }
  const T den = add(add(T(1), zv[0]), div(mul(a, zv[n - 1]), gamma));
  tail[0] = den;
  tail[1] = div(a, gamma);
  tail[2] = div(T(1), den);
}

// A line of a ring past kK14Stiff in Thomas order with the table's
// factors, one rounding each: cyclic_const_phi_plain bit for bit.  y' goes
// through the output, which is read back twice (for y_0 and y_{n-1}, then
// for x).
template <typename T>
__device__ __noinline__ void cyclic_const_thomas(
    const T* __restrict__ rhs, const T* __restrict__ tr, T a,
    T* __restrict__ out, int64_t base, int64_t n, int64_t B2) {
  const T* inv = tr;
  const T* cp = tr + n;
  const T* zv = tr + 2 * n;
  const T gamma = -add(T(1), mul(T(2), -a));
  T dy = T(0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = base + i * B2;
    const T ai = (i == 0) ? T(0) : a;
    dy = mul(sub(rhs[off], mul(ai, dy)), __ldg(inv + i));
    out[off] = dy;
  }
  T y = T(0), yn = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    y = sub(out[base + i * B2], mul(__ldg(cp + i), y));
    if (i == n - 1) yn = y;
  }
  const T fact = div(add(y, div(mul(a, yn), gamma)), __ldg(tr + 3 * n));
  y = T(0);
  for (int64_t i = n - 1; i >= 0; --i) {
    const int64_t off = base + i * B2;
    y = sub(out[off], mul(__ldg(cp + i), y));
    out[off] = sub(y, mul(fact, __ldg(zv + i)));
  }
}

// The block's warps and the blocks an SM its registers are held to: 16
// warps, one block an SM (120 registers at 32 rows a thread) against 32
// warps (64 registers, 16 rows a thread) and two blocks of 16 (spills):
// 0.208-0.214 against 0.213-0.220 and 0.254 ms on the (128, 512, 512)
// annulus (scripts/cyl_be_tune.py, PERF.md section 6).
constexpr int kK14Warps = 16;
constexpr int kK14Blocks = 1;

// A tile: 32 lines adjacent in z (the lanes) of one ring, the block's W
// warps taking consecutive runs of R*M phi rows (kRegs: R = 1, the rows
// kept in registers; else each pass reads them again, d' through the
// output).  Each line: a forward pass from zero gives the run's last l and
// the row-only multiplier G (the product of -a_i inv_i); the runs' carries
// chain through shared memory, D = l + G D (w multiply-adds); a second
// forward pass from D gives d'.  The backward pass does the same with
// x_i = d'_i - cp_i x_{i+1} (m, and H the product of -cp_i), the last
// chain ending at y_0; y_{n-1} = d'_{n-1} comes from the last warp.  Then
// x = y - fact z with fact = (y_0 + e y_{n-1}) / den: no division on a
// line.  A ring past kK14Stiff goes to the Thomas order instead.  The
// blocks are persistent (as many as fit on the card), each walking tiles
// gridDim.x apart; with kRegs a thread loads its rows of the next tile
// before it solves this one, so the loads fly while it computes.
template <typename T, int M, bool kRegs>
__global__ void __launch_bounds__(32 * kK14Warps, kK14Blocks)
    cyclic_const_phi_kernel(const T* __restrict__ rhs,
                            const T* __restrict__ fac,
                            const T* __restrict__ tab, T* __restrict__ out,
                            int64_t B1, int64_t n, int64_t B2, int R) {
  __shared__ T sL[32 * kK14Warps], sM[32 * kK14Warps], sG[kK14Warps],
      sH[kK14Warps], sYn[32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t groups = atf::cdiv(B2, 32);
  const int64_t tiles = B1 * groups;
  const int64_t i0 = (int64_t)w * R * M;        // the run's first row
  // the tile's ring and the lane's line (b2 >= B2: no line)
  auto line = [&](int64_t t, int64_t& ring, int64_t& b2) {
    ring = t / groups;
    b2 = (t - ring * groups) * 32 + lane;
  };
  T next[kRegs ? M : 1];
  auto prefetch = [&](int64_t t) {
    if (t >= tiles) return;
    int64_t ring, b2;
    line(t, ring, b2);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = i0 + k;
      next[k] = (b2 < B2 && i < n) ? rhs[ring * n * B2 + i * B2 + b2] : T(0);
    }
  };
  if constexpr (kRegs) prefetch(blockIdx.x);

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    int64_t ring, b2;
    line(t, ring, b2);
    const bool valid = b2 < B2;
    const int64_t base = ring * n * B2 + b2;
    const T* tr = tab + ring * (3 * n + kK14Tail);
    const T* inv = tr;
    const T* cp = tr + n;
    const T* zv = tr + 2 * n;
    const T f = __ldg(fac + ring);
    const T a = -f;
    T d[kRegs ? M : 1];
    if constexpr (kRegs) {
#pragma unroll
      for (int k = 0; k < M; ++k) d[k] = next[k];
      prefetch(t + gridDim.x);
    }
    if (T(2) * f > T(kK14Stiff)) {
      if (w == 0 && valid) cyclic_const_thomas(rhs, tr, a, out, base, n, B2);
      continue;
    }
    auto load = [&](int64_t i) { return valid ? rhs[base + i * B2] : T(0); };

    T l = T(0), G = T(1);                        // forward from zero
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          T v;
          if constexpr (kRegs) {
            v = d[k];
          } else {
            v = load(i);
          }
          const T iv = __ldg(inv + i);
          const T ai = i == 0 ? T(0) : a;
          l = (v - ai * l) * iv;
          G = G * (-ai * iv);
        }
      }
    }
    sL[threadIdx.x] = l;
    if (lane == 0) sG[w] = G;
    __syncthreads();
    T dp = T(0);                                 // D of the runs before
#pragma unroll 4
    for (int v = 0; v < w; ++v) dp = sL[v * 32 + lane] + sG[v] * dp;
    bool last = false;
    for (int r = 0; r < R; ++r) {                // forward again: d'
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          T v;
          if constexpr (kRegs) {
            v = d[k];
          } else {
            v = load(i);
          }
          const T ai = i == 0 ? T(0) : a;
          dp = (v - ai * dp) * __ldg(inv + i);
          if constexpr (kRegs) {
            d[k] = dp;
          } else if (valid) {
            out[base + i * B2] = dp;
          }
          last = i == n - 1;
        }
      }
    }
    if (last) sYn[lane] = dp;                    // y_{n-1} = d'_{n-1}

    T m = T(0), H = T(1);                        // backward from zero
    for (int r = R - 1; r >= 0; --r) {
#pragma unroll
      for (int k = M - 1; k >= 0; --k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          T v;
          if constexpr (kRegs) {
            v = d[k];
          } else {
            v = valid ? out[base + i * B2] : T(0);
          }
          const T ci = __ldg(cp + i);
          m = v - ci * m;
          H = H * -ci;
        }
      }
    }
    sM[threadIdx.x] = m;
    if (lane == 0) sH[w] = H;
    __syncthreads();
    T y = T(0), y_in = T(0);                     // the chain down to y_0
#pragma unroll 4
    for (int v = W - 1; v >= 0; --v) {
      if (v == w) y_in = y;
      y = sM[v * 32 + lane] + sH[v] * y;
    }
    const T fact = (y + __ldg(tr + 3 * n + 1) * sYn[lane]) *
                   __ldg(tr + 3 * n + 2);
    y = y_in;                                    // backward again: x
    for (int r = R - 1; r >= 0; --r) {
#pragma unroll
      for (int k = M - 1; k >= 0; --k) {
        const int64_t i = i0 + (int64_t)r * M + k;
        if (i < n) {
          T v;
          if constexpr (kRegs) {
            v = d[k];
          } else {
            v = valid ? out[base + i * B2] : T(0);
          }
          y = v - __ldg(cp + i) * y;
          if (valid) out[base + i * B2] = y - fact * __ldg(zv + i);
        }
      }
    }
  }
}

template <typename T>
void launch_const_sweep_strided(const void* rhs, const void* a,
                                const void* b, const void* c,
                                const void* radd, void* out, int64_t n,
                                int64_t B, cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = atf::cdiv(B, threads);
  const size_t smem = 2 * n * sizeof(T);
  atf::allow_dynamic_smem(const_sweep_strided_kernel<T>, smem);
  const_sweep_strided_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(radd), static_cast<T*>(out), n, B);
}

template <typename T>
void launch_const_sweep_z(const void* rhs, const void* a, const void* b,
                          const void* c, const void* radd, void* out,
                          int64_t npen, int64_t n, cudaStream_t stream) {
  const int64_t blocks = atf::cdiv(npen, kPencils);
  const size_t smem = z_smem_bytes<T>(n);
  atf::allow_dynamic_smem(const_sweep_z_kernel<T>, smem);
  const_sweep_z_kernel<T><<<(unsigned)blocks, kPencils, smem, stream>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(radd), static_cast<T*>(out), npen, n);
}

template <typename T, int M, bool kRegs>
void launch_cyclic_const_phi_m(const T* rhs, const T* fac, const T* tab,
                               T* out, int64_t B1, int64_t n, int64_t B2,
                               int device, cudaStream_t stream) {
  // every warp takes at least one row
  const int R =
      kRegs ? 1 : (int)atf::cdiv(n, (int64_t)kK14Warps * M);
  const int W = (int)atf::cdiv(n, (int64_t)R * M);
  auto* kernel = cyclic_const_phi_kernel<T, M, kRegs>;
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * W, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t tiles = B1 * atf::cdiv(B2, 32);
  const int64_t blocks = atf::imin(
      tiles, (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1));
  kernel<<<(unsigned)blocks, 32 * W, 0, stream>>>(rhs, fac, tab, out, B1, n,
                                                  B2, R);
}

// M: the fewest rows a thread that keep a line in registers within
// kK14Warps warps (at most 32 rows a thread at float32, 16 at float64),
// else 16 rows a thread read again in each pass.
template <typename T>
void launch_cyclic_const_phi(const void* rhs, const void* fac,
                             const void* tab, void* out, int64_t B1,
                             int64_t n, int64_t B2, int device,
                             cudaStream_t stream) {
  auto* r = static_cast<const T*>(rhs);
  auto* f = static_cast<const T*>(fac);
  auto* t = static_cast<const T*>(tab);
  auto* o = static_cast<T*>(out);
  auto fits = [&](int M) { return atf::cdiv(n, M) <= kK14Warps; };
  auto args = std::make_tuple(r, f, t, o, B1, n, B2, device, stream);
  if (fits(4)) {
    std::apply(launch_cyclic_const_phi_m<T, 4, true>, args);
  } else if (fits(8)) {
    std::apply(launch_cyclic_const_phi_m<T, 8, true>, args);
  } else if (fits(16)) {
    std::apply(launch_cyclic_const_phi_m<T, 16, true>, args);
  } else if (sizeof(T) == 4 && fits(32)) {
    std::apply(launch_cyclic_const_phi_m<T, sizeof(T) == 4 ? 32 : 16, true>,
               args);
  } else {
    std::apply(launch_cyclic_const_phi_m<T, 16, false>, args);
  }
}

template <typename T>
void launch_cyclic_const_table(const void* fac, void* tab, int64_t B1,
                               int64_t n, cudaStream_t stream) {
  const int threads = 128;
  cyclic_const_table_kernel<T>
      <<<(unsigned)atf::cdiv(B1, threads), threads, 0, stream>>>(
          static_cast<const T*>(fac), static_cast<T*>(tab), B1, n);
}

}  // namespace

ATF_API int atf_const_sweep_strided(int dtype, int device, const void* rhs,
                                    const void* a, const void* b,
                                    const void* c, const void* radd,
                                    void* out, int64_t n, int64_t B,
                                    void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_const_sweep_strided<T>(rhs, a, b, c, radd, out, n, B,
                                             (cudaStream_t)stream));
}

ATF_API int atf_const_sweep_z(int dtype, int device, const void* rhs,
                              const void* a, const void* b, const void* c,
                              const void* radd, void* out, int64_t npen,
                              int64_t n, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_const_sweep_z<T>(rhs, a, b, c, radd, out, npen, n,
                                       (cudaStream_t)stream));
}

ATF_API int atf_cyclic_const_phi(int dtype, int device, const void* rhs,
                                 const void* fac, const void* tab, void* out,
                                 int64_t B1, int64_t n, int64_t B2,
                                 void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_cyclic_const_phi<T>(rhs, fac, tab, out, B1, n, B2,
                                          device, (cudaStream_t)stream));
}

// K14's table, (B1, 3n + kK14Tail) values.
ATF_API int atf_cyclic_const_table(int dtype, int device, const void* fac,
                                   void* tab, int64_t B1, int64_t n,
                                   void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_cyclic_const_table<T>(fac, tab, B1, n,
                                            (cudaStream_t)stream));
}
