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
//     contiguous z axis of the natural field, on the staged split-line
//     kernel of csrc/split_staged.cuh, and the step transposes nothing.
//
// Rows (K24-K26): a = -g_lo, c = -g_hi, b = 1 + g_lo + g_hi + sw, d = rhs
// + sw*t_inf; no codes, no row lag (g_hi is already the cell's own upper
// face), and void cells are identity rows because their streams are zero.
// The row formers (`GStreamRows` for K25 and K26, `GThetaRows` for K24)
// form each row one IEEE rounding at a time (the _rn helpers) in the plain
// versions' order (solvers/gstreams.py), so the rows, and K24's right-hand
// sides, equal _gsolve's bit for bit; the split-line core then solves them
// split across threads, which parts from the Thomas order by about the
// condition number times a rounding (ratios (g_lo + g_hi) / (1 + sw) below
// 5 at the step's dt).  At float32 a line (the strided kernel: a block of
// 32 lines) with a row past its former's ratio (kK24Stiff; K25 and K26
// kK26Stiff) is solved again in Thomas order in grow's reciprocal order,
// bit for bit its plain version.  Types: S storage, C compute (common.cuh
// ATF_DISPATCH_STATE); a bfloat16 state solves at float32 and stores its
// result to nearest or stochastically (`key`, from the cell's natural
// index: the plain version's rounding), the streams always to nearest.
//
// What bounds them on the H100: memory.  Per cell at bfloat16 (float32):
// K23 reads T + mask and writes nine streams, 21 B (41); K24 reads T and
// seven streams and writes U, 18 B (36); K25 and K26 read rhs and three
// streams and write x, 10 B (20); none moves anything else below its
// shared-memory lengths (c' and d' never leave the SM).  Designs:
//   K24 and K25: the strided kernel of the split-line core
//      (csrc/split_line.cuh, `split_strided_kernel`; K1's layout): lanes
//      are 32 lines adjacent in z (K24: the (y, z) pencils of the x sweep,
//      (B1, n, B2) = (1, nx, ny*nz); K25: the z columns of a y sweep,
//      (nx, ny, nz)), so every row load and store is coalesced; the
//      block's 16 warps (two blocks an SM: kGxyWarps, kGxyBlocks) split
//      each line's 8-row chunks, each chunk's rows are formed and
//      eliminated in registers, the reduced rows solved on warp shuffles,
//      and x written once through atf::st with the key.  At bfloat16 a
//      warp reads two rows of its 32 lines with one 4-byte load a lane
//      (`ld_pair`) where the rows pair up (nz even): the loads in flight,
//      not bytes, bound the bfloat16 sweeps.
//      K25 takes K26's `GStreamRows` (its strided `load`, `row_at` and
//      `replay`).  K24's `GThetaRows` forms each right-hand side from the
//      stencil, as K6's `VpThetaRows` does (csrc/varprop_sweeps.cu), but
//      every stream is the cell's own, so the neighbours give only T:
//        x+-1: T carried from row to row within the chunk, with a halo row
//              of T at row0 - 1 and row0 + M;
//        z+-1: T from the neighbouring lanes by warp shuffle; lanes 0 and
//              31 load their outer neighbour (reading rows in pairs, lanes
//              0, 1, 30 and 31 load both rows' in one instruction).  Lane
//              b2 + 1 is z + 1 only inside a y row: the values are selected
//              by k > 0 and k + 1 < nz, never multiplied by them;
//        y+-1: T at off -+ nz, from L1/L2.
//      Where two blocks' shared memory holds no eliminated rows (lines of
//      257-512 rows, 384^3's among them) K24 keeps each row's right-hand
//      side and forms its rows again from it in phase (c), without the
//      stencil's loads (K25 forms its rows again from its inputs).  The
//      first K24 and K25 marched one thread along each pencil (a Thomas
//      recurrence with a rounded division a row, c' and d' through two
//      float32 field-sized scratch buffers, +16 B/cell: 34 and 26 B/cell
//      at bfloat16).
//   K26: K19's staged layout on the split-line core
//      (csrc/split_staged.cuh): a warp a line, its lanes the line's
//      chunks, the persistent block's lines and streams staged by cp.async
//      at the state type (bfloat16 in 4-byte pairs), double-buffered;
//      12-row chunks at 384 rows (32 a line: 16-row chunks left a quarter
//      of the lanes idle).  What holds it near 40% of its bfloat16 bound:
//      the solve's latency, not bytes (the float32 line runs in ~1.15x the
//      time for twice the bytes).  The first K26 ran one warp a block, a
//      lane a line's serial recurrence, staging [32 lines x 32 rows] tiles
//      widened to float32 by scalar loads and sending c' and d' through
//      float32 scratch (26 B/cell at bfloat16, 10-12 warps an SM).
// K23 marches tiles of 8 y rows x 128 z cells along x,
// four cells a thread, as K3: k(T) once a cell into a shared tile with
// its y halo rows (the z halo by lanes 0 and 31), each face's harm once
// (the y faces through the tile, the z faces by shuffle, the x face
// carried to the next plane), cp(T) once a cell, offsets advanced by the
// plane stride, 8- and 16-byte accesses along z, loads one plane ahead
// and one barrier a plane (three tile buffers; a plane's y lo streams are
// stored at the next plane).  The first K23 ran a thread a cell over a
// grid-stride loop with a 64-bit division and modulo a cell, evaluating k
// at the cell and at each of up to six in-mask neighbours and six harms:
// bound by instructions (1.04-1.08 ms at bfloat16, 1.02-1.15 at float32,
// 384^3).  The march does a third of its table evaluations and half its
// divisions and still holds 38-43% of its bfloat16 bound (PERF.md section
// 6): latency at 16 warps an SM (116 registers), not bytes.
#include "field_rows.cuh"
#include "varprop.cuh"

namespace {

using atf::add;
using atf::div;
using atf::mul;
using atf::sub;

constexpr int kHConst = 0, kHStream = 1, kHRad = 2;   // film modes

// Tables of at most kGfSmallSeg segments are summed without a branch
// (K8's kK8SmallSeg; varprop.cuh table<kSeg>).
constexpr int kGfSmallSeg = 4;

// K23's tile: a warp a y row, kGfZ adjacent z cells a lane, kGfRows rows
// a block; the block marches its (y, z) tile along x through a segment of
// planes.
constexpr int kGfZ = 4;
constexpr int kGfRows = 8;
constexpr int kGfTileZ = 32 * kGfZ;
constexpr int kGfThreads = 32 * kGfRows;
// blocks an SM the registers are held to (__launch_bounds__): 2 (116
// registers at float32) ran 5-15% faster than 3 (80, small spills) and
// 1.1-1.7x faster than 4 (64, spills) at 384^3 (PERF.md section 6)
constexpr int kGfMinBlocks = 2;
static_assert(kGfZ == 4, "the vector accesses take four cells a thread");
static_assert(kGfThreads >= 2 * kGfTileZ,
              "at most one cell of the two y halo rows a thread");

// The fields pass's scalars and outputs (g_lo x, g_hi x, g_lo y, g_hi y,
// g_lo z, g_hi z, sw x, y, z, src_pre).
template <typename C>
struct GScalars {
  C rho, tg[3], sk[3], hpar, tik, tik2, hconv, dt;
};
template <typename S>
struct GOuts {
  S* p[10];
};

// kGfZ cells from p, widened: one vector access where `vec` (the row's
// cells aligned and all in the field), else cell by cell (nv in the
// field): the films and the sources
template <typename S, typename C>
__device__ __forceinline__ void ld_cells(const S* p, bool vec, int nv,
                                         C (&v)[kGfZ]) {
  if (vec) {
    if constexpr (sizeof(S) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else if constexpr (sizeof(S) == 8) {
      const double2 q0 = reinterpret_cast<const double2*>(p)[0];
      const double2 q1 = reinterpret_cast<const double2*>(p)[1];
      v[0] = q0.x;
      v[1] = q0.y;
      v[2] = q1.x;
      v[3] = q1.y;
    } else {                             // bfloat16: its bits, widened
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(q.x << 16);
      v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16);
      v[3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) v[c] = c < nv ? atf::ld(p + c) : C(0);
  }
}

// kGfZ cells of T and their mask bytes as loaded: their bits, widened
// where they are used, so that a load one plane ahead is not waited on
// before its plane comes (vector loads only; cell by cell, the bits are
// gathered at once).
template <typename S>
struct Raw {
  uint32_t w[kGfZ * sizeof(S) / 4];
  uint32_t m;          // mask byte c in byte c
};

template <typename S>
__device__ __forceinline__ void ld_raw(const S* p, const uint8_t* pm,
                                       bool vec, int nv, Raw<S>& r) {
  if (vec) {
    if constexpr (sizeof(S) == 2) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      r.w[0] = q.x;
      r.w[1] = q.y;
    } else {
#pragma unroll
      for (int i = 0; i < (int)sizeof(S) / 4; ++i) {
        const uint4 q = reinterpret_cast<const uint4*>(p)[i];
        r.w[4 * i] = q.x;
        r.w[4 * i + 1] = q.y;
        r.w[4 * i + 2] = q.z;
        r.w[4 * i + 3] = q.w;
      }
    }
    r.m = *reinterpret_cast<const uint32_t*>(pm);
  } else {
#pragma unroll
    for (int i = 0; i < (int)(kGfZ * sizeof(S) / 4); ++i) r.w[i] = 0;
    r.m = 0;
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      if (c < nv) {
        if constexpr (sizeof(S) == 2) {
          r.w[c / 2] |= (uint32_t)__bfloat16_as_ushort(p[c]) << (16 * (c % 2));
        } else if constexpr (sizeof(S) == 4) {
          r.w[c] = __float_as_uint(p[c]);
        } else {
          r.w[2 * c] = (uint32_t)__double2loint(p[c]);
          r.w[2 * c + 1] = (uint32_t)__double2hiint(p[c]);
        }
        r.m |= (uint32_t)pm[c] << (8 * c);
      }
    }
  }
}

// cell c of `r` widened to C (atf::ld's value, bit for bit)
template <typename S, typename C>
__device__ __forceinline__ C wid(const Raw<S>& r, int c) {
  if constexpr (sizeof(S) == 2) {
    const uint32_t w = r.w[c / 2];
    return __uint_as_float(c % 2 ? (w & 0xffff0000u) : (w << 16));
  } else if constexpr (sizeof(S) == 4) {
    return __uint_as_float(r.w[c]);
  } else {
    return __hiloint2double((int)r.w[2 * c + 1], (int)r.w[2 * c]);
  }
}

// the mask bits of `r` (bit c: cell c in the mask)
template <typename S>
__device__ __forceinline__ unsigned mbits(const Raw<S>& r) {
  unsigned m = 0;
#pragma unroll
  for (int c = 0; c < kGfZ; ++c) m |= ((r.m >> (8 * c)) & 0xffu) ? 1u << c : 0u;
  return m;
}

// kGfZ cells to p, rounded to nearest at S (atf::st)
template <typename S, typename C>
__device__ __forceinline__ void st_cells(S* p, bool vec, int nv,
                                         const C (&v)[kGfZ]) {
  if (vec) {
    if constexpr (sizeof(S) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (sizeof(S) == 8) {
      reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
      reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
    } else {
      uint2 q;
      q.x = atf::bf16_bits(v[0], -1, 0) |
            ((unsigned)atf::bf16_bits(v[1], -1, 0) << 16);
      q.y = atf::bf16_bits(v[2], -1, 0) |
            ((unsigned)atf::bf16_bits(v[3], -1, 0) << 16);
      *reinterpret_cast<uint2*>(p) = q;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      if (c < nv) atf::st(p + c, v[c], -1, 0);
    }
  }
}

// K23's shared memory, one of three buffers (plane x's, plane x - 1's y hi
// faces, plane x + 1's being written): the tile's k(T) and mask bytes, the
// y hi faces, and k and the mask bytes of the y halo rows.  A thread's
// kGfZ cells are one vector (Quad) of each row.
template <typename C>
struct alignas(sizeof(C) * kGfZ) Quad {
  C v[kGfZ];
};
template <typename C>
struct GfBuf {
  Quad<C> k[kGfRows][32];
  Quad<C> fy[kGfRows][32];
  C kh[2][kGfTileZ];
  uint32_t m[kGfRows][32];         // mask byte c of a thread's cells: byte c
  uint8_t mh[2][kGfTileZ];
};
constexpr int kGfBufs = 3;

// The plane march.  Thread (row ty, lane) owns cells z0 .. z0 + kGfZ - 1
// of row y; per plane x it holds its cells' T, k and mask bits at x and
// x + 1 and their x lo faces (the previous plane's x hi faces), and
//   (1) issues the loads of its cells at x + 2 and of its halo cells at
//       x + 1 (kept as loaded bits until their plane comes: the march
//       never waits on a load issued in the same plane), writes its k and
//       mask bytes into the tile, and k(T) of one cell of the y halo rows
//       (the threads of lanes 0 and 31 keep k at the z halo cells
//       z0 - 1 and z0 + kGfZ in registers);
//   and, past the plane's one barrier,
//   (2) stores plane x - 1's y lo streams (g_lo and sw along y) from the
//       y hi faces the row above wrote into plane x - 1's tile, forms its
//       y hi faces from the row below in the tile (the halo row for the
//       last row) into the tile, its z faces within its cells and from its
//       neighbouring lanes by shuffle, its x hi faces from the k at x + 1
//       it loaded, and the first row its y lo faces from the halo row;
//   (3) forms and stores its cells' other seven (eight) streams.
// Each face's harm is formed once (each tile's edge faces once more by
// the tile beyond it) in its plain version's argument order, harm(k at
// the lower index, k at the upper one); an uncoupled face is 0 without a
// harm.  k(T) is evaluated once a cell (and once more at each tile's halo
// cells), cp(T) once a cell.
template <typename S, typename C, int kSeg>
__global__ void __launch_bounds__(kGfThreads, kGfMinBlocks)
    gstream_fields_kernel(const S* __restrict__ Tf,
                          const uint8_t* __restrict__ mask,
                          const S* __restrict__ h, const S* __restrict__ src,
                          GOuts<S> o, int64_t nx, int64_t ny, int64_t nz,
                          int64_t xs_len, int vec,
                          const __grid_constant__ atf::Table<C> ktab,
                          const __grid_constant__ atf::Table<C> ctab,
                          const __grid_constant__ GScalars<C> sc,
                          int hmode) {
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char atf_smem[];
  GfBuf<C>* bufs = reinterpret_cast<GfBuf<C>*>(atf_smem);
  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int zc = lane * kGfZ;                    // the cells' column
  const int64_t zt = (int64_t)blockIdx.x * kGfTileZ;
  const int64_t y0 = (int64_t)blockIdx.y * kGfRows;
  const int64_t y = y0 + ty;
  const int64_t x0 = (int64_t)blockIdx.z * xs_len;
  const int64_t x1 = atf::imin(nx, x0 + xs_len);
  const int64_t plane = ny * nz;
  const int nv =
      y < ny ? (int)atf::imin(kGfZ, nz > zt + zc ? nz - zt - zc : 0) : 0;
  const bool full = vec && nv == kGfZ;
  const int64_t own = y * nz + zt + zc;          // offset in a plane
  // this thread's y halo cell: row y0 - 1 (threads < kGfTileZ), y0 + rows
  // (the next kGfTileZ threads), none (the rest)
  const bool hcell = threadIdx.x < 2 * kGfTileZ;
  const int hr = hcell ? threadIdx.x / kGfTileZ : 0;
  const int hc = threadIdx.x % kGfTileZ;
  const int64_t hy = hr == 0 ? y0 - 1 : y0 + kGfRows;
  const bool hin = hcell && hy >= 0 && hy < ny && zt + hc < nz;
  const int64_t hoff = hy * nz + zt + hc;
  // lanes 0 and 31: the z halo cell before and after the tile
  const int64_t zz = lane == 0 ? zt - 1 : zt + kGfTileZ;
  const bool zin = y < ny && (lane == 0 || lane == 31) && zz >= 0 && zz < nz;
  const int64_t zoff = y * nz + zz;
  auto on = [](unsigned bits, int c) { return ((bits >> c) & 1u) != 0u; };
  auto kt = [&](C t) { return atf::table<kSeg>(ktab, t); };

  // the segment's first plane and its x lo faces
  C t[kGfZ], k[kGfZ], fxl[kGfZ];
  Raw<S> r0;
  ld_raw(Tf + x0 * plane + own, mask + x0 * plane + own, full, nv, r0);
  unsigned m = mbits(r0), mp = 0;
#pragma unroll
  for (int c = 0; c < kGfZ; ++c) {
    t[c] = wid<S, C>(r0, c);
    k[c] = kt(t[c]);
    fxl[c] = C(0);
  }
  if (x0 > 0) {
    const int64_t o = (x0 - 1) * plane + own;
    ld_raw(Tf + o, mask + o, full, nv, r0);
    mp = mbits(r0);
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      if (on(m & mp, c)) fxl[c] = atf::harm_rn(kt(wid<S, C>(r0, c)), k[c]);
    }
  }
  // loads run ahead of their use, as raw bits: plane x + 1's cells (two
  // planes ahead) and plane x's halo cells (one plane ahead) are in
  // registers at plane x
  auto load_cells = [&](int64_t x, Raw<S>& r) {
    const int64_t o = (x < nx ? x : x0) * plane + own;   // x0: a dummy
    ld_raw(Tf + o, mask + o, full, x < nx ? nv : 0, r);
    if (x >= nx) r.m = 0;
  };
  // the halo cells' T and mask byte (the mask byte 0 outside the field)
  auto load_halo = [&](int64_t x, S& th, unsigned& mh, S& tz,
                       unsigned& mz) {
    const int64_t o = x * plane;
    th = Tf[hin ? o + hoff : 0];
    mh = hin ? mask[o + hoff] : 0u;
    tz = Tf[zin ? o + zoff : 0];
    mz = zin ? mask[o + zoff] : 0u;
  };
  Raw<S> r1;
  load_cells(x0 + 1, r1);
  S th, tz;
  unsigned mh, mz;
  load_halo(x0, th, mh, tz, mz);

  // plane x - 1's y lo stream waits for its faces from the row above
  // (written before plane x's barrier): its tw_y, sk_y*h*w*m, y hi bits
  // and, in the first row, its y lo faces from the halo row
  C twy[kGfZ], swy[kGfZ], fy0[kGfZ];
  unsigned yhp = 0, yl0 = 0;
  auto finish_ylo = [&](const GfBuf<C>& P, int64_t xp) {
    C f[kGfZ], lo[kGfZ], sw[kGfZ];
    unsigned yl = yl0;
    if (ty > 0) {
      yl = 0;
      const uint32_t ma = P.m[ty - 1][lane];
      const Quad<C> fa = P.fy[ty - 1][lane];
#pragma unroll
      for (int c = 0; c < kGfZ; ++c) {
        const bool cpl = on(mp, c) && ((ma >> (8 * c)) & 0xffu) != 0u;
        yl |= cpl ? 1u << c : 0u;
        f[c] = fa.v[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < kGfZ; ++c) f[c] = fy0[c];
    }
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      lo[c] = on(yl, c) ? mul(twy[c], f[c]) : C(0);
      sw[c] = mul(swy[c], sub(sub(C(2), on(yl, c) ? C(1) : C(0)),
                              on(yhp, c) ? C(1) : C(0)));
    }
    st_cells(o.p[2] + xp * plane + own, full, nv, lo);
    st_cells(o.p[7] + xp * plane + own, full, nv, sw);
  };

  for (int64_t x = x0; x < x1; ++x) {
    GfBuf<C>& B = bufs[(x - x0) % kGfBufs];
    const GfBuf<C>& P = bufs[(x - x0 + kGfBufs - 1) % kGfBufs];
    const int64_t off = x * plane;
    // (1) the loads of the planes ahead; the halo cells' k; the tile
    Raw<S> r2;
    S th1, tz1;
    unsigned mh1, mz1;
    load_cells(x + 2, r2);
    load_halo(x + 1 < nx ? x + 1 : x, th1, mh1, tz1, mz1);
    C hl[kGfZ], sv[kGfZ];
    if (hmode == kHStream) ld_cells(h + off + own, full, nv, hl);
    if (src != nullptr) ld_cells(src + off + own, full, nv, sv);
    if (hcell) {
      B.kh[hr][hc] = mh != 0u ? kt(atf::ld(&th)) : C(0);
      B.mh[hr][hc] = mh != 0u;
    }
    const bool zm = mz != 0u;
    const C kz = zm ? kt(atf::ld(&tz)) : C(0);
    {
      Quad<C> q;
      uint32_t mw = 0;
#pragma unroll
      for (int c = 0; c < kGfZ; ++c) {
        q.v[c] = k[c];
        mw |= on(m, c) ? 1u << (8 * c) : 0u;
      }
      B.k[ty][lane] = q;
      B.m[ty][lane] = mw;
    }
    __syncthreads();

    // (2) plane x - 1's y lo stream; plane x's y hi faces, into the tile,
    // and the first row's y lo faces
    if (x > x0) finish_ylo(P, x - 1);
    const bool last = ty + 1 == kGfRows;
    C kb[kGfZ];
    unsigned mb = 0;
    if (last) {
#pragma unroll
      for (int c = 0; c < kGfZ; ++c) {
        kb[c] = B.kh[1][zc + c];
        mb |= B.mh[1][zc + c] ? 1u << c : 0u;
      }
    } else {
      const Quad<C> q = B.k[ty + 1][lane];
      const uint32_t w = B.m[ty + 1][lane];
#pragma unroll
      for (int c = 0; c < kGfZ; ++c) {
        kb[c] = q.v[c];
        mb |= ((w >> (8 * c)) & 0xffu) ? 1u << c : 0u;
      }
    }
    const unsigned yh = m & mb;
    Quad<C> fyh;
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      fyh.v[c] = on(yh, c) ? atf::harm_rn(k[c], kb[c]) : C(0);
    }
    B.fy[ty][lane] = fyh;
    if (ty == 0) {
      yl0 = 0;
#pragma unroll
      for (int c = 0; c < kGfZ; ++c) {
        const bool cpl = on(m, c) && B.mh[0][zc + c] != 0;
        yl0 |= cpl ? 1u << c : 0u;
        fy0[c] = cpl ? atf::harm_rn(B.kh[0][zc + c], k[c]) : C(0);
      }
    }
    // z faces: within the thread's cells, across lanes by shuffle
    C k_up = __shfl_down_sync(kAll, k[0], 1);
    unsigned m_up = __shfl_down_sync(kAll, m & 1u, 1);
    if (lane == 31) {
      k_up = kz;
      m_up = zm;
    }
    C fzh[kGfZ];
    unsigned zh = 0;
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      const bool nb = c + 1 < kGfZ ? on(m, c + 1) : m_up != 0u;
      const bool cpl = on(m, c) && nb;
      zh |= cpl ? 1u << c : 0u;
      fzh[c] = cpl ? atf::harm_rn(k[c], c + 1 < kGfZ ? k[c + 1] : k_up)
                   : C(0);
    }
    C fz0 = __shfl_up_sync(kAll, fzh[kGfZ - 1], 1);
    unsigned z0on = __shfl_up_sync(kAll, (zh >> (kGfZ - 1)) & 1u, 1);
    if (lane == 0) {
      z0on = on(m, 0) && zm;
      fz0 = z0on ? atf::harm_rn(kz, k[0]) : C(0);
    }
    const unsigned zl = ((zh << 1) | z0on) & ((1u << kGfZ) - 1u);
    // x hi faces from the next plane's k
    C tn[kGfZ], kn[kGfZ], fxh[kGfZ];
    const unsigned mn = mbits(r1);
    const unsigned xh = m & mn;
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      tn[c] = wid<S, C>(r1, c);
      kn[c] = kt(tn[c]);
      fxh[c] = on(xh, c) ? atf::harm_rn(k[c], kn[c]) : C(0);
    }

    // (3) plane x's streams but g_lo and sw along y (at plane x + 1)
    const unsigned xl = m & mp;
    C w[kGfZ], wm[kGfZ], hw[kGfZ];
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      w[c] = atf::div(C(1), mul(sc.rho, atf::table<kSeg>(ctab, t[c])));
      C hloc = sc.hpar;
      if (hmode == kHStream) {
        hloc = hl[c];
      } else if (hmode == kHRad) {
        const C tk = add(t[c], C(273.15));
        hloc = add(mul(mul(sc.hpar, add(tk, sc.tik)),
                       add(mul(tk, tk), sc.tik2)),
                   sc.hconv);
      }
      wm[c] = mul(w[c], on(m, c) ? C(1) : C(0));
      hw[c] = mul(hloc, wm[c]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const unsigned bl = a == 0 ? xl : zl;
      const unsigned bh = a == 0 ? xh : a == 1 ? yh : zh;
      C lo[kGfZ], hi[kGfZ], sw[kGfZ];
#pragma unroll
      for (int c = 0; c < kGfZ; ++c) {
        const C flo = a == 0 ? fxl[c] : c == 0 ? fz0 : fzh[c - 1];
        const C fhi = a == 0 ? fxh[c] : a == 1 ? fyh.v[c] : fzh[c];
        const C tw = mul(sc.tg[a], w[c]);
        const C ska = mul(sc.sk[a], hw[c]);
        hi[c] = on(bh, c) ? mul(tw, fhi) : C(0);
        if (a == 1) {                  // the rest at plane x + 1
          twy[c] = tw;
          swy[c] = ska;
        } else {
          lo[c] = on(bl, c) ? mul(tw, flo) : C(0);
          // Robin sinks: h * w * (exposed faces along the axis)
          sw[c] = mul(ska, sub(sub(C(2), on(bl, c) ? C(1) : C(0)),
                               on(bh, c) ? C(1) : C(0)));
        }
      }
      if (a != 1) {
        st_cells(o.p[2 * a] + off + own, full, nv, lo);
        st_cells(o.p[6 + a] + off + own, full, nv, sw);
      }
      st_cells(o.p[2 * a + 1] + off + own, full, nv, hi);
    }
    yhp = yh;
    if (src != nullptr) {
#pragma unroll
      for (int c = 0; c < kGfZ; ++c) sv[c] = mul(mul(sc.dt, wm[c]), sv[c]);
      st_cells(o.p[9] + off + own, full, nv, sv);
    }

    // the next plane
#pragma unroll
    for (int c = 0; c < kGfZ; ++c) {
      t[c] = tn[c];
      k[c] = kn[c];
      fxl[c] = fxh[c];
    }
    mp = m;
    m = mn;
    r1 = r2;
    th = th1;
    mh = mh1;
    tz = tz1;
    mz = mz1;
  }
  // the segment's last plane's y lo stream
  __syncthreads();
  if (x1 > x0) finish_ylo(bufs[(x1 - 1 - x0) % kGfBufs], x1 - 1);
}

// The stiffness ratios of the g-stream sweeps (csrc/field_rows.cuh): at
// float32 a line with a row past |a| + |c| > ratio * (b - |a| - |c|) is
// solved again in Thomas order, grow's reciprocal order, bit for bit its
// plain version (on the strided kernel, K24, K25 and K26's long lines, the
// block of 32 lines that holds it).  No bfloat16 state replays (its gate
// is one bfloat16 ulp), no float64 one.  Every line split, over five seeds
// and dt x1-10 on chip_smoke.py phase 10's streams at 384^3 and 97x203x131
// (scripts/open_tune.py, PERF.md section 6), the largest distance from the
// plain version in float32 ulp of the output's scale (the gate is 8):
//   K26 (z): 6.2 below 16, 10.3 at 16-24, 11.0 at 24-32;
//   K25 (y): 4.9 below 16, 6.2 at 16-24, 13.7 at 24-32: K26's cut, 16;
//   K24 (x): 4.7 below 16, 5.5 at 16-24, 7.2 at 24-32, 5.4 at 32-48.
// The step's rows sit below 5 at its dt.
constexpr double kK26Stiff = 16.0;
constexpr double kK24Stiff = 16.0;

// K24's and K25's block shape on the strided kernel at float32 compute
// (float32 and bfloat16 states): kGxyWarps warps a block, registers held
// to kGxyBlocks blocks an SM (split_line.cuh SplitShape; float64 takes the
// core's).  On the H100 at 384^3 (scripts/gstream_tune.py, PERF.md section
// 6), with the bfloat16 rows read in pairs (ld_pair), 16 warps and two
// blocks an SM (64 registers; K24 then keeps right-hand sides, K25 forms
// its rows again) took the bfloat16 step 2.97 -> 2.69 ms against one block
// of 32 warps; 24 warps (80 registers) ran the same at 384^3 and 1.1-3x
// slower on 8192-row and 97x203x131 lines, 8 warps and four blocks, or 16
// warps and one, slower.
constexpr int kGxyWarps = 16;
constexpr int kGxyBlocks = 2;

// One axis of the explicit pass: g_lo*(t_lo - t) + g_hi*(t_hi - t).
template <typename C>
__device__ __forceinline__ C gterm(C lo, C hi, C t_lo, C t_hi, C t) {
  return add(mul(lo, sub(t_lo, t)), mul(hi, sub(t_hi, t)));
}

// The g-stream row of grow's order from the cell's g_lo, g_hi, sw and
// right-hand side r, one rounding each: _gsolve's row bit for bit.
template <typename C>
__device__ __forceinline__ void grow(C lo, C hi, C sw, C r, C t_inf, C& a,
                                     C& b, C& c, C& d) {
  a = -lo;
  c = -hi;
  b = add(add(add(C(1), lo), hi), sw);
  d = add(r, mul(sw, t_inf));
}

// K25's and K26's rows for the staged split-line kernel
// (csrc/split_staged.cuh; K26) and the strided one (K25, and K26's lines
// too long to stage): the streams g_lo, g_hi and sw and the right-hand side
// at the state type S, widened (atf::ld), the row formed at C by grow.  No
// code, no columns.
template <typename S, typename C>
struct GStreamRows {
  static constexpr int kStreams = 3;             // g_lo, g_hi, sw
  static constexpr int kCols = 0;
  static constexpr bool kReplay =
      std::is_same_v<S, float> && std::is_same_v<C, float>;
  static constexpr double kStiff = kK26Stiff;
  static size_t replay_bytes(int64_t n) { return open_replay_bytes<C>(n); }
  const S* rhs;
  const S* g[kStreams];
  C t_inf;

  __device__ __forceinline__ const S* stream(int t) const { return g[t]; }
  __device__ __forceinline__ const C* col(int) const { return nullptr; }

  // row i of the line at base + i*rs
  __device__ __forceinline__ void row_at(int64_t off, C& a, C& b, C& c,
                                         C& d) const {
    grow(atf::ld(g[0] + off), atf::ld(g[1] + off),
         atf::ld(g[2] + off), atf::ld(rhs + off), t_inf, a, b, c, d);
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    bool stiff = false;
    load(ch, base, rs, row0, n, valid, stiff);
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, bool& stiff) const {
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          const int64_t i = row0 + k;
          if (!valid || i >= n) {
            a = c = d = C(0);
            b = C(1);
            return;
          }
          row_at(base + i * rs, a, b, c, d);
        },
        row0, n, stiff_check<kReplay, GStreamRows>(stiff));
  }

  __device__ __forceinline__ void replay(C* out, int64_t base, int64_t rs,
                                         int64_t n, bool valid,
                                         C* sm) const {
    open_replay<true>(
        [&](int64_t i, C& a, C& b, C& c, C& d) {
          row_at(base + i * rs, a, b, c, d);
        },
        out, base, rs, n, valid, sm);
  }

  template <int M>
  __device__ __forceinline__ void load_staged(Chunk<C, M, false>& ch,
                                              const S* x, const S* f, int fs,
                                              const C*, int,
                                              const uint8_t*, int j,
                                              int64_t nv, bool& stiff) const {
    const int64_t row0 = (int64_t)j * M;
    const int s0 = j * staged_stride<S, M>();
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          if (row0 + k >= nv) {
            a = c = d = C(0);
            b = C(1);
            return;
          }
          const int s = s0 + k;
          grow(atf::ld(f + s), atf::ld(f + fs + s), atf::ld(f + 2 * fs + s),
               atf::ld(x + s), t_inf, a, b, c, d);
        },
        row0, nv, stiff_check<kReplay, GStreamRows>(stiff));
  }
};

// K25's rows: K26's, with K25's block shape and, at bfloat16 where the
// lines' rows pair up (B2 even, aligned), two rows a load (ld_pair).
template <typename S, typename C>
struct GStreamYRows : GStreamRows<S, C> {
  static constexpr int kWarps = sizeof(C) == 4 ? kGxyWarps : kSplitWarps<C>;
  static constexpr int kMinBlocks = sizeof(C) == 4 ? kGxyBlocks : 1;

  bool pairs;     // the lines' rows 4-byte aligned in pairs (B2 even)

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    bool stiff = false;
    load(ch, base, rs, row0, n, valid, stiff);
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, bool& stiff) const {
    if constexpr (sizeof(S) == 2 && M % 2 == 0) {
      if (pairs) {
        load_pairs(ch, base, rs, row0, n, valid);
        return;
      }
    }
    GStreamRows<S, C>::load(ch, base, rs, row0, n, valid, stiff);
  }

  template <int M>
  __device__ __forceinline__ void load_pairs(Chunk<C, M, false>& ch,
                                             int64_t base, int64_t rs,
                                             int64_t row0, int64_t n,
                                             bool valid) const {
    const bool pv = pair_valid(valid);
    const int64_t q0 = pair_offset(base);
    C v[4][2];
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          if (k % 2 == 0) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              ld_pair(t < 3 ? this->g[t] : this->rhs, q0, rs, row0 + k, n, pv,
                      v[t]);
            }
          }
          const int64_t i = row0 + k;
          if (!valid || i >= n) {
            a = c = d = C(0);
            b = C(1);
            return;
          }
          const int q = k % 2;
          grow(v[0][q], v[1][q], v[2][q], v[3][q], this->t_inf, a, b, c, d);
        },
        row0, n);
  }
};

// K24's rows for the strided kernel on the x lines of the natural field:
// (B1, n, B2) = (1, nx, ny*nz), line b2 = j*nz + k at base = b2, rows
// rs = ny*nz apart.  Row i is grow's row from gx_lo, gx_hi and sw_x at the
// cell and the right-hand side
//   d = t + rr*((gterm_x + gterm_y) + gterm_z) (+ src_pre),
// each neighbour's T zero past the domain edge, in
// gstream_theta_sweep_plain's order, one rounding each: the plain rows bit
// for bit.  Every lane of a warp forms the same rows of its own line
// together (the z neighbours come by shuffle); a lane past the last line
// (`valid` false) takes part with zeros and forms identity rows.  Where the
// core keeps a value a row (kKeepRhs), phase (a) keeps each row's
// right-hand side and phase (c) forms the row again from it and the
// cell's x streams, without the stencil's loads.  The float32 replay forms
// each row alone from global memory (no shuffle): the same rows.
template <typename S, typename C>
struct GThetaRows {
  static constexpr int kWarps = sizeof(C) == 4 ? kGxyWarps : kSplitWarps<C>;
  static constexpr int kMinBlocks = sizeof(C) == 4 ? kGxyBlocks : 1;
  static constexpr bool kKeepsRhs = true;
  static constexpr bool kReplay =
      std::is_same_v<S, float> && std::is_same_v<C, float>;
  static constexpr double kStiff = kK24Stiff;
  static size_t replay_bytes(int64_t n) { return open_replay_bytes<C>(n); }
  const S* Tf;
  const S* gx_lo;
  const S* gx_hi;
  const S* gy_lo;
  const S* gy_hi;
  const S* gz_lo;
  const S* gz_hi;
  const S* sw_x;
  const S* src;                                  // src_pre, or null
  int64_t ny, nz;
  C rr, t_inf;
  bool pairs;     // bfloat16 rows read two at a time (nz even, aligned)

  // the right-hand side from T at the cell (t) and its neighbours, the
  // cell's x streams (lo, hi), y and z streams and src_pre (sp)
  __device__ __forceinline__ C rhs(C lo, C hi, C t, C tx_lo, C tx_hi, C gyl,
                                   C gyh, C ty_lo, C ty_hi, C gzl, C gzh,
                                   C tz_lo, C tz_hi, C sp) const {
    C acc = gterm(lo, hi, tx_lo, tx_hi, t);
    acc = add(acc, gterm(gyl, gyh, ty_lo, ty_hi, t));
    acc = add(acc, gterm(gzl, gzh, tz_lo, tz_hi, t));
    const C d = add(t, mul(rr, acc));
    return src != nullptr ? add(d, sp) : d;
  }

  // the same with the y and z streams and src_pre read at off
  __device__ __forceinline__ C rhs(int64_t off, C lo, C hi, C t, C tx_lo,
                                   C tx_hi, C ty_lo, C ty_hi, C tz_lo,
                                   C tz_hi) const {
    return rhs(lo, hi, t, tx_lo, tx_hi, atf::ld(gy_lo + off),
               atf::ld(gy_hi + off), ty_lo, ty_hi, atf::ld(gz_lo + off),
               atf::ld(gz_hi + off), tz_lo, tz_hi,
               src != nullptr ? atf::ld(src + off) : C(0));
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, C* kept = nullptr,
                                       int stride = 0) const {
    bool stiff = false;
    form<M, false>(ch, base, rs, row0, n, valid, kept, stride, stiff);
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, bool& stiff) const {
    form<M, false>(ch, base, rs, row0, n, valid, nullptr, 0, stiff);
  }

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, C* kept, int stride,
                                       bool& stiff) const {
    form<M, false>(ch, base, rs, row0, n, valid, kept, stride, stiff);
  }

  template <int M>
  __device__ __forceinline__ void reload(Chunk<C, M, false>& ch,
                                         int64_t base, int64_t rs,
                                         int64_t row0, int64_t n, bool valid,
                                         C* kept, int stride) const {
    bool stiff = false;
    form<M, true>(ch, base, rs, row0, n, valid, kept, stride, stiff);
  }

  // kAgain: the right-hand sides from kept[k*stride]; else from the
  // stencil, stored there where kept is not null
  template <int M, bool kAgain>
  __device__ __forceinline__ void form(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid, C* kept, int stride,
                                       bool& stiff) const {
    if constexpr (sizeof(S) == 2 && M % 2 == 0) {
      if (pairs) {
        form_pairs<M, kAgain>(ch, base, rs, row0, n, valid, kept, stride);
        return;
      }
    }
    constexpr unsigned kAll = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int64_t j = base / nz;
    const int64_t kz = base - j * nz;
    const bool ylo = valid && j > 0, yhi = valid && j + 1 < ny;
    const bool zlo = valid && kz > 0, zhi = valid && kz + 1 < nz;
    const bool in0 = valid && row0 < n;
    // T at the row before the chunk and at its first row
    C t_lo = (!kAgain && in0 && row0 > 0)
                 ? atf::ld(Tf + base + (row0 - 1) * rs)
                 : C(0);
    C t_c = (!kAgain && in0) ? atf::ld(Tf + base + row0 * rs) : C(0);
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          const int64_t i = row0 + k;
          if (i >= n) {                 // the same rows for the whole warp
            a = c = d = C(0);
            b = C(1);
            return;
          }
          const int64_t off = base + i * rs;
          const C lo = valid ? atf::ld(gx_lo + off) : C(0);
          const C hi = valid ? atf::ld(gx_hi + off) : C(0);
          const C sw = valid ? atf::ld(sw_x + off) : C(0);
          C dv;
          if constexpr (kAgain) {
            dv = kept[k * stride];
          } else {
            const C t_hi =
                valid && i + 1 < n ? atf::ld(Tf + off + rs) : C(0);
            C tz_lo = __shfl_up_sync(kAll, t_c, 1);
            C tz_hi = __shfl_down_sync(kAll, t_c, 1);
            if (lane == 0) tz_lo = zlo ? atf::ld(Tf + off - 1) : C(0);
            if (lane == 31) tz_hi = zhi ? atf::ld(Tf + off + 1) : C(0);
            dv = valid ? rhs(off, lo, hi, t_c, t_lo, t_hi,
                             ylo ? atf::ld(Tf + off - nz) : C(0),
                             yhi ? atf::ld(Tf + off + nz) : C(0),
                             zlo ? tz_lo : C(0), zhi ? tz_hi : C(0))
                       : C(0);
            if (kept != nullptr) kept[k * stride] = dv;
            t_lo = t_c;
            t_c = t_hi;
          }
          grow(lo, hi, sw, dv, t_inf, a, b, c, d);
        },
        row0, n, stiff_check<kReplay, GThetaRows>(stiff));
  }

  // form's rows with every input but the z halo read two rows at a time
  // (ld_pair; bfloat16, M even): at an even row k the right-hand sides of
  // rows k and k + 1, from T at rows row0 + k - 1 .. row0 + k + 2 (the
  // first two carried from the last pair), their y neighbours and streams.
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
    // the z halo: T left of lane 0's line, right of lane 31's
    const int64_t b0 = base - lane, b31 = b0 + 31;
    const bool hlo = b0 % nz > 0, hhi = b31 < ny * nz && b31 % nz + 1 < nz;
    C t[2];                         // T at rows row0 + k - 1 and row0 + k
    if constexpr (!kAgain) ld_pair(Tf, q0, rs, row0 - 1, n, pv, t);
    C x[3][2], dv[2];
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          const int64_t i = row0 + k;
          const int h = k % 2;
          if (h == 0) {
            ld_pair(gx_lo, q0, rs, i, n, pv, x[0]);
            ld_pair(gx_hi, q0, rs, i, n, pv, x[1]);
            ld_pair(sw_x, q0, rs, i, n, pv, x[2]);
            if constexpr (!kAgain) {
              C th[2], gy[2][2], gz[2][2], ty[2][2], sp[2] = {C(0), C(0)};
              ld_pair(Tf, q0, rs, i + 1, n, pv, th);
              ld_pair(gy_lo, q0, rs, i, n, pv, gy[0]);
              ld_pair(gy_hi, q0, rs, i, n, pv, gy[1]);
              ld_pair(gz_lo, q0, rs, i, n, pv, gz[0]);
              ld_pair(gz_hi, q0, rs, i, n, pv, gz[1]);
              ld_pair(Tf, q0 - nz, rs, i, n, ylo, ty[0]);
              ld_pair(Tf, q0 + nz, rs, i, n, yhi, ty[1]);
              if (src != nullptr) ld_pair(src, q0, rs, i, n, pv, sp);
              // T at rows i - 1 .. i + 2
              const C tr[4] = {t[0], t[1], th[0], th[1]};
              // the z halo of rows i and i + 1 by one load: lanes 0 and 1
              // left of lane 0's line, lanes 30 and 31 right of lane 31's
              // (one instruction, not four: PERF.md section 6)
              C hz = C(0);
              const int64_t r = i + (lane & 1);
              if (r < n && (lane < 2 ? hlo : lane >= 30 && hhi)) {
                hz = atf::ld(Tf + (lane < 2 ? b0 - 1 : b31 + 1) + r * rs);
              }
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                C tz_lo = __shfl_up_sync(kAll, tr[1 + e], 1);
                C tz_hi = __shfl_down_sync(kAll, tr[1 + e], 1);
                const C hl = __shfl_sync(kAll, hz, e);
                const C hh = __shfl_sync(kAll, hz, 30 + e);
                if (lane == 0) tz_lo = hl;
                if (lane == 31) tz_hi = hh;
                dv[e] = valid ? rhs(x[0][e], x[1][e], tr[1 + e], tr[e],
                                    tr[2 + e], gy[0][e], gy[1][e], ty[0][e],
                                    ty[1][e], gz[0][e], gz[1][e],
                                    zlo ? tz_lo : C(0), zhi ? tz_hi : C(0),
                                    sp[e])
                              : C(0);
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
            r = dv[h];
            if (kept != nullptr) kept[k * stride] = r;
          }
          grow(x[0][h], x[1][h], x[2][h], r, t_inf, a, b, c, d);
        },
        row0, n);
  }

  __device__ __forceinline__ void replay(C* out, int64_t base, int64_t rs,
                                         int64_t n, bool valid,
                                         C* sm) const {
    const int64_t j = base / nz;
    const int64_t kz = base - j * nz;
    open_replay<true>(
        [&](int64_t i, C& a, C& b, C& c, C& d) {
          const int64_t off = base + i * rs;
          const C lo = atf::ld(gx_lo + off), hi = atf::ld(gx_hi + off);
          const C dv = rhs(
              off, lo, hi, atf::ld(Tf + off),
              i > 0 ? atf::ld(Tf + off - rs) : C(0),
              i + 1 < n ? atf::ld(Tf + off + rs) : C(0),
              j > 0 ? atf::ld(Tf + off - nz) : C(0),
              j + 1 < ny ? atf::ld(Tf + off + nz) : C(0),
              kz > 0 ? atf::ld(Tf + off - 1) : C(0),
              kz + 1 < nz ? atf::ld(Tf + off + 1) : C(0));
          grow(lo, hi, atf::ld(sw_x + off), dv, t_inf, a, b, c, d);
        },
        out, base, rs, n, valid, sm);
  }
};

// K23 on the (nx, ny, nz) field: tiles of kGfRows y rows x kGfTileZ z
// cells, each marched along x through a segment of planes; the segment
// count S is chosen so that the waves of blocks cost the least, each
// segment's first plane evaluating k at the plane before it.
template <typename S, typename C, int kSeg>
void launch_gstream_fields_k(const S* Tf, const uint8_t* mask, const S* h,
                             const S* src, const GOuts<S>& o, int64_t nx,
                             int64_t ny, int64_t nz, const atf::Table<C>& kt,
                             const atf::Table<C>& ct, const GScalars<C>& sc,
                             int hmode, int device, cudaStream_t stream) {
  auto* kernel = gstream_fields_kernel<S, C, kSeg>;
  const size_t smem = kGfBufs * sizeof(GfBuf<C>);
  atf::allow_dynamic_smem(kernel, smem);
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGfThreads,
                                                smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t wave = (int64_t)(per_sm > 0 ? per_sm : 1) *
                       (sms > 0 ? sms : 1);
  const int64_t tiles = atf::cdiv(nz, kGfTileZ) * atf::cdiv(ny, kGfRows);
  int64_t best = 1, best_cost = -1;
  for (int64_t seg = 1; seg <= atf::imin(nx, 65535); ++seg) {
    const int64_t len = atf::cdiv(nx, seg);
    if (atf::cdiv(nx, len) != seg) continue;
    const int64_t cost = atf::cdiv(tiles * seg, wave) * (len + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = seg;
      best_cost = cost;
    }
  }
  const int64_t len = atf::cdiv(nx, best);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  bool vec = nz % kGfZ == 0 && aligned(Tf) && aligned(mask) &&
             (h == nullptr || aligned(h)) && (src == nullptr || aligned(src));
  for (int q = 0; q < 10; ++q) vec = vec && (o.p[q] == nullptr || aligned(o.p[q]));
  const dim3 grid((unsigned)atf::cdiv(nz, kGfTileZ),
                  (unsigned)atf::cdiv(ny, kGfRows), (unsigned)best);
  kernel<<<grid, kGfThreads, smem, stream>>>(Tf, mask, h, src, o, nx, ny, nz,
                                             len, vec ? 1 : 0, kt, ct, sc,
                                             hmode);
}

template <typename S, typename C>
void launch_gstream_fields(const void* Tf, const void* mask, const void* h,
                           const void* src, void* const* outs, int64_t nx,
                           int64_t ny, int64_t nz, const double* ktab,
                           int kn, const double* ctab, int cn,
                           const double* d, int hmode, int device,
                           cudaStream_t stream) {
  atf::Table<C> kt, ct;
  atf::make_table(ktab, kn, &kt);
  atf::make_table(ctab, cn, &ct);
  GScalars<C> sc;
  sc.rho = (C)d[0];
  for (int a = 0; a < 3; ++a) {
    sc.tg[a] = (C)d[1 + a];
    sc.sk[a] = (C)d[4 + a];
  }
  sc.hpar = (C)d[7];
  sc.tik = (C)d[8];
  sc.tik2 = (C)d[9];
  sc.hconv = (C)d[10];
  sc.dt = (C)d[11];
  GOuts<S> o;
  for (int q = 0; q < 10; ++q) o.p[q] = static_cast<S*>(outs[q]);
  const S* t = static_cast<const S*>(Tf);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const S* hh = static_cast<const S*>(h);
  const S* s = static_cast<const S*>(src);
  if (kn <= kGfSmallSeg && cn <= kGfSmallSeg) {
    launch_gstream_fields_k<S, C, kGfSmallSeg>(t, m, hh, s, o, nx, ny, nz,
                                               kt, ct, sc, hmode, device,
                                               stream);
  } else {
    launch_gstream_fields_k<S, C, 0>(t, m, hh, s, o, nx, ny, nz, kt, ct, sc,
                                     hmode, device, stream);
  }
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
                         cn, sc, hmode, device, (cudaStream_t)stream));
}

// K24: the x lines, (B1, n, B2) = (1, nx, ny*nz).
ATF_API int atf_gstream_theta_sweep(
    int dtype, int device, const void* Tf, const void* gxlo,
    const void* gxhi, const void* gylo, const void* gyhi, const void* gzlo,
    const void* gzhi, const void* swx, const void* srcp, void* out,
    int64_t nx, int64_t ny, int64_t nz, double rr, double t_inf, int64_t key,
    void* stream) {
  const void* ptrs[9] = {Tf, gxlo, gxhi, gylo, gyhi, gzlo, gzhi, swx, srcp};
  bool pairs = nz % 2 == 0;
  for (const void* q : ptrs) {
    pairs = pairs && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  }
  ATF_DISPATCH_STATE(
      dtype, device,
      ATF_RETURN_IF((launch_split_strided<C, GThetaRows<S, C>>(
          GThetaRows<S, C>{
              static_cast<const S*>(Tf), static_cast<const S*>(gxlo),
              static_cast<const S*>(gxhi), static_cast<const S*>(gylo),
              static_cast<const S*>(gyhi), static_cast<const S*>(gzlo),
              static_cast<const S*>(gzhi), static_cast<const S*>(swx),
              static_cast<const S*>(srcp), ny, nz, (C)rr, (C)t_inf, pairs},
          static_cast<S*>(out), 1, nx, ny * nz, 1, ny * nz, device,
          (cudaStream_t)stream, key))));
}

// K25: the lines of (B1, n, B2) along n (the y lines of (nx, ny, nz)).
ATF_API int atf_gstream_sweep_strided(int dtype, int device, const void* rhs,
                                      const void* glo, const void* ghi,
                                      const void* sw, void* out, int64_t B1,
                                      int64_t n, int64_t B2, double t_inf,
                                      int64_t key, void* stream) {
  const void* ptrs[4] = {rhs, glo, ghi, sw};
  bool pairs = B2 % 2 == 0;
  for (const void* q : ptrs) {
    pairs = pairs && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  }
  ATF_DISPATCH_STATE(
      dtype, device,
      ATF_RETURN_IF((launch_split_strided<C, GStreamYRows<S, C>>(
          GStreamYRows<S, C>{{static_cast<const S*>(rhs),
                              {static_cast<const S*>(glo),
                               static_cast<const S*>(ghi),
                               static_cast<const S*>(sw)},
                              (C)t_inf},
                             pairs},
          static_cast<S*>(out), B1, n, B2, 1, B2, device,
          (cudaStream_t)stream, key))));
}

ATF_API int atf_gstream_sweep_z(int dtype, int device, const void* rhs,
                                const void* glo, const void* ghi,
                                const void* sw, void* out, void* flags,
                                int64_t npen, int64_t n, double t_inf,
                                int64_t key, void* stream) {
  ATF_DISPATCH_STATE(
      dtype, device,
      ATF_RETURN_IF((launch_split_staged<C, GStreamRows<S, C>>(
          GStreamRows<S, C>{static_cast<const S*>(rhs),
                            {static_cast<const S*>(glo),
                             static_cast<const S*>(ghi),
                             static_cast<const S*>(sw)},
                            (C)t_inf},
          static_cast<S*>(out), static_cast<uint8_t*>(flags), npen, n,
          device, (cudaStream_t)stream, key))));
}
