// K8: the tier-2 variable-property sweep along the contiguous z axis.
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
//   inv = 1/(b + al*c'); c' = -ch*inv; d' = (d + al*d')*inv.
// The coup > 0 gate is right for films >= 0 only; the callers refuse
// negative films.
//
// What bounds it on the H100: memory -- read rhs (4) + T (4) + code (1),
// write x (4) = 13 B/cell for float32, plus the 16 B/cell c'/d' round trip
// of the global scratch.  Design: K2's.  The solve runs along the
// contiguous axis, so one warp owns 32 pencils and stages [32 pencils x 32
// rows] tiles of rhs, T and code through shared memory with coalesced
// loads (lane = row), then each lane runs its pencil's recurrence from the
// tile (lane = pencil; padded pitch, conflict-free).  The T tile holds one
// extra row, the first row of the next chunk, for the k_{r+1} lookahead.
// k, cp, the faces and the films live only in registers.  c' and d' go to
// global scratch through the same tiles, as in K2 (on the H100, K2 with
// global scratch measured faster than with whole lines in shared memory;
// PERF.md).
#include "varprop.cuh"

namespace {

constexpr int kPencils = 32;        // pencils per block (one warp)
constexpr int kChunk = 32;          // rows per staged tile
constexpr int kPitch = kChunk + 1;  // padded tile row; slot kChunk = lookahead

template <typename T>
constexpr size_t vp2_smem_bytes() {
  // rhs / c' / x, d', T tiles (T), then the code tile (bytes)
  return 3 * sizeof(T) * kPencils * kPitch + kPencils * kPitch;
}

template <typename T>
__global__ void __launch_bounds__(kPencils) vp2_sweep_z_kernel(
    const T* __restrict__ rhs, const T* __restrict__ Tf,
    const uint8_t* __restrict__ code, T* __restrict__ out,
    T* __restrict__ dpbuf, int64_t npen, int64_t n,
    const __grid_constant__ atf::Table<T> ktab,
    const __grid_constant__ atf::Table<T> ctab, T glo, T gs, T inv_dtor,
    T h, T t_inf, T rc, T tik, T tik2, int with_rad) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* tile = reinterpret_cast<T*>(atf_smem);        // rhs, then c', then x
  T* tile2 = tile + kPencils * kPitch;             // d'
  T* ttile = tile2 + kPencils * kPitch;            // T^n (+ lookahead row)
  uint8_t* ctile = reinterpret_cast<uint8_t*>(ttile + kPencils * kPitch);

  const int lane = threadIdx.x;
  const int64_t pen0 = (int64_t)blockIdx.x * kPencils;
  const int np = (int)atf::imin(kPencils, npen - pen0);
  const int row = lane * kPitch;

  // forward elimination, chunk by chunk
  T cp = T(0), dp = T(0), f_lo = T(0), k_cur = T(0);
  for (int64_t k0 = 0; k0 < n; k0 += kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        tile[q * kPitch + lane] = rhs[g];
        ttile[q * kPitch + lane] = Tf[g];
        ctile[q * kPitch + lane] = code[g];
      }
    }
    if (lane < np && k0 + kChunk < n) {
      ttile[row + kChunk] = Tf[(pen0 + lane) * n + k0 + kChunk];
    }
    __syncwarp();
    if (lane < np) {
      if (k0 == 0) k_cur = atf::clamp_sum(ktab, ttile[row]);
      for (int j = 0; j < cz; ++j) {
        const T tc = ttile[row + j];
        const unsigned c = ctile[row + j];
        const T k_next =
            (k0 + j + 1 < n) ? atf::clamp_sum(ktab, ttile[row + j + 1]) : T(0);
        const T f_hi = (c & 1u) ? atf::harm(k_cur, k_next) : T(0);
        T hh = h;
        if (with_rad) hh = h + atf::rad_film(tc, rc, tik, tik2);
        const T sink = atf::bit<T>(c, 2u) * gs * hh
                       + atf::bit<T>(c, 4u) * gs * hh;
        const T srhs = sink * t_inf;
        const T al = glo * f_lo;
        const T ch = glo * f_hi;
        const T coup = al + ch + sink;
        const T w_r = coup > T(0) ? atf::clamp_sum(ctab, tc) * inv_dtor : T(1);
        const T b = w_r + coup;
        const T d = tile[row + j] * w_r + srhs;
        const T inv = T(1) / (b + al * cp);
        cp = -ch * inv;
        dp = (d + al * dp) * inv;
        tile[row + j] = cp;
        tile2[row + j] = dp;
        f_lo = f_hi;
        k_cur = k_next;
      }
    }
    __syncwarp();
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        out[g] = tile[q * kPitch + lane];
        dpbuf[g] = tile2[q * kPitch + lane];
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
        const int64_t g = (pen0 + q) * n + k0 + lane;
        tile[q * kPitch + lane] = out[g];
        tile2[q * kPitch + lane] = dpbuf[g];
      }
    }
    __syncwarp();
    if (lane < np) {
      for (int j = cz - 1; j >= 0; --j) {
        x = tile2[row + j] - tile[row + j] * x;
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

template <typename T>
void launch_vp2_sweep_z(const void* rhs, const void* Tf, const void* code,
                        void* out, void* scratch, int64_t npen, int64_t n,
                        const double* ktab, int kn, const double* ctab,
                        int cn, double glo, double gs, double inv_dtor,
                        double h, double t_inf, double rc, double tik,
                        double tik2, int with_rad, cudaStream_t stream) {
  atf::Table<T> kt, ct;
  atf::make_table(ktab, kn, &kt);
  atf::make_table(ctab, cn, &ct);
  const int64_t blocks = atf::cdiv(npen, kPencils);
  vp2_sweep_z_kernel<T><<<(unsigned)blocks, kPencils, vp2_smem_bytes<T>(),
                          stream>>>(
      static_cast<const T*>(rhs), static_cast<const T*>(Tf),
      static_cast<const uint8_t*>(code), static_cast<T*>(out),
      static_cast<T*>(scratch), npen, n, kt, ct, (T)glo, (T)gs,
      (T)inv_dtor, (T)h, (T)t_inf, (T)rc, (T)tik, (T)tik2, with_rad);
}

}  // namespace

ATF_API int atf_vp2_sweep_z(int dtype, int device, const void* rhs,
                            const void* Tf, const void* code, void* out,
                            void* scratch, int64_t npen, int64_t n,
                            const double* ktab, int kn, const double* ctab,
                            int cn, double glo, double gs, double inv_dtor,
                            double h, double t_inf, double rc, double tik,
                            double tik2, int with_rad, void* stream) {
  if (kn < 0 || kn > atf::kMaxSeg || cn < 0 || cn > atf::kMaxSeg) {
    return (int)cudaErrorInvalidValue;
  }
  ATF_DISPATCH(dtype, device,
               launch_vp2_sweep_z<T>(rhs, Tf, code, out, scratch, npen, n,
                                     ktab, kn, ctab, cn, glo, gs, inv_dtor,
                                     h, t_inf, rc, tik, tik2, with_rad,
                                     (cudaStream_t)stream));
}
