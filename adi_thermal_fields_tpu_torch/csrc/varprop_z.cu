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
// Rows: atf::vp_row (varprop.cuh), the rows of K6 and K7, from the rhs, the
// z sweep code (sweep_code(mask, None, 2) moved to the natural layout;
// bits 1/2/8), the pre-masked lower-face conductivity fc_z (K5), w =
// 1/(rho cp) and a film stream h or the scalar rob_c.  Row i's upper face
// is fc[i+1]: the TPU kernel runs one row lagged for it and finishes the
// last row with a zero upper face (:189-197); here each lane reads it one
// slot ahead in the staged tile (slot kChunk holds the next chunk's first
// face) and takes zero past the last row.  One rounding per operation in
// the plain version's order: the kernel repeats it bit for bit.
//
// What bounds it on the H100: memory -- read rhs (4) + code (1) + fc (4) +
// w (4) [+ h (4)], write x (4): 17 B/cell, 21 with h (float32), plus the
// 16 B/cell c'/d' round trip of the global scratch.  Design: K8's.  The
// solve runs along the contiguous axis, so one warp owns 32 pencils and
// stages [32 pencils x 32 rows] tiles of every stream through shared
// memory with coalesced loads (lane = row), then each lane runs its
// pencil's recurrence from the tiles (lane = pencil; padded pitch,
// conflict-free).  c' and d' go to global scratch through the rhs and d'
// tiles, as in K8.
#include "varprop.cuh"

namespace {

constexpr int kPencils = 32;        // pencils per block (one warp)
constexpr int kChunk = 32;          // rows per staged tile
constexpr int kPitch = kChunk + 1;  // padded tile row; slot kChunk = lookahead

template <typename T>
constexpr size_t vp_z_smem_bytes() {
  // rhs / c' / x, d', fc (+ lookahead), w, h tiles (T), then the code tile
  return 5 * sizeof(T) * kPencils * kPitch + kPencils * kPitch;
}

template <typename T>
__global__ void __launch_bounds__(kPencils) vp_sweep_z_kernel(
    const T* __restrict__ rhs, const uint8_t* __restrict__ code,
    const T* __restrict__ fc, const T* __restrict__ w,
    const T* __restrict__ h, T* __restrict__ out, T* __restrict__ dpbuf,
    int64_t npen, int64_t n, T tg, T sk, T t_inf, T rob_c) {
  extern __shared__ __align__(16) unsigned char atf_smem[];
  T* tile = reinterpret_cast<T*>(atf_smem);        // rhs, then c', then x
  T* tile2 = tile + kPencils * kPitch;             // d'
  T* ftile = tile2 + kPencils * kPitch;            // fc (+ lookahead)
  T* wtile = ftile + kPencils * kPitch;            // w
  T* htile = wtile + kPencils * kPitch;            // h
  uint8_t* ctile = reinterpret_cast<uint8_t*>(htile + kPencils * kPitch);

  const int lane = threadIdx.x;
  const int64_t pen0 = (int64_t)blockIdx.x * kPencils;
  const int np = (int)atf::imin(kPencils, npen - pen0);
  const int row = lane * kPitch;

  // forward elimination, chunk by chunk
  T cp = T(0), dp = T(0), f_lo = T(0);
  for (int64_t k0 = 0; k0 < n; k0 += kChunk) {
    const int cz = (int)atf::imin(kChunk, n - k0);
    if (lane < cz) {
      for (int q = 0; q < np; ++q) {
        const int64_t g = (pen0 + q) * n + k0 + lane;
        const int s = q * kPitch + lane;
        tile[s] = rhs[g];
        ftile[s] = fc[g];
        wtile[s] = w[g];
        htile[s] = h != nullptr ? h[g] : rob_c;
        ctile[s] = code[g];
      }
    }
    if (lane < np && k0 + kChunk < n) {
      ftile[row + kChunk] = fc[(pen0 + lane) * n + k0 + kChunk];
    }
    __syncwarp();
    if (lane < np) {
      if (k0 == 0) f_lo = ftile[row];
      for (int j = 0; j < cz; ++j) {
        const T f_hi = (k0 + j + 1 < n) ? ftile[row + j + 1] : T(0);
        atf::vp_row(ctile[row + j], f_lo, f_hi, wtile[row + j],
                    htile[row + j], tile[row + j], tg, sk, t_inf, cp, dp);
        tile[row + j] = cp;
        tile2[row + j] = dp;
        f_lo = f_hi;
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
        x = atf::sub(tile2[row + j], atf::mul(tile[row + j], x));
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
void launch_vp_sweep_z(const void* rhs, const void* code, const void* fc,
                       const void* w, const void* h, void* out,
                       void* scratch, int64_t npen, int64_t n, double tg,
                       double sk, double t_inf, double rob_c,
                       cudaStream_t stream) {
  const size_t smem = vp_z_smem_bytes<T>();
  atf::allow_dynamic_smem(vp_sweep_z_kernel<T>, smem);
  const int64_t blocks = atf::cdiv(npen, kPencils);
  vp_sweep_z_kernel<T><<<(unsigned)blocks, kPencils, smem, stream>>>(
      static_cast<const T*>(rhs), static_cast<const uint8_t*>(code),
      static_cast<const T*>(fc), static_cast<const T*>(w),
      static_cast<const T*>(h), static_cast<T*>(out),
      static_cast<T*>(scratch), npen, n, (T)tg, (T)sk, (T)t_inf, (T)rob_c);
}

}  // namespace

ATF_API int atf_varprop_sweep_z(int dtype, int device, const void* rhs,
                                const void* code, const void* fc,
                                const void* w, const void* h, void* out,
                                void* scratch, int64_t npen, int64_t n,
                                double tg, double sk, double t_inf,
                                double rob_c, void* stream) {
  ATF_DISPATCH(dtype, device,
               launch_vp_sweep_z<T>(rhs, code, fc, w, h, out, scratch, npen,
                                    n, tg, sk, t_inf, rob_c,
                                    (cudaStream_t)stream));
}
