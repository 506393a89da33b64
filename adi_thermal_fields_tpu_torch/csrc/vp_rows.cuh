// The rows of the stream-reading variable-property sweeps (K7, K7x, K19)
// for the split-line core's strided kernel (csrc/split_line.cuh), and
// K19's bfloat16 rows for its staged kernel (csrc/split_staged.cuh).
#pragma once

#include "split_staged.cuh"
#include "varprop.cuh"

namespace {

// Row i of the line at base + i*rs from the rhs, the sweep code, the
// pre-masked lower faces fc (fc[i+1] the upper face, zero past the last
// row), w = 1/(rho cp) and a film stream h or the scalar rob_c
// (atf::vp_row_coeffs); a chunk reads fc at its M rows and one more, each
// row's f_hi carried to the next row as f_lo.  K7 (y lines), K7x (x
// lines) and K19's lines too long to stage (z lines) take it.  Types: the
// streams at the state type S, widened (atf::ldg), the rows formed at the
// compute type C (common.cuh ATF_DISPATCH_STATE).  At bfloat16 the block
// takes K25's shape (16 warps, two blocks an SM) and reads one row a load:
// at 384^3 (scripts/vp_bf16_ab.py, PERF.md section 6) that ran K7b in
// 0.75 ms against 0.82 with 32 warps, and reading two rows a load
// (split_line.cuh ld_pair, as K25 does) 0.94-1.01: its extra registers
// spill at 64 a thread.
template <typename S, typename C>
struct VpRows {
  static constexpr int kWarps = sizeof(S) == 2 ? 16 : kSplitWarps<C>;
  static constexpr int kMinBlocks = sizeof(S) == 2 ? 2 : 1;
  const S* rhs;
  const uint8_t* code;
  const S* fc;
  const S* w;
  const S* h;
  C tg, sk, t_inf, rob_c;

  template <int M>
  __device__ __forceinline__ void load(Chunk<C, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    C f_lo = (valid && row0 < n) ? atf::ldg(fc + base + row0 * rs) : C(0);
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          const int64_t i = row0 + k;
          if (!valid || i >= n) {
            a = c = d = C(0);
            b = C(1);
            return;
          }
          const int64_t off = base + i * rs;
          const C f_hi = (i + 1 < n) ? atf::ldg(fc + off + rs) : C(0);
          atf::vp_row_coeffs<C>(__ldg(code + off), f_lo, f_hi,
                                atf::ldg(w + off),
                                h != nullptr ? atf::ldg(h + off) : rob_c,
                                atf::ldg(rhs + off), tg, sk, t_inf, a, b, c,
                                d);
          f_lo = f_hi;
        },
        row0, n);
  }
};

// K19's bfloat16 rows for the staged split-line kernel (K26's kernel,
// csrc/split_staged.cuh): the rhs and the streams fc, w (and h where kH)
// staged at S in 4-byte pairs, the code bytes staged too; row i's upper
// face is the next staged slot, the next chunk's first past the chunk's
// last row (staged_stride), zero past the last row, as K19's own kernel
// reads it (csrc/varprop_z.cu).  Lines too long to stage take VpRows'
// strided load (lanes n apart).
template <typename S, typename C, bool kH>
struct VpZRows : VpRows<S, C> {
  static constexpr int kStreams = kH ? 3 : 2;   // fc, w (, h)
  static constexpr int kCols = 0;
  static constexpr bool kCode = true;

  __device__ __forceinline__ const S* stream(int t) const {
    return t == 0 ? this->fc : t == 1 ? this->w : this->h;
  }
  __device__ __forceinline__ const C* col(int) const { return nullptr; }

  template <int M>
  __device__ __forceinline__ void load_staged(Chunk<C, M, false>& ch,
                                              const S* x, const S* f, int fs,
                                              const C*, int,
                                              const uint8_t* ct, int j,
                                              int64_t nv, bool&) const {
    constexpr int kStride = staged_stride<S, M>();
    const int64_t row0 = (int64_t)j * M;
    const int s0 = j * kStride;
    C f_lo = row0 < nv ? atf::ld(f + s0) : C(0);
    ch.load_rows(
        [&](int k, C& a, C& b, C& c, C& d) {
          const int64_t i = row0 + k;
          if (i >= nv) {
            a = c = d = C(0);
            b = C(1);
            return;
          }
          const int s = s0 + k;
          const C f_hi =
              i + 1 < nv ? atf::ld(f + (k < M - 1 ? s + 1 : s0 + kStride))
                         : C(0);
          atf::vp_row_coeffs<C>(ct[j * (M + 4) + k], f_lo, f_hi,
                                atf::ld(f + fs + s),
                                kH ? atf::ld(f + 2 * fs + s) : this->rob_c,
                                atf::ld(x + s), this->tg, this->sk,
                                this->t_inf, a, b, c, d);
          f_lo = f_hi;
        },
        row0, nv);
  }
};

}  // namespace
