// The rows of the stream-reading variable-property sweeps (K7, K7x, K19)
// for the split-line core's strided kernel (csrc/split_line.cuh).
#pragma once

#include "split_line.cuh"
#include "varprop.cuh"

namespace {

// Row i of the line at base + i*rs from the rhs, the sweep code, the
// pre-masked lower faces fc (fc[i+1] the upper face, zero past the last
// row), w = 1/(rho cp) and a film stream h or the scalar rob_c
// (atf::vp_row_coeffs); a chunk reads fc at its M rows and one more, each
// row's f_hi carried to the next row as f_lo.  K7 (y lines), K7x (x
// lines) and K19's lines too long to stage (z lines) take it.
template <typename T>
struct VpRows {
  const T* rhs;
  const uint8_t* code;
  const T* fc;
  const T* w;
  const T* h;
  T tg, sk, t_inf, rob_c;

  template <int M>
  __device__ __forceinline__ void load(Chunk<T, M, false>& ch, int64_t base,
                                       int64_t rs, int64_t row0, int64_t n,
                                       bool valid) const {
    T f_lo = (valid && row0 < n) ? __ldg(fc + base + row0 * rs) : T(0);
    ch.load_rows(
        [&](int k, T& a, T& b, T& c, T& d) {
          const int64_t i = row0 + k;
          if (!valid || i >= n) {
            a = c = d = T(0);
            b = T(1);
            return;
          }
          const int64_t off = base + i * rs;
          const T f_hi = (i + 1 < n) ? __ldg(fc + off + rs) : T(0);
          atf::vp_row_coeffs<T>(__ldg(code + off), f_lo, f_hi,
                                __ldg(w + off),
                                h != nullptr ? __ldg(h + off) : rob_c,
                                __ldg(rhs + off), tg, sk, t_inf, a, b, c, d);
          f_lo = f_hi;
        },
        row0, n);
  }
};

}  // namespace
