// Shared helpers for the port's CUDA kernels (compiled for sm_90a).
//
// Every exported entry point has a plain C interface: pointers and the
// stream come in as void*, scalars as double (rounded to the compute type
// inside), sizes as int64.  The entry point selects the device, launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError() of
// the launch (0 = success) so that the Python wrapper can raise.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ATF_API extern "C" __attribute__((visibility("default")))

namespace atf {

constexpr int kF32 = 0;
constexpr int kF64 = 1;
constexpr int kBF16 = 2;   // bfloat16 storage, float32 solve

// The state's storage type S and the solve's compute type C: loads widen,
// stores narrow.  A bfloat16 store rounds to nearest for a negative `key`,
// else stochastically with the JAX bit trick (dist/cartesian_pallas.py
// _stoch_round_bf16): add 16 random low bits to the float32 pattern and
// truncate.  The bits are sr_bits(key, idx), a counter-based hash of the
// key (seed and pass, folded on the host: solvers/rounding.py sr_key) and
// the cell's linear index in the natural layout -- independent of the
// block shape and the launch order, so the plain version (round_bf16)
// repeats it bit for bit from the same float32 value.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t sr_bits(int64_t key, int64_t idx) {
  const uint64_t u = (uint64_t)idx;
  return mix32(mix32((uint32_t)u ^ (uint32_t)key) + (uint32_t)(u >> 32));
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ double ld(const double* p) { return *p; }

// ld through the read-only data cache (__ldg), for the row formers whose
// pointers the compiler cannot prove read-only.
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg(const double* p) { return __ldg(p); }

__device__ __forceinline__ void st(float* p, float v, int64_t, int64_t) {
  *p = v;
}
__device__ __forceinline__ void st(double* p, double v, int64_t, int64_t) {
  *p = v;
}
// The bits of v rounded to bfloat16 as st() stores it.
__device__ __forceinline__ unsigned short bf16_bits(float v, int64_t key,
                                                   int64_t idx) {
  if (key < 0) return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  const uint32_t b = __float_as_uint(v) + (sr_bits(key, idx) & 0xffffu);
  return (unsigned short)(b >> 16);
}
__device__ __forceinline__ void st(__nv_bfloat16* p, float v, int64_t key,
                                   int64_t idx) {
  *p = __ushort_as_bfloat16(bf16_bits(v, key, idx));
}

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Codes are read as unsigned bytes everywhere: bit 128 (the z-high
// neighbour of the stencil code) is the sign bit of a signed char.
constexpr unsigned kLow = 1u, kHigh = 2u, kPin = 4u, kInMask = 8u;
constexpr unsigned kNb1Lo = 16u, kNb1Hi = 32u, kNb2Lo = 64u, kNb2Hi = 128u;

template <typename T>
__device__ __forceinline__ T bit(unsigned code, unsigned b) {
  return (code & b) ? T(1) : T(0);
}

// IEEE round-to-nearest operations, one rounding each, never fused into an
// FMA: a kernel written with them repeats its plain PyTorch version (one
// tensor op per operation) bit for bit.
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div(double a, double b) {
  return __ddiv_rn(a, b);
}

// Sherman-Morrison's factor (y_0 + beta y_{n-1}/gamma) / (1 + z_0 + beta
// z_{n-1}/gamma) of solvers/thomas.cyclic_thomas, one rounding each.
template <typename T>
__device__ __forceinline__ T sm_fact(T y0, T z0, T yn, T zn, T beta,
                                     T gamma) {
  return div(add(y0, div(mul(beta, yn), gamma)),
             add(add(T(1), z0), div(mul(beta, zn), gamma)));
}

// One forward step of cyclic_thomas's double solve, one rounding each: the
// state (c', y', z') after row i from that after row i - 1.  Rows 0 and
// n-1 take the wrap couplings out (beta, gamma set at row 0), and B y = d
// and B z = u (u = gamma e_0 + alpha e_{n-1}) run together.  The
// Thomas-order replays of csrc/split_cyclic.cuh (K11, K16, K18, K22) run it
// and sm_fact: their plain versions bit for bit.
template <typename T>
struct ThomasStep {
  T cp = T(0), dy = T(0), dz = T(0);

  __device__ __forceinline__ void row(int64_t i, int64_t n, T a, T b, T c,
                                      T d, T& beta, T& gamma) {
    T u = T(0);
    if (i == 0) {
      beta = a;
      a = T(0);
      gamma = -b;
      b = sub(b, gamma);
      u = gamma;
    }
    if (i == n - 1) {
      const T alpha = c;
      c = T(0);
      b = sub(b, div(mul(alpha, beta), gamma));
      u = alpha;
    }
    const T denom = sub(b, mul(a, cp));
    cp = div(c, denom);
    dy = div(sub(d, mul(a, dy)), denom);
    dz = div(sub(u, mul(a, dz)), denom);
  }
};

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after opting in); a refusal surfaces as the launch's error.
template <typename K>
inline void allow_dynamic_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
}

}  // namespace atf

// Inside an ATF_DISPATCH body: an error before the launch (the scratch of
// a long line's reduced rows) returns at once.
#define ATF_RETURN_IF(expr)                          \
  do {                                               \
    const cudaError_t cfg_err = (expr);              \
    if (cfg_err != cudaSuccess) return (int)cfg_err; \
  } while (0)

// Selects `device`, runs the statement with `T` bound to the field type
// named by `dtype`, and returns the launch's cudaGetLastError().
#define ATF_DISPATCH(dtype, device, ...)                                  \
  do {                                                                    \
    cudaError_t set_err = cudaSetDevice(device);                          \
    if (set_err != cudaSuccess) return (int)set_err;                      \
    if ((dtype) == atf::kF32) {                                           \
      using T = float;                                                    \
      __VA_ARGS__;                                                        \
    } else if ((dtype) == atf::kF64) {                                    \
      using T = double;                                                   \
      __VA_ARGS__;                                                        \
    } else {                                                              \
      return (int)cudaErrorInvalidValue;                                  \
    }                                                                     \
    return (int)cudaGetLastError();                                       \
  } while (0)

// The same for the kernels with a bfloat16 entry: binds the storage type
// `S` and the compute type `C` (float32, float64, or bfloat16 solved at
// float32).
#define ATF_DISPATCH_STATE(dtype, device, ...)                            \
  do {                                                                    \
    cudaError_t set_err = cudaSetDevice(device);                          \
    if (set_err != cudaSuccess) return (int)set_err;                      \
    if ((dtype) == atf::kF32) {                                           \
      using S = float;                                                    \
      using C = float;                                                    \
      __VA_ARGS__;                                                        \
    } else if ((dtype) == atf::kF64) {                                    \
      using S = double;                                                   \
      using C = double;                                                   \
      __VA_ARGS__;                                                        \
    } else if ((dtype) == atf::kBF16) {                                   \
      using S = __nv_bfloat16;                                            \
      using C = float;                                                    \
      __VA_ARGS__;                                                        \
    } else {                                                              \
      return (int)cudaErrorInvalidValue;                                  \
    }                                                                     \
    return (int)cudaGetLastError();                                       \
  } while (0)
