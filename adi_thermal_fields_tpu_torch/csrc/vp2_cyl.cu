// K16: the tier-2 periodic sweep of the cylindrical variable-property
// step along phi (its r sweep K15 and z sweep, K8's general form, run on
// the core's split-line kernels in csrc/vp2_sweep.cu).
//
// K16 replaces adi_thermal_fields_tpu/solvers/pallas_vp2.py
//     fused_vp2_cyclic_axis1 (:812, call site :882, body _vp2_cyclic_kernel
//     :633): the PERIODIC solve along axis 1 of a (B1, n, B2) field -- phi
//     of the natural field.
//
// Row i, from rhs, T^n and the code byte (bits 1 = hi coupling live, 2/4 =
// lo/hi face exposed, 16 = lo coupling live), the coupling metric geo and
// film metric gs (one value per ring):
//   k_i = k(T_i); f_lo = bit16 ? harm(k_{i-1}, k_i) : 0 and f_hi = bit1 ?
//   harm(k_i, k_{i+1}) : 0 with i-1 and i+1 taken mod n; hr =
//   eps*sigma*(Tk+Tik)(Tk^2+Tik^2) (0 without radiation); sink = (bit2 +
//   bit4)*gs*(h_void + hr);
//   al = geo*f_lo; ch = geo*f_hi; coup = al + ch + sink;
//   w = coup > 0 ? cp(T_i)*inv_dtor : 1        (scaled-row elimination,
//   b = w + coup; d = rhs*w + sink*tinf; a = -al; c = -ch   pallas_vp2.py:335)
// and the wrap couplings come out by Sherman-Morrison in cyclic_thomas's
// gauge (csrc/split_cyclic.cuh).  The coup > 0 gate is right for films >= 0
// only; the step refuses negative films.
//
// Rounding: the kernel forms its plain version's rows (solvers/vp2.py: one
// tensor op per operation) one IEEE rounding at a time with the _rn helpers
// (common.cuh, varprop.cuh), which nvcc never contracts into an FMA.
// In float32 the apparent heat capacity jumps 12x at the solidus within
// one ulp of T, so one contracted rounding in T's path would move a cell
// across it.  K16 solves its rows split across threads: within 7.3e-4 K
// of its plain version at float32 on rings whose rows stay below a
// stiffness ratio of 12; a block of lines with a row past it (kK16Stiff:
// a tube's inner rings, a full disk's, where the split solve parts by up
// to 1 K) is solved in Thomas order instead, bit for bit.
//
// What bounds it on the H100: memory.  The byte model (float32) reads T
// (4) + code (1) + rhs (4) and writes x (4): 13 B/cell; k, cp, the faces
// and the films live in registers only.  It holds far below it (PERF.md
// section 6): K11's periodic split-line kernel (csrc/split_cyclic.cuh:
// lanes = 32 phi lines adjacent in z, the block's warps splitting each
// line's 8-row chunks, Sherman-Morrison's second right-hand side in the
// reduced system only); `Vp2CyclicRows` evaluates k(T) once a row and, at
// a chunk's edges, at rows row0 - 1 and row0 + M mod n (the wrap faces),
// cp(T) every row (selected where coup > 0, as K8).  Nothing but x leaves
// the SM (the first K16 marched a thread a pencil with c', y and z in
// global memory).  Latency holds it there -- four rounded divisions a row
// (harm and the elimination; with the hardware reciprocal it parted from
// the plain version past P8_TOL on the tube), two table evaluations a row
// and 64 registers a thread at 32 warps (small spills).  Its stiff blocks
// (a third of the (64, 512, 1024) tube's) replay the Thomas order at
// about five split blocks' time each: the tube takes ~1.8 ms, above the
// first K16's 1.6 (PERF.md section 6).
#include "split_cyclic.cuh"
#include "varprop.cuh"

namespace {

using atf::add;
using atf::mul;

// K16's stiffness ratio, as K11's (csrc/masked.cu): a block of lines with
// a row past |a| + |c| > kK16Stiff * (b - |a| - |c|) is solved in Thomas
// order, bit for bit vp2_cyclic_phi_plain.  12: every block split, blocks
// below 12 stayed within 7.3e-4 K of the plain version at float32 (P8_TOL
// 1e-3: a quarter spare), blocks of 12-16 reached 1.1e-3 K
// (scripts/cyclic_tune.py, PERF.md section 6).
constexpr double kK16Stiff = 12.0;

// K16's rows for the periodic split solve (csrc/split_cyclic.cuh): the
// rows of vp2_cyclic_phi_plain one rounding at a time, k(T) once a row (a
// chunk also at its rows row0 - 1 and row0 + M, mod n), each face's
// harm(k_{i-1}, k_i) in that order whichever row forms it.
template <typename T, int kSeg>
struct Vp2CyclicRows {
  static constexpr double kStiff = kK16Stiff;
  const T* rhs;
  const T* Tf;
  const uint8_t* code;
  const T* geo;
  const T* gs;
  atf::Table<T> ktab, ctab;
  T inv_dtor, h_void, tinf, rc, tik, tik2;
  int rad;

  template <int M, typename F>
  __device__ __forceinline__ void each(const CycLine& L, int64_t row0,
                                       F&& f) const {
    const int64_t n = L.n;
    const T g = __ldg(geo + L.b1);
    const T s = __ldg(gs + L.b1);
    auto tat = [&](int64_t i) { return __ldg(Tf + L.at(i)); };
    T t_cur = tat(row0);
    T k_cur = atf::table<kSeg>(ktab, t_cur);
    T h_lo = atf::harm_rn(atf::table<kSeg>(ktab, tat(row0 > 0 ? row0 - 1
                                                              : n - 1)),
                          k_cur);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int64_t i = row0 + k;
      if (i < n) {
        const T t_nxt = tat(i + 1 < n ? i + 1 : 0);
        const T k_nxt = atf::table<kSeg>(ktab, t_nxt);
        const T h_hi = atf::harm_rn(k_cur, k_nxt);
        const int64_t off = L.at(i);
        const unsigned cd = __ldg(code + off);
        const T f_lo = (cd & 16u) ? h_lo : T(0);
        const T f_hi = (cd & 1u) ? h_hi : T(0);
        const T hr = rad ? atf::rad_film_rn(t_cur, rc, tik, tik2) : T(0);
        const T sink =
            mul(mul(add(atf::bit<T>(cd, 2u), atf::bit<T>(cd, 4u)), s),
                add(h_void, hr));
        const T al = mul(g, f_lo);
        const T ch = mul(g, f_hi);
        const T coup = add(add(al, ch), sink);
        // cp at every row, selected where coup > 0 (as K8)
        const T cp = atf::table<kSeg>(ctab, t_cur);
        const T w = coup > T(0) ? mul(cp, inv_dtor) : T(1);
        f(k, -al, add(w, coup), -ch,
          add(mul(__ldg(rhs + off), w), mul(sink, tinf)));
        t_cur = t_nxt;
        k_cur = k_nxt;
        h_lo = h_hi;
      }
    }
  }
};

// Tables of at most kSmallSeg segments are summed without a branch (K8's
// kK8SmallSeg).
constexpr int kSmallSeg = 4;

template <typename T>
cudaError_t launch_vp2_cyclic_phi(const void* rhs, const void* Tf,
                                  const void* code, const void* geo,
                                  const void* gs, void* out, int64_t B1,
                                  int64_t n, int64_t B2, const double* ktab,
                                  int kn, const double* ctab, int cn,
                                  double inv_dtor, double h_void, double tinf,
                                  double rc, double tik, double tik2,
                                  int with_rad, int device,
                                  cudaStream_t stream) {
  auto launch = [&](auto rows) {
    rows.rhs = static_cast<const T*>(rhs);
    rows.Tf = static_cast<const T*>(Tf);
    rows.code = static_cast<const uint8_t*>(code);
    rows.geo = static_cast<const T*>(geo);
    rows.gs = static_cast<const T*>(gs);
    atf::make_table(ktab, kn, &rows.ktab);
    atf::make_table(ctab, cn, &rows.ctab);
    rows.inv_dtor = (T)inv_dtor;
    rows.h_void = (T)h_void;
    rows.tinf = (T)tinf;
    rows.rc = (T)rc;
    rows.tik = (T)tik;
    rows.tik2 = (T)tik2;
    rows.rad = with_rad;
    return launch_split_cyclic<T>(rows, static_cast<T*>(out), B1, n, B2,
                                  device, stream);
  };
  return kn <= kSmallSeg && cn <= kSmallSeg
             ? launch(Vp2CyclicRows<T, kSmallSeg>{})
             : launch(Vp2CyclicRows<T, 0>{});
}

bool tables_ok(int kn, int cn) {
  return kn >= 0 && kn <= atf::kMaxSeg && cn >= 0 && cn <= atf::kMaxSeg;
}

}  // namespace

ATF_API int atf_vp2_cyclic_phi(int dtype, int device, const void* rhs,
                               const void* Tf, const void* code,
                               const void* geo, const void* gs, void* out,
                               int64_t B1, int64_t n, int64_t B2,
                               const double* ktab, int kn, const double* ctab,
                               int cn, double inv_dtor, double h_void,
                               double tinf, double rc, double tik,
                               double tik2, int with_rad, void* stream) {
  if (!tables_ok(kn, cn)) return (int)cudaErrorInvalidValue;
  ATF_DISPATCH(dtype, device,
               ATF_RETURN_IF((launch_vp2_cyclic_phi<T>(
                   rhs, Tf, code, geo, gs, out, B1, n, B2, ktab, kn, ctab, cn,
                   inv_dtor, h_void, tinf, rc, tik, tik2, with_rad, device,
                   (cudaStream_t)stream))));
}
