// The films of the open tier-2 sweeps K15 (csrc/vp2_cyl.cu) and K8's
// general form (csrc/vp2_sweep.cu): the interface films h_lo and h_hi
// against tinf, the Picard radiative film, and the domain-edge films at
// rows 0 and n-1, each with its own radiative ambient, gated by code bit 8
// (solvers/vp2.py _open_films), one IEEE rounding per operation.
#pragma once

#include "varprop.cuh"

namespace {

// a domain-edge film (h, geo, t_inf) with its own radiative ambient
template <typename T>
struct Edge {
  int on;
  T h, g, tinf, tik, tik2;
};

// the film constants of an open sweep
template <typename T>
struct Films {
  T inv_dtor, h_lo, h_hi, tinf, rc, tik, tik2;
  int rad;
  Edge<T> e0, e1;
};

template <typename T>
Edge<T> make_edge(const double* e) {
  Edge<T> out;
  out.on = e[0] != 0.0;
  out.h = (T)e[1];
  out.g = (T)e[2];
  out.tinf = (T)e[3];
  out.tik = (T)e[4];
  out.tik2 = (T)e[5];
  return out;
}

template <typename T>
Films<T> make_films(double inv_dtor, double h_lo, double h_hi, double tinf,
                    double rc, double tik, double tik2, int rad,
                    const double* edges) {
  Films<T> f;
  f.inv_dtor = (T)inv_dtor;
  f.h_lo = (T)h_lo;
  f.h_hi = (T)h_hi;
  f.tinf = (T)tinf;
  f.rc = (T)rc;
  f.tik = (T)tik;
  f.tik2 = (T)tik2;
  f.rad = rad;
  f.e0 = make_edge<T>(edges);
  f.e1 = make_edge<T>(edges + 6);
  return f;
}

template <typename T>
__device__ __forceinline__ void edge_film(const Edge<T>& e, unsigned code,
                                          T tc, const Films<T>& f, T& sink,
                                          T& srhs) {
  using atf::add;
  using atf::mul;
  const T hr = f.rad ? atf::rad_film_rn(tc, f.rc, e.tik, e.tik2) : T(0);
  const T s = mul(mul(atf::bit<T>(code, 8u), e.g), add(e.h, hr));
  sink = add(sink, s);
  srhs = add(srhs, mul(s, e.tinf));
}

// (sink, srhs) of an open-sweep row from its code byte, T and film metrics
// gsl/gsh: bit2*gsl*(h_lo + hr) + bit4*gsh*(h_hi + hr), its product with
// tinf, then the edge films where the row is the first (row 0) or the last
// (row n-1)
template <typename T>
__device__ __forceinline__ void open_films(unsigned code, T tc, T gsl, T gsh,
                                           bool first, bool last,
                                           const Films<T>& f, T& sink,
                                           T& srhs) {
  using atf::add;
  using atf::mul;
  const T hr = f.rad ? atf::rad_film_rn(tc, f.rc, f.tik, f.tik2) : T(0);
  sink = add(mul(mul(atf::bit<T>(code, 2u), gsl), add(f.h_lo, hr)),
             mul(mul(atf::bit<T>(code, 4u), gsh), add(f.h_hi, hr)));
  srhs = mul(sink, f.tinf);
  if (first && f.e0.on) edge_film(f.e0, code, tc, f, sink, srhs);
  if (last && f.e1.on) edge_film(f.e1, code, tc, f, sink, srhs);
}

}  // namespace
