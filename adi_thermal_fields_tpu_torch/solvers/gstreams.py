"""The g-stream variable-property tier: kernels K23-K26 and their plain
versions.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_gstreams.py`` —
``gstream_fields`` (:163, body ``_gfields_kernel`` :73) -> K23
``gstream_fields``; ``gstream_theta_sweep`` (:839, body ``_gring_kernel``
:665) -> K24 ``gstream_theta_sweep``; ``gstream_sweep_axis1`` (:575) -> K25
``gstream_sweep_y``; ``gstream_sweep`` (:376), which the JAX step feeds the
(z, x, y) transposes, -> K26 ``gstream_sweep_z`` on the natural layout.
CUDA source: ``csrc/gstreams.cu``.

The fields pass folds every coefficient of the varprop rows into
pre-multiplied per-axis streams (``w = 1/(rho cp(T))``, ``fc`` the harmonic
face conductivity between in-mask neighbours, ``n`` the exposed faces along
the axis, ``h`` the film):

    g_lo = tg*w*fc_lo,  g_hi = tg*w*fc_hi,  sw = sk*h*w*n,  tg = theta*dt/d^2,
    sk = dt/d,  src_pre = dt*w*mask*src,

so each sweep is ``a = -g_lo, c = -g_hi, b = 1 + g_lo + g_hi + sw, d = rhs +
sw*t_inf`` with no codes (void cells have all-zero streams: identity rows)
and the theta pass is ``T + rr*sum_ax (g_lo*(T_lo - T) + g_hi*(T_hi - T))``
with ``rr = (1-theta)/theta``.  Every function computes at float32 for a
bfloat16 state (float64 at float64), in the JAX kernels' order, and stores
at the state dtype: the streams rounded to nearest, the sweeps' results to
nearest or, with ``rng_seed``, stochastically (solvers/rounding.py).  K23
repeats its plain version one IEEE rounding at a time; K24-K26 form the
same rows (and K24 the same right-hand sides) so, but solve each line
split across threads (K24 and K25 the strided kernel of
csrc/split_line.cuh, K26 the staged one of csrc/split_staged.cuh), within
the split kernels' gate.  Each
wrapper runs its plain version on CPU tensors and launches its kernel on
CUDA tensors, counting the launch in its ``launches`` attribute.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bc.faces import shift_in
from ..bc.radiation import STEFAN_BOLTZMANN
from ..kernels import (STATE_DTYPES, check_kernel_inputs, compute_dtype,
                       dtype_code, load_library, ptr, raise_on_error,
                       stream_ptr, use_kernel)
from .fields import stiff_flags
from .rounding import sr_key, to_state, widen
from .thomas import thomas
from .varprop import _table_arg, eval_spec, harm

__all__ = ["H_MODES", "gstream_fields",
           "gstream_fields_plain", "gstream_theta_sweep",
           "gstream_theta_sweep_plain", "gstream_sweep_y",
           "gstream_sweep_y_plain", "gstream_sweep_z",
           "gstream_sweep_z_plain"]

H_MODES = ("const", "stream", "rad")


def _gstream_scalars(dtype: torch.dtype, h_mode: str, hpar: float,
                    t_inf: float, h_conv: float) -> tuple[float, float,
                                                          float]:
    """``(hpar, tik, tik2)`` as the fields pass takes them, rounded at the
    compute dtype: the film ``hpar`` (``rad``: ``emissivity*sigma``, the
    product of the two rounded operands, as the JAX kernel forms it),
    ``Tik = t_inf + 273.15`` and ``Tik^2``."""
    f = np.float32 if compute_dtype(dtype) == torch.float32 else np.float64
    if h_mode == "rad":
        hpar = f(hpar) * f(STEFAN_BOLTZMANN)
    tik = f(t_inf) + f(273.15)
    return float(f(hpar)), float(tik), float(tik * tik)


# ---------------------------------------------------------------------------
# K23: the fields pass
# ---------------------------------------------------------------------------

def gstream_fields_plain(T, mask_u8, tg3, sk3, *, k_spec, cp_spec, rho,
                         h_mode="const", hpar=0.0, t_inf=0.0, h_conv=0.0,
                         dt=0.0, h=None, src=None):
    """Plain version of K23 (any device): the JAX ``_gfields_kernel``
    arithmetic with tensor shifts.  Returns ``(g_lo3, g_hi3, sw3,
    src_pre)``."""
    state = T.dtype
    Tc = widen(T)
    cdt = Tc.dtype
    m = (mask_u8 != 0).to(cdt)
    k = eval_spec(k_spec, Tc)
    w = 1.0 / (rho * eval_spec(cp_spec, Tc))
    hpar, tik, tik2 = _gstream_scalars(state, h_mode, hpar, t_inf, h_conv)
    if h_mode == "rad":
        tk = Tc + 273.15
        hloc = hpar * (tk + tik) * (tk * tk + tik2) + h_conv
    elif h_mode == "stream":
        hloc = widen(h)
    else:
        hloc = hpar
    wm = w * m
    hw = hloc * wm
    g_lo, g_hi, sw = [], [], []
    for ax in range(3):
        c_lo = m * shift_in(m, ax, -1, fill=0.0)
        c_hi = m * shift_in(m, ax, +1, fill=0.0)
        tw = tg3[ax] * w
        g_lo.append(tw * (harm(shift_in(k, ax, -1, fill=0.0), k) * c_lo))
        g_hi.append(tw * (harm(k, shift_in(k, ax, +1, fill=0.0)) * c_hi))
        sw.append((sk3[ax] * hw) * (2.0 - c_lo - c_hi))
    out = tuple(tuple(to_state(t, state) for t in group)
                for group in (g_lo, g_hi, sw))
    src_pre = (None if src is None else
               to_state((dt * wm) * widen(src), state))
    return (*out, src_pre)


def gstream_fields(T: torch.Tensor, mask_u8: torch.Tensor, tg3, sk3, *,
                   k_spec, cp_spec, rho: float, h_mode: str = "const",
                   hpar: float = 0.0, t_inf: float = 0.0,
                   h_conv: float = 0.0, dt: float = 0.0,
                   h: torch.Tensor | None = None,
                   src: torch.Tensor | None = None):
    """K23: the nine g-stream fields (and ``src_pre`` with ``src``) in one
    pass over T and the uint8 mask, natural (x, y, z) layout, T's dtype.

    ``tg3``: per-axis ``theta*dt/d^2``; ``sk3``: per-axis ``dt/d``;
    ``k_spec``/``cp_spec``: a number or a table (at most 32 breakpoints);
    ``h_mode``: "const" (the scalar film ``hpar``), "stream" (the per-cell
    film ``h``, T's dtype) or "rad" (``hpar`` the emissivity: the film
    ``eps*sigma*(Tk+Tik)(Tk^2+Tik^2) + h_conv`` in registers); ``src``: a
    volumetric source at T's dtype, giving ``src_pre = dt*w*mask*src``.
    Returns ``((g_lo x, y, z), (g_hi x, y, z), (sw x, y, z), src_pre)``."""
    if h_mode not in H_MODES:
        raise ValueError(f"h_mode must be one of {H_MODES}, got {h_mode!r}")
    if h_mode == "stream" and h is None:
        raise ValueError("h_mode='stream' needs the h field")
    h = h if h_mode == "stream" else None
    if not use_kernel(T, mask_u8, h, src):
        return gstream_fields_plain(
            T, mask_u8, tg3, sk3, k_spec=k_spec, cp_spec=cp_spec, rho=rho,
            h_mode=h_mode, hpar=hpar, t_inf=t_inf, h_conv=h_conv, dt=dt,
            h=h, src=src)
    if T.dim() != 3:
        raise ValueError(f"gstream_fields: field must be 3-D, got {T.dim()}")
    check_kernel_inputs("gstream_fields", T, mask_u8, h, src,
                        dtypes=STATE_DTYPES)
    ktab, kn = _table_arg(k_spec)
    ctab, cn = _table_arg(cp_spec)
    g_lo, g_hi, sw = ([torch.empty_like(T) for _ in range(3)]
                      for _ in range(3))
    srcp = None if src is None else torch.empty_like(T)
    hp, tik, tik2 = _gstream_scalars(T.dtype, h_mode, hpar, t_inf, h_conv)
    err = load_library().atf_gstream_fields(
        dtype_code(T.dtype), T.device.index, ptr(T), ptr(mask_u8), ptr(h),
        ptr(src), *(ptr(t) for ax in range(3) for t in (g_lo[ax], g_hi[ax])),
        *(ptr(t) for t in sw), ptr(srcp), *T.shape, ktab, kn, ctab, cn,
        float(rho), *(float(v) for v in tg3), *(float(v) for v in sk3), hp,
        tik, tik2, float(h_conv), float(dt), H_MODES.index(h_mode),
        stream_ptr(T.device))
    raise_on_error(err, "gstream_fields")
    gstream_fields.launches += 1
    return tuple(g_lo), tuple(g_hi), tuple(sw), srcp


gstream_fields.launches = 0


# ---------------------------------------------------------------------------
# K24-K26: the sweeps
# ---------------------------------------------------------------------------

def _gsolve(d, g_lo, g_hi, sw, t_inf, axis):
    """The g-stream rows along ``axis``, solved by ``thomas`` with one
    reciprocal per row (the kernels' order)."""
    b = 1.0 + g_lo + g_hi + sw
    dd = d + sw * t_inf
    mv = (lambda t: t.movedim(axis, 0))
    return thomas(mv(-g_lo), mv(b), mv(-g_hi), mv(dd), reciprocal=True) \
        .movedim(0, axis).contiguous()


def _theta_rhs(T, gx_lo, gx_hi, gy_lo, gy_hi, gz_lo, gz_hi, rr, src_pre):
    """K24's right-hand sides at the compute dtype: the explicit pass (x,
    then y, then z; each neighbour 0 past the domain edge)."""
    T = widen(T)
    acc = None
    for ax, lo, hi in ((0, gx_lo, gx_hi), (1, gy_lo, gy_hi),
                       (2, gz_lo, gz_hi)):
        lo, hi = widen(lo), widen(hi)
        term = (lo * (shift_in(T, ax, -1, fill=0.0) - T)
                + hi * (shift_in(T, ax, +1, fill=0.0) - T))
        acc = term if acc is None else acc + term
    d = T + rr * acc
    return d if src_pre is None else d + widen(src_pre)


def gstream_theta_sweep_plain(T, gx_lo, gx_hi, gy_lo, gy_hi, gz_lo, gz_hi,
                              sw_x, rr, t_inf, *, src_pre=None,
                              rng_seed=None, rng_offset=0):
    """Plain version of K24: the explicit pass (x, then y, then z), then the
    x rows and ``thomas``."""
    d = _theta_rhs(T, gx_lo, gx_hi, gy_lo, gy_hi, gz_lo, gz_hi, rr, src_pre)
    x = _gsolve(d, widen(gx_lo), widen(gx_hi), widen(sw_x), t_inf, 0)
    return to_state(x, T.dtype, sr_key(rng_seed, rng_offset))


def gstream_theta_sweep(T: torch.Tensor, gx_lo: torch.Tensor,
                        gx_hi: torch.Tensor, gy_lo: torch.Tensor,
                        gy_hi: torch.Tensor, gz_lo: torch.Tensor,
                        gz_hi: torch.Tensor, sw_x: torch.Tensor, rr: float,
                        t_inf: float, *, src_pre: torch.Tensor | None = None,
                        rng_seed: int | None = None,
                        rng_offset: int = 0) -> torch.Tensor:
    """K24: ``U = A_x^{-1}[(I + rr*G) T (+ src_pre) + sw_x*t_inf]``, the
    g-stream theta pass fused into the x sweep, natural (x, y, z) layout;
    ``rr = (1-theta)/theta``; streams from K23.  Its right-hand sides
    equal the plain version's bit for bit; the solve is split across
    threads (the strided split-line kernel, the stencil formed a chunk at a
    time, no c'/d' scratch), so within the split kernels' gate of its
    plain version, not bitwise; at float32 a block of 32 lines with a row
    past ``kK24Stiff`` (``csrc/gstreams.cu``) is solved again in Thomas
    order, bit for bit."""
    ins = (gx_lo, gx_hi, gy_lo, gy_hi, gz_lo, gz_hi, sw_x)
    if not use_kernel(T, *ins, src_pre):
        return gstream_theta_sweep_plain(T, *ins, rr, t_inf,
                                         src_pre=src_pre, rng_seed=rng_seed,
                                         rng_offset=rng_offset)
    if T.dim() != 3:
        raise ValueError(
            f"gstream_theta_sweep: field must be 3-D, got {T.dim()}")
    check_kernel_inputs("gstream_theta_sweep", T, None, *ins, src_pre,
                        dtypes=STATE_DTYPES)
    out = torch.empty_like(T)
    err = load_library().atf_gstream_theta_sweep(
        dtype_code(T.dtype), T.device.index, ptr(T), *(ptr(t) for t in ins),
        ptr(src_pre), ptr(out), *T.shape, float(rr), float(t_inf),
        sr_key(rng_seed, rng_offset), stream_ptr(T.device))
    raise_on_error(err, "gstream_theta_sweep")
    gstream_theta_sweep.launches += 1
    return out


gstream_theta_sweep.launches = 0


def _sweep_plain(rhs, g_lo, g_hi, sw, t_inf, axis, rng_seed, rng_offset):
    x = _gsolve(widen(rhs), widen(g_lo), widen(g_hi), widen(sw), t_inf,
                axis)
    return to_state(x, rhs.dtype, sr_key(rng_seed, rng_offset))


def gstream_sweep_y_plain(rhs, g_lo, g_hi, sw, t_inf, *, rng_seed=None,
                          rng_offset=0):
    """Plain version of K25: the y rows and ``thomas``."""
    return _sweep_plain(rhs, g_lo, g_hi, sw, t_inf, 1, rng_seed, rng_offset)


def gstream_sweep_z_plain(rhs, g_lo, g_hi, sw, t_inf, *, rng_seed=None,
                          rng_offset=0):
    """Plain version of K26: the z rows and ``thomas``."""
    return _sweep_plain(rhs, g_lo, g_hi, sw, t_inf, 2, rng_seed, rng_offset)


def gstream_sweep_y(rhs: torch.Tensor, g_lo: torch.Tensor,
                    g_hi: torch.Tensor, sw: torch.Tensor, t_inf: float, *,
                    rng_seed: int | None = None,
                    rng_offset: int = 0) -> torch.Tensor:
    """K25: the g-stream sweep along y of the natural (x, y, z) field, the
    streams the y ones of K23; split across threads (the strided
    split-line kernel, no c'/d' scratch), so within the split kernels' gate
    of its plain version, not bitwise; at float32 a block of 32 lines with
    a row past ``kK26Stiff`` (``csrc/gstreams.cu``) is solved again in
    Thomas order, bit for bit."""
    if not use_kernel(rhs, g_lo, g_hi, sw):
        return gstream_sweep_y_plain(rhs, g_lo, g_hi, sw, t_inf,
                                     rng_seed=rng_seed, rng_offset=rng_offset)
    if rhs.dim() != 3:
        raise ValueError(f"gstream_sweep_y: field must be 3-D, got "
                         f"{rhs.dim()}")
    check_kernel_inputs("gstream_sweep_y", rhs, None, g_lo, g_hi, sw,
                        dtypes=STATE_DTYPES)
    out = torch.empty_like(rhs)
    err = load_library().atf_gstream_sweep_strided(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(g_lo),
        ptr(g_hi), ptr(sw), ptr(out), *rhs.shape, float(t_inf),
        sr_key(rng_seed, rng_offset), stream_ptr(rhs.device))
    raise_on_error(err, "gstream_sweep_y")
    gstream_sweep_y.launches += 1
    return out


gstream_sweep_y.launches = 0


def gstream_sweep_z(rhs: torch.Tensor, g_lo: torch.Tensor,
                    g_hi: torch.Tensor, sw: torch.Tensor, t_inf: float, *,
                    rng_seed: int | None = None,
                    rng_offset: int = 0) -> torch.Tensor:
    """K26: the g-stream sweep along the contiguous z axis of the natural
    (x, y, z) field, every stream natural (the JAX step transposes the
    field and three streams for its axis-0 kernel instead); split across a
    warp's lanes (the staged split-line kernel, no c'/d' scratch), so
    within the split kernels' gate of its plain version, not bitwise; at
    float32 a line with a row past ``kK26Stiff`` (``csrc/gstreams.cu``) is
    solved again in Thomas order, bit for bit."""
    if not use_kernel(rhs, g_lo, g_hi, sw):
        return gstream_sweep_z_plain(rhs, g_lo, g_hi, sw, t_inf,
                                     rng_seed=rng_seed, rng_offset=rng_offset)
    if rhs.dim() != 3:
        raise ValueError(f"gstream_sweep_z: field must be 3-D, got "
                         f"{rhs.dim()}")
    check_kernel_inputs("gstream_sweep_z", rhs, None, g_lo, g_hi, sw,
                        dtypes=STATE_DTYPES)
    n = rhs.shape[-1]
    out = torch.empty_like(rhs)
    flags = stiff_flags(rhs, rhs.numel() // n)
    err = load_library().atf_gstream_sweep_z(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(g_lo),
        ptr(g_hi), ptr(sw), ptr(out), ptr(flags), rhs.numel() // n, n,
        float(t_inf), sr_key(rng_seed, rng_offset), stream_ptr(rhs.device))
    raise_on_error(err, "gstream_sweep_z")
    gstream_sweep_z.launches += 1
    return out


gstream_sweep_z.launches = 0
