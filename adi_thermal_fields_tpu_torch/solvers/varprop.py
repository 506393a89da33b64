"""Variable-property kernels K5, K6 and K7 with their plain versions.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_varprop.py`` —
``varprop_fields`` (:1274, body ``_vp_fields_kernel`` :1223) -> K5
``varprop_fields``; ``fused_varprop_theta_sweep`` (:1066, body
``_vp_ring_kernel`` :821) -> K6 ``varprop_theta_sweep``;
``fused_varprop_sweep_axis1`` (:718, body ``_varprop_kernel_axis1`` :560)
-> K7 ``varprop_sweep_y``; ``fused_varprop_sweep`` (:251, body
``_varprop_kernel`` :60) -> K7's entry point along x,
``varprop_sweep_x``, and K19 ``varprop_sweep_z`` (its natural-z form,
every stream natural); ``varprop_theta_rhs`` (:471, body
``_vp_rhs_kernel`` :403) -> K20 ``varprop_theta_rhs``.  CUDA sources:
``csrc/varprop_fields.cu`` (K5), ``csrc/varprop_sweeps.cu`` (K6, K7, K20)
and ``csrc/varprop_z.cu`` (K19).

Property tables reach the kernels as clamp-sum segments (``table_segments``):
``v(T) = v0 + sum_i s_i*clamp(T - p_i, 0, dp_i)`` in table order, slopes
``s_i = dv_i/dp_i`` in float64 on the host, a value step ``dv_i*(T > p_i)``
where ``dp_i == 0``, and segments with ``dv_i == 0`` skipped — the JAX
``PropertyTable`` evaluation.  Kernels and plain versions evaluate the same
segments in the same order at the field's dtype.

The implicit rows of K6, K7 and K19 (per pencil along the sweep axis,
``fc`` the pre-masked harmonic face conductivity of the lower face,
``fc[i+1]`` the upper, ``w = 1/(rho cp)``, code bits 1/2/8 of
``sweep_code``):

    tw = tg*w, a = -tw*fc[i], c = -tw*fc[i+1],
    sink = (sk*h)*((2-low-high)*inm), sw = sink*w,
    b = 1 + tw*(fc[i] + fc[i+1]) + sw, d = rhs + sw*t_inf

with ``h`` a per-cell film stream or the scalar ``rob_c``.  The explicit
pass of K6 and K20 is ``R0 = T + (cw*w*inm)*sum_ax iv_ax*(f_lo*(T_lo - T) +
f_hi*(T_hi - T)) [+ (dt*w*inm)*src]``, faces x, then y, then z; like the
JAX kernel it leaves the Robin flux out of R0.  K20 repeats its plain
version one IEEE rounding at a time, and K6 forms its right-hand sides
as K20 does.  K6, K7, K7's x entry and K19 form the plain versions' rows
bit for bit but solve each line split across threads (the split-line
core of ``csrc/split_line.cuh``), not in Thomas order: within a few
float32 ulp of the output's scale.  K6 and K7's x entry cut each line
into the same chunks, so K20 then K7's x entry equals K6 bit for bit.
Each wrapper runs its plain version on CPU tensors and launches its
kernel on CUDA tensors, counting the launch in its ``launches``
attribute; none takes a scratch field.

bfloat16 states (the entries "K5b", "K6b", "K7b", "K7xb", "K19b" and
"K20b", counted apart in ``<wrapper>.bf16.launches``): every stream is
read at bfloat16 and widened, the fields, rows and right-hand sides are
formed and solved at float32, and each result is stored at bfloat16 by
``solvers/rounding.py``: the fields pass to nearest (the JAX kernel casts
its float32 results), the sweeps and K20 to nearest or, with
``rng_seed``, stochastically under ``sr_key(rng_seed, rng_offset)``.  K6
keeps its right-hand sides at float32 (JAX's ring kernel, :856-857), so at
bfloat16 K20 -> K7x, which stores R0, is not K6 bit for bit.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from ..bc.faces import shift_in
from ..bc.radiation import STEFAN_BOLTZMANN, radiative_h
from ..kernels import (STATE_DTYPES, check_kernel_inputs, compute_dtype,
                       dtype_code, load_library, ptr, raise_on_error,
                       stream_ptr, use_kernel)
from .rounding import sr_key, to_state, widen
from .stencil import _inv3
from .thomas import thomas

__all__ = ["MAX_TABLE_POINTS", "table_segments", "clamp_sum", "eval_spec",
           "face_g", "harm", "varprop_fields", "varprop_fields_plain",
           "varprop_theta_sweep", "varprop_theta_sweep_plain",
           "varprop_theta_rhs", "varprop_theta_rhs_plain",
           "varprop_sweep_x", "varprop_sweep_x_plain",
           "varprop_sweep_y", "varprop_sweep_y_plain",
           "varprop_sweep_z", "varprop_sweep_z_plain"]

# breakpoints a kernel table holds (csrc/varprop.cuh: kMaxSeg = 31 segments)
MAX_TABLE_POINTS = 32
_LOW, _HIGH, _INMASK = 1, 2, 8


def table_segments(spec) -> tuple[float, tuple]:
    """``(v0, ((p, dp, s), ...))`` of a property spec: a number (constant,
    no segments) or a table with ``points`` and ``values`` (strictly
    increasing points; duplicates make a value step).  ``s`` is the slope
    ``dv/dp``, or the step ``dv`` where ``dp == 0``."""
    if isinstance(spec, (int, float)):
        return float(spec), ()
    pts = [float(p) for p in spec.points]
    vals = [float(v) for v in spec.values]
    segs = []
    for i in range(len(pts) - 1):
        dp = pts[i + 1] - pts[i]
        dv = vals[i + 1] - vals[i]
        if dv == 0.0:
            continue
        segs.append((pts[i], dp, dv / dp if dp > 0.0 else dv))
    return vals[0], tuple(segs)


def clamp_sum(Tc: torch.Tensor, v0: float, segs) -> torch.Tensor:
    """The clamp-sum of ``table_segments`` at ``Tc``'s dtype."""
    acc = torch.full_like(Tc, v0)
    for p, dp, s in segs:
        if dp > 0.0:
            acc = acc + s * torch.clamp(Tc - p, 0.0, dp)
        else:     # duplicate abscissae: a value step at p
            acc = acc + s * (Tc > p).to(Tc.dtype)
    return acc


def eval_spec(spec, T: torch.Tensor) -> torch.Tensor:
    """A property spec (number or table) evaluated at ``T``."""
    return clamp_sum(T, *table_segments(spec))


def harm(ka: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Harmonic mean ``2 ka kb / (ka + kb)``, zero where the sum is not
    positive."""
    den = ka + kb
    return torch.where(den > 0, 2.0 * ka * kb / torch.where(den > 0, den, 1.0),
                       0.0)


def face_g(kf: torch.Tensor, axis: int, direction: int,
           mask: torch.Tensor) -> torch.Tensor:
    """Harmonic face conductivity toward the (axis, direction) neighbour;
    zero across mask boundaries and domain edges (JAX
    ``step/cartesian_varprop._face_g``)."""
    kn = shift_in(kf, axis, direction, fill=0.0)
    mn = shift_in(mask, axis, direction, fill=False)
    return torch.where(mask & mn, harm(kf, kn), 0.0)


def _table_arg(spec):
    """A table spec as the C entry points take it: a double buffer
    ``[v0, p0, dp0, s0, p1, ...]`` and the segment count."""
    if not isinstance(spec, (int, float)) and \
            len(spec.points) > MAX_TABLE_POINTS:
        raise ValueError(f"a kernel property table holds at most "
                         f"{MAX_TABLE_POINTS} breakpoints, got "
                         f"{len(spec.points)}")
    v0, segs = table_segments(spec)
    flat = [v0] + [v for seg in segs for v in seg]
    return (ctypes.c_double * len(flat))(*flat), len(segs)


def _rad_scalars(emissivity: float, t_inf: float, dtype: torch.dtype):
    """``(eps*sigma, Tik, Tik^2)`` of ``radiative_h`` at ``dtype``:
    ``Tik = dtype(t_inf) + dtype(273.15)`` and its square at ``dtype``."""
    tik = (torch.tensor(t_inf, dtype=dtype)
           + torch.tensor(273.15, dtype=dtype))
    return emissivity * STEFAN_BOLTZMANN, float(tik), float(tik * tik)


def _counter(fn, t: torch.Tensor):
    """Where ``fn`` counts a launch on ``t``: its bfloat16 entry's
    ``fn.bf16``, else ``fn``."""
    return fn.bf16 if t.dtype == torch.bfloat16 else fn


# ---------------------------------------------------------------------------
# K5: the fields pass
# ---------------------------------------------------------------------------

def varprop_fields_plain(T, mask_u8, *, k_spec, cp_spec, rho: float,
                         rad=None):
    """Plain version of K5: the XLA formulation of JAX
    ``build_varprop_fields`` (cartesian_varprop.py:426-447); a bfloat16 T
    at float32, each output rounded to nearest."""
    dtype = T.dtype
    T = widen(T)
    mask = mask_u8 != 0
    kf = eval_spec(k_spec, T)
    fc = tuple(to_state(face_g(kf, ax, -1, mask), dtype) for ax in range(3))
    w = to_state(1.0 / (rho * eval_spec(cp_spec, T)), dtype)
    if rad is None:
        return fc, w
    eps, tinf, hconv = rad
    return fc, w, to_state(radiative_h(T, eps, tinf, h_conv=hconv), dtype)


def varprop_fields(T: torch.Tensor, mask_u8: torch.Tensor, *, k_spec,
                   cp_spec, rho: float, rad: tuple | None = None):
    """K5: per-axis pre-masked harmonic face conductivities, ``1/(rho cp)``
    and (``rad = (emissivity, t_inf, h_conv)``) the Picard radiative film,
    in one pass over ``T`` and the uint8 mask, natural (x, y, z) layout.

    ``fx[i] = harm(k[i-1], k[i])`` where cells i-1 and i are both in-mask,
    else 0 (likewise fy, fz); ``k_spec``/``cp_spec``: a number or a table
    (``points``/``values``, at most 32 breakpoints).  Returns
    ``((fx, fy, fz), w)`` or ``((fx, fy, fz), w, h)``.  A bfloat16 T
    (K5b) is evaluated at float32, the outputs rounded to nearest."""
    if not use_kernel(T, mask_u8):
        return varprop_fields_plain(T, mask_u8, k_spec=k_spec,
                                    cp_spec=cp_spec, rho=rho, rad=rad)
    if T.dim() != 3:
        raise ValueError(f"varprop_fields: field must be 3-D, got {T.dim()}")
    check_kernel_inputs("varprop_fields", T, mask_u8, dtypes=STATE_DTYPES)
    ktab, kn = _table_arg(k_spec)
    ctab, cn = _table_arg(cp_spec)
    outs = [torch.empty_like(T) for _ in range(4 if rad is None else 5)]
    if rad is None:
        rc, tik, tik2, hconv = 0.0, 0.0, 0.0, 0.0
    else:
        eps, tinf, hconv = rad
        rc, tik, tik2 = _rad_scalars(float(eps), float(tinf),
                                     compute_dtype(T.dtype))
    err = load_library().atf_varprop_fields(
        dtype_code(T.dtype), T.device.index, ptr(T), ptr(mask_u8),
        *(ptr(o) for o in outs[:4]), ptr(outs[4]) if rad is not None else None,
        *T.shape, ktab, kn, ctab, cn, float(rho), rc, tik, tik2,
        float(hconv), stream_ptr(T.device))
    raise_on_error(err, "varprop_fields")
    _counter(varprop_fields, T).launches += 1
    fc, w = tuple(outs[:3]), outs[3]
    return (fc, w) if rad is None else (fc, w, outs[4])


varprop_fields.launches = 0
varprop_fields.bf16 = SimpleNamespace(launches=0)   # K5b


# ---------------------------------------------------------------------------
# K6 and K7: the sweeps
# ---------------------------------------------------------------------------

def _varprop_solve(d, code, fc, w, tg, sk, t_inf, h, rob_c, axis):
    """The module's implicit rows along ``axis``, solved by ``thomas`` with
    one reciprocal per row (the JAX kernel's order), at ``d``'s dtype (the
    streams widened to it)."""
    dtype = d.dtype
    fc, w, h = widen(fc), widen(w), widen(h)
    bit = (lambda b: ((code & b) != 0).to(dtype))
    low, high, inm = bit(_LOW), bit(_HIGH), bit(_INMASK)
    # sk*h at the field's dtype (the kernels' scalar product)
    hv = h if h is not None else torch.tensor(rob_c, dtype=dtype)
    sink = (torch.tensor(sk, dtype=dtype) * hv) * ((2.0 - low - high) * inm)
    f_hi = shift_in(fc, axis, +1, fill=0.0)
    tw = tg * w
    a = -tw * fc
    c = -tw * f_hi
    sw = sink * w
    b = 1.0 + tw * (fc + f_hi) + sw
    dd = d + sw * t_inf
    mv = (lambda t: t.movedim(axis, 0))
    return thomas(mv(a), mv(b), mv(c), mv(dd), reciprocal=True) \
        .movedim(0, axis).contiguous()


def _theta_rhs(T, inm, fx, fy, fz, w, cw, inv_d2, src, dt):
    """The explicit pass of K6 and K20 (``_vp_rhs_kernel``: faces x, then
    y, then z); ``inm``: the in-mask factor at T's dtype; the streams
    widened to it."""
    fx, fy, fz, w, src = (widen(t) for t in (fx, fy, fz, w, src))
    acc = None
    for ax, f, iv in zip(range(3), (fx, fy, fz), _inv3(inv_d2)):
        f_hi = shift_in(f, ax, +1, fill=0.0)
        term = (f * (shift_in(T, ax, -1, fill=0.0) - T)
                + f_hi * (shift_in(T, ax, +1, fill=0.0) - T)) * iv
        acc = term if acc is None else acc + term
    gain = w * inm
    d = T + cw * gain * acc
    if src is not None:
        d = d + dt * gain * src
    return d


def varprop_theta_sweep_plain(T, code, fx, fy, fz, w, cw, inv_d2, tg, sk,
                              t_inf, *, h=None, rob_c=0.0, src=None,
                              dt=None, rng_seed=None, rng_offset=0):
    """Plain version of K6: the explicit pass, then the x rows and
    ``thomas``; a bfloat16 T at float32 (R0 kept at float32), U stored
    back by ``to_state``."""
    dtype = T.dtype
    T = widen(T)
    inm = ((code & _INMASK) != 0).to(T.dtype)
    d = _theta_rhs(T, inm, fx, fy, fz, w, cw, inv_d2, src, dt)
    x = _varprop_solve(d, code, fx, w, tg, sk, t_inf, h, rob_c, 0)
    return to_state(x, dtype, sr_key(rng_seed, rng_offset))


def varprop_theta_sweep(T: torch.Tensor, code: torch.Tensor,
                        fx: torch.Tensor, fy: torch.Tensor, fz: torch.Tensor,
                        w: torch.Tensor, cw: float, inv_d2, tg: float,
                        sk: float, t_inf: float, *,
                        h: torch.Tensor | None = None, rob_c: float = 0.0,
                        src: torch.Tensor | None = None,
                        dt: float | None = None, rng_seed: int | None = None,
                        rng_offset: int = 0) -> torch.Tensor:
    """K6: ``U = A_x^{-1}[(I + cw W L) T (+ dt W src) + sink*t_inf]``, the
    explicit varprop theta pass fused into the x sweep, on the natural
    (x, y, z) field.

    ``code``: the x sweep code ``sweep_code(mask, None, 0)`` (bits 1/2/8);
    ``fx/fy/fz``: pre-masked faces (K5); ``w = 1/(rho cp)``;
    ``cw = (1-theta)*dt``; ``inv_d2``: per-axis 1/d^2; ``tg =
    theta*dt/dx^2``; ``sk = dt/dx``; ``h``: per-cell film stream, else the
    scalar ``rob_c``; ``src``: volumetric source (needs ``dt``).  Each x
    line is split across a block's warps (no c'/d' scratch).  A bfloat16
    state (K6b) solves at float32 and stores U to nearest, or
    stochastically with ``rng_seed`` / ``rng_offset``."""
    if src is not None and dt is None:
        raise ValueError("varprop_theta_sweep: src needs dt")
    sr = dict(rng_seed=rng_seed, rng_offset=rng_offset)
    if not use_kernel(T, code, fx, fy, fz, w, h, src):
        return varprop_theta_sweep_plain(T, code, fx, fy, fz, w, cw, inv_d2,
                                         tg, sk, t_inf, h=h, rob_c=rob_c,
                                         src=src, dt=dt, **sr)
    if T.dim() != 3:
        raise ValueError(
            f"varprop_theta_sweep: field must be 3-D, got {T.dim()}")
    check_kernel_inputs("varprop_theta_sweep", T, code, fx, fy, fz, w, h, src,
                        dtypes=STATE_DTYPES)
    ivx, ivy, ivz = _inv3(inv_d2)
    out = torch.empty_like(T)
    err = load_library().atf_varprop_theta_sweep(
        dtype_code(T.dtype), T.device.index, ptr(T), ptr(code), ptr(fx),
        ptr(fy), ptr(fz), ptr(w), ptr(h), ptr(src), ptr(out), *T.shape, cw,
        0.0 if dt is None else dt, ivx, ivy, ivz, tg, sk, t_inf, rob_c,
        sr_key(rng_seed, rng_offset), stream_ptr(T.device))
    raise_on_error(err, "varprop_theta_sweep")
    _counter(varprop_theta_sweep, T).launches += 1
    return out


varprop_theta_sweep.launches = 0
varprop_theta_sweep.bf16 = SimpleNamespace(launches=0)   # K6b


# ---------------------------------------------------------------------------
# K20: the explicit pass alone
# ---------------------------------------------------------------------------

def varprop_theta_rhs_plain(T, fx, fy, fz, w, mask_u8, cw, inv_d2, *,
                            src=None, dt=None, rng_seed=None, rng_offset=0):
    """Plain version of K20; a bfloat16 T at float32, R0 stored back by
    ``to_state``."""
    dtype = T.dtype
    T = widen(T)
    inm = (mask_u8 != 0).to(T.dtype)
    return to_state(_theta_rhs(T, inm, fx, fy, fz, w, cw, inv_d2, src, dt),
                    dtype, sr_key(rng_seed, rng_offset))


def varprop_theta_rhs(T: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                      fz: torch.Tensor, w: torch.Tensor,
                      mask_u8: torch.Tensor, cw: float, inv_d2, *,
                      src: torch.Tensor | None = None,
                      dt: float | None = None, rng_seed: int | None = None,
                      rng_offset: int = 0) -> torch.Tensor:
    """K20: ``R0 = T + (cw*w*mask)*sum_ax iv_ax*(f_lo*(T_lo - T) + f_hi*(T_hi
    - T)) [+ (dt*w*mask)*src]`` on the natural (x, y, z) field, from the
    pre-masked faces of K5 (no neighbour masks needed) and the uint8 mask.
    ``cw = (1-theta)*dt``; ``inv_d2``: per-axis 1/d^2; ``src``: volumetric
    source (needs ``dt``).  The Robin flux stays out of R0.  A bfloat16
    state (K20b) forms R0 at float32 and stores it to nearest, or
    stochastically with ``rng_seed`` / ``rng_offset``."""
    if src is not None and dt is None:
        raise ValueError("varprop_theta_rhs: src needs dt")
    sr = dict(rng_seed=rng_seed, rng_offset=rng_offset)
    if not use_kernel(T, fx, fy, fz, w, mask_u8, src):
        return varprop_theta_rhs_plain(T, fx, fy, fz, w, mask_u8, cw,
                                       inv_d2, src=src, dt=dt, **sr)
    if T.dim() != 3:
        raise ValueError(
            f"varprop_theta_rhs: field must be 3-D, got {T.dim()}")
    check_kernel_inputs("varprop_theta_rhs", T, mask_u8, fx, fy, fz, w, src,
                        dtypes=STATE_DTYPES)
    ivx, ivy, ivz = _inv3(inv_d2)
    out = torch.empty_like(T)
    err = load_library().atf_varprop_theta_rhs(
        dtype_code(T.dtype), T.device.index, ptr(T), ptr(fx), ptr(fy),
        ptr(fz), ptr(w), ptr(mask_u8), ptr(src), ptr(out), *T.shape, cw,
        0.0 if dt is None else dt, ivx, ivy, ivz,
        sr_key(rng_seed, rng_offset), stream_ptr(T.device))
    raise_on_error(err, "varprop_theta_rhs")
    _counter(varprop_theta_rhs, T).launches += 1
    return out


varprop_theta_rhs.launches = 0
varprop_theta_rhs.bf16 = SimpleNamespace(launches=0)   # K20b


def _sweep_plain(rhs, code, fc, w, tg, sk, t_inf, h, rob_c, axis, rng_seed,
                 rng_offset):
    """The plain sweeps along ``axis``: a bfloat16 rhs at float32, the
    result stored back by ``to_state``."""
    x = _varprop_solve(widen(rhs), code, fc, w, tg, sk, t_inf, h, rob_c,
                       axis)
    return to_state(x, rhs.dtype, sr_key(rng_seed, rng_offset))


def varprop_sweep_x_plain(rhs, code, fc, w, tg, sk, t_inf, *, h=None,
                          rob_c=0.0, rng_seed=None, rng_offset=0):
    """Plain version of K7's x entry: the x rows and ``thomas``."""
    return _sweep_plain(rhs, code, fc, w, tg, sk, t_inf, h, rob_c, 0,
                        rng_seed, rng_offset)


def _launch_strided(name, fn, rhs, code, fc, w, h, dims, tg, sk, t_inf,
                    rob_c, rng_seed, rng_offset):
    """K7 and its x entry on ``dims`` = (B1, n, B2), counted in ``fn``'s
    launches (its ``bf16`` namespace at bfloat16)."""
    if rhs.dim() != 3:
        raise ValueError(f"{name}: field must be 3-D, got {rhs.dim()}")
    check_kernel_inputs(name, rhs, code, fc, w, h, dtypes=STATE_DTYPES)
    out = torch.empty_like(rhs)
    err = load_library().atf_varprop_sweep_strided(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(code),
        ptr(fc), ptr(w), ptr(h), ptr(out), *dims, tg, sk, t_inf, rob_c,
        sr_key(rng_seed, rng_offset), stream_ptr(rhs.device))
    raise_on_error(err, name)
    _counter(fn, rhs).launches += 1
    return out


def varprop_sweep_x(rhs: torch.Tensor, code: torch.Tensor, fc: torch.Tensor,
                    w: torch.Tensor, tg: float, sk: float, t_inf: float, *,
                    h: torch.Tensor | None = None, rob_c: float = 0.0,
                    rng_seed: int | None = None,
                    rng_offset: int = 0) -> torch.Tensor:
    """K7's entry point along x: the varprop rows of ``varprop_sweep_y``
    along the leading axis of the natural field, viewed as (1, nx,
    ny*nz) (the solve-leading form of JAX ``fused_varprop_sweep``), in
    K6's chunks.  ``code``: the x sweep code
    ``sweep_code(mask, None, 0)``; ``fc``: the x faces.  Counted in its
    own ``launches`` ("K7x"; its bfloat16 entry "K7xb" in ``bf16``)."""
    sr = dict(rng_seed=rng_seed, rng_offset=rng_offset)
    if not use_kernel(rhs, code, fc, w, h):
        return varprop_sweep_x_plain(rhs, code, fc, w, tg, sk, t_inf, h=h,
                                     rob_c=rob_c, **sr)
    nx = rhs.shape[0]
    return _launch_strided("varprop_sweep_x", varprop_sweep_x, rhs, code, fc,
                           w, h, (1, nx, rhs.numel() // nx), tg, sk, t_inf,
                           rob_c, **sr)


varprop_sweep_x.launches = 0
varprop_sweep_x.bf16 = SimpleNamespace(launches=0)   # K7xb


def varprop_sweep_y_plain(rhs, code, fc, w, tg, sk, t_inf, *, h=None,
                          rob_c=0.0, rng_seed=None, rng_offset=0):
    """Plain version of K7: the y rows and ``thomas``."""
    return _sweep_plain(rhs, code, fc, w, tg, sk, t_inf, h, rob_c, 1,
                        rng_seed, rng_offset)


def varprop_sweep_y(rhs: torch.Tensor, code: torch.Tensor, fc: torch.Tensor,
                    w: torch.Tensor, tg: float, sk: float, t_inf: float, *,
                    h: torch.Tensor | None = None, rob_c: float = 0.0,
                    rng_seed: int | None = None,
                    rng_offset: int = 0) -> torch.Tensor:
    """K7: the varprop sweep along y of the natural (x, y, z) field, each
    line split across a block's warps (no c'/d' scratch).  ``code`` is the
    y sweep code in the natural layout (``sweep_code(mask, None,
    1).movedim(0, 1)``), ``fc`` the y faces.  A bfloat16 state (K7b, and
    K7xb along x) solves at float32 and stores its result to nearest, or
    stochastically with ``rng_seed`` / ``rng_offset``."""
    sr = dict(rng_seed=rng_seed, rng_offset=rng_offset)
    if not use_kernel(rhs, code, fc, w, h):
        return varprop_sweep_y_plain(rhs, code, fc, w, tg, sk, t_inf, h=h,
                                     rob_c=rob_c, **sr)
    return _launch_strided("varprop_sweep_y", varprop_sweep_y, rhs, code, fc,
                           w, h, tuple(rhs.shape), tg, sk, t_inf, rob_c,
                           **sr)


varprop_sweep_y.launches = 0
varprop_sweep_y.bf16 = SimpleNamespace(launches=0)   # K7b


# ---------------------------------------------------------------------------
# K19: the sweep along contiguous z
# ---------------------------------------------------------------------------

def varprop_sweep_z_plain(rhs, code, fc, w, tg, sk, t_inf, *, h=None,
                          rob_c=0.0, rng_seed=None, rng_offset=0):
    """Plain version of K19: the z rows and ``thomas``."""
    return _sweep_plain(rhs, code, fc, w, tg, sk, t_inf, h, rob_c, 2,
                        rng_seed, rng_offset)


def varprop_sweep_z(rhs: torch.Tensor, code: torch.Tensor, fc: torch.Tensor,
                    w: torch.Tensor, tg: float, sk: float, t_inf: float, *,
                    h: torch.Tensor | None = None, rob_c: float = 0.0,
                    rng_seed: int | None = None,
                    rng_offset: int = 0) -> torch.Tensor:
    """K19: the varprop rows along the contiguous z axis, every stream and
    the result in the natural (x, y, z) layout.  ``code``: the z sweep
    code in the natural layout (``sweep_code(mask, None, 2).movedim(0,
    2)``); ``fc``: the z faces (K5); ``h``: a film stream, else the scalar
    ``rob_c``.  Each line is split across a warp (no c'/d' scratch).  A
    bfloat16 state (K19b: the staged kernel of K26, streams staged at
    bfloat16) solves at float32 and stores its result to nearest, or
    stochastically with ``rng_seed`` / ``rng_offset``."""
    sr = dict(rng_seed=rng_seed, rng_offset=rng_offset)
    if not use_kernel(rhs, code, fc, w, h):
        return varprop_sweep_z_plain(rhs, code, fc, w, tg, sk, t_inf, h=h,
                                     rob_c=rob_c, **sr)
    if rhs.dim() != 3:
        raise ValueError(
            f"varprop_sweep_z: field must be 3-D, got {rhs.dim()}")
    check_kernel_inputs("varprop_sweep_z", rhs, code, fc, w, h,
                        dtypes=STATE_DTYPES)
    out = torch.empty_like(rhs)
    n = rhs.shape[2]
    err = load_library().atf_varprop_sweep_z(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(code),
        ptr(fc), ptr(w), ptr(h), ptr(out), rhs.numel() // n, n, tg, sk,
        t_inf, rob_c, sr_key(rng_seed, rng_offset), stream_ptr(rhs.device))
    raise_on_error(err, "varprop_sweep_z")
    _counter(varprop_sweep_z, rhs).launches += 1
    return out


varprop_sweep_z.launches = 0
varprop_sweep_z.bf16 = SimpleNamespace(launches=0)   # K19b
