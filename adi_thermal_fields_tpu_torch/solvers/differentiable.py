"""Autograd Functions over the kernel path, with hand-derived pullbacks.

Counterpart: ``adi_thermal_fields_tpu/solvers/differentiable.py`` — the
custom VJPs ``sweep_solve`` (:125), ``sweep_solve_lite`` (:226),
``fused_theta_solve_lite`` (:312), ``theta_rhs_diff`` (:367),
``vp_sweep_solve`` (:438), ``vp_cyclic_solve`` (:494), ``vp2_sweep_solve``
(:566) and ``vp2_cyclic_solve`` (:626), under the same names and
arguments.  The plain steps (step/cartesian.py, the reference tiers) are
differentiable as they stand; the kernel wrappers are forward only
(kernels/__init__.py), and these Functions carry autograd across them.

* The forward calls the kernel wrapper with grad mode off: the kernel on a
  CUDA tensor, its plain version on a CPU tensor.  With no input that
  requires grad, ``Function.apply`` runs the same forward and records no
  graph, so a step launches what it launched before.  The kernels take
  their scalars
  (``tg``, ``dt``, ``c_exp``, ``rob_c``, ``inv_dtor``) as Python floats: a
  0-d tensor is read back with ``float``, a host sync on the gradient
  route only.
* Sweeps: ``x = A^{-1} d``.  The pullback solves the transposed system
  ``A^T y = g`` (``a_t[i] = c[i-1]``, ``c_t[i] = a[i+1]``) on K21
  (``tridiag_fields``; K22 ``cyclic_fields`` for the periodic phi
  sweeps), whose plain versions run on the CPU, and contracts y against
  the parameter Jacobians, ``p_bar = y^T (dd/dp) - y^T (dA/dp) x``, term
  for term as the JAX module does.  Every A here is row and column
  diagonally dominant, so A^T is row dominant and K21's and K22's replays
  of stiff blocks apply unchanged.
* The theta-pass stencil ``R0 = (I + c L) T`` is self-adjoint (L is the
  symmetric masked Laplacian): its pullback is K3 on the cotangent.
* The tier-2 sweeps (K15, K16, K8's general form) derive their rows from
  T^n.  The pullback rebuilds the physical streams from T and ``dtor``
  under ``torch.enable_grad`` (the JAX module's ``jax.vjp`` of
  ``vp2_streams_xla``), takes their cotangents from the stream formulas of
  ``vp_sweep_solve`` / ``vp_cyclic_solve``, and pulls them back to T and
  ``dtor`` with ``torch.autograd.grad``.

No backward runs ``thomas``'s row loop on the card (n launches a sweep).
The split-line kernels are a few float32 ulp from Thomas order, and so
are K21 and K22: on the card a gradient agrees with its plain version's
to float32 ulps of its scale, not bit for bit.  bfloat16 states have no
Functions: the JAX step bypasses its VJPs there, and so does
``adi_step_fused``.
"""
from __future__ import annotations

import torch

from ..bc.faces import shift_in
from .fields import cyclic_fields, tridiag_fields
from .stencil import theta_rhs
from .sweeps import sweep_strided, sweep_z
from .theta_sweep import fused_theta_sweep
from .varprop import eval_spec
from .vp2 import (_col, vp2_cyclic_phi, vp2_cyclic_streams,
                  vp2_open_streams, vp2_sweep_strided, vp2_sweep_z)
from .vpfields import (vp_fields_cyclic_phi, vp_fields_sweep_strided,
                       vp_fields_sweep_z)

__all__ = ["sweep_solve", "sweep_solve_lite", "theta_rhs_diff",
           "fused_theta_solve_lite", "vp_sweep_solve", "vp_cyclic_solve",
           "vp2_sweep_solve", "vp2_cyclic_solve"]


def _f(x):
    """A scalar as the kernels take it: a Python float.  ``float`` of a
    0-d tensor is a host sync, paid on the gradient route only."""
    return float(x) if torch.is_tensor(x) else x


def _dn(x, axis):
    """x[i-1] along ``axis``, 0 at i = 0."""
    return shift_in(x, axis, -1, fill=0.0)


def _up(x, axis):
    """x[i+1] along ``axis``, 0 at i = n-1."""
    return shift_in(x, axis, +1, fill=0.0)


def _solve_t(a, b, c, g, axis):
    """``y = A^{-T} g`` for the open rows (a, b, c) along ``axis``: K21 on
    the transposed rows (plain ``thomas`` on the CPU)."""
    return tridiag_fields(_dn(c, axis).contiguous(), b.contiguous(),
                          _up(a, axis).contiguous(), g.contiguous(), axis)


def _solve_t_cyclic(a, b, c, g):
    """``y = A^{-T} g`` for periodic rows along axis 1: K22 on the
    transposed rows (plain ``cyclic_thomas`` on the CPU)."""
    return cyclic_fields(torch.roll(c, 1, 1).contiguous(), b.contiguous(),
                         torch.roll(a, -1, 1).contiguous(), g.contiguous(),
                         1)


# ---------------------------------------------------------------------------
# the constant-property sweeps: K1 (x, y) and K2 (z)
# ---------------------------------------------------------------------------

def _sweep_kernel(rhs, code, tg, dt, t_inf, axis, *, coeff=None, rob_c=None,
                  qflux=None, dir_val=None):
    """K1 along axis 0 or 1, K2 along the contiguous z (axis 2)."""
    if axis == 2:
        return sweep_z(rhs, code, tg, dt, t_inf, rob_c, coeff=coeff,
                       qflux=qflux, dir_val=dir_val)
    return sweep_strided(rhs, code, tg, dt, t_inf, axis=axis, coeff=coeff,
                         rob_c=rob_c, qflux=qflux, dir_val=dir_val)


def _sweep_bar(x, g, code, cf, tg, dt, t_inf, qflux, axis, want):
    """The pullback shared by the coefficient and plan-lite sweeps:
    ``(y, pin, rhs_bar, coeff_bar, tg_bar, dt_bar, t_inf_bar)`` with ``cf``
    the Robin sink per cell (zero on pinned rows); of the last four, only
    those that ``want`` (four flags) asks for, the others None."""
    dtype = x.dtype
    low = (code & 1) != 0
    high = (code & 2) != 0
    pin = (code & 4) != 0
    lowf, highf = low.to(dtype), high.to(dtype)
    a, c = -tg * lowf, -tg * highf
    b = torch.where(pin, 1.0, 1.0 + tg * (lowf + highf) + dt * cf)
    y = _solve_t(a, b, c, g, axis)
    unp = ~pin
    rhs_bar = torch.where(pin, 0.0, y)
    coeff_bar = tg_bar = dt_bar = t_inf_bar = None
    if want[0]:
        coeff_bar = torch.where(unp, dt * y * (t_inf - x), 0.0)
    if want[1]:
        tg_bar = -torch.where(unp, y * ((lowf + highf) * x
                                        - lowf * _dn(x, axis)
                                        - highf * _up(x, axis)), 0.0).sum()
    if want[2]:
        qf = 0.0 if qflux is None else qflux
        dt_bar = torch.where(unp, y * (qf + cf * (t_inf - x)), 0.0).sum()
    if want[3]:
        t_inf_bar = torch.where(unp, y * dt * cf, 0.0).sum()
    return y, pin, rhs_bar, coeff_bar, tg_bar, dt_bar, t_inf_bar


class _SweepSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, code, coeff, tg, dt, t_inf, qflux, dir_val, axis):
        ctx.scalars = (_f(tg), _f(dt), _f(t_inf))
        x = _sweep_kernel(rhs, code, *ctx.scalars, axis, coeff=coeff,
                          qflux=qflux, dir_val=dir_val)
        ctx.save_for_backward(x, code, coeff, qflux)
        ctx.axis = axis
        ctx.has_q, ctx.has_d = qflux is not None, dir_val is not None
        return x

    @staticmethod
    def backward(ctx, g):
        x, code, coeff, qflux = ctx.saved_tensors
        tg, dt, t_inf = ctx.scalars
        pin = (code & 4) != 0
        coeffp = torch.where(pin, 0.0, coeff)
        need = ctx.needs_input_grad
        y, pin, rhs_bar, coeff_bar, tg_bar, dt_bar, t_inf_bar = _sweep_bar(
            x, g, code, coeffp, tg, dt, t_inf, qflux, ctx.axis, need[2:6])
        return (rhs_bar, None, coeff_bar, tg_bar, dt_bar, t_inf_bar,
                dt * rhs_bar if ctx.has_q and need[6] else None,
                torch.where(pin, y, 0.0) if ctx.has_d and need[7] else None,
                None)


def sweep_solve(rhs, code, coeff, tg, dt, t_inf, qflux=None, dir_val=None,
                *, axis: int = 0):
    """Differentiable masked sweep with a Robin coefficient field (JAX
    ``sweep_solve``): K1 along axis 0 or 1, K2 along the contiguous z
    (``axis=2``, the field plan's natural z), every field and the code in
    the natural layout.  ``tg``, ``dt`` and ``t_inf`` are floats or 0-d
    tensors."""
    if axis not in (0, 1, 2):
        raise ValueError(f"sweep_solve: axis must be 0, 1 or 2, not {axis}")
    return _SweepSolve.apply(rhs, code, coeff, tg, dt, t_inf, qflux,
                             dir_val, axis)


class _SweepSolveLite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, code, rob_c, tg, dt, t_inf, qflux, dir_val, axis):
        ctx.scalars = (_f(rob_c), _f(tg), _f(dt), _f(t_inf))
        x = _sweep_kernel(rhs, code, *ctx.scalars[1:], axis,
                          rob_c=ctx.scalars[0], qflux=qflux, dir_val=dir_val)
        ctx.save_for_backward(x, code, qflux)
        ctx.axis = axis
        ctx.has_q, ctx.has_d = qflux is not None, dir_val is not None
        return x

    @staticmethod
    def backward(ctx, g):
        x, code, qflux = ctx.saved_tensors
        rob_c, tg, dt, t_inf = ctx.scalars
        dtype = x.dtype
        # exposed faces per axis: domain edges count, pinned rows have none
        nfaces = ((2.0 - ((code & 1) != 0).to(dtype)
                   - ((code & 2) != 0).to(dtype))
                  * ((code & 8) != 0).to(dtype))
        need = ctx.needs_input_grad
        y, pin, rhs_bar, coeff_bar, tg_bar, dt_bar, t_inf_bar = _sweep_bar(
            x, g, code, rob_c * nfaces, tg, dt, t_inf, qflux, ctx.axis,
            need[2:6])
        return (rhs_bar, None,
                None if coeff_bar is None else (coeff_bar * nfaces).sum(),
                tg_bar, dt_bar, t_inf_bar,
                dt * rhs_bar if ctx.has_q and need[6] else None,
                torch.where(pin, y, 0.0) if ctx.has_d and need[7] else None,
                None)


def sweep_solve_lite(rhs, code, rob_c, tg, dt, t_inf, qflux=None,
                     dir_val=None, *, axis: int = 0):
    """Differentiable plan-lite sweep (JAX ``sweep_solve_lite``): the
    Robin sink ``rob_c*(2 - low - high)*inmask`` from the code bits, K1
    along axis 0 or 1, K2 along the contiguous z (``axis=2``, natural
    layout, which here also takes ``qflux`` and ``dir_val``).  ``rob_c``,
    ``tg``, ``dt`` and ``t_inf`` are floats or 0-d tensors."""
    if axis not in (0, 1, 2):
        raise ValueError(f"sweep_solve_lite: axis must be 0, 1 or 2, "
                         f"not {axis}")
    return _SweepSolveLite.apply(rhs, code, rob_c, tg, dt, t_inf, qflux,
                                 dir_val, axis)


# ---------------------------------------------------------------------------
# the theta-pass stencil (K3) and the stencil fused into the x sweep (K4)
# ---------------------------------------------------------------------------

def _inv_floats(inv):
    """A scalar or per-axis 1/d^2 (floats or tensors) as K3/K4 take it."""
    if torch.is_tensor(inv):
        return float(inv) if inv.dim() == 0 else tuple(float(v)
                                                      for v in inv)
    return inv if isinstance(inv, (int, float)) else tuple(float(v)
                                                           for v in inv)


def _axis_passes(T, mask_u8, g):
    """``<g, Lhat_ax T>`` for each axis: the unit-Laplacian passes of the
    1/d^2 and c cotangents (three K3 launches on the card)."""
    gi = []
    for ax in range(3):
        unit = tuple(1.0 if i == ax else 0.0 for i in range(3))
        gi.append((g * (theta_rhs(T, mask_u8, 1.0, unit) - T)).sum())
    return torch.stack(gi)


def _inv_bar(needed, inv_is_scalar, gi, c):
    """The 1/d^2 cotangent: a 0-d sum for a scalar 1/d^2, else per axis."""
    if not needed:
        return None
    bar = c * gi
    return bar.sum() if inv_is_scalar else bar


class _ThetaRhsDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, T, mask_u8, c, inv):
        ctx.save_for_backward(T, mask_u8)
        ctx.c, ctx.inv = _f(c), _inv_floats(inv)
        ctx.inv_scalar = torch.is_tensor(inv) and inv.dim() == 0
        return theta_rhs(T, mask_u8, ctx.c, ctx.inv)

    @staticmethod
    def backward(ctx, g):
        T, mask_u8 = ctx.saved_tensors
        c, inv = ctx.c, ctx.inv
        need = ctx.needs_input_grad
        g = g.contiguous()
        # (I + cL)^T = I + cL, L symmetric: pull back with the stencil
        T_bar = theta_rhs(g, mask_u8, c, inv) if need[0] else None
        c_bar = inv_bar = None
        if need[2] or need[3]:
            if isinstance(inv, (int, float)):
                # cubic voxels: one pass, c_bar = <g, L T>, and L scales
                # linearly with 1/d^2
                lapT = theta_rhs(T, mask_u8, 1.0, inv) - T
                c_bar = (g * lapT).sum()
                if need[3]:
                    inv_bar = c_bar * c / inv
            else:
                gi = _axis_passes(T, mask_u8, g)
                c_bar = (torch.tensor(inv, dtype=gi.dtype,
                                      device=gi.device) * gi).sum()
                inv_bar = _inv_bar(need[3], ctx.inv_scalar, gi, c)
        return (T_bar, None, c_bar if need[2] else None, inv_bar)


def theta_rhs_diff(T, mask_u8, c, inv_dx2):
    """Differentiable explicit theta pass ``R0 = T + c*(Lx+Ly+Lz) T`` on
    K3 (JAX ``theta_rhs_diff``).  ``c`` a float or 0-d tensor; ``inv_dx2``
    a scalar or per-axis triple (floats, or a tensor to differentiate)."""
    return _ThetaRhsDiff.apply(T, mask_u8, c, inv_dx2)


class _FusedThetaSolveLite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, T, code, c_exp, inv_d2, rob_c, tg, dt, t_inf):
        ctx.scalars = (_f(c_exp), _inv_floats(inv_d2), _f(rob_c), _f(tg),
                       _f(dt), _f(t_inf))
        x = fused_theta_sweep(T, code, ctx.scalars[0], ctx.scalars[1],
                              ctx.scalars[3], ctx.scalars[4],
                              ctx.scalars[5], ctx.scalars[2])
        ctx.save_for_backward(x, T, code)
        ctx.inv_scalar = torch.is_tensor(inv_d2) and inv_d2.dim() == 0
        return x

    @staticmethod
    def backward(ctx, g):
        x, T, code = ctx.saved_tensors
        c_exp, inv, rob_c, tg, dt, t_inf = ctx.scalars
        dtype = x.dtype
        low = (code & 1) != 0
        high = (code & 2) != 0
        lowf, highf = low.to(dtype), high.to(dtype)
        inm = (code & 8) != 0
        nfaces = (2.0 - lowf - highf) * inm.to(dtype)
        cf = rob_c * nfaces
        a, c = -tg * lowf, -tg * highf
        b = 1.0 + tg * (lowf + highf) + dt * cf
        y = _solve_t(a, b, c, g, 0)                  # A^T y = g
        mask_u8 = inm.to(torch.uint8)
        inv3 = (inv,) * 3 if isinstance(inv, (int, float)) else inv
        need = ctx.needs_input_grad
        # d(T) = (I + c_exp L) T with L the symmetric masked Laplacian
        T_bar = theta_rhs(y, mask_u8, c_exp, inv3) if need[0] else None
        rob_c_bar = tg_bar = dt_bar = t_inf_bar = c_bar = inv_bar = None
        if need[4]:
            rob_c_bar = (dt * y * (t_inf - x) * nfaces).sum()
        if need[5]:
            tg_bar = -(y * ((lowf + highf) * x - lowf * _dn(x, 0)
                            - highf * _up(x, 0))).sum()
        if need[6]:
            dt_bar = (y * cf * (t_inf - x)).sum()
        if need[7]:
            t_inf_bar = (y * dt * cf).sum()
        if need[2] or need[3]:
            # c_exp / inv_d2 cotangents via per-axis unit-Laplacian passes
            gi = _axis_passes(T, mask_u8, y)
            c_bar = (torch.tensor(inv3, dtype=gi.dtype, device=gi.device)
                     * gi).sum()
            inv_bar = _inv_bar(need[3], ctx.inv_scalar, gi, c_exp)
        return (T_bar, None, c_bar if need[2] else None, inv_bar, rob_c_bar,
                tg_bar, dt_bar, t_inf_bar)


def fused_theta_solve_lite(T, code, c_exp, inv_d2, rob_c, tg, dt, t_inf):
    """Differentiable explicit theta pass fused into the plan-lite x sweep
    on K4 (JAX ``fused_theta_solve_lite``): ``x = A^{-1} [(I + c_exp L) T
    + dt*cf*t_inf]``.  Pullback: the transposed solve on K21, then K3 on
    its result for ``T_bar``."""
    return _FusedThetaSolveLite.apply(T, code, c_exp, inv_d2, rob_c, tg, dt,
                                      t_inf)


# ---------------------------------------------------------------------------
# the five-stream cylindrical sweeps: K17 (r, z) and K18 (phi)
#
#   flo_i = fhi_{i-1} (flo_0 = 0),  a = -dw glo flo,  c = -dw ghi fhi,
#   b = 1 + dw (glo flo + ghi fhi + sink),  d = rhs + dw srhs;
#   rhs_bar = y, srhs_bar = y dw, sink_bar = -y dw x,
#   dw_bar = y [glo flo (x_dn - x) + ghi fhi (x_up - x) - sink x + srhs],
#   fhi_bar_i = dw_i ghi_i y_i (x_{i+1} - x_i)
#             + dw_{i+1} glo_{i+1} y_{i+1} (x_i - x_{i+1}).
# The geometry columns are the grid's: no cotangent.
# ---------------------------------------------------------------------------

def _open_stream_bars(x, g, fhi, dw, sink, srhs, glo, ghi, axis):
    """``(y, fhi_bar, dw_bar, sink_bar, srhs_bar)`` of an open stream
    sweep along ``axis``."""
    gl, gh = _col(glo, axis, x.dim()), _col(ghi, axis, x.dim())
    flo = _dn(fhi, axis)
    a = -dw * gl * flo
    c = -dw * gh * fhi
    b = 1.0 + dw * (gl * flo + gh * fhi + sink)
    y = _solve_t(a, b, c, g, axis)
    x_dn, x_up = _dn(x, axis), _up(x, axis)
    dw_bar = y * (gl * flo * (x_dn - x) + gh * fhi * (x_up - x)
                  - sink * x + srhs)
    fhi_bar = (dw * gh * y * (x_up - x)
               + _up(dw * gl, axis) * _up(y, axis) * (x - x_up))
    return y, fhi_bar, dw_bar, -y * dw * x, y * dw


def _cyclic_stream_bars(x, g, flo, fhi, dw, sink, srhs, geo):
    """``(y, flo_bar, fhi_bar, dw_bar, sink_bar, srhs_bar, geo_bar)`` of a
    periodic stream sweep along axis 1 with hi faces ``fhi``."""
    gg = geo[:, None, None]
    a = -dw * gg * flo
    c = -dw * gg * fhi
    b = 1.0 + dw * (gg * (flo + fhi) + sink)
    y = _solve_t_cyclic(a, b, c, g)
    x_dn, x_up = torch.roll(x, 1, 1), torch.roll(x, -1, 1)
    dw_bar = y * (gg * (flo * (x_dn - x) + fhi * (x_up - x))
                  - sink * x + srhs)
    flo_bar = y * dw * gg * (x_dn - x)
    fhi_bar = y * dw * gg * (x_up - x)
    geo_bar = (y * dw * (flo * (x_dn - x) + fhi * (x_up - x))).sum((1, 2))
    return y, flo_bar, fhi_bar, dw_bar, -y * dw * x, y * dw, geo_bar


def _vp_kernel(rhs, fhi, dw, sink, srhs, glo, ghi, axis):
    if axis == 0:
        return vp_fields_sweep_strided(rhs, fhi, dw, sink, srhs, glo, ghi)
    return vp_fields_sweep_z(rhs, fhi, dw, sink, srhs, glo, ghi)


class _VpSweepSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, fhi, dw, sink, srhs, glo, ghi, axis):
        x = _vp_kernel(rhs, fhi, dw, sink, srhs, glo, ghi, axis)
        ctx.save_for_backward(x, fhi, dw, sink, srhs, glo, ghi)
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        x, fhi, dw, sink, srhs, glo, ghi = ctx.saved_tensors
        bars = _open_stream_bars(x, g, fhi, dw, sink, srhs, glo, ghi,
                                 ctx.axis)
        return (*(bar if need else None for bar, need
                  in zip(bars, ctx.needs_input_grad)), None, None, None)


def vp_sweep_solve(rhs, fhi, dw, sink, srhs, glo, ghi, *, axis: int = 0):
    """Differentiable five-stream sweep (JAX ``vp_sweep_solve``): K17
    along axis 0 (r) or its z entry along the last axis (``axis=2``).  The
    JAX wrapper's ``nat_rhs_out`` solves z with the streams on a (z, r,
    phi) transpose; here every stream stays natural.  ``glo``/``ghi``:
    (n,) geometry columns."""
    axis = axis % rhs.dim()
    if axis not in (0, rhs.dim() - 1):
        raise ValueError("vp_sweep_solve solves along the first or the "
                         f"last axis, not {axis}")
    return _VpSweepSolve.apply(rhs, fhi, dw, sink, srhs, glo, ghi, axis)


class _VpCyclicSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, flo, dw, sink, srhs, geo):
        x = vp_fields_cyclic_phi(rhs, flo, dw, sink, srhs, geo)
        ctx.save_for_backward(x, flo, dw, sink, srhs, geo)
        return x

    @staticmethod
    def backward(ctx, g):
        x, flo, dw, sink, srhs, geo = ctx.saved_tensors
        fhi = torch.roll(flo, -1, 1)      # periodic hi faces (bwd only)
        y, flo_bar, fhi_bar, dw_bar, sink_bar, srhs_bar, geo_bar = \
            _cyclic_stream_bars(x, g, flo, fhi, dw, sink, srhs, geo)
        # flo is every hi face too: fold fhi_bar back through the roll
        bars = (y, flo_bar + torch.roll(fhi_bar, 1, 1), dw_bar, sink_bar,
                srhs_bar, geo_bar)
        return tuple(bar if need else None
                     for bar, need in zip(bars, ctx.needs_input_grad))


def vp_cyclic_solve(rhs, flo, dw, sink, srhs, geo):
    """Differentiable periodic five-stream sweep along axis 1 (phi) on K18
    (JAX ``vp_cyclic_solve``), hi faces ``flo[i + 1 mod n]``; ``geo``: the
    (B1,) metric per ring (JAX: an (nr, nz) plane)."""
    return _VpCyclicSolve.apply(rhs, flo, dw, sink, srhs, geo)


# ---------------------------------------------------------------------------
# the tier-2 sweeps: K15 (r), K8's general form (z) and K16 (phi)
# ---------------------------------------------------------------------------

def _inv_dtor(dtor, dtype):
    """``1/dtor`` at the field's precision, as the kernels take it."""
    if torch.is_tensor(dtor):
        return float(1.0 / dtor.to(dtype))
    one = torch.ones((), dtype=dtype)
    return float(one / torch.tensor(dtor, dtype=dtype))


def _vp2_open_streams(T, code, gsl, gsh, dtor, axis, spec):
    """``(fhi, dw, sink, srhs)`` of an open tier-2 sweep along ``axis``
    from T^n: ``vp2_open_streams`` and ``dw = dtor/cp(T)``."""
    k_spec, cp_spec, h_lo, h_hi, tv, eps, e0, e1 = spec
    fhi, sink, srhs = vp2_open_streams(T, code, gsl, gsh, axis,
                                       k_spec=k_spec, h_lo=h_lo, h_hi=h_hi,
                                       tinf=tv, emissivity=eps, edge0=e0,
                                       edge1=e1)
    return fhi, dtor / eval_spec(cp_spec, T), sink, srhs


def _vp2_cyclic_streams(T, code, gs, dtor, spec):
    """``(flo, fhi, dw, sink, srhs)`` of the periodic tier-2 sweep along
    axis 1 from T^n: ``vp2_cyclic_streams`` and ``dw = dtor/cp(T)``."""
    k_spec, cp_spec, h_void, tv, eps = spec
    flo, fhi, sink, srhs = vp2_cyclic_streams(
        T, code, gs, k_spec=k_spec, h_void=h_void, tinf_void=tv,
        emissivity=eps)
    return flo, fhi, dtor / eval_spec(cp_spec, T), sink, srhs


def _pull_streams(build, T, dtor, bars):
    """``(T_bar, dtor_bar)``: the stream cotangents ``bars`` pulled back
    through ``build(T, dtor)`` by autograd (JAX: ``jax.vjp`` of
    ``vp2_streams_xla``)."""
    with torch.enable_grad():
        T_ = T.detach().requires_grad_(True)
        dtor_ = (dtor.detach().requires_grad_(True) if torch.is_tensor(dtor)
                 else dtor)
        outs = build(T_, dtor_)
        live = [(o, b) for o, b in zip(outs, bars)
                if torch.is_tensor(o) and o.requires_grad]
        ins = [T_] + ([dtor_] if torch.is_tensor(dtor_) else [])
        if not live:
            return torch.zeros_like(T), None
        grads = torch.autograd.grad([o for o, _ in live],
                                    ins, [b for _, b in live],
                                    allow_unused=True)
    T_bar = torch.zeros_like(T) if grads[0] is None else grads[0]
    dtor_bar = None
    if len(grads) > 1:
        dtor_bar = (torch.zeros_like(dtor) if grads[1] is None
                    else grads[1])
    return T_bar, dtor_bar


def _vp2_kernel(rhs, T, code, glo, ghi, gsl, gsh, inv_dtor, spec, axis):
    k_spec, cp_spec, h_lo, h_hi, tv, eps, e0, e1 = spec
    if axis == 0:
        return vp2_sweep_strided(rhs, T, code, glo, ghi, gsl, gsh, inv_dtor,
                                 k_spec=k_spec, cp_spec=cp_spec, h_lo=h_lo,
                                 h_hi=h_hi, tinf_void=tv, emissivity=eps,
                                 edge0=e0, edge1=e1)
    return vp2_sweep_z(rhs, T, code, glo, gsl, inv_dtor, k_spec=k_spec,
                       cp_spec=cp_spec, h=h_lo, t_inf=tv, emissivity=eps,
                       ghi=ghi, gsh=gsh, h_hi=h_hi, edge0=e0, edge1=e1)


class _Vp2SweepSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, T, code, glo, ghi, gsl, gsh, dtor, spec, axis):
        x = _vp2_kernel(rhs, T, code, glo, ghi, gsl, gsh,
                        _inv_dtor(dtor, T.dtype), spec, axis)
        ctx.save_for_backward(x, T, code, glo, ghi, gsl, gsh)
        ctx.dtor, ctx.spec, ctx.axis = dtor, spec, axis
        ctx.has_d = rhs is not None
        return x

    @staticmethod
    def backward(ctx, g):
        x, T, code, glo, ghi, gsl, gsh = ctx.saved_tensors
        axis, spec, dtor = ctx.axis, ctx.spec, ctx.dtor
        dtor_d = dtor.detach() if torch.is_tensor(dtor) else dtor
        with torch.no_grad():
            fhi, dw, sink, srhs = _vp2_open_streams(T, code, gsl, gsh,
                                                    dtor_d, axis, spec)
            y, fhi_bar, dw_bar, sink_bar, srhs_bar = _open_stream_bars(
                x, g, fhi, dw, sink, srhs, glo, ghi, axis)
        T_bar, dtor_bar = _pull_streams(
            lambda T_, d_: _vp2_open_streams(T_, code, gsl, gsh, d_, axis,
                                             spec),
            T, dtor, (fhi_bar, dw_bar, sink_bar, srhs_bar))
        if not ctx.has_d:
            T_bar = T_bar + y                  # the rhs IS T
        need = ctx.needs_input_grad
        return (y if ctx.has_d and need[0] else None,
                T_bar if need[1] else None, None, None, None, None, None,
                dtor_bar if need[7] else None, None, None)


def vp2_sweep_solve(rhs, T, code, glo, ghi, gsl, gsh, dtor, *, spec,
                    axis: int = 0):
    """Differentiable tier-2 open sweep (JAX ``vp2_sweep_solve``): K15
    along axis 0 (r) or K8's general form along the last axis
    (``axis=2``; the JAX ``nat_rhs_out`` z solve, natural here).  ``spec``
    = (k_spec, cp_spec, h_lo, h_hi, tinf_void, emissivity, edge0, edge1);
    ``rhs`` None means the rhs is T (the first backward-Euler sweep);
    ``dtor = dt/rho`` a float or a 0-d tensor at T's dtype."""
    axis = axis % T.dim()
    if axis not in (0, T.dim() - 1):
        raise ValueError("vp2_sweep_solve solves along the first or the "
                         f"last axis, not {axis}")
    return _Vp2SweepSolve.apply(rhs, T, code, glo, ghi, gsl, gsh, dtor,
                                tuple(spec), axis)


class _Vp2CyclicSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rhs, T, code, geo, gs, dtor, spec):
        k_spec, cp_spec, h_void, tv, eps = spec
        x = vp2_cyclic_phi(rhs, T, code, geo, gs, _inv_dtor(dtor, T.dtype),
                           k_spec=k_spec, cp_spec=cp_spec, h_void=h_void,
                           tinf_void=tv, emissivity=eps)
        ctx.save_for_backward(x, T, code, geo, gs)
        ctx.dtor, ctx.spec = dtor, spec
        return x

    @staticmethod
    def backward(ctx, g):
        x, T, code, geo, gs = ctx.saved_tensors
        spec, dtor = ctx.spec, ctx.dtor
        dtor_d = dtor.detach() if torch.is_tensor(dtor) else dtor
        with torch.no_grad():
            flo, fhi, dw, sink, srhs = _vp2_cyclic_streams(T, code, gs,
                                                           dtor_d, spec)
            y, flo_bar, fhi_bar, dw_bar, sink_bar, srhs_bar, _ = \
                _cyclic_stream_bars(x, g, flo, fhi, dw, sink, srhs, geo)
        T_bar, dtor_bar = _pull_streams(
            lambda T_, d_: _vp2_cyclic_streams(T_, code, gs, d_, spec), T,
            dtor, (flo_bar, fhi_bar, dw_bar, sink_bar, srhs_bar))
        need = ctx.needs_input_grad
        return (y if need[0] else None, T_bar if need[1] else None, None,
                None, None, dtor_bar if need[5] else None, None)


def vp2_cyclic_solve(rhs, T, code, geo, gs, dtor, *, spec):
    """Differentiable tier-2 periodic sweep along axis 1 (phi) on K16 (JAX
    ``vp2_cyclic_solve``).  ``spec`` = (k_spec, cp_spec, h_void,
    tinf_void, emissivity); ``geo``/``gs``: (B1,) per ring."""
    return _Vp2CyclicSolve.apply(rhs, T, code, geo, gs, dtor, tuple(spec))
