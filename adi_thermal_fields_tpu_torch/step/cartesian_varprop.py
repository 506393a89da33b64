"""Cartesian ADI step with temperature-dependent material properties.

Counterpart: ``adi_thermal_fields_tpu/step/cartesian_varprop.py`` —
``PropertyTable`` (:97), ``apparent_cp`` (:134), ``melt_pool_enhanced_k``
(:155), ``_face_g`` (:199), ``adi_step_varprop`` (:209),
``build_varprop_codes`` (:299) and ``adi_step_varprop_fused`` (:523).

Conductivity k(T) and volumetric heat capacity rho*cp(T) are lookup
tables evaluated at T^n (Picard linearization).  Finite-volume flux form
with the harmonic face conductivity ``2 k_i k_j / (k_i + k_j)`` between
in-mask neighbours; latent heat enters through an apparent heat capacity
over the mushy interval (``apparent_cp``).  Per axis the implicit sweeps
solve

    (1 + theta*(g_lo + g_hi) + dt*C_ax) u_i
        - theta*g_lo u_{i-1} - theta*g_hi u_{i+1}
        = rhs_i + dt*q_ax + dt*C_ax*T_inf,
    g_lo/hi = dt * k_face_lo/hi / (rho cp_i dx^2),

and BC packs built against a reference material are rescaled by
``cp_ref/cp(T)``.

Two steps: ``adi_step_varprop`` is the plain reference (the JAX "xla"
branch, ``thomas`` along each axis).  ``adi_step_varprop_fused`` is the
kernel path, K5 (fields) -> K6 (theta pass + x sweep) -> K7 (y sweep) ->
K8 (tier-2 z sweep), the route the JAX step takes under its module
defaults for a float32 single-device run with scalar ``robin_h``,
PropertyTable k/cp and an optional emissivity.  Unlike the JAX step, which
sends float64 z through its stream-reading sweep because its vp2 kernel
takes float32 only, the port runs K8 for float32 and float64 alike; the
two z solves differ only by row scaling (round-off level at float64).
"""
from __future__ import annotations

import dataclasses

import torch

from ..bc.faces import shift_in
from ..bc.packs import CoeffPacks
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..solvers.sweeps import sweep_code
from ..solvers.thomas import thomas
from ..solvers.varprop import (clamp_sum, face_g, table_segments,
                               varprop_fields, varprop_sweep_y,
                               varprop_theta_sweep)
from ..solvers.vp2 import build_vp2_code, vp2_sweep_z
from .cartesian import state_numpy_dtype

__all__ = ["PropertyTable", "apparent_cp", "melt_pool_enhanced_k",
           "adi_step_varprop", "adi_step_varprop_fused",
           "build_varprop_codes", "check_films"]


@dataclasses.dataclass(frozen=True)
class PropertyTable:
    """Piecewise-linear property vs temperature, clamped at the table ends.
    ``points``/``values`` are 1-D and strictly increasing in ``points``
    (a duplicated point makes a value step).

    Evaluated as the clamp-sum ``v0 + sum_i s_i * clamp(T - p_i, 0,
    dp_i)`` (slopes in float64 on the host, segments with no value change
    skipped) at ``promote(T.dtype, float32)``, the JAX evaluation; the
    kernels K5 and K8 take the same segments (solvers/varprop.py)."""

    points: tuple
    values: tuple

    def __call__(self, T: torch.Tensor) -> torch.Tensor:
        cdt = torch.promote_types(T.dtype, torch.float32)
        return clamp_sum(T.to(cdt), *table_segments(self)).to(T.dtype)


def apparent_cp(cp_solid: float, cp_liquid: float, latent_heat: float,
                T_solidus: float, T_liquidus: float,
                n_mushy: int = 8) -> PropertyTable:
    """Apparent-heat-capacity table for phase change on a fixed grid:
    cp(T) carries a plateau ``L / (T_liq - T_sol)`` over the mushy interval
    so that the enthalpy integral includes the latent heat L [J/kg]."""
    dTm = T_liquidus - T_solidus
    if dTm <= 0:
        raise ValueError("T_liquidus must exceed T_solidus")
    cp_mushy = 0.5 * (cp_solid + cp_liquid) + latent_heat / dTm
    eps = 1e-9 * max(1.0, dTm)
    pts = [T_solidus - eps, T_solidus]
    vals = [cp_solid, cp_mushy]
    for i in range(1, n_mushy):
        pts.append(T_solidus + dTm * i / n_mushy)
        vals.append(cp_mushy)
    pts += [T_liquidus, T_liquidus + eps]
    vals += [cp_mushy, cp_liquid]
    return PropertyTable(tuple(pts), tuple(vals))


def melt_pool_enhanced_k(k_solid: float, T_solidus: float, T_liquidus: float,
                         enhancement: float = 4.0,
                         k_liquid: float | None = None) -> PropertyTable:
    """Melt-pool convection proxy: an effective-conductivity table ramping
    from ``k_solid`` at the solidus to ``enhancement * k_liquid`` (default
    ``k_solid``) at the liquidus and above."""
    if T_liquidus <= T_solidus:
        raise ValueError("T_liquidus must exceed T_solidus")
    kl = k_solid if k_liquid is None else k_liquid
    return PropertyTable((T_solidus, T_liquidus),
                         (k_solid, kl * enhancement))


def check_films(robin_h, emissivity, **films) -> None:
    """Refuse negative films on the variable-property path: the tier-2
    sweeps (K8, K15, K16) scale a row only where its couplings and films
    sum to more than zero, which is right for films >= 0 only.  ``films``:
    further named films (the cylindrical step's h_void, h_front, Robin and
    z-face h); None skips one."""
    if robin_h is not None and float(robin_h) < 0.0:
        raise ValueError(f"robin_h must be >= 0 on the variable-property "
                         f"path, got {robin_h}")
    for name, h in films.items():
        if h is not None and float(h) < 0.0:
            raise ValueError(f"{name} must be >= 0 on the variable-property "
                             f"path, got {h}")
    if emissivity is not None and float(emissivity) < 0.0:
        raise ValueError(f"emissivity must be >= 0, got {emissivity}")


def _full(T, value):
    return torch.full_like(T, float(value))


def adi_step_varprop(T: torch.Tensor, mask: torch.Tensor, packs: CoeffPacks,
                     grid: CartesianGrid, mat_ref: Material, *,
                     k_table=None, cp_table=None, dt: float,
                     theta: float = 0.5, t_inf: float = 0.0,
                     source: torch.Tensor | None = None) -> torch.Tensor:
    """One theta-scheme ADI step with T-dependent k and/or cp: the plain
    reference.  ``mat_ref``: the material whose rho and cp built ``packs``;
    ``k_table``: a table, a number, a callable or a per-axis 3-tuple of
    them; ``cp_table``: a table, a callable or None.  ``dt`` is rounded to
    the state dtype."""
    mask = mask.to(torch.bool)
    dt = float(state_numpy_dtype(T.dtype)(dt))
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]

    def k_of(tab):
        if tab is None:
            return _full(T, mat_ref.k)
        if callable(tab):
            return tab(T)
        return _full(T, tab)

    if isinstance(k_table, (tuple, list)):
        kfs = tuple(k_of(tab) for tab in k_table)
    else:
        kfs = (k_of(k_table),) * 3
    cpf = cp_table(T) if cp_table is not None else _full(T, mat_ref.cp)
    inv_rc = 1.0 / (mat_ref.rho * cpf)
    bc_scale = mat_ref.cp / cpf

    g = {(ax, d): dt * face_g(kfs[ax], ax, d, mask) * inv_rc * inv_d2[ax]
         for ax in range(3) for d in (-1, +1)}
    lap = torch.zeros_like(T)
    for ax in range(3):
        for d in (-1, +1):
            lap = lap + g[(ax, d)] * (shift_in(T, ax, d, fill=0.0) - T)
    R0 = T + (1.0 - theta) * torch.where(mask, lap, 0.0)
    if source is not None:
        R0 = R0 + torch.where(mask, dt * source * inv_rc, 0.0)

    def sweep(rhs, axis):
        g_lo, g_hi = g[(axis, -1)], g[(axis, +1)]
        coeff_ax = packs.coeff[axis] * bc_scale
        qflux_ax = packs.qflux[axis] * bc_scale
        a = -theta * g_lo
        c = -theta * g_hi
        b = 1.0 + theta * (g_lo + g_hi) + dt * coeff_ax
        d = rhs + dt * qflux_ax + dt * coeff_ax * t_inf
        b = torch.where(mask, b, 1.0)
        d = torch.where(mask, d, rhs)
        pin = packs.dir_mask & mask
        a = torch.where(pin, 0.0, a)
        c = torch.where(pin, 0.0, c)
        b = torch.where(pin, 1.0, b)
        d = torch.where(pin, packs.dir_val, d)
        mv = (lambda t: t.movedim(axis, 0))
        return thomas(mv(a), mv(b), mv(c), mv(d)).movedim(0, axis) \
            .contiguous()

    return sweep(sweep(sweep(R0, 0), 1), 2)


def build_varprop_codes(mask: torch.Tensor) -> tuple:
    """The kernel path's per-axis codes, all in the natural (x, y, z)
    layout: the x and y sweep codes (``sweep_code``, bits 1/2/8) for K6
    and K7, and the vp2 z code ``build_vp2_code(mask, 2,
    edge_exposed=True)`` for K8.  The JAX function's third code is the z
    sweep code in (z, x, y) for its stream-reading z sweep, and its step
    builds the vp2 code on every call; here the vp2 code is built with the
    others.  Mask-dependent only: rebuild on birth events."""
    mask = mask.to(torch.bool)
    return (sweep_code(mask, None, 0),
            sweep_code(mask, None, 1).movedim(0, 1).contiguous(),
            build_vp2_code(mask, 2, edge_exposed=True))


def _kernel_spec(tab, default: float, name: str):
    """A property as the kernels take it: a number or a table."""
    if tab is None:
        return float(default)
    if isinstance(tab, (int, float)):
        return float(tab)
    if isinstance(tab, PropertyTable):
        return tab
    raise NotImplementedError(
        f"{name}: per-axis k tuples and callables need the XLA fields "
        "build and the stream-reading z sweep (TPU kernel row 17, "
        "pallas_varprop.fused_varprop_sweep), not ported yet; pass a "
        "PropertyTable or a number")


def adi_step_varprop_fused(T: torch.Tensor, mask: torch.Tensor, codes: tuple,
                           grid: CartesianGrid, mat_ref: Material, *,
                           k_table=None, cp_table=None, dt: float,
                           theta: float = 0.5, t_inf: float = 0.0,
                           robin_h: float = 0.0,
                           h_field: torch.Tensor | None = None,
                           h_axes: tuple | None = None,
                           emissivity: float | None = None,
                           h_conv: float | None = 0.0,
                           source: torch.Tensor | None = None,
                           fuse_theta: bool | None = None,
                           gstreams: bool | None = None) -> torch.Tensor:
    """One varprop theta-scheme step on K5 -> K6 -> K7 -> K8.

    Same physics as ``adi_step_varprop`` for Robin on every exposed face:
    the scalar ``robin_h``, or with ``emissivity`` the Picard radiative
    film ``h_rad(T) + h_conv`` (``robin_h`` is then not used).  No Neumann
    flux, no Dirichlet pins.  ``mask``: bool or uint8 (uint8 is what K5
    reads; the engine converts it once per birth event).  ``codes`` from
    ``build_varprop_codes(mask)``;
    ``k_table``/``cp_table``: PropertyTable, number or None (``mat_ref``'s
    value).  ``dt`` is rounded to the state dtype (float32 or float64).

    Not ported yet, and refused with the missing TPU kernel named:
    ``h_field`` and ``h_axes`` (row 17, the stream-reading sweep),
    ``fuse_theta=False`` (rows 19 and 17), ``gstreams=True`` and bfloat16
    states (rows 27-30, the g-stream tier with stochastic rounding)."""
    if h_axes is not None or h_field is not None:
        raise NotImplementedError(
            "per-face or per-cell film streams (h_axes / h_field, the "
            "corrected-BC route) need the stream-reading varprop sweep, TPU "
            "kernel row 17 (pallas_varprop.fused_varprop_sweep), not ported "
            "yet")
    if fuse_theta is False:
        raise NotImplementedError(
            "fuse_theta=False needs TPU kernel rows 19 "
            "(pallas_varprop.varprop_theta_rhs) and 17 "
            "(fused_varprop_sweep), not ported yet")
    if gstreams:
        raise NotImplementedError(
            "the g-stream tier needs TPU kernel rows 27-30 "
            "(pallas_gstreams.py), not ported yet")
    if T.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"state dtype {T.dtype}: bfloat16 varprop states run the "
            "g-stream tier with stochastic rounding, TPU kernel rows 27-30 "
            "(pallas_gstreams.py), not ported yet")
    check_films(robin_h, emissivity)
    k_spec = _kernel_spec(k_table, mat_ref.k, "k_table")
    cp_spec = _kernel_spec(cp_table, mat_ref.cp, "cp_table")
    self_rad = emissivity is not None
    h_conv = float(h_conv or 0.0)
    if self_rad:
        check_films(h_conv, None)

    # scalars at the state dtype, in the JAX step's op order
    f = state_numpy_dtype(T.dtype)
    dt_s = f(dt)
    dz = grid.spacing[2]
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]
    cw = float(f(1.0 - theta) * dt_s)
    tg = [float(f(theta) * dt_s * f(iv)) for iv in inv_d2]
    sk = [float(dt_s / f(d)) for d in grid.spacing]
    inv_dtor = float(f(1.0) / (dt_s / f(mat_ref.rho)))

    mask_u8 = mask.to(torch.uint8)
    if self_rad:
        fc, w, hf = varprop_fields(
            T, mask_u8, k_spec=k_spec, cp_spec=cp_spec, rho=mat_ref.rho,
            rad=(float(emissivity), float(t_inf), h_conv))
        rob = 0.0
    else:
        fc, w = varprop_fields(T, mask_u8, k_spec=k_spec, cp_spec=cp_spec,
                               rho=mat_ref.rho)
        hf, rob = None, float(robin_h)
    U = varprop_theta_sweep(T, codes[0], fc[0], fc[1], fc[2], w, cw, inv_d2,
                            tg[0], sk[0], t_inf, h=hf, rob_c=rob, src=source,
                            dt=float(dt_s))
    V = varprop_sweep_y(U, codes[1], fc[1], w, tg[1], sk[1], t_inf, h=hf,
                        rob_c=rob)
    # K8 reads V only as the rhs; k, cp and the films come from T^n
    return vp2_sweep_z(V, T, codes[2], float(f(theta * inv_d2[2])),
                       float(f(1.0 / dz)), inv_dtor, k_spec=k_spec,
                       cp_spec=cp_spec,
                       h=h_conv if self_rad else float(robin_h),
                       t_inf=float(t_inf),
                       emissivity=float(emissivity) if self_rad else 0.0)
