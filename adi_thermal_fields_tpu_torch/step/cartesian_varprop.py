"""Cartesian ADI step with temperature-dependent material properties.

Counterpart: ``adi_thermal_fields_tpu/step/cartesian_varprop.py`` —
``PropertyTable`` (:97), ``apparent_cp`` (:134), ``melt_pool_enhanced_k``
(:155), ``_face_g`` (:199), ``adi_step_varprop`` (:209),
``build_varprop_codes`` (:299), ``build_face_h_axes`` (:312),
``build_varprop_fields`` (:385) and ``adi_step_varprop_fused`` (:523).

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

Two steps.  ``adi_step_varprop`` materializes a/b/c/d from the packs (any
BC: Robin, Neumann, Dirichlet): ``implementation="reference"`` solves them
with ``thomas`` (the JAX "xla" branch), ``"kernels"`` with K21 in the
natural layout (the JAX "pallas" branch, ``fused_tridiag_fields``).
``adi_step_varprop_fused`` is the Robin-only kernel path: K5 (fields) ->
K6 (theta pass + x sweep) -> K7 (y sweep; with ``VP2_Y_DEFAULT`` K15's
tier-2 y entry) -> K8 (tier-2 z sweep) for a float32 state with a scalar
or self-radiative film, and the JAX step's
other routes: K19 along z for float64 states, film fields and per-face
streams, K20 then K7's x entry with ``fuse_theta=False``.  Float64 z runs
K19 as in JAX, whose tier-2 z kernel takes float32 states only.
``adi_step_varprop_gstreams`` (JAX :450) is the g-stream tier, K23 ->
K24 -> K25 -> K26, which ``adi_step_varprop_fused`` takes for bfloat16
states (float32 with ``gstreams=True``), stochastic rounding included;
the bfloat16 states it does not take (per-face streams, per-axis k
tuples, callables, theta <= 0, ``gstreams=False``) run the classic tier's
bfloat16 entries (K5b, K6b or K20b -> K7xb, K7b, K19b), as in JAX.
"""
from __future__ import annotations

import dataclasses

import torch

from ..bc.faces import exposed_face, shift_in
from ..bc.packs import CoeffPacks, _normalize_per_face
from ..bc.radiation import radiative_h
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..solvers.fields import tridiag_fields
from ..solvers.gstreams import (gstream_fields, gstream_sweep_y,
                                gstream_sweep_z, gstream_theta_sweep)
from ..solvers.sweeps import sweep_code
from ..solvers.thomas import thomas
from ..solvers.varprop import (clamp_sum, face_g, table_segments,
                               varprop_fields, varprop_sweep_x,
                               varprop_sweep_y, varprop_sweep_z,
                               varprop_theta_rhs, varprop_theta_sweep)
from ..solvers.vp2 import build_vp2_code, vp2_sweep_y, vp2_sweep_z
from .cartesian import solve_dtype, solve_numpy_dtype

__all__ = ["PropertyTable", "apparent_cp", "melt_pool_enhanced_k",
           "adi_step_varprop", "adi_step_varprop_fused",
           "adi_step_varprop_gstreams", "build_varprop_codes",
           "build_face_h_axes", "build_varprop_fields", "check_films",
           "IMPLEMENTATIONS", "G_STREAMS_DEFAULT", "G_STREAMS_BF16_DEFAULT",
           "VP2_Y_DEFAULT"]

IMPLEMENTATIONS = ("kernels", "reference")

# adi_step_varprop_fused(gstreams=None) routes an eligible step through the
# g-stream tier (K23-K26) at bfloat16 only, as the JAX module's flags
# (:55-69): its TPU A/B lost at float32 and won at bfloat16.  The H100 A/B
# is in PERF.md; the defaults stay the JAX ones.
G_STREAMS_DEFAULT = False          # float32 states: the classic tier
G_STREAMS_BF16_DEFAULT = True      # bfloat16 states: the g-stream tier

# The tier-2 (vp2) y solve of the classic tier, as the JAX module's flag
# (:86): K15's y entry derives the face conductivities, 1/(rho cp) and the
# films in registers from T^n and a 1-byte code instead of reading the
# fields pass's fc/w/h streams, 13 B/cell (rhs, T, code, x) against K7's
# 21.  The JAX package keeps it off (y on K7) on a TPU A/B; the H100 A/B is
# in PERF.md, and the default stays the JAX one.  The tier-2 z solve (K8)
# runs under the same gate without a switch.
VP2_Y_DEFAULT = False


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


def _prop(T, tab, const):
    """A property (None: ``const``, a number or a callable) at ``T``."""
    if tab is None:
        return torch.full_like(T, float(const))
    if callable(tab):
        return tab(T)
    return torch.full_like(T, float(tab))


def _axis_k(T, mat_ref, k_table) -> tuple:
    """(k_x, k_y, k_z) at ``T``; ``k_table`` may be a per-axis 3-tuple."""
    if isinstance(k_table, (tuple, list)):
        return tuple(_prop(T, tab, mat_ref.k) for tab in k_table)
    return (_prop(T, k_table, mat_ref.k),) * 3


def adi_step_varprop(T: torch.Tensor, mask: torch.Tensor, packs: CoeffPacks,
                     grid: CartesianGrid, mat_ref: Material, *,
                     k_table=None, cp_table=None, dt,
                     theta: float = 0.5, t_inf: float = 0.0,
                     source: torch.Tensor | None = None,
                     implementation: str = "reference") -> torch.Tensor:
    """One theta-scheme ADI step with T-dependent k and/or cp from
    materialized a/b/c/d.  ``mat_ref``: the material whose rho and cp
    built ``packs``; ``k_table``: a table, a number, a callable or a
    per-axis 3-tuple of them; ``cp_table``: a table, a callable or None.
    Dirichlet rows are pinned (a = c = 0, b = 1, d = the pin).
    ``implementation``: "reference" solves each axis with ``thomas``,
    "kernels" with K21 in the natural layout.  ``dt`` (a Python float, or
    a 0-d tensor for the reference implementation's autograd) is rounded
    to the solve dtype; callable tables may close over tensors that
    require grad (the inverse apps' fitted k and cp)."""
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {IMPLEMENTATIONS}, "
                         f"got {implementation!r}")
    mask = mask.to(torch.bool)
    dt = (dt.to(solve_dtype(T.dtype)) if torch.is_tensor(dt)
          else float(solve_numpy_dtype(T.dtype)(dt)))
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]
    kfs = _axis_k(T, mat_ref, k_table)
    cpf = _prop(T, cp_table, mat_ref.cp)
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
        if implementation == "kernels":
            return tridiag_fields(a, b, c, d, axis)
        mv = (lambda t: t.movedim(axis, 0))
        return thomas(mv(a), mv(b), mv(c), mv(d)).movedim(0, axis) \
            .contiguous()

    return sweep(sweep(sweep(R0, 0), 1), 2)


def build_varprop_codes(mask: torch.Tensor) -> tuple:
    """The kernel path's per-axis codes, all in the natural (x, y, z)
    layout: the x and y sweep codes (``sweep_code``, bits 1/2/8) for K6 or
    K7's x entry and K7, the vp2 z code ``build_vp2_code(mask, 2,
    edge_exposed=True)`` for K8, the z sweep code for K19, and the vp2 y
    code ``build_vp2_code(mask, 1, edge_exposed=True)`` for K15's y entry,
    built only while ``VP2_Y_DEFAULT`` is on (else None: the step then
    builds it on each call that takes K15's y entry).  The JAX function
    returns three codes, its z sweep code in (z, x, y), and its step builds
    the vp2 codes on every call.  Mask-dependent only: rebuild on birth
    events."""
    mask = mask.to(torch.bool)
    return (sweep_code(mask, None, 0),
            sweep_code(mask, None, 1).movedim(0, 1).contiguous(),
            build_vp2_code(mask, 2, edge_exposed=True),
            sweep_code(mask, None, 2).movedim(0, 2).contiguous(),
            build_vp2_code(mask, 1, edge_exposed=True) if VP2_Y_DEFAULT
            else None)


def build_face_h_axes(mask: torch.Tensor, robin_h, radiation_scale=None, *,
                      dtype: torch.dtype) -> tuple:
    """Per-axis film streams carrying per-face convective h (scalars or
    fields) and per-face radiative area scales through the stream-reading
    sweeps, whose sink is ``sk*h*n`` with ``n = e_lo + e_hi`` the cell's
    exposed faces along the axis (JAX :312-366).

    ``A = (e_lo*h_lo + e_hi*h_hi)/max(n, 1)``: the kernels' ``A*n``
    rebuilds the face sum exactly (a division by 1 or 2).  ``B`` is the
    same fold of the scales (a face without one counts 1), so the film of
    a sweep is ``A + h_rad(T)*B`` with ``h_rad`` pure radiation.  Returns
    ``((Ax, Bx), (Ay, By), (Az, Bz))`` at ``dtype`` on ``mask``'s device,
    ``B`` None without ``radiation_scale``.  Unlike the JAX function,
    which moves the z pair to its (z, x, y) layout, every stream stays in
    the natural layout that K19 reads.  Rebuild on birth events."""
    mask = mask.to(torch.bool)
    dev = mask.device
    h_pf = _normalize_per_face(robin_h)
    s_pf = (None if radiation_scale is None
            else _normalize_per_face(radiation_scale))

    def as_t(v):
        return torch.as_tensor(0.0 if v is None else v, dtype=dtype,
                               device=dev)

    out = []
    for flo, fhi in (("x-", "x+"), ("y-", "y+"), ("z-", "z+")):
        e_lo = exposed_face(mask, flo).to(dtype)
        e_hi = exposed_face(mask, fhi).to(dtype)
        inv_n = 1.0 / torch.clamp(e_lo + e_hi, min=1.0)

        def fold(pf):
            return (e_lo * as_t(pf[flo]) + e_hi * as_t(pf[fhi])) * inv_n

        A = fold(h_pf)
        B = (None if s_pf is None else
             fold({f: 1.0 if s_pf[f] is None else s_pf[f]
                   for f in (flo, fhi)}))
        out.append((A, B))
    return tuple(out)


def _kernel_spec(tab, default: float):
    """A property as the kernels K5 and K8 take it, a number or a table;
    None for a callable."""
    if tab is None:
        return float(default)
    if isinstance(tab, (int, float)):
        return float(tab)
    if isinstance(tab, PropertyTable):
        return tab
    if callable(tab):
        return None
    raise TypeError(f"a property must be a number, a PropertyTable or a "
                    f"callable, got {type(tab).__name__}")


def build_varprop_fields(T: torch.Tensor, mask: torch.Tensor,
                         mat_ref: Material, k_table=None, cp_table=None, *,
                         rad: tuple | None = None):
    """Per-axis pre-masked harmonic face conductivities ``(fx, fy, fz)``,
    ``w = 1/(rho cp)`` and, with ``rad = (emissivity, t_inf, h_conv)``,
    the Picard radiative film, natural layout, T's dtype (JAX :385-447).
    K5 when both properties are numbers or tables; per-axis k tuples and
    callables build them with tensor ops (``face_g`` per axis) at T's
    dtype, as JAX does: at bfloat16 a number k is a bfloat16 field, a
    PropertyTable is evaluated at float32 and rounded, and every operation
    rounds to bfloat16."""
    ks = (None if isinstance(k_table, (tuple, list))
          else _kernel_spec(k_table, mat_ref.k))
    cs = _kernel_spec(cp_table, mat_ref.cp)
    if ks is not None and cs is not None:
        return varprop_fields(T, mask.to(torch.uint8), k_spec=ks,
                              cp_spec=cs, rho=mat_ref.rho, rad=rad)
    mask = mask.to(torch.bool)
    kfs = _axis_k(T, mat_ref, k_table)
    fc = tuple(face_g(kfs[ax], ax, -1, mask).to(T.dtype) for ax in range(3))
    # rho at T's dtype: JAX rounds the weakly typed scalar to a bfloat16
    # array's dtype (7800 -> 7808)
    rho = torch.tensor(float(mat_ref.rho), dtype=T.dtype)
    w = (1.0 / (rho * _prop(T, cp_table, mat_ref.cp))).to(T.dtype)
    if rad is None:
        return fc, w
    eps, tinf, hconv = rad
    return fc, w, radiative_h(T, eps, tinf, h_conv=hconv)


def _gstream_spec(tab, default: float):
    """A property as the g-stream tier takes it (a number or a table), or
    None: per-axis tuples and callables run the classic tier."""
    if isinstance(tab, (tuple, list)):
        return None
    return _kernel_spec(tab, default)


def adi_step_varprop_gstreams(T: torch.Tensor, mask: torch.Tensor,
                              grid: CartesianGrid, mat_ref: Material, *,
                              k_table=None, cp_table=None, dt: float,
                              theta: float = 0.5, t_inf: float = 0.0,
                              robin_h: float = 0.0,
                              h_field: torch.Tensor | None = None,
                              emissivity: float | None = None,
                              h_conv: float | None = 0.0,
                              source: torch.Tensor | None = None,
                              rng_seed: int | None = None) -> torch.Tensor:
    """One varprop theta-scheme step through the g-stream tier (JAX
    :450-520): K23 builds the pre-multiplied coupling and sink streams
    (the film a scalar ``robin_h``, a per-cell ``h_field``, or with
    ``emissivity`` the radiative film ``h_rad(T) + h_conv`` in registers),
    then K24 (theta pass + x), K25 (y) and K26 (z, natural layout: the JAX
    step's four transposes are gone).  Same physics as
    ``adi_step_varprop_fused`` for Robin-only boundaries.

    float32 and bfloat16 states; a bfloat16 state solves at float32 and
    stores its streams at bfloat16 (to nearest) and U, V and W stochastically
    with ``rng_seed`` (offsets 1-3), else to nearest.  ``h_field`` and
    ``source`` are read at the state dtype (JAX reads them at theirs).
    Raises for ``theta <= 0``, per-axis k tuples and callables, and other
    dtypes, as JAX does."""
    if not theta > 0.0:
        raise ValueError("the g-stream tier needs theta > 0 (the streams "
                         "carry theta*dt*w*fc; use theta in {0.5, 1})")
    ks = _gstream_spec(k_table, mat_ref.k)
    cs = _gstream_spec(cp_table, mat_ref.cp)
    if ks is None or cs is None:
        raise ValueError("g-stream tier needs constant or PropertyTable "
                         "k/cp (per-axis tuples and callables run the "
                         "classic fused tier)")
    if T.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g-stream tier is f32/bf16 only, got {T.dtype}")
    f = solve_numpy_dtype(T.dtype)
    dt_s = f(dt)
    tg3 = [float(f(theta) * dt_s * f(1.0 / (d * d))) for d in grid.spacing]
    sk3 = [float(dt_s / f(d)) for d in grid.spacing]
    if emissivity is not None:
        h_mode, hpar = "rad", float(emissivity)
    elif h_field is not None:
        h_mode, hpar = "stream", 0.0
    else:
        h_mode, hpar = "const", float(robin_h or 0.0)
    as_state = (lambda t: None if t is None else t.to(T.dtype))
    mask_u8 = mask if mask.dtype == torch.uint8 else mask.to(torch.uint8)
    g_lo, g_hi, sw, src_pre = gstream_fields(
        T, mask_u8, tg3, sk3, k_spec=ks, cp_spec=cs, rho=mat_ref.rho,
        h_mode=h_mode, hpar=hpar, t_inf=float(t_inf),
        h_conv=float(h_conv or 0.0), dt=float(dt_s),
        h=as_state(h_field) if h_mode == "stream" else None,
        src=as_state(source))
    sr = dict(rng_seed=rng_seed if T.dtype == torch.bfloat16 else None)
    U = gstream_theta_sweep(T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2],
                            g_hi[2], sw[0], (1.0 - theta) / theta, t_inf,
                            src_pre=src_pre, rng_offset=1, **sr)
    V = gstream_sweep_y(U, g_lo[1], g_hi[1], sw[1], t_inf, rng_offset=2,
                        **sr)
    return gstream_sweep_z(V, g_lo[2], g_hi[2], sw[2], t_inf, rng_offset=3,
                           **sr)


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
                           gstreams: bool | None = None,
                           rng_seed: int | None = None) -> torch.Tensor:
    """One varprop theta-scheme step on the kernels, route for route as
    the JAX step (:563-776).

    Same physics as ``adi_step_varprop`` for Robin on every exposed face
    (no Neumann flux, no Dirichlet pins), the film one of: the scalar
    ``robin_h``; with ``emissivity`` the Picard radiative film ``h_rad(T)
    + h_conv`` (``robin_h`` then unused); a per-cell ``h_field``; or the
    per-axis streams ``h_axes`` of ``build_face_h_axes`` (mutually
    exclusive with ``h_field``), whose film is ``A + h_rad(T)*B`` with
    ``emissivity`` (``h_conv`` ignored: convection lives in A).  ``mask``:
    bool or uint8 (K5 and K20 read uint8; the engine converts it once per
    birth event).  ``codes`` from ``build_varprop_codes(mask)``;
    ``k_table``: a PropertyTable, number, callable or per-axis 3-tuple of
    them; ``cp_table``: a PropertyTable, number or callable (None:
    ``mat_ref``'s value).  ``dt`` is rounded to the solve dtype.

    Route: ``gstreams`` (None: ``G_STREAMS_DEFAULT``, or
    ``G_STREAMS_BF16_DEFAULT`` for a bfloat16 state) sends a float32 or
    bfloat16 step with theta > 0, no ``h_axes`` and number or table
    properties to ``adi_step_varprop_gstreams`` (K23-K26; ``rng_seed``
    seeds its stochastic bfloat16 stores), as the JAX step routes (:569-582).
    Otherwise the classic tier: the fields (K5 for numbers and tables,
    tensor ops for per-axis tuples and callables); x by K6 (``fuse_theta``
    True or None) or by K20 then K7's x entry (``fuse_theta=False``); y by
    K7, or with ``VP2_Y_DEFAULT`` by K15's y entry under the tier-2 gate;
    z by K8 under the tier-2 gate, else by K19.  The
    tier-2 gate is the JAX step's (:651-656): a float32 state, a table or
    number cp and conductivity along the axis, a scalar or self-radiative
    film (no ``h_field``, no ``h_axes``); float64 states, film fields and
    streams and callables take K7 and K19.  The classic tier takes
    float32, float64 and bfloat16 states.  A bfloat16 state that the
    g-stream tier does not take (``h_axes``, per-axis k tuples, callables,
    theta <= 0, ``gstreams=False``) runs the classic tier's bfloat16
    entries K5b, K6b (or K20b then K7xb), K7b and K19b: fields and rows at
    float32 from the bfloat16 streams, every store at bfloat16, rounded
    stochastically with ``rng_seed`` at the JAX offsets (R0 0, x 1, y 2,
    z 3; to nearest without a seed; K5b's fields always to nearest).  JAX
    rebuilds z's faces and 1/(rho cp) on the (z, x, y) transposes from k
    and cp rounded to bfloat16 first (:718-752); the port's z sweep reads
    K5b's natural fz and w, which round once.  ``h_field`` and ``source``
    are read at the state dtype.  Other dtypes raise."""
    if h_axes is not None and h_field is not None:
        raise ValueError("h_axes and h_field are mutually exclusive")
    if gstreams is None:
        gstreams = (G_STREAMS_DEFAULT
                    or (G_STREAMS_BF16_DEFAULT and T.dtype == torch.bfloat16))
    if (gstreams and theta > 0.0 and h_axes is None
            and T.dtype in (torch.float32, torch.bfloat16)
            and _gstream_spec(k_table, mat_ref.k) is not None
            and _gstream_spec(cp_table, mat_ref.cp) is not None):
        return adi_step_varprop_gstreams(
            T, mask, grid, mat_ref, k_table=k_table, cp_table=cp_table,
            dt=dt, theta=theta, t_inf=t_inf, robin_h=robin_h,
            h_field=h_field, emissivity=emissivity, h_conv=h_conv,
            source=source, rng_seed=rng_seed)
    # float32, float64 or bfloat16 (any other dtype raises here)
    f = solve_numpy_dtype(T.dtype)
    check_films(robin_h, emissivity)
    self_rad = emissivity is not None and h_field is None and h_axes is None
    h_conv = float(h_conv or 0.0)
    if self_rad:
        check_films(h_conv, None)
    kts = (tuple(k_table) if isinstance(k_table, (tuple, list))
           else (k_table,) * 3)
    if len(kts) != 3:
        raise ValueError("a per-axis k_table must be a 3-tuple")
    cp_spec = _kernel_spec(cp_table, mat_ref.cp)
    ky_spec, kz_spec = (_kernel_spec(kt, mat_ref.k) for kt in kts[1:])

    # scalars at the solve dtype (float32 for bfloat16), in the JAX step's
    # op order
    dt_s = f(dt)
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]
    cw = float(f(1.0 - theta) * dt_s)
    tg = [float(f(theta) * dt_s * f(iv)) for iv in inv_d2]
    sk = [float(dt_s / f(d)) for d in grid.spacing]

    mask_u8 = mask if mask.dtype == torch.uint8 else mask.to(torch.uint8)
    if self_rad:
        fc, w, hf = build_varprop_fields(
            T, mask_u8, mat_ref, k_table, cp_table,
            rad=(float(emissivity), float(t_inf), h_conv))
    else:
        fc, w = build_varprop_fields(T, mask_u8, mat_ref, k_table, cp_table)
        hf = h_field
    rob = 0.0 if hf is not None or h_axes is not None else float(robin_h)
    if h_axes is not None:
        # h_rad is pure radiation (at T's dtype, as JAX forms it): the
        # convection lives in A; each stream at the state dtype
        h_rad = (None if emissivity is None else
                 radiative_h(T, emissivity, t_inf, h_conv=0.0))
        hs = tuple((A if B is None or h_rad is None else A + h_rad * B)
                   .to(T.dtype) for A, B in h_axes)
    else:
        hs = (hf if hf is None else hf.to(T.dtype),) * 3
    # a bfloat16 state rounds its stores stochastically with rng_seed, at
    # the JAX step's offsets: R0 0, x 1, y 2, z 3 (:617-621, 657-665, 773)
    seed = rng_seed if T.dtype == torch.bfloat16 else None
    src = None if source is None else source.to(T.dtype)

    if fuse_theta is False:
        R0 = varprop_theta_rhs(T, *fc, w, mask_u8, cw, inv_d2, src=src,
                               dt=float(dt_s), rng_seed=seed, rng_offset=0)
        U = varprop_sweep_x(R0, codes[0], fc[0], w, tg[0], sk[0], t_inf,
                            h=hs[0], rob_c=rob, rng_seed=seed, rng_offset=1)
    else:
        U = varprop_theta_sweep(T, codes[0], *fc, w, cw, inv_d2, tg[0],
                                sk[0], t_inf, h=hs[0], rob_c=rob, src=src,
                                dt=float(dt_s), rng_seed=seed, rng_offset=1)
    # the tier-2 sweeps (K15's y entry, K8) derive k, cp and a scalar or
    # self-radiative film from T^n in registers; the JAX step's vp2 gate
    # (float32 states only), each constant rounded to float32 once
    vp2_ok = (T.dtype == torch.float32 and cp_spec is not None
              and h_field is None and h_axes is None)
    vp2 = dict(cp_spec=cp_spec, h=h_conv if self_rad else float(robin_h),
               t_inf=float(t_inf),
               emissivity=float(emissivity) if self_rad else 0.0)
    inv_dtor = float(f(1.0) / (dt_s / f(mat_ref.rho)))
    if VP2_Y_DEFAULT and vp2_ok and ky_spec is not None:
        ycode = (codes[4] if codes[4] is not None else
                 build_vp2_code(mask.to(torch.bool), 1, edge_exposed=True))
        V = vp2_sweep_y(U, T, ycode, float(f(theta * inv_d2[1])),
                        float(f(1.0 / grid.spacing[1])), inv_dtor,
                        k_spec=ky_spec, **vp2)
    else:
        V = varprop_sweep_y(U, codes[1], fc[1], w, tg[1], sk[1], t_inf,
                            h=hs[1], rob_c=rob, rng_seed=seed, rng_offset=2)
    if vp2_ok and kz_spec is not None:
        return vp2_sweep_z(V, T, codes[2], float(f(theta * inv_d2[2])),
                           float(f(1.0 / grid.spacing[2])), inv_dtor,
                           k_spec=kz_spec, **vp2)
    return varprop_sweep_z(V, codes[3], fc[2], w, tg[2], sk[2], t_inf,
                           h=hs[2], rob_c=rob, rng_seed=seed, rng_offset=3)
