"""Variable-property cylindrical (r, phi, z) ADI step.

Counterpart: ``adi_thermal_fields_tpu/step/cylindrical_varprop.py`` —
``_ev`` (:76), ``_props`` (:100), ``_face_phi`` (:123),
``build_cyl_vp2_plan`` (:152), ``_vp2_be_step`` (:175),
``adi_step_cyl_varprop`` (:290) and ``adi_step_cyl_varprop_masked``
(:770).

Finite volume, Picard-frozen properties:

    rho cp(T^n) (T^{n+1} - T^n)/dt = div(k(T^n) grad T^{n+1}) + S

with harmonic face conductivities between adjacent cells' k(T^n) and
``w = 1/(rho cp(T^n))``.  Sweeps chain r -> phi -> z; Robin rows (the
outer and annular-inner rings, the z ends) need no k(T): the boundary
conductivity cancels by ghost elimination, leaving ``dt w h A/V``.  With
``active``, faces across void cells are cut, void rows hold their value,
and interior material/void faces carry Robin films ``h_void`` (the z+
faces ``h_front``) against ``T_inf_void``.  ``emissivity > 0`` adds the
Picard radiative film to every exposed film, each against its own
ambient.  ``scheme="be"``: backward Euler; ``scheme="douglas"``:
Douglas-Gunn with the affine operators built from the same streams as the
solves, so steady states are fixed points.

Three implementations:

* ``"kernels"`` (the JAX ``"pallas"`` route).  Backward Euler with table
  or number properties (``k_table`` None, a number, a ``PropertyTable`` or
  a 3-tuple of those; the same for ``cp_table``) runs the tier-2 chain of
  ``_vp2_be_step``: K15 along r -> K16 along phi -> K8's general form
  along z, each deriving k, cp, the faces and the films from T^n and a
  1-byte code (``build_cyl_vp2_plan``).  Douglas and backward Euler with
  an arbitrary callable build the five streams (face
  conductivity, ``dt w``, sink, srhs) with tensor ops and run K17 along r,
  K18 along phi and K17's z entry along z of the natural streams (the JAX
  Douglas z solve, :706-713, runs on a (z, r, phi) transpose pair; the
  port departs in layout only).  The JAX package sends
  float64 through the stream tier (its vp2 kernels take float32); the port
  runs the tier-2 chain at float32 and float64 alike.  The two tiers
  differ only by the scaling of each row, and agree to round-off.
* ``"fields"`` (the JAX ``"pallas_fields"`` route): the reference's
  materialized a/b/c/d, solved in the natural layout by K21 along r and z
  and K22 along phi, for backward Euler and Douglas alike.
* ``"reference"`` (the JAX ``"xla"`` route): the streams, materialized
  a/b/c/d, ``thomas`` along r and z and ``cyclic_thomas`` along phi.

``nphi == 1`` runs no phi sweep.  bfloat16 and float16 states are solved
at float32 and rounded back once, as the JAX step does.  ``dt`` is a
Python float or a 0-d tensor.  The ``kernels`` tier runs its sweeps
through the autograd Functions of solvers/differentiable.py, where JAX
calls its custom VJPs (:184, :497-537, :653, :707): gradients w.r.t. T,
dt and what the tables close over flow through K15-K18 and K8's general
form; the ``reference`` tier is differentiable by autograd, and the
``fields`` tier (K21/K22 on materialized rows) is forward only.  Not
ported, and refused naming what they need: the multi-device hooks
``constrain``, ``z_solver`` and ``pallas_solvers``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..bc.faces import shift_in
from ..bc.radiation import radiative_h
from ..core.grid import CylindricalGrid
from ..core.material import Material
from ..solvers.differentiable import (vp2_cyclic_solve, vp2_sweep_solve,
                                      vp_cyclic_solve, vp_sweep_solve)
from ..solvers.fields import cyclic_fields, tridiag_fields
from ..solvers.thomas import cyclic_thomas, thomas
from ..solvers.varprop import face_g, harm
from ..solvers.vp2 import build_vp2_code
from .cartesian import solve_numpy_dtype
from .cartesian_varprop import PropertyTable, check_films
from .cylindrical import RobinBC, ZFaceBC, _vec

__all__ = ["adi_step_cyl_varprop", "adi_step_cyl_varprop_masked",
           "build_cyl_vp2_plan", "IMPLEMENTATIONS"]

IMPLEMENTATIONS = ("kernels", "fields", "reference")


def _ev(tab, const, T):
    """A property (None, number or callable) evaluated at T in T's dtype."""
    if tab is None:
        return torch.full_like(T, float(const))
    if callable(tab):
        return tab(T).to(T.dtype)
    return torch.full_like(T, float(tab))


def _props(T, mat_ref: Material, k_table, cp_table):
    """Per-axis (k_r, k_phi, k_z)(T^n) and w = 1/(rho cp(T^n)); k_table
    may be a 3-tuple (anisotropic conductivity)."""
    if isinstance(k_table, (tuple, list)):
        if len(k_table) != 3:
            raise ValueError("anisotropic k_table must be a 3-tuple "
                             "(k_r, k_phi, k_z)")
        ks = tuple(_ev(t, mat_ref.k, T) for t in k_table)
    else:
        kf = _ev(k_table, mat_ref.k, T)
        ks = (kf, kf, kf)
    w = 1.0 / (mat_ref.rho * _ev(cp_table, mat_ref.cp, T))
    return ks, w


def _face_phi(kf, active):
    """Periodic lo-face harmonic conductivity along axis 1,
    ``harm(k[:, j-1], k[:, j])``, zero across void when ``active`` is
    given."""
    f = harm(torch.roll(kf, 1, 1), kf)
    if active is not None:
        f = torch.where(active & torch.roll(active, 1, 1), f, 0.0)
    return f


def _table_spec(tab, default: float):
    """A property as the tier-2 kernels take it (a number or a
    PropertyTable), or None for a callable."""
    if tab is None:
        return float(default)
    if isinstance(tab, (int, float)):
        return float(tab)
    if isinstance(tab, PropertyTable):
        return tab
    return None


def _radii(grid: CylindricalGrid):
    r = np.maximum(np.asarray(grid.r, np.float64), 1e-15)
    r_imh = np.maximum(np.asarray(grid.r_imh, np.float64), 1e-15)
    return r, r_imh, np.asarray(grid.r_iph, np.float64)


def _dirichlet_rows(grid: CylindricalGrid, zbc: ZFaceBC) -> tuple:
    return tuple(idx for idx, kind in ((0, zbc.kind_bot),
                                       (grid.nz - 1, zbc.kind_top))
                 if kind == "dirichlet")


def build_cyl_vp2_plan(active, grid: CylindricalGrid, zbc: ZFaceBC):
    """The tier-2 codes for a fixed active mask, all in the natural
    (r, phi, z) layout: ``(code_r, code_p, code_z)``.  Pass it to
    ``adi_step_cyl_varprop(vp2_plan=...)`` to skip the per-step code
    builds; rebuild it when a cell is born.  ``active`` None: the whole
    grid.  (The JAX plan keeps its z code as (z, r, phi).)"""
    if active is None:
        active = torch.ones(grid.shape, dtype=torch.bool)
    act_b = active.to(torch.bool)
    code_r = build_vp2_code(act_b, 0)
    code_p = build_vp2_code(act_b, 1, periodic=True)
    if not grid.is_annular:
        code_p[0] = 0            # full-disk axis ring: identity rows
    code_z = build_vp2_code(act_b, 2, clear_rows=_dirichlet_rows(grid, zbc))
    return (code_r, code_p, code_z)


@functools.lru_cache(maxsize=16)
def _full_vp2_plan(grid: CylindricalGrid, zbc: ZFaceBC, device):
    """The codes of an unmasked step (built once per grid, BCs and
    device)."""
    return build_cyl_vp2_plan(
        torch.ones(grid.shape, dtype=torch.bool, device=device), grid, zbc)


@functools.lru_cache(maxsize=64)
def _vp2_columns(grid: CylindricalGrid, zbc: ZFaceBC, dtype, device):
    """The tier-2 sweeps' per-row columns at ``dtype``: r coupling and
    film metrics, phi coupling and film metrics per ring, z coupling
    (zero at Dirichlet rows) and film metrics."""
    r, r_imh, r_iph = _radii(grid)
    dr, dz, dphi, nz = grid.dr, grid.dz, grid.dphi, grid.nz
    geoz = np.full(nz, 1.0 / (dz * dz))
    geoz[list(_dirichlet_rows(grid, zbc))] = 0.0
    vec = (lambda v: _vec(v, dtype, device))
    return dict(glo_r=vec(r_imh / (r * dr * dr)),
                ghi_r=vec(r_iph / (r * dr * dr)), gsl_r=vec(r_imh / (r * dr)),
                gsh_r=vec(r_iph / (r * dr)),
                geo_p=vec(1.0 / (r * r * dphi * dphi)),
                gs_p=vec(1.0 / (r * dphi)), geo_z=vec(geoz),
                gs_z=vec(np.full(nz, 1.0 / dz)))


def _pin_z(X, zbc: ZFaceBC, act):
    """The z sweep's rhs with Dirichlet end rows pinned; void end cells
    hold their value."""
    pins = [(idx, float(t)) for idx, kind, t in
            ((0, zbc.kind_bot, zbc.T_bot), (X.shape[2] - 1, zbc.kind_top,
                                            zbc.T_top)) if kind == "dirichlet"]
    if not pins:
        return X
    X = X.clone()
    for idx, t_dir in pins:
        if act is None:
            X[:, :, idx] = t_dir
        else:
            X[:, :, idx] = torch.where(act[:, :, idx], t_dir, X[:, :, idx])
    return X


def _vp2_be_step(T, grid, mat_ref, dt, robin_outer, zbc, k_specs, cp_spec,
                 *, robin_inner, act, h_void, T_inf_void, h_front, source,
                 emissivity, cp_table, vp2_plan):
    """The tier-2 backward-Euler chain: K15 (r) -> K16 (phi) -> K8's
    general form (z)."""
    dtype, dev = T.dtype, T.device
    f = solve_numpy_dtype(dtype)
    if torch.is_tensor(dt):
        dt_s = dt.to(dtype)
        dtor = dt_s / mat_ref.rho
    else:
        dt_s = f(dt)
        dtor = float(f(dt_s / f(mat_ref.rho)))
    nr, dr = grid.nr, grid.dr
    eps = float(emissivity)
    h_v, tv = float(h_void), float(T_inf_void)
    cols = _vp2_columns(grid, zbc, dtype, dev)
    r, r_imh, r_iph = _radii(grid)
    if vp2_plan is None:
        vp2_plan = (_full_vp2_plan(grid, zbc, dev) if act is None
                    else build_cyl_vp2_plan(act, grid, zbc))
    code_r, code_p, code_z = vp2_plan

    # r: the inner ring's film on annular grids, the outer ring's film
    edge_r0 = edge_r1 = None
    if (grid.is_annular and robin_inner is not None
            and (robin_inner.h != 0.0 or eps > 0.0)):
        edge_r0 = (float(robin_inner.h), float(r_imh[0] / (r[0] * dr)),
                   float(robin_inner.T_inf))
    if robin_outer is not None and (robin_outer.h != 0.0 or eps > 0.0):
        edge_r1 = (float(robin_outer.h),
                   float(r_iph[nr - 1] / (r[nr - 1] * dr)),
                   float(robin_outer.T_inf))
    rhs_r = None
    if source is not None:
        cpf = _ev(cp_table, mat_ref.cp, T)
        if not torch.is_tensor(dt_s):
            dt_s = torch.full((), float(dt_s), dtype=dtype, device=dev)
        s = dt_s / (mat_ref.rho * cpf) * source
        if act is not None:
            s = torch.where(act, s, 0.0)
        rhs_r = T + s
    X = vp2_sweep_solve(rhs_r, T, code_r, cols["glo_r"], cols["ghi_r"],
                        cols["gsl_r"], cols["gsh_r"], dtor,
                        spec=(k_specs[0], cp_spec, h_v, h_v, tv, eps,
                              edge_r0, edge_r1), axis=0)
    if grid.nphi > 1:
        X = vp2_cyclic_solve(X, T, code_p, cols["geo_p"], cols["gs_p"], dtor,
                             spec=(k_specs[1], cp_spec, h_v, tv, eps))

    # z: Robin ends as edge films; Dirichlet rows pinned in the rhs, their
    # coupling columns zero and their film bits cleared in the code
    edges = []
    for kind, h, t_inf in ((zbc.kind_bot, zbc.h_bot, zbc.T_inf_bot),
                           (zbc.kind_top, zbc.h_top, zbc.T_inf_top)):
        if kind not in ("neumann0", "dirichlet", "robin"):
            raise ValueError(f"unknown z-face BC kind: {kind!r}")
        edges.append((float(h), 1.0 / grid.dz, float(t_inf))
                     if kind == "robin" else None)
    return vp2_sweep_solve(_pin_z(X, zbc, act), T, code_z, cols["geo_z"],
                           cols["geo_z"], cols["gs_z"], cols["gs_z"], dtor,
                           spec=(k_specs[2], cp_spec, h_v, float(h_front),
                                 tv, eps, edges[0], edges[1]), axis=2)


def _fields_step(T, grid, mat_ref, dt, robin_outer, zbc, k_table, cp_table,
                 *, robin_inner, act, h_void, T_inf_void, h_front, source,
                 emissivity, scheme, theta, solver):
    """The stream tier: K17/K18 (``solver`` "kernels") or materialized
    rows solved by K21/K22 ("fields") or ``thomas``/``cyclic_thomas``
    ("reference"), backward Euler or Douglas-Gunn."""
    dtype, dev = T.dtype, T.device
    f = solve_numpy_dtype(dtype)
    dt_s = dt.to(dtype) if torch.is_tensor(dt) else float(f(dt))
    nr, nphi, nz = grid.shape
    dr, dz = grid.dr, grid.dz
    (kf_r, kf_p, kf_z), w = _props(T, mat_ref, k_table, cp_table)
    dw = dt_s * w
    r, r_imh, r_iph = _radii(grid)
    cols = _vp2_columns(grid, zbc, dtype, dev)
    col = (lambda name: cols[name][:, None, None])
    ga_r, gc_r = col("glo_r"), col("ghi_r")
    zero = torch.zeros((), dtype=dtype, device=dev)
    eps = float(emissivity)
    if eps > 0.0:
        def hr(t, t_inf):
            return radiative_h(t, eps, t_inf)
    else:
        def hr(t, t_inf):
            return zero
    hr_void = hr(T, T_inf_void)
    sink_on = act is not None and (h_void != 0.0 or h_front != 0.0
                                   or eps > 0.0)
    mask = act if act is not None else torch.ones_like(T, dtype=torch.bool)

    def gate(x):
        return x if act is None else torch.where(act, x, 0.0)

    def exposed(ax, d):
        return act & ~shift_in(act, ax, d, fill=True)

    # --- r streams: Robin rings, then the material/void interface films
    fr = face_g(kf_r, 0, -1, mask)
    fr_hi = torch.cat([fr[1:], torch.zeros_like(fr[:1])], 0)
    sink_r = torch.zeros_like(T)
    srhs_r = torch.zeros_like(T)
    rings = []
    if robin_outer is not None and (robin_outer.h != 0.0 or eps > 0.0):
        rings.append((nr - 1, robin_outer, r_iph[nr - 1] / (r[nr - 1] * dr)))
    if (grid.is_annular and robin_inner is not None
            and (robin_inner.h != 0.0 or eps > 0.0)):
        rings.append((0, robin_inner, r_imh[0] / (r[0] * dr)))
    for i, rob, g in rings:
        s = float(g) * (rob.h + hr(T[i], rob.T_inf))
        if act is not None:
            s = torch.where(act[i], s, 0.0)
        sink_r[i] += s
        srhs_r[i] += s * rob.T_inf
    if sink_on:
        s = (h_void + hr_void) * (
            torch.where(exposed(0, -1), col("gsl_r"), zero)
            + torch.where(exposed(0, +1), col("gsh_r"), zero))
        sink_r = sink_r + s
        srhs_r = srhs_r + s * T_inf_void

    def solve_r(rhs, dwx):
        if solver == "kernels":
            return vp_sweep_solve(
                rhs.contiguous(), fr_hi, dwx, sink_r, srhs_r, cols["glo_r"],
                cols["ghi_r"], axis=0)
        a = -dwx * ga_r * fr
        c = -dwx * gc_r * fr_hi
        b = 1.0 + dwx * (ga_r * fr + gc_r * fr_hi + sink_r)
        if solver == "fields":
            return tridiag_fields(a, b, c, rhs + dwx * srhs_r, 0)
        return thomas(a, b, c, rhs + dwx * srhs_r)

    # --- phi streams (periodic)
    solve_phi = None
    if nphi > 1:
        gphi = col("geo_p")
        fp = _face_phi(kf_p, act)
        if not grid.is_annular:
            fp[0] = 0.0                  # full-disk axis-ring regularity
        fp_hi = torch.roll(fp, -1, 1)
        sink_p = torch.zeros_like(T)
        srhs_p = torch.zeros_like(T)
        if sink_on:
            e_lo = act & ~torch.roll(act, 1, 1)
            e_hi = act & ~torch.roll(act, -1, 1)
            s = (h_void + hr_void) * col("gs_p") * (
                e_lo.to(dtype) + e_hi.to(dtype))
            if not grid.is_annular:
                s[0] = 0.0
            sink_p = sink_p + s
            srhs_p = srhs_p + s * T_inf_void

        def solve_phi(rhs, dwx):
            if solver == "kernels":
                return vp_cyclic_solve(
                    rhs.contiguous(), fp, dwx, sink_p, srhs_p, cols["geo_p"])
            ap = -dwx * gphi * fp
            cp = -dwx * gphi * fp_hi
            bp = 1.0 + dwx * (gphi * (fp + fp_hi) + sink_p)
            if solver == "fields":
                return cyclic_fields(ap, bp, cp, rhs + dwx * srhs_p, 1)
            mv = (lambda t: t.movedim(1, 0))
            return cyclic_thomas(mv(ap), mv(bp), mv(cp),
                                 mv(rhs + dwx * srhs_p)).movedim(0, 1) \
                .contiguous()

    # --- z streams: interface films, then the end rows (Robin films fold
    # into sink/srhs; Dirichlet rows have zero geometry and a pinned rhs)
    fz = face_g(kf_z, 2, -1, mask)
    fz_hi = torch.cat([fz[:, :, 1:], torch.zeros_like(fz[:, :, :1])], 2)
    sink_z = torch.zeros_like(T)
    srhs_z = torch.zeros_like(T)
    if sink_on:
        e_lo = act & ~shift_in(act, 2, -1, fill=True)
        e_hi = act & ~shift_in(act, 2, +1, fill=True)
        s = ((h_void + hr_void) * e_lo.to(dtype)
             + (h_front + hr_void) * e_hi.to(dtype)) / dz
        sink_z = sink_z + s
        srhs_z = srhs_z + s * T_inf_void
    for idx, kind, h, t_inf in ((0, zbc.kind_bot, zbc.h_bot, zbc.T_inf_bot),
                                (nz - 1, zbc.kind_top, zbc.h_top,
                                 zbc.T_inf_top)):
        if kind == "robin":
            s = (float(h) + hr(T[:, :, idx], float(t_inf))) / dz
            if act is not None:
                s = torch.where(act[:, :, idx], s, 0.0)
            sink_z[:, :, idx] += s
            srhs_z[:, :, idx] += s * float(t_inf)
        elif kind == "dirichlet":
            sink_z[:, :, idx] = 0.0
            srhs_z[:, :, idx] = 0.0
        elif kind != "neumann0":
            raise ValueError(f"unknown z-face BC kind: {kind!r}")
    gz = cols["geo_z"]
    colz = gz[None, None, :]

    def solve_z(rhs, dwx):
        d = _pin_z(rhs, zbc, act)
        if solver == "kernels":
            return vp_sweep_solve(d.contiguous(), fz_hi, dwx.contiguous(),
                                  sink_z, srhs_z, gz, gz, axis=2)
        az = -dwx * colz * fz
        cz = -dwx * colz * fz_hi
        bz = 1.0 + dwx * (colz * (fz + fz_hi) + sink_z)
        if solver == "fields":
            return tridiag_fields(az, bz, cz, d + dwx * srhs_z, 2)
        mv = (lambda t: t.movedim(2, 0))
        return thomas(mv(az), mv(bz), mv(cz), mv(d + dwx * srhs_z)) \
            .movedim(0, 2).contiguous()

    if scheme == "be":
        R0 = T if source is None else T + gate(dw * source)
        X = solve_r(R0, dw)
        if solve_phi is not None:
            X = solve_phi(X, dw)
        return solve_z(X, dw)

    # Douglas-Gunn: the affine operators from the solves' own streams
    th = theta if 0.0 < theta <= 1.0 else 0.5

    def sh(x, axis, d):
        return shift_in(x, axis, d, fill=0.0)

    Lr = w * (ga_r * fr * sh(T, 0, -1) + gc_r * fr_hi * sh(T, 0, +1)
              - (ga_r * fr + gc_r * fr_hi + sink_r) * T + srhs_r)
    Lp = zero
    if solve_phi is not None:
        Lp = w * (gphi * fp * torch.roll(T, 1, 1)
                  + gphi * fp_hi * torch.roll(T, -1, 1)
                  - (gphi * (fp + fp_hi) + sink_p) * T + srhs_p)
    Lz = w * (colz * fz * sh(T, 2, -1) + colz * fz_hi * sh(T, 2, +1)
              - (colz * (fz + fz_hi) + sink_z) * T + srhs_z)
    Y0 = T + dt_s * (Lr + Lp + Lz)
    if source is not None:
        Y0 = Y0 + gate(dw * source)
    thdw = th * dw
    thdt = (th * dt_s if torch.is_tensor(dt_s)
            else float(f(th) * f(dt_s)))
    X = solve_r(Y0 - thdt * Lr, thdw)
    if solve_phi is not None:
        X = solve_phi(X - thdt * Lp, thdw)
    return solve_z(X - thdt * Lz, thdw)


def adi_step_cyl_varprop(T: torch.Tensor, grid: CylindricalGrid,
                         mat_ref: Material, *, dt,
                         robin_outer: RobinBC, zbc: ZFaceBC,
                         k_table=None, cp_table=None,
                         robin_inner: RobinBC | None = None,
                         active: torch.Tensor | None = None,
                         h_void: float = 0.0, T_inf_void: float = 20.0,
                         h_front: float | None = None,
                         source: torch.Tensor | None = None,
                         emissivity: float = 0.0, scheme: str = "be",
                         theta: float = 0.5,
                         implementation: str = "kernels", vp2_plan=None,
                         constrain=None, z_solver=None,
                         pallas_solvers=None) -> torch.Tensor:
    """One variable-property cylindrical step of an (nr, nphi, nz) field
    (module docstring).

    ``k_table`` / ``cp_table``: None (``mat_ref``'s value), a number, a
    ``PropertyTable`` or a ``T -> field`` callable; ``k_table`` may be a
    3-tuple (k_r, k_phi, k_z) of those.  ``active``: optional (nr, nphi,
    nz) bool mask; ``h_void`` / ``T_inf_void``: the material/void
    interface films, ``h_front`` (default ``h_void``) on the z+ faces.
    ``source``: volumetric heat rate [W/m^3].  ``vp2_plan``: the codes of
    ``build_cyl_vp2_plan(active, grid, zbc)`` (tier-2 route only)."""
    for name, hook in (("constrain", constrain), ("z_solver", z_solver),
                       ("pallas_solvers", pallas_solvers)):
        if hook is not None:
            raise NotImplementedError(
                f"{name}: the multi-device hooks need the port of "
                "dist/cylindrical.py (torch.distributed), not ported yet")
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {IMPLEMENTATIONS}, "
                         f"got {implementation!r}")
    if scheme not in ("be", "douglas"):
        raise ValueError(f"unknown scheme: {scheme!r}")
    if T.dtype in (torch.bfloat16, torch.float16):
        # solve sub-float32 states at float32 and round back once
        return adi_step_cyl_varprop(
            T.float(), grid, mat_ref, dt=dt, robin_outer=robin_outer,
            zbc=zbc, k_table=k_table, cp_table=cp_table,
            robin_inner=robin_inner, active=active, h_void=h_void,
            T_inf_void=T_inf_void, h_front=h_front, source=source,
            emissivity=emissivity, scheme=scheme, theta=theta,
            implementation=implementation, vp2_plan=vp2_plan).to(T.dtype)
    solve_numpy_dtype(T.dtype)          # float32 / float64, or raise
    if tuple(T.shape) != grid.shape:
        raise ValueError(f"T shape {tuple(T.shape)} != grid shape "
                         f"{grid.shape}")
    h_front = h_void if h_front is None else h_front
    check_films(None, emissivity, h_void=h_void, h_front=h_front,
                robin_outer=None if robin_outer is None else robin_outer.h,
                robin_inner=None if robin_inner is None else robin_inner.h,
                h_bot=zbc.h_bot if zbc.kind_bot == "robin" else None,
                h_top=zbc.h_top if zbc.kind_top == "robin" else None)
    T = T.contiguous()
    act = None if active is None else active.to(torch.bool).contiguous()
    common = dict(robin_inner=robin_inner, act=act, h_void=float(h_void),
                  T_inf_void=float(T_inf_void), h_front=float(h_front),
                  source=source, emissivity=float(emissivity))
    if implementation == "kernels" and scheme == "be":
        kts = (tuple(k_table) if isinstance(k_table, (tuple, list))
               else (k_table,) * 3)
        specs = tuple(_table_spec(t, mat_ref.k) for t in kts)
        cp_spec = _table_spec(cp_table, mat_ref.cp)
        if len(specs) == 3 and cp_spec is not None \
                and all(s is not None for s in specs):
            return _vp2_be_step(T, grid, mat_ref, dt, robin_outer, zbc,
                                specs, cp_spec, cp_table=cp_table,
                                vp2_plan=vp2_plan, **common)
    return _fields_step(T, grid, mat_ref, dt, robin_outer, zbc, k_table,
                        cp_table, scheme=scheme, theta=theta,
                        solver=implementation, **common)


def adi_step_cyl_varprop_masked(T: torch.Tensor, grid: CylindricalGrid,
                                mat_ref: Material, *, dt,
                                robin_outer: RobinBC, zbc: ZFaceBC,
                                active: torch.Tensor, k_table=None,
                                cp_table=None,
                                robin_inner: RobinBC | None = None,
                                robin_void: RobinBC | None = None,
                                source: torch.Tensor | None = None,
                                emissivity: float = 0.0, scheme: str = "be",
                                theta: float = 0.5,
                                implementation: str = "kernels"
                                ) -> torch.Tensor:
    """Element-birth clamp wrapper on the varprop step: void cells clamped
    to ``robin_void.T_inf`` before and after the unmasked step, inactive
    cells of ring 0 tied to the inner ambient.  For the face-cut
    (adiabatic) treatment pass ``active=`` to ``adi_step_cyl_varprop``."""
    rin = robin_inner if robin_inner is not None else robin_outer
    rvd = robin_void if robin_void is not None else robin_outer
    active = active.to(torch.bool)
    T_work = torch.where(active, T, rvd.T_inf)
    T1 = adi_step_cyl_varprop(T_work, grid, mat_ref, dt=dt,
                              robin_outer=robin_outer, zbc=zbc,
                              k_table=k_table, cp_table=cp_table,
                              robin_inner=robin_inner, source=source,
                              emissivity=emissivity, scheme=scheme,
                              theta=theta, implementation=implementation)
    T1 = torch.where(active, T1, rvd.T_inf)
    T1[0] = torch.where(active[0], T1[0], rin.T_inf)
    return T1
