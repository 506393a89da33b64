"""Mask-aware cylindrical (r, phi, z) backward-Euler step with Robin films at
material/void interfaces.

Counterpart: ``adi_thermal_fields_tpu/step/cylindrical_masked.py`` —
``MaskedRobinPlan`` (:47), ``adi_step_masked_robin`` (:81),
``build_masked_robin_plan`` (:136) and ``masked_robin_solve`` (:310).

Couplings are severed across active/void boundaries and every exposed face
of an active cell (interior interface or domain end) adds a Robin sink
``fac*(h/k)*(A_face/V_cell)`` to the diagonal and ``*T_inf`` to the rhs,
with the cylindrical face/volume ratios r-faces ``r_{i-+1/2}/(r_i dr)``,
phi-faces ``1/(r_i dphi)`` and z-faces ``1/dz``.  Interior interfaces take
``h_void`` (the z+ faces ``h_front``), domain faces the Robin data of
their boundary, and phi is periodic.  Dirichlet z ends pin their active
cells.  Void rows are identity rows at the void ambient.  Backward Euler
chains r -> phi -> z, the phi solve being a mask-broken cyclic system.

Two implementations, one plan:

* ``"kernels"``: K9 along r, K11 along phi (skipped when nphi == 1), K10
  along z, each folding the rhs in the kernel from the code bits (the
  JAX compressed-kernel route, :329-360).  Float32 and float64 take the
  same three kernels: the JAX package sends a float64 z solve through a
  transpose pair (:357-360), the port reads z in the natural layout at
  every dtype.
* ``"reference"``: the plain versions of the three sweeps (a/b/c/d built
  from the plan, ``thomas`` along r and z, ``cyclic_thomas`` along phi),
  the counterpart of the JAX ``"xla"`` branch (:362-391), with its
  ``where(active, ., ambient)`` before and after.

The plan keeps every sweep's code, sink and srhs in the NATURAL (r, phi, z)
layout (the JAX plan keeps its z arrays solve-leading, as (z, r, phi)), so
no step transposes anything.  Not ported: ``pad_to_tile`` (TPU tiling) and
the ``constrain`` hook of the multi-chip layer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bc.faces import shift_in
from ..core.grid import CylindricalGrid
from ..core.material import Material
from ..solvers.masked import (masked_cyclic_phi, masked_cyclic_phi_plain,
                              masked_sweep_strided,
                              masked_sweep_strided_plain, masked_sweep_z,
                              masked_sweep_z_plain)
from .cylindrical import IMPLEMENTATIONS, RobinBC, ZFaceBC

__all__ = ["MaskedRobinPlan", "build_masked_robin_plan",
           "masked_robin_solve", "adi_step_masked_robin"]


class MaskedRobinPlan(NamedTuple):
    """Per-sweep inputs of the masked-Robin step, all per unit ``fac =
    dt*alpha`` and in the natural (r, phi, z) layout.  It depends only on
    the active mask: rebuild it when a cell is born.

    ``r`` and ``z``: ``(code, sink, srhs, glo, ghi)`` with (n,) geometry
    vectors; ``phi``: ``(code, sink, srhs, geo)`` with (nr, nz) geometry,
    or None when nphi == 1.  Code bits: 1/2 = coupling to i-1/i+1 (void
    and pin severed), 4 = pinned row, 8 = active; codes are uint8.  srhs
    holds sink*T_inf on live rows and the pin value on pinned rows."""

    active: torch.Tensor          # (nr, nphi, nz) bool
    ambient: float                # the void ambient (T_inf_void)
    r: tuple
    phi: tuple | None
    z: tuple


def build_masked_robin_plan(grid: CylindricalGrid, mat: Material,
                            active: torch.Tensor, *, robin_outer: RobinBC,
                            zbc: ZFaceBC, robin_inner: RobinBC | None = None,
                            h_void: float = 0.0, T_inf_void: float = 20.0,
                            h_front: float | None = None,
                            dtype: torch.dtype = torch.float64
                            ) -> MaskedRobinPlan:
    """The step's plan from the active mask, on the mask's device."""
    active = active.to(torch.bool).contiguous()
    if tuple(active.shape) != grid.shape:
        raise ValueError(f"active shape {tuple(active.shape)} != grid shape "
                         f"{grid.shape}")
    dev = active.device
    nr, nphi, nz = grid.shape
    dr, dz, dphi = grid.dr, grid.dz, grid.dphi
    if h_front is None:
        h_front = h_void

    r = np.maximum(np.asarray(grid.r, np.float64), 1e-15)
    r_imh = np.maximum(np.asarray(grid.r_imh, np.float64), 0.0)
    r_iph = np.asarray(grid.r_iph, np.float64)
    inv_k = 1.0 / mat.k

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float64), device=dev) \
            .to(dtype)

    col = (lambda v: vec(v)[:, None, None])

    def coupled(axis, direction):
        return active & shift_in(active, axis, direction, fill=False)

    def exposed(axis, direction):
        return active & ~shift_in(active, axis, direction, fill=False)

    f64 = torch.float64
    idx_r = torch.arange(nr, device=dev)[:, None, None]
    idx_z = torch.arange(nz, device=dev)[None, None, :]
    h_in = robin_inner.h if (grid.is_annular and robin_inner is not None) \
        else 0.0
    t_in = robin_inner.T_inf if robin_inner is not None else T_inf_void
    h_out, t_out = robin_outer.h, robin_outer.T_inf

    def hT(face_exposed, geom, is_domain, h_domain, t_domain, h_ifc, t_ifc):
        """(sink, sink*T_inf) of one face direction: ``(h/k)*A/V`` on
        exposed faces, domain or interface Robin data per cell."""
        sc = (lambda v: torch.tensor(v, dtype=f64, device=dev))
        if is_domain is None:
            h, t_ = sc(h_ifc), sc(t_ifc)
        else:
            h = torch.where(is_domain, sc(h_domain), sc(h_ifc))
            t_ = torch.where(is_domain, sc(t_domain), sc(t_ifc))
        s = torch.where(face_exposed, h * inv_k * geom, 0.0).to(dtype)
        return s, (s * t_).to(dtype)

    # z-end data: robin -> (h, T_inf); neumann0 -> h = 0; dirichlet pins
    hz_bot = zbc.h_bot if zbc.kind_bot == "robin" else 0.0
    hz_top = zbc.h_top if zbc.kind_top == "robin" else 0.0

    sink_rm, rhs_rm = hT(exposed(0, -1), col(r_imh / (r * dr)), idx_r == 0,
                         h_in, t_in, h_void, T_inf_void)
    sink_rp, rhs_rp = hT(exposed(0, +1), col(r_iph / (r * dr)),
                         idx_r == nr - 1, h_out, t_out, h_void, T_inf_void)
    # phi faces are periodic: exposure wraps around, no domain edge
    g_phi = col(1.0 / (r * dphi))
    s1, r1 = hT(active & ~torch.roll(active, 1, 1), g_phi, None, 0.0, 0.0,
                h_void, T_inf_void)
    s2, r2 = hT(active & ~torch.roll(active, -1, 1), g_phi, None, 0.0, 0.0,
                h_void, T_inf_void)
    sink_zm, rhs_zm = hT(exposed(2, -1), 1.0 / dz, idx_z == 0, hz_bot,
                         zbc.T_inf_bot, h_void, T_inf_void)
    sink_zp, rhs_zp = hT(exposed(2, +1), 1.0 / dz, idx_z == nz - 1, hz_top,
                         zbc.T_inf_top, h_front, T_inf_void)

    # Dirichlet z ends: the active cells of the end slab pinned
    pin = torch.zeros_like(active)
    pin_val = torch.zeros(active.shape, dtype=dtype, device=dev)
    for kind, k, value in ((zbc.kind_bot, 0, zbc.T_bot),
                           (zbc.kind_top, nz - 1, zbc.T_top)):
        if kind == "dirichlet":
            p = active & (idx_z == k)
            pin = pin | p
            pin_val = pin_val.masked_fill(p, value)
    live = active & ~pin
    base = pin.to(torch.uint8) * 4 | active.to(torch.uint8) * 8

    def pack(cup_lo, cup_hi, sink, sink_rhs):
        """(code, sink, srhs) with void/pin folded in."""
        code = (base | (cup_lo & live).to(torch.uint8)
                | (cup_hi & live).to(torch.uint8) * 2)
        sink = torch.where(live, sink, 0.0)
        srhs = torch.where(pin, pin_val, torch.where(live, sink_rhs, 0.0))
        return code, sink, srhs

    r_sw = pack(coupled(0, -1), coupled(0, +1), sink_rm + sink_rp,
                rhs_rm + rhs_rp) + (vec(r_imh / (r * dr * dr)),
                                    vec(r_iph / (r * dr * dr)))
    phi_sw = None
    if nphi > 1:
        geo_phi = vec(1.0 / (r * r * dphi * dphi))
        if not grid.is_annular:
            geo_phi[0] = 0.0   # axis-row regularity on full disks
        phi_sw = pack(torch.roll(active, 1, 1) & active,
                      torch.roll(active, -1, 1) & active, s1 + s2, r1 + r2) \
            + (geo_phi[:, None].expand(nr, nz).contiguous(),)
    geo_z = vec(np.full(nz, 1.0 / (dz * dz)))
    z_sw = pack(coupled(2, -1), coupled(2, +1), sink_zm + sink_zp,
                rhs_zm + rhs_zp) + (geo_z, geo_z)
    return MaskedRobinPlan(active, float(T_inf_void), r_sw, phi_sw, z_sw)


def masked_robin_solve(T: torch.Tensor, plan: MaskedRobinPlan,
                       grid: CylindricalGrid, mat: Material, *, dt: float,
                       source: torch.Tensor | None = None,
                       implementation: str = "kernels") -> torch.Tensor:
    """One backward-Euler step from a prebuilt plan.  ``dt``: a Python
    float; ``fac = dt*alpha`` is formed in the state dtype.  ``source``:
    optional volumetric heat rate [W/m^3]."""
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {IMPLEMENTATIONS}, "
                         f"got {implementation!r}")
    fac = float(torch.tensor(dt, dtype=T.dtype)
                * torch.tensor(mat.alpha, dtype=T.dtype))
    amb = plan.ambient
    R0 = T if source is None else T + dt * source / (mat.rho * mat.cp)
    if implementation == "kernels":
        X = masked_sweep_strided(R0, *plan.r, fac, amb)
        if plan.phi is not None:
            X = masked_cyclic_phi(X, *plan.phi, fac, amb)
        return masked_sweep_z(X, *plan.z, fac, amb)
    active = plan.active
    X = masked_sweep_strided_plain(torch.where(active, R0, amb), *plan.r,
                                   fac, amb)
    if plan.phi is not None:
        X = masked_cyclic_phi_plain(X, *plan.phi, fac, amb)
    X = masked_sweep_z_plain(X, *plan.z, fac, amb)
    return torch.where(active, X, amb)


def adi_step_masked_robin(T: torch.Tensor, grid: CylindricalGrid,
                          mat: Material, *, dt: float, active: torch.Tensor,
                          robin_outer: RobinBC, zbc: ZFaceBC,
                          robin_inner: RobinBC | None = None,
                          h_void: float = 0.0, T_inf_void: float = 20.0,
                          h_front: float | None = None,
                          source: torch.Tensor | None = None,
                          implementation: str = "kernels") -> torch.Tensor:
    """One BE step of the masked cylindrical problem (plan built from
    ``active`` inside, as the JAX step does).

    active: (nr, nphi, nz) bool solid mask; robin_outer / robin_inner: the
    domain radial faces (inner only on annular grids: a full disk's axis
    is a zero-flux face, r_{-1/2} = 0); zbc: the z ends ("neumann0",
    "dirichlet" or "robin"); h_void, T_inf_void: interior material/void
    faces; h_front: the z+ interface faces (default h_void)."""
    plan = build_masked_robin_plan(grid, mat, active,
                                   robin_outer=robin_outer, zbc=zbc,
                                   robin_inner=robin_inner, h_void=h_void,
                                   T_inf_void=T_inf_void, h_front=h_front,
                                   dtype=T.dtype)
    return masked_robin_solve(T, plan, grid, mat, dt=dt, source=source,
                              implementation=implementation)
