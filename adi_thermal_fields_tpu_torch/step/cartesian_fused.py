"""Kernel-path Cartesian ADI step on the four hand-written kernels.

Counterpart: ``adi_thermal_fields_tpu/step/cartesian_pallas.py`` —
``SweepPlan``, ``build_sweep_plan`` and ``adi_step_pallas`` (:138), with
the same branch structure (:180-297):

* plan-lite fast path (scalar-h Robin, no Neumann, no Dirichlet, no
  source): K4 (stencil fused into the x-sweep), K1 along y, K2 along the
  contiguous z;
* every other plan: K3 (stencil), K1 along x, K1 along y, K2 along z
  with the plan's coefficient, Neumann and Dirichlet fields.

Numerically it is step/cartesian.adi_step.  JAX solves the field plan's z
on the (z, x, y) transpose (:247-265); here K2 solves it in the natural
layout, so no step makes a permuted copy of the state.  All mask/BC-derived
sweep inputs are prebuilt per axis in the natural layout by
``build_sweep_plan`` (they change only on birth events).  bfloat16 states
run the same kernels in their bfloat16 entries: float32 solves, bfloat16
stores, rounded to nearest or stochastically (``rng_seed``; JAX
:138-297).  Left out of this port: the TPU tiling helpers ``pad_to_tile``
/ ``padded_shape`` / ``pad_domain``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bc.packs import CoeffPacks
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..solvers.differentiable import (fused_theta_solve_lite,
                                      sweep_solve, sweep_solve_lite,
                                      theta_rhs_diff)
from ..solvers.rounding import sr_key, to_state, widen
from ..solvers.stencil import theta_rhs
from ..solvers.sweeps import sweep_code, sweep_strided, sweep_z
from ..solvers.theta_sweep import fused_theta_sweep
from .cartesian import step_scalars

__all__ = ["SweepPlan", "build_sweep_plan", "adi_step_fused"]


class SweepPlan(NamedTuple):
    """Per-axis sweep inputs (rebuilt on birth only), every one in the
    natural (x, y, z) layout.  The x code carries the stencil bits for
    K4."""

    mask: torch.Tensor                 # (x, y, z) bool
    codes: tuple                       # 3 uint8 tensors
    coeffs: tuple | None               # 3 Robin fields; None = plan-lite
    qfluxes: tuple | None              # 3 Neumann fields or None
    dir_vals: tuple | None             # 3 Dirichlet value fields or None
    mask_u8: torch.Tensor              # uint8 mask for K3
    rob_c: tuple | None = None         # per-axis h/(rho cp d_ax), plan-lite


def build_sweep_plan(mask: torch.Tensor, packs: CoeffPacks | None, *,
                     has_neumann: bool | None = None,
                     has_dirichlet: bool | None = None,
                     robin_const=None) -> SweepPlan:
    """Precompute per-axis codes and re-laid coefficient fields.

    ``robin_const``: plan-lite mode for scalar-h Robin — pass
    ``h/(rho cp d)`` (a scalar, or the per-axis triple for anisotropic
    voxels) and no coefficient fields are built: the kernels derive the
    Robin sink from the code's in-mask bit.  ``packs`` may then be None
    when no Neumann or Dirichlet BCs exist.  ``has_neumann`` /
    ``has_dirichlet`` default to what the packs hold (one host sync)."""
    mask = mask.to(torch.bool)
    if has_dirichlet is None:
        has_dirichlet = packs is not None and bool(packs.dir_mask.any())
    if has_neumann is None:
        has_neumann = packs is not None and bool((packs.qflux != 0).any())
    lite = robin_const is not None

    dirm = packs.dir_mask if has_dirichlet else None
    # sweep_code returns axis-first: x is natural; y and z move back
    codes = (sweep_code(mask, dirm, 0, stencil_bits=True),
             sweep_code(mask, dirm, 1).movedim(0, 1).contiguous(),
             sweep_code(mask, dirm, 2).movedim(0, 2).contiguous())
    if lite:
        coeffs = None
        rc = robin_const
        rob_c = (tuple(float(v) for v in rc)
                 if isinstance(rc, (tuple, list)) else (float(rc),) * 3)
    else:
        coeffs = tuple(packs.coeff)
        rob_c = None
    qfluxes = tuple(packs.qflux) if has_neumann else None
    dir_vals = (packs.dir_val,) * 3 if has_dirichlet else None
    return SweepPlan(mask, codes, coeffs, qfluxes, dir_vals,
                     mask.to(torch.uint8), rob_c)


def adi_step_fused(T: torch.Tensor, plan: SweepPlan, grid: CartesianGrid,
                   mat: Material, *, dt, theta: float = 0.5,
                   t_inf: float = 0.0,
                   source: torch.Tensor | None = None,
                   rng_seed: int | None = None) -> torch.Tensor:
    """One theta-scheme ADI step on the kernel path.  ``dt`` is a Python
    float or a 0-d tensor, rounded to the solve dtype; ``source``:
    optional volumetric heat rate [W/m^3], as in step/cartesian.adi_step.

    float32 and float64 states run through the autograd Functions of
    solvers/differentiable.py where JAX calls its custom VJPs
    (cartesian_pallas.py:196-297), so gradients w.r.t. T, dt, the source
    and the plan's fields flow through the kernels; with no input that
    requires grad they launch the same kernels and record no graph.

    A bfloat16 state (and bfloat16 plan fields) solves every pass at
    float32 and stores bfloat16.  ``rng_seed`` (an integer: vary it per
    step, the engine passes its step counter) makes those stores
    stochastic, as the JAX step's: K3 with the seed, the sweeps with seed
    + 1, + 2, + 3 (offsets 0-3 of solvers/rounding.sr_key); without it they
    round to nearest.  The JAX step solves the stochastic z pass on the
    transposed layout; here K2 takes the natural z in every mode.  That
    route is not differentiable (the JAX step bypasses its VJPs there):
    asked for a gradient, it raises.  float32 and float64 states ignore
    ``rng_seed``."""
    dt, inv_d2, tg, c_exp = step_scalars(T.dtype, grid, mat, dt, theta)
    if T.dtype == torch.bfloat16:
        fields = (T, dt, source, *(plan.coeffs or ()),
                  *(plan.qfluxes or ()), *(plan.dir_vals or ()))
        if torch.is_grad_enabled() and any(
                torch.is_tensor(x) and x.requires_grad for x in fields):
            raise ValueError(
                "adi_step_fused: the bfloat16 route (stochastic or "
                "nearest stores) is not differentiable, as in the JAX "
                "step; differentiate a float32 or float64 state")
        if torch.is_tensor(dt):
            dt, tg, c_exp = float(dt), tuple(map(float, tg)), float(c_exp)
        return _step_bf16(T, plan, mat, dt, inv_d2, tg, c_exp, t_inf,
                          source, rng_seed)
    codes = plan.codes
    lite = plan.coeffs is None

    if (lite and source is None and plan.qfluxes is None
            and plan.dir_vals is None):
        # the flagship WAAM configuration: stencil fused into the x-sweep
        rc = plan.rob_c
        U = fused_theta_solve_lite(T, codes[0], c_exp, inv_d2, rc[0], tg[0],
                                   dt, t_inf)
        V = sweep_solve_lite(U, codes[1], rc[1], tg[1], dt, t_inf, axis=1)
        return sweep_solve_lite(V, codes[2], rc[2], tg[2], dt, t_inf, axis=2)

    R0 = theta_rhs_diff(T, plan.mask_u8, c_exp, inv_d2)
    if source is not None:
        R0 = R0 + torch.where(plan.mask, dt * source / (mat.rho * mat.cp),
                              0.0)
    q = plan.qfluxes or (None, None, None)
    dv = plan.dir_vals or (None, None, None)
    X = R0
    for ax in range(3):
        if lite:
            X = sweep_solve_lite(X, codes[ax], plan.rob_c[ax], tg[ax], dt,
                                 t_inf, q[ax], dv[ax], axis=ax)
        else:
            X = sweep_solve(X, codes[ax], plan.coeffs[ax], tg[ax], dt, t_inf,
                            q[ax], dv[ax], axis=ax)
    return X


def _step_bf16(T, plan, mat, dt, inv_d2, tg, c_exp, t_inf, source,
               rng_seed):
    """The bfloat16 step: the kernels' bfloat16 entries, stores rounded
    to nearest or stochastically with ``rng_seed``."""
    codes = plan.codes
    lite = plan.coeffs is None
    sr = dict(rng_seed=rng_seed)

    if (lite and source is None and plan.qfluxes is None
            and plan.dir_vals is None):
        # the flagship WAAM configuration: stencil fused into the x-sweep
        rc = plan.rob_c
        U = fused_theta_sweep(T, codes[0], c_exp, inv_d2, tg[0], dt, t_inf,
                              rc[0], rng_offset=1, **sr)
        V = sweep_strided(U, codes[1], tg[1], dt, t_inf, axis=1, rob_c=rc[1],
                          rng_offset=2, **sr)
        return sweep_z(V, codes[2], tg[2], dt, t_inf, rc[2], rng_offset=3,
                       **sr)

    R0 = theta_rhs(T, plan.mask_u8, c_exp, inv_d2, rng_offset=0, **sr)
    if source is not None:
        q = torch.where(plan.mask, dt * widen(source) / (mat.rho * mat.cp),
                        0.0)
        # at a bfloat16 state the sum rounds once more (its own offset)
        R0 = to_state(widen(R0) + q, R0.dtype, sr_key(rng_seed, 4))
    cf = plan.coeffs or (None, None, None)
    rc = plan.rob_c or (None, None, None)
    q = plan.qfluxes or (None, None, None)
    dv = plan.dir_vals or (None, None, None)
    U = sweep_strided(R0, codes[0], tg[0], dt, t_inf, axis=0, coeff=cf[0],
                      rob_c=rc[0], qflux=q[0], dir_val=dv[0], rng_offset=1,
                      **sr)
    V = sweep_strided(U, codes[1], tg[1], dt, t_inf, axis=1, coeff=cf[1],
                      rob_c=rc[1], qflux=q[1], dir_val=dv[1], rng_offset=2,
                      **sr)
    return sweep_z(V, codes[2], tg[2], dt, t_inf, rc[2], coeff=cf[2],
                   qflux=q[2], dir_val=dv[2], rng_offset=3, **sr)
