"""Cartesian masked theta-scheme ADI time step: the plain reference step.

Counterpart: ``adi_thermal_fields_tpu/step/cartesian.py`` —
``masked_laplacian_1d``, ``build_sweep_system``, ``implicit_sweep``,
``adi_step`` and ``apply_surface_impulse`` (:134).  Plain tensor ops on
any device; the kernel path (step/cartesian_fused.py) is checked against
it on the CPU and on the card.

One step advances ``T^{n+1} = W(V(U(R0)))`` where
``R0 = T^n + dt*kappa*(1-theta)*(Lx+Ly+Lz) T^n`` (mask-aware Laplacians) and
U/V/W are per-axis implicit sweeps, each solving, per pencil,

    (1 + theta*gam*nnb + dt*C_ax) u_i - theta*gam*(u_{i-1} + u_{i+1})
        = rhs_i + dt*q_ax + dt*C_ax*T_inf

with couplings only between mask-adjacent neighbors, Dirichlet rows pinned
to their value, and void rows as identity rows carrying the rhs through.
The explicit (1-theta) fraction of the Robin flux is NOT in R0: Robin
enters only through the implicit sink ``dt*C_ax`` (the reference scheme's
convention, kept for parity).
"""
from __future__ import annotations

import numpy as np
import torch

from ..bc.faces import exposed_face, shift_in
from ..bc.packs import CoeffPacks
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..solvers.thomas import thomas

__all__ = ["adi_step", "masked_laplacian_1d", "build_sweep_system",
           "implicit_sweep", "step_scalars", "solve_numpy_dtype",
           "solve_dtype", "round_to_state", "apply_surface_impulse"]


def solve_numpy_dtype(dtype: torch.dtype):
    """numpy scalar type of the solve for a state dtype: float32 for
    float32 and bfloat16 states (bf16 stores, float32 solve), float64 for
    float64."""
    if dtype in (torch.float32, torch.bfloat16):
        return np.float32
    if dtype == torch.float64:
        return np.float64
    raise NotImplementedError(
        f"state dtype {dtype} is not supported (float32, float64 or "
        "bfloat16)")


def solve_dtype(dtype: torch.dtype) -> torch.dtype:
    """The solve's torch dtype for a state dtype (``solve_numpy_dtype``)."""
    return torch.float64 if solve_numpy_dtype(dtype) is np.float64 \
        else torch.float32


def round_to_state(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to the state dtype (to nearest), as a Python float."""
    return float(torch.tensor(float(x), dtype=dtype))


def step_scalars(dtype: torch.dtype, grid: CartesianGrid, mat: Material,
                 dt, theta: float):
    """Per-step scalars ``(dt, inv_d2, tg, c_exp)``.

    ``dt`` is rounded to the solve dtype (float32 for bfloat16 states, as
    the JAX step's ``promote_types(T.dtype, float32)``) and ``tg =
    theta*(kappa*dt*inv_d2)`` and ``c_exp = dt*kappa*(1-theta)`` are
    evaluated at its precision in the JAX step's op order.  ``inv_d2``
    stays at double precision: consumers round it at the solve dtype, as
    the JAX step does.  A Python-float ``dt`` gives Python floats; a 0-d
    tensor ``dt`` (a decision variable of the inverse apps) gives 0-d
    tensors at the solve dtype that keep its graph."""
    inv_d2 = tuple(1.0 / (d * d) for d in grid.spacing)
    if torch.is_tensor(dt):
        dt_s = dt.to(solve_dtype(dtype))
        kappa = mat.alpha
        tg = tuple(theta * (kappa * dt_s * iv) for iv in inv_d2)
        return dt_s, inv_d2, tg, dt_s * kappa * (1.0 - theta)
    f = solve_numpy_dtype(dtype)
    dt_s = f(dt)
    kappa = f(mat.alpha)
    tg = tuple(float(f(theta) * (kappa * dt_s * f(iv))) for iv in inv_d2)
    c_exp = float(dt_s * kappa * f(1.0 - theta))
    return float(dt_s), inv_d2, tg, c_exp


def masked_laplacian_1d(T: torch.Tensor, mask: torch.Tensor, axis: int,
                        inv_dx2: float) -> torch.Tensor:
    """Second difference along ``axis`` counting only in-mask neighbors
    (reflective at mask boundaries); zero on void cells."""
    nbr_lo = shift_in(mask, axis, -1, fill=False)
    nbr_hi = shift_in(mask, axis, +1, fill=False)
    T_lo = shift_in(T, axis, -1, fill=0.0)
    T_hi = shift_in(T, axis, +1, fill=0.0)
    s = torch.where(nbr_lo, T_lo, 0.0) + torch.where(nbr_hi, T_hi, 0.0)
    cnt = nbr_lo.to(T.dtype) + nbr_hi.to(T.dtype)
    return torch.where(mask, (s - cnt * T) * inv_dx2, 0.0)


def build_sweep_system(rhs, mask, coeff_ax, dir_mask, dir_val, qflux_ax,
                       theta_gam, dt, t_inf: float, axis: int):
    """The per-axis tridiagonal system (a, b, c, d) of one implicit sweep,
    in the natural field layout (``theta_gam`` and ``dt`` floats or 0-d
    tensors)."""
    low = mask & shift_in(mask, axis, -1, fill=False)
    high = mask & shift_in(mask, axis, +1, fill=False)

    dtype = rhs.dtype
    zero = torch.zeros((), dtype=dtype, device=rhs.device)
    neg_tg = ((-theta_gam).to(dtype) if torch.is_tensor(theta_gam)
              else torch.full((), -theta_gam, dtype=dtype,
                              device=rhs.device))
    a = torch.where(low, neg_tg, zero)
    c = torch.where(high, neg_tg, zero)
    nnb = low.to(dtype) + high.to(dtype)
    b = 1.0 + theta_gam * nnb + dt * coeff_ax
    d = rhs + dt * qflux_ax + dt * coeff_ax * t_inf

    # void rows: identity carrying rhs through
    b = torch.where(mask, b, 1.0)
    d = torch.where(mask, d, rhs)

    # Dirichlet rows: pinned
    pin = dir_mask & mask
    a = torch.where(pin, zero, a)
    c = torch.where(pin, zero, c)
    b = torch.where(pin, 1.0, b)
    d = torch.where(pin, dir_val, d)
    return a, b, c, d


def implicit_sweep(rhs, mask, coeff_ax, dir_mask, dir_val, qflux_ax,
                   theta_gam, dt, t_inf: float,
                   axis: int) -> torch.Tensor:
    """One per-axis implicit sweep in full-shape batched form."""
    a, b, c, d = build_sweep_system(rhs, mask, coeff_ax, dir_mask, dir_val,
                                    qflux_ax, theta_gam, dt, t_inf, axis)
    mv = (lambda t: t.movedim(axis, 0))
    x = thomas(mv(a), mv(b), mv(c), mv(d))
    return x.movedim(0, axis).contiguous()


def adi_step(T: torch.Tensor, mask: torch.Tensor, packs: CoeffPacks,
             grid: CartesianGrid, mat: Material, *, dt,
             theta: float = 0.5, t_inf: float = 0.0,
             source: torch.Tensor | None = None) -> torch.Tensor:
    """Advance one ADI step.  ``dt`` is a Python float or a 0-d tensor
    (autograd flows to it, and to T, the packs and the source); it is
    rounded to the state dtype (``step_scalars``).

    ``source``: optional volumetric heat rate [W/m^3] added explicitly to
    R0 as ``dt*S/(rho cp)`` on in-mask cells."""
    mask = mask.to(torch.bool)
    dt, inv_d2, tg, c_exp = step_scalars(T.dtype, grid, mat, dt, theta)

    lap = (masked_laplacian_1d(T, mask, 0, inv_d2[0])
           + masked_laplacian_1d(T, mask, 1, inv_d2[1])
           + masked_laplacian_1d(T, mask, 2, inv_d2[2]))
    R0 = T + c_exp * lap
    if source is not None:
        R0 = R0 + torch.where(mask, dt * source / (mat.rho * mat.cp), 0.0)

    U = implicit_sweep(R0, mask, packs.coeff[0], packs.dir_mask,
                       packs.dir_val, packs.qflux[0], tg[0], dt, t_inf, 0)
    V = implicit_sweep(U, mask, packs.coeff[1], packs.dir_mask,
                       packs.dir_val, packs.qflux[1], tg[1], dt, t_inf, 1)
    W = implicit_sweep(V, mask, packs.coeff[2], packs.dir_mask,
                       packs.dir_val, packs.qflux[2], tg[2], dt, t_inf, 2)
    return W


def apply_surface_impulse(T: torch.Tensor, mask: torch.Tensor,
                          grid: CartesianGrid, mat: Material, Q,
                          face: str = "z-") -> torch.Tensor:
    """Add a surface heat impulse ``dT = Q/(rho cp d_normal)`` [Q in J/m^2]
    on the exposed cells of the outermost slab of ``face``.  Returns the
    updated field."""
    axis = {"x": 0, "y": 1, "z": 2}[face[0]]
    # dT = Q * A_face / (rho cp V) = Q / (rho cp d_normal)
    dT = Q / (mat.rho * mat.cp * grid.spacing[axis])
    exp = exposed_face(mask.to(torch.bool), face)
    slab = torch.zeros_like(exp)
    slab.select(axis, 0 if face[1] == "-" else T.shape[axis] - 1).fill_(True)
    return torch.where(exp & slab, T + dT, T)
