"""Cylindrical (r, phi, z) ADI time step with periodic phi.

Counterpart: ``adi_thermal_fields_tpu/step/cylindrical.py`` — ``RobinBC``
and ``ZFaceBC`` (:52-73, copied), the explicit operators ``apply_Lr``,
``apply_Lphi``, ``apply_Lz``, ``r_operator`` and ``z_operator``
(:88-213), the unit-fac geometry ``_r_geometry``/``_z_geometry``
(:126-182, numpy, copied), the implicit sweeps (:216-325), ``adi_step``
(:351) and the ambient-clamp element-birth wrapper ``adi_step_masked``
(:412).

Finite-volume radial operator with Robin at the outer face (and on
annular grids optionally at the inner face) by ghost-cell elimination, a
periodic phi solve, and a z sweep with Neumann-0 / Dirichlet / Robin ends.
``scheme="be"``: backward Euler chained r -> phi -> z with the source
added up front; ``scheme="douglas"``: Douglas-Gunn with the BC-consistent
affine explicit operators.

Two implementations:

* ``"kernels"`` (the JAX ``"pallas"`` route): K12 along r, K14 along phi
  (not launched when nphi == 1), K13 along z in the natural layout with
  the Dirichlet end rows written into its rhs first; K12's and K13's
  row tables (both K13t) and K14's ring table (K14t) built once per dt
  and cached;
* ``"reference"`` (the JAX ``"xla"`` route): ``thomas`` with per-row
  coefficient vectors along r and z, ``phi_solve_spectral`` along phi.

The sweeps' coefficient vectors are built as the JAX package builds them:
``fac`` rounded to the field's dtype, then ``-fac*ge_a``, ``1 +
fac*(...)`` and ``fac*rob_rhs`` in that dtype.  They depend only on the
grid, material, BCs, ``dt`` and dtype, and are cached per device.  ``dt``
is a Python float.  Float32 and float64 states run; other dtypes raise
``NotImplementedError``.  Not ported: ``pad_to_tile``, ``padded_cyl_shape``
and ``pad_cyl_domain`` (TPU tile padding, inert by the JAX package's own
test).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.grid import CylindricalGrid
from ..core.material import Material
from ..solvers.const_sweeps import (const_sweep_strided, const_sweep_table,
                                    const_sweep_z, cyclic_const_phi,
                                    cyclic_const_phi_table)
from ..solvers.spectral import phi_eigenvalue_factors, phi_solve_spectral
from ..solvers.thomas import thomas

__all__ = ["RobinBC", "ZFaceBC", "adi_step", "adi_step_masked", "apply_Lr",
           "apply_Lphi", "apply_Lz", "r_operator", "z_operator"]

IMPLEMENTATIONS = ("kernels", "reference")


@dataclasses.dataclass(frozen=True)
class RobinBC:
    """Convective (Robin) boundary: -k dT/dn = h (T - T_inf)."""

    h: float
    T_inf: float


@dataclasses.dataclass(frozen=True)
class ZFaceBC:
    """Axial end-face BCs; kinds in {"neumann0", "dirichlet", "robin"}."""

    kind_bot: str = "neumann0"
    kind_top: str = "robin"
    h_bot: float = 0.0
    h_top: float = 0.0
    T_inf_bot: float = 20.0
    T_inf_top: float = 20.0
    T_bot: float = 20.0
    T_top: float = 20.0


def _vec(values, dtype, device):
    """A float64 numpy vector rounded to ``dtype`` on ``device``."""
    return torch.as_tensor(np.asarray(values, np.float64),
                           device=device).to(dtype)


# --------------------------------------------------------------------------
# Explicit operators (the Douglas scheme's; alpha applied by the caller for
# the apply_L* forms)
# --------------------------------------------------------------------------

def _r_vectors(grid: CylindricalGrid, dtype, device):
    r = _vec(grid.r, dtype, device)[:, None, None]
    r_imh = _vec(np.maximum(grid.r_imh, 1e-15), dtype, device)[:, None, None]
    r_iph = _vec(grid.r_iph, dtype, device)[:, None, None]
    return r, r_imh, r_iph


def apply_Lr(T: torch.Tensor, grid: CylindricalGrid) -> torch.Tensor:
    """Finite-volume radial Laplacian with zero-flux faces at both radial
    ends."""
    dr = grid.dr
    r, r_imh, r_iph = _r_vectors(grid, T.dtype, T.device)
    Trp = torch.cat([T[1:], T[-1:]], 0)
    Trm = torch.cat([T[:1], T[:-1]], 0)
    flux_p = r_iph * (Trp - T) / dr
    flux_m = r_imh * (T - Trm) / dr
    return (flux_p - flux_m) / (r * dr)


def apply_Lphi(T: torch.Tensor, grid: CylindricalGrid) -> torch.Tensor:
    """Periodic second difference in phi over r^2 dphi^2; axis row zeroed on
    full-disk grids for regularity."""
    if grid.nphi == 1:
        return torch.zeros_like(T)
    r, _, _ = _r_vectors(grid, T.dtype, T.device)
    Tph = torch.roll(T, -1, 1)
    Tmh = torch.roll(T, 1, 1)
    out = (Tph - 2.0 * T + Tmh) / (r * r * grid.dphi * grid.dphi)
    if not grid.is_annular:
        out[0] = 0.0
    return out


def apply_Lz(T: torch.Tensor, grid: CylindricalGrid) -> torch.Tensor:
    """Axial second difference with Neumann-0 ghost cells at both ends."""
    dz = grid.dz
    Tzp = torch.cat([T[:, :, 1:], T[:, :, -1:]], 2)
    Tzm = torch.cat([T[:, :, :1], T[:, :, :-1]], 2)
    return (Tzp - 2.0 * T + Tzm) / (dz * dz)


# --------------------------------------------------------------------------
# Unit-fac geometry (numpy; shared by the implicit sweeps and the affine
# explicit operators)
# --------------------------------------------------------------------------

def _r_geometry(grid: CylindricalGrid, mat: Material,
                robin_outer: RobinBC | None, robin_inner: RobinBC | None):
    """Radial off-diagonal couplings, Robin diagonal additions and Robin
    T_inf source per unit fac."""
    nr, dr = grid.nr, grid.dr
    r = np.maximum(np.asarray(grid.r, np.float64), 1e-15)
    r_imh = np.maximum(np.asarray(grid.r_imh, np.float64), 1e-15)
    r_iph = np.asarray(grid.r_iph, np.float64)
    ge_a = r_imh / (r * dr * dr)
    ge_c = r_iph / (r * dr * dr)
    ge_a[0] = 0.0
    ge_c[nr - 1] = 0.0
    ge_rob = np.zeros(nr)
    rob_rhs = np.zeros(nr)
    if grid.is_annular and robin_inner is not None and robin_inner.h != 0.0:
        g_in = (r_imh[0] * (robin_inner.h / mat.k)) / (r[0] * dr)
        ge_rob[0] += g_in
        rob_rhs[0] += g_in * robin_inner.T_inf
    if robin_outer is not None and robin_outer.h != 0.0:
        g_out = (r_iph[nr - 1] * (robin_outer.h / mat.k)) / (r[nr - 1] * dr)
        ge_rob[nr - 1] += g_out
        rob_rhs[nr - 1] += g_out * robin_outer.T_inf
    return ge_a, ge_c, ge_rob, rob_rhs


def _z_geometry(grid: CylindricalGrid, mat: Material, zbc: ZFaceBC):
    """Axial geometry per 1/dz^2 including the end-BC rows; Dirichlet rows
    come out all-zero (identity rows pinned by the z sweep's rhs)."""
    nz, dz = grid.nz, grid.dz
    ge_a = np.ones(nz)
    ge_c = np.ones(nz)
    ge_b = np.full(nz, 2.0)
    rob_rhs = np.zeros(nz)
    ge_a[0] = 0.0
    ge_c[nz - 1] = 0.0
    dir_rows = []

    def end_row(idx, kind, h, t_inf, t_dir):
        if kind == "neumann0":
            ge_b[idx] = 1.0
        elif kind == "dirichlet":
            ge_a[idx] = 0.0
            ge_c[idx] = 0.0
            ge_b[idx] = 0.0
            dir_rows.append((idx, float(t_dir)))
        elif kind == "robin":
            beta = h / mat.k
            ge_b[idx] = 1.0 + beta * dz
            rob_rhs[idx] = beta * dz * t_inf
        else:
            raise ValueError(f"unknown z-face BC kind: {kind!r}")

    end_row(0, zbc.kind_bot, zbc.h_bot, zbc.T_inf_bot, zbc.T_bot)
    end_row(nz - 1, zbc.kind_top, zbc.h_top, zbc.T_inf_top, zbc.T_top)
    return ge_a, ge_c, ge_b, rob_rhs, dir_rows


@functools.lru_cache(maxsize=64)
def _r_operator_columns(grid, mat, robin_outer, robin_inner, dtype, device):
    ge_a, ge_c, ge_rob, rob_rhs = _r_geometry(grid, mat, robin_outer,
                                              robin_inner)
    al = mat.alpha
    return tuple(_vec(al * v, dtype, device)[:, None, None]
                 for v in (ge_a, ge_c, ge_a + ge_c + ge_rob, rob_rhs))


@functools.lru_cache(maxsize=64)
def _z_operator_rows(grid, mat, zbc, dtype, device):
    ge_a, ge_c, ge_b, rob_rhs, _ = _z_geometry(grid, mat, zbc)
    al = mat.alpha / (grid.dz * grid.dz)
    return tuple(_vec(al * v, dtype, device)[None, None, :]
                 for v in (ge_a, ge_c, ge_b, rob_rhs))


def r_operator(T: torch.Tensor, grid: CylindricalGrid, mat: Material,
               robin_outer: RobinBC | None,
               robin_inner: RobinBC | None = None) -> torch.Tensor:
    """Affine explicit radial operator ``alpha*(L_r T + s)`` [K/s]: the
    exact discrete operator whose implicit solve is the r sweep (Robin rows
    included), as Douglas-Gunn consistency requires."""
    ca, cc, cb, cr = _r_operator_columns(grid, mat, robin_outer, robin_inner,
                                         T.dtype, T.device)
    Tdn = torch.cat([torch.zeros_like(T[:1]), T[:-1]], 0)
    Tup = torch.cat([T[1:], torch.zeros_like(T[:1])], 0)
    return ca * Tdn + cc * Tup - cb * T + cr


def z_operator(T: torch.Tensor, grid: CylindricalGrid, mat: Material,
               zbc: ZFaceBC) -> torch.Tensor:
    """Affine explicit axial operator ``alpha*(L_z T + s)`` [K/s] consistent
    with the z sweep's matrices (Dirichlet rows contribute zero rate)."""
    ra, rc, rb, rr = _z_operator_rows(grid, mat, zbc, T.dtype, T.device)
    Tdn = torch.cat([torch.zeros_like(T[:, :, :1]), T[:, :, :-1]], 2)
    Tup = torch.cat([T[:, :, 1:], torch.zeros_like(T[:, :, :1])], 2)
    return ra * Tdn + rc * Tup - rb * T + rr


# --------------------------------------------------------------------------
# Implicit sweeps
# --------------------------------------------------------------------------

def _coefficients(fac, ge_a, ge_c, ge_b, rob_rhs, dtype, device):
    """(a, b, c, radd) of the rows, computed in ``dtype`` from ``fac``
    rounded to it (on the CPU, then moved: the same IEEE operations)."""
    fac = torch.tensor(fac, dtype=dtype)
    v = (lambda x: _vec(x, dtype, "cpu"))
    return tuple(t.to(device) for t in (-fac * v(ge_a), 1.0 + fac * v(ge_b),
                                        -fac * v(ge_c), fac * v(rob_rhs)))


@functools.lru_cache(maxsize=64)
def _r_coefficients(grid, mat, robin_outer, robin_inner, theta_dt, dtype,
                    device):
    ge_a, ge_c, ge_rob, rob_rhs = _r_geometry(grid, mat, robin_outer,
                                              robin_inner)
    return _coefficients(theta_dt * mat.alpha, ge_a, ge_c,
                         ge_a + ge_c + ge_rob, rob_rhs, dtype, device)


@functools.lru_cache(maxsize=64)
def _r_table(grid, mat, robin_outer, robin_inner, theta_dt, dtype, device):
    """K12's table of the r rows' factors (``const_sweep_table``), kept
    beside ``_r_coefficients`` under the same key: a run of steps at one
    dt builds it once."""
    a, b, c, _ = _r_coefficients(grid, mat, robin_outer, robin_inner,
                                 theta_dt, dtype, device)
    return const_sweep_table(a, b, c)


@functools.lru_cache(maxsize=64)
def _z_coefficients(grid, mat, zbc, theta_dt, dtype, device):
    ge_a, ge_c, ge_b, rob_rhs, dir_rows = _z_geometry(grid, mat, zbc)
    fac = theta_dt * mat.alpha / (grid.dz * grid.dz)
    return (_coefficients(fac, ge_a, ge_c, ge_b, rob_rhs, dtype, device),
            tuple(dir_rows))


@functools.lru_cache(maxsize=64)
def _z_table(grid, mat, zbc, theta_dt, dtype, device):
    """K13's table of the z rows' factors (``const_sweep_table``), kept
    beside ``_z_coefficients`` under the same key: a run of steps at one
    dt builds it once."""
    (a, b, c, _), _ = _z_coefficients(grid, mat, zbc, theta_dt, dtype,
                                      device)
    return const_sweep_table(a, b, c)


@functools.lru_cache(maxsize=64)
def _phi_fac(grid, mat, theta, dt, dtype, device):
    """K14's fac per ring: theta*alpha*dt/(r_i^2 dphi^2), axis row 0."""
    return (theta * mat.alpha * dt
            * phi_eigenvalue_factors(grid, dtype)).to(device)


@functools.lru_cache(maxsize=64)
def _phi_table(grid, mat, theta, dt, dtype, device):
    """K14's table of the rings' factors (``cyclic_const_phi_table``),
    kept beside ``_phi_fac`` under the same key: a run of steps at one dt
    builds it once."""
    return cyclic_const_phi_table(
        _phi_fac(grid, mat, theta, dt, dtype, device), grid.nphi)


def _col(v):
    return v[:, None, None]


def _r_sweep(rhs, grid, mat, theta_dt, robin_outer, robin_inner,
             implementation):
    """Solve (I - theta*dt*alpha*L_r) x = rhs along axis 0."""
    key = (grid, mat, robin_outer, robin_inner, theta_dt, rhs.dtype,
           rhs.device)
    a, b, c, radd = _r_coefficients(*key)
    if implementation == "kernels":
        return const_sweep_strided(rhs, a, b, c, radd, _r_table(*key))
    return thomas(_col(a), _col(b), _col(c), rhs + _col(radd))


def _z_sweep(rhs, grid, mat, theta_dt, zbc, implementation):
    """Solve (I - theta*dt*alpha*L_z) x = rhs along axis 2 with end BCs:
    Dirichlet rows take their value from the rhs."""
    (a, b, c, radd), dir_rows = _z_coefficients(grid, mat, zbc, theta_dt,
                                                rhs.dtype, rhs.device)
    if implementation == "kernels":
        if dir_rows:
            rhs = rhs.clone()
            for idx, t_dir in dir_rows:
                rhs[:, :, idx] = t_dir
        return const_sweep_z(rhs, a, b, c, radd,
                             _z_table(grid, mat, zbc, theta_dt, rhs.dtype,
                                      rhs.device))
    d = rhs.movedim(2, 0)                        # (nz, nr, nphi)
    if dir_rows:
        d = d.clone()
        for idx, t_dir in dir_rows:
            d[idx] = t_dir
    x = thomas(_col(a), _col(b), _col(c), d + _col(radd))
    return x.movedim(0, 2).contiguous()


def _phi_solve(X, grid, mat, theta, dt, implementation):
    """Periodic phi solve: K14, or the spectral solve; nphi == 1 is the
    identity."""
    if grid.nphi == 1:
        return X
    if implementation == "kernels":
        key = (grid, mat, theta, dt, X.dtype, X.device)
        return cyclic_const_phi(X, _phi_fac(*key), _phi_table(*key))
    return phi_solve_spectral(X, grid, mat, theta, dt)


# --------------------------------------------------------------------------
# Time steps
# --------------------------------------------------------------------------

def adi_step(T: torch.Tensor, grid: CylindricalGrid, mat: Material, *,
             dt: float, robin_outer: RobinBC, zbc: ZFaceBC,
             robin_inner: RobinBC | None = None,
             source: torch.Tensor | None = None, scheme: str = "be",
             theta: float = 0.5,
             implementation: str = "kernels") -> torch.Tensor:
    """One cylindrical ADI step of an (nr, nphi, nz) field.

    scheme="be": backward Euler, r -> phi -> z implicit solves with the
    volumetric source [W/m^3] added up front.  scheme="douglas":
    Douglas-Gunn with stabilizing correction, sweeps at ``th*dt`` with
    ``th = theta`` if ``0 < theta <= 1`` else 0.5."""
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {IMPLEMENTATIONS}, "
                         f"got {implementation!r}")
    if T.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"cylindrical step: {T.dtype} states are not ported (float32 or "
            "float64; bf16 needs stochastic rounding)")
    if tuple(T.shape) != grid.shape:
        raise ValueError(f"T shape {tuple(T.shape)} != grid shape "
                         f"{grid.shape}")
    T = T.contiguous()
    impl = implementation
    if scheme == "be":
        R0 = T if source is None else T + dt * source / (mat.rho * mat.cp)
        X = _r_sweep(R0, grid, mat, dt, robin_outer, robin_inner, impl)
        X = _phi_solve(X, grid, mat, 1.0, dt, impl)
        return _z_sweep(X, grid, mat, dt, zbc, impl)
    if scheme != "douglas":
        raise ValueError(f"unknown scheme: {scheme!r}")

    th = theta if 0.0 < theta <= 1.0 else 0.5
    # BC-consistent affine operators [K/s]: the same discrete operators as
    # the implicit solves, so the corrections cancel at steady state
    Lr = r_operator(T, grid, mat, robin_outer, robin_inner)
    Lp = mat.alpha * apply_Lphi(T, grid)
    Lz = z_operator(T, grid, mat, zbc)
    Y0 = T + dt * (Lr + Lp + Lz)
    if source is not None:
        Y0 = Y0 + dt * source / (mat.rho * mat.cp)
    Y1 = _r_sweep(Y0 - th * dt * Lr, grid, mat, th * dt, robin_outer,
                  robin_inner, impl)
    Y2 = _phi_solve(Y1 - th * dt * Lp, grid, mat, th, dt, impl)
    return _z_sweep(Y2 - th * dt * Lz, grid, mat, th * dt, zbc, impl)


def adi_step_masked(T: torch.Tensor, grid: CylindricalGrid, mat: Material, *,
                    dt: float, robin_outer: RobinBC, zbc: ZFaceBC,
                    active: torch.Tensor, robin_inner: RobinBC | None = None,
                    robin_void: RobinBC | None = None,
                    source: torch.Tensor | None = None, scheme: str = "be",
                    theta: float = 0.5,
                    implementation: str = "kernels") -> torch.Tensor:
    """Element-birth wrapper: void cells clamped to ``robin_void.T_inf``
    before and after the unmasked step; inactive cells of radial row 0
    track the inner ambient."""
    rin = robin_inner if robin_inner is not None else robin_outer
    rvd = robin_void if robin_void is not None else robin_outer
    ambient_void = rvd.T_inf
    active = active.to(torch.bool)
    T_work = torch.where(active, T, ambient_void)
    T1 = adi_step(T_work, grid, mat, dt=dt, robin_outer=robin_outer,
                  zbc=zbc, robin_inner=robin_inner, source=source,
                  scheme=scheme, theta=theta, implementation=implementation)
    T1 = torch.where(active, T1, ambient_void)
    T1[0] = torch.where(active[0], T1[0], rin.T_inf)
    return T1
