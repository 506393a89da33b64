"""Spiral/ring deposition schedules as precomputed activation-time arrays.

Counterpart: ``adi_thermal_fields_tpu/birth/spiral.py`` (:31-79), a
numpy-only copy.  The whole deposition kinematics is one float64
``activation_time[nphi, nz]`` array kept on the host: the active mask at
time t is ``activation_time < t`` (strict) and the columns born in a step
are ``t_prev <= activation_time < t_next`` (half-open).  Only the (nphi,
nz) masks go to the device, so births need no device sync.

Kinematics (loops_per_layer = q, one loop per ``tau_dep``): layer L
occupies z-cells [iz_base + L*layer_cells, ...); its phi column i
activates at ``(L*q + i/nphi) * tau_dep`` (column 0 at layer start).
"""
from __future__ import annotations

import numpy as np

from ..core.grid import CylindricalGrid

__all__ = ["spiral_activation_times", "ring_activation_times", "active_at",
           "newborn_between"]


def spiral_activation_times(grid: CylindricalGrid, *, iz_base: int,
                            layer_cells: int, n_layers: int,
                            tau_dep: float, loops_per_layer: int = 1,
                            dtype=np.float64) -> np.ndarray:
    """(nphi, nz) activation times; substrate rows (iz < iz_base) are -inf
    and never-deposited rows are +inf."""
    nphi, nz = grid.nphi, grid.nz
    act = np.full((nphi, nz), np.inf, dtype=dtype)
    act[:, :iz_base] = -np.inf
    col = np.arange(nphi, dtype=dtype) / nphi  # fraction of a loop
    for layer in range(n_layers):
        t0 = layer * loops_per_layer * tau_dep
        iz0 = iz_base + layer * layer_cells
        iz1 = min(iz0 + layer_cells, nz)
        if iz0 >= nz:
            break
        act[:, iz0:iz1] = (t0 + col * tau_dep)[:, None]
    return act


def ring_activation_times(grid: CylindricalGrid, *, iz_base: int,
                          layer_cells: int, n_layers: int,
                          tau_per_layer: float,
                          dtype=np.float64) -> np.ndarray:
    """(nphi, nz) activation times for instant full-ring layers: layer L's
    cells all activate at ``L * tau_per_layer``."""
    nphi, nz = grid.nphi, grid.nz
    act = np.full((nphi, nz), np.inf, dtype=dtype)
    act[:, :iz_base] = -np.inf
    for layer in range(n_layers):
        iz0 = iz_base + layer * layer_cells
        iz1 = min(iz0 + layer_cells, nz)
        if iz0 >= nz:
            break
        act[:, iz0:iz1] = layer * tau_per_layer
    return act


def active_at(activation_time: np.ndarray, t: float) -> np.ndarray:
    """Active (nphi, nz) mask at time t (strict: a column is active once
    the nozzle has swept past its leading edge)."""
    return activation_time < t


def newborn_between(activation_time: np.ndarray, t_prev: float,
                    t_next: float) -> np.ndarray:
    """Columns that activate in the half-open step interval [t_prev,
    t_next) (t = 0 births are included at the first step)."""
    return (activation_time >= t_prev) & (activation_time < t_next)
