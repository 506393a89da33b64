"""Layer and track-column birth schedules as activation-time arrays.

Counterpart: ``adi_thermal_fields_tpu/birth/layers.py`` —
``layer_activation_times`` (:20), ``activation_times_from_layer_times``
(:37) and ``track_activation_times`` (:54), a numpy copy.  Deposition
kinematics are data (per-cell activation times), so the event loop births
cells by elementwise updates:

* z-slab layers: layer j activates its z-cells at j*t_step;
* moving track columns: column yi of a bead activates at
  (yi - y0) * dx / speed.
"""
from __future__ import annotations

import numpy as np

__all__ = ["layer_activation_times", "track_activation_times",
           "activation_times_from_layer_times"]


def layer_activation_times(nz: int, *, iz_base: int, cells_per_layer: int,
                           n_layers: int, t_step: float,
                           t_first: float = 0.0,
                           dtype=np.float64) -> np.ndarray:
    """(nz,) activation time per z index: substrate (-inf) below ``iz_base``,
    layer j at ``t_first + j * t_step``, +inf above the last layer."""
    act = np.full(nz, np.inf, dtype=dtype)
    act[:iz_base] = -np.inf
    for j in range(n_layers):
        z0 = iz_base + j * cells_per_layer
        z1 = min(z0 + cells_per_layer, nz)
        if z0 >= nz:
            break
        act[z0:z1] = t_first + j * t_step
    return act


def activation_times_from_layer_times(nz: int, *, iz_base: int,
                                      cells_per_layer: int,
                                      layer_times, dtype=np.float64
                                      ) -> np.ndarray:
    """(nz,) activation times with an explicit per-layer time list (e.g. the
    WAAM app's area-dependent layer schedule)."""
    act = np.full(nz, np.inf, dtype=dtype)
    act[:iz_base] = -np.inf
    for j, t in enumerate(layer_times):
        z0 = iz_base + j * cells_per_layer
        z1 = min(z0 + cells_per_layer, nz)
        if z0 >= nz:
            break
        act[z0:z1] = t
    return act


def track_activation_times(ny: int, *, y_start: int, n_columns: int,
                           dt_per_column: float, t_first: float = 0.0,
                           dtype=np.float64) -> np.ndarray:
    """(ny,) activation time per y column of a moving single-track bead:
    column ``y_start + i`` activates at ``t_first + i * dt_per_column``
    (dt = dx / scan speed)."""
    act = np.full(ny, np.inf, dtype=dtype)
    for i in range(n_columns):
        y = y_start + i
        if y >= ny:
            break
        act[y] = t_first + i * dt_per_column
    return act
