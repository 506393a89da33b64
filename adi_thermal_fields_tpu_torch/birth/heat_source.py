"""Moving volumetric heat sources for welding/WAAM torches [W/m^3].

Counterpart: ``adi_thermal_fields_tpu/birth/heat_source.py`` —
``gaussian_ellipsoid_source`` (:40), ``GoldakSource`` (:55) and
``goldak_source`` (:75), in torch.  Each builds the cell centres on the
given device at the given dtype (both explicit: the JAX functions default
to float32) and returns a field for the ``source=`` argument of the steps:

* a normalized Gaussian ellipsoid;
* the Goldak double ellipsoid (the de-facto standard arc-weld model):
  front/rear semi-axes ``a_f``/``a_r`` along travel, width ``b``, depth
  ``c``, power fractions ``f_f + f_r = 2``.

The centre is a Python float triple: a moving torch rebuilds the field on
the device each call, with no host synchronisation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.grid import CartesianGrid

__all__ = ["GoldakSource", "gaussian_ellipsoid_source", "goldak_source"]

_SQRT3 = float(np.sqrt(3.0))
_NORM = 6.0 * _SQRT3 / (np.pi * np.sqrt(np.pi))


def _cell_centers(grid: CartesianGrid, device, dtype):
    def axis(n, d):
        return (torch.arange(n, dtype=dtype, device=device) + 0.5) * d
    return (axis(grid.nx, grid.dx), axis(grid.ny, grid.dy),
            axis(grid.nz, grid.dz))


def gaussian_ellipsoid_source(grid: CartesianGrid, power: float, center,
                              radii, *, device, dtype: torch.dtype
                              ) -> torch.Tensor:
    """Normalized 3-D Gaussian of total power P [W] with 1/e semi-axes
    ``radii = (rx, ry, rz)`` centred at ``center``."""
    rx, ry, rz = radii
    xs, ys, zs = _cell_centers(grid, device, dtype)
    cx, cy, cz = center
    gx = torch.exp(-((xs - cx) / rx) ** 2)[:, None, None]
    gy = torch.exp(-((ys - cy) / ry) ** 2)[None, :, None]
    gz = torch.exp(-((zs - cz) / rz) ** 2)[None, None, :]
    norm = power / (np.pi ** 1.5 * rx * ry * rz)
    return norm * gx * gy * gz


@dataclasses.dataclass(frozen=True)
class GoldakSource:
    """Goldak double-ellipsoid parameters (SI units)."""

    power: float            # absorbed power eta*V*I [W]
    a_f: float              # front semi-axis along travel [m]
    a_r: float              # rear semi-axis along travel [m]
    b: float                # half-width [m]
    c: float                # depth [m]
    travel_axis: int = 1    # torch travel direction (0=x, 1=y)

    @property
    def f_f(self) -> float:
        """Front power fraction (standard continuity choice)."""
        return 2.0 * self.a_f / (self.a_f + self.a_r)

    @property
    def f_r(self) -> float:
        return 2.0 * self.a_r / (self.a_f + self.a_r)


def goldak_source(grid: CartesianGrid, g: GoldakSource, center, *, device,
                  dtype: torch.dtype) -> torch.Tensor:
    """Goldak double-ellipsoid volumetric source field [W/m^3].

    ``q(x) = f * 6*sqrt(3)*P / (a b c pi^1.5) * exp(-3 xi^2/a^2 - 3 eta^2/b^2
    - 3 zeta^2/c^2)`` with the front (a_f, f_f) ellipsoid ahead of the torch
    along the travel axis and the rear one behind; integrates to P.
    """
    xs, ys, zs = _cell_centers(grid, device, dtype)
    cx, cy, cz = center
    X = (xs - cx)[:, None, None]
    Y = (ys - cy)[None, :, None]
    Z = (zs - cz)[None, None, :]
    along = X if g.travel_axis == 0 else Y
    across = Y if g.travel_axis == 0 else X

    common = torch.exp(-3.0 * (across / g.b) ** 2 - 3.0 * (Z / g.c) ** 2)
    q_f = (g.f_f / g.a_f) * torch.exp(-3.0 * (along / g.a_f) ** 2)
    q_r = (g.f_r / g.a_r) * torch.exp(-3.0 * (along / g.a_r) ** 2)
    q = torch.where(along >= 0.0, q_f, q_r)
    amp = _NORM * g.power / (g.b * g.c)
    return amp * q * common
