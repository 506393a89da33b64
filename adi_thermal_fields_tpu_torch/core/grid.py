"""Grid descriptors: the Cartesian voxel grid and the cylindrical grid.

Counterpart: ``adi_thermal_fields_tpu/core/grid.py`` — ``CartesianGrid``
and ``CylindricalGrid`` (:95-159), numpy-only copies (the JAX package
imports jax at package import, so the port carries its own host layers).
The solid mask is a tensor passed separately, never part of the grid.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = ["CartesianGrid", "CylindricalGrid"]


@dataclasses.dataclass(frozen=True)
class CartesianGrid:
    """3-D voxel grid with optional anisotropic spacing.

    nx, ny, nz : cell counts; dx : cell size along x [m], also the default
    for dy/dz (cubic voxels); dy, dz : cell sizes along y and z [m].
    """

    nx: int
    ny: int
    nz: int
    dx: float
    dy: float | None = None
    dz: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "nx", int(self.nx))
        object.__setattr__(self, "ny", int(self.ny))
        object.__setattr__(self, "nz", int(self.nz))
        object.__setattr__(self, "dx", float(self.dx))
        object.__setattr__(self, "dy",
                           float(self.dx if self.dy is None else self.dy))
        object.__setattr__(self, "dz",
                           float(self.dx if self.dz is None else self.dz))

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def spacing(self) -> tuple[float, float, float]:
        """Per-axis cell sizes (dx, dy, dz) [m]."""
        return (self.dx, self.dy, self.dz)

    @property
    def ncells(self) -> int:
        return self.nx * self.ny * self.nz


@dataclasses.dataclass(frozen=True)
class CylindricalGrid:
    """Cylindrical (r, phi, z) grid, optionally annular.

    Cell-center radii are ``r_i = r_inner + (i + 0.5) dr``; the inner
    boundary sits at the inner face of cell 0 (``r_inner``; the symmetry
    axis when ``r_inner == 0``) and the outer boundary at the outer face of
    the last cell.  ``dphi = 2*pi/nphi`` (full periodic azimuth).
    """

    nr: int
    nphi: int
    nz: int
    dr: float
    dz: float
    r_inner: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "nr", int(self.nr))
        object.__setattr__(self, "nphi", int(self.nphi))
        object.__setattr__(self, "nz", int(self.nz))
        object.__setattr__(self, "dr", float(self.dr))
        object.__setattr__(self, "dz", float(self.dz))
        object.__setattr__(self, "r_inner", float(self.r_inner))

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nr, self.nphi, self.nz)

    @property
    def ncells(self) -> int:
        return self.nr * self.nphi * self.nz

    @property
    def dphi(self) -> float:
        return 2.0 * np.pi / max(1, self.nphi)

    @property
    def is_annular(self) -> bool:
        return self.r_inner > 0.0

    @cached_property
    def r(self) -> np.ndarray:
        """Cell-center radii, shape (nr,)."""
        return self.r_inner + (np.arange(self.nr, dtype=np.float64)
                               + 0.5) * self.dr

    @cached_property
    def r_imh(self) -> np.ndarray:
        """Inner-face radii r_{i-1/2}, shape (nr,)."""
        return self.r - 0.5 * self.dr

    @cached_property
    def r_iph(self) -> np.ndarray:
        """Outer-face radii r_{i+1/2}, shape (nr,)."""
        return self.r + 0.5 * self.dr

    @property
    def r_outer_face(self) -> float:
        """Outer physical boundary radius (outer face of the last cell)."""
        return float(self.r_inner + self.nr * self.dr)

    @property
    def height(self) -> float:
        return self.nz * self.dz
