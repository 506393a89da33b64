"""Cartesian voxel grid descriptor.

Counterpart: ``adi_thermal_fields_tpu/core/grid.py::CartesianGrid`` — a
numpy-only copy (the JAX package imports jax at package import, so the port
carries its own host layers).  The solid mask is a tensor passed separately,
never part of the grid.
"""
from __future__ import annotations

import dataclasses

__all__ = ["CartesianGrid"]


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
