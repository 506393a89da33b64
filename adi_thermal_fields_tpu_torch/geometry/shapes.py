"""Voxel mask builders for canonical shapes (host-side numpy).

Counterpart: ``adi_thermal_fields_tpu/geometry/shapes.py`` —
``cylinder_mask`` (:14) and ``plate_mask`` (:33), a numpy copy.
"""
from __future__ import annotations

import numpy as np

__all__ = ["cylinder_mask", "plate_mask"]


def cylinder_mask(nx: int, ny: int, nz: int, dx: float, R: float,
                  axis: int = 2) -> np.ndarray:
    """Boolean mask of a cylinder of radius R aligned with ``axis``; the
    cross-section is centered in the two transverse dimensions and tested at
    cell centers (<= R)."""
    dims = [nx, ny, nz]
    trans = [d for d in range(3) if d != axis]
    n0, n1 = dims[trans[0]], dims[trans[1]]
    c0, c1 = n0 / 2.0, n1 / 2.0
    x0 = (np.arange(n0) + 0.5 - c0) * dx
    x1 = (np.arange(n1) + 0.5 - c1) * dx
    X0, X1 = np.meshgrid(x0, x1, indexing="ij")
    sec = np.sqrt(X0 ** 2 + X1 ** 2) <= R + 1e-12
    mask = np.zeros((nx, ny, nz), bool)
    view = np.moveaxis(mask, axis, -1)
    view[...] = sec[:, :, None]
    return mask


def plate_mask(nx: int, ny: int, nz: int, plate_cells: int) -> np.ndarray:
    """Solid plate occupying the bottom ``plate_cells`` z-slabs."""
    mask = np.zeros((nx, ny, nz), bool)
    mask[:, :, :plate_cells] = True
    return mask
