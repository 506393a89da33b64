"""Triangle-mesh voxelization (vectorized numpy).

Counterpart: ``adi_thermal_fields_tpu/geometry/voxelize.py`` —
``voxelize_solid`` (its numpy path; the native C++ kernel it prefers is
bit-identical by ``tests/test_native.py`` and is not ported yet),
``voxelize_shell``, ``subdivided_triangles``, ``grid_from_mesh`` and
``auto_cell_size`` (copies).

* ``voxelize_solid``: even-odd parity fill — for every (x, y) cell-center
  column, count triangle crossings below each cell center along +z; odd
  parity = inside.
* ``voxelize_shell``: mark every voxel touched by a triangle (subdivide until
  sub-triangle footprints fit a voxel, bin their centroids).
"""
from __future__ import annotations

import math

import numpy as np

from .stl import TriMesh

__all__ = ["voxelize_solid", "voxelize_shell", "auto_cell_size",
           "grid_from_mesh", "subdivided_triangles"]


def auto_cell_size(mesh: TriMesh, dx: float, max_voxels: int = 12_000_000,
                   dz: float | None = None) -> float:
    """Coarsen the LATERAL dx until the bounding-box voxel count fits the
    budget.  ``dz``: fixed vertical cell size of an anisotropic grid — the
    budget then counts (ext/dx, ext/dx, ext/dz) voxels and only dx
    coarsens."""
    ext = mesh.extents
    while True:
        d = np.array([dx, dx, dx if dz is None else dz])
        n = int(np.prod(np.maximum(np.ceil(ext / d), 1)))
        if n <= max_voxels:
            return dx
        dx *= (n / max_voxels) ** (1.0 / (3.0 if dz is None else 2.0)) * 1.0001


def _spacing3(dx) -> np.ndarray:
    """Normalize a scalar or 3-sequence cell size to (dx, dy, dz)."""
    d = np.broadcast_to(np.asarray(dx, float), (3,)).copy()
    if (d <= 0).any():
        raise ValueError(f"cell sizes must be positive, got {d}")
    return d


def grid_from_mesh(mesh: TriMesh, dx, pad_cells=1
                   ) -> tuple[np.ndarray, tuple[int, int, int]]:
    """(origin, (nx, ny, nz)) covering the mesh bounds with padding; the
    origin is the min corner of voxel (0,0,0).  ``dx``: scalar or per-axis
    (dx, dy, dz); ``pad_cells``: scalar or per-axis cell counts."""
    d = _spacing3(dx)
    pad = np.broadcast_to(np.asarray(pad_cells, int), (3,))
    lo, hi = mesh.bounds
    origin = lo - pad * d
    dims = np.ceil((hi - origin) / d).astype(int) + pad
    return origin, (int(dims[0]), int(dims[1]), int(dims[2]))


def voxelize_solid(mesh: TriMesh, dx, origin=None, dims=None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Even-odd parity solid voxelization.  Returns (mask, origin).
    ``dx``: scalar (cubic voxels) or per-axis (dx, dy, dz)."""
    if origin is None or dims is None:
        origin, dims = grid_from_mesh(mesh, dx)
    d = _spacing3(dx)
    origin = np.asarray(origin, float)
    nx, ny, nz = dims
    dx, dy, dz = d
    tri = mesh.triangles
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]

    # Parity at cell centers along +z columns through (xc, yc).  The ray
    # lattice carries a tiny irrational jitter so rays never pass exactly
    # through mesh edges or vertices (ambiguous even-odd counts); the
    # sampling bias is ~1e-4 of a cell.
    jx = 1.1283791670955126e-4 * dx
    jy = 0.7071067811865476e-4 * dy
    xc = origin[0] + (np.arange(nx) + 0.5) * dx + jx
    yc = origin[1] + (np.arange(ny) + 0.5) * dy + jy
    zc = origin[2] + (np.arange(nz) + 0.5) * dz

    counts = np.zeros((nx, ny, nz), np.int64)

    for t in range(len(tri)):
        a, b, c = v0[t], v1[t], v2[t]
        # candidate columns: xy-bbox of the triangle
        i0 = max(0, int(math.floor((min(a[0], b[0], c[0]) - origin[0]) / dx - 0.5)))
        i1 = min(nx - 1, int(math.ceil((max(a[0], b[0], c[0]) - origin[0]) / dx - 0.5)))
        j0 = max(0, int(math.floor((min(a[1], b[1], c[1]) - origin[1]) / dy - 0.5)))
        j1 = min(ny - 1, int(math.ceil((max(a[1], b[1], c[1]) - origin[1]) / dy - 0.5)))
        if i1 < i0 or j1 < j0:
            continue
        X, Y = np.meshgrid(xc[i0:i1 + 1], yc[j0:j1 + 1], indexing="ij")
        # barycentric test in the xy-projection
        det = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1])
        if abs(det) < 1e-300:
            continue
        w0 = ((b[1] - c[1]) * (X - c[0]) + (c[0] - b[0]) * (Y - c[1])) / det
        w1 = ((c[1] - a[1]) * (X - c[0]) + (a[0] - c[0]) * (Y - c[1])) / det
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
        if not inside.any():
            continue
        z_hit = w0 * a[2] + w1 * b[2] + w2 * c[2]
        below = z_hit[:, :, None] < zc[None, None, :]
        counts[i0:i1 + 1, j0:j1 + 1, :] += (inside[:, :, None] & below)

    return (counts % 2).astype(bool), origin


def subdivided_triangles(tri: np.ndarray, max_edge: float,
                         max_level: int = 6) -> tuple[np.ndarray, np.ndarray]:
    """Uniformly subdivide each triangle until its longest edge is below
    ``max_edge`` (capped at 4**max_level pieces).  Returns (sub_triangles,
    parent_index)."""
    tri = np.asarray(tri, float)
    edges = np.stack([
        np.linalg.norm(tri[:, 0] - tri[:, 1], axis=1),
        np.linalg.norm(tri[:, 1] - tri[:, 2], axis=1),
        np.linalg.norm(tri[:, 2] - tri[:, 0], axis=1),
    ], axis=1).max(axis=1)
    levels = np.clip(np.ceil(np.log2(np.maximum(edges / max_edge, 1.0))
                             ).astype(int), 0, max_level)
    out_t, out_p = [], []
    parents = np.arange(len(tri))
    for lv in range(max_level + 1):
        sel = levels == lv
        if not sel.any():
            continue
        t = tri[sel]
        p = parents[sel]
        for _ in range(lv):
            a, b, c = t[:, 0], t[:, 1], t[:, 2]
            ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
            t = np.concatenate([
                np.stack([a, ab, ca], axis=1),
                np.stack([ab, b, bc], axis=1),
                np.stack([ca, bc, c], axis=1),
                np.stack([ab, bc, ca], axis=1),
            ])
            p = np.tile(p, 4)
        out_t.append(t)
        out_p.append(p)
    return np.concatenate(out_t), np.concatenate(out_p)


def voxelize_shell(mesh: TriMesh, dx, origin=None, dims=None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Mark voxels touched by the surface (subdivide + centroid binning).
    ``dx``: scalar or per-axis (dx, dy, dz)."""
    if origin is None or dims is None:
        origin, dims = grid_from_mesh(mesh, dx)
    d = _spacing3(dx)
    origin = np.asarray(origin, float)
    sub, _ = subdivided_triangles(mesh.triangles, max_edge=0.5 * float(d.min()))
    cent = sub.mean(axis=1)
    idx = np.floor((cent - origin) / d).astype(int)
    ok = np.all((idx >= 0) & (idx < np.asarray(dims)), axis=1)
    idx = idx[ok]
    mask = np.zeros(dims, bool)
    mask[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return mask, origin
