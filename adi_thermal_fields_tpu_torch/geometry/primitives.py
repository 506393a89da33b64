"""Procedural triangle meshes.

Counterpart: ``adi_thermal_fields_tpu/geometry/primitives.py::box_mesh``
(copy).
"""
from __future__ import annotations

import numpy as np

from .stl import TriMesh

__all__ = ["box_mesh"]


def _quads_to_tris(quads: np.ndarray) -> np.ndarray:
    """(N, 4, 3) quads -> (2N, 3, 3) triangles."""
    a, b, c, d = quads[:, 0], quads[:, 1], quads[:, 2], quads[:, 3]
    return np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)])


def box_mesh(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)) -> TriMesh:
    sx, sy, sz = np.asarray(size, float) / 2.0
    cx, cy, cz = center
    # 8 corners
    p = np.array([[x, y, z] for x in (cx - sx, cx + sx)
                  for y in (cy - sy, cy + sy)
                  for z in (cz - sz, cz + sz)])
    # outward-wound quads
    quads = np.array([
        [p[0], p[1], p[3], p[2]],  # x-
        [p[4], p[6], p[7], p[5]],  # x+
        [p[0], p[4], p[5], p[1]],  # y-
        [p[2], p[3], p[7], p[6]],  # y+
        [p[0], p[2], p[6], p[4]],  # z-
        [p[1], p[5], p[7], p[3]],  # z+
    ])
    return TriMesh(_quads_to_tris(quads))
