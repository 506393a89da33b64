"""Per-slice geometry from the triangle mesh: section perimeter/area and
per-slice lateral-area correction scales.

Counterpart: ``adi_thermal_fields_tpu/geometry/slices.py`` —
``section_segments``, ``slice_perimeter_area`` and
``per_slice_perimeter_scale``, a numpy copy.  Each z-plane section is
computed directly from triangle-plane crossings, vectorized over
triangles.  Segments are oriented by the parent triangle's outward normal
(direction = n x z_hat), so the signed shoelace sum gives the enclosed
area without stitching loops.
"""
from __future__ import annotations

import numpy as np

from .perimeter import digital_perimeter
from .stl import TriMesh

__all__ = ["section_segments", "slice_perimeter_area",
           "per_slice_perimeter_scale"]


def section_segments(mesh: TriMesh, z: float) -> np.ndarray:
    """Oriented intersection segments of the mesh with the plane z=const:
    (M, 2, 2) array of xy endpoints (p1 -> p2 with material on the left)."""
    tri = mesh.triangles
    zs = tri[:, :, 2]
    below = zs < z
    n_below = below.sum(axis=1)
    crossing = (n_below == 1) | (n_below == 2)
    if not crossing.any():
        return np.zeros((0, 2, 2))
    tri = tri[crossing]
    below = below[crossing]
    n_below = n_below[crossing]
    normals = mesh.face_normals[crossing]

    # roll vertices so the odd one (alone on its side) is vertex 0
    odd_is_below = n_below == 1
    odd_idx = np.where(odd_is_below[:, None], below, ~below).argmax(axis=1)
    idx = (odd_idx[:, None] + np.arange(3)[None, :]) % 3
    tri = np.take_along_axis(tri, idx[:, :, None], axis=1)

    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    # edges a-b and a-c cross the plane
    tb = (z - a[:, 2]) / np.where(np.abs(b[:, 2] - a[:, 2]) > 1e-300,
                                  b[:, 2] - a[:, 2], 1e-300)
    tc = (z - a[:, 2]) / np.where(np.abs(c[:, 2] - a[:, 2]) > 1e-300,
                                  c[:, 2] - a[:, 2], 1e-300)
    p = a[:, :2] + tb[:, None] * (b[:, :2] - a[:, :2])
    q = a[:, :2] + tc[:, None] * (c[:, :2] - a[:, :2])

    # orient p -> q such that the segment direction matches n x z_hat
    want = np.stack([normals[:, 1], -normals[:, 0]], axis=1)
    d = q - p
    flip = np.einsum("ij,ij->i", d, want) < 0.0
    p_out = np.where(flip[:, None], q, p)
    q_out = np.where(flip[:, None], p, q)
    return np.stack([p_out, q_out], axis=1)


def slice_perimeter_area(mesh: TriMesh, z: float) -> tuple[float, float]:
    """(perimeter, enclosed area) of the mesh section at height z."""
    seg = section_segments(mesh, z)
    if len(seg) == 0:
        return 0.0, 0.0
    d = seg[:, 1] - seg[:, 0]
    perim = float(np.linalg.norm(d, axis=1).sum())
    # oriented shoelace over independent segments (valid for closed sections)
    area = 0.5 * float(np.sum(seg[:, 0, 0] * seg[:, 1, 1]
                              - seg[:, 1, 0] * seg[:, 0, 1]))
    return perim, abs(area)


def per_slice_perimeter_scale(mesh: TriMesh, mask: np.ndarray, origin,
                              dx: float) -> np.ndarray:
    """Per-z-slab lateral Robin correction: true section perimeter divided by
    the voxel mask's digital perimeter (stl_utils.per_slice_scale semantics,
    generalizing the pi/4 circle factor of geometry/perimeter.py).  Slabs
    with no section or no exposed faces get scale 1."""
    nz = mask.shape[2]
    oz = float(np.asarray(origin)[2])
    scales = np.ones(nz)
    for k in range(nz):
        sec = mask[:, :, k]
        if not sec.any():
            continue
        dig = digital_perimeter(sec, dx)
        if dig <= 0:
            continue
        true_p, _ = slice_perimeter_area(mesh, oz + (k + 0.5) * dx)
        if true_p > 0:
            scales[k] = true_p / dig
    return scales
