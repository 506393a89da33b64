"""STL-derived correction of voxel-face Robin coefficients.

Counterpart: ``adi_thermal_fields_tpu/geometry/bc_correction.py`` —
``voxel_projected_areas`` (:38) and ``corrected_robin_fields`` (:99), a
copy in numpy.  The one array the JAX function takes through jnp (the
exposed faces of the mask, :113-127) comes from the port's
``bc.faces.exposed_face`` on a CPU bool tensor, the same values.

A voxel surface exposes axis-aligned dx^2 faces, but the true boundary area
crossing a voxel is generally different (oblique surfaces project onto
several faces; the staircase overestimates smooth ones).  Following the
reference's ``voxel_bc_correction.py``: subdivide every mesh triangle until
its footprint fits inside a voxel (:69-81), bin sub-triangle centroids to
voxels (:84-99), accumulate ``|n . e_f| * area`` onto the six per-direction
face buckets (:170-182), then set ``h_face = base_h * (projected_area /
dx^2)`` with a fallback to ``base_h`` on exposed cells the mesh discretization
missed (:156-165).

By the projection theorem the SUM of all per-face projected areas equals
the digital staircase area identically, so this correction
*redistributes* the film coefficient to the true per-face projections.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bc.faces import FACES, exposed_face
from .stl import TriMesh
from .voxelize import subdivided_triangles

__all__ = ["voxel_projected_areas", "corrected_robin_fields"]

_FACE_AXIS = {"x-": 0, "x+": 0, "y-": 1, "y+": 1, "z-": 2, "z+": 2}
_FACE_SIGN = {"x-": -1, "x+": +1, "y-": -1, "y+": +1, "z-": -1, "z+": +1}


def voxel_projected_areas(mesh: TriMesh, mask: np.ndarray, origin, dx,
                          max_level: int = 6) -> dict[str, np.ndarray]:
    """Per-face-direction 3-D arrays of true boundary area projected onto
    each voxel's faces [m^2]; only in-mask voxels accumulate.

    ``dx``: scalar voxel pitch or per-axis (dx, dy, dz) — anisotropic
    voxels (the WAAM ``--dz_mm`` mode) bin by per-axis pitch and subdivide
    to the smallest pitch."""
    mask = np.asarray(mask, bool)
    origin = np.asarray(origin, float)
    dims = np.asarray(mask.shape)
    d3 = np.broadcast_to(np.asarray(dx, float), (3,)).astype(float)

    sub, parent = subdivided_triangles(mesh.triangles,
                                       max_edge=0.9 * float(d3.min()),
                                       max_level=max_level)
    # sub-triangle areas and (parent) normals
    e1 = sub[:, 1] - sub[:, 0]
    e2 = sub[:, 2] - sub[:, 0]
    nvec = 0.5 * np.cross(e1, e2)          # area-weighted normal
    area_n = nvec              # |area_n| components = projected areas
    cent = sub.mean(axis=1)

    # Bin each surface patch to the solid voxel it bounds.  A patch centroid
    # frequently lands just on the void side of the voxelized boundary; the
    # reference silently drops those (voxel_bc_correction.py:98-99, losing
    # ~half the area of smooth surfaces to the base-h fallback).  Here such
    # patches are re-binned one half-cell inward along -n (the solid side),
    # twice if needed, before being dropped.
    nrm = np.linalg.norm(area_n, axis=1, keepdims=True)
    unit_n = np.where(nrm > 1e-300, area_n / np.maximum(nrm, 1e-300), 0.0)

    def bin_ok(points):
        idx = np.floor((points - origin) / d3).astype(int)
        inb = np.all((idx >= 0) & (idx < dims), axis=1)
        idx_c = np.clip(idx, 0, dims - 1)
        return idx, inb & mask[idx_c[:, 0], idx_c[:, 1], idx_c[:, 2]]

    idx, ok = bin_ok(cent)
    for step in (0.5, 1.0):
        miss = ~ok
        if not miss.any():
            break
        idx2, ok2 = bin_ok(cent[miss] - step * d3 * unit_n[miss])
        idx[miss] = np.where(ok2[:, None], idx2, idx[miss])
        ok[miss] = ok2
    idx = idx[ok]
    area_n = area_n[ok]

    flat = np.ravel_multi_index((idx[:, 0], idx[:, 1], idx[:, 2]), mask.shape)
    out = {}
    for f in FACES:
        ax, sg = _FACE_AXIS[f], _FACE_SIGN[f]
        comp = area_n[:, ax] * sg
        contrib = np.where(comp > 0.0, comp, 0.0)
        acc = np.zeros(mask.size)
        np.add.at(acc, flat, contrib)
        out[f] = acc.reshape(mask.shape)
    return out


def corrected_robin_fields(mesh: TriMesh, mask: np.ndarray, origin, dx,
                           base_h: dict[str, float],
                           fallback_to_base: bool = True,
                           max_level: int = 6
                           ) -> tuple[dict[str, np.ndarray],
                                      dict[str, np.ndarray]]:
    """(robin_h_fields, area_scale_fields) keyed by face direction.

    ``h_face[cell] = base_h[face] * projected_area / A_face`` on cells the
    mesh touches, with the PER-FACE voxel area ``A_face`` (dy*dz for x
    faces, dx*dz for y, dx*dy for z — the reference's single ``dx^2``,
    voxel_bc_correction.py:170-182, generalized to anisotropic voxels);
    exposed cells with no projected area fall back to ``base_h``
    (voxel_bc_correction.py:110-167).
    """
    d3 = np.broadcast_to(np.asarray(dx, float), (3,)).astype(float)
    projected = voxel_projected_areas(mesh, mask, origin, d3,
                                      max_level=max_level)
    face_area = {0: d3[1] * d3[2], 1: d3[0] * d3[2], 2: d3[0] * d3[1]}
    robin, scale = {}, {}
    mask_t = torch.from_numpy(np.asarray(mask, bool))
    for f, h0 in base_h.items():
        scl = projected[f] / face_area[_FACE_AXIS[f]]
        h = float(h0) * scl
        if fallback_to_base and h0 != 0.0:
            exp = exposed_face(mask_t, f).numpy()
            missing = exp & (h <= 0.0)
            h = np.where(missing, float(h0), h)
            scl = np.where(missing, 1.0, scl)
        robin[f] = h
        scale[f] = scl
    return robin, scale
