"""STL reading/writing (no trimesh dependency).

Counterpart: ``adi_thermal_fields_tpu/geometry/stl.py`` — ``TriMesh``,
``load_stl`` and ``save_stl_binary`` (copies).  Binary and ASCII STL to an
(N, 3, 3) float64 triangle array, with the mm -> m autoscale heuristic (a
model whose max extent exceeds 1.0 is taken to be in millimetres).
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

__all__ = ["TriMesh", "load_stl", "save_stl_binary"]


@dataclasses.dataclass
class TriMesh:
    """Triangle soup: vertices of each face, (N, 3, 3) [m or caller units]."""

    triangles: np.ndarray

    @property
    def face_normals(self) -> np.ndarray:
        """Unit normals, (N, 3); degenerate faces get zero normals."""
        e1 = self.triangles[:, 1] - self.triangles[:, 0]
        e2 = self.triangles[:, 2] - self.triangles[:, 0]
        n = np.cross(e1, e2)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        return np.where(ln > 1e-300, n / np.maximum(ln, 1e-300), 0.0)

    @property
    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        v = self.triangles.reshape(-1, 3)
        return v.min(axis=0), v.max(axis=0)

    @property
    def extents(self) -> np.ndarray:
        lo, hi = self.bounds
        return hi - lo

    def scaled(self, factor: float) -> "TriMesh":
        return TriMesh(self.triangles * factor)


def _load_binary(data: bytes) -> np.ndarray:
    n = struct.unpack_from("<I", data, 80)[0]
    expected = 84 + n * 50
    if len(data) < expected:
        raise ValueError(f"binary STL truncated: {len(data)} < {expected} bytes")
    rec = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84)
    rec = rec.reshape(n, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n, 4, 3)
    return floats[:, 1:4, :].astype(np.float64)  # drop stored normals


def _load_ascii(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            parts = line.split()
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    arr = np.asarray(verts, float)
    if len(arr) % 3:
        raise ValueError("ASCII STL vertex count not a multiple of 3")
    return arr.reshape(-1, 3, 3)


def load_stl(path: str, units: str = "auto") -> TriMesh:
    """Load an STL file; ``units``: "m", "mm", or "auto" (mm->m when the max
    extent exceeds 1.0)."""
    with open(path, "rb") as f:
        data = f.read()
    is_ascii = data[:6].lower() == b"solid " and b"facet" in data[:4096]
    if is_ascii:
        try:
            tris = _load_ascii(data.decode("ascii", errors="ignore"))
        except ValueError:
            tris = _load_binary(data)
    else:
        tris = _load_binary(data)
    mesh = TriMesh(tris)
    if units == "mm":
        mesh = mesh.scaled(1e-3)
    elif units == "auto" and float(mesh.extents.max(initial=0.0)) > 1.0:
        mesh = mesh.scaled(1e-3)
    return mesh


def save_stl_binary(path: str, mesh: TriMesh) -> None:
    tris = np.asarray(mesh.triangles, np.float32)
    n = len(tris)
    normals = mesh.face_normals.astype(np.float32)
    rec = np.zeros((n, 50), np.uint8)
    body = np.concatenate([normals[:, None, :], tris], axis=1).reshape(n, 48 // 4)
    rec[:, :48] = body.astype("<f4").view(np.uint8).reshape(n, 48)
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", n))
        f.write(rec.tobytes())
