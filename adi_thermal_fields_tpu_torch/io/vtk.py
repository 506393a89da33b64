"""Legacy VTK writers and readers: STRUCTURED_POINTS (Cartesian fields)
and STRUCTURED_GRID (cylindrical fields with true tube geometry), ASCII
and binary.

Counterpart: ``adi_thermal_fields_tpu/io/vtk.py`` —
``write_vtk_structured_points`` (:21), ``read_vtk_structured_points``
(:61), ``write_vtk_cylindrical_grid`` (:100) and
``read_vtk_structured_grid`` (:169), a numpy copy: for the same arrays the
two writers produce the same bytes, and each reader reads the other's
files.  Fields are written F-order (x fastest); units are the caller's
(the WAAM app passes mm).  ``binary=True`` writes the legacy big-endian
form, ~6x smaller and far faster to produce than ASCII; ParaView reads
both.  Fields are numpy arrays: move tensors to the host first.
"""
from __future__ import annotations

import numpy as np

__all__ = ["write_vtk_structured_points", "read_vtk_structured_points",
           "write_vtk_cylindrical_grid", "read_vtk_structured_grid"]


def write_vtk_structured_points(path: str, fields: dict[str, np.ndarray], *,
                                spacing, origin=(0.0, 0.0, 0.0),
                                comment: str = "adi_thermal_fields_tpu",
                                binary: bool = False) -> None:
    """Write one or more same-shaped 3-D scalar fields.  ``spacing``:
    scalar or per-axis (sx, sy, sz)."""
    items = list(fields.items())
    if not items:
        raise ValueError("no fields to write")
    shape = np.asarray(items[0][1]).shape
    nx, ny, nz = shape
    ox, oy, oz = map(float, origin)
    with open(path, "wb") as f:
        w = lambda s: f.write(s.encode("ascii"))
        w("# vtk DataFile Version 3.0\n")
        w(comment + "\n")
        w("BINARY\n" if binary else "ASCII\n")
        w("DATASET STRUCTURED_POINTS\n")
        w(f"DIMENSIONS {nx} {ny} {nz}\n")
        w(f"ORIGIN {ox:.9g} {oy:.9g} {oz:.9g}\n")
        sx, sy, sz = np.broadcast_to(np.asarray(spacing, float), (3,))
        w(f"SPACING {sx:.9g} {sy:.9g} {sz:.9g}\n")
        w(f"POINT_DATA {nx * ny * nz}\n")
        for name, arr in items:
            arr = np.asarray(arr)
            if arr.shape != shape:
                raise ValueError(f"field {name!r} shape {arr.shape} != {shape}")
            w(f"SCALARS {name} float 1\n")
            w("LOOKUP_TABLE default\n")
            # F-order: x fastest, then y, then z
            flat = np.asarray(arr, np.float32).transpose(2, 1, 0)
            if binary:
                f.write(flat.astype(">f4").tobytes())
                w("\n")
            else:
                for plane in flat:           # z
                    for row in plane:        # y
                        w(" ".join(f"{v:.6g}" for v in row) + "\n")


def read_vtk_structured_points(path: str) -> dict[str, np.ndarray]:
    """Read back this module's output (ASCII or binary legacy form)."""
    with open(path, "rb") as f:
        data = f.read()
    fields: dict[str, np.ndarray] = {}
    dims = None
    binary = False
    pos = 0

    def next_line():
        nonlocal pos
        end = data.index(b"\n", pos)
        ln = data[pos:end].decode("ascii", errors="replace")
        pos = end + 1
        return ln

    while pos < len(data):
        ln = next_line()
        if ln.startswith("BINARY"):
            binary = True
        elif ln.startswith("DIMENSIONS"):
            dims = tuple(int(v) for v in ln.split()[1:4])
        elif ln.startswith("SCALARS"):
            name = ln.split()[1]
            next_line()  # LOOKUP_TABLE
            need = dims[0] * dims[1] * dims[2]
            if binary:
                arr = np.frombuffer(data, dtype=">f4", count=need,
                                    offset=pos).astype(np.float64)
                pos += 4 * need
            else:
                vals: list[float] = []
                while len(vals) < need:
                    vals.extend(float(v) for v in next_line().split())
                arr = np.asarray(vals)
            fields[name] = arr.reshape(dims[2], dims[1], dims[0]).transpose(2, 1, 0)
    return fields


def write_vtk_cylindrical_grid(path: str, fields: dict[str, np.ndarray], *,
                               r, dphi: float, dz: float,
                               z0: float = 0.0, phi0: float = 0.0,
                               comment: str = "adi_thermal_fields_tpu",
                               binary: bool = False,
                               close_phi: bool = True) -> None:
    """Legacy VTK STRUCTURED_GRID writer for cylindrical (nr, nphi, nz)
    fields with TRUE tube geometry (explicit x,y,z points), so ParaView
    renders the actual annulus instead of an index-space box — the
    reference has no cylindrical output path at all (its spiral driver
    writes GIFs only, quick_spiral_deposition_gif_v5.py).

    r: cell-center radii, shape (nr,).  ``close_phi=True`` appends a
    duplicate of the phi=0 plane so the tube renders closed (legacy VTK
    has no periodic topology); point count becomes nr*(nphi+1)*nz.
    Units are the caller's (the spiral app passes mm).
    """
    items = list(fields.items())
    if not items:
        raise ValueError("no fields to write")
    nr, nphi, nz = np.asarray(items[0][1]).shape
    r = np.asarray(r, float)
    if r.shape != (nr,):
        raise ValueError(f"r shape {r.shape} != ({nr},)")
    npx = nphi + 1 if close_phi else nphi
    phi = phi0 + dphi * np.arange(npx)
    z = z0 + dz * np.arange(nz)
    # point array in VTK F-order: first index (r) fastest, z slowest
    R, PHI, Z = np.meshgrid(r, phi, z, indexing="ij")    # (nr, npx, nz)
    pts = np.stack([R * np.cos(PHI), R * np.sin(PHI), Z], axis=-1)
    pts_f = pts.transpose(2, 1, 0, 3).reshape(-1, 3)     # z, phi, r -> rows

    def closed(a):
        a = np.asarray(a)
        if close_phi:
            a = np.concatenate([a, a[:, :1]], axis=1)
        return a

    with open(path, "wb") as f:
        w = lambda s: f.write(s.encode("ascii"))
        w("# vtk DataFile Version 3.0\n")
        w(comment + "\n")
        w("BINARY\n" if binary else "ASCII\n")
        w("DATASET STRUCTURED_GRID\n")
        w(f"DIMENSIONS {nr} {npx} {nz}\n")
        w(f"POINTS {nr * npx * nz} float\n")
        if binary:
            f.write(pts_f.astype(">f4").tobytes())
            w("\n")
        else:
            for p in pts_f:
                w(f"{p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        w(f"POINT_DATA {nr * npx * nz}\n")
        for name, arr in items:
            arr = closed(arr)
            if arr.shape != (nr, npx, nz):
                raise ValueError(f"field {name!r} shape mismatch")
            w(f"SCALARS {name} float 1\n")
            w("LOOKUP_TABLE default\n")
            flat = np.asarray(arr, np.float32).transpose(2, 1, 0)
            if binary:
                f.write(flat.astype(">f4").tobytes())
                w("\n")
            else:
                for plane in flat:
                    for row in plane:
                        w(" ".join(f"{v:.6g}" for v in row) + "\n")


def read_vtk_structured_grid(path: str):
    """Read back this module's STRUCTURED_GRID output: returns
    ``(points, fields)`` with points (N, 3) float64 and each field in the
    writer's (nr, nphi[+1], nz) layout (the duplicated phi seam plane is
    kept; drop ``[:, -1]`` to recover the periodic field)."""
    with open(path, "rb") as f:
        data = f.read()
    fields: dict[str, np.ndarray] = {}
    dims = None
    pts = None
    binary = False
    pos = 0

    def next_line():
        nonlocal pos
        end = data.index(b"\n", pos)
        ln = data[pos:end].decode("ascii", errors="replace")
        pos = end + 1
        return ln

    while pos < len(data):
        ln = next_line()
        if ln.startswith("BINARY"):
            binary = True
        elif ln.startswith("DIMENSIONS"):
            dims = tuple(int(v) for v in ln.split()[1:4])
        elif ln.startswith("POINTS"):
            need = 3 * dims[0] * dims[1] * dims[2]
            if binary:
                pts = np.frombuffer(data, dtype=">f4", count=need,
                                    offset=pos).astype(np.float64)
                pos += 4 * need
            else:
                vals: list[float] = []
                while len(vals) < need:
                    vals.extend(float(v) for v in next_line().split())
                pts = np.asarray(vals)
            pts = pts.reshape(-1, 3)
        elif ln.startswith("SCALARS"):
            name = ln.split()[1]
            next_line()  # LOOKUP_TABLE
            need = dims[0] * dims[1] * dims[2]
            if binary:
                arr = np.frombuffer(data, dtype=">f4", count=need,
                                    offset=pos).astype(np.float64)
                pos += 4 * need
            else:
                vals = []
                while len(vals) < need:
                    vals.extend(float(v) for v in next_line().split())
                arr = np.asarray(vals)
            fields[name] = arr.reshape(dims[2], dims[1],
                                       dims[0]).transpose(2, 1, 0)
    return pts, fields
