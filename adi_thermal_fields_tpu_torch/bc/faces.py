"""Exposed-face detection on a boolean solid mask.

Counterpart: ``adi_thermal_fields_tpu/bc/faces.py`` — ``shift_in``,
``exposed_face`` and ``exposed_faces``.  A cell is exposed on face f (one of
x-/x+/y-/y+/z-/z+) when it is inside the solid mask and its neighbor across
that face is void or outside the domain.
"""
from __future__ import annotations

import torch

__all__ = ["FACES", "exposed_face", "exposed_faces", "shift_in"]

FACES = ("x-", "x+", "y-", "y+", "z-", "z+")

_AXIS = {"x": 0, "y": 1, "z": 2}


def shift_in(arr: torch.Tensor, axis: int, direction: int,
             fill) -> torch.Tensor:
    """Return ``arr`` shifted by one cell so that element i holds the neighbor
    value at ``i + direction`` along ``axis``; out-of-domain slots get
    ``fill``."""
    if direction not in (-1, +1):
        raise ValueError("direction must be +1 or -1")
    n = arr.shape[axis]
    out = torch.empty_like(arr)
    if direction == +1:
        out.narrow(axis, 0, n - 1).copy_(arr.narrow(axis, 1, n - 1))
        out.narrow(axis, n - 1, 1).fill_(fill)
    else:
        out.narrow(axis, 1, n - 1).copy_(arr.narrow(axis, 0, n - 1))
        out.narrow(axis, 0, 1).fill_(fill)
    return out


def exposed_face(mask: torch.Tensor, face: str) -> torch.Tensor:
    """Boolean field: in-mask cells whose neighbor across ``face`` is void or
    the domain edge."""
    axis = _AXIS[face[0]]
    direction = -1 if face[1] == "-" else +1
    nbr = shift_in(mask, axis, direction, fill=False)
    return mask & ~nbr


def exposed_faces(mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """All six exposed-face fields keyed by face name."""
    return {f: exposed_face(mask, f) for f in FACES}
