"""Binary morphology on voxel masks (6-connectivity), numpy only.

Counterpart: ``adi_thermal_fields_tpu/geometry/morphology.py`` —
``dilate6``, ``erode6``, ``closing6``, ``flood_fill_outside`` (its numpy
path; the native BFS is not ported yet), ``fill_enclosed`` and
``solidify_mask`` (copies).  These run once per geometry load on the host.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dilate6", "erode6", "closing6", "flood_fill_outside",
           "fill_enclosed", "solidify_mask"]


def _shift(m: np.ndarray, axis: int, direction: int) -> np.ndarray:
    out = np.zeros_like(m)
    src = [slice(None)] * m.ndim
    dst = [slice(None)] * m.ndim
    if direction > 0:
        src[axis] = slice(0, -1)
        dst[axis] = slice(1, None)
    else:
        src[axis] = slice(1, None)
        dst[axis] = slice(0, -1)
    out[tuple(dst)] = m[tuple(src)]
    return out


def dilate6(m: np.ndarray, iterations: int = 1) -> np.ndarray:
    m = np.asarray(m, bool)
    for _ in range(iterations):
        out = m.copy()
        for ax in range(3):
            out |= _shift(m, ax, +1)
            out |= _shift(m, ax, -1)
        m = out
    return m


def erode6(m: np.ndarray, iterations: int = 1) -> np.ndarray:
    return ~dilate6(~np.asarray(m, bool), iterations)


def closing6(m: np.ndarray, iterations: int = 1) -> np.ndarray:
    return erode6(dilate6(m, iterations), iterations)


def flood_fill_outside(solid: np.ndarray) -> np.ndarray:
    """Boolean field of 'outside air': void cells 6-connected to the domain
    boundary, by iterated dilation on a padded array."""
    solid = np.asarray(solid, bool)
    free = ~solid
    pad = np.pad(free, 1, constant_values=True)
    out = np.zeros_like(pad)
    out[0, :, :] = out[-1, :, :] = True
    out[:, 0, :] = out[:, -1, :] = True
    out[:, :, 0] = out[:, :, -1] = True
    out &= pad
    # expand strictly to the fixpoint: a serpentine channel's 6-connected
    # path can be far longer than the domain diameter.  `out` grows
    # monotonically within the padded volume, so the loop terminates.
    while True:
        grown = dilate6(out) & pad
        if (grown == out).all():
            break
        out = grown
    return out[1:-1, 1:-1, 1:-1]


def fill_enclosed(solid: np.ndarray) -> np.ndarray:
    """Solid plus every void region not connected to the outside."""
    outside = flood_fill_outside(solid)
    return np.asarray(solid, bool) | ~outside


def solidify_mask(mask: np.ndarray, mode: str = "auto",
                  closing_iters: int = 1) -> np.ndarray:
    """Condition a voxelized mask into a watertight solid.

    Modes: "none" (as-is), "fill" (fill enclosed cavities), "close_flood"
    (morphological closing, then fill), "auto" (thin shells / failed fills —
    erosion survival ratio < 0.25 or fill fraction < 0.02 — escalate to
    close_flood; otherwise fill).
    """
    mask = np.asarray(mask, bool)
    if mode == "none":
        return mask
    if mode == "fill":
        return fill_enclosed(mask)
    if mode == "close_flood":
        return fill_enclosed(closing6(mask, closing_iters))
    if mode != "auto":
        raise ValueError(f"unknown solidify mode: {mode!r}")

    filled = fill_enclosed(mask)
    n_mask = int(mask.sum())
    if n_mask == 0:
        return mask
    erosion_ratio = float(erode6(filled).sum()) / max(1, int(filled.sum()))
    fill_frac = float((filled & ~mask).sum()) / n_mask
    if erosion_ratio < 0.25 or fill_frac < 0.02:
        return fill_enclosed(closing6(mask, closing_iters))
    return filled
