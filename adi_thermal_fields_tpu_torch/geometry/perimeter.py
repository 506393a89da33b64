"""Digital-perimeter correction for lateral Robin coefficients.

Counterpart: ``adi_thermal_fields_tpu/geometry/perimeter.py`` —
``digital_perimeter`` and ``perimeter_correction_factor``, a numpy copy.
An axis-aligned voxelization of a smooth cross-section overestimates its
perimeter: every boundary step contributes a full dx face, so a circle's
digital perimeter is 4/pi ~ 1.273x the true circumference.  Applying the
physical film coefficient h on the staircase therefore over-cools by
~27%; the fix scales h by ``gamma = true_perimeter / digital_perimeter``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["digital_perimeter", "perimeter_correction_factor"]


def digital_perimeter(section: np.ndarray, dx: float) -> float:
    """Total exposed-face length of a 2-D boolean section (4-connectivity;
    domain edges count as exposed), in meters."""
    m = np.asarray(section, bool)
    pad = np.pad(m, 1, constant_values=False)
    faces = ((m & ~pad[:-2, 1:-1]).sum() + (m & ~pad[2:, 1:-1]).sum()
             + (m & ~pad[1:-1, :-2]).sum() + (m & ~pad[1:-1, 2:]).sum())
    return float(faces) * dx


def perimeter_correction_factor(section: np.ndarray, dx: float,
                                true_perimeter: float) -> float:
    """gamma = true / digital perimeter; multiply lateral Robin h by this."""
    dig = digital_perimeter(section, dx)
    if dig <= 0.0:
        return 1.0
    return true_perimeter / dig
