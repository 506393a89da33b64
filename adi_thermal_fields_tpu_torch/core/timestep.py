"""Time-stepping controls.

Counterpart: ``adi_thermal_fields_tpu/core/timestep.py`` —
``TimeControls`` (:19), a copy.  The ``dt`` a step uses is always an
argument of the step functions; ``TimeControls`` carries the static knobs
(theta, scheme) and a default dt for convenience.
"""
from __future__ import annotations

import dataclasses

__all__ = ["TimeControls"]


@dataclasses.dataclass(frozen=True)
class TimeControls:
    dt: float
    theta: float = 0.5
    scheme: str = "be"  # cylindrical only: "be" (backward Euler) | "douglas"

    def __post_init__(self):
        object.__setattr__(self, "dt", float(self.dt))
        object.__setattr__(self, "theta", float(self.theta))
        object.__setattr__(self, "scheme", str(self.scheme).lower())
