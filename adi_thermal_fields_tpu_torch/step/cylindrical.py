"""Boundary-condition data of the cylindrical (r, phi, z) steps.

Counterpart: ``adi_thermal_fields_tpu/step/cylindrical.py`` — ``RobinBC``
and ``ZFaceBC`` (:52-73), copied.  The unmasked cylindrical step
(``adi_step``, backward Euler and Douglas) and the ambient-clamp wrapper
``adi_step_masked`` are not ported yet: they run on TPU kernel rows 9-12
(``pallas_sweeps.fused_sweep_const`` and the ``fused_cyclic_const``
family).
"""
from __future__ import annotations

import dataclasses

__all__ = ["RobinBC", "ZFaceBC"]


@dataclasses.dataclass(frozen=True)
class RobinBC:
    """Convective (Robin) boundary: -k dT/dn = h (T - T_inf)."""

    h: float
    T_inf: float


@dataclasses.dataclass(frozen=True)
class ZFaceBC:
    """Axial end-face BCs; kinds in {"neumann0", "dirichlet", "robin"}."""

    kind_bot: str = "neumann0"
    kind_top: str = "robin"
    h_bot: float = 0.0
    h_top: float = 0.0
    T_inf_bot: float = 20.0
    T_inf_top: float = 20.0
    T_bot: float = 20.0
    T_top: float = 20.0
