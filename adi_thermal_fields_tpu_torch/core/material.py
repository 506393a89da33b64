"""Material properties (constant-coefficient conduction).

Counterpart: ``adi_thermal_fields_tpu/core/material.py::Material`` (copy).
Density rho [kg/m^3], specific heat cp [J/kg/K], conductivity k [W/m/K];
thermal diffusivity alpha = k/(rho*cp).
"""
from __future__ import annotations

import dataclasses

__all__ = ["Material"]


@dataclasses.dataclass(frozen=True)
class Material:
    rho: float
    cp: float
    k: float

    def __post_init__(self):
        object.__setattr__(self, "rho", float(self.rho))
        object.__setattr__(self, "cp", float(self.cp))
        object.__setattr__(self, "k", float(self.k))

    @property
    def alpha(self) -> float:
        """Thermal diffusivity [m^2/s]."""
        return self.k / (self.rho * self.cp)
