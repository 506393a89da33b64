"""Radiative boundary conditions via an equivalent film coefficient.

Counterpart: ``adi_thermal_fields_tpu/bc/radiation.py`` —
``STEFAN_BOLTZMANN`` and ``radiative_h``.  The Stefan-Boltzmann flux
factors exactly as a temperature-dependent Robin film:

    q = eps*sigma*(T^4 - T_inf^4) = h_rad(T) * (T - T_inf),
    h_rad(T) = eps*sigma*(T + T_inf)*(T^2 + T_inf^2)

so evaluating ``h_rad`` at the current field (Picard linearization) turns
radiation into the Robin machinery.  The variable-property engine refreshes
it every sub-step (apps/engine.py).
"""
from __future__ import annotations

import torch

__all__ = ["STEFAN_BOLTZMANN", "radiative_h"]

STEFAN_BOLTZMANN = 5.670374419e-8  # W/m^2/K^4


def radiative_h(T: torch.Tensor, emissivity, t_inf, *, celsius: bool = True,
                h_conv=0.0) -> torch.Tensor:
    """Per-cell film coefficient making Robin exactly reproduce radiation
    (plus an additive convective film ``h_conv``), in ``T``'s dtype.

    celsius: temperatures are C (the framework's unit convention) and are
    shifted by 273.15 K for the T^4 law.  ``T_inf + 273.15`` is formed at
    ``T``'s precision, as the JAX function does.  At bfloat16 the Python
    scalars are rounded to bfloat16 first, as JAX rounds a weakly typed
    scalar to a bfloat16 array's dtype (``eps*sigma`` and 273.15 move)."""
    weak = ((lambda v: float(torch.tensor(float(v), dtype=T.dtype)))
            if T.dtype == torch.bfloat16 else (lambda v: v))
    off = weak(273.15 if celsius else 0.0)
    Tk = T + off
    # a device fill, not a host-to-device copy (which would stall the host
    # on the stream)
    Tik = torch.full((), float(t_inf), dtype=T.dtype, device=T.device) + off
    h = weak(emissivity * STEFAN_BOLTZMANN) * (Tk + Tik) \
        * (Tk * Tk + Tik * Tik)
    return h + weak(h_conv)
