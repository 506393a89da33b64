"""Unified boundary-condition coefficient assembly for the Cartesian ADI core.

Counterpart: ``adi_thermal_fields_tpu/bc/packs.py`` — ``CoeffPacks`` and
``build_coeff_packs``.

* **Robin** faces become a volumetric sink ``h * A / (rho cp V)`` [1/s] on
  the exposed cells of each face, summed per axis.  ``h`` may be a scalar, a
  3-D field, or a per-face dict of either.
* **Neumann** flux ``q'' [W/m^2]`` (positive = heat INTO the solid) becomes
  an explicit source ``q'' * A / (rho cp V)`` [K/s] on exposed cells.
* **Dirichlet** cells are flagged by a boolean mask + value field.

The JAX function defaults its dtype to ``jnp.result_type(float)``; here the
dtype is an explicit argument.  The product keeps the op order
``dtype(h) * dtype(1/(rho cp d))``: the engine's plan-lite constant is built
the same way, so the lite and field plans agree bitwise.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import torch

from ..core.grid import CartesianGrid
from ..core.material import Material
from .faces import FACES, exposed_face

__all__ = ["CoeffPacks", "build_coeff_packs"]

_AXIS_OF_FACE = {"x-": 0, "x+": 0, "y-": 1, "y+": 1, "z-": 2, "z+": 2}


class CoeffPacks(NamedTuple):
    """Per-axis BC coefficient fields.

    coeff : (3, nx, ny, nz) Robin volumetric sink per axis [1/s]
    qflux : (3, nx, ny, nz) Neumann volumetric source per axis [K/s]
    dir_mask : (nx, ny, nz) bool, Dirichlet-pinned cells
    dir_val  : (nx, ny, nz) pinned temperature values
    """

    coeff: torch.Tensor
    qflux: torch.Tensor
    dir_mask: torch.Tensor
    dir_val: torch.Tensor


def _normalize_per_face(spec: Any) -> dict[str, Any]:
    """Expand scalar/field/dict specs into a per-face dict (missing faces map
    to None)."""
    if spec is None:
        return {f: None for f in FACES}
    if isinstance(spec, Mapping):
        return {f: spec.get(f, None) for f in FACES}
    return {f: spec for f in FACES}


def build_coeff_packs(mask: torch.Tensor, grid: CartesianGrid,
                      mat: Material, *, dtype: torch.dtype,
                      robin_h: Any = None,
                      neumann: Mapping[str, Any] | None = None,
                      dirichlet_mask: torch.Tensor | None = None,
                      dirichlet_value: Any = None) -> CoeffPacks:
    """Assemble per-axis coefficient packs on ``mask``'s device."""
    mask = mask.to(torch.bool)
    device = mask.device
    shape = mask.shape
    # A_face / (rho cp V) per axis = 1 / (rho cp d_axis)
    inv_ccell = [torch.tensor(1.0 / (mat.rho * mat.cp * d), dtype=dtype,
                              device=device) for d in grid.spacing]
    zero = torch.zeros((), dtype=dtype, device=device)

    coeff = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(3)]
    qflux = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(3)]

    h_per_face = _normalize_per_face(robin_h)
    q_per_face = _normalize_per_face(neumann)

    for f in FACES:
        ax = _AXIS_OF_FACE[f]
        hf = h_per_face[f]
        qf = q_per_face[f]
        if hf is None and qf is None:
            continue
        exp = exposed_face(mask, f)
        if hf is not None:
            hfield = torch.as_tensor(hf, dtype=dtype, device=device)
            coeff[ax] = coeff[ax] + torch.where(exp, hfield * inv_ccell[ax],
                                                zero)
        if qf is not None:
            qfield = torch.as_tensor(qf, dtype=dtype, device=device)
            qflux[ax] = qflux[ax] + torch.where(exp, qfield * inv_ccell[ax],
                                                zero)

    if dirichlet_mask is None:
        dir_mask = torch.zeros(shape, dtype=torch.bool, device=device)
    else:
        dir_mask = dirichlet_mask.to(device=device, dtype=torch.bool)
    if dirichlet_value is None:
        dir_val = torch.zeros(shape, dtype=dtype, device=device)
    else:
        dir_val = torch.as_tensor(dirichlet_value, dtype=dtype,
                                  device=device).expand(shape).contiguous()

    return CoeffPacks(coeff=torch.stack(coeff), qflux=torch.stack(qflux),
                      dir_mask=dir_mask, dir_val=dir_val)
