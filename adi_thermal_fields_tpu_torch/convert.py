"""Carry the JAX package's state across to the port's tensors.

The JAX package (``adi_thermal_fields_tpu``) hands its arrays over as numpy
(``np.asarray(jax_array)``); these functions turn them into the port's
tensors on a chosen device:

* ``field_from_numpy(T)``: a temperature (or any) field;
* ``packs_from_numpy(coeff, qflux, dir_mask, dir_val)``: bc/packs.CoeffPacks;
* ``plan_from_numpy(...)``: step/cartesian_fused.SweepPlan from the fields
  of ``step/cartesian_pallas.SweepPlan``.  Its int8 codes are reinterpreted
  as uint8 (bit 128 is the int8 sign bit), and every z input (code,
  coefficient, Neumann and Dirichlet fields) moves from the JAX (z, x, y)
  layout to the natural (x, y, z) layout that K2 reads.  The JAX plan's
  TPU tile padding (``pad_to_tile``) is not
  undone here: convert an unpadded plan;
* ``property_table_from_jax(tab)``: step/cartesian_varprop.PropertyTable
  from a JAX ``PropertyTable`` (its points and values as floats);
* ``vp2_code_from_numpy(code)``: a JAX ``build_vp2_code`` code as the
  port's uint8 code (its bits stay below 32, so the values are kept), in
  the natural layout K8 reads — ``zxy=True`` undoes the (z, x, y) layout
  the JAX Cartesian step gives its z code;
* ``masked_plan_from_jax(plan)``: step/cylindrical_masked.MaskedRobinPlan
  from the ``compressed`` inputs of a JAX ``MaskedRobinPlan``: int8 codes
  as uint8, the z code, sink and srhs moved from the JAX (z, r, phi)
  layout to the natural (r, phi, z) layout, the geometry as tensors;
* ``cyl_vp2_plan_from_jax(plan)``: the port's ``build_cyl_vp2_plan`` codes
  from a JAX ``build_cyl_vp2_plan`` tuple: int8 codes as uint8, the z code
  moved from (z, r, phi) to the natural layout;
* ``faces_from_numpy(spec)``: a per-face dict of films or area scales (a
  JAX ``robin_h`` / ``radiation_scale``, or the outputs of
  ``corrected_robin_fields``) with its fields as tensors;
* ``h_axes_from_jax(h_axes)``: the per-axis film streams of a JAX
  ``build_face_h_axes`` as the port's, the z pair moved from the JAX
  (z, x, y) layout to the natural layout that K19 reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .bc.packs import CoeffPacks
from .step.cartesian_fused import SweepPlan
from .step.cartesian_varprop import PropertyTable
from .step.cylindrical_masked import MaskedRobinPlan

__all__ = ["field_from_numpy", "packs_from_numpy", "plan_from_numpy",
           "property_table_from_jax", "vp2_code_from_numpy",
           "masked_plan_from_jax", "cyl_vp2_plan_from_jax",
           "faces_from_numpy", "h_axes_from_jax"]


def field_from_numpy(T, *, device, dtype: torch.dtype | None = None
                     ) -> torch.Tensor:
    """A contiguous tensor copy of ``T`` on ``device`` (dtype kept unless
    given)."""
    t = torch.from_numpy(np.require(T, requirements=["C", "W"]))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def _codes_from_numpy(code, *, device) -> torch.Tensor:
    """int8 sweep codes reinterpreted bit for bit as uint8."""
    arr = np.require(code, requirements=["C", "W"])
    if arr.dtype == np.int8:
        arr = arr.view(np.uint8)
    if arr.dtype != np.uint8:
        raise TypeError(f"sweep codes must be int8 or uint8, got {arr.dtype}")
    return torch.from_numpy(arr).to(device)


def packs_from_numpy(coeff, qflux, dir_mask, dir_val, *, device
                     ) -> CoeffPacks:
    """CoeffPacks from the JAX packs' four arrays."""
    return CoeffPacks(coeff=field_from_numpy(coeff, device=device),
                      qflux=field_from_numpy(qflux, device=device),
                      dir_mask=field_from_numpy(np.asarray(dir_mask, bool),
                                                device=device),
                      dir_val=field_from_numpy(dir_val, device=device))


def plan_from_numpy(mask, codes, coeffs=None, qfluxes=None, dir_vals=None,
                    rob_c=None, *, device) -> SweepPlan:
    """SweepPlan from the fields of a JAX ``SweepPlan`` as numpy arrays.

    ``codes``: the three int8 codes (x and y natural, z in (z, x, y));
    ``coeffs`` / ``qfluxes`` / ``dir_vals``: three arrays each in the same
    layouts, or None; ``rob_c``: the per-axis plan-lite constants (a
    scalar or 3 values), or None for a field plan.  Every z input moves
    from (z, x, y) to the natural layout, where the port solves z."""
    mask_t = field_from_numpy(np.asarray(mask, bool), device=device)
    cx, cy, cz = (_codes_from_numpy(c, device=device) for c in codes)
    cz = cz.permute(1, 2, 0).contiguous()
    lite = coeffs is None

    def fields(triple):
        if triple is None:
            return None
        fx, fy, fz = (field_from_numpy(a, device=device) for a in triple)
        return fx, fy, fz.permute(1, 2, 0).contiguous()

    rc = None
    if lite:
        if rob_c is None:
            raise ValueError("a plan-lite plan (coeffs=None) needs rob_c")
        rc = tuple(float(v) for v in np.broadcast_to(
            np.asarray(rob_c, np.float64), (3,)))
    return SweepPlan(mask_t, (cx, cy, cz), fields(coeffs), fields(qfluxes),
                     fields(dir_vals), mask_t.to(torch.uint8), rc)


def property_table_from_jax(tab) -> PropertyTable:
    """The port's PropertyTable with the same breakpoints and values as
    the JAX ``PropertyTable`` (or any object with ``points``/``values``)."""
    return PropertyTable(tuple(float(p) for p in np.asarray(tab.points)),
                         tuple(float(v) for v in np.asarray(tab.values)))


def vp2_code_from_numpy(code, *, device, zxy: bool = False) -> torch.Tensor:
    """A JAX vp2 code (int8 bits 1/2/4/8/16) as the port's uint8 code;
    ``zxy``: the code is in the (z, x, y) layout and moves to (x, y, z)."""
    t = _codes_from_numpy(code, device=device)
    if t.numel() and int(t.max()) >= 32:
        raise ValueError("a vp2 code uses bits 1-16 only")
    return t.permute(1, 2, 0).contiguous() if zxy else t


def masked_plan_from_jax(plan, *, device="cpu") -> MaskedRobinPlan:
    """The port's masked-Robin plan from a JAX ``MaskedRobinPlan`` (its
    ``active``, ``ambient`` and ``compressed`` fields, read as numpy)."""
    comp_r, comp_phi, comp_z = plan.compressed

    def sweep(comp, zfirst=False):
        code, *fields = comp
        code = _codes_from_numpy(np.asarray(code), device=device)
        fields = [field_from_numpy(np.asarray(f), device=device)
                  for f in fields]
        if zfirst:      # (z, r, phi) -> (r, phi, z)
            code = code.permute(1, 2, 0).contiguous()
            fields[:2] = [f.permute(1, 2, 0).contiguous()
                          for f in fields[:2]]
        return (code, *fields)

    return MaskedRobinPlan(
        field_from_numpy(np.asarray(plan.active, bool), device=device),
        float(np.asarray(plan.ambient)), sweep(comp_r),
        None if comp_phi is None else sweep(comp_phi),
        sweep(comp_z, zfirst=True))


def cyl_vp2_plan_from_jax(plan, *, device="cpu") -> tuple:
    """``(code_r, code_p, code_z)`` of the port's ``build_cyl_vp2_plan``
    from a JAX ``build_cyl_vp2_plan`` tuple (read as numpy)."""
    code_r, code_p, code_z = (np.asarray(c) for c in plan)
    return (vp2_code_from_numpy(code_r, device=device),
            vp2_code_from_numpy(code_p, device=device),
            vp2_code_from_numpy(code_z, device=device, zxy=True))


def faces_from_numpy(spec, *, device, dtype: torch.dtype | None = None
                     ) -> dict:
    """A per-face dict (faces x-, x+, ...) of scalars or fields, the fields
    as contiguous tensors on ``device`` (dtype kept unless given)."""
    return {face: (v if v is None or isinstance(v, (int, float))
                   else field_from_numpy(np.asarray(v), device=device,
                                         dtype=dtype))
            for face, v in spec.items()}


def h_axes_from_jax(h_axes, *, device) -> tuple:
    """``((Ax, Bx), (Ay, By), (Az, Bz))`` of a JAX ``build_face_h_axes``
    (read as numpy) in the port's layout: x and y kept, the z pair moved
    from (z, x, y) to (x, y, z); a missing B stays None."""
    out = []
    for ax, pair in enumerate(h_axes):
        conv = []
        for a in pair:
            if a is None:
                conv.append(None)
                continue
            t = field_from_numpy(np.asarray(a), device=device)
            conv.append(t.permute(1, 2, 0).contiguous() if ax == 2 else t)
        out.append(tuple(conv))
    return tuple(out)
