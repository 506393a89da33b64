"""Event-driven simulation engine shared by the CLI apps.

Counterpart: ``adi_thermal_fields_tpu/apps/engine.py`` —
``make_cartesian_engine`` (:52; its constant-property single-device
branches :409-459) and ``EventLoop`` (:592).  The host walks the event list
(births and frames); between events ``advance`` issues the sub-steps from
Python with scalar arguments and no host synchronisation.  Syncs happen
once at the start and at frame boundaries (the finite check and frame
callbacks), as in the JAX loop.

``implementation`` is explicit — there is no choice by device:
"kernels" runs step/cartesian_fused.adi_step_fused (K1-K4 on CUDA tensors,
their plain versions on CPU tensors); "reference" runs the plain step
step/cartesian.adi_step.  ``k_table``, ``cp_table`` or ``emissivity``
switch the engine onto the variable-property step (JAX :167-358).  With
Robin films only, "kernels" runs step/cartesian_varprop.
adi_step_varprop_fused (K5-K8; per-face or field ``robin_h`` and
``radiation_scale`` folded once per birth into per-axis streams by
``build_face_h_axes``, then K19 along z).  With Neumann flux or Dirichlet
pins both implementations take the materialized step adi_step_varprop,
"kernels" solving it with K21; "reference" always does, and with
radiation rebuilds its packs every sub-step from the live field.
bfloat16 states run the kernels' bfloat16 entries (K1-K4; the varprop
step on the g-stream tier, K23-K26) and, with ``stochastic_rounding``,
round their stores stochastically, seeded by the integer step counter of
``clock``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..bc.packs import _normalize_per_face, build_coeff_packs
from ..bc.radiation import radiative_h
from ..core.grid import CartesianGrid
from ..core.material import Material
from ..step.cartesian import adi_step, round_to_state, solve_numpy_dtype
from ..step.cartesian_fused import adi_step_fused, build_sweep_plan
from ..step.cartesian_varprop import (adi_step_varprop,
                                      adi_step_varprop_fused,
                                      build_face_h_axes, build_varprop_codes,
                                      check_films)

__all__ = ["make_cartesian_engine", "EventLoop", "IMPLEMENTATIONS", "clock"]

IMPLEMENTATIONS = ("kernels", "reference")


def _faces_on(spec, device, dtype) -> dict:
    """A per-face film spec (scalar, field or dict of either) as a per-face
    dict, fields as tensors on ``device`` at ``dtype``."""
    return {face: (v if v is None or isinstance(v, (int, float))
                   else torch.as_tensor(v, dtype=dtype, device=device))
            for face, v in _normalize_per_face(spec).items()}


def clock(state_dtype: torch.dtype, dt: float, t0: float):
    """The sub-step clock OUTSIDE the state dtype (JAX ``_clock``,
    :467-478): ``i -> (t_i, istep_i)`` with ``t_i = t0 + i*dt`` at the solve
    precision (>= float32) and ``istep_i = round(t0/dt) + i`` an int32 step
    counter, the stochastic rounding's seed.  At bfloat16 (8-bit mantissa)
    a time or a seed formed at the state dtype would repeat over whole
    plateaus of sub-steps past step ~256, re-correlating the rounding."""
    f = solve_numpy_dtype(state_dtype)
    t0f, dtf = f(t0), f(dt)
    base = int(np.round(t0f / dtf))

    def tick(i: int):
        istep = (base + i + 2 ** 31) % 2 ** 32 - 2 ** 31   # int32 wrap
        return float(t0f + f(i) * dtf), istep

    return tick


def make_cartesian_engine(grid: CartesianGrid, mat: Material, *,
                          implementation: str, device, dtype: torch.dtype,
                          theta: float = 0.5, t_inf: float = 20.0,
                          robin_h=None, neumann=None, dirichlet_mask=None,
                          dirichlet_value=None, source_fn=None,
                          history_t_crit=None, mesh=None, k_table=None,
                          cp_table=None, emissivity=None,
                          radiation_scale=None,
                          stochastic_rounding: bool = False):
    """Split engine: ``prepare(active) -> prep`` (plan or pack rebuild,
    needed only when the mask changes) and
    ``advance(T, prep, dt, n_sub, t0=0.0) -> T`` (the sub-step loop).

    ``dtype``: state and pack dtype (float32, float64 or bfloat16; a
    bfloat16 state solves at float32 in the kernels' bfloat16 entries and
    its plan-lite constant stays at float32, JAX :158-163).
    ``stochastic_rounding``: round every bfloat16 store stochastically,
    seeded per sub-step from an integer step counter (JAX :81-87, :312,
    :436): round-to-nearest drops updates smaller than the bfloat16 quantum
    (~8 K at 1500 C) and freezes slow cooling.  It raises where it cannot
    be honoured, as the JAX engine does: the reference implementation and
    the materialized Neumann/Dirichlet varprop step.  ``robin_h``:
    scalar (plan-lite: no coefficient fields), per-face dict or 3-D field
    (field plan).  ``source_fn``: optional ``t -> volumetric heat field
    [W/m^3]``.  Thermal history and device meshes are not ported yet.

    Variable properties: ``k_table`` / ``cp_table`` (PropertyTable,
    number, callable, or a per-axis k 3-tuple; ``apparent_cp`` for latent
    heat, ``melt_pool_enhanced_k`` for the melt-pool proxy) and
    ``emissivity`` (the radiative film ``h_rad(T)`` on top of the
    convective ``robin_h``, refreshed every sub-step).  ``robin_h`` may be
    a scalar (>= 0 there), a per-face dict or a 3-D field, e.g. the STL
    area-corrected fields (geometry/bc_correction.py); the film is then
    ``robin_h + h_rad(T) * radiation_scale``, ``radiation_scale`` a
    per-face dict or field of area ratios (a face without one counts 1;
    it needs ``emissivity``).  Unlike the JAX engine, which drops
    ``radiation_scale`` beside a scalar ``robin_h``, the port applies it
    there too.  Neumann flux and Dirichlet pins run the materialized
    step."""
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(f"implementation must be one of {IMPLEMENTATIONS}, "
                         f"got {implementation!r}")
    if history_t_crit is not None:
        raise NotImplementedError("thermal-history tracking is not ported "
                                  "to the PyTorch engine yet")
    if mesh is not None:
        raise NotImplementedError("multi-device meshes are not ported to "
                                  "the PyTorch engine yet")
    f = solve_numpy_dtype(dtype)
    device = torch.device(device)
    if stochastic_rounding and implementation == "reference":
        raise ValueError("stochastic_rounding is a kernel feature; the "
                         "reference branch would silently round to nearest "
                         "(bf16 cooling freeze hazard)")

    def _packs(active):
        return build_coeff_packs(active, grid, mat, dtype=dtype,
                                 robin_h=robin_h, neumann=neumann,
                                 dirichlet_mask=dirichlet_mask,
                                 dirichlet_value=dirichlet_value)

    # plan-lite: a scalar (or absent) Robin h needs no coefficient fields.
    # Per-axis h/(rho cp d_axis), with the op order of build_coeff_packs
    # (dtype(h) * dtype(1/(rho cp d))) so the lite plan is bitwise equal to
    # the field plan by construction.
    lite_c = None
    if robin_h is None or isinstance(robin_h, (int, float)):
        lite_c = tuple(float(f(float(robin_h or 0.0))
                             * f(1.0 / (mat.rho * mat.cp * d)))
                       for d in grid.spacing)
    lite_needs_packs = neumann is not None or dirichlet_mask is not None

    varprop = (k_table is not None or cp_table is not None
               or emissivity is not None)
    if radiation_scale is not None and emissivity is None:
        raise ValueError("radiation_scale scales the RADIATIVE film and "
                         "therefore requires emissivity; for a corrected "
                         "convective film pass the corrected h fields as "
                         "robin_h")
    if varprop:
        # a radiation_scale makes the film per face even beside a scalar h
        scalar_conv = lite_c is not None and radiation_scale is None
        if scalar_conv:
            check_films(float(robin_h or 0.0), emissivity)
        else:
            check_films(None, emissivity)
        # radiation: a scalar convective robin_h rides on top of h_rad(T)
        h_conv = (float(robin_h or 0.0)
                  if emissivity is not None and scalar_conv else None)
        fused = neumann is None and dirichlet_mask is None
        # per-face films on the device at the state dtype, converted once
        h_pf = s_pf = None
        if not scalar_conv:
            h_pf = _faces_on(robin_h if lite_c is None
                             else float(robin_h or 0.0), device, dtype)
            s_pf = _faces_on(radiation_scale, device, dtype)

        def _compose_h(T):
            """This sub-step's total film for the packs: the convective
            robin_h plus the radiative film, scaled per face by
            radiation_scale (JAX :186-201)."""
            h_rad = radiative_h(T, emissivity, t_inf,
                                h_conv=0.0 if h_conv is None else h_conv)
            if scalar_conv:
                return h_rad
            return {face: (h_pf[face] if h_pf[face] is not None else 0.0)
                    + h_rad * (1.0 if s_pf[face] is None else s_pf[face])
                    for face in h_pf}

        if stochastic_rounding and not fused:
            raise ValueError("stochastic_rounding on the varprop path needs "
                             "the fused kernels (Robin-only films, no "
                             "Neumann/Dirichlet); this configuration takes "
                             "the materialized step, which has no "
                             "stochastic stores")
        if implementation == "kernels" and fused:
            s_spec = s_pf if emissivity is not None else None

            def prepare(active):
                active = active.to(device=device, dtype=torch.bool)
                # K5 and K20 read the mask as uint8: convert once per birth;
                # per-face films fold into per-axis streams once per birth
                h_ab = (None if scalar_conv else
                        build_face_h_axes(active, h_pf, s_spec,
                                          dtype=dtype))
                return (active.to(torch.uint8), build_varprop_codes(active),
                        h_ab)

            def step1(T, prep, dt, t, istep):
                active, codes, h_ab = prep
                src = None if source_fn is None else source_fn(t)
                return adi_step_varprop_fused(
                    T, active, codes, grid, mat, k_table=k_table,
                    cp_table=cp_table, dt=dt, theta=theta, t_inf=t_inf,
                    robin_h=float(robin_h or 0.0) if scalar_conv else 0.0,
                    h_axes=h_ab, emissivity=emissivity, h_conv=h_conv,
                    source=src,
                    rng_seed=istep if stochastic_rounding else None)
        else:
            def prepare(active):
                active = active.to(device=device, dtype=torch.bool)
                # radiation rebuilds the packs every sub-step from the live
                # field; otherwise they depend on the mask only
                return (active,
                        None if emissivity is not None else _packs(active))

            def step1(T, prep, dt, t, istep):
                active, packs = prep
                if emissivity is not None:
                    packs = build_coeff_packs(
                        active, grid, mat, dtype=T.dtype,
                        robin_h=_compose_h(T), neumann=neumann,
                        dirichlet_mask=dirichlet_mask,
                        dirichlet_value=dirichlet_value)
                src = None if source_fn is None else source_fn(t)
                return adi_step_varprop(
                    T, active, packs, grid, mat, k_table=k_table,
                    cp_table=cp_table, dt=dt, theta=theta, t_inf=t_inf,
                    source=src, implementation=implementation)
    elif implementation == "kernels":
        def prepare(active):
            active = active.to(device=device, dtype=torch.bool)
            packs = (_packs(active)
                     if lite_c is None or lite_needs_packs else None)
            return build_sweep_plan(active, packs,
                                    has_neumann=neumann is not None,
                                    has_dirichlet=dirichlet_mask is not None,
                                    robin_const=lite_c)

        def step1(T, prep, dt, t, istep):
            src = None if source_fn is None else source_fn(t)
            # the seed is the INTEGER step counter (JAX :432-436)
            return adi_step_fused(T, prep, grid, mat, dt=dt, theta=theta,
                                  t_inf=t_inf, source=src,
                                  rng_seed=istep if stochastic_rounding
                                  else None)
    else:
        def prepare(active):
            active = active.to(device=device, dtype=torch.bool)
            return (active, _packs(active))

        def step1(T, prep, dt, t, istep):
            active, packs = prep
            src = None if source_fn is None else source_fn(t)
            return adi_step(T, active, packs, grid, mat, dt=dt, theta=theta,
                            t_inf=t_inf, source=src)

    def advance(T, prep, dt: float, n_sub: int, t0: float = 0.0):
        """``n_sub`` sub-steps of ``dt`` from ``t0`` on the clock of
        ``clock``."""
        tick = clock(T.dtype, dt, t0)
        for i in range(n_sub):
            T = step1(T, prep, dt, *tick(i))
        return T

    return prepare, advance


@dataclasses.dataclass
class EventLoop:
    """Run an element-birth simulation through its event schedule.

    advance : ``(T, prep, dt, n_sub, t0) -> T`` from make_cartesian_engine.
    prepare : ``active -> prep``, called when the mask changes (births).
    activation_times : tensor of the field's shape on the field's device;
        a cell is born when ``activation_times <= t`` (substrate = -inf).
    deposit_T : temperature assigned to newborn cells.
    dt_cap : max sub-step; event segments are split evenly to respect it.
    substeps : sub-steps taken by ``run`` (output).
    ``run`` raises on NaN/Inf at frame boundaries and the last event.
    Thermal history and interpass dwell are not ported yet."""

    advance: Callable
    prepare: Callable
    activation_times: Any
    deposit_T: float
    dt_cap: float
    history: bool = False
    interpass_T: float | None = None
    substeps: int = 0

    def run(self, T, *, frame_times, t_end: float | None = None,
            on_frame: Callable | None = None):
        if self.history:
            raise NotImplementedError("thermal-history tracking is not "
                                      "ported to the PyTorch engine yet")
        if self.interpass_T is not None:
            raise NotImplementedError("interpass dwell control is not "
                                      "ported to the PyTorch engine yet")
        act = self.activation_times
        eps = 1e-12
        # event times come from the activation field's own values (one host
        # copy at set-up).  Comparisons against them are INCLUSIVE: for a
        # float32 field `act < te + 1e-12` is false at act == te (the
        # epsilon vanishes in the cast), and every layer would activate one
        # event late.
        act_h = act.detach().cpu().numpy()
        finite = np.isfinite(act_h) & (act_h >= 0.0)
        births = np.unique(np.where(finite, act_h, np.inf))
        births = [float(b) for b in births if math.isfinite(float(b))]
        frame_times = [float(t) for t in frame_times]
        t_end = t_end if t_end is not None else (
            max(frame_times) if frame_times else 0.0)
        # a float32 birth time a hair above the float64 t_end still deposits
        birth_set = set(b for b in births
                        if b <= t_end + 1e-6 * max(1.0, abs(t_end)))
        events = sorted(birth_set | set(frame_times) | {t_end})
        frames = set(frame_times)
        final_event = events[-1] if events else None

        t = 0.0
        active = (act <= t).expand(T.shape)
        # layers born at the start are deposited now; the substrate (-inf)
        # and cells born earlier keep the entering field
        born_now = active & (act >= t)
        T = torch.where(born_now, self.deposit_T, T)
        active_any = bool(active.any())          # one sync at start only
        prep = self.prepare(active)
        if t in frames and on_frame is not None:
            on_frame(t, T, active)

        def check(t):
            if not bool(torch.isfinite(torch.where(active, T, 0.0)).all()):
                raise FloatingPointError(
                    f"non-finite temperature detected at t={t:.6g} s "
                    f"(dt_cap={self.dt_cap:.3g}; check material/BC "
                    "magnitudes)")

        for te in events:
            if te <= t + eps:
                continue
            seg = te - t
            if active_any:
                n_sub = max(1, int(math.ceil(seg / self.dt_cap)))
                # dt and the segment start rounded to the STATE dtype, as
                # the JAX loop passes them (:729-731): at bfloat16 both are
                # bf16-quantised before the clock widens them.  Kept so, for
                # parity with JAX, not corrected here.
                T = self.advance(T, prep, round_to_state(seg / n_sub, T.dtype),
                                 n_sub, round_to_state(t, T.dtype))
                self.substeps += n_sub
            t = te
            if te in birth_set:
                new_active = (act <= t).expand(T.shape)
                newborn = new_active & ~active
                T = torch.where(newborn, self.deposit_T, T)
                active = new_active
                active_any = True          # a birth event implies new cells
                prep = self.prepare(active)
            if te in frames or te == final_event:
                check(t)
            if te in frames and on_frame is not None:
                on_frame(t, T, active)
        return T, active, t
