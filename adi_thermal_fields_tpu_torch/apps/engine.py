"""Event-driven simulation engine shared by the CLI apps.

Counterpart: ``adi_thermal_fields_tpu/apps/engine.py`` —
``history_update`` (:36), ``make_cartesian_engine`` (:52; its
single-device branches), ``make_cartesian_advance`` (:538) and
``EventLoop`` (:592).  The host walks the event list (births and frames);
between events ``advance`` issues the sub-steps from Python with scalar
arguments and no host synchronisation.  Syncs happen once at the start,
at frame boundaries (the finite check and frame callbacks) and, with
interpass dwell control, once per dwell check (the part's masked maximum),
as in the JAX loop.

With ``history_t_crit`` the engine also tracks each voxel's thermal
history, its running peak and its seconds above one or more critical
temperatures, updated in place on the device after every sub-step of
every route (``history_update``).

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
step on the g-stream tier, K23-K26, or, with per-face films, per-axis k
tuples or callables, on the classic tier's K5b, K6b, K7b and K19b) and,
with ``stochastic_rounding``, round their stores stochastically, seeded
by the integer step counter of ``clock``.  Per-face films and scales are
held at ``promote(dtype, float32)``, as the JAX engine holds them (:285).
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

__all__ = ["make_cartesian_engine", "make_cartesian_advance", "EventLoop",
           "history_update", "IMPLEMENTATIONS", "clock"]

IMPLEMENTATIONS = ("kernels", "reference")


def history_update(pk, ta, T, dt, tc, multi):
    """One sub-step of the per-voxel thermal-history state, IN PLACE on
    ``pk`` and ``ta``: the running peak ``pk = max(pk, T)`` and the
    dt-weighted time above threshold ``ta += dt * (T > tc)`` (a leading
    threshold axis on ``ta`` when ``multi``).  ``tc``: a 1-D tensor of the
    thresholds at ``ta``'s dtype, on T's device (compared at that dtype,
    as JAX compares at ``promote_types(T.dtype, float32)``); ``dt``: a
    Python float.  No host synchronisation.  Returns ``(pk, ta)``."""
    torch.maximum(pk, T, out=pk)
    if multi:
        above = T[None] > tc.view((-1,) + (1,) * T.dim())
    else:
        # a 1-element 1-D tc: a 0-dim one would compare at T's dtype
        above = T > tc[:1]
    ta.add_(above, alpha=dt)
    return pk, ta


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
    ``advance.has_source`` says whether ``source_fn`` is set (EventLoop's
    interpass dwell refuses a continuous source).

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
    [W/m^3]``.  Device meshes are not ported yet.

    ``history_t_crit``: per-voxel thermal history (JAX :88-100).  The
    advance becomes ``advance(T, prep, dt, n_sub, t0, hist) -> (T, hist)``
    with ``hist = (T_peak, t_above)`` updated IN PLACE after every
    sub-step of every route (``history_update``): the running peak and the
    seconds above ``history_t_crit``.  A tuple of thresholds gives
    ``t_above`` a leading threshold axis (``(800.0, 500.0)``: the steel
    t8/5 as ``t_above[1] - t_above[0]`` for monotone cooling), and
    ``advance.history_thresholds`` holds the tuple (None for one
    threshold).  ``t_above`` is kept at ``promote_types(state, float32)``.
    EventLoop(history=True) threads the state and resets a cell's history
    at its birth; never-born cells accumulate from their placeholder
    temperatures, so consumers mask by the final active state.

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
        # per-face films on the device at promote(dtype, float32), the
        # JAX engine's h_dtype (:285), converted once
        h_pf = s_pf = None
        if not scalar_conv:
            hdt = torch.promote_types(dtype, torch.float32)
            h_pf = _faces_on(robin_h if lite_c is None
                             else float(robin_h or 0.0), device, hdt)
            s_pf = _faces_on(radiation_scale, device, hdt)

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
                        build_face_h_axes(active, h_pf, s_spec, dtype=hdt))
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

    if history_t_crit is None:
        def advance(T, prep, dt: float, n_sub: int, t0: float = 0.0):
            """``n_sub`` sub-steps of ``dt`` from ``t0`` on the clock of
            ``clock``."""
            tick = clock(T.dtype, dt, t0)
            for i in range(n_sub):
                T = step1(T, prep, dt, *tick(i))
            return T
        advance.history_thresholds = None
    else:
        multi = isinstance(history_t_crit, (tuple, list))
        t_crits = tuple(float(t) for t in (history_t_crit if multi
                                           else (history_t_crit,)))
        tcs = {}          # the thresholds on the device, once per dtype

        def advance(T, prep, dt: float, n_sub: int, t0: float = 0.0,
                    hist=None):
            """As above, updating ``hist = (T_peak, t_above)`` in place
            after every sub-step."""
            pk, ta = hist
            if ta.dtype not in tcs:
                tcs[ta.dtype] = torch.tensor(t_crits, dtype=ta.dtype,
                                             device=T.device)
            tc = tcs[ta.dtype]
            tick = clock(T.dtype, dt, t0)
            for i in range(n_sub):
                T = step1(T, prep, dt, *tick(i))
                history_update(pk, ta, T, dt, tc, multi)
            return T, (pk, ta)
        advance.history_thresholds = t_crits if multi else None
    advance.has_source = source_fn is not None
    return prepare, advance


def make_cartesian_advance(grid: CartesianGrid, mat: Material, *,
                           implementation: str, device,
                           theta: float = 0.5, t_inf: float = 20.0,
                           robin_h=None, neumann=None, dirichlet_mask=None,
                           dirichlet_value=None, source_fn=None, mesh=None,
                           robin_h_fn=None):
    """Fused convenience form (JAX :538-589): ``advance(T, active, dt,
    n_sub, t0=0.0) -> T`` rebuilds the plan or packs for the current mask
    on every call, then takes ``n_sub`` steps.  The engine is built once
    per state dtype.  Prefer make_cartesian_engine + EventLoop(prepare=...)
    for large grids: the rebuild then happens on births only.

    ``robin_h_fn``: optional ``T -> h`` (scalar, face dict or field) giving
    a temperature-dependent film, e.g. ``bc.radiation.radiative_h``,
    evaluated at the field entering each call (refreshed per event
    segment); it replaces ``robin_h``, and the engine is rebuilt with it on
    every call."""
    cache = {}
    kw = dict(implementation=implementation, device=device, theta=theta,
              t_inf=t_inf, neumann=neumann, dirichlet_mask=dirichlet_mask,
              dirichlet_value=dirichlet_value, source_fn=source_fn,
              mesh=mesh)

    def advance(T, active, dt: float, n_sub: int, t0: float = 0.0):
        if robin_h_fn is not None:
            prepare, adv = make_cartesian_engine(
                grid, mat, dtype=T.dtype, robin_h=robin_h_fn(T), **kw)
        else:
            if T.dtype not in cache:
                cache[T.dtype] = make_cartesian_engine(
                    grid, mat, dtype=T.dtype, robin_h=robin_h, **kw)
            prepare, adv = cache[T.dtype]
        return adv(T, prepare(active), dt, n_sub, t0)

    advance.has_source = source_fn is not None
    return advance


@dataclasses.dataclass
class EventLoop:
    """Run an element-birth simulation through its event schedule (JAX
    :592-788).

    advance : with ``prepare`` set, ``(T, prep, dt, n_sub, t0) -> T`` from
        make_cartesian_engine, and ``prepare(active) -> prep`` is called
        when the mask changes (births); with ``prepare=None``,
        ``(T, active, dt, n_sub, t0) -> T`` is given the mask (e.g.
        make_cartesian_advance).
    activation_times : tensor of the field's shape on the field's device;
        a cell is born when ``activation_times <= t`` (substrate = -inf).
    deposit_T : temperature assigned to newborn cells.
    dt_cap : max sub-step; event segments are split evenly to respect it.
    check_finite : raise on NaN/Inf (with the simulation time) at frame
        boundaries and the last event.
    history : thread the per-voxel thermal history (an advance from
        ``make_cartesian_engine(history_t_crit=...)`` and ``prepare``);
        after ``run`` ``(T_peak, t_above)`` are in ``history_state``.  A
        cell's history restarts at its birth: the peak at the deposit
        temperature, zero time above.  ``history_thresholds``: the
        threshold tuple, when not read from ``advance.history_thresholds``.
    interpass_T : interpass temperature control [C]: before each birth the
        loop holds deposition and keeps cooling the part in
        ``interpass_dwell``-second increments until its maximum temperature
        is at or below this (or ``interpass_max_dwell`` seconds of dwell
        accrue).  The dwell is inserted on top of the schedule (its clock
        and the activation times are unchanged); each layer's dwell is
        logged in ``dwell_log`` as ``(event_time, dwell_seconds)``.  One
        host read of the part's masked maximum per dwell check.  It raises
        with an engine built with a continuous ``source_fn`` (the torch
        would keep burning at the frozen schedule time).
    substeps : sub-steps taken by ``run``, dwells included (output).
    """

    advance: Callable
    activation_times: Any
    deposit_T: float
    dt_cap: float
    prepare: Callable | None = None
    check_finite: bool = True
    history: bool = False
    history_state: Any = None
    history_thresholds: tuple | None = None
    interpass_T: float | None = None
    interpass_dwell: float = 5.0
    interpass_max_dwell: float = 600.0
    dwell_log: Any = None
    substeps: int = 0

    def _advance(self, T, prep, active, dt: float, n_sub: int, t: float):
        # dt and the segment start rounded to the STATE dtype, as the JAX
        # loop passes them (:724-736): at bfloat16 both are bf16-quantised
        # before the clock widens them.  Kept so, for parity with JAX.
        dt, t = round_to_state(dt, T.dtype), round_to_state(t, T.dtype)
        self.substeps += n_sub
        if self.history:
            T, self.history_state = self.advance(T, prep, dt, n_sub, t,
                                                 self.history_state)
            return T
        return self.advance(T, active if prep is None else prep, dt, n_sub,
                            t)

    def run(self, T, *, frame_times, t_end: float | None = None,
            on_frame: Callable | None = None, extra_events=(),
            start_t: float = 0.0, history_state=None):
        """``start_t``: resume the schedule from this time (births at or
        after it replay).  ``history_state``: ``(T_peak, t_above)`` to
        resume the history from (copied; default: the peak seeded from the
        entering field, zero time above)."""
        act = self.activation_times
        eps = 1e-12
        # event times come from the activation field's own values (one host
        # copy at set-up).  Comparisons against them are INCLUSIVE: for a
        # float32 field `act < te + 1e-12` is false at act == te (the
        # epsilon vanishes in the cast), and every layer would activate one
        # event late.
        act_h = act.detach().cpu().numpy()
        finite = np.isfinite(act_h) & (act_h >= start_t)
        births = np.unique(np.where(finite, act_h, np.inf))
        births = [float(b) for b in births if math.isfinite(float(b))]
        frame_times = [float(t) for t in frame_times]
        t_end = t_end if t_end is not None else (
            max(frame_times) if frame_times else 0.0)
        # a float32 birth time a hair above the float64 t_end still deposits
        birth_set = set(b for b in births
                        if b <= t_end + 1e-6 * max(1.0, abs(t_end)))
        events = sorted(birth_set | set(frame_times)
                        | set(float(e) for e in extra_events) | {t_end})
        frames = set(frame_times)
        final_event = events[-1] if events else None

        if self.interpass_T is not None and self.interpass_dwell <= 0:
            raise ValueError("interpass_dwell must be positive (a zero or "
                             "negative increment would dwell forever)")
        if self.interpass_T is not None and getattr(self.advance,
                                                    "has_source", False):
            raise ValueError(
                "interpass_T cannot be combined with a continuous source_fn: "
                "during the dwell the engine keeps evaluating the source at "
                "the frozen schedule time (the torch never switches off), so "
                "the part may never cool to the threshold.  Model deposition "
                "heating via birth deposits (deposit_T) when using interpass "
                "control")
        t = float(start_t)
        active = (act <= t).expand(T.shape)
        # layers born at the start are deposited now; the substrate (-inf)
        # and cells born earlier keep the entering field
        born_now = active & torch.isfinite(act) & (act >= t)
        T = torch.where(born_now, self.deposit_T, T)
        active_any = bool(active.any())          # one sync at start only
        prep = self.prepare(active) if self.prepare is not None else None
        if self.history:
            if prep is None:
                raise ValueError("EventLoop(history=True) requires prepare "
                                 "and an advance from make_cartesian_engine("
                                 "history_t_crit=...)")
            if history_state is not None:
                # the advance updates the state in place: work on copies
                self.history_state = tuple(
                    torch.as_tensor(x, device=T.device).clone()
                    for x in history_state)
            else:
                # t_above accumulates many small dt increments: solve
                # precision even for bfloat16 states; a tuple of thresholds
                # adds a leading threshold axis
                ths = (self.history_thresholds
                       if self.history_thresholds is not None
                       else getattr(self.advance, "history_thresholds",
                                    None))
                ta_shape = tuple(T.shape) if not ths else \
                    (len(ths),) + tuple(T.shape)
                self.history_state = (T.clone(), torch.zeros(
                    ta_shape, dtype=torch.promote_types(T.dtype,
                                                        torch.float32),
                    device=T.device))
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
                T = self._advance(T, prep, active, seg / n_sub, n_sub, t)
            t = te
            if te in birth_set:
                if self.interpass_T is not None and active_any:
                    dwell = 0.0
                    n_dw = max(1, int(math.ceil(self.interpass_dwell
                                                / self.dt_cap)))
                    dt_dw = self.interpass_dwell / n_dw
                    while dwell < self.interpass_max_dwell:
                        # one host read per dwell check
                        tmax = float(torch.where(active, T,
                                                 -math.inf).max())
                        if tmax <= self.interpass_T:
                            break
                        T = self._advance(T, prep, active, dt_dw, n_dw, t)
                        dwell += self.interpass_dwell
                    if dwell > 0.0:
                        if self.dwell_log is None:
                            self.dwell_log = []
                        self.dwell_log.append((te, dwell))
                new_active = (act <= t).expand(T.shape)
                newborn = new_active & ~active
                T = torch.where(newborn, self.deposit_T, T)
                if self.history:
                    # a newborn's history starts at its deposit: void cells
                    # carry placeholder temperatures through the solver's
                    # identity rows, so anything accumulated before is void
                    pk, ta = self.history_state
                    self.history_state = (
                        torch.where(newborn, T, torch.maximum(pk, T)),
                        torch.where(newborn, 0.0, ta))
                active = new_active
                active_any = True          # a birth event implies new cells
                if self.prepare is not None:
                    prep = self.prepare(active)
            if self.check_finite and (te in frames or te == final_event):
                check(t)
            if te in frames and on_frame is not None:
                on_frame(t, T, active)
        return T, active, t
