"""Thermal parameter identification from measured cooling curves (CLI app).

Counterpart: ``adi_thermal_fields_tpu/apps/calibrate_params.py``
(:1-379).  Calibration fits the convection coefficient h, conductivity k,
heat capacity cp and emissivity of a real setup to thermocouple traces of
a cool-down experiment.  The loss ``mean((T_sim(probes, t_s) -
T_meas)^2)`` is differentiated through the whole transient ADI simulation
by autograd, so the fit converges in tens of iterations.

Differentiability w.r.t. the physics constants comes from the plain
variable-property step (``step/cartesian_varprop.adi_step_varprop(
implementation="reference")``), whose callable k(T)/cp(T) tables close
over the fitted tensors, and from the Robin sink being linear in h (unit-h
packs scaled by h, or by the Picard radiative film with ``eps``).

Scenario: a solid block at uniform T0 cooling by Robin convection on all
exposed faces, sampled at probe voxels (center, face center, edge
midpoint).  Measurements come from ``--measured @csv`` (columns: t, one
per probe) or are synthesized from ``--true_h/--true_k/--true_cp/
--true_eps``.  ``--uq`` adds Gauss-Newton 1-sigma error bars from the
Jacobian of the residuals (JAX: ``jax.jacfwd``; here one forward-mode pass
per parameter with ``torch.autograd.forward_ad``).

The JAX app's optimizers map to torch's: ``optax.lbfgs`` to
``torch.optim.LBFGS(line_search_fn="strong_wolfe")`` one iteration a
step (its line search differs, so a fit ends at the same optimum by
another path), and Adam with ``exponential_decay(lr, iters//4, 0.5)`` to
``torch.optim.Adam`` under a ``LambdaLR`` of ``0.5 ** (it / (iters//4))``.
``--device`` defaults to ``cuda`` and the run raises when CUDA is
absent; ``--device cpu`` runs on the CPU.  The simulation runs at
float64, as the JAX app does under x64.

Example (synthetic round trip):
    python -m adi_thermal_fields_tpu_torch.apps.calibrate_params \\
        --fit h,k --true_h 45 --true_k 38 --iters 60
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import resolve_device

__all__ = ["default_probes", "make_measurement_forward", "fit",
           "uncertainty", "load_measured", "build_argparser", "run"]


def default_probes(shape):
    """Probe voxels with complementary sensitivities: center (conduction-
    dominated), face center (film-dominated), edge midpoint."""
    nx, ny, nz = shape
    return [(nx // 2, ny // 2, nz // 2),
            (nx // 2, ny // 2, nz - 1),
            (nx // 2, 0, nz - 1)]


def make_measurement_forward(grid, mat_base, probes, *, t0: float,
                             t_inf: float, dt: float, n_steps: int,
                             sample_every: int, dtype=torch.float64,
                             device="cuda"):
    """Differentiable ``forward(params) -> (n_samples, n_probes)`` simulated
    probe traces on ``device`` (the card unless the caller passes
    ``"cpu"``; raises when CUDA is absent).  params: dict with any of 'h',
    'k', 'cp', 'eps' as 0-d tensors; missing 'k'/'cp' take mat_base
    values, missing 'h' means no convective film, missing 'eps' means no
    radiation (with 'eps', 'h' is the additive convective film)."""
    from ..bc.packs import build_coeff_packs
    from ..bc.radiation import radiative_h
    from ..step.cartesian_varprop import adi_step_varprop

    device = resolve_device(device)
    mask = torch.ones(grid.shape, dtype=torch.bool, device=device)
    pidx = tuple(torch.tensor([p[i] for p in probes], device=device)
                 for i in range(3))
    # the Robin sink is linear in h: the geometry as unit-h packs, a
    # per-cell h entering as a broadcast multiply (both faces of an axis
    # share the cell's h, so h * unit_coeff is a full rebuild, exactly)
    packs_unit = build_coeff_packs(mask, grid, mat_base, robin_h=1.0,
                                   dtype=dtype)

    def const(v, default):
        return torch.as_tensor(default if v is None else v, dtype=dtype,
                               device=device)

    def forward(params):
        h = const(params.get("h"), 0.0)
        k = const(params.get("k"), mat_base.k)
        cp = const(params.get("cp"), mat_base.cp)
        eps = params.get("eps", None)
        # the packs carry h*A/(rho cp_base V); the varprop step rescales
        # them by cp_base/cp(T), so a fitted cp flows through cp_table
        k_tab = (lambda T: torch.zeros_like(T) + k)
        cp_tab = (lambda T: torch.zeros_like(T) + cp)
        packs = packs_unit._replace(coeff=packs_unit.coeff * h)
        T = torch.full(grid.shape, t0, dtype=dtype, device=device)
        traces = []
        for _ in range(n_steps):
            if eps is not None:
                # radiation as an exact Robin film h(T), linearized per
                # step at T^n, plus the fitted convective film
                hf = radiative_h(T, eps, t_inf, h_conv=h).to(dtype)
                pk = packs_unit._replace(coeff=packs_unit.coeff * hf[None])
            else:
                pk = packs
            T = adi_step_varprop(T, mask, pk, grid, mat_base,
                                 k_table=k_tab, cp_table=cp_tab, dt=dt,
                                 theta=1.0, t_inf=t_inf,
                                 implementation="reference")
            traces.append(T[pidx])
        return torch.stack(traces)[sample_every - 1::sample_every]

    return forward


def fit(forward, measured, fit_keys, init, *, iters: int, lr: float = 0.1,
        optimizer: str = "lbfgs", fixed=None, log=print):
    """Minimize the trace misfit in log-parameter space (positivity by
    construction); returns (fitted dict, loss history).

    fixed: dict of non-fitted parameters held constant in the forward.
    optimizer: 'lbfgs' (one strong-Wolfe L-BFGS iteration a step) or
    'adam' (with exponential lr decay).  The last history entry is the
    loss at the returned parameters (one extra forward)."""
    dtype = measured.dtype
    fixed = dict(fixed or {})
    p = torch.log(torch.tensor([init[key] for key in fit_keys], dtype=dtype,
                               device=measured.device)).requires_grad_(True)

    def loss_fn(p):
        params = dict(fixed)
        params.update({key: torch.exp(p[i])
                       for i, key in enumerate(fit_keys)})
        r = forward(params) - measured
        return torch.mean(r * r)

    history = []

    def emit(it, loss, p_at_loss):
        history.append(float(loss))
        if log is not None and (it % max(1, iters // 10) == 0
                                or it == iters - 1):
            vals = {key: float(torch.exp(p_at_loss[i]))
                    for i, key in enumerate(fit_keys)}
            log(f"iter {it:4d} rms {float(loss)**0.5:.4g} K  " +
                " ".join(f"{key}={v:.5g}" for key, v in vals.items()))

    if optimizer == "lbfgs":
        # one iteration a step, its line search up to 20 evaluations
        # (max_eval counts the step's first evaluation too).  torch's
        # default tolerances stall a clean fit near 1e-5 K (a directional
        # derivative under 1e-9); here a step stops early only at a
        # gradient under 1e-9, a parameter ~1e-11 from the optimum
        opt = torch.optim.LBFGS([p], lr=1.0, max_iter=1, max_eval=21,
                                history_size=10, tolerance_grad=1e-9,
                                tolerance_change=1e-30,
                                line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad()
            loss = loss_fn(p)
            loss.backward()
            return loss

        for it in range(iters):
            p_prev = p.detach().clone()
            loss = opt.step(closure)       # the loss at p_prev
            emit(it, loss.detach(), p_prev)
    elif optimizer == "adam":
        # decay the step near the optimum (raw Adam in log-space oscillates
        # around the minimum at a fixed lr)
        opt = torch.optim.Adam([p], lr=lr)
        T_dec = max(1, iters // 4)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda it: 0.5 ** (it / T_dec))
        for it in range(iters):
            opt.zero_grad()
            loss = loss_fn(p)
            loss.backward()
            emit(it, loss.detach(), p.detach())
            opt.step()
            sched.step()
    else:
        raise ValueError(f"unknown optimizer {optimizer!r} (lbfgs | adam)")
    with torch.no_grad():
        history.append(float(loss_fn(p)))
    p = p.detach()
    return ({key: float(torch.exp(p[i])) for i, key in enumerate(fit_keys)},
            history)


def uncertainty(forward, measured, fitted, fit_keys, *, fixed=None):
    """Gauss-Newton (Laplace) 1-sigma uncertainties of the fitted values.

    J = d residuals / d params at the optimum, one forward-mode pass per
    parameter through the whole transient simulation (JAX: jax.jacfwd);
    Cov = s^2 (J^T J)^-1 with the noise variance s^2 estimated from the
    residual sum of squares over N - p degrees of freedom.  Returns
    {key: sigma}."""
    import torch.autograd.forward_ad as fwAD

    dtype, dev = measured.dtype, measured.device
    theta = torch.tensor([fitted[key] for key in fit_keys], dtype=dtype,
                         device=dev)
    fixed = dict(fixed or {})

    def residuals(th):
        params = dict(fixed)
        params.update({key: th[i] for i, key in enumerate(fit_keys)})
        return (forward(params) - measured).reshape(-1)

    with torch.no_grad():
        r = residuals(theta)
        cols = []
        for i in range(len(fit_keys)):
            with fwAD.dual_level():
                tangent = torch.zeros_like(theta)
                tangent[i] = 1.0
                cols.append(fwAD.unpack_dual(
                    residuals(fwAD.make_dual(theta, tangent))).tangent)
    J = torch.stack(cols, 1)
    n, p = J.shape
    s2 = float(r @ r) / max(n - p, 1)
    cov = s2 * torch.linalg.inv(J.T @ J)
    return {key: float(torch.sqrt(cov[i, i]))
            for i, key in enumerate(fit_keys)}


def load_measured(spec: str, n_probes: int):
    """'@file.csv' with columns t, T_probe0, T_probe1, ... (comma/space
    separated, '#' comments).  Returns (times, (n_samples, n_probes))."""
    if not spec.startswith("@"):
        raise SystemExit("--measured expects @file.csv")
    rows = []
    with open(spec[1:]) as f:
        for ln in f:
            ln = ln.split("#")[0].strip().replace(",", " ")
            if ln:
                rows.append([float(x) for x in ln.split()])
    arr = np.asarray(rows, np.float64)
    if arr.ndim != 2 or arr.shape[1] != n_probes + 1:
        raise SystemExit(f"--measured needs {n_probes + 1} columns "
                         f"(t + {n_probes} probes); got shape {arr.shape}")
    return arr[:, 0], arr[:, 1:]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Fit h/k/cp/emissivity to measured cooling curves "
                    "by adjoint")
    p.add_argument("--nx", type=int, default=20)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--nz", type=int, default=12)
    p.add_argument("--dx_mm", type=float, default=2.0)
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0, help="initial guess")
    p.add_argument("--k", type=float, default=54.0, help="initial guess")
    p.add_argument("--h", type=float, default=20.0, help="initial guess")
    p.add_argument("--T0", type=float, default=900.0)
    p.add_argument("--T_inf", type=float, default=25.0)
    p.add_argument("--dt", type=float, default=0.5)
    p.add_argument("--n_steps", type=int, default=120)
    p.add_argument("--sample_every", type=int, default=4)
    p.add_argument("--fit", type=str, default="h",
                   help="comma subset of h,k,cp,eps to fit (rho is "
                        "degenerate with cp — only the product rho*cp "
                        "enters); non-fitted ones are held at their flag "
                        "values, and 'eps' enables radiation")
    p.add_argument("--measured", type=str, default=None,
                   help="@file.csv with t + one column per probe; omit to "
                        "synthesize from --true_*")
    p.add_argument("--true_h", type=float, default=45.0)
    p.add_argument("--true_k", type=float, default=None)
    p.add_argument("--true_cp", type=float, default=None)
    p.add_argument("--eps", type=float, default=0.3,
                   help="initial emissivity guess (used when 'eps' in --fit)")
    p.add_argument("--true_eps", type=float, default=None)
    p.add_argument("--uq", type=int, default=0,
                   help="report Gauss-Newton 1-sigma uncertainties")
    p.add_argument("--noise_K", type=float, default=0.0,
                   help="synthetic measurement noise sigma [K]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--lr", type=float, default=0.08, help="adam only")
    p.add_argument("--optimizer", choices=["lbfgs", "adam"],
                   default="lbfgs")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run raises when CUDA is absent")
    return p


def run(args) -> dict:
    from ..core.grid import CartesianGrid
    from ..core.material import Material
    from ..io.logging import log

    device = resolve_device(args.device)
    dtype = torch.float64
    grid = CartesianGrid(args.nx, args.ny, args.nz, args.dx_mm * 1e-3)
    mat = Material(args.rho, args.cp, args.k)
    probes = default_probes(grid.shape)
    forward = make_measurement_forward(
        grid, mat, probes, t0=args.T0, t_inf=args.T_inf, dt=args.dt,
        n_steps=args.n_steps, sample_every=args.sample_every, dtype=dtype,
        device=device)

    fit_keys = [s.strip() for s in args.fit.split(",") if s.strip()]
    bad = [key for key in fit_keys if key not in ("h", "k", "cp", "eps")]
    if bad:
        raise SystemExit(f"--fit accepts h,k,cp,eps; got {bad}")

    # non-fitted parameters are held at their flag values; radiation is
    # active only when eps is fitted or --true_eps marks it as physics
    radiation = "eps" in fit_keys or args.true_eps is not None
    as_t = (lambda v: torch.tensor(v, dtype=dtype, device=device))
    fixed = {key: as_t(v) for key, v in
             (("h", args.h), ("k", args.k), ("cp", args.cp))
             if key not in fit_keys}
    if radiation and "eps" not in fit_keys:
        fixed["eps"] = as_t(args.eps)

    if args.measured:
        n_samples = args.n_steps // args.sample_every
        times, measured = load_measured(args.measured, len(probes))
        if measured.shape[0] != n_samples:
            raise SystemExit(f"--measured has {measured.shape[0]} samples "
                             f"but the schedule produces {n_samples} "
                             f"(n_steps/sample_every)")
        expect = (np.arange(n_samples) + 1) * args.sample_every * args.dt
        if not np.allclose(times, expect, rtol=1e-6, atol=1e-9):
            raise SystemExit(
                "--measured time column does not match the simulation "
                f"sample grid (dt*sample_every = {args.dt*args.sample_every}"
                f" s): file starts {times[:3]}, expected {expect[:3]} — "
                "adjust --dt/--sample_every/--n_steps to the data")
        measured = torch.tensor(measured, dtype=dtype, device=device)
    else:
        truth = {"h": args.true_h,
                 "k": args.true_k if args.true_k is not None else args.k,
                 "cp": args.true_cp if args.true_cp is not None else args.cp}
        if args.true_eps is not None or "eps" in fit_keys:
            truth["eps"] = (args.true_eps if args.true_eps is not None
                            else args.eps)
        log("synthesizing measurements from " +
            " ".join(f"{key}={v:g}" for key, v in truth.items()), tag="cal")
        with torch.no_grad():
            measured = forward({key: as_t(v) for key, v in truth.items()})
        if args.noise_K > 0.0:
            rng = np.random.default_rng(args.seed)
            measured = measured + torch.tensor(
                rng.normal(0.0, args.noise_K, tuple(measured.shape)),
                dtype=dtype, device=device)

    init = {"h": args.h, "k": args.k, "cp": args.cp, "eps": args.eps}
    fitted, history = fit(forward, measured, fit_keys, init,
                          iters=args.iters, lr=args.lr,
                          optimizer=args.optimizer, fixed=fixed,
                          log=lambda m: log(m, tag="cal"))
    result = {"fitted": fitted, "fit": fit_keys,
              "rms_final_K": history[-1] ** 0.5,
              "rms_initial_K": history[0] ** 0.5, "history": history}
    if args.uq:
        sig = uncertainty(forward, measured, fitted, fit_keys, fixed=fixed)
        result["sigma"] = sig
        log("1-sigma: " + " ".join(f"{key}={fitted[key]:.5g}+-{s_:.3g}"
                                   for key, s_ in sig.items()), tag="cal")
    if not args.measured:
        result["truth"] = {key: truth[key] for key in fit_keys}
        for key in fit_keys:
            err = abs(fitted[key] - truth[key]) / truth[key]
            log(f"{key}: fitted {fitted[key]:.5g} vs truth {truth[key]:g} "
                f"({100 * err:.2f}% off)", tag="cal")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
