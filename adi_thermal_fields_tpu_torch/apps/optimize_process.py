"""Adjoint-based WAAM process-schedule optimization (CLI app).

Counterpart: ``adi_thermal_fields_tpu/apps/optimize_process.py`` (:1-397).
Inverse process design: differentiate through the whole transient ADI
simulation of a layer-by-layer wall build and descend per-layer process
parameters so every layer hits a target t8/5 cooling time (the 800 -> 500
C dwell that controls steel microstructure).  As a wall grows, heat
accumulates and later layers cool ever slower; the optimizer finds the
per-layer deposit superheat or inter-layer dwell that equalizes it.

The simulation runs on the plain steps, as the JAX app does:
``step/cartesian.adi_step`` at theta 1, or with ``--latent_J_kg``
``step/cartesian_varprop.adi_step_varprop(implementation="reference")``.
Autograd runs through every Thomas solve of every sub-step; the JAX
``lax.scan`` loops are Python loops here, each layer is rematerialized in
the backward pass by ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint``)
so one layer's sub-steps are live at a time, and ``optax.adam`` is
``torch.optim.Adam``.

Decision variables (``--var``):
  deposit_T : per-layer deposit temperature [C]
  dwell     : per-layer inter-layer dwell time [s], kept positive by a
              softplus reparameterization (its stable inverse as JAX's,
              :226-233), optionally charged a total-time penalty.

The per-layer t8/5 proxy integrates a smooth band indicator of the
layer's mean temperature, ``integral dt sigma((Tm-500)/w)
sigma((800-Tm)/w)``, with the clock stopped at the layer's first drop
below the band (``--t85_mode first_crossing``) or counting every
in-band second (``occupancy``).

``--device`` defaults to ``cuda`` and the run raises when CUDA is absent;
``--device cpu`` runs on the CPU.  The simulation runs at float64, as the
JAX app does under x64.

Example:
    python -m adi_thermal_fields_tpu_torch.apps.optimize_process \\
        --layers 8 --target_t85 6 --var deposit_T --iters 40
"""
from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

from . import resolve_device

__all__ = ["build_wall_problem", "make_forward", "optimize", "run",
           "build_argparser"]


def build_wall_problem(*, nx: int, ny: int, nz_plate: int, n_layers: int,
                       layer_vox: int, wall_w_vox: int, dx: float,
                       mat, h: float, t_inf: float, dtype,
                       device="cuda"):
    """Static geometry for a thin wall grown on a plate.

    Returns (grid, masks, newborn, probe_w) on ``device`` (the card unless
    the caller passes ``"cpu"``; raises when CUDA is absent):
      masks   : (L, nx, ny, nz) bool — active cells after layer i deposited
      newborn : (L, nx, ny, nz) bool — cells born at layer i
      probe_w : (L, N) dtype — row i = normalized indicator of layer i's
                cells (probe weights for the layer-mean temperature)
    """
    from ..core.grid import CartesianGrid

    device = resolve_device(device)
    nz = nz_plate + n_layers * layer_vox
    grid = CartesianGrid(nx, ny, nz, dx)

    plate = np.zeros(grid.shape, bool)
    plate[:, :, :nz_plate] = True

    x0 = nx // 2 - wall_w_vox // 2
    wall_cols = slice(x0, x0 + wall_w_vox)

    masks, newborn, probes = [], [], []
    cur = plate.copy()
    for i in range(n_layers):
        z0 = nz_plate + i * layer_vox
        born = np.zeros(grid.shape, bool)
        born[wall_cols, :, z0:z0 + layer_vox] = True
        cur = cur | born
        masks.append(cur.copy())
        newborn.append(born)
        w = born.astype(np.float64).ravel()
        probes.append(w / w.sum())

    return (grid,
            torch.from_numpy(np.stack(masks)).to(device),
            torch.from_numpy(np.stack(newborn)).to(device),
            torch.from_numpy(np.stack(probes)).to(device=device,
                                                  dtype=dtype))


def make_forward(grid, masks, newborn, probe_w, mat, *, h: float,
                 t_inf: float, n_sub: int, target_t85: float,
                 band=(500.0, 800.0), band_w: float = 15.0,
                 time_penalty: float = 0.0, dtype=torch.float64,
                 k_table=None, cp_table=None,
                 interpass_limit=None, interpass_penalty: float = 1.0,
                 target_weight: float = 1.0,
                 t85_mode: str = "first_crossing"):
    """Build the differentiable ``forward(deposit_T, dwell_s) -> (loss,
    aux)``: backward-Euler sub-steps (theta 1, so any dwell length stays
    stable), ``aux = dict(t85=(L,), T_final=..., interpass=(L,))``.

    ``k_table``/``cp_table``: optional T-dependent properties (e.g.
    ``apparent_cp`` with latent heat) through the varprop reference step.
    ``interpass_limit``: the top layer's mean temperature at the end of
    each segment but the last is charged ``interpass_penalty * relu(T -
    limit)^2``.  ``t85_mode``: 'first_crossing' stops a layer's t8/5
    clock at its first drop below the band; 'occupancy' counts all
    in-band time (JAX :98-125)."""
    from ..bc.packs import build_coeff_packs
    from ..step.cartesian import adi_step
    from ..step.cartesian_varprop import adi_step_varprop

    L = int(masks.shape[0])
    t_lo, t_hi = band
    packs = [build_coeff_packs(masks[i], grid, mat, robin_h=h, dtype=dtype)
             for i in range(L)]
    layer_ids = torch.arange(L, device=masks.device)

    def band_ind(tm):
        return (torch.sigmoid((tm - t_lo) / band_w)
                * torch.sigmoid((t_hi - tm) / band_w))

    if t85_mode not in ("first_crossing", "occupancy"):
        raise ValueError(f"unknown t85_mode {t85_mode!r} "
                         "(first_crossing | occupancy)")

    def layer_segment(i, T, t85, done, dep_i, dwell_i):
        mask_i, pk_i = masks[i], packs[i]
        T = torch.where(newborn[i], dep_i.to(dtype), T)
        dt = (dwell_i / n_sub).to(dtype)
        deposited = (layer_ids <= i).to(dtype)
        for _ in range(n_sub):
            if k_table is not None or cp_table is not None:
                T = adi_step_varprop(T, mask_i, pk_i, grid, mat, dt=dt,
                                     theta=1.0, t_inf=t_inf,
                                     k_table=k_table, cp_table=cp_table,
                                     implementation="reference")
            else:
                T = adi_step(T, mask_i, pk_i, grid, mat, dt=dt, theta=1.0,
                             t_inf=t_inf)
            tm = probe_w @ T.reshape(-1)           # (L,) layer-mean probes
            t85 = t85 + dt * deposited * (1.0 - done) * band_ind(tm)
            if t85_mode == "first_crossing":
                # the clock stops at the first sub-band reading
                done = torch.maximum(done, deposited * (tm < t_lo))
        # interpass reading: the just-deposited layer's mean T at the end
        # of its segment (the temperature the next layer is laid onto)
        tip = (probe_w @ T.reshape(-1))[i]
        return T, t85, done, tip

    def forward(deposit_T, dwell_s):
        dev = masks.device
        T = torch.full(grid.shape, t_inf, dtype=dtype, device=dev)
        t85 = torch.zeros(L, dtype=dtype, device=dev)
        done = torch.zeros(L, dtype=dtype, device=dev)
        dep, dwl = deposit_T.to(dtype), dwell_s.to(dtype)
        tips = []
        for i in range(L):
            seg = functools.partial(layer_segment, i)
            if torch.is_grad_enabled():
                # rematerialize per layer: the backward keeps one layer's
                # sub-steps live at a time, not the whole build
                T, t85, done, tip = torch.utils.checkpoint.checkpoint(
                    seg, T, t85, done, dep[i], dwl[i], use_reentrant=False)
            else:
                T, t85, done, tip = seg(T, t85, done, dep[i], dwl[i])
            tips.append(tip)
        interpass = torch.stack(tips)

        miss = t85 - target_t85
        loss = target_weight * torch.mean(miss * miss)
        if time_penalty:
            loss = loss + time_penalty * torch.sum(dwell_s)
        if interpass_limit is not None:
            over = torch.clamp(interpass - interpass_limit, min=0.0)
            # the last segment is exempt: nothing is deposited after it
            w_next = (layer_ids < L - 1).to(dtype)
            loss = loss + interpass_penalty * (
                torch.sum(w_next * over * over) / max(L - 1, 1))
        return loss, {"t85": t85, "T_final": T, "interpass": interpass}

    return forward


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` forms it
    (``logaddexp(x, 0)``), with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def dwell_params(dwell_s0, dwell_min: float) -> torch.Tensor:
    """The softplus parameters of a dwell schedule: ``dwell = dwell_min +
    softplus(p)``.  Stable inverse: ``expm1`` overflows above ~709, but
    softplus(x) == x to float64 precision beyond ~30 (JAX :226-233)."""
    x = torch.clamp(dwell_s0 - dwell_min, min=1e-3)
    return torch.where(x > 30.0, x,
                       torch.log(torch.expm1(torch.clamp(x, max=30.0))))


def optimize(forward, var: str, deposit_T0, dwell_s0, *, iters: int,
             lr: float, dwell_min: float = 0.5, log=print):
    """Adam on the selected variable; returns (deposit_T, dwell_s,
    history)."""
    if var == "deposit_T":
        params = deposit_T0.detach().clone().to(torch.float64)

        def loss_fn(p):
            return forward(p, dwell_s0.to(p.dtype))
    elif var == "dwell":
        params = dwell_params(dwell_s0.detach().to(torch.float64), dwell_min)

        def loss_fn(p):
            return forward(deposit_T0.to(p.dtype), dwell_min + softplus(p))
    else:
        raise ValueError(f"unknown --var {var!r} (deposit_T | dwell)")

    params.requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr)
    history = []
    for it in range(iters):
        opt.zero_grad()
        loss, aux = loss_fn(params)
        loss.backward()
        loss = float(loss.detach())
        history.append(loss)
        if log is not None and (it % max(1, iters // 10) == 0
                                or it == iters - 1):
            t85 = aux["t85"].detach().cpu().numpy()
            log(f"iter {it:4d} loss {loss:.6g} "
                f"t85 [{t85.min():.3g}, {t85.max():.3g}] s")
        opt.step()

    params = params.detach()
    if var == "deposit_T":
        return params, dwell_s0.to(params.dtype), history
    return (deposit_T0.to(params.dtype), dwell_min + softplus(params),
            history)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Adjoint optimization of a WAAM wall-build schedule")
    p.add_argument("--nx", type=int, default=24)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--nz_plate", type=int, default=6)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--layer_vox", type=int, default=2)
    p.add_argument("--wall_w_vox", type=int, default=3)
    p.add_argument("--dx_mm", type=float, default=1.5)
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0)
    p.add_argument("--k", type=float, default=30.0)
    p.add_argument("--h", type=float, default=80.0)
    p.add_argument("--T_inf", type=float, default=25.0)
    p.add_argument("--deposit_T", type=float, default=1550.0)
    p.add_argument("--dwell_s", type=float, default=8.0)
    p.add_argument("--n_sub", type=int, default=24,
                   help="ADI sub-steps per layer interval")
    p.add_argument("--target_t85", type=float, default=6.0,
                   help="target 800->500 C cooling time [s]")
    p.add_argument("--band_w", type=float, default=15.0,
                   help="smooth band indicator width [K]")
    p.add_argument("--t85_mode", choices=["first_crossing", "occupancy"],
                   default="first_crossing",
                   help="stop each layer's t8/5 clock at its first drop "
                        "below the band (metallurgical 800->500 time) or "
                        "count all in-band time incl. reheat excursions")
    p.add_argument("--var", choices=["deposit_T", "dwell"],
                   default="deposit_T")
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--lr", type=float, default=None,
                   help="Adam step (default: 20 for deposit_T, 0.2 for dwell)")
    p.add_argument("--time_penalty", type=float, default=0.0,
                   help="loss += penalty * total dwell [1/s] (dwell mode)")
    p.add_argument("--interpass_limit_C", type=float, default=None,
                   help="soft interpass-temperature constraint [C]: "
                        "penalize each layer's mean T at segment end above "
                        "this; combine with --var dwell --time_penalty "
                        "(and optionally --target_weight 0) to find the "
                        "fastest schedule that respects the limit")
    p.add_argument("--interpass_penalty", type=float, default=1.0)
    p.add_argument("--target_weight", type=float, default=1.0,
                   help="weight of the t8/5 target term (0 disables it)")
    p.add_argument("--latent_J_kg", type=float, default=0.0,
                   help="latent heat of fusion [J/kg]; releases inside the "
                        "solidus..liquidus band via apparent cp(T) — the "
                        "varprop (differentiable) forward.  NOTE: apparent "
                        "cp acts on steps whose starting T lies in the band; "
                        "pick n_sub so the cooling trajectory samples it "
                        "(a first deposit step can drop hundreds of K)")
    p.add_argument("--solidus_C", type=float, default=1420.0)
    p.add_argument("--liquidus_C", type=float, default=1470.0)
    p.add_argument("--out", type=str, default=None,
                   help="write the optimized schedule as JSON")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run raises when CUDA is absent")
    return p


def run(args) -> dict:
    from ..core.material import Material
    from ..io.logging import log

    device = resolve_device(args.device)
    mat = Material(args.rho, args.cp, args.k)
    dtype = torch.float64
    grid, masks, newborn, probe_w = build_wall_problem(
        nx=args.nx, ny=args.ny, nz_plate=args.nz_plate,
        n_layers=args.layers, layer_vox=args.layer_vox,
        wall_w_vox=args.wall_w_vox, dx=args.dx_mm * 1e-3, mat=mat,
        h=args.h, t_inf=args.T_inf, dtype=dtype, device=device)
    cp_table = None
    if args.latent_J_kg > 0.0:
        from ..step.cartesian_varprop import apparent_cp
        cp_table = apparent_cp(args.cp, args.cp, args.latent_J_kg,
                               args.solidus_C, args.liquidus_C)
    forward = make_forward(grid, masks, newborn, probe_w, mat, h=args.h,
                           t_inf=args.T_inf, n_sub=args.n_sub,
                           target_t85=args.target_t85, band_w=args.band_w,
                           time_penalty=args.time_penalty, dtype=dtype,
                           cp_table=cp_table,
                           interpass_limit=args.interpass_limit_C,
                           interpass_penalty=args.interpass_penalty,
                           target_weight=args.target_weight,
                           t85_mode=args.t85_mode)

    L = args.layers
    dep0 = torch.full((L,), args.deposit_T, dtype=dtype, device=device)
    dw0 = torch.full((L,), args.dwell_s, dtype=dtype, device=device)

    with torch.no_grad():
        loss0, aux0 = forward(dep0, dw0)
    t85_0 = aux0["t85"].cpu().numpy()
    log(f"initial loss {float(loss0):.6g}; "
        f"t85 spread [{t85_0.min():.3g}, {t85_0.max():.3g}] s "
        f"(target {args.target_t85})")

    lr = args.lr if args.lr is not None else (
        20.0 if args.var == "deposit_T" else 0.2)
    dep, dw, history = optimize(forward, args.var, dep0, dw0,
                                iters=args.iters, lr=lr,
                                log=lambda m: log(m, tag="opt"))
    with torch.no_grad():
        loss1, aux1 = forward(dep, dw)
    t85_1 = aux1["t85"].cpu().numpy()
    log(f"final loss {float(loss1):.6g}; "
        f"t85 spread [{t85_1.min():.3g}, {t85_1.max():.3g}] s")

    result = {
        "var": args.var,
        "loss_initial": float(loss0),
        "loss_final": float(loss1),
        "t85_initial": t85_0.tolist(),
        "t85_final": t85_1.tolist(),
        "deposit_T": dep.cpu().numpy().tolist(),
        "dwell_s": dw.cpu().numpy().tolist(),
        "interpass_final": aux1["interpass"].cpu().numpy().tolist(),
        "history": history,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        log(f"schedule written to {args.out}", tag="opt")
    return result


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
