"""WAAM deposition from an STL model (flagship CLI app), PyTorch port.

Counterpart: ``adi_thermal_fields_tpu/apps/waam_from_stl.py`` —
``load_voxels``, ``extract_layers``, ``parse_layer_times``,
``layer_birth_times``, ``run`` (:221) and ``main``.  Pipeline: STL (mm) ->
parity voxelization + solidify -> z-slab layers -> per-layer birth times
(slab-area estimate or measured ``--layer_times_s``) -> event-driven ADI
loop with element birth (apps/engine.py) on the chosen device.  The
variable-property flags (``--latent_J_kg``, ``--melt_k_factor``,
``--emissivity``) build the tables as the JAX app does (:318-349) and put
the engine on the variable-property step (kernels K5-K8).
``--corrected_bc 1`` replaces ``--h_side`` by the STL projected-area
corrected per-face h fields (geometry/bc_correction.py), which also scale
the radiative film under ``--emissivity`` (JAX :273-287): the constant
property step runs them on K1's field plan, the varprop step as per-axis
film streams (K5-K7, K19).

Example (on a CUDA machine):
    python -m adi_thermal_fields_tpu_torch.apps.waam_from_stl --stl part.stl \
        --dx_mm 1.0

``--precision bfloat16`` stores the field at bfloat16 and solves at
float32 (the kernels' bfloat16 entries: K4, K1, K2 or K3, K1 x3; with the
varprop flags the g-stream tier K23-K26, and with them and
``--corrected_bc 1`` the classic tier's K5b, K6b, K7b and K19b), rounding
every store stochastically, seeded by the engine's step counter.  The JAX
app rounds stochastically only on a TPU and warns elsewhere (:305-316);
the port's rounding runs on every device, CPU included.

Outputs (JAX :417-470): ``--save_vtk 1`` writes a VTK frame per frame
time into ``--outdir`` (binary past 2 M cells under ``--vtk_format
auto``); ``--checkpoint`` writes an npz checkpoint at every frame, and
``--resume`` restarts from one (also one the JAX app wrote), with its
thermal history when the thresholds match; ``--history_t_crit`` tracks
each voxel's peak temperature and seconds above each threshold and writes
them to ``waam_history.vtk`` (zero on never-born cells; two thresholds
also log the t8/5 cooling time); ``--interpass_T`` dwells before each
layer until the part has cooled to it.

``--device`` defaults to ``cuda`` and the run raises when CUDA is absent;
``--device cpu`` runs the kernels' plain versions.  Flags of the JAX app
that this port does not support yet (``--mesh``) exit with a message
naming them.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import resolve_device

__all__ = ["build_argparser", "load_voxels", "extract_layers",
           "parse_layer_times", "layer_birth_times", "run", "main"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="WAAM thermal simulation from STL (PyTorch port)")
    p.add_argument("--stl", type=str, required=True)
    p.add_argument("--dx_mm", type=float, default=1.0)
    p.add_argument("--dz_mm", type=float, default=None,
                   help="vertical (layer-direction) voxel size [mm]; "
                        "default dx_mm")
    p.add_argument("--pad_mm", type=float, default=2.0)
    p.add_argument("--voxel_method", choices=["parity", "shell"],
                   default="parity")
    p.add_argument("--auto_dx", type=int, default=1)
    p.add_argument("--max_voxels", type=int, default=12_000_000)
    p.add_argument("--solidify", choices=["auto", "fill", "close_flood",
                                          "none"], default="auto")
    p.add_argument("--solid_close_iters", type=int, default=1)
    # material
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0)
    p.add_argument("--k", type=float, default=54.0)
    # process
    p.add_argument("--bead_height_mm", type=float, default=2.0)
    p.add_argument("--bead_width_mm", type=float, default=6.0)
    p.add_argument("--scan_speed_mm_s", type=float, default=8.0)
    p.add_argument("--eta_fill", type=float, default=1.0)
    p.add_argument("--layer_times_s", type=str, default=None,
                   help="measured per-layer print durations [s]: a comma "
                        "list or '@file' with one duration per line")
    p.add_argument("--t_hold_s", type=float, default=0.0,
                   help="extra cool-down simulated after the last layer [s]")
    # BCs
    p.add_argument("--h_side", type=float, default=30.0)
    p.add_argument("--T_inf", type=float, default=20.0)
    p.add_argument("--Ts", type=float, default=1500.0)
    p.add_argument("--emissivity", type=float, default=0.0,
                   help="surface emissivity: adds the radiative film "
                        "h_rad(T) = eps*sigma*(T+T_inf)(T^2+T_inf^2) on top "
                        "of --h_side, refreshed every sub-step (0 = off)")
    # variable-property physics (step/cartesian_varprop.py)
    p.add_argument("--latent_J_kg", type=float, default=0.0,
                   help="latent heat of fusion [J/kg] via the apparent-cp "
                        "method over --solidus_C..--liquidus_C (steel "
                        "~2.7e5)")
    p.add_argument("--solidus_C", type=float, default=1420.0)
    p.add_argument("--liquidus_C", type=float, default=1470.0)
    p.add_argument("--cp_liquid", type=float, default=None,
                   help="liquid-phase cp [J/kg/K]; default = --cp")
    p.add_argument("--melt_k_factor", type=float, default=1.0,
                   help="melt-pool convection proxy: conductivity "
                        "enhancement above the liquidus (1 disables)")
    # numerics
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--cfl", type=float, default=2.0)
    p.add_argument("--precision", choices=["float32", "float64", "bfloat16"],
                   default="float32")
    p.add_argument("--nframes", type=int, default=12)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run raises when CUDA is absent")
    p.add_argument("--implementation", choices=["kernels", "reference"],
                   default="kernels",
                   help="kernels: K1-K4 (K5-K8 and K19 with variable "
                        "properties) on CUDA, plain versions on CPU; "
                        "reference: the plain step")
    p.add_argument("--corrected_bc", type=int, default=0,
                   help="1: STL projected-area corrected per-face Robin "
                        "fields instead of the uniform --h_side")
    # output
    p.add_argument("--save_vtk", type=int, default=0)
    p.add_argument("--vtk_format", choices=["auto", "ascii", "binary"],
                   default="auto",
                   help="auto = binary above 2M cells, ascii below")
    p.add_argument("--outdir", type=str, default="waam_out",
                   help="directory of the VTK frames and waam_history.vtk "
                        "(made when something is written)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="write a resume checkpoint (npz) at every frame")
    p.add_argument("--resume", type=str, default="",
                   help="resume from a checkpoint file (the port's or the "
                        "JAX app's)")
    p.add_argument("--interpass_T", type=float, default=None,
                   help="interpass temperature control [C]: dwell (keep "
                        "cooling) before each layer until the part's max "
                        "temperature is at or below this")
    p.add_argument("--interpass_dwell_s", type=float, default=5.0)
    p.add_argument("--interpass_max_dwell_s", type=float, default=600.0)
    p.add_argument("--history_t_crit", type=str, default=None,
                   help="track per-voxel thermal history: peak temperature "
                        "and seconds above the critical temperature(s) [C]; "
                        "a comma list tracks each ('800,500' gives the "
                        "steel t8/5 as t_above_500 - t_above_800), written "
                        "to waam_history.vtk")
    p.add_argument("--viewer", type=int, default=0)
    # JAX-app flags not ported yet: parsed so that they exit with a message
    p.add_argument("--mesh", type=str, default="")
    return p


def _reject_unsupported(args) -> None:
    """Exit with a message for flags this port does not support yet."""
    bad = [name for name, on in (
        ("--mesh", bool(args.mesh)),
        # the reference step cannot round stochastically (the JAX engine
        # refuses it too)
        ("--precision bfloat16 with --implementation reference",
         args.precision == "bfloat16"
         and args.implementation == "reference")) if on]
    if bad:
        raise SystemExit("not supported by the PyTorch port yet: "
                         + ", ".join(bad)
                         + " (the JAX package's app runs them)")


def load_voxels(args):
    """STL -> solid voxel mask (+ origin, per-axis spacing in meters,
    mesh)."""
    from ..geometry.morphology import solidify_mask
    from ..geometry.stl import load_stl
    from ..geometry.voxelize import (auto_cell_size, grid_from_mesh,
                                     voxelize_shell, voxelize_solid)
    from ..io.logging import log

    mesh = load_stl(args.stl, units="auto")
    dx = args.dx_mm * 1e-3
    dz_fixed = args.dz_mm * 1e-3 if args.dz_mm is not None else None
    if args.auto_dx:
        dx2 = auto_cell_size(mesh, dx, args.max_voxels, dz=dz_fixed)
        if dx2 != dx:
            log(f"auto-dx: {dx * 1e3:.3g} -> {dx2 * 1e3:.3g} mm to fit "
                f"{args.max_voxels} voxel budget", tag="vox")
            dx = dx2
    dz = dz_fixed if dz_fixed is not None else dx
    d = (dx, dx, dz)
    # per-axis pad cell counts: --pad_mm is the same margin on every axis
    pad = tuple(max(1, int(round(args.pad_mm * 1e-3 / dv))) for dv in d)
    origin, dims = grid_from_mesh(mesh, d, pad_cells=pad)
    if args.voxel_method == "parity":
        mask, _ = voxelize_solid(mesh, d, origin=origin, dims=dims)
    else:
        mask, _ = voxelize_shell(mesh, d, origin=origin, dims=dims)
    mask = solidify_mask(mask, mode=args.solidify,
                         closing_iters=args.solid_close_iters)
    log(f"grid {dims}, dx={dx * 1e3:.4g} mm"
        + (f", dz={dz * 1e3:.4g} mm" if dz != dx else "")
        + f", solid {int(mask.sum())} voxels "
        f"({mask.mean() * 100:.1f}%)", tag="vox")
    return mesh, mask, origin, d


def extract_layers(mask: np.ndarray, cells_per_layer: int):
    """Z-slab layers (ks, ke) covering the solid."""
    k_idx = np.nonzero(mask.any(axis=(0, 1)))[0]
    if k_idx.size == 0:
        raise RuntimeError("voxelized model is empty")
    kmin, kmax = int(k_idx.min()), int(k_idx.max())
    layers = []
    ks = kmin
    while ks <= kmax:
        while ks <= kmax and not mask[:, :, ks].any():
            ks += 1
        if ks > kmax:
            break
        ke = min(kmax, ks + cells_per_layer - 1)
        while ke >= ks and not mask[:, :, ke].any():
            ke -= 1
        if ke < ks:
            ks += 1
            continue
        layers.append((ks, ke))
        ks = ke + 1
    return layers


def parse_layer_times(spec: str) -> list:
    """Per-layer print durations [s] from a comma list or '@file' (one
    duration per line; blank lines and '#' comments ignored)."""
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            items = [ln.split("#")[0].strip() for ln in f]
        items = [x for x in items if x]
    else:
        items = [x.strip() for x in spec.split(",") if x.strip()]
    durations = [float(x) for x in items]
    bad = [d for d in durations if not (d > 0.0)]
    if bad:
        raise SystemExit(f"--layer_times_s durations must be positive; "
                         f"got {bad[:3]}")
    return durations


def layer_birth_times(mask, layers, dx, bead_width_m, scan_speed_m_s,
                      eta_fill):
    """Cumulative print-time estimate per layer from mean slab area."""
    times = []
    t = 0.0
    a_pix = dx * dx
    for ks, ke in layers:
        areas = [float(mask[:, :, k].sum()) * a_pix for k in range(ks, ke + 1)]
        A = float(np.mean(areas)) if areas else 0.0
        L_est = (A / max(bead_width_m, 1e-12)) * max(eta_fill, 1.0)
        t += L_est / max(scan_speed_m_s, 1e-12)
        times.append(t)
    return times


def run(args) -> dict:
    from ..core.grid import CartesianGrid
    from ..core.material import Material
    from ..io.checkpoint import (RunState, load_checkpoint, save_checkpoint,
                                 to_numpy)
    from ..io.logging import fmt_bytes, log
    from ..io.vtk import write_vtk_structured_points
    from ..step.cartesian_varprop import apparent_cp, melt_pool_enhanced_k
    from .engine import EventLoop, make_cartesian_engine

    _reject_unsupported(args)
    device = resolve_device(args.device)

    mesh, mask_full, origin, d = load_voxels(args)
    dx, _, dz = d
    nx, ny, nz = mask_full.shape
    grid = CartesianGrid(nx, ny, nz, dx, dz=dz)
    mat = Material(args.rho, args.cp, args.k)

    dtype = {"float32": torch.float32, "float64": torch.float64,
             "bfloat16": torch.bfloat16}[args.precision]
    bytes_T = grid.ncells * torch.empty((), dtype=dtype).element_size()
    log(f"field memory ~{fmt_bytes(bytes_T)} + mask {fmt_bytes(grid.ncells)}"
        f" on {device}", tag="mem")

    n_per_layer = max(1, int(round(args.bead_height_mm * 1e-3 / dz)))
    layers = extract_layers(mask_full, n_per_layer)
    if args.layer_times_s:
        durations = parse_layer_times(args.layer_times_s)
        if len(durations) != len(layers):
            raise SystemExit(
                f"--layer_times_s supplies {len(durations)} durations but "
                f"{len(layers)} layers were extracted (bead_height "
                f"{args.bead_height_mm} mm over {dz*1e3:g} mm voxels)")
        births = list(np.cumsum(durations))
    else:
        births = layer_birth_times(mask_full, layers, dx,
                                   args.bead_width_mm * 1e-3,
                                   args.scan_speed_mm_s * 1e-3,
                                   args.eta_fill)
    total_time = (births[-1] if births else 0.0) + args.t_hold_s
    log(f"{len(layers)} layers, n_per_layer={n_per_layer}, "
        f"total print time ~{births[-1] if births else 0.0:.2f} s"
        + (f" + {args.t_hold_s:g} s hold" if args.t_hold_s else ""),
        tag="layers")

    # per-cell activation times: layer j's in-mask cells are born at its
    # START time (layer 0 at t=0)
    act = np.full(grid.shape, np.inf)
    start_times = [0.0] + births[:-1]
    for (ks, ke), tb in zip(layers, start_times):
        sl = mask_full[:, :, ks:ke + 1]
        act[:, :, ks:ke + 1] = np.where(sl, tb, act[:, :, ks:ke + 1])
    act = torch.from_numpy(act).to(device)

    # variable-property physics: latent heat (apparent cp), melt-pool
    # convection proxy, radiation -- the terms that dominate at 1500 C
    k_table = cp_table = None
    emissivity = args.emissivity if args.emissivity > 0 else None
    if args.latent_J_kg > 0:
        cp_table = apparent_cp(args.cp, args.cp_liquid or args.cp,
                               args.latent_J_kg, args.solidus_C,
                               args.liquidus_C)
        log(f"latent heat {args.latent_J_kg:.3g} J/kg over "
            f"{args.solidus_C:g}-{args.liquidus_C:g} C (apparent cp)",
            tag="phys")
    if args.melt_k_factor != 1.0:
        k_table = melt_pool_enhanced_k(args.k, args.solidus_C,
                                       args.liquidus_C,
                                       enhancement=args.melt_k_factor)
        log(f"melt-pool k proxy: {args.melt_k_factor:g}x above "
            f"{args.liquidus_C:g} C", tag="phys")
    if emissivity is not None:
        log(f"radiative film, emissivity {emissivity:g}"
            + (" (area-corrected)" if args.corrected_bc else ""), tag="phys")

    robin_h, rad_scale = args.h_side, None
    if args.corrected_bc:
        # per-axis spacing: the corrector normalizes by each direction's
        # voxel-face area, so --dz_mm composes
        from ..geometry.bc_correction import corrected_robin_fields
        fields, scale = corrected_robin_fields(
            mesh, mask_full, origin, d,
            {f: args.h_side for f in ("x-", "x+", "y-", "y+", "z-", "z+")})
        robin_h = {f: torch.as_tensor(v, dtype=dtype, device=device)
                   for f, v in fields.items()}
        # the same area ratios scale the radiative film
        rad_scale = {f: torch.as_tensor(v, dtype=dtype, device=device)
                     for f, v in scale.items()}
        log("using STL projected-area corrected Robin fields", tag="bc")

    hist_crits = None
    crits_np = None     # canonical threshold array (checkpoint meta/guard)
    if args.history_t_crit is not None:
        vals = tuple(float(v) for v in str(args.history_t_crit).split(","))
        hist_crits = vals if len(vals) > 1 else vals[0]
        crits_np = np.atleast_1d(np.asarray(vals))

    prepare, advance = make_cartesian_engine(
        grid, mat, implementation=args.implementation, device=device,
        dtype=dtype, theta=args.theta, t_inf=args.T_inf, robin_h=robin_h,
        history_t_crit=hist_crits,
        k_table=k_table, cp_table=cp_table, emissivity=emissivity,
        radiation_scale=rad_scale if emissivity is not None else None,
        stochastic_rounding=dtype == torch.bfloat16)
    dmin = min(d)
    dt_cap = args.cfl * dmin * dmin / mat.alpha
    log(f"alpha={mat.alpha:.3e} m^2/s, dt_cap={dt_cap:.3e} s "
        f"(cfl={args.cfl}), implementation={args.implementation}", tag="num")

    T = torch.full(grid.shape, args.T_inf, dtype=dtype, device=device)
    start_t = 0.0
    resume_history = None
    if args.resume:
        st = load_checkpoint(args.resume)
        T = torch.as_tensor(np.asarray(st.T, np.float64)).to(
            device=device, dtype=dtype)
        start_t = st.t
        if args.history_t_crit is not None and st.meta \
                and "history_peak" in st.meta:
            ha = st.meta["history_above"]
            # t_above's leading threshold axis must match the current
            # --history_t_crit
            nth = len(hist_crits) if isinstance(hist_crits, tuple) else None
            want = (grid.shape if nth is None
                    else (nth,) + tuple(grid.shape))
            if tuple(ha.shape) != tuple(want):
                raise SystemExit(
                    f"checkpoint thermal-history shape {tuple(ha.shape)} does "
                    f"not match --history_t_crit {args.history_t_crit} "
                    f"(expected {want}); resume with the same threshold list "
                    "the checkpoint was written with")
            ck_crits = st.meta.get("history_crits")
            if ck_crits is not None and not np.array_equal(
                    np.atleast_1d(ck_crits), crits_np):
                raise SystemExit(
                    f"checkpoint thermal-history thresholds "
                    f"{np.atleast_1d(ck_crits).tolist()} != "
                    f"--history_t_crit {crits_np.tolist()}; resuming "
                    "would mix accumulators measured against different "
                    "temperatures")
            # t_above accumulates at solve precision (>= float32)
            resume_history = (
                torch.as_tensor(np.asarray(st.meta["history_peak"],
                                           np.float64)).to(
                    device=device, dtype=dtype),
                torch.as_tensor(np.asarray(ha)).to(
                    device=device,
                    dtype=torch.promote_types(dtype, torch.float32)))
            log("resumed thermal-history state from checkpoint", tag="ckpt")
        log(f"resumed from {args.resume} at t={start_t:.3f} s", tag="ckpt")

    frame_times = (np.linspace(0.0, total_time, args.nframes).tolist()
                   if args.nframes > 1 and total_time > 0 else [0.0])
    frames_meta = []
    binary = (args.vtk_format == "binary"
              or (args.vtk_format == "auto" and grid.ncells > 2_000_000))
    vtk_geo = dict(spacing=tuple(v * 1e3 for v in d),
                   origin=tuple(np.asarray(origin) * 1e3), binary=binary)

    def on_frame(t, T_d, active):
        T_np = to_numpy(T_d)           # bfloat16 at float32
        a_np = active.cpu().numpy()
        n_act = int(a_np.sum())
        tmax = float(np.nanmax(np.where(a_np, T_np, np.nan))) if n_act else 0.0
        if not np.isfinite(tmax) or abs(tmax) > 1e5:
            log(f"suspicious field values at t={t:.3f}: Tmax={tmax:.3g}",
                tag="warn")
        log(f"t={t:9.3f} s  active={n_act}  Tmax={tmax:8.1f}", tag="frame")
        frames_meta.append((t, n_act, tmax))
        if args.save_vtk:
            os.makedirs(args.outdir, exist_ok=True)
            write_vtk_structured_points(
                os.path.join(args.outdir, f"waam_{t:010.3f}.vtk"),
                {"Temperature": T_np, "Mask": a_np.astype(np.float32)},
                **vtk_geo)
        if args.checkpoint:
            meta = None
            if args.history_t_crit is not None \
                    and loop.history_state is not None:
                pk_c, ta_c = loop.history_state
                meta = {"history_peak": pk_c, "history_above": ta_c,
                        "history_crits": crits_np}
            save_checkpoint(args.checkpoint,
                            RunState(T=T_np, active=a_np, t=t, meta=meta))

    loop = EventLoop(advance=advance, prepare=prepare, activation_times=act,
                     deposit_T=args.Ts, dt_cap=dt_cap,
                     history=args.history_t_crit is not None,
                     history_thresholds=(hist_crits if isinstance(
                         hist_crits, tuple) else None),
                     interpass_T=args.interpass_T,
                     interpass_dwell=args.interpass_dwell_s,
                     interpass_max_dwell=args.interpass_max_dwell_s)
    T, active, t = loop.run(T, frame_times=frame_times, t_end=total_time,
                            on_frame=on_frame, start_t=start_t,
                            history_state=resume_history)
    if loop.dwell_log:
        tot = sum(dw for _, dw in loop.dwell_log)
        log(f"interpass dwells: {len(loop.dwell_log)} layers, "
            f"{tot:.1f} s total cooling inserted", tag="interpass")
    log(f"done: {len(frames_meta)} frames, {loop.substeps} sub-steps",
        tag="done")

    if args.history_t_crit is not None:
        pk_np, ta_np = (to_numpy(x) for x in loop.history_state)
        a_np = active.cpu().numpy()
        fn = os.path.join(args.outdir, "waam_history.vtk")
        # never-born cells carry no meaningful history: masked to 0
        fields = {"T_peak": np.where(a_np, pk_np.astype(np.float32), 0.0)}
        if isinstance(hist_crits, tuple):
            for tc, ta_i in zip(hist_crits, ta_np):
                key = f"t_above_{tc:g}".replace(".", "p")
                fields[key] = np.where(a_np, ta_i.astype(np.float32), 0.0)
        else:
            fields["t_above"] = np.where(a_np, ta_np.astype(np.float32), 0.0)
        fields["Mask"] = a_np.astype(np.float32)
        os.makedirs(args.outdir, exist_ok=True)
        write_vtk_structured_points(fn, fields, **vtk_geo)
        if isinstance(hist_crits, tuple) and len(hist_crits) == 2 \
                and a_np.any():
            t85 = ta_np[1] - ta_np[0]
            log(f"t{hist_crits[0]:g}/{hist_crits[1]:g}: max "
                f"{float(t85[a_np].max()):.3f} s, mean (deposited) "
                f"{float(t85[a_np].mean()):.3f} s", tag="history")
        log(f"thermal history (T_crit={args.history_t_crit}) -> {fn}",
            tag="history")

    if args.viewer and frames_meta:
        log("viewer: load the VTK series in ParaView, or use "
            "adi_thermal_fields_tpu_torch.apps.viewer on saved frames",
            tag="viewer")
    return {"T": T, "active": active, "t": t, "frames": frames_meta,
            "grid": grid, "layers": layers, "births": births,
            "substeps": loop.substeps, "history": loop.history_state,
            "dwell_log": loop.dwell_log}


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
