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
varprop flags the g-stream tier K23-K26), rounding every store
stochastically, seeded by the engine's step counter.  The JAX app rounds
stochastically only on a TPU and warns elsewhere (:305-316); the port's
rounding runs on every device, CPU included.

``--device`` defaults to ``cuda`` and the run raises when CUDA is absent;
``--device cpu`` runs the kernels' plain versions.  Flags of the JAX app
that this port does not support yet exit with a message naming them.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

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
    # JAX-app flags not ported yet: parsed so that they exit with a message
    p.add_argument("--mesh", type=str, default="")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--save_vtk", type=int, default=0)
    p.add_argument("--history_t_crit", type=str, default=None)
    p.add_argument("--interpass_T", type=float, default=None)
    return p


def _reject_unsupported(args) -> None:
    """Exit with a message for flags this port does not support yet."""
    bf16 = args.precision == "bfloat16"
    varprop = (args.emissivity > 0 or args.latent_J_kg > 0
               or args.melt_k_factor != 1.0)
    bad = [name for name, on in (
        ("--mesh", bool(args.mesh)),
        ("--checkpoint", bool(args.checkpoint)),
        ("--resume", bool(args.resume)),
        ("--save_vtk", args.save_vtk != 0),
        ("--history_t_crit", args.history_t_crit is not None),
        ("--interpass_T", args.interpass_T is not None),
        # per-face films with variable properties run the classic varprop
        # tier, whose bfloat16 entries (K5-K7, K19) are not ported
        ("--precision bfloat16 on area-corrected films with variable "
         "properties", bf16 and bool(args.corrected_bc) and varprop),
        # the reference step cannot round stochastically
        ("--precision bfloat16 with --implementation reference",
         bf16 and args.implementation == "reference")) if on]
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
    from ..io.logging import fmt_bytes, log
    from ..step.cartesian_varprop import apparent_cp, melt_pool_enhanced_k
    from .engine import EventLoop, make_cartesian_engine

    _reject_unsupported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass "
                           "--device cpu to run the plain versions")

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

    prepare, advance = make_cartesian_engine(
        grid, mat, implementation=args.implementation, device=device,
        dtype=dtype, theta=args.theta, t_inf=args.T_inf, robin_h=robin_h,
        k_table=k_table, cp_table=cp_table, emissivity=emissivity,
        radiation_scale=rad_scale if emissivity is not None else None,
        stochastic_rounding=dtype == torch.bfloat16)
    dmin = min(d)
    dt_cap = args.cfl * dmin * dmin / mat.alpha
    log(f"alpha={mat.alpha:.3e} m^2/s, dt_cap={dt_cap:.3e} s "
        f"(cfl={args.cfl}), implementation={args.implementation}", tag="num")

    T = torch.full(grid.shape, args.T_inf, dtype=dtype, device=device)
    frame_times = (np.linspace(0.0, total_time, args.nframes).tolist()
                   if args.nframes > 1 and total_time > 0 else [0.0])
    frames_meta = []

    def on_frame(t, T_d, active):
        # numpy has no bfloat16: read a bfloat16 field at float32
        T_np = T_d.to(torch.promote_types(T_d.dtype, torch.float32)) \
            .cpu().numpy()
        a_np = active.cpu().numpy()
        n_act = int(a_np.sum())
        tmax = float(np.nanmax(np.where(a_np, T_np, np.nan))) if n_act else 0.0
        if not np.isfinite(tmax) or abs(tmax) > 1e5:
            log(f"suspicious field values at t={t:.3f}: Tmax={tmax:.3g}",
                tag="warn")
        log(f"t={t:9.3f} s  active={n_act}  Tmax={tmax:8.1f}", tag="frame")
        frames_meta.append((t, n_act, tmax))

    loop = EventLoop(advance=advance, prepare=prepare, activation_times=act,
                     deposit_T=args.Ts, dt_cap=dt_cap)
    T, active, t = loop.run(T, frame_times=frame_times, t_end=total_time,
                            on_frame=on_frame)
    log(f"done: {len(frames_meta)} frames, {loop.substeps} sub-steps",
        tag="done")
    return {"T": T, "active": active, "t": t, "frames": frames_meta,
            "grid": grid, "layers": layers, "births": births,
            "substeps": loop.substeps}


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
