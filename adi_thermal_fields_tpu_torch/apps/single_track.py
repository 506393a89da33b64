"""Single-track deposition on a plate (CLI app), PyTorch port.

Counterpart: ``adi_thermal_fields_tpu/apps/single_track.py`` —
``build_argparser`` (the same flags and defaults), ``run`` and ``main``.
A bead of ``--track_w_vox`` x ``--track_h_vox`` voxels is deposited column
by column along y on top of a plate, each column born at ``--T_track`` as
the torch passes (element birth, ``birth/layers.track_activation_times``);
Robin convection on every exposed face.  ``--goldak_power`` adds the arc's
power as a Goldak double-ellipsoid source following the torch
(``birth/heat_source.goldak_source``) until the track ends.  The event
loop (``apps/engine.EventLoop``) advances through
``make_cartesian_advance``, which rebuilds the plan at each event: with
``--implementation kernels`` each sub-step runs K4, K1 and K2 (plan-lite,
scalar h), or with the torch's source K3, K1 twice and K2
(step/cartesian_fused.py); ``reference`` runs the plain step.

The Goldak field is built on the device at the state dtype; the JAX app
builds it at float32 (its ``goldak_source`` default) whatever the state.

Outputs: a GIF of the x mid-plane (``--out``; ``--out ""`` skips it;
matplotlib and imageio are imported only to write it) and, with
``--save_vtk 1``, a VTK frame per frame time in ``--outdir``.  CLI units:
mm (SI internally).

``--device`` defaults to ``cuda`` and the run raises when CUDA is absent;
``--device cpu`` runs the kernels' plain versions.

Example (on a CUDA machine):
    python -m adi_thermal_fields_tpu_torch.apps.single_track --out track.gif
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import resolve_device

__all__ = ["build_argparser", "run", "main"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Single-track deposition on a plate (PyTorch port)")
    p.add_argument("--plate_x_mm", type=float, default=30.0)
    p.add_argument("--plate_y_mm", type=float, default=60.0)
    p.add_argument("--plate_z_mm", type=float, default=6.0)
    p.add_argument("--dx_mm", type=float, default=1.0)
    p.add_argument("--track_len_mm", type=float, default=40.0)
    p.add_argument("--track_w_vox", type=int, default=3)
    p.add_argument("--track_h_vox", type=int, default=3)
    p.add_argument("--speed_mm_s", type=float, default=8.0)
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0)
    p.add_argument("--k", type=float, default=54.0)
    p.add_argument("--h", type=float, default=30.0)
    p.add_argument("--T_inf", type=float, default=20.0)
    p.add_argument("--T_track", type=float, default=1500.0)
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--cfl", type=float, default=2.0)
    p.add_argument("--t_tail", type=float, default=5.0,
                   help="relaxation after track end [s]")
    p.add_argument("--nframes", type=int, default=24)
    p.add_argument("--out", type=str, default="single_track.gif")
    p.add_argument("--save_vtk", type=int, default=0)
    p.add_argument("--outdir", type=str, default=".")
    p.add_argument("--precision", choices=["float32", "float64"],
                   default="float32")
    # moving torch: on top of the bead birth, the arc's power as a Goldak
    # double-ellipsoid source following the torch
    p.add_argument("--goldak_power", type=float, default=0.0,
                   help="absorbed torch power [W]; 0 disables the source")
    p.add_argument("--goldak_af_mm", type=float, default=2.0)
    p.add_argument("--goldak_ar_mm", type=float, default=4.0)
    p.add_argument("--goldak_b_mm", type=float, default=2.0)
    p.add_argument("--goldak_c_mm", type=float, default=2.0)
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run raises when CUDA is absent")
    p.add_argument("--implementation", choices=["kernels", "reference"],
                   default="kernels",
                   help="kernels: K4, K1, K2 (with --goldak_power: K3, K1 "
                        "x2, K2) on CUDA, plain versions on CPU; "
                        "reference: the plain step")
    return p


def run(args) -> dict:
    from ..birth.layers import track_activation_times
    from ..core.grid import CartesianGrid
    from ..core.material import Material
    from ..io.logging import log
    from .engine import EventLoop, make_cartesian_advance

    device = resolve_device(args.device)
    dx = args.dx_mm * 1e-3
    nx = int(round(args.plate_x_mm / args.dx_mm))
    ny = int(round(args.plate_y_mm / args.dx_mm))
    plate_cells = int(round(args.plate_z_mm / args.dx_mm))
    nz = plate_cells + args.track_h_vox + 2
    grid = CartesianGrid(nx, ny, nz, dx)
    mat = Material(args.rho, args.cp, args.k)

    track_cols = int(round(args.track_len_mm / args.dx_mm))
    y0 = (ny - track_cols) // 2
    x0 = nx // 2 - args.track_w_vox // 2
    dt_col = dx / (args.speed_mm_s * 1e-3)
    act_y = track_activation_times(ny, y_start=y0, n_columns=track_cols,
                                   dt_per_column=dt_col, t_first=1e-9)

    # per-cell activation: plate always active; bead columns per act_y
    act = np.full(grid.shape, np.inf)
    act[:, :, :plate_cells] = -np.inf
    zs = slice(plate_cells, plate_cells + args.track_h_vox)
    act[x0:x0 + args.track_w_vox, :, zs] = act_y[None, :, None]
    act = torch.from_numpy(act).to(device)

    dtype = torch.float32 if args.precision == "float32" else torch.float64
    T = torch.full(grid.shape, args.T_inf, dtype=dtype, device=device)
    t_track = track_cols * dt_col

    source_fn = None
    if args.goldak_power > 0.0:
        from ..birth.heat_source import GoldakSource, goldak_source

        gk = GoldakSource(power=args.goldak_power,
                          a_f=args.goldak_af_mm * 1e-3,
                          a_r=args.goldak_ar_mm * 1e-3,
                          b=args.goldak_b_mm * 1e-3,
                          c=args.goldak_c_mm * 1e-3, travel_axis=1)
        x_c = (x0 + args.track_w_vox / 2.0) * dx
        z_c = (plate_cells + args.track_h_vox) * dx
        speed = args.speed_mm_s * 1e-3
        off = torch.zeros(grid.shape, dtype=dtype, device=device)

        def source_fn(t):
            # t is the sub-step's host clock: the torch's position and its
            # switch-off need no device read
            if not t < t_track:
                return off
            y_c = (y0 + 0.5) * dx + speed * t
            return goldak_source(grid, gk, (x_c, y_c, z_c), device=device,
                                 dtype=dtype)

    advance = make_cartesian_advance(grid, mat,
                                     implementation=args.implementation,
                                     device=device, theta=args.theta,
                                     t_inf=args.T_inf, robin_h=args.h,
                                     source_fn=source_fn)
    dt_cap = args.cfl * dx * dx / mat.alpha
    t_end = t_track + args.t_tail
    frame_times = np.linspace(0.0, t_end, args.nframes)
    log(f"grid {grid.shape}, {track_cols} bead columns, dt_cap="
        f"{dt_cap:.3e} s, t_end={t_end:.3f} s, implementation="
        f"{args.implementation}", tag="track")

    frames = []

    def on_frame(t, T_d, active):
        T_np = T_d.cpu().numpy()
        a_np = active.cpu().numpy()
        frames.append((t, T_np, a_np))
        tmax = (float(np.nanmax(np.where(a_np, T_np, np.nan)))
                if a_np.any() else 0.0)
        log(f"t={t:8.3f} s  Tmax={tmax:7.1f}", tag="frame")
        if args.save_vtk:
            from ..io.vtk import write_vtk_structured_points
            os.makedirs(args.outdir, exist_ok=True)
            write_vtk_structured_points(
                os.path.join(args.outdir, f"track_{t:09.3f}.vtk"),
                {"Temperature": T_np, "Mask": a_np.astype(np.float32)},
                spacing=args.dx_mm)

    loop = EventLoop(advance=advance, activation_times=act,
                     deposit_T=args.T_track, dt_cap=dt_cap)
    T, active, t = loop.run(T, frame_times=frame_times, t_end=t_end,
                            on_frame=on_frame)
    log(f"done: {len(frames)} frames, {loop.substeps} sub-steps", tag="done")

    if args.out:
        _save_gif(args.out, frames, plate_cells, args)
        log(f"saved {args.out}", tag="gif")
    return {"frames": frames, "T": T, "active": active, "t": t,
            "substeps": loop.substeps, "grid": grid,
            "activation_times": act}


def _save_gif(path, frames, plate_cells, args):
    import matplotlib
    matplotlib.use("Agg")
    import imageio.v2 as imageio
    import matplotlib.pyplot as plt

    images = []
    vmax = max(np.nanmax(np.where(a, T, np.nan)) for _, T, a in frames
               if a.any())
    for t, T, a in frames:
        fig, ax = plt.subplots(figsize=(6, 3.2))
        # side view: x mid-plane (y-z)
        sl = np.where(a[T.shape[0] // 2], T[T.shape[0] // 2], np.nan)
        im = ax.imshow(sl.T, origin="lower", aspect="auto",
                       vmin=args.T_inf, vmax=vmax, cmap="inferno")
        ax.axhline(plate_cells - 0.5, color="w", lw=0.5)
        ax.set_title(f"t = {t:.2f} s")
        fig.colorbar(im, ax=ax, label="T, C")
        fig.tight_layout()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        images.append(buf.copy())
        plt.close(fig)
    imageio.mimsave(path, images, fps=6)


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
