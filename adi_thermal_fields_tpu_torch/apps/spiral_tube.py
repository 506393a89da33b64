"""Spiral/ring WAAM tube deposition on a cylindrical grid (CLI app),
PyTorch port.

Counterpart: ``adi_thermal_fields_tpu/apps/spiral_tube.py`` —
``build_argparser`` (:30, the same flags and defaults) and ``run`` (:131)
on one device, optionally with the moving Gaussian torch
(``--torch_Q``/``--torch_sigma``).  The nozzle sweeps arcs layer by layer,
activating (phi, z) columns of an annular wall from a float64
activation-time table kept on the host (birth/spiral.py).  Each fixed step
runs, with ``--void_mode robin`` (the default), the masked-Robin
cylindrical step (step/cylindrical_masked.py) on K9, K11 and K10; its plan
depends only on the active mask, so it is rebuilt only on steps in which a
column is born, which the host knows from the activation times without a
device sync.  With ``--void_mode clamp`` it runs the ambient-clamp wrapper
of the unmasked step (step/cylindrical.adi_step_masked, the JAX app's
:314-321) on K12, K14 and K13, which needs no plan.

The variable-property flags ``--latent_J_kg`` (apparent cp over
``--solidus_C``..``--liquidus_C``), ``--melt_k_factor`` (the melt-pool
conductivity proxy), ``--emissivity`` (the radiative film on every exposed
surface) and ``--scheme douglas`` switch the run onto the cylindrical
varprop step (step/cylindrical_varprop.py), as the JAX app does (:185-215,
:282-305): in robin mode with ``active`` and the interface films, in clamp
mode through its clamp wrapper.  Backward Euler runs K15, K16 and K8 (the
robin mode rebuilds their codes only on steps with a birth), Douglas K17,
K18 and K17.  The host syncs with the device only at frames.

Example (on a CUDA machine):
    python -m adi_thermal_fields_tpu_torch.apps.spiral_tube --R_out 32 \\
        --wall_thickness 2 --height 8 --z_back 20 --pitch 4 --out ""

Outputs (JAX :341-511): ``--history_t_crit`` tracks each voxel's peak
temperature and seconds above each threshold (reset at a column's birth
to ``--Ts``, then ``apps.engine.history_update`` after every step, in
place on the device), masked by the final active state on output and
saved to ``--history_out``; ``--vtk`` writes the final state as a
STRUCTURED_GRID with the true tube geometry [mm]; ``--checkpoint``
writes an npz checkpoint at every frame and ``--resume`` restarts from
one by step index (the schedule is recomputed from the same flags; the
same dt and thresholds are required), its clock added up step by step as
the straight run's is, so that a resumed run equals the straight one bit
for bit.

``--device`` defaults to ``cuda`` and the run raises when CUDA is absent;
``--device cpu`` runs the kernels' plain versions.  ``--implementation
reference`` runs the plain step.  ``--mesh`` (the multi-device layer) is
not ported and exits with a message.  A non-empty ``--out`` writes a GIF
and needs matplotlib and imageio.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from . import resolve_device

__all__ = ["build_argparser", "run", "main"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="WAAM tube: spiral/ring deposition, masked cylindrical "
                    "ADI (PyTorch port)")
    # geometry [mm]
    p.add_argument("--R_out", type=float, required=True)
    p.add_argument("--wall_thickness", type=float, required=True)
    p.add_argument("--height", type=float, required=True)
    p.add_argument("--z_back", type=float, required=True)
    p.add_argument("--nr", type=int, default=8)
    p.add_argument("--nphi", type=int, default=36)
    p.add_argument("--dz", type=float, default=None,
                   help="override dz [mm] (default dr)")
    # material
    p.add_argument("--rho", type=float, default=7800.0)
    p.add_argument("--cp", type=float, default=490.0)
    p.add_argument("--k", type=float, default=54.0)
    # BCs
    p.add_argument("--h_side", type=float, default=300.0)
    p.add_argument("--h_end", type=float, default=150.0)
    p.add_argument("--h_void", type=float, default=None)
    p.add_argument("--T_inf", type=float, default=20.0)
    p.add_argument("--Ts", type=float, default=1000.0)
    p.add_argument("--void_mode", choices=["robin", "clamp"], default="robin")
    # time / kinematics
    p.add_argument("--t_tot", type=float, default=30.0)
    p.add_argument("--dt_fixed", type=float, default=0.05)
    p.add_argument("--pitch", type=float, required=True,
                   help="vertical distance per full turn [mm]")
    p.add_argument("--speed", type=float, default=None,
                   help="tangential speed [mm/s]")
    p.add_argument("--auto_speed", action="store_true",
                   help="choose speed so all layers fit in t_tot")
    p.add_argument("--loops_per_layer", type=int, default=1)
    p.add_argument("--layer_cells_z", type=int, default=None,
                   help="layer thickness in z cells (default: derived from "
                        "pitch)")
    # output
    p.add_argument("--nframes", type=int, default=30)
    p.add_argument("--out", type=str, default="spiral_tube.gif")
    p.add_argument("--iphi_slice", type=int, default=0)
    p.add_argument("--precision", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--scheme", choices=["be", "douglas"], default="be")
    # variable-property physics
    p.add_argument("--latent_J_kg", type=float, default=0.0)
    p.add_argument("--solidus_C", type=float, default=1420.0)
    p.add_argument("--liquidus_C", type=float, default=1510.0)
    p.add_argument("--melt_k_factor", type=float, default=1.0)
    p.add_argument("--emissivity", type=float, default=0.0)
    # moving torch
    p.add_argument("--torch_Q", type=float, default=0.0,
                   help="moving torch power [W]: a Gaussian volumetric "
                        "source of width --torch_sigma centred on the "
                        "nozzle, normalized so its domain integral is Q")
    p.add_argument("--torch_sigma", type=float, default=3.0,
                   help="torch Gaussian sigma [mm]")
    p.add_argument("--history_t_crit", type=str, default=None,
                   help="track per-voxel thermal history: peak temperature "
                        "and seconds above each comma-separated threshold "
                        "[C] (e.g. '800,500' -> t8/5 = t_above[1] - "
                        "t_above[0])")
    p.add_argument("--history_out", type=str, default="spiral_history.npz",
                   help="npz output path for the thermal-history arrays")
    p.add_argument("--vtk", type=str, default="",
                   help="write the final state as a legacy VTK "
                        "STRUCTURED_GRID with the true tube geometry [mm]")
    p.add_argument("--checkpoint", type=str, default="",
                   help="write a resume checkpoint (npz) at every frame")
    p.add_argument("--resume", type=str, default="",
                   help="resume from a checkpoint file; the deposition "
                        "schedule is recomputed from the (identical) CLI "
                        "args, so only T, t and the thermal history are "
                        "restored")
    # the JAX app's multi-device flag: parsed so that it exits
    p.add_argument("--mesh", type=str, default="")
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run raises when CUDA is absent")
    p.add_argument("--implementation", choices=["kernels", "reference"],
                   default="kernels",
                   help="kernels: K9-K11 (clamp: K12-K14; varprop flags: "
                        "K8 and K15-K18) on CUDA, plain versions on CPU; "
                        "reference: the plain step")
    return p


def _reject_unsupported(args) -> None:
    """Exit with a message for flags this port does not support yet."""
    bad = [f"{name}: needs {need}" for name, on, need in (
        ("--mesh", bool(args.mesh), "the multi-device layer"),) if on]
    if bad:
        raise SystemExit("not supported by the PyTorch port yet: "
                         + "; ".join(bad)
                         + " (the JAX package's app runs them)")


def run(args) -> dict:
    from ..birth.spiral import (active_at, newborn_between,
                                spiral_activation_times)
    from ..core.grid import CylindricalGrid
    from ..core.material import Material
    from ..io.checkpoint import RunState, load_checkpoint, save_checkpoint
    from ..io.logging import log
    from ..io.vtk import write_vtk_cylindrical_grid
    from ..step.cylindrical import RobinBC, ZFaceBC, adi_step_masked
    from ..step.cylindrical_masked import (build_masked_robin_plan,
                                           masked_robin_solve)
    from ..step.cylindrical_varprop import (adi_step_cyl_varprop,
                                            adi_step_cyl_varprop_masked,
                                            build_cyl_vp2_plan)
    from .engine import history_update

    _reject_unsupported(args)
    device = resolve_device(args.device)

    mm = 1e-3
    R_out = args.R_out * mm
    wall = args.wall_thickness * mm
    R_in = max(0.0, R_out - wall)
    dr = wall / args.nr
    dz = (args.dz * mm) if args.dz else dr
    nz = int(round((args.z_back * mm + args.height * mm) / dz))
    grid = CylindricalGrid(args.nr, args.nphi, nz, dr, dz, r_inner=R_in)
    mat = Material(args.rho, args.cp, args.k)
    iz_base = int(round(args.z_back * mm / dz))
    # layer thickness: explicit cells, else derived from pitch (vertical
    # distance per full turn; layer_height = pitch / loops_per_layer)
    if args.layer_cells_z is not None:
        layer_cells = max(1, args.layer_cells_z)
    else:
        layer_cells = max(1, int(round(args.pitch * mm
                                       / (dz * args.loops_per_layer))))
    layer_h = layer_cells * dz
    n_layers = max(1, int(round(args.height * mm / layer_h)))

    # kinematics: time per loop from tangential speed at the wall mid-radius
    r_mid = R_in + 0.5 * wall
    if args.auto_speed or args.speed is None:
        tau_loop = args.t_tot / (n_layers * args.loops_per_layer)
    else:
        tau_loop = 2 * math.pi * r_mid / (args.speed * mm)
    log(f"grid (nr,nphi,nz)=({grid.nr},{grid.nphi},{grid.nz}), "
        f"R_in={R_in*1e3:.3g} mm, {n_layers} layers, "
        f"tau_loop={tau_loop:.3f} s", tag="spiral")

    # float64 on the host: the births are decided there, with the same
    # float clock as the JAX app
    act = spiral_activation_times(
        grid, iz_base=iz_base, layer_cells=layer_cells, n_layers=n_layers,
        tau_dep=tau_loop * args.loops_per_layer,
        loops_per_layer=args.loops_per_layer)

    h_void = args.h_void if args.h_void is not None else args.h_side
    rob = RobinBC(args.h_side, args.T_inf)
    rob_void = RobinBC(h_void, args.T_inf)
    clamp = args.void_mode == "clamp"
    zbc = ZFaceBC(kind_bot="neumann0", kind_top="robin", h_top=args.h_end,
                  T_inf_top=args.T_inf)
    dtype = {"float32": torch.float32, "float64": torch.float64}[
        args.precision]

    # variable-property physics: latent heat (apparent cp) and the
    # melt-pool conductivity proxy switch the run onto the varprop step
    k_table = cp_table = None
    if args.latent_J_kg > 0:
        from ..step.cartesian_varprop import apparent_cp
        cp_table = apparent_cp(args.cp, args.cp, args.latent_J_kg,
                               args.solidus_C, args.liquidus_C)
        log(f"latent heat {args.latent_J_kg:.3g} J/kg over "
            f"{args.solidus_C:g}-{args.liquidus_C:g} C (apparent cp)",
            tag="varprop")
    if args.melt_k_factor != 1.0:
        from ..step.cartesian_varprop import melt_pool_enhanced_k
        k_table = melt_pool_enhanced_k(args.k, args.solidus_C,
                                       args.liquidus_C,
                                       enhancement=args.melt_k_factor)
        log(f"melt-pool k proxy: {args.melt_k_factor:g}x above "
            f"{args.liquidus_C:g} C", tag="varprop")
    if args.emissivity > 0.0:
        log(f"radiative film: eps={args.emissivity:g} on every exposed "
            "surface (Picard h_rad(T))", tag="varprop")
    varprop = (k_table is not None or cp_table is not None
               or args.emissivity > 0.0 or args.scheme != "be")
    if args.scheme != "be" and k_table is None and cp_table is None \
            and args.emissivity == 0.0:
        log("scheme=douglas routes through the varprop step with constant "
            "tables (identical physics, second-order time)", tag="scheme")
    if args.emissivity > 0.0 and clamp:
        log("clamp void mode: radiation applies on the domain faces only "
            "(the clamp scheme has no material/void interface films)",
            tag="varprop")
    # the tier-2 route (K15, K16, K8) reads codes that depend on the mask
    vp2_codes = (varprop and not clamp and args.scheme == "be"
                 and args.implementation == "kernels")
    vp_kw = dict(k_table=k_table, cp_table=cp_table,
                 emissivity=args.emissivity, scheme=args.scheme,
                 implementation=args.implementation)

    def plan_of(active2d):
        a3 = torch.from_numpy(active2d).to(device)[None].expand(grid.shape)
        a3 = a3.contiguous()
        return build_masked_robin_plan(
            grid, mat, a3, robin_outer=rob, zbc=zbc, robin_inner=rob,
            h_void=h_void, T_inf_void=args.T_inf, h_front=args.h_end,
            dtype=dtype)

    # moving torch: Gaussian volumetric source [W/m^3] centred on the
    # nozzle, its position from the same kinematics as the activation
    # times (layer L, loop fraction t/tau_loop)
    torch_source = None
    if args.torch_Q > 0.0:
        log(f"torch: Q={args.torch_Q:g} W, sigma={args.torch_sigma:g} mm",
            tag="torch")
        r_np = np.asarray(grid.r)
        vol = torch.as_tensor(r_np * grid.dr * grid.dphi * grid.dz,
                              device=device).to(dtype)[:, None, None]
        phis = torch.as_tensor(grid.dphi * np.arange(grid.nphi),
                               device=device).to(dtype)
        zs = torch.as_tensor(grid.dz * (np.arange(grid.nz) + 0.5),
                             device=device).to(dtype)
        sig = args.torch_sigma * mm
        tau_layer = tau_loop * args.loops_per_layer

        def torch_source(t, active3d):
            frac = (t / tau_loop) % 1.0
            phi_n = 2.0 * math.pi * frac
            lay = min(max(math.floor(t / tau_layer), 0), n_layers - 1)
            z_n = (iz_base + (lay + 1.0) * layer_cells - 0.5) * grid.dz
            dphi_w = torch.abs(((phis - phi_n) + math.pi) % (2 * math.pi)
                               - math.pi)
            arc2 = (r_mid * dphi_w) ** 2                  # (nphi,)
            dz2 = (zs - z_n) ** 2                         # (nz,)
            G = torch.exp(-(arc2[:, None] + dz2[None, :])
                          / (2.0 * sig * sig))
            G3 = G[None] * active3d
            norm = torch.sum(G3 * vol) + 1e-30
            return (args.torch_Q / norm) * G3

    T = torch.full(grid.shape, args.T_inf, dtype=dtype, device=device)
    dt = args.dt_fixed
    n_steps = int(round(args.t_tot / dt))
    frame_every = max(1, n_steps // max(1, args.nframes))

    def clamp_step(T, a3, src):
        if varprop:
            return adi_step_cyl_varprop_masked(
                T, grid, mat, dt=dt, robin_outer=rob, zbc=zbc, active=a3,
                robin_inner=rob, robin_void=rob_void, source=src, **vp_kw)
        return adi_step_masked(T, grid, mat, dt=dt, robin_outer=rob,
                               zbc=zbc, active=a3, robin_inner=rob,
                               robin_void=rob_void, source=src,
                               implementation=args.implementation)

    def varprop_step(T, a3, src, codes):
        return adi_step_cyl_varprop(
            T, grid, mat, dt=dt, robin_outer=rob, zbc=zbc, robin_inner=rob,
            active=a3, h_void=h_void, T_inf_void=args.T_inf,
            h_front=args.h_end, source=src, vp2_plan=codes, **vp_kw)

    # per-voxel thermal history (the engine's semantics: reset at birth to
    # the deposit temperature, then history_update after every step)
    crits = None
    if args.history_t_crit is not None:
        crits = tuple(float(v) for v in str(args.history_t_crit).split(","))
        tc = torch.tensor(crits, dtype=dtype, device=device)
        pk = torch.full(grid.shape, args.T_inf, dtype=dtype, device=device)
        ta = torch.zeros((len(crits),) + grid.shape, dtype=dtype,
                         device=device)
        log(f"thermal history: peak + t_above{crits} C", tag="history")

    # resume by step index: the schedule recomputes from the CLI args, so
    # the state is T, t and the thermal history only
    i0 = 0
    if args.resume:
        st = load_checkpoint(args.resume)
        T = torch.as_tensor(np.asarray(st.T, np.float64)).to(
            device=device, dtype=dtype)
        i0 = int(round(st.t / dt))
        if abs(i0 * dt - st.t) > 1e-9 * max(1.0, st.t):
            raise SystemExit(f"checkpoint t={st.t} is not a multiple of "
                             f"--dt_fixed {dt}; resume needs the same dt")
        if crits is not None:
            if not (st.meta and "history_peak" in st.meta):
                raise SystemExit("--history_t_crit set but the checkpoint "
                                 "carries no thermal-history state")
            ha = st.meta["history_above"]
            if ha.shape[0] != len(crits):
                raise SystemExit(
                    f"checkpoint thermal-history has {ha.shape[0]} "
                    f"thresholds, --history_t_crit has {len(crits)}")
            ck_crits = tuple(float(v) for v in
                             np.atleast_1d(st.meta.get("history_crits",
                                                       np.asarray(crits))))
            if ck_crits != crits:
                raise SystemExit(
                    f"checkpoint thermal-history thresholds {ck_crits} != "
                    f"--history_t_crit {crits}; resuming would mix "
                    "accumulators measured against different temperatures")
            pk = torch.as_tensor(np.asarray(st.meta["history_peak"],
                                            np.float64)).to(device=device,
                                                            dtype=dtype)
            ta = torch.as_tensor(np.asarray(ha, np.float64)).to(
                device=device, dtype=dtype)
        log(f"resumed t={st.t:.3f} s (step {i0}/{n_steps})", tag="resume")

    frames = []
    plan = a3 = None
    plans_built = 0
    # the clock a straight run reaches at step i0, added up as it adds it
    # (i0 * dt can differ in the last bit, and a column born on that step
    # boundary would then be born a step apart; the JAX app takes i0 * dt)
    t = 0.0
    for _ in range(i0):
        t += dt
    for i in range(i0, n_steps):
        t_next = t + dt
        newborn = newborn_between(act, t, t_next)
        born = bool(newborn.any())
        if born or a3 is None:
            if born:
                nb = torch.from_numpy(newborn).to(device)[None]
                T = T.masked_fill(nb, args.Ts)
                if crits is not None:
                    pk.masked_fill_(nb, args.Ts)
                    ta.masked_fill_(nb, 0.0)
            active = active_at(act, t_next)
            if clamp:
                a3 = torch.from_numpy(active).to(device)[None] \
                    .expand(grid.shape)
            elif varprop:
                a3 = torch.from_numpy(active).to(device)[None] \
                    .expand(grid.shape).contiguous()
                if vp2_codes:
                    plan = build_cyl_vp2_plan(a3, grid, zbc)
                    plans_built += 1
            else:
                plan = plan_of(active)
                plans_built += 1
                a3 = plan.active
        src = None
        if torch_source is not None:
            src = torch_source(t + 0.5 * dt, a3)
        if clamp:
            T = clamp_step(T, a3, src)
        elif varprop:
            T = varprop_step(T, a3, src, plan)
        else:
            T = masked_robin_solve(T, plan, grid, mat, dt=dt, source=src,
                                   implementation=args.implementation)
        if crits is not None:
            history_update(pk, ta, T, dt, tc, multi=True)
        t = t_next
        if (i + 1) % frame_every == 0 or i == n_steps - 1:
            a_np = np.broadcast_to(active[None], grid.shape)
            T_np = T.cpu().numpy()
            tmax = float(np.nanmax(np.where(a_np, T_np, np.nan)))
            log(f"t={t:8.3f} s  Tmax={tmax:8.1f}", tag="frame")
            frames.append((t, T_np, a_np.copy()))
            if args.checkpoint:
                meta = None if crits is None else {
                    "history_peak": pk, "history_above": ta,
                    "history_crits": np.asarray(crits)}
                save_checkpoint(args.checkpoint, RunState(
                    T=T_np, active=np.asarray(active), t=t, meta=meta))

    active_end = active_at(act, t)
    out = {"T": T, "frames": frames, "grid": grid, "t": t,
           "active": active_end, "activation_times": act,
           "steps": n_steps, "steps_run": max(0, n_steps - i0),
           "plans_built": plans_built}
    # never-born cells carry meaningless placeholder history: masked by
    # the final active state
    a_fin = np.broadcast_to(active_end[None], grid.shape)
    if crits is not None:
        pk_np = np.where(a_fin, pk.cpu().numpy(), 0.0)
        ta_np = np.where(a_fin[None], ta.cpu().numpy(), 0.0)
        out["history"] = {"peak": pk_np, "t_above": ta_np, "crits": crits}
        if len(crits) == 2:
            t85 = ta_np[1] - ta_np[0]
            log(f"t{crits[0]:g}/{crits[1]:g}: max "
                f"{float(t85.max()):.3f} s, mean (deposited) "
                f"{float(t85[a_fin].mean()):.3f} s", tag="history")
        if args.history_out:
            np.savez_compressed(
                args.history_out, peak=pk_np, t_above=ta_np,
                crits=np.asarray(crits), r=np.asarray(grid.r),
                dphi=grid.dphi, dz=grid.dz,
                active=a_fin.astype(np.uint8))
            log(f"saved {args.history_out}", tag="history")

    if args.vtk:
        fields = {"T": np.where(a_fin, T.cpu().numpy(), args.T_inf),
                  "active": a_fin.astype(np.float32)}
        if crits is not None:
            fields["T_peak"] = out["history"]["peak"]
            for kk, cc in enumerate(crits):
                fields[f"t_above_{cc:g}C"] = out["history"]["t_above"][kk]
        write_vtk_cylindrical_grid(
            args.vtk, fields, r=np.asarray(grid.r) * 1e3,
            dphi=grid.dphi, dz=grid.dz * 1e3, binary=True,
            comment="adi_thermal_fields_tpu spiral_tube [mm]")
        log(f"saved {args.vtk}", tag="vtk")

    if args.out and frames:
        _save_gif(args.out, frames, grid, args)
        log(f"saved {args.out}", tag="gif")
    elif args.out:
        log("no steps ran (resume at/past t_tot); gif skipped", tag="gif")
    return out


def _save_gif(path, frames, grid, args):
    import matplotlib
    matplotlib.use("Agg")
    import imageio.v2 as imageio
    import matplotlib.pyplot as plt

    images = []
    vmax = max(np.nanmax(np.where(a, T, np.nan)) for _, T, a in frames)
    ir = grid.nr - 1  # outer surface view
    for t, T, a in frames:
        fig, ax = plt.subplots(figsize=(6.4, 3.6))
        sl = np.where(a[ir], T[ir], np.nan)   # (nphi, nz)
        im = ax.imshow(sl.T, origin="lower", aspect="auto",
                       vmin=args.T_inf, vmax=vmax, cmap="inferno",
                       extent=[0, 360, 0, grid.nz * grid.dz * 1e3])
        ax.set_xlabel("phi, deg")
        ax.set_ylabel("z, mm")
        ax.set_title(f"outer surface T, t = {t:.2f} s")
        fig.colorbar(im, ax=ax, label="T, C")
        fig.tight_layout()
        fig.canvas.draw()
        images.append(np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy())
        plt.close(fig)
    imageio.mimsave(path, images, fps=8)


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
