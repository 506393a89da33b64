#!/usr/bin/env python3
"""A/B of the field sweeps K21 and K22 (a/b/c/d fields, open and
periodic) and K17 and K18 (five streams, open and periodic) and the three
steps that run them, between two checkouts of the PyTorch port, on one
CUDA card.

    python3 scripts/fields_rows_ab.py OTHER_CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run: CUDA-event medians in ms and the share of each kernel's bound
(chip_smoke.py ``bound``: its inputs read once and its output written
once at 3.35 TB/s, or its operations at 67 TFLOP/s), float32 unless named:

* K21 along x, y and z on chip_smoke.py phase 9's systems at 384^3 and
  97x203x131, and on 8192-row lines (8192x64x64 x, 64x8192x64 y,
  64x64x8192 z);
* K17 along r and z on phase 8's streams (the (64, 512, 1024) tube at
  float32 and at 10x the step's dt, the (37, 203, 131) disk at float32
  and float64) and on 8192-row lines (8192x64x64 r, 64x64x8192 z).  A
  checkout without K17's z entry (``vp_fields_sweep_z``) solves z on the
  (z, r, phi) permutation: its row times the kernel alone on the permuted
  streams, and "K17 z permute pair" the five permutes and the result's
  permute back that its step runs around it;
* K22 along phi (axis 1) on phase 9's systems at 384^3 and 97x203x131,
  and at 384^3 along axis 0 and the last axis (B2 = 1: one busy lane a
  warp on the periodic split kernel); K18 on phase 8's streams (the tube
  at the step's dt and at 10x, the disk at float32 and float64) and K22
  on the same rows materialized (chip_smoke.py ``k18_rows``); K18 on the
  tube's own Douglas step rows (theta*dw) and K22 on the ``fields``
  tier's Douglas step rows, each taken from one step at the tube's T
  (scripts/cyclic_tune.py ``step_call_args``).  Beside each row of
  these, the share of its blocks (one b1, 32 lines) past the
  checkout's ``kCyclicFieldStiff`` (csrc/field_rows.cuh), which replay
  the Thomas order (none for a checkout without it);
* the steps in ms/step (median of STEP_REPS after STEP_WARMUP) with their
  device time per kernel and its sum (busy ms) from torch.profiler over
  three steps (scripts/sweep_rows_ab.py ``profile_steps``) and the idle
  share 1 - busy / (CUDA-event ms/step): the (64, 512, 1024) cylindrical
  varprop Douglas step (phase 8: K17 r and z, K18), the 384^3
  Neumann/Dirichlet varprop step (phase 9: K21 x3) and the cylindrical
  ``fields`` tier's backward Euler and Douglas steps at the tube (phase
  9: K21 r and z, K22);
* the wall time of chip_smoke.py phase 8's spiral-app print with
  ``--scheme douglas`` at float32 (K17 and K18 on every step; the
  library built before it).
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys

from sweep_rows_ab import profile_steps

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_WARMUP, STEP_REPS = 2, 7


def row(torch, cs, out, kname, name, ins, fn, reps=20):
    """The kernel's median ms and its share of the bound on ``ins``."""
    got = fn()
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, got))
    ms = cs.cuda_ms(torch, fn, reps)
    b = cs.bound(kname, nbytes, got.numel())["bound_ms"]
    out[f"{kname} {name} ms"] = ms
    out[f"{kname} {name} pct_of_bound"] = 100.0 * b / ms
    del got


def k21_rows(torch, cs, dev, out):
    from adi_thermal_fields_tpu_torch.solvers import tridiag_fields
    f32 = torch.float32
    cases = [(label, shape, ("x", "y", "z"))
             for label, shape, prec in cs.P9_SHAPES if prec == "float32"]
    cases += [(f"{'x'.join(map(str, s))} long", s, (ax,))
              for ax, s in zip("xyz", cs.LONG_LINES)]
    for label, shape, axes in cases:
        abcd = cs.field_systems(torch, shape, f32, dev, 5)
        for ax in axes:
            row(torch, cs, out, "K21", f"{label} {ax}", abcd,
                lambda ax=ax: tridiag_fields(*abcd, "xyz".index(ax)))
        del abcd
        torch.cuda.empty_cache()


def k17_rows(torch, cs, dev, out, natural_z):
    """K17 r and z at phase 8's tube (also at 10x dt) and disk and on
    8192-row lines."""
    from adi_thermal_fields_tpu_torch.solvers import vp_fields_sweep_strided
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp
    if natural_z:
        from adi_thermal_fields_tpu_torch.solvers import vp_fields_sweep_z

    def z_rows(label, sz, gz):
        if natural_z:
            row(torch, cs, out, "K17", f"{label} z", sz,
                lambda: vp_fields_sweep_z(*sz, gz, gz))
            return
        zl = [t.permute(2, 0, 1).contiguous() for t in sz]
        row(torch, cs, out, "K17", f"{label} z", zl,
            lambda: vp_fields_sweep_strided(*zl, gz, gz))

        def pair():
            x = vp_fields_sweep_strided(*(t.permute(2, 0, 1).contiguous()
                                          for t in sz), gz, gz)
            return x.permute(1, 2, 0).contiguous()
        whole = cs.cuda_ms(torch, pair, 20)
        out[f"K17 {label} z permute pair ms"] = \
            whole - out[f"K17 {label} z ms"]

    cases = [(label, shape, prec, 1.0) for label, shape, prec in cs.P8_SHAPES]
    cases.insert(1, (cs.P8_SHAPES[0][0], cs.P8_SHAPES[0][1], "float32",
                     10.0))
    for label, shape, prec, dtm in cases:
        dtype = getattr(torch, prec)
        grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape, dtype,
                                                dev)
        R = cs.random_field(torch, mask, seed=43).to(dtype)
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        sr, sz = cs.k17_streams(torch, grid, mat, mask, T, R,
                                cs.P8_DT * dtm)
        name = f"{label} {prec}" + (f" {dtm:g}x dt" if dtm != 1.0 else "")
        row(torch, cs, out, "K17", f"{name} r", sr,
            lambda: vp_fields_sweep_strided(*sr, cols["glo_r"],
                                            cols["ghi_r"]))
        z_rows(name, sz, cols["geo_z"])
        del T, R, sr, sz, mask
        torch.cuda.empty_cache()
    # 8192-row lines: streams at the tube's scale, coupling ~2
    for ax, shape, axis in (("r", cs.LONG_LINES[0], 0),
                            ("z", cs.LONG_LINES[2], 2)):
        st, col = cs.line_streams(torch, shape, axis, dev, 61)
        label = f"{'x'.join(map(str, shape))} long"
        if ax == "r":
            row(torch, cs, out, "K17", f"{label} r", st,
                lambda: vp_fields_sweep_strided(*st, col, col))
        else:
            z_rows(label, st, col)
        del st
        torch.cuda.empty_cache()


def cyclic_field_rows(torch, cs, dev, out, root):
    """K22 and K18 on phase 9's systems, phase 8's streams and the steps'
    own phi rows, with the share of blocks past the checkout's ratio."""
    from cyclic_tune import (block_max, douglas_phi_args, phase8_step_kw,
                             step_call_args, stiff_ratio)
    from adi_thermal_fields_tpu_torch.solvers import (cyclic_fields,
                                                      vp_fields_cyclic_phi)
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp
    ratio = stiff_ratio(root)

    def share(name, rows):
        a, b, c, _ = rows
        if ratio is None:
            return
        off = a.abs() + c.abs()
        past = block_max((off / (b - off)).double()) > ratio
        out[f"{name} replayed_share"] = float(past.double().mean())

    for label, shape, prec in cs.P9_SHAPES[:2]:
        abcd = cs.field_systems(torch, shape, getattr(torch, prec), dev, 5)
        axes = (1, 0, 2) if shape[0] == cs.P9_N else (1,)
        for ax in axes:
            row(torch, cs, out, "K22", f"{label} {prec} axis {ax}", abcd,
                lambda ax=ax: cyclic_fields(*abcd, ax))
        del abcd
        torch.cuda.empty_cache()
    cases = [(label, shape, prec, 1.0) for label, shape, prec in cs.P8_SHAPES]
    cases.insert(1, (cs.P8_SHAPES[0][0], cs.P8_SHAPES[0][1], "float32",
                     10.0))
    kt, _ = cs.varprop_tables()
    for label, shape, prec, dtm in cases:
        dtype = getattr(torch, prec)
        grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape, dtype,
                                                dev)
        R = cs.random_field(torch, mask, seed=43).to(dtype)
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        sr, _ = cs.k17_streams(torch, grid, mat, mask, T, R, cs.P8_DT * dtm)
        sp = (R, cvp._face_phi(kt(T), mask), *sr[2:])
        ap = cs.k18_rows(torch, sp, cols["geo_p"])
        name = f"{label} {prec}" + (f" {dtm:g}x dt" if dtm != 1.0 else "")
        row(torch, cs, out, "K18", name, sp,
            lambda: vp_fields_cyclic_phi(*sp, cols["geo_p"]))
        share(f"K18 {name}", ap)
        row(torch, cs, out, "K22", f"{name}, K18's rows", ap,
            lambda: cyclic_fields(*ap, 1))
        share(f"K22 {name}, K18's rows", ap)
        if label.endswith("tube") and dtm == 1.0:
            kw = phase8_step_kw(cs, mask, zbc, cs.P8_DT)
            plan = cvp.build_cyl_vp2_plan(mask, grid, zbc)
            dp = douglas_phi_args(cs, cvp, grid, mat, T, kw, plan)
            name = f"{label} Douglas step rows"
            row(torch, cs, out, "K18", name, dp[:5],
                lambda: vp_fields_cyclic_phi(*dp))
            share(f"K18 {name}", cs.k18_rows(torch, dp[:5], dp[5]))
            fp = step_call_args(cvp, "cyclic_fields", lambda: (
                cvp.adi_step_cyl_varprop(T, grid, mat, scheme="douglas",
                                         implementation="fields", **kw)))
            name = f"{label} fields tier Douglas step rows"
            row(torch, cs, out, "K22", name, fp[:4],
                lambda: cyclic_fields(*fp))
            share(f"K22 {name}", fp[:4])
            del dp, fp
        del T, R, sr, sp, ap, mask
        torch.cuda.empty_cache()


def timed_step(torch, out, name, step, T0):
    """CUDA-event ms/step (median of STEP_REPS after STEP_WARMUP) and the
    profile of ``step``."""
    T = T0
    for _ in range(STEP_WARMUP):
        T = step(T)
    times = []
    for _ in range(STEP_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        T = step(T)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    prof = profile_steps(torch, step, T)
    prof["idle_share"] = max(0.0, 1.0 - prof["busy_ms"] / ms)
    out[f"step_{name}_ms"] = ms
    out[f"profile_{name}"] = prof


def step_rows(torch, cs, dev, out):
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              RobinBC, adi_step_cyl_varprop)
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine

    kt, ct = cs.varprop_tables()
    label, shape, _ = cs.P8_SHAPES[0]
    grid, mat, mask, zbc, T0 = cs.cylvp_case(torch, label, shape,
                                             torch.float32, dev)
    kw = dict(dt=cs.P8_DT, robin_outer=RobinBC(300.0, 20.0), zbc=zbc,
              robin_inner=RobinBC(50.0, 20.0), active=mask, h_void=80.0,
              T_inf_void=20.0, h_front=200.0, k_table=kt, cp_table=ct,
              emissivity=cs.EMISSIVITY)
    for name, impl, scheme in (("varprop douglas", "kernels", "douglas"),
                               ("fields be", "fields", "be"),
                               ("fields douglas", "fields", "douglas")):
        timed_step(torch, out, f"{name} {label}",
                   lambda T, impl=impl, scheme=scheme: adi_step_cyl_varprop(
                       T, grid, mat, scheme=scheme, implementation=impl,
                       **kw), T0)
    del T0, mask
    torch.cuda.empty_cache()
    # phase 9's Neumann/Dirichlet varprop step at 384^3
    n = cs.P9_N
    cgrid = CartesianGrid(n, n, n, 1e-3)
    cmask = cs.bench_mask(torch, cgrid.shape, dev)
    dirm = torch.zeros(cgrid.shape, dtype=torch.bool, device=dev)
    dirm[:, :, 0] = True
    prep, step = make_cartesian_engine(
        cgrid, Material(7800.0, 490.0, 54.0), implementation="kernels",
        device=dev, dtype=torch.float32, theta=0.5, t_inf=20.0, k_table=kt,
        cp_table=ct, robin_h=200.0, neumann={"z+": 5e5},
        dirichlet_mask=dirm, dirichlet_value=600.0)
    p = prep(cmask)
    timed_step(torch, out, f"neumann/dirichlet varprop {n}^3",
               lambda T: step(T, p, 0.02, 1, 0.0),
               torch.where(cmask, 900.0, 20.0).to(torch.float32))
    torch.cuda.empty_cache()


def app_row(torch, cs, dev, out):
    """Wall seconds of phase 8's spiral app with --scheme douglas."""
    import time
    from adi_thermal_fields_tpu_torch.apps import spiral_tube as app
    args = app.build_argparser().parse_args(
        cs.P6_APP + cs.P8_APP_FLAGS + ["--scheme", "douglas", "--device",
                                       str(dev), "--implementation",
                                       "kernels"])
    t0 = time.perf_counter()
    res = app.run(args)
    torch.cuda.synchronize()
    out["spiral app douglas print wall_s"] = time.perf_counter() - t0
    out["spiral app douglas print steps"] = res["steps"]


def measure(root):
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adi_thermal_fields_tpu_torch import solvers

    dev = torch.device("cuda", 0)
    out = dict(root=root)
    k21_rows(torch, cs, dev, out)
    k17_rows(torch, cs, dev, out, hasattr(solvers, "vp_fields_sweep_z"))
    cyclic_field_rows(torch, cs, dev, out, root)
    step_rows(torch, cs, dev, out)
    app_row(torch, cs, dev, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out["card"] = smi.stdout.strip()
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1] == "--measure":
        measure(os.path.abspath(sys.argv[2]))
        return
    other = os.path.abspath(sys.argv[1])
    for root in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--measure", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
