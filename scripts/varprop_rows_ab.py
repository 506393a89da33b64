#!/usr/bin/env python3
"""A/B of the varprop sweeps K6, K7, K7x, K8 and K19, the varprop steps,
and the split-line sweeps K1, K2 and K4 that share their core, between
two checkouts of the PyTorch port, on one CUDA card.

    python3 scripts/varprop_rows_ab.py OTHER_CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run, CUDA-event medians in ms (float32 unless named):

* K6 (theta pass + x sweep: h stream; rob_c + src) at chip_smoke.py phase
  2's 256^3 and 512^3 WAAM masks; K7 (y sweep: h stream, rob_c) and K8 (z
  sweep: radiation, convection alone) there; K7x (x sweep, h stream) at
  512^3; K19 (z sweep: h stream, rob_c; float32 and float64) at 384^3 and
  512^3;
* K1 (plan-lite y), K2 (plan-lite z) and K4 (stencil + plan-lite x) at
  the 512^3 WAAM mask;
* chip_smoke.py phase 3's 512^3 varprop step (the tables, h 30; with and
  without emissivity 0.5; with emissivity also at float64, z on K19) and
  phase 9's 384^3 corrected-BC step (per-face h and radiation scales,
  emissivity 0.5; K5, K6, K7, K19) in ms/step, each with its device time
  per kernel and their sum (busy ms) from torch.profiler over three
  steps, and the idle share 1 - busy / (CUDA-event ms/step).
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys

from sweep_rows_ab import profile_steps

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_WARMUP, STEP_REPS = 2, 5


def vp_rows(torch, cs, dev, n, out, dtype):
    """K6 (256^3 and 512^3), K7 and K8 (256^3 and 512^3), K7x (512^3) and
    K19 (384^3 and 512^3) at the n^3 WAAM mask; at float64 K19 alone."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (varprop_fields_plain,
                                                      varprop_sweep_x,
                                                      varprop_sweep_y,
                                                      varprop_sweep_z,
                                                      varprop_theta_sweep,
                                                      vp2_sweep_z)
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_varprop_codes)

    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = cs.varprop_tables()
    shape = (n,) * 3
    grid = CartesianGrid(*shape, 0.5e-3)
    sc = cs.vp_scalars(grid, mat, 2.0 * grid.dx ** 2 / mat.alpha)
    mask = cs.waam_mask(torch, shape, dev)
    T = cs.mushy_field(torch, mask, seed=7).to(dtype)
    R = cs.random_field(torch, mask, seed=13).to(dtype)
    codes = build_varprop_codes(mask)
    fc, w, h = varprop_fields_plain(T, mask.to(torch.uint8), k_spec=kt,
                                    cp_spec=ct, rho=mat.rho,
                                    rad=(cs.EMISSIVITY, 20.0, cs.H_CONV))
    g = torch.Generator(device=dev).manual_seed(5)
    src = torch.where(mask, 1e8 * torch.rand(shape, generator=g, device=dev),
                      0.0).to(dtype)
    th = (T, codes[0], *fc, w, sc["cw"], sc["inv_d2"], sc["tg"][0],
          sc["sk"][0], 20.0)
    xk = (R, codes[0], fc[0], w, sc["tg"][0], sc["sk"][0], 20.0)
    yk = (R, codes[1], fc[1], w, sc["tg"][1], sc["sk"][1], 20.0)
    zk = (R, T, codes[2], sc["glo"], sc["gs"], sc["inv_dtor"])
    zkw = dict(k_spec=kt, cp_spec=ct, h=cs.H_CONV, t_inf=20.0)
    z19 = (R, codes[3], fc[2], w, sc["tg"][2], sc["sk"][2], 20.0)
    tag = f"{n}^3" + ("" if dtype == torch.float32 else " f64")
    rows = []
    if dtype == torch.float32 and n in (256, 512):
        rows += [
            ("K6_ms", lambda: varprop_theta_sweep(*th, h=h)),
            ("K6_rob_c_src_ms", lambda: varprop_theta_sweep(
                *th, rob_c=cs.H_CONV, src=src, dt=sc["dt"])),
            ("K7_h_ms", lambda: varprop_sweep_y(*yk, h=h)),
            ("K7_rob_c_ms", lambda: varprop_sweep_y(*yk, rob_c=cs.H_CONV)),
            ("K8_rad_ms", lambda: vp2_sweep_z(
                *zk, emissivity=cs.EMISSIVITY, **zkw)),
            ("K8_conv_ms", lambda: vp2_sweep_z(*zk, **zkw))]
    if dtype == torch.float32 and n == 512:
        rows.append(("K7x_h_ms", lambda: varprop_sweep_x(*xk, h=h)))
    if n in (384, 512):
        rows += [("K19_h_ms", lambda: varprop_sweep_z(*z19, h=h)),
                 ("K19_rob_c_ms", lambda: varprop_sweep_z(
                     *z19, rob_c=cs.H_CONV))]
    for name, fn in rows:
        out[f"{name} {tag}"] = cs.cuda_ms(torch, fn, 30)


def core_rows(torch, cs, dev, out):
    """K1 lite y, K2 lite z and K4 at the 512^3 WAAM mask (the split-line
    core's other users)."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (fused_theta_sweep,
                                                      sweep_code,
                                                      sweep_strided, sweep_z)
    from adi_thermal_fields_tpu_torch.step.cartesian import step_scalars

    f32 = torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    grid = CartesianGrid(512, 512, 512, 0.5e-3)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    dt, inv_d2, tg, c_exp = step_scalars(f32, grid, mat, dt, 0.5)
    rc = float(torch.tensor(30.0, dtype=f32)
               * torch.tensor(1.0 / (mat.rho * mat.cp * grid.dy), dtype=f32))
    mask = cs.waam_mask(torch, grid.shape, dev)
    T = cs.random_field(torch, mask, seed=7)
    c1 = sweep_code(mask, None, 1).movedim(0, 1).contiguous()
    c2 = sweep_code(mask, None, 2).movedim(0, 2).contiguous()
    c4 = sweep_code(mask, None, 0, stencil_bits=True)
    out["K1_lite_y_ms 512^3"] = cs.cuda_ms(torch, lambda: sweep_strided(
        T, c1, tg[1], dt, 20.0, axis=1, rob_c=rc), 30)
    out["K2_lite_z_ms 512^3"] = cs.cuda_ms(torch, lambda: sweep_z(
        T, c2, tg[2], dt, 20.0, rc), 30)
    out["K4_ms 512^3"] = cs.cuda_ms(torch, lambda: fused_theta_sweep(
        T, c4, c_exp, inv_d2, tg[0], dt, 20.0, rc), 30)


def timed_step(torch, out, name, advance, prep, T0, dt):
    """CUDA-event ms/step (median of STEP_REPS after STEP_WARMUP) and the
    profile of ``advance`` from ``T0``."""
    T = advance(T0, prep, dt, STEP_WARMUP, 0.0)
    times = []
    for i in range(STEP_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        T = advance(T, prep, dt, 1, i * dt)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    prof = profile_steps(torch, lambda T: advance(T, prep, dt, 1, 0.0), T)
    prof["idle_share"] = max(0.0, 1.0 - prof["busy_ms"] / ms)
    out[f"step_{name}_ms"] = ms
    out[f"profile_{name}"] = prof


def step_rows(torch, cs, dev, out):
    """chip_smoke.py phase 3's 512^3 varprop step, with and without
    emissivity (and with it at float64), and phase 9's 384^3 corrected-BC
    step: ms/step and their profiles."""
    import numpy as np
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.bc.faces import FACES

    grid = CartesianGrid(512, 512, 512, 0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = cs.varprop_tables()
    mask = cs.waam_mask(torch, grid.shape, dev)
    T0 = cs.mushy_field(torch, mask, seed=11)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    eps = dict(robin_h=cs.H_CONV, emissivity=cs.EMISSIVITY)
    for name, bcs, dtype in (
            ("h30 512^3", dict(robin_h=cs.H_CONV), torch.float32),
            ("h30_eps 512^3", eps, torch.float32),
            ("h30_eps 512^3 f64", eps, torch.float64)):
        prepare, advance = make_cartesian_engine(
            grid, mat, implementation="kernels", device=dev, dtype=dtype,
            theta=0.5, t_inf=20.0, k_table=kt, cp_table=ct, **bcs)
        timed_step(torch, out, name, advance, prepare(mask), T0.to(dtype),
                   dt)
        torch.cuda.empty_cache()
    del T0, mask
    # phase 9's corrected-BC step (bench.py's run_corrected)
    n = cs.P9_N
    grid = CartesianGrid(n, n, n, 1e-3)
    mask = cs.bench_mask(torch, grid.shape, dev)
    T0 = torch.where(mask, 900.0, 20.0).to(torch.float32)
    rng = np.random.default_rng(5)
    f32 = (lambda a: torch.from_numpy(a).to(dev, torch.float32))
    hf = {f: f32(10.0 + 10.0 * rng.random(grid.shape)) for f in FACES}
    scale = {f: f32(0.7 + 0.6 * rng.random(grid.shape)) for f in FACES}
    prepare, advance = make_cartesian_engine(
        grid, mat, implementation="kernels", device=dev, dtype=torch.float32,
        theta=0.5, t_inf=20.0, k_table=kt, cp_table=ct, robin_h=hf,
        radiation_scale=scale, emissivity=cs.EMISSIVITY)
    timed_step(torch, out, f"corrected {n}^3", advance, prepare(mask), T0,
               0.02)
    torch.cuda.empty_cache()


def measure(root):
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda", 0)
    out = dict(root=root)
    for n, dtype in ((256, torch.float32), (384, torch.float32),
                     (512, torch.float32), (384, torch.float64),
                     (512, torch.float64)):
        vp_rows(torch, cs, dev, n, out, dtype)
        torch.cuda.empty_cache()
    core_rows(torch, cs, dev, out)
    torch.cuda.empty_cache()
    step_rows(torch, cs, dev, out)
    out["card"] = torch.cuda.get_device_name(0)
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
