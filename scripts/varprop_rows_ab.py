#!/usr/bin/env python3
"""A/B of the varprop sweeps K6, K7 and K8, the 512^3 varprop steps, and
the split-line sweeps K1, K2 and K4 that share K7's and K8's core, between
two checkouts of the PyTorch port, on one CUDA card.

    python3 scripts/varprop_rows_ab.py OTHER_CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run, float32 CUDA-event medians in ms:

* K6 (theta pass + x sweep, h stream) at chip_smoke.py phase 2's 256^3
  WAAM mask; K7 (y sweep: h stream, rob_c) and K8 (z sweep: radiation,
  convection alone) there and at the 512^3 WAAM mask;
* K1 (plan-lite y), K2 (plan-lite z) and K4 (stencil + plan-lite x) at
  the 512^3 WAAM mask;
* chip_smoke.py phase 3's 512^3 varprop step (the tables, h 30; with and
  without emissivity 0.5) in ms/step, each with its device time per
  kernel and their sum (busy ms) from torch.profiler over three steps,
  and the idle share 1 - busy / (CUDA-event ms/step).
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


def vp_rows(torch, cs, dev, n, out):
    """K6 (256^3 only), K7 and K8 at the n^3 WAAM mask."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (varprop_fields_plain,
                                                      varprop_sweep_y,
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
    T = cs.mushy_field(torch, mask, seed=7)
    R = cs.random_field(torch, mask, seed=13)
    codes = build_varprop_codes(mask)
    fc, w, h = varprop_fields_plain(T, mask.to(torch.uint8), k_spec=kt,
                                    cp_spec=ct, rho=mat.rho,
                                    rad=(cs.EMISSIVITY, 20.0, cs.H_CONV))
    yk = (R, codes[1], fc[1], w, sc["tg"][1], sc["sk"][1], 20.0)
    zk = (R, T, codes[2], sc["glo"], sc["gs"], sc["inv_dtor"])
    zkw = dict(k_spec=kt, cp_spec=ct, h=cs.H_CONV, t_inf=20.0)
    tag = f"{n}^3"
    if n == 256:
        out[f"K6_ms {tag}"] = cs.cuda_ms(torch, lambda: varprop_theta_sweep(
            T, codes[0], *fc, w, sc["cw"], sc["inv_d2"], sc["tg"][0],
            sc["sk"][0], 20.0, h=h), 50)
    out[f"K7_h_ms {tag}"] = cs.cuda_ms(
        torch, lambda: varprop_sweep_y(*yk, h=h), 50)
    out[f"K7_rob_c_ms {tag}"] = cs.cuda_ms(
        torch, lambda: varprop_sweep_y(*yk, rob_c=cs.H_CONV), 50)
    out[f"K8_rad_ms {tag}"] = cs.cuda_ms(torch, lambda: vp2_sweep_z(
        *zk, emissivity=cs.EMISSIVITY, **zkw), 50)
    out[f"K8_conv_ms {tag}"] = cs.cuda_ms(
        torch, lambda: vp2_sweep_z(*zk, **zkw), 50)


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


def step_rows(torch, cs, dev, out):
    """chip_smoke.py phase 3's 512^3 varprop step, with and without
    emissivity, ms/step and its profile."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine

    grid = CartesianGrid(512, 512, 512, 0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = cs.varprop_tables()
    mask = cs.waam_mask(torch, grid.shape, dev)
    T0 = cs.mushy_field(torch, mask, seed=11)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    for name, bcs in (("h30", dict(robin_h=cs.H_CONV)),
                      ("h30_eps", dict(robin_h=cs.H_CONV,
                                       emissivity=cs.EMISSIVITY))):
        prepare, advance = make_cartesian_engine(
            grid, mat, implementation="kernels", device=dev,
            dtype=torch.float32, theta=0.5, t_inf=20.0, k_table=kt,
            cp_table=ct, **bcs)
        prep = prepare(mask)
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
        prof = profile_steps(torch, lambda T: advance(T, prep, dt, 1, 0.0),
                             T)
        prof["idle_share"] = max(0.0, 1.0 - prof["busy_ms"] / ms)
        out[f"step_{name}_ms 512^3"] = ms
        out[f"profile_{name} 512^3"] = prof
        del prep, T
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
    for n in (256, 512):
        vp_rows(torch, cs, dev, n, out)
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
