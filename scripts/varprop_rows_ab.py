#!/usr/bin/env python3
"""A/B of the varprop x and y sweeps (K6, K7) and the 512^3 varprop step
between two checkouts of the PyTorch port, on one CUDA card.

    python3 scripts/varprop_rows_ab.py OTHER_CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run: K6 (theta pass + x sweep, h stream) and K7 (y sweep, h stream)
CUDA-event medians at chip_smoke.py phase 2's 256^3 WAAM mask, and the
median ms/step of phase 3's 512^3 varprop step with the tables, h 30 and
emissivity 0.5, all float32.
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root):
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.solvers import (varprop_fields_plain,
                                                      varprop_sweep_y,
                                                      varprop_theta_sweep)
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_varprop_codes)

    dev = torch.device("cuda", 0)
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = cs.varprop_tables()
    shape = (256,) * 3
    grid = CartesianGrid(*shape, 0.5e-3)
    sc = cs.vp_scalars(grid, mat, 2.0 * grid.dx ** 2 / mat.alpha)
    mask = cs.waam_mask(torch, shape, dev)
    T = cs.mushy_field(torch, mask, seed=7)
    R = cs.random_field(torch, mask, seed=13)
    codes = build_varprop_codes(mask)
    fc, w, h = varprop_fields_plain(T, mask.to(torch.uint8), k_spec=kt,
                                    cp_spec=ct, rho=mat.rho,
                                    rad=(cs.EMISSIVITY, 20.0, cs.H_CONV))
    out = dict(root=root)
    out["K6_ms"] = cs.cuda_ms(torch, lambda: varprop_theta_sweep(
        T, codes[0], *fc, w, sc["cw"], sc["inv_d2"], sc["tg"][0],
        sc["sk"][0], 20.0, h=h), 50)
    out["K7_ms"] = cs.cuda_ms(torch, lambda: varprop_sweep_y(
        R, codes[1], fc[1], w, sc["tg"][1], sc["sk"][1], 20.0, h=h), 50)
    del T, R, fc, w, h, codes, mask
    grid = CartesianGrid(512, 512, 512, 0.5e-3)
    mask = cs.waam_mask(torch, grid.shape, dev)
    T0 = cs.mushy_field(torch, mask, seed=11)
    prepare, advance = make_cartesian_engine(
        grid, mat, implementation="kernels", device=dev, dtype=torch.float32,
        theta=0.5, t_inf=20.0, k_table=kt, cp_table=ct, robin_h=cs.H_CONV,
        emissivity=cs.EMISSIVITY)
    prep = prepare(mask)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    out["step_ms"] = statistics.median(cs.cuda_ms(
        torch, lambda: advance(T0, prep, dt, 1, 0.0), 10) for _ in range(3))
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
