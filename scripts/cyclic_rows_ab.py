#!/usr/bin/env python3
"""A/B of the periodic phi sweeps K11 (masked-Robin) and K16 (tier-2
variable-property) and the two cylindrical steps that run them, between
two checkouts of the PyTorch port, on one CUDA card.

    python3 scripts/cyclic_rows_ab.py OTHER_CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run: CUDA-event medians in ms and the share of each kernel's bound
(chip_smoke.py ``bound``: its inputs read once and its output written
once at 3.35 TB/s, or its operations at 67 TFLOP/s) at chip_smoke.py's
shapes, float32 unless named:

* K11 at phase 6's (64, 512, 1024) tube and (37, 203, 131) disk, and K16
  at phase 8's tube and disk (float32 and float64);
* both on CYCLIC_SHAPES: the spiral app's (32, 720, 200) ring and the
  4096-row lines on a mild and a stiff annulus;
* phase 6's masked-Robin step and phase 8's varprop backward-Euler step at
  (64, 512, 1024) in ms/step (median of STEP_REPS after STEP_WARMUP), each
  with its device time per kernel and their sum (busy ms) from
  torch.profiler over three steps (scripts/sweep_rows_ab.py
  ``profile_steps``), and the idle share 1 - busy / (CUDA-event ms/step).
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


def row(torch, cs, out, kname, name, ins, fn, reps=30):
    """The kernel's median ms and its share of the bound on ``ins``."""
    got = fn()
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, got))
    ms = cs.cuda_ms(torch, fn, reps)
    b = cs.bound(kname, nbytes, got.numel())["bound_ms"]
    out[f"{kname} {name} ms"] = ms
    out[f"{kname} {name} pct_of_bound"] = 100.0 * b / ms


def k11_rows(torch, cs, dev, out):
    """K11 at phase 6's tube and disk and on CYCLIC_SHAPES."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import masked_cyclic_phi

    f32 = torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    fac = float(torch.tensor(cs.CYL_DT, dtype=f32)
                * torch.tensor(mat.alpha, dtype=f32))
    cases = [(label, shape, 5e-4, 0.02 if label.endswith("tube") else 0.0)
             for label, shape in cs.CYL_SHAPES] + list(cs.CYCLIC_SHAPES[:3])
    for label, shape, dr, r_inner in cases:
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        if label.endswith("tube"):
            mask = cs.tube_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(29)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        plan = cs.cyl_plan(torch, grid, mask, "dirichlet")
        R = cs.random_field(torch, mask, seed=17)
        row(torch, cs, out, "K11", label, (R, *plan.phi),
            lambda: masked_cyclic_phi(R, *plan.phi, fac, 20.0))
        del R, plan, mask
        torch.cuda.empty_cache()


def k16_rows(torch, cs, dev, out):
    """K16 at phase 8's tube and disk (float32 and float64) and on
    CYCLIC_SHAPES."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.solvers import vp2_cyclic_phi
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    kt, ct = cs.varprop_tables()
    pk = dict(k_spec=kt, cp_spec=ct, h_void=80.0, tinf_void=20.0,
              emissivity=cs.EMISSIVITY)
    cases = [(label, shape, prec, 5e-4, None)
             for label, shape, prec in cs.P8_SHAPES] + [
        (label, shape, "float32", dr, r_inner)
        for label, shape, dr, r_inner in cs.CYCLIC_SHAPES[:3]]
    for label, shape, prec, dr, r_inner in cases:
        dtype = getattr(torch, prec)
        f = getattr(np, prec)
        grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape, dtype,
                                                dev, dr, r_inner)
        R = cs.random_field(torch, mask, seed=43).to(dtype)
        code = cvp.build_cyl_vp2_plan(mask, grid, zbc)[1]
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        inv = float(f(1.0) / f(f(cs.P8_DT) / f(mat.rho)))
        args = (R, T, code, cols["geo_p"], cols["gs_p"], inv)
        row(torch, cs, out, "K16", f"{label} {prec}", (R, T, code),
            lambda: vp2_cyclic_phi(*args, **pk))
        del R, T, code, args
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
    """Phase 6's masked-Robin step and phase 8's varprop BE step at
    (64, 512, 1024), float32, kernels."""
    from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material,
                                              RobinBC, adi_step_cyl_varprop,
                                              build_cyl_vp2_plan,
                                              masked_robin_solve)

    label, shape = cs.CYL_SHAPES[0]
    grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    mask = cs.tube_mask(torch, shape, dev)
    plan = cs.cyl_plan(torch, grid, mask, "neumann0")
    timed_step(torch, out, "masked 64x512x1024",
               lambda T: masked_robin_solve(T, plan, grid, mat, dt=cs.CYL_DT,
                                            implementation="kernels"),
               cs.random_field(torch, mask, seed=19))
    del plan, mask
    torch.cuda.empty_cache()
    label, shape, _ = cs.P8_SHAPES[0]
    grid, mat, mask, zbc, T0 = cs.cylvp_case(torch, label, shape,
                                             torch.float32, dev)
    kt, ct = cs.varprop_tables()
    vp2_plan = build_cyl_vp2_plan(mask, grid, zbc)
    kw = dict(dt=cs.P8_DT, robin_outer=RobinBC(300.0, 20.0), zbc=zbc,
              robin_inner=RobinBC(50.0, 20.0), active=mask, h_void=80.0,
              T_inf_void=20.0, h_front=200.0, k_table=kt, cp_table=ct,
              emissivity=cs.EMISSIVITY)
    timed_step(torch, out, "varprop BE 64x512x1024",
               lambda T: adi_step_cyl_varprop(
                   T, grid, mat, scheme="be", implementation="kernels",
                   vp2_plan=vp2_plan, **kw), T0)
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
    k11_rows(torch, cs, dev, out)
    k16_rows(torch, cs, dev, out)
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
