#!/usr/bin/env python3
"""A/B of K8's general form (the cylindrical tier-2 z sweep) and K23 (the
g-stream table pass) and the two steps that run them, between two
checkouts of the PyTorch port, on one CUDA card.

    python3 scripts/vp2_gstream_ab.py OTHER_CHECKOUT
    python3 scripts/vp2_gstream_ab.py --measure CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run (``--measure``: one run of one checkout): CUDA-event medians in ms
and the share of each kernel's bound (chip_smoke.py ``bound``: its inputs
read once and its output written once at 3.35 TB/s, or its operations at
67 TFLOP/s), at chip_smoke.py's shapes:

* K8's general form at phase 8's (64, 512, 1024) tube (float32, and at
  10x the step's dt), its (37, 203, 131) disk (float32 and float64) and on
  64x64x8192 lines (past the staged lines: the core's strided kernel);
  K8's Cartesian form at 512^3 (the WAAM mask, radiation);
* K23 at phase 10's 384^3 WAAM mask and 97x203x131, bfloat16 and
  float32, in each film mode (const, stream, rad) and with a source;
* phase 8's varprop backward-Euler step at (64, 512, 1024) float32 and
  phase 10's bfloat16 varprop step at 384^3 (bench.py's run_varprop
  through make_cartesian_engine, stochastic rounding) in ms/step (median
  of STEP_REPS after STEP_WARMUP), each with its device time per kernel
  and their sum (busy ms) from torch.profiler over three steps
  (scripts/sweep_rows_ab.py ``profile_steps``), and the idle share 1 -
  busy / (CUDA-event ms/step).
"""
import importlib.util
import json
import os
import subprocess
import sys

from cyclic_rows_ab import row, timed_step

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k8_rows(torch, cs, dev, out):
    """K8's general form on phase 8's inputs, and its Cartesian form at
    512^3."""
    import numpy as np
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import vp2_sweep_z
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_varprop_codes)

    kt, ct = cs.varprop_tables()
    label, shape, _ = cs.P8_SHAPES[0]
    cases = [(f"{label} {prec}", label, shape, prec, 1.0)
             for label, shape, prec in cs.P8_SHAPES]
    cases += [(f"{label} float32, 10x dt", label, shape, "float32", 10.0),
              ("64x64x8192 lines float32", "8192 tube", (64, 64, 8192),
               "float32", 1.0)]
    for name, label, shape, prec, fac in cases:
        dtype = getattr(torch, prec)
        f = getattr(np, prec)
        grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape, dtype,
                                                dev)
        R = cs.random_field(torch, mask, seed=43).to(dtype)
        code = cvp.build_cyl_vp2_plan(mask, grid, zbc)[2]
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        inv = float(f(1.0) / f(f(fac * cs.P8_DT) / f(mat.rho)))
        zk = dict(k_spec=kt, cp_spec=ct, ghi=cols["geo_z"],
                  gsh=cols["gs_z"], h=80.0, h_hi=200.0, t_inf=20.0,
                  emissivity=cs.EMISSIVITY,
                  edge1=(400.0, 1.0 / grid.dz, 20.0))
        row(torch, cs, out, "K8", f"general {name}", (R, T, code),
            lambda: vp2_sweep_z(R, T, code, cols["geo_z"], cols["gs_z"],
                                inv, **zk))
        del R, T, code, mask
        torch.cuda.empty_cache()
    shape = (512,) * 3
    mask = cs.waam_mask(torch, shape, dev)
    T = cs.mushy_field(torch, mask, 5)
    R = cs.random_field(torch, mask, 6)
    sc = cs.vp_scalars(CartesianGrid(*shape, 0.5e-3),
                       Material(7800.0, 490.0, 54.0), cs.P10_VP_DT)
    code = build_varprop_codes(mask)[2]
    row(torch, cs, out, "K8", "Cartesian 512^3 waam rad", (R, T, code),
        lambda: vp2_sweep_z(R, T, code, sc["glo"], sc["gs"], sc["inv_dtor"],
                            k_spec=kt, cp_spec=ct, h=cs.H_CONV, t_inf=20.0,
                            emissivity=cs.EMISSIVITY))
    del R, T, code, mask
    torch.cuda.empty_cache()


def k23_rows(torch, cs, dev, out):
    """K23 on phase 10's shapes, bfloat16 and float32, each film mode."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import gstream_fields

    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = cs.varprop_tables()
    for label, shape in cs.P10_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            sc = cs.vp_scalars(CartesianGrid(*shape, 0.5e-3), mat,
                               cs.P10_VP_DT)
            if label.endswith("waam"):
                mask = cs.waam_mask(torch, shape, dev)
            else:
                g = torch.Generator(device=dev).manual_seed(3)
                mask = torch.rand(shape, generator=g, device=dev) > 0.25
            T = cs.mushy_field(torch, mask, seed=7).to(dtype)
            m8 = mask.to(torch.uint8)
            g = torch.Generator(device=dev).manual_seed(5)
            h = (5.0 + 40.0 * torch.rand(shape, generator=g, device=dev)
                 ).to(dtype)
            src = torch.where(mask, 1e8 * torch.rand(shape, generator=g,
                                                     device=dev),
                              0.0).to(dtype)
            fk = dict(k_spec=kt, cp_spec=ct, rho=mat.rho, dt=sc["dt"],
                      t_inf=20.0)
            modes = (("const", (T, m8), dict(h_mode="const",
                                             hpar=cs.H_CONV)),
                     ("stream", (T, m8, h), dict(h_mode="stream", h=h)),
                     ("rad", (T, m8), dict(h_mode="rad",
                                           hpar=cs.EMISSIVITY,
                                           h_conv=cs.H_CONV)),
                     ("rad + src", (T, m8, src),
                      dict(h_mode="rad", hpar=cs.EMISSIVITY,
                           h_conv=cs.H_CONV, src=src)))
            where = f"{label} {str(dtype)[6:]}"
            for mode, ins, kw in modes:
                def fn(kw=kw):
                    g_lo, g_hi, sw, sp = gstream_fields(
                        T, m8, sc["tg"], sc["sk"], **fk, **kw)
                    # one tensor whose numel is the cells and whose bytes
                    # are the outputs' (row() adds the output's bytes)
                    return _Outs(g_lo + g_hi + sw + ((sp,) if sp is not None
                                                     else ()))
                row(torch, cs, out, "K23", f"{mode} {where}", ins, fn)
            del T, m8, h, src, mask
            torch.cuda.empty_cache()


class _Outs:
    """The streams K23 returns, seen by ``row`` as one output: the cells
    of one and the bytes of all."""

    def __init__(self, ts):
        self.ts = ts

    def numel(self):
        return self.ts[0].numel()

    def element_size(self):
        return sum(t.element_size() for t in self.ts)


def bf16_step(torch, cs, dev, out):
    """Phase 10's bf16 varprop step at 384^3 (bench.py run_varprop)."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine

    n = cs.P9_N
    grid = CartesianGrid(n, n, n, 1e-3)
    mask = cs.bench_mask(torch, grid.shape, dev)
    T0 = torch.where(mask, 900.0, 20.0).to(torch.bfloat16)
    kt, ct = cs.varprop_tables()
    prepare, advance = make_cartesian_engine(
        grid, Material(7800.0, 490.0, 54.0), implementation="kernels",
        device=dev, dtype=torch.bfloat16, theta=0.5, t_inf=20.0,
        stochastic_rounding=True, robin_h=15.0, emissivity=cs.EMISSIVITY,
        k_table=kt, cp_table=ct)
    prep = prepare(mask)
    clock = [0]

    def step(T):
        clock[0] += 1
        return advance(T, prep, cs.P10_VP_DT, 1, clock[0] * cs.P10_VP_DT)

    timed_step(torch, out, "bf16 varprop 384^3", step, T0)
    del T0, mask, prep
    torch.cuda.empty_cache()


def be_step(torch, cs, dev, out):
    """Phase 8's varprop BE step at (64, 512, 1024) float32."""
    from adi_thermal_fields_tpu_torch import (RobinBC, adi_step_cyl_varprop,
                                              build_cyl_vp2_plan)

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
    del T0, mask, vp2_plan
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
    k8_rows(torch, cs, dev, out)
    k23_rows(torch, cs, dev, out)
    be_step(torch, cs, dev, out)
    bf16_step(torch, cs, dev, out)
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
