#!/usr/bin/env python3
"""A/B of the contiguous-z sweeps K10 (masked-Robin, the cylindrical masked
step) and K26 (the g-stream tier, the bfloat16 varprop step), with K24 and
K25 beside them, and the two steps that run them, between two checkouts of
the PyTorch port, on one CUDA card.

    python3 scripts/z_pencils_ab.py OTHER_CHECKOUT
    python3 scripts/z_pencils_ab.py --measure CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run (``--measure``: one run of one checkout): CUDA-event medians in ms
and the share of each kernel's bound (chip_smoke.py ``bound``: its inputs
read once and its output written once at 3.35 TB/s, or its operations at
67 TFLOP/s), at chip_smoke.py's shapes:

* K10 at phase 6's (64, 512, 1024) tube and (37, 203, 131) disk, on the
  spiral app's (32, 720, 200) ring at 0.25 mm (CYCLIC_SHAPES[0]) and on
  64x64x8192 lines, float32, fac = dt * alpha at phase 6's dt;
* K10 also at 10x dt on the tube and at the spiral app's own dt (0.05 s)
  on its ring, where float32 lines past the replay ratio take the
  Thomas-order replay;
* K26 at phase 10's 384^3 WAAM mask and 97x203x131, bfloat16 (seeded)
  and float32, and on 64x64x8192 lines; K24 and K25 at 384^3 bfloat16
  (seeded);
* the other users of the staged kernel: K21's z entry on phase 9's 384^3
  systems and 64x64x8192 lines (float32), K17's natural z on phase 8's
  disk (float64);
* phase 6's masked-Robin step at (64, 512, 1024) float32 and phase 10's
  bfloat16 varprop step at 384^3 (bench.py's run_varprop through
  make_cartesian_engine, stochastic rounding) in ms/step (median of
  STEP_REPS after STEP_WARMUP), each with its device time per kernel and
  their sum (busy ms) from torch.profiler over three steps
  (scripts/sweep_rows_ab.py ``profile_steps``), and the idle share 1 -
  busy / (CUDA-event ms/step).
"""
import importlib.util
import json
import os
import subprocess
import sys

from cyclic_rows_ab import row, timed_step
from vp2_gstream_ab import bf16_step

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG = ("64x64x8192 lines", (64, 64, 8192))


def k10_case(torch, cs, dev, label, shape, dr, r_inner):
    """Phase 6's plan on one cylindrical shape: (R, plan)."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid

    grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
    if label.endswith("disk"):
        g = torch.Generator(device=dev).manual_seed(29)
        mask = torch.rand(shape, generator=g, device=dev) > 0.25
    else:
        mask = cs.tube_mask(torch, shape, dev)
    plan = cs.cyl_plan(torch, grid, mask,
                       "neumann0" if label.endswith("disk") else "dirichlet")
    return cs.random_field(torch, mask, seed=17), plan


def k10_shapes(cs):
    """(label, shape, dr, r_inner, dt multiple) of K10's rows."""
    ring = cs.CYCLIC_SHAPES[0]
    return ([(label, shape, 5e-4, 0.0 if label.endswith("disk") else 0.02,
              1.0) for label, shape in cs.CYL_SHAPES]
            + [ring + (1.0,), LONG + (5e-4, 0.02, 1.0),
               (cs.CYL_SHAPES[0][0] + " 10x dt", cs.CYL_SHAPES[0][1], 5e-4,
                0.02, 10.0),
               (ring[0] + " app dt", *ring[1:], 0.05 / cs.CYL_DT)])


def k10_rows(torch, cs, dev, out):
    from adi_thermal_fields_tpu_torch import Material
    from adi_thermal_fields_tpu_torch.solvers import masked_sweep_z

    f32 = torch.float32
    alpha = Material(7800.0, 490.0, 54.0).alpha
    for label, shape, dr, r_inner, dtm in k10_shapes(cs):
        fac = float(torch.tensor(cs.CYL_DT * dtm, dtype=f32)
                    * torch.tensor(alpha, dtype=f32))
        R, plan = k10_case(torch, cs, dev, label, shape, dr, r_inner)
        row(torch, cs, out, "K10", label, (R, *plan.z),
            lambda: masked_sweep_z(R, *plan.z, fac, 20.0))
        del R, plan
        torch.cuda.empty_cache()


def gstream_case(torch, cs, dev, label, shape, dtype):
    """Phase 10's streams on one shape: (R, g_lo, g_hi, sw)."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import gstream_fields

    sc = cs.vp_scalars(CartesianGrid(*shape, 0.5e-3),
                       Material(7800.0, 490.0, 54.0), cs.P10_VP_DT)
    if label.endswith("waam"):
        mask = cs.waam_mask(torch, shape, dev)
    else:
        g = torch.Generator(device=dev).manual_seed(3)
        mask = torch.rand(shape, generator=g, device=dev) > 0.25
    T = cs.mushy_field(torch, mask, seed=7).to(dtype)
    R = cs.random_field(torch, mask, seed=13).to(dtype)
    kt, ct = cs.varprop_tables()
    g_lo, g_hi, sw, _ = gstream_fields(
        T, mask.to(torch.uint8), sc["tg"], sc["sk"], k_spec=kt, cp_spec=ct,
        rho=7800.0, dt=sc["dt"], t_inf=20.0, h_mode="rad",
        hpar=cs.EMISSIVITY, h_conv=cs.H_CONV)
    return T, R, g_lo, g_hi, sw


def gstream_rows(torch, cs, dev, out):
    from adi_thermal_fields_tpu_torch.solvers import (gstream_sweep_y,
                                                      gstream_sweep_z,
                                                      gstream_theta_sweep)

    seed = dict(rng_seed=cs.P10_SEED)
    cases = [(label, shape, dtype) for label, shape in cs.P10_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [LONG + (torch.bfloat16,), LONG + (torch.float32,)]
    for label, shape, dtype in cases:
        T, R, g_lo, g_hi, sw = gstream_case(torch, cs, dev, label, shape,
                                            dtype)
        where = f"{label} {str(dtype)[6:]}"
        row(torch, cs, out, "K26", where, (R, g_lo[2], g_hi[2], sw[2]),
            lambda: gstream_sweep_z(R, g_lo[2], g_hi[2], sw[2], 20.0,
                                    rng_offset=3, **seed))
        if label.startswith("384") and dtype == torch.bfloat16:
            th = (T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2], g_hi[2],
                  sw[0])
            row(torch, cs, out, "K24", where, th,
                lambda: gstream_theta_sweep(*th, 1.0, 20.0, rng_offset=1,
                                            **seed))
            row(torch, cs, out, "K25", where, (R, g_lo[1], g_hi[1], sw[1]),
                lambda: gstream_sweep_y(R, g_lo[1], g_hi[1], sw[1], 20.0,
                                        rng_offset=2, **seed))
        del T, R, g_lo, g_hi, sw
        torch.cuda.empty_cache()


def staged_rows(torch, cs, dev, out):
    """K21's z entry (float32: 384^3, 8192-row lines) and K17's natural z
    (phase 8's disk, float64): the staged kernel's other users."""
    from adi_thermal_fields_tpu_torch.solvers import (tridiag_fields,
                                                      vp_fields_sweep_z)
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    for label, shape in ((cs.P9_SHAPES[0][0], cs.P9_SHAPES[0][1]), LONG):
        a, b, c, R = cs.field_systems(torch, shape, torch.float32, dev, 5)
        row(torch, cs, out, "K21", f"z {label}", (a, b, c, R),
            lambda: tridiag_fields(a, b, c, R, 2))
        del a, b, c, R
        torch.cuda.empty_cache()
    label, shape, prec = cs.P8_SHAPES[2]
    grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape,
                                            torch.float64, dev)
    cols = cvp._vp2_columns(grid, zbc, torch.float64, dev)
    R = cs.random_field(torch, mask, seed=26).double()
    _, sz = cs.k17_streams(torch, grid, mat, mask, T, R, cs.P8_DT, 28)
    row(torch, cs, out, "K17", f"z {label} {prec}", sz,
        lambda: vp_fields_sweep_z(*sz, cols["geo_z"], cols["geo_z"]))
    del T, R, sz, mask
    torch.cuda.empty_cache()


def masked_step(torch, cs, dev, out):
    """Phase 6's masked-Robin step at (64, 512, 1024) float32."""
    from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material,
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


def measure(root):
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda", 0)
    out = dict(root=root)
    k10_rows(torch, cs, dev, out)
    gstream_rows(torch, cs, dev, out)
    staged_rows(torch, cs, dev, out)
    masked_step(torch, cs, dev, out)
    bf16_step(torch, cs, dev, out)
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
