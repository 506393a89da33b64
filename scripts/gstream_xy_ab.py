#!/usr/bin/env python3
"""A/B of the g-stream sweeps along x and y, K24 (the theta pass fused into
the x sweep) and K25 (the y sweep), and of the bfloat16 varprop step that
runs them, between two checkouts of the PyTorch port, on one CUDA card.

    python3 scripts/gstream_xy_ab.py OTHER_CHECKOUT
    python3 scripts/gstream_xy_ab.py --measure CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run (``--measure``: one run of one checkout): CUDA-event medians in ms
and the share of each kernel's bound (chip_smoke.py ``bound``: its inputs
read once and its output written once at 3.35 TB/s, or its operations at
67 TFLOP/s), at chip_smoke.py's shapes:

* K24 (seeded, and with src_pre) and K25 (seeded) at phase 10's 384^3
  WAAM mask and 97x203x131, bfloat16 and float32, on phase 10's streams
  (the radiative film); K26 beside them at 384^3 (the step's third sweep);
* K24 on 8192x64x64 and K25 on 64x8192x64 lines (LONG_LINES, seeded),
  bfloat16 and float32;
* phase 10's bfloat16 varprop step at 384^3 (bench.py's run_varprop
  through make_cartesian_engine, stochastic rounding) in ms/step (median
  of STEP_REPS after STEP_WARMUP), with its device time per kernel and
  their sum (busy ms) from torch.profiler over three steps
  (scripts/sweep_rows_ab.py ``profile_steps``), and the idle share 1 -
  busy / (CUDA-event ms/step).
"""
import importlib.util
import json
import os
import subprocess
import sys

from cyclic_rows_ab import row
from vp2_gstream_ab import bf16_step
from z_pencils_ab import gstream_case

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gstream_rows(torch, cs, dev, out):
    from adi_thermal_fields_tpu_torch.solvers import (gstream_sweep_y,
                                                      gstream_sweep_z,
                                                      gstream_theta_sweep)

    seed = dict(rng_seed=cs.P10_SEED)
    for label, shape in cs.P10_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            T, R, g_lo, g_hi, sw = gstream_case(torch, cs, dev, label, shape,
                                                dtype)
            where = f"{label} {str(dtype)[6:]}"
            th = (T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2], g_hi[2],
                  sw[0])
            row(torch, cs, out, "K24", where, th,
                lambda: gstream_theta_sweep(*th, 1.0, 20.0, rng_offset=1,
                                            **seed))
            sp = torch.where(T > 1000.0, 0.5, 0.0).to(dtype)
            row(torch, cs, out, "K24", f"{where} src_pre", (*th, sp),
                lambda: gstream_theta_sweep(*th, 1.0, 20.0, src_pre=sp))
            row(torch, cs, out, "K25", where, (R, g_lo[1], g_hi[1], sw[1]),
                lambda: gstream_sweep_y(R, g_lo[1], g_hi[1], sw[1], 20.0,
                                        rng_offset=2, **seed))
            if label.startswith("384"):
                row(torch, cs, out, "K26", where,
                    (R, g_lo[2], g_hi[2], sw[2]),
                    lambda: gstream_sweep_z(R, g_lo[2], g_hi[2], sw[2], 20.0,
                                            rng_offset=3, **seed))
            del T, R, g_lo, g_hi, sw, th, sp
            torch.cuda.empty_cache()
    for ax, kname in ((0, "K24"), (1, "K25")):
        shape = cs.LONG_LINES[ax]
        label = f"{'x'.join(map(str, shape))} lines"
        for dtype in (torch.bfloat16, torch.float32):
            T, R, g_lo, g_hi, sw = gstream_case(torch, cs, dev, "waam",
                                                shape, dtype)
            where = f"{label} {str(dtype)[6:]}"
            if ax == 0:
                th = (T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2],
                      g_hi[2], sw[0])
                row(torch, cs, out, kname, where, th,
                    lambda: gstream_theta_sweep(*th, 1.0, 20.0, rng_offset=1,
                                                **seed))
                del th
            else:
                row(torch, cs, out, kname, where,
                    (R, g_lo[1], g_hi[1], sw[1]),
                    lambda: gstream_sweep_y(R, g_lo[1], g_hi[1], sw[1],
                                            20.0, rng_offset=2, **seed))
            del T, R, g_lo, g_hi, sw
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
    gstream_rows(torch, cs, dev, out)
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
