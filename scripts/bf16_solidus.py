#!/usr/bin/env python3
"""How a bfloat16 state with stochastic rounding cools through the latent
heat of the apparent-cp method, against float32, on the PyTorch port.

A 20x12x12 mm steel block (1 mm cells, one corner of a 24x16x16 grid) at
1500 C cools by convection (h 30) and radiation (emissivity 0.5) for 300
sub-steps of 0.14 s through make_cartesian_engine(stochastic_rounding=True)
(the g-stream tier at bfloat16, the classic tier at float32), once without
latent heat and once with 2.7e5 J/kg over a mushy interval of 50 K
(1420-1470 C, the WAAM app's) and of 170 K (1300-1470 C).  Prints the mean,
min and max of the block's temperature for each.

Stochastic rounding is unbiased in T, not in enthalpy: at the solidus cp
jumps 12x, so zero-mean rounding noise of a few K adds heat on average (the
enthalpy is convex there) and a narrow mushy interval holds the state at
the solidus.

    python scripts/bf16_solidus.py             # on the CPU (plain versions)
    python scripts/bf16_solidus.py --device cuda
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,  # noqa
                                          apparent_cp)
from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine  # noqa
from adi_thermal_fields_tpu_torch.step.cartesian import round_to_state  # noqa


def run(device, dtype, cp_table, steps, dt):
    grid = CartesianGrid(24, 16, 16, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = torch.zeros(grid.shape, dtype=torch.bool, device=device)
    mask[2:22, 2:14, :12] = True
    prepare, advance = make_cartesian_engine(
        grid, mat, implementation="kernels", device=device, dtype=dtype,
        t_inf=20.0, robin_h=30.0, emissivity=0.5, cp_table=cp_table,
        stochastic_rounding=dtype == torch.bfloat16)
    T = torch.where(mask, 1500.0, 20.0).to(dtype)
    T = advance(T, prepare(mask), round_to_state(dt, dtype), steps, 0.0)
    block = T.double()[mask]
    return float(block.mean()), float(block.min()), float(block.max())


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cpu")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--dt", type=float, default=0.14)
    args = p.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cases = (("no latent heat", None),
             ("mushy 1420-1470 C", apparent_cp(490.0, 490.0, 2.7e5, 1420.0,
                                               1470.0)),
             ("mushy 1300-1470 C", apparent_cp(490.0, 490.0, 2.7e5, 1300.0,
                                               1470.0)))
    dev = torch.device(args.device)
    for name, cp in cases:
        f32 = run(dev, torch.float32, cp, args.steps, args.dt)
        bf = run(dev, torch.bfloat16, cp, args.steps, args.dt)
        print(f"{name:18s} after {args.steps} steps: float32 mean/min/max "
              f"{f32[0]:.2f}/{f32[1]:.1f}/{f32[2]:.1f} C, bfloat16 + SR "
              f"{bf[0]:.2f}/{bf[1]:.1f}/{bf[2]:.1f} C", flush=True)


if __name__ == "__main__":
    main()
