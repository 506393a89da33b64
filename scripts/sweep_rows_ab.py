#!/usr/bin/env python3
"""A/B of K1 (the masked sweep, ``sweep_strided``) and K15 (the tier-2
sweep along cylindrical r, ``vp2_sweep_strided``) between two checkouts of
the PyTorch port, on one CUDA card.

    python3 scripts/sweep_rows_ab.py OTHER_CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run: CUDA-event medians, float32, of K1 at chip_smoke.py phase 2's
256^3 WAAM mask (plan-lite y, the constant-property path's variant, and
the field form along x with Neumann and Dirichlet) and of K15 at phase 8's
64x512x1024 tube (r, the cylindrical varprop BE step's variant).
"""
import importlib.util
import json
import os
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
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              build_coeff_packs)
    from adi_thermal_fields_tpu_torch.solvers import (sweep_code,
                                                      sweep_strided,
                                                      vp2_sweep_strided)
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp
    from adi_thermal_fields_tpu_torch.step.cartesian import step_scalars

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    out = dict(root=root)
    # K1, phase 2's 256^3 WAAM case
    grid = CartesianGrid(256, 256, 256, 0.5e-3)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    dt, _, tg, _ = step_scalars(f32, grid, mat, dt, 0.5)
    rc = float(torch.tensor(30.0, dtype=f32)
               * torch.tensor(1.0 / (mat.rho * mat.cp * grid.dy), dtype=f32))
    mask = cs.waam_mask(torch, grid.shape, dev)
    T = cs.random_field(torch, mask, seed=7)
    dirm = torch.zeros_like(mask)
    dirm[:, :, 0] = mask[:, :, 0]
    pk = build_coeff_packs(mask, grid, mat, dtype=f32, robin_h=200.0,
                           neumann={"z+": 5e5}, dirichlet_mask=dirm,
                           dirichlet_value=20.0)
    c1 = sweep_code(mask, None, 1).movedim(0, 1).contiguous()
    d0 = sweep_code(mask, dirm, 0)
    out["K1_lite_y_ms"] = cs.cuda_ms(torch, lambda: sweep_strided(
        T, c1, tg[1], dt, 20.0, axis=1, rob_c=rc), 50)
    out["K1_field_x_ms"] = cs.cuda_ms(torch, lambda: sweep_strided(
        T, d0, tg[0], dt, 20.0, axis=0, coeff=pk.coeff[0],
        qflux=pk.qflux[0], dir_val=pk.dir_val), 50)
    del T, mask, dirm, pk, c1, d0
    # K15, phase 8's tube, r
    label, shape, _ = cs.P8_SHAPES[0]
    grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape, f32, dev)
    R = cs.random_field(torch, mask, seed=43)
    code_r = cvp.build_cyl_vp2_plan(mask, grid, zbc)[0]
    cols = cvp._vp2_columns(grid, zbc, f32, dev)
    inv = float(torch.tensor(1.0, dtype=f32)
                / (torch.tensor(cs.P8_DT, dtype=f32)
                   / torch.tensor(mat.rho, dtype=f32)))
    r, r_imh, r_iph = cvp._radii(grid)
    kt, ct = cs.varprop_tables()
    rk = dict(k_spec=kt, cp_spec=ct, h_lo=80.0, h_hi=80.0, tinf_void=20.0,
              emissivity=cs.EMISSIVITY,
              edge0=(50.0, r_imh[0] / (r[0] * grid.dr), 20.0),
              edge1=(300.0, r_iph[-1] / (r[-1] * grid.dr), 20.0))
    rcols = (cols["glo_r"], cols["ghi_r"], cols["gsl_r"], cols["gsh_r"])
    out["K15_r_ms"] = cs.cuda_ms(torch, lambda: vp2_sweep_strided(
        R, T, code_r, *rcols, inv, **rk), 50)
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
