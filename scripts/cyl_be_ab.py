#!/usr/bin/env python3
"""A/B of the cylindrical steps' pencil sweeps K9 (masked-Robin r) and K13
(constant-row z), K12 (the unmasked cylindrical step's r sweep), K14 (its
periodic phi solve) and K15 with its y entry K15y (the tier-2 r and y
sweeps) and the steps and apps that run them, between two checkouts of
the PyTorch port, on one CUDA card.

    python3 scripts/cyl_be_ab.py [--k14 | --pencils | --k12] OTHER_CHECKOUT
    python3 scripts/cyl_be_ab.py [--k14 | --pencils | --k12] --measure CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run (``--measure``: one run of one checkout; ``--k14``: K14's rows
alone; ``--pencils``: K9's, K13's and K14's rows and the masked, BE and
Douglas steps alone; ``--k12``: K12's, K13's and K14's rows and the BE
and Douglas steps alone): CUDA-event medians in ms
and the share of each kernel's bound (chip_smoke.py ``bound``: its field
read once and its output written once at 3.35 TB/s, or its operations at
67 TFLOP/s), at chip_smoke.py's shapes:

* K9 at phase 6's (64, 512, 1024) tube and (37, 203, 131) disk and on
  97-row r lines of the tube's kind (97, 512, 675), float32, fac = dt *
  alpha at phase 6's dt;
* K13 at phase 7's (128, 512, 512) annulus and (37, 203, 131) disk and on
  8192-row lines (64, 64, 8192), float32, with the step's table where the
  checkout takes one and given none (the table built in the call), and
  K13's table kernel (K13t) alone;
* phase 6's masked-Robin step at (64, 512, 1024), with its profile;
* K12 at phase 7's (128, 512, 512) annulus and (37, 203, 131) disk, the
  spiral app's (32, 720, 200) ring at its dt (0.05 s) and 512-row r
  lines (512, 512, 128), float32, with the step's table (``_r_table``)
  where the checkout takes one and given none (the table built in the
  call), and at the annulus the PyTorch call computing the same function
  (chip_smoke.py's addmm by the dense inverse);

* K14 at phase 7's (128, 512, 512) annulus and (37, 203, 131) disk,
  float32 and float64, and on the spiral app's (32, 720, 200) ring at its
  dt (0.05 s), with the step's table where the checkout takes one; at the
  annulus also K14 given no table (built in the call where the checkout
  takes one) and the PyTorch call computing the same function (the
  rfft/irfft solve, phi_solve_spectral);
* phase 7's unmasked backward-Euler and Douglas steps at (128, 512, 512);
* K15 at phase 8's (64, 512, 1024) tube (the rhs T itself, as the step
  calls it, and given), its disk, and the tube at 10x the step's dt;
  K15y at the 512^3 WAAM mask (radiative film);
* phase 8's varprop backward-Euler step at (64, 512, 1024);
* the steps with their device time per kernel and their sum (busy ms)
  from torch.profiler over three steps (scripts/sweep_rows_ab.py
  ``profile_steps``), and the idle share 1 - busy / (CUDA-event ms/step);
* the spiral app's prints (phase 7's --void_mode clamp, phase 8's
  varprop flags; float32, kernels): wall s.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys

from cyclic_rows_ab import row, timed_step
from z_pencils_ab import k10_case, masked_step

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K9's r lines past its march and K13's z lines past its staging
K9_LONG = ("97x512x675 tube", (97, 512, 675))
K13_LONG = ("64x64x8192 annular", (64, 64, 8192))
# K12's r lines past its march
K12_LONG = ("512x512x128 annular", (512, 512, 128))


def k14_rows(torch, cs, dev, out):
    """K14 at phase 7's shapes, float32 and float64, and the rfft solve."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (cyclic_const_phi,
                                                      phi_solve_spectral)
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl

    takes_table = "table" in inspect.signature(cyclic_const_phi).parameters
    for label, shape in cs.P7_SHAPES:
        grid, mat, _, _ = cs.be_case(label, shape)
        for dtype in (torch.float32, torch.float64):
            R = cs.random_field(torch, torch.ones(shape, dtype=torch.bool,
                                                  device=dev), 23).to(dtype)
            key = (grid, mat, 1.0, cs.P7_DT, dtype, dev)
            fac = cyl._phi_fac(*key)
            args = (R, fac, cyl._phi_table(*key)) if takes_table else (R, fac)
            row(torch, cs, out, "K14", f"{label} {str(dtype)[6:]}", (R,),
                lambda: cyclic_const_phi(*args))
            if label.endswith("annular") and dtype == torch.float32:
                # a call that is given no table (built in the call where
                # the checkout takes one)
                row(torch, cs, out, "K14", f"{label} float32 no table",
                    (R,), lambda: cyclic_const_phi(R, fac))
                out["K14 rfft solve ms"] = cs.cuda_ms(
                    torch, lambda: phi_solve_spectral(R, grid, mat, 1.0,
                                                      cs.P7_DT), 10)
            del R, args
            torch.cuda.empty_cache()
    # the spiral app's ring (720 rows)
    label, shape, dr, r_inner = cs.CYCLIC_SHAPES[0][:4]
    grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
    mat = Material(7800.0, 490.0, 54.0)
    R = cs.random_field(torch, torch.ones(shape, dtype=torch.bool,
                                          device=dev), 23)
    key = (grid, mat, 1.0, 0.05, torch.float32, dev)
    fac = cyl._phi_fac(*key)
    args = (R, fac, cyl._phi_table(*key)) if takes_table else (R, fac)
    row(torch, cs, out, "K14", f"{label} float32", (R,),
        lambda: cyclic_const_phi(*args))
    del R, args
    torch.cuda.empty_cache()


def k9_rows(torch, cs, dev, out):
    """K9 at phase 6's tube and disk and on 97-row r lines."""
    from adi_thermal_fields_tpu_torch import Material
    from adi_thermal_fields_tpu_torch.solvers import masked_sweep_strided

    f32 = torch.float32
    fac = float(torch.tensor(cs.CYL_DT, dtype=f32)
                * torch.tensor(Material(7800.0, 490.0, 54.0).alpha,
                               dtype=f32))
    shapes = [(label, shape, 0.0 if label.endswith("disk") else 0.02)
              for label, shape in cs.CYL_SHAPES]
    shapes.append(K9_LONG + (0.02,))
    for label, shape, r_inner in shapes:
        R, plan = k10_case(torch, cs, dev, label, shape, 5e-4, r_inner)
        row(torch, cs, out, "K9", label, (R, *plan.r),
            lambda: masked_sweep_strided(R, *plan.r, fac, 20.0))
        del R, plan
        torch.cuda.empty_cache()


def k13_rows(torch, cs, dev, out):
    """K13 at phase 7's shapes and on 8192-row lines, with the step's
    table (where the checkout takes one) and given none; K13t alone."""
    from adi_thermal_fields_tpu_torch.solvers import const_sweep_z
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl

    f32 = torch.float32
    takes_table = "table" in inspect.signature(const_sweep_z).parameters
    for label, shape in (*cs.P7_SHAPES, K13_LONG):
        grid, mat, _, zbc = cs.be_case(label, shape)
        R = cs.random_field(torch, torch.ones(shape, dtype=torch.bool,
                                              device=dev), 23)
        vecs, _ = cyl._z_coefficients(grid, mat, zbc, cs.P7_DT, f32, dev)
        row(torch, cs, out, "K13", f"{label} no table", (R, *vecs),
            lambda: const_sweep_z(R, *vecs))
        if takes_table:
            from adi_thermal_fields_tpu_torch.solvers import \
                const_sweep_table
            table = cyl._z_table(grid, mat, zbc, cs.P7_DT, f32, dev)
            row(torch, cs, out, "K13", label, (R, *vecs, table),
                lambda: const_sweep_z(R, *vecs, table))
            out[f"K13t {label} ms"] = cs.cuda_ms(
                torch, lambda: const_sweep_table(*vecs[:3]), 10)
        del R
        torch.cuda.empty_cache()


def k12_rows(torch, cs, dev, out):
    """K12 at phase 7's shapes, the spiral app's ring and 512-row r lines,
    with the step's table (where the checkout takes one) and given none;
    the addmm call at the annulus."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid, RobinBC
    from adi_thermal_fields_tpu_torch.solvers import const_sweep_strided
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl

    f32 = torch.float32
    takes_table = "table" in inspect.signature(
        const_sweep_strided).parameters
    ring = cs.CYCLIC_SHAPES[0]
    cases = [(label, shape, 5e-4, 0.02 if label.endswith("annular")
              else 0.0, cs.P7_DT) for label, shape in cs.P7_SHAPES]
    cases += [(ring[0], ring[1], ring[2], ring[3], 0.05),
              K12_LONG + (5e-4, 0.02, cs.P7_DT)]
    for label, shape, dr, r_inner, dt in cases:
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        _, mat, _, _ = cs.be_case(label, shape)
        key = (grid, mat, RobinBC(300.0, 20.0), None, dt, f32, dev)
        vecs = cyl._r_coefficients(*key)
        R = cs.random_field(torch, torch.ones(shape, dtype=torch.bool,
                                              device=dev), 23)
        row(torch, cs, out, "K12", f"{label} no table", (R, *vecs),
            lambda: const_sweep_strided(R, *vecs))
        if takes_table:
            table = cyl._r_table(*key)
            row(torch, cs, out, "K12", label, (R, *vecs, table),
                lambda: const_sweep_strided(R, *vecs, table))
        if label == cs.P7_SHAPES[0][0]:
            out["K12 addmm ms"] = cs.cuda_ms(
                torch, cs.dense_inverse_call(torch, vecs, 0, R), 10)
        del R
        torch.cuda.empty_cache()


def be_steps(torch, cs, dev, out):
    """Phase 7's unmasked steps at (128, 512, 512) float32."""
    from adi_thermal_fields_tpu_torch import adi_step_cylindrical

    label, shape = cs.P7_SHAPES[0]
    grid, mat, rob, zbc = cs.be_case(label, shape)
    T0 = cs.random_field(torch, torch.ones(shape, dtype=torch.bool,
                                           device=dev), 31)
    for scheme in ("be", "douglas"):
        timed_step(torch, out, f"unmasked {scheme} {label}",
                   lambda T, s=scheme: adi_step_cylindrical(
                       T, grid, mat, dt=cs.P7_DT, robin_outer=rob, zbc=zbc,
                       scheme=s, implementation="kernels"), T0)
    del T0
    torch.cuda.empty_cache()


def k15_rows(torch, cs, dev, out):
    """K15 at phase 8's tube and disk and the tube at 10x dt; K15y at
    512^3."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.solvers import vp2_sweep_strided
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    kt, ct = cs.varprop_tables()
    tube, disk = cs.P8_SHAPES[0][:2], cs.P8_SHAPES[1][:2]
    for name, (label, shape), dtm, with_rhs in (
            ("tube rhs is T", tube, 1.0, False), ("tube rhs", tube, 1.0, True),
            ("disk rhs is T", disk, 1.0, False),
            ("tube 10x dt rhs is T", tube, 10.0, False)):
        grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape,
                                                torch.float32, dev)
        R = cs.random_field(torch, mask, seed=43) if with_rhs else None
        code = cvp.build_cyl_vp2_plan(mask, grid, zbc)[0]
        cols = cvp._vp2_columns(grid, zbc, torch.float32, dev)
        f = np.float32
        inv = float(f(1.0) / f(f(dtm * cs.P8_DT) / f(mat.rho)))
        r, r_imh, r_iph = cvp._radii(grid)
        rk = dict(k_spec=kt, cp_spec=ct, h_lo=80.0, h_hi=80.0,
                  tinf_void=20.0, emissivity=cs.EMISSIVITY,
                  edge0=((50.0, r_imh[0] / (r[0] * grid.dr), 20.0)
                         if grid.is_annular else None),
                  edge1=(300.0, r_iph[-1] / (r[-1] * grid.dr), 20.0))
        rc = (cols["glo_r"], cols["ghi_r"], cols["gsl_r"], cols["gsh_r"])
        ins = (T, code) if R is None else (R, T, code)
        row(torch, cs, out, "K15", name, ins,
            lambda: vp2_sweep_strided(R, T, code, *rc, inv, **rk))
        del T, R, code, mask
        torch.cuda.empty_cache()
    k15y_row(torch, cs, dev, out)


def k15y_row(torch, cs, dev, out, record=None):
    """K15y at the 512^3 WAAM mask (radiative film); ``record`` (if given)
    takes its name, its output, its plain version's and its ms."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (build_vp2_code,
                                                      vp2_sweep_y,
                                                      vp2_sweep_y_plain)

    kt, ct = cs.varprop_tables()
    shape = (512,) * 3
    grid = CartesianGrid(*shape, 0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    sc = cs.vp_scalars(grid, mat, 2.0 * grid.dx ** 2 / mat.alpha)
    glo = float(torch.tensor(0.5 / grid.dy ** 2, dtype=torch.float32))
    gs = float(torch.tensor(1.0 / grid.dy, dtype=torch.float32))
    mask = cs.waam_mask(torch, shape, dev)
    T = cs.mushy_field(torch, mask, seed=7)
    R = cs.random_field(torch, mask, seed=13)
    code = build_vp2_code(mask, 1, edge_exposed=True)
    yk = dict(k_spec=kt, cp_spec=ct, h=cs.H_CONV, t_inf=20.0,
              emissivity=cs.EMISSIVITY)
    row(torch, cs, out, "K15y", "512^3 waam rad", (R, T, code),
        lambda: vp2_sweep_y(R, T, code, glo, gs, sc["inv_dtor"], **yk))
    if record is not None:
        args = (R, T, code, glo, gs, sc["inv_dtor"])
        record("K15y 512^3", vp2_sweep_y(*args, **yk),
               vp2_sweep_y_plain(*args, **yk),
               out["K15y 512^3 waam rad ms"])
        del args
    del T, R, code, mask
    torch.cuda.empty_cache()


def varprop_be_step(torch, cs, dev, out):
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
    timed_step(torch, out, f"varprop be {label}",
               lambda T: adi_step_cyl_varprop(
                   T, grid, mat, scheme="be", implementation="kernels",
                   vp2_plan=vp2_plan, **kw), T0)
    del T0, mask, vp2_plan
    torch.cuda.empty_cache()


def app_prints(torch, cs, dev, out):
    """The spiral app's clamp and varprop prints (float32, kernels)."""
    for name, extra in (("clamp", ["--void_mode", "clamp"]),
                        ("varprop", cs.P8_APP_FLAGS)):
        res = cs.spiral_app(torch, dev, 0, extra, impls=("kernels",))
        out[f"app {name} wall s"] = res["wall_kernels"]
        del res
        torch.cuda.empty_cache()


def measure(root, only):
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda", 0)
    out = dict(root=root)
    if only == "--pencils":
        k9_rows(torch, cs, dev, out)
    if only == "--k12":
        k12_rows(torch, cs, dev, out)
    if only in ("--pencils", "--k12"):
        k13_rows(torch, cs, dev, out)
    k14_rows(torch, cs, dev, out)
    if only == "--pencils":
        masked_step(torch, cs, dev, out)
    if only in ("--pencils", "--k12"):
        be_steps(torch, cs, dev, out)
    elif only is None:
        be_steps(torch, cs, dev, out)
        k15_rows(torch, cs, dev, out)
        varprop_be_step(torch, cs, dev, out)
        app_prints(torch, cs, dev, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out["card"] = smi.stdout.strip() or torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


def main():
    args = sys.argv[1:]
    only = args[0] if args[:1] in (["--k14"], ["--pencils"],
                                   ["--k12"]) else None
    args = args[only is not None:]
    if args[0] == "--measure":
        measure(os.path.abspath(args[1]), only)
        return
    other = os.path.abspath(args[0])
    for root in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               *([only] if only else []),
                               "--measure", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
