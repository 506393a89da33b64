#!/usr/bin/env python3
"""The periodic phi sweeps K11, K16, K18 and K22 (csrc/split_cyclic.cuh,
the split-line core with Sherman-Morrison) on one CUDA card: their build
time and register and spill report, their error against their plain
versions block by block against each block's stiffness, and their time.

    python3 scripts/cyclic_tune.py [--build-report] [--seeds 17,23]
                                   [--dts 1,2.5] [--kernels K18,K22]
                                   [--set NAME=VALUE ...]
                                   [--sub OLD=NEW ...]

A block (one ring b1, 32 adjacent lines b2) with a row past |a| + |c| >
ratio (b - |a| - |c|) is solved in Thomas order, bit for bit the plain
version, where ratio is the row former's constant (kK11Stiff in
csrc/masked.cu, kK16Stiff in csrc/vp2_cyl.cu, kCyclicFieldStiff in
csrc/field_rows.cuh for K18 and K22).
``--set kK16Stiff=1e30`` (any ``constexpr`` of csrc/split_cyclic.cuh,
masked.cu, vp2_cyl.cu, fields.cu, vp_fields.cu, field_rows.cuh and
common.cuh) splits every block, ``-1`` replays every block; ``--sub
'chain_bytes<C>(W, R, M)=(limit + 1)'`` (a text substitution in those
sources, OLD free of '=') takes the one-warp replay where the chain would
fit.  Either measures a copy of the package under build/tune/ so
changed.  ``--kernels`` measures those kernels alone.

Prints (``--build-report``) the nvcc time of csrc/masked.cu,
csrc/vp2_cyl.cu, csrc/fields.cu and csrc/vp_fields.cu each compiled
alone, with the registers and spills of each split_cyclic_kernel, then,
for each kernel, shape, seed (of the right-hand side, of T and of a
disk's mask) and time step (a multiple of chip_smoke.py's), one JSON
line: max |delta| from the plain version (K and float32 ulp of the
output's scale), the CUDA-event median ms over 20 calls (first seed
only), the share of blocks past the measured copy's ratio (K18 and
K22), and per bin of the blocks' largest ratio the count of blocks,
their largest |delta| from the plain version, and the largest distances
of the plain version and of the kernel from the float64 solve of the
same rows (``cyclic_thomas`` on the rows cast to float64: what each
solve's own rounding costs).  Shapes: chip_smoke.py phase 6's (64, 512,
1024) tube and (37, 203, 131) disk for K11, phase 8's tube and disk
(float32; float64 for K16) for K16, CYCLIC_SHAPES' spiral-app ring and
stiff 4096-row lines, for K11 tests/test_torch_cuda.py's (37, 45, 70)
disk and for K16 disks of 256 and 512 phi cells; for K18, and K22 on the
same rows materialized (chip_smoke.py ``k18_rows``), phase 8's tube and
disk (float32 and float64) from chip_smoke.py's streams and the rows of
the tube's own Douglas step (theta*dw, taken from one step of
adi_step_cyl_varprop at the time step), and K22 alone on phase 9's
384^3 systems (first time step only).
"""
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adi_thermal_fields_tpu_torch"
SOURCES = ("split_cyclic.cuh", "masked.cu", "vp2_cyl.cu", "fields.cu",
           "vp_fields.cu", "field_rows.cuh", "common.cuh")
KERNELS = ("K11", "K16", "K18", "K22")
# bins of a block's largest |a| + |c| over b - |a| - |c|
EDGES = (0, 1, 2, 4, 8, 12, 16, 20, 25, 30, 40, 60, 100, 200, 1000,
         float("inf"))


def patched_copy(sets, subs):
    """A copy of the package under build/tune/ with the constants set and
    the substitutions made."""
    tag = "_".join(re.sub(r"\W", "", s) for s in sets + subs)[:80]
    root = os.path.join(HERE, "build", "tune", tag)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(root, PKG, "csrc")
    for s in sets:
        name, value = s.split("=")
        hits = 0
        for src in SOURCES:
            path = os.path.join(csrc, src)
            text, n = re.subn(
                rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};",
                open(path).read())
            open(path, "w").write(text)
            hits += n
        if hits != 1:
            raise SystemExit(f"cyclic_tune: constant {name} found {hits} "
                             "times")
    for s in subs:
        old, new = s.split("=", 1)
        hits = 0
        for src in SOURCES:
            path = os.path.join(csrc, src)
            text = open(path).read()
            hits += text.count(old)
            open(path, "w").write(text.replace(old, new))
        if hits == 0:
            raise SystemExit(f"cyclic_tune: {old} not in {SOURCES}")
    return root


def build_report(root):
    """nvcc of K11's, K16's, K22's and K18's sources, each alone, timed;
    the registers and spills of each periodic split kernel."""
    from adi_thermal_fields_tpu_torch.kernels.build import (NVCC_FLAGS,
                                                            find_nvcc)
    csrc = os.path.join(root, PKG, "csrc")
    work = os.path.join(root, "build", "tune_obj")
    os.makedirs(work, exist_ok=True)
    for src in ("masked.cu", "vp2_cyl.cu", "fields.cu", "vp_fields.cu"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", csrc, "-c",
             "-o", os.path.join(work, src + ".o"), os.path.join(csrc, src)],
            capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(proc.stdout + proc.stderr)
        kernels = 0
        for part in (proc.stdout + proc.stderr).split(
                "Compiling entry function")[1:]:
            name = part.split("'")[1]
            if "split_cyclic_kernel" not in name:
                continue
            kernels += 1
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
            print(f"ptxas {name[:110]}: {regs.group(1) if regs else '?'} "
                  f"regs, spills {spill.groups() if spill else '?'}",
                  flush=True)
        print(f"nvcc {src} alone: {secs:.1f} s, {kernels} split_cyclic_kernel"
              f" instantiations", flush=True)


def block_max(t):
    """(B1, n, B2) -> (B1, ceil(B2 / 32)): the largest value of each
    block of 32 lines."""
    import torch
    m = t.amax(dim=1)
    B1, B2 = m.shape
    groups = -(-B2 // 32)
    m = torch.nn.functional.pad(m, (0, groups * 32 - B2))
    return m.reshape(B1, groups, 32).amax(dim=2)


def step_call_args(module, name, step):
    """The positional arguments of the first call of ``module.name`` that
    ``step()`` makes (the call still runs)."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        step()
    finally:
        setattr(module, name, real)
    return seen[0]


def phase8_step_kw(cs, mask, zbc, dt):
    """chip_smoke.py phase 8's step keywords at time step ``dt``."""
    from adi_thermal_fields_tpu_torch import RobinBC
    kt, ct = cs.varprop_tables()
    return dict(dt=dt, robin_outer=RobinBC(300.0, 20.0), zbc=zbc,
                robin_inner=RobinBC(50.0, 20.0), active=mask, h_void=80.0,
                T_inf_void=20.0, h_front=200.0, k_table=kt, cp_table=ct,
                emissivity=cs.EMISSIVITY)


def douglas_phi_args(cs, cvp, grid, mat, T, kw, plan):
    """(rhs, flo, dw, sink, srhs, geo): K18's arguments in one Douglas
    step of the ``kernels`` tier from T (its rows carry theta*dw)."""
    return step_call_args(cvp, "vp_fields_cyclic_phi", lambda: (
        cvp.adi_step_cyl_varprop(T, grid, mat, scheme="douglas",
                                 implementation="kernels", vp2_plan=plan,
                                 **kw)))


def stiff_ratio(root):
    """kCyclicFieldStiff of ``root``'s csrc/field_rows.cuh, or None where
    the checkout has none."""
    path = os.path.join(root, PKG, "csrc", "field_rows.cuh")
    hit = re.search(r"constexpr double kCyclicFieldStiff = ([^;]+);",
                    open(path).read()) if os.path.exists(path) else None
    return float(hit.group(1)) if hit else None


def measure(root, seeds, dts, with_report, kernels):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adi_thermal_fields_tpu_torch import CylindricalGrid, Material
    from adi_thermal_fields_tpu_torch.kernels.build import build_library
    from adi_thermal_fields_tpu_torch.solvers import (
        cyclic_fields, cyclic_fields_plain, cyclic_thomas,
        masked_cyclic_phi, masked_cyclic_phi_plain, vp2_cyclic_phi,
        vp2_cyclic_phi_plain, vp_fields_cyclic_phi,
        vp_fields_cyclic_phi_plain)
    from adi_thermal_fields_tpu_torch.solvers.varprop import eval_spec, harm
    from adi_thermal_fields_tpu_torch.solvers.vp2 import _rad, _scaled_rows
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    if not torch.cuda.is_available():
        raise SystemExit("cyclic_tune: no CUDA card")
    dev = torch.device("cuda", 0)
    if with_report:
        build_report(root)
    _, secs = build_library()
    print(f"library build: {secs:.1f} s", flush=True)

    def report(kname, label, seed, dtm, fn, plain, rows, timed,
               replay_ratio=None):
        got, want = fn(), plain()
        mv = (lambda t: t.double().movedim(1, 0))
        exact = cyclic_thomas(*(mv(t) for t in rows)).movedim(0, 1)
        torch.cuda.synchronize()
        a, b, c, _ = rows
        off = a.abs() + c.abs()
        ratio = block_max((off / (b - off)).double())
        err = block_max((got - want).abs().double())
        e_plain = block_max((want.double() - exact).abs())
        e_kern = block_max((got.double() - exact).abs())
        ulp = torch.finfo(torch.float32).eps * float(want.abs().max())
        bins = []
        for lo, hi in zip(EDGES[:-1], EDGES[1:]):
            sel = (ratio >= lo) & (ratio < hi)
            if bool(sel.any()):
                bins.append(dict(
                    ratio=[lo, hi], blocks=int(sel.sum()),
                    err=float(err[sel].max()),
                    err_ulp=float(err[sel].max()) / ulp,
                    plain_vs_exact=float(e_plain[sel].max()),
                    kernel_vs_exact=float(e_kern[sel].max())))
        replayed = None
        if replay_ratio is not None:
            replayed = float((ratio > replay_ratio).double().mean())
        rec = dict(kernel=kname, shape=label, seed=seed, dt_multiple=dtm,
                   max_abs_err=float(err.max()),
                   err_ulp=float(err.max()) / ulp,
                   ms=cs.cuda_ms(torch, fn, 20) if timed else None,
                   replayed_share=replayed, bins=bins)
        print(json.dumps(rec), flush=True)

    f32, f64 = torch.float32, torch.float64
    mat = Material(7800.0, 490.0, 54.0)
    k11_cases = [(label, shape, 5e-4, 0.02 if label.endswith("tube")
                  else 0.0, cs.CYL_DT) for label, shape in cs.CYL_SHAPES]
    k11_cases += [(label, shape, dr, ri, cs.CYL_DT)
                  for label, shape, dr, ri in (cs.CYCLIC_SHAPES[0],
                                               cs.CYCLIC_SHAPES[2])]
    k11_cases.append(("37x45x70 disk, dt 0.05 s", (37, 45, 70), 5e-4, 0.0,
                      0.05))
    if "K11" not in kernels:
        k11_cases = []
    for label, shape, dr, r_inner, dt0 in k11_cases:
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        for si, seed in enumerate(seeds):
            if label.endswith("tube"):
                mask = cs.tube_mask(torch, shape, dev)
            else:
                g = torch.Generator(device=dev).manual_seed(seed + 12)
                mask = torch.rand(shape, generator=g, device=dev) > 0.25
            plan = cs.cyl_plan(torch, grid, mask, "dirichlet")
            R = cs.random_field(torch, mask, seed=seed)
            code, sink, srhs, geo = plan.phi
            for di, dtm in enumerate(dts):
                fac = float(torch.tensor(dt0 * dtm, dtype=f32)
                            * torch.tensor(mat.alpha, dtype=f32))
                a = torch.where((code & 1) != 0, -fac * geo[:, None, :], 0.0)
                c = torch.where((code & 2) != 0, -fac * geo[:, None, :], 0.0)
                d = torch.where((code & 4) != 0, srhs, torch.where(
                    (code & 8) != 0, R + fac * srhs, 20.0))
                report("K11", label, seed, dtm,
                       lambda: masked_cyclic_phi(R, *plan.phi, fac, 20.0),
                       lambda: masked_cyclic_phi_plain(R, *plan.phi, fac,
                                                       20.0),
                       (a, 1.0 - (a + c) + fac * sink, c, d),
                       si == 0 and di == 0)
                del a, c, d
            del R, plan
            torch.cuda.empty_cache()

    kt, ct = cs.varprop_tables()
    pk = dict(k_spec=kt, cp_spec=ct, h_void=80.0, tinf_void=20.0,
              emissivity=cs.EMISSIVITY)
    k16_cases = [(label, shape, prec, 5e-4, None)
                 for label, shape, prec in cs.P8_SHAPES]
    k16_cases += [(label, shape, "float32", dr, ri)
                  for label, shape, dr, ri in (cs.CYCLIC_SHAPES[0],
                                               cs.CYCLIC_SHAPES[2])]
    k16_cases += [("37x256x131 disk", (37, 256, 131), "float32", 5e-4, None),
                  ("37x512x64 disk", (37, 512, 64), "float32", 5e-4, None)]
    if "K16" not in kernels:
        k16_cases = []
    for label, shape, prec, dr, r_inner in k16_cases:
        dtype = getattr(torch, prec)
        f = getattr(np, prec)
        grid, mat, mask, zbc, _ = cs.cylvp_case(torch, label, shape, dtype,
                                                dev, dr, r_inner)
        code = cvp.build_cyl_vp2_plan(mask, grid, zbc)[1]
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        geo, gs = cols["geo_p"][:, None, None], cols["gs_p"][:, None, None]
        bit = (lambda b: ((code & b) != 0).to(dtype))
        for si, seed in enumerate(seeds):
            g = torch.Generator(device=dev).manual_seed(seed + 24)
            T = torch.where(mask, 1400.0 + 100.0 * torch.rand(
                shape, generator=g, device=dev), 20.0)
            T.view(-1)[::97] = cs.SOLIDUS
            T.view(-1)[31::101] = cs.LIQUIDUS
            T = T.to(dtype)
            R = cs.random_field(torch, mask, seed=seed + 26).to(dtype)
            k = eval_spec(kt, T)
            flo = harm(torch.roll(k, 1, 1), k) * bit(16)
            fhi = harm(k, torch.roll(k, -1, 1)) * bit(1)
            sink = (bit(2) + bit(4)) * gs * (80.0 + _rad(T, cs.EMISSIVITY,
                                                         20.0))
            for di, dtm in enumerate(dts):
                inv = float(f(1.0) / f(f(cs.P8_DT * dtm) / f(mat.rho)))
                rows = _scaled_rows(R, T, ct, inv, geo * flo, geo * fhi,
                                    sink, sink * 20.0)
                args = (R, T, code, cols["geo_p"], cols["gs_p"], inv)
                report("K16", f"{label} {prec}", seed, dtm,
                       lambda: vp2_cyclic_phi(*args, **pk),
                       lambda: vp2_cyclic_phi_plain(*args, **pk), rows,
                       si == 0 and di == 0)
                del rows, args
            del R, T, k, flo, fhi, sink
            torch.cuda.empty_cache()

    # K18 and K22 on its rows materialized (the fields tier's): phase 8's
    # streams at each time step and the tube's own Douglas step rows; K22
    # alone on phase 9's 384^3 systems
    ratio = stiff_ratio(root)

    def field_pair(label, seed, dtm, sp, geo, timed):
        ap = cs.k18_rows(torch, sp, geo)
        if "K18" in kernels:
            report("K18", label, seed, dtm,
                   lambda: vp_fields_cyclic_phi(*sp, geo),
                   lambda: vp_fields_cyclic_phi_plain(*sp, geo), ap, timed,
                   ratio)
        if "K22" in kernels:
            report("K22", f"{label}, fields tier rows", seed, dtm,
                   lambda: cyclic_fields(*ap, 1),
                   lambda: cyclic_fields_plain(*ap, 1), ap, timed, ratio)
        del ap

    k18_cases = list(cs.P8_SHAPES) if {"K18", "K22"} & set(kernels) else []
    for label, shape, prec in k18_cases:
        dtype = getattr(torch, prec)
        grid, mat, mask, zbc, _ = cs.cylvp_case(torch, label, shape, dtype,
                                                dev)
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        douglas = label.endswith("tube") and prec == "float32"
        plan = cvp.build_cyl_vp2_plan(mask, grid, zbc) if douglas else None
        for si, seed in enumerate(seeds):
            g = torch.Generator(device=dev).manual_seed(seed + 24)
            T = torch.where(mask, 1400.0 + 100.0 * torch.rand(
                shape, generator=g, device=dev), 20.0)
            T.view(-1)[::97] = cs.SOLIDUS
            T.view(-1)[31::101] = cs.LIQUIDUS
            T = T.to(dtype)
            R = cs.random_field(torch, mask, seed=seed + 26).to(dtype)
            flo = cvp._face_phi(kt(T), mask)
            for dtm in dts:
                sr, _ = cs.k17_streams(torch, grid, mat, mask, T, R,
                                       cs.P8_DT * dtm, seed=seed + 47)
                field_pair(f"{label} {prec}", seed, dtm, (R, flo, *sr[2:]),
                           cols["geo_p"], si == 0)
                del sr
                if douglas:
                    args = douglas_phi_args(
                        cs, cvp, grid, mat, T,
                        phase8_step_kw(cs, mask, zbc, cs.P8_DT * dtm), plan)
                    field_pair(f"{label} Douglas step rows", seed, dtm,
                               args[:5], args[5], si == 0)
                    del args
                torch.cuda.empty_cache()
            del T, R, flo
            torch.cuda.empty_cache()
    if "K22" in kernels:
        label, shape, prec = cs.P9_SHAPES[0]
        for si, seed in enumerate(seeds):
            abcd = cs.field_systems(torch, shape, getattr(torch, prec), dev,
                                    seed)
            report("K22", f"{label} {prec}", seed, 1.0,
                   lambda: cyclic_fields(*abcd, 1),
                   lambda: cyclic_fields_plain(*abcd, 1), abcd, si == 0,
                   ratio)
            del abcd
            torch.cuda.empty_cache()
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        measure(args[1], [int(s) for s in args[2].split(",")],
                [float(d) for d in args[3].split(",")], args[4] == "1",
                args[5].split(","))
        return
    report = "--build-report" in args
    args = [a for a in args if a != "--build-report"]
    seeds, dts, kernels, sets, subs = "17", "1", ",".join(KERNELS), [], []
    for flag, value in zip(args[::2], args[1::2]):
        if flag == "--seeds":
            seeds = value
        elif flag == "--dts":
            dts = value
        elif flag == "--kernels":
            kernels = value
        elif flag == "--set":
            sets.append(value)
        else:
            subs.append(value)
    root = patched_copy(sets, subs) if sets or subs else HERE
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--measure", root, seeds, dts, str(int(report)),
                           kernels])
    sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
