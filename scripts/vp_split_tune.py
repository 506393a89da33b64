#!/usr/bin/env python3
"""The varprop sweeps on the split-line core (K6, K7, K7x, K8 and its
general form "K8g", K19: csrc/varprop_sweeps.cu, csrc/vp2_sweep.cu,
csrc/varprop_z.cu, csrc/split_line.cuh) on one CUDA card: their register
and spill report, a check against the plain versions over odd shapes, and
their times; or (``--bins``) K8's general form's distance from its plain
version against the lines' stiffness.

    python3 scripts/vp_split_tune.py [--quick] [--kernels K6,K19]
                                     [--set NAME=VALUE ...]
                                     [--sub OLD=NEW ...]
    python3 scripts/vp_split_tune.py --bins 17,23,31,47,59:1,3,10
                                     [--set kK8Stiff=1e30 ...]

Prints one line per case.  Checks (float32 within 8 float32 ulp of the
output's scale, float64 within 1e-12 of it): lines of 1 to 12,000 rows,
K6, K7 and K7x with their eliminated rows kept in shared memory and past
their shared memory (reduced rows in global memory), K8 and K19 with
several lines a warp, one and several chunks a lane and past their staged
lines (the core's strided kernel), T through the mushy interval with cells
on the solidus and the liquidus; K7x against K20 -> K6 bit for bit.
Times: CUDA-event medians, float32, at chip_smoke.py's 256^3 and 512^3
WAAM masks (K19 also at 384^3; K6, K7x and K19 also at 512^3 float64), on
many short lines (8192x64x64) and on 8192-row lines, with the share of
3.35 TB/s under the byte models (float32: K6 29 B/cell, K7, K7x and K19
21 with the h stream, 17 with rob_c; K8 13).
``--kernels`` limits the run to the kernels named.
``--set kK8Lines=4`` (any ``constexpr`` of those sources) or ``--sub
clamp_sum_rn=clamp_sum`` (a text substitution, wherever OLD occurs in
them) measures a copy of the package under build/tune/ so changed;
``--quick`` skips the checks and times the 256^3, 384^3, 512^3 and
8192-row z lines alone.
``--bins SEEDS:DTS`` runs K8's general form alone, on chip_smoke.py phase
8's (64, 512, 1024) tube (float32) and (37, 203, 131) disk (float32 and
float64) with T over 1400-1500 C (the melt-pool k x4 above 1470) and the
rhs drawn from each seed, at each multiple of the step's dt, and prints
one JSON line per shape, seed and dt: the lines' largest stiffness ratio
(|a| + |c|) / (b - |a| - |c|) of the plain version's rows (a[0] and
c[n-1] dropped), the share of lines past kK8Stiff (solved again in Thomas
order at float32), the max |delta| from the plain version (K and float32
ulp of the output's scale), the CUDA-event median ms (first seed), and
per bin of the lines' largest ratio the count of lines, their largest
|delta| and the largest distances of the plain version and of the kernel
from the float64 solve of the same rows.  ``--set kK8Stiff=1e30`` splits
every line; ``--sub 'Chunk<T, M, false> ch;=Chunk<T, M, false, true> ch;'
--sub 'warp_reduced(ch.a[0]=warp_reduced<T, true>(ch.a[0]'`` takes
rounded divisions in the chunks and phase (b) in registers instead of the
hardware reciprocal.
"""
import contextlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adi_thermal_fields_tpu_torch"
SOURCES = ("vp2_sweep.cu", "varprop_sweeps.cu", "varprop_z.cu",
           "split_line.cuh")
KERNELS = ("K6", "K7", "K7x", "K8", "K8g", "K19")
# bins of a line's largest |a| + |c| over b - |a| - |c|
EDGES = (0, 1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, float("inf"))


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
            raise SystemExit(f"vp_split_tune: constant {name} found {hits} "
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
            raise SystemExit(f"vp_split_tune: {old} not in {SOURCES}")
    return root


def ptxas_report(build_library):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, secs = build_library(verbose=True)
    print(f"build: {secs:.1f} s", flush=True)
    for part in buf.getvalue().split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        if not any(k in name for k in ("vp2_sweep_z_kernel",
                                        "vp2_sweep_z_general_kernel",
                                        "staged_replay_kernel",
                                        "vp_sweep_z_kernel",
                                        "split_strided_kernel",
                                        "sweep_strided_kernel")):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        print(f"ptxas {name[:100]}: {regs.group(1) if regs else '?'} regs, "
              f"spills {spill.groups() if spill else '?'}", flush=True)


def measure(root, quick, kernels):
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.kernels.build import build_library
    from adi_thermal_fields_tpu_torch.solvers import (
        varprop_fields_plain, varprop_sweep_x, varprop_sweep_x_plain,
        varprop_sweep_y, varprop_sweep_y_plain, varprop_sweep_z,
        varprop_sweep_z_plain, varprop_theta_rhs, varprop_theta_sweep,
        varprop_theta_sweep_plain, build_vp2_code, vp2_sweep_z,
        vp2_sweep_z_plain)
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_varprop_codes)

    if not torch.cuda.is_available():
        raise SystemExit("vp_split_tune: no CUDA card")
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(0)}; package {root}",
          flush=True)
    ptxas_report(build_library)
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = cs.varprop_tables()

    def case(shape, seed, dtype, waam=False):
        """(name, B/cell, kernel, plain) of each kernel on ``shape`` at
        ``dtype``."""
        if waam:
            mask = cs.waam_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(seed)
            mask = torch.rand(shape, generator=g, device=dev) > 0.2
        T = cs.mushy_field(torch, mask, seed).to(dtype)
        R = cs.random_field(torch, mask, seed + 1).to(dtype)
        grid = CartesianGrid(*shape, 0.5e-3)
        sc = cs.vp_scalars(grid, mat, 2.0 * grid.dx ** 2 / mat.alpha)
        codes = build_varprop_codes(mask)
        fc, w, h = varprop_fields_plain(T, mask.to(torch.uint8), k_spec=kt,
                                        cp_spec=ct, rho=mat.rho,
                                        rad=(cs.EMISSIVITY, 20.0, cs.H_CONV))
        yk = (R, codes[1], fc[1], w, sc["tg"][1], sc["sk"][1], 20.0)
        zk = (R, T, codes[2], sc["glo"], sc["gs"], sc["inv_dtor"])
        zkw = dict(k_spec=kt, cp_spec=ct, h=cs.H_CONV, t_inf=20.0)
        # K8's general form: distinct per-row columns, both edge films
        n = shape[2]
        gcol = (lambda v: v * (1.0 + 0.2 * torch.rand(
            n, generator=torch.Generator(device=dev).manual_seed(seed + n),
            device=dev)).to(dtype))
        zg = (R, T, build_vp2_code(mask, 2), gcol(sc["glo"]), gcol(sc["gs"]),
              sc["inv_dtor"])
        zgw = dict(k_spec=kt, cp_spec=ct, ghi=gcol(sc["glo"]),
                   gsh=gcol(sc["gs"]), h=cs.H_CONV, h_hi=2.0 * cs.H_CONV,
                   t_inf=20.0, emissivity=cs.EMISSIVITY,
                   edge0=(300.0, sc["gs"], 30.0),
                   edge1=(400.0, sc["gs"], 15.0))
        th = (T, codes[0], *fc, w, sc["cw"], sc["inv_d2"], sc["tg"][0],
              sc["sk"][0], 20.0)
        src = torch.where(mask, 1e8 * torch.rand(shape, device=dev),
                          0.0).to(dtype)
        sk = dict(rob_c=30.0, src=src, dt=sc["dt"])
        xk = (R, codes[0], fc[0], w, sc["tg"][0], sc["sk"][0], 20.0)
        z19 = (R, codes[3], fc[2], w, sc["tg"][2], sc["sk"][2], 20.0)
        return [
            ("K6 x h", 29, lambda: varprop_theta_sweep(*th, h=h),
             lambda: varprop_theta_sweep_plain(*th, h=h)),
            ("K6 x rob_c+src", 29, lambda: varprop_theta_sweep(*th, **sk),
             lambda: varprop_theta_sweep_plain(*th, **sk)),
            ("K7x x h", 21, lambda: varprop_sweep_x(*xk, h=h),
             lambda: varprop_sweep_x_plain(*xk, h=h)),
            ("K7x x R0 rob_c+src", 0, lambda: varprop_sweep_x(
                varprop_theta_rhs(T, *fc, w, mask.to(torch.uint8),
                                  sc["cw"], sc["inv_d2"], src=src,
                                  dt=sc["dt"]), *xk[1:], rob_c=30.0),
             lambda: varprop_theta_sweep(*th, **sk)),
            ("K19 z h", 21, lambda: varprop_sweep_z(*z19, h=h),
             lambda: varprop_sweep_z_plain(*z19, h=h)),
            ("K19 z rob_c", 17, lambda: varprop_sweep_z(*z19, rob_c=30.0),
             lambda: varprop_sweep_z_plain(*z19, rob_c=30.0)),
            ("K7 y h", 21, lambda: varprop_sweep_y(*yk, h=h),
             lambda: varprop_sweep_y_plain(*yk, h=h)),
            ("K7 y rob_c", 17, lambda: varprop_sweep_y(*yk, rob_c=30.0),
             lambda: varprop_sweep_y_plain(*yk, rob_c=30.0)),
            ("K8 z rad", 13,
             lambda: vp2_sweep_z(*zk, emissivity=cs.EMISSIVITY, **zkw),
             lambda: vp2_sweep_z_plain(*zk, emissivity=cs.EMISSIVITY,
                                       **zkw)),
            ("K8 z conv", 13, lambda: vp2_sweep_z(*zk, **zkw),
             lambda: vp2_sweep_z_plain(*zk, **zkw)),
            ("K8g z general", 13, lambda: vp2_sweep_z(*zg, **zgw),
             lambda: vp2_sweep_z_plain(*zg, **zgw)),
        ]

    def runs(name, which):
        kname = name.split()[0]
        return kname in which.split() and kname in kernels

    # (shape, which kernels): K6, K7x solve along axis 0, K7 along axis 1,
    # K8 and K19 along axis 2
    checks = [((37, 45, 70), "K6 K7 K7x K8 K8g K19"),
              ((3, 1, 1), "K6 K7 K7x K8 K8g K19"),
              ((2, 3, 33), "K6 K7 K7x K8 K8g K19"),
              ((4, 7, 256), "K8 K8g K19"), ((4, 7, 257), "K8 K8g K19"),
              ((3, 5, 513), "K8 K8g K19"), ((2, 3, 1030), "K8 K8g K19"),
              ((2, 3, 8192), "K8 K8g K19"), ((1, 3, 12000), "K8 K8g K19"),
              ((3, 200, 37), "K7"), ((3, 500, 37), "K7"),
              ((5, 1100, 7), "K7"), ((5, 2200, 7), "K7"),
              ((2, 4500, 9), "K7"), ((1, 8192, 40), "K7"),
              ((200, 3, 37), "K6 K7x"), ((500, 3, 37), "K6 K7x"),
              ((1100, 5, 7), "K6 K7x"), ((2200, 5, 7), "K6 K7x"),
              ((4500, 2, 9), "K6 K7x"), ((8192, 1, 40), "K6 K7x")]
    worst = {}
    for shape, which in ([] if quick else checks):
        for dtype in (torch.float32, torch.float64):
            for name, _, kern, plain in case(shape, 3, dtype):
                if not runs(name, which):
                    continue
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                scale = max(1.0, float(want.abs().max()))
                ulps = err / (torch.finfo(dtype).eps * scale)
                bad = (ulps > 8.0 if dtype == torch.float32
                       else err > 1e-12 * scale)
                if "R0" in name:          # K20 -> K7x against K6: bitwise
                    bad = not bool(torch.equal(got, want))
                key = (name, str(dtype)[6:])
                worst[key] = max(worst.get(key, 0.0), ulps)
                if bad or not bool(torch.isfinite(got).all()):
                    print(f"FAIL {name} {shape} {str(dtype)[6:]}: "
                          f"{ulps:.3f} ulp of scale", flush=True)
    print("check done: worst " + ", ".join(
        f"{n} {d} {u:.3f}" for (n, d), u in sorted(worst.items()))
          + " ulp of scale", flush=True)

    f32, f64 = torch.float32, torch.float64
    timed = (("256^3 waam", (256,) * 3, True, "K6 K7 K7x K8 K19", f32),
             ("384^3 waam", (384,) * 3, True, "K19", f32),
             ("512^3 waam", (512,) * 3, True, "K6 K7 K7x K8 K8g K19", f32),
             ("512^3 waam f64", (512,) * 3, True, "K6 K7x K19", f64),
             ("64x64x8192", (64, 64, 8192), False, "K8 K8g K19", f32),
             ("8192x64x64", (8192, 64, 64), False, "K6 K7 K7x K8 K19", f32),
             ("64x8192x64", (64, 8192, 64), False, "K7", f32))
    for label, shape, waam, which, dtype in (timed[:5] if quick
                                             else timed):
        rows = case(shape, 5, dtype, waam)
        cells = math.prod(shape)
        for name, bpc4, kern, _ in rows:
            if not runs(name, which) or not bpc4:
                continue
            # the byte model at float32, each field's bytes at dtype
            bpc = bpc4 // 4 * torch.finfo(dtype).bits // 8 + bpc4 % 4
            ms = cs.cuda_ms(torch, kern, 20)
            pct = 100.0 * cells * bpc / (ms * 1e-3) / cs.HBM_BYTES_PER_S
            print(f"{name} {label}: {ms:.4f} ms, {pct:.1f}% of its {bpc} "
                  "B/cell bound", flush=True)
        del rows
        torch.cuda.empty_cache()


def line_max(t):
    """The largest value of each line (the last axis) of ``t``."""
    return t.amax(dim=-1).reshape(-1)


def bins(root, seeds, dts):
    """K8's general form against its plain version, line by line, binned
    by the lines' stiffness (module docstring)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adi_thermal_fields_tpu_torch.bc.faces import shift_in
    from adi_thermal_fields_tpu_torch.kernels.build import build_library
    from adi_thermal_fields_tpu_torch.solvers import (thomas, vp2_sweep_z,
                                                      vp2_sweep_z_plain)
    from adi_thermal_fields_tpu_torch.solvers.vp2 import (_faces_hi,
                                                          _open_films,
                                                          _scaled_rows)
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    dev = torch.device("cuda", 0)
    _, secs = build_library()
    print(f"card: {torch.cuda.get_device_name(0)}; package {root}; library "
          f"build {secs:.1f} s", flush=True)
    stiff = float(re.search(r"constexpr double kK8Stiff = ([^;]+);", open(
        os.path.join(root, PKG, "csrc", "vp2_sweep.cu")).read()).group(1))
    kt, ct = cs.varprop_tables()
    for label, shape, prec in cs.P8_SHAPES:
        dtype = getattr(torch, prec)
        f = getattr(np, prec)
        grid, mat, mask, zbc, _ = cs.cylvp_case(torch, label, shape, dtype,
                                                dev)
        code = cvp.build_cyl_vp2_plan(mask, grid, zbc)[2]
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        glo, gs = cols["geo_z"], cols["gs_z"]
        films = dict(h=80.0, h_hi=200.0, t_inf=20.0,
                     emissivity=cs.EMISSIVITY,
                     edge1=(400.0, 1.0 / grid.dz, 20.0))
        for seed in seeds:
            g = torch.Generator(device=dev).manual_seed(seed)
            T = torch.where(mask, 1400.0 + 100.0 * torch.rand(
                shape, generator=g, device=dev), 20.0)
            T.view(-1)[seed::97] = cs.SOLIDUS
            T.view(-1)[31 + seed::101] = cs.LIQUIDUS
            T = T.to(dtype)
            R = cs.random_field(torch, mask, seed + 1).to(dtype)
            for dtm in dts:
                inv = float(f(1.0) / f(f(dtm * cs.P8_DT) / f(mat.rho)))
                args = (R, T, code, glo, gs, inv)
                kw = dict(k_spec=kt, cp_spec=ct, ghi=glo, gsh=gs, **films)
                fn = (lambda: vp2_sweep_z(*args, **kw))
                got = fn()
                want = vp2_sweep_z_plain(*args, **kw)
                # the plain version's rows
                fhi = _faces_hi(T, code, kt, 2)
                sink, srhs = _open_films(
                    T, code, gs, gs, 2, films["h"], films["h_hi"],
                    films["t_inf"], films["emissivity"], None,
                    films["edge1"])
                a, b, c, d = _scaled_rows(
                    R, T, ct, inv, glo * shift_in(fhi, 2, -1, fill=0.0),
                    glo * fhi, sink, srhs)
                a[..., 0] = 0.0
                c[..., -1] = 0.0
                off = a.abs() + c.abs()
                ratio = line_max((off / (b - off)).double())
                mv = (lambda t: t.double().movedim(2, 0))
                exact = thomas(mv(a), mv(b), mv(c), mv(d)).movedim(0, 2)
                torch.cuda.synchronize()
                err = line_max((got - want).abs().double())
                e_plain = line_max((want.double() - exact).abs())
                e_kern = line_max((got.double() - exact).abs())
                ulp = torch.finfo(torch.float32).eps * float(
                    want.abs().max())
                rows = []
                for lo, hi in zip(EDGES[:-1], EDGES[1:]):
                    sel = (ratio >= lo) & (ratio < hi)
                    if bool(sel.any()):
                        rows.append(dict(
                            ratio=[lo, hi], lines=int(sel.sum()),
                            err=float(err[sel].max()),
                            err_ulp=float(err[sel].max()) / ulp,
                            plain_vs_exact=float(e_plain[sel].max()),
                            kernel_vs_exact=float(e_kern[sel].max())))
                rec = dict(
                    kernel="K8g", shape=label, dtype=prec, seed=seed,
                    dt_multiple=dtm, max_ratio=float(ratio.max()),
                    replayed=(float((ratio > stiff).double().mean())
                              if dtype == torch.float32 else 0.0),
                    max_abs_err=float(err.max()),
                    err_ulp=float(err.max()) / ulp,
                    ms=cs.cuda_ms(torch, fn, 20) if seed == seeds[0]
                    else None, bins=rows)
                print(json.dumps(rec), flush=True)
                del got, want, a, b, c, d, exact, fhi, sink, srhs
            del T, R
            torch.cuda.empty_cache()


def main():
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        measure(args[1], args[2] == "--quick", args[3].split(","))
        return
    if args[:1] == ["--bins-run"]:
        seeds, dts = args[2].split(":")
        bins(args[1], [int(v) for v in seeds.split(",")],
             [float(v) for v in dts.split(",")])
        return
    quick = "--quick" in args
    args = [a for a in args if a != "--quick"]
    sets, subs, kernels, binspec = [], [], ",".join(KERNELS), None
    for flag, value in zip(args[::2], args[1::2]):
        if flag == "--kernels":
            kernels = value
        elif flag == "--bins":
            binspec = value
        else:
            (sets if flag == "--set" else subs).append(value)
    root = patched_copy(sets, subs) if sets or subs else HERE
    cmd = ([sys.executable, os.path.abspath(__file__), "--bins-run", root,
            binspec] if binspec else
           [sys.executable, os.path.abspath(__file__), "--measure", root,
            "--quick" if quick else "--full", kernels])
    sys.exit(subprocess.run(cmd).returncode)


if __name__ == "__main__":
    main()
