#!/usr/bin/env python3
"""The open split-line sweeps K21 (a/b/c/d fields), K17 (five streams),
K10 (masked-Robin z) and the g-stream sweeps K24 (theta + x), K25 (y) and
K26 (z) on one CUDA card: their build time and register and spill report,
their error against their plain versions block by block against each
block's stiffness, and their time.  The open-line twin of
scripts/cyclic_tune.py.

    python3 scripts/open_tune.py [--build-report] [--seeds 17,23]
                                 [--dts 1,10] [--kernels K10,K26]
                                 [--set NAME=VALUE ...] [--sub OLD=NEW ...]

A block of lines with a row past (|a| + |c|) > ratio (b - |a| - |c|) is
solved in Thomas order, bit for bit the plain version, where ratio is
kOpenStiff of csrc/field_rows.cuh (K17, K21), kK10Stiff of csrc/masked.cu
(K10) or kK24Stiff (K24) and kK26Stiff (K25, K26) of csrc/gstreams.cu;
``--set kOpenStiff=1e30`` or ``--set kK10Stiff=1e30`` (any ``constexpr``
of csrc/field_rows.cuh,
csrc/split_staged.cuh, csrc/split_line.cuh, csrc/masked.cu and
csrc/gstreams.cu) splits every block; ``--sub OLD=NEW`` makes a text
substitution in those sources (OLD free of '='); either is measured in a
copy of the package under build/tune/.  ``--kernels`` (default all six)
picks the kernels measured.

Prints (``--build-report``) the nvcc time of csrc/fields.cu and
csrc/vp_fields.cu each compiled alone, with the registers and spills of
each split-line kernel in them, then, for each kernel, entry, shape,
seed and time step (a multiple of chip_smoke.py's P8_DT), one JSON line:
max |delta| from the plain version (K and float32 ulp of the output's
scale), the CUDA-event median ms over 20 calls (first seed and step
only), and per bin of the blocks' largest ratio (|a| + |c|) / (b - |a| -
|c|) (a block: 32 adjacent lines) the count of blocks, their largest
|delta| from the plain version, and the largest distances of the plain
version and of the kernel from the float64 solve of the same rows
(``thomas`` on the rows cast to float64: what each solve's own rounding
costs).  Inputs: chip_smoke.py phase 8's K17 streams on the (64, 512,
1024) tube and the (37, 203, 131) disk (float32; the disk also float64),
built from T as the stream tier builds them, at the given multiples of
the step's dt, K17 along r and z (natural) and K21 on the same rows (the
``fields`` tier's); phase 9's K21 systems at 384^3 and 97x203x131 along
x, y and z; and the spiral app's ring of chip_smoke.py phase 8 ((32, 720,
200) at 0.25 mm, r_inner 52 mm) at theta = 0.5 of its --dt_fixed 0.05 s:
its Douglas print's own rows.  The Douglas step solves the rows of
theta*dw: the (64, 512, 1024) tube's Douglas step reaches half the ratio
of its inputs here at the same dt.  K10: chip_smoke.py phase 6's plans and
random fields on its tube, its disk and the spiral app's ring
(CYCLIC_SHAPES[0]) at multiples of phase 6's dt (float32).  K24-K26: phase
10's streams (the radiative film) from its mushy T and random fields at
384^3 (WAAM mask) and 97x203x131 at multiples of its dt (float32; K24 on
the mushy T with its seven streams, K25 and K26 on the random field with
the y and z streams); K24's and K25's blocks are 32 adjacent lines of the
x and y sweeps.
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
SOURCES = ("field_rows.cuh", "split_staged.cuh", "split_line.cuh",
           "masked.cu", "gstreams.cu")
# bins of a block's largest |a| + |c| over b - |a| - |c|
EDGES = (0, 1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, float("inf"))


def patched_copy(sets, subs):
    """A copy of the package under build/tune/ with the constants set and
    the substitutions made; an earlier copy with the same sources is kept
    (with its built library)."""
    tag = "open_" + "_".join(re.sub(r"\W", "", s) for s in sets + subs)[:80]
    root = os.path.join(HERE, "build", "tune", tag)
    fresh = root + ".new"
    shutil.rmtree(fresh, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, PKG), os.path.join(fresh, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    patch(os.path.join(fresh, PKG, "csrc"), sets, subs)
    old = os.path.join(root, PKG)
    if os.path.isdir(old) and same_tree(old, os.path.join(fresh, PKG)):
        shutil.rmtree(fresh)
        return root
    shutil.rmtree(root, ignore_errors=True)
    os.rename(fresh, root)
    return root


def same_tree(a, b):
    """The two directories hold the same files with the same bytes."""
    import filecmp
    cmp = filecmp.dircmp(a, b, ignore=["__pycache__"])
    if cmp.left_only or cmp.right_only or cmp.funny_files:
        return False
    _, bad, err = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    return not bad and not err and all(
        same_tree(os.path.join(a, d), os.path.join(b, d))
        for d in cmp.common_dirs)


def patch(csrc, sets, subs):
    """Set the constants and make the substitutions in csrc/SOURCES."""
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
            raise SystemExit(f"open_tune: constant {name} found {hits} "
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
            raise SystemExit(f"open_tune: {old} not in {SOURCES}")


def build_report(root):
    """nvcc of K21's and K17's sources, each alone, timed; the registers
    and spills of each split-line kernel."""
    from adi_thermal_fields_tpu_torch.kernels.build import (NVCC_FLAGS,
                                                            find_nvcc)
    csrc = os.path.join(root, PKG, "csrc")
    work = os.path.join(root, "build", "tune_obj")
    os.makedirs(work, exist_ok=True)
    for src in ("fields.cu", "vp_fields.cu", "masked.cu", "gstreams.cu"):
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
            if "split_" not in name:
                continue
            kernels += 1
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
            print(f"ptxas {name[:110]}: {regs.group(1) if regs else '?'} "
                  f"regs, spills {spill.groups() if spill else '?'}",
                  flush=True)
        print(f"nvcc {src} alone: {secs:.1f} s, {kernels} split-line kernel"
              f" instantiations", flush=True)


def block_max(t, axis):
    """The largest value of each block of 32 adjacent lines along
    ``axis`` (lines in the order of the other axes)."""
    import torch
    m = t.amax(dim=axis).reshape(-1)
    pad = -m.numel() % 32
    m = torch.nn.functional.pad(m, (0, pad))
    return m.reshape(-1, 32).amax(dim=1)


def load_chip_smoke(root=HERE):
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def k10_rows(torch, R, code, sink, srhs, glo, ghi, fac, ambient):
    """K10's rows (solvers/masked.py ``_masked_plain`` along z)."""
    from adi_thermal_fields_tpu_torch.solvers.masked import _prefold
    low = ((code & 1) != 0).to(R.dtype)
    high = ((code & 2) != 0).to(R.dtype)
    al, ch = glo * low, ghi * high
    return (-fac * al, 1.0 + fac * (al + ch + sink), -fac * ch,
            _prefold(R, code, srhs, fac, ambient))


def measure_k10_k26(cs, dev, seeds, dts, kernels, report):
    """K10 on phase 6's shapes, K26 (float32) on phase 10's."""
    import torch
    from adi_thermal_fields_tpu_torch import (CartesianGrid, CylindricalGrid,
                                              Material)
    from adi_thermal_fields_tpu_torch.solvers import (
        gstream_fields, gstream_sweep_z, gstream_sweep_z_plain,
        masked_sweep_z, masked_sweep_z_plain)

    f32 = torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    cases = [(label, shape, 5e-4, 0.0 if label.endswith("disk") else 0.02)
             for label, shape in cs.CYL_SHAPES] + [cs.CYCLIC_SHAPES[0]]
    for label, shape, dr, r_inner in cases if "K10" in kernels else ():
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        for si, seed in enumerate(seeds):
            if label.endswith("disk"):
                g = torch.Generator(device=dev).manual_seed(seed + 12)
                mask = torch.rand(shape, generator=g, device=dev) > 0.25
            else:
                mask = cs.tube_mask(torch, shape, dev)
            plan = cs.cyl_plan(torch, grid, mask, "dirichlet")
            R = cs.random_field(torch, mask, seed=seed)
            for di, dtm in enumerate(dts):
                fac = float(torch.tensor(cs.CYL_DT * dtm, dtype=f32)
                            * torch.tensor(mat.alpha, dtype=f32))
                rows = k10_rows(torch, R, *plan.z, fac, 20.0)
                report("K10", label, seed, dtm,
                       lambda: masked_sweep_z(R, *plan.z, fac, 20.0),
                       lambda: masked_sweep_z_plain(R, *plan.z, fac, 20.0),
                       rows, 2, si == 0 and di == 0)
                del rows
            del R, plan, mask
            torch.cuda.empty_cache()
    kt, ct = cs.varprop_tables()
    for label, shape in cs.P10_SHAPES if "K26" in kernels else ():
        for si, seed in enumerate(seeds):
            if label.endswith("waam"):
                mask = cs.waam_mask(torch, shape, dev)
            else:
                g = torch.Generator(device=dev).manual_seed(seed + 3)
                mask = torch.rand(shape, generator=g, device=dev) > 0.25
            T = cs.mushy_field(torch, mask, seed=seed + 7)
            R = cs.random_field(torch, mask, seed=seed + 13)
            for di, dtm in enumerate(dts):
                sc = cs.vp_scalars(CartesianGrid(*shape, 0.5e-3), mat,
                                   cs.P10_VP_DT * dtm)
                g_lo, g_hi, sw, _ = gstream_fields(
                    T, mask.to(torch.uint8), sc["tg"], sc["sk"], k_spec=kt,
                    cp_spec=ct, rho=mat.rho, dt=sc["dt"], t_inf=20.0,
                    h_mode="rad", hpar=cs.EMISSIVITY, h_conv=cs.H_CONV)
                lo, hi, s = g_lo[2], g_hi[2], sw[2]
                rows = (-lo, 1.0 + lo + hi + s, -hi, R + s * 20.0)
                report("K26", label, seed, dtm,
                       lambda: gstream_sweep_z(R, lo, hi, s, 20.0),
                       lambda: gstream_sweep_z_plain(R, lo, hi, s, 20.0),
                       rows, 2, si == 0 and di == 0)
                if si == 0 and di == 0:          # the bfloat16 state's ms
                    z16 = [t.to(torch.bfloat16) for t in (R, lo, hi, s)]
                    ms = cs.cuda_ms(torch, lambda: gstream_sweep_z(
                        *z16, 20.0, rng_seed=cs.P10_SEED, rng_offset=3), 20)
                    print(json.dumps(dict(kernel="K26", shape=label,
                                          dtype="bfloat16", ms=ms)),
                          flush=True)
                    del z16
                del rows, g_lo, g_hi, sw, lo, hi, s
            del T, R, mask
            torch.cuda.empty_cache()


def measure_k24_k25(cs, dev, seeds, dts, kernels, report):
    """K24 and K25 (float32) on phase 10's streams."""
    import torch
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (
        gstream_fields, gstream_sweep_y, gstream_sweep_y_plain,
        gstream_theta_sweep, gstream_theta_sweep_plain)
    from adi_thermal_fields_tpu_torch.solvers.gstreams import _theta_rhs

    if not {"K24", "K25"} & set(kernels):
        return
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = cs.varprop_tables()
    for label, shape in cs.P10_SHAPES:
        for si, seed in enumerate(seeds):
            if label.endswith("waam"):
                mask = cs.waam_mask(torch, shape, dev)
            else:
                g = torch.Generator(device=dev).manual_seed(seed + 3)
                mask = torch.rand(shape, generator=g, device=dev) > 0.25
            T = cs.mushy_field(torch, mask, seed=seed + 7)
            R = cs.random_field(torch, mask, seed=seed + 13)
            for di, dtm in enumerate(dts):
                sc = cs.vp_scalars(CartesianGrid(*shape, 0.5e-3), mat,
                                   cs.P10_VP_DT * dtm)
                g_lo, g_hi, sw, _ = gstream_fields(
                    T, mask.to(torch.uint8), sc["tg"], sc["sk"], k_spec=kt,
                    cp_spec=ct, rho=mat.rho, dt=sc["dt"], t_inf=20.0,
                    h_mode="rad", hpar=cs.EMISSIVITY, h_conv=cs.H_CONV)
                timed = si == 0 and di == 0
                th = (T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2],
                      g_hi[2], sw[0], 1.0, 20.0)
                if "K24" in kernels:
                    d = _theta_rhs(T, *th[1:7], 1.0, None)
                    lo, hi, s = g_lo[0], g_hi[0], sw[0]
                    rows = (-lo, 1.0 + lo + hi + s, -hi, d + s * 20.0)
                    report("K24", label, seed, dtm,
                           lambda: gstream_theta_sweep(*th),
                           lambda: gstream_theta_sweep_plain(*th), rows, 0,
                           timed)
                    del d, rows
                if "K25" in kernels:
                    lo, hi, s = g_lo[1], g_hi[1], sw[1]
                    rows = (-lo, 1.0 + lo + hi + s, -hi, R + s * 20.0)
                    report("K25", label, seed, dtm,
                           lambda: gstream_sweep_y(R, lo, hi, s, 20.0),
                           lambda: gstream_sweep_y_plain(R, lo, hi, s, 20.0),
                           rows, 1, timed)
                    del rows
                del g_lo, g_hi, sw, th
            del T, R, mask
            torch.cuda.empty_cache()


def measure(cs, dev, seeds, dts, with_report, root=HERE,
            kernels=("K10", "K17", "K21", "K24", "K25", "K26")):
    import torch
    from adi_thermal_fields_tpu_torch.solvers import (
        thomas, tridiag_fields, tridiag_fields_plain, vp_fields_sweep_strided,
        vp_fields_sweep_strided_plain, vp_fields_sweep_z,
        vp_fields_sweep_z_plain)
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    if with_report:
        build_report(root)
    if dev.type == "cuda":
        from adi_thermal_fields_tpu_torch.kernels.build import build_library
        _, secs = build_library()
        print(f"library build: {secs:.1f} s", flush=True)

    def report(kname, label, seed, dtm, fn, plain, rows, axis, timed):
        got, want = fn(), plain()
        mv = (lambda t: t.double().movedim(axis, 0))
        exact = thomas(*(mv(t) for t in rows)).movedim(0, axis)
        torch.cuda.synchronize()
        a, b, c, _ = rows
        off = a.abs() + c.abs()
        ratio = block_max((off / (b - off)).double(), axis)
        err = block_max((got - want).abs().double(), axis)
        e_plain = block_max((want.double() - exact).abs(), axis)
        e_kern = block_max((got.double() - exact).abs(), axis)
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
        rec = dict(kernel=kname, shape=label, seed=seed, dt_multiple=dtm,
                   dtype=str(got.dtype).replace("torch.", ""),
                   max_ratio=float(ratio.max()),
                   max_abs_err=float(err.max()),
                   err_ulp=float(err.max()) / ulp,
                   ms=cs.cuda_ms(torch, fn, 20) if timed else None,
                   bins=bins)
        print(json.dumps(rec), flush=True)
        del got, want, exact

    measure_k10_k26(cs, dev, seeds, dts, kernels, report)
    measure_k24_k25(cs, dev, seeds, dts, kernels, report)
    # K17 along r and z, and K21 on the same rows (the fields tier's)
    k17_cases = [(label, shape, prec, 5e-4, None, 1.0)
                 for label, shape, prec in cs.P8_SHAPES]
    k17_cases.append(("32x720x200 app tube", (32, 720, 200), "float32",
                      2.5e-4, 0.052, 0.5 * 0.05 / cs.P8_DT))
    for label, shape, prec, dr, r_inner, base in (
            k17_cases if {"K17", "K21"} & set(kernels) else ()):
        dtype = getattr(torch, prec)
        grid, mat, mask, zbc, _ = cs.cylvp_case(torch, label, shape, dtype,
                                                dev, dr, r_inner)
        cols = cvp._vp2_columns(grid, zbc, dtype, dev)
        shape = tuple(mask.shape)
        for si, seed in enumerate(seeds):
            g = torch.Generator(device=dev).manual_seed(seed + 24)
            T = torch.where(mask, 1400.0 + 100.0 * torch.rand(
                shape, generator=g, device=dev), 20.0)
            T.view(-1)[::97] = cs.SOLIDUS
            T.view(-1)[31::101] = cs.LIQUIDUS
            T = T.to(dtype)
            R = cs.random_field(torch, mask, seed=seed + 26).to(dtype)
            for di, dtm in enumerate(dts):
                sr, sz = cs.k17_streams(torch, grid, mat, mask, T, R,
                                        cs.P8_DT * base * dtm, seed + 28)
                timed = si == 0 and di == 0
                for entry, st, axis, gl, gh, kern, plain in (
                        ("r", sr, 0, cols["glo_r"], cols["ghi_r"],
                         vp_fields_sweep_strided,
                         vp_fields_sweep_strided_plain),
                        ("z", sz, 2, cols["geo_z"], cols["geo_z"],
                         vp_fields_sweep_z, vp_fields_sweep_z_plain)):
                    rows = cs.k17_rows(torch, st, gl, gh, axis)
                    report("K17", f"{label} {entry}", seed, base * dtm,
                           lambda: kern(*st, gl, gh),
                           lambda: plain(*st, gl, gh), rows, axis, timed)
                    report("K21", f"{label} {entry} (fields tier rows)",
                           seed, base * dtm,
                           lambda: tridiag_fields(*rows, axis),
                           lambda: tridiag_fields_plain(*rows, axis), rows,
                           axis, timed)
                    del rows
                del sr, sz
            del T, R
            torch.cuda.empty_cache()
        del mask, cols
    # K21 on phase 9's systems
    for label, shape, prec in cs.P9_SHAPES if "K21" in kernels else ():
        dtype = getattr(torch, prec)
        for si, seed in enumerate(seeds):
            a, b, c, R = cs.field_systems(torch, shape, dtype, dev, seed + 5)
            for ax in range(3):
                report("K21", f"{label} {'xyz'[ax]}", seed, 1.0,
                       lambda: tridiag_fields(a, b, c, R, ax),
                       lambda: tridiag_fields_plain(a, b, c, R, ax),
                       (a, b, c, R), ax, si == 0)
            del a, b, c, R
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(f"card: {smi.stdout.strip()}", flush=True)


def main():
    args = sys.argv[1:]
    report = "--build-report" in args
    args = [a for a in args if a != "--build-report"]
    seeds, dts, sets, subs = "17", "1", [], []
    kernels = "K10,K17,K21,K24,K25,K26"
    for flag, value in zip(args[::2], args[1::2]):
        if flag == "--seeds":
            seeds = value
        elif flag == "--dts":
            dts = value
        elif flag == "--kernels":
            kernels = value
        elif flag == "--set":
            sets.append(value)
        elif flag == "--sub":
            subs.append(value)
        else:
            raise SystemExit(f"open_tune: unknown flag {flag}")
    root = patched_copy(sets, subs) if sets or subs else HERE
    if sets or subs:
        print(f"measuring {root}", flush=True)
    cs = load_chip_smoke(root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("open_tune: no CUDA card")
    measure(cs, torch.device("cuda", 0), [int(s) for s in seeds.split(",")],
            [float(d) for d in dts.split(",")], report, root,
            tuple(kernels.split(",")))


if __name__ == "__main__":
    main()
