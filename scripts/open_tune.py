#!/usr/bin/env python3
"""The open field sweeps K21 (a/b/c/d fields) and K17 (five streams) on
the split-line core, on one CUDA card: their build time and register and
spill report, their error against their plain versions block by block
against each block's stiffness, and their time.  The open-line twin of
scripts/cyclic_tune.py.

    python3 scripts/open_tune.py [--build-report] [--seeds 17,23]
                                 [--dts 1,10] [--set NAME=VALUE ...]
                                 [--sub OLD=NEW ...]

A block of lines with a row past (|a| + |c|) > ratio (b - |a| - |c|) is
solved in Thomas order, bit for bit the plain version, where ratio is
kOpenStiff of csrc/field_rows.cuh; ``--set kOpenStiff=1e30`` (any
``constexpr`` of csrc/field_rows.cuh, csrc/split_staged.cuh and
csrc/split_line.cuh) splits every block; ``--sub OLD=NEW`` makes a text
substitution in those sources (OLD free of '='); either is measured in a
copy of the package under build/tune/.

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
of its inputs here at the same dt.
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
SOURCES = ("field_rows.cuh", "split_staged.cuh", "split_line.cuh")
# bins of a block's largest |a| + |c| over b - |a| - |c|
EDGES = (0, 1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, float("inf"))


def patched_copy(sets, subs):
    """A copy of the package under build/tune/ with the constants set and
    the substitutions made."""
    tag = "open_" + "_".join(re.sub(r"\W", "", s) for s in sets + subs)[:80]
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
    return root


def build_report(root):
    """nvcc of K21's and K17's sources, each alone, timed; the registers
    and spills of each split-line kernel."""
    from adi_thermal_fields_tpu_torch.kernels.build import (NVCC_FLAGS,
                                                            find_nvcc)
    csrc = os.path.join(root, PKG, "csrc")
    work = os.path.join(root, "build", "tune_obj")
    os.makedirs(work, exist_ok=True)
    for src in ("fields.cu", "vp_fields.cu"):
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


def measure(cs, dev, seeds, dts, with_report, root=HERE):
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

    # K17 along r and z, and K21 on the same rows (the fields tier's)
    k17_cases = [(label, shape, prec, 5e-4, None, 1.0)
                 for label, shape, prec in cs.P8_SHAPES]
    k17_cases.append(("32x720x200 app tube", (32, 720, 200), "float32",
                      2.5e-4, 0.052, 0.5 * 0.05 / cs.P8_DT))
    for label, shape, prec, dr, r_inner, base in k17_cases:
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
    for label, shape, prec in cs.P9_SHAPES:
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
    for flag, value in zip(args[::2], args[1::2]):
        if flag == "--seeds":
            seeds = value
        elif flag == "--dts":
            dts = value
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
            [float(d) for d in dts.split(",")], report, root)


if __name__ == "__main__":
    main()
