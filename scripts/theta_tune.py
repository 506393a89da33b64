#!/usr/bin/env python3
"""K3 and K4 (the theta-pass stencil, csrc/stencil.cu, and the stencil
fused into the plan-lite x sweep, csrc/theta_sweep.cu) on one CUDA card:
their register and spill report, a check against the plain versions over
odd shapes and every entry, and their times.

    python3 scripts/theta_tune.py [--set NAME=VALUE ...]

Prints one line per case.  Checks: float32 within 8 float32 ulp of the
output's scale, float64 within 1e-9 K, bfloat16 within one bfloat16 ulp
(to nearest and seeded).  Times: CUDA-event medians, float32, at
chip_smoke.py's 256^3 and 512^3 WAAM masks (and bfloat16 at 256^3), and
for K4 on 8192-row lines (8192x64x64: the reduced rows in global memory)
and on planes (1x512x512, 3x512x512), with the share of 3.35 TB/s under
the 9 B/cell byte model (5 at bfloat16), and K1's plan-lite x sweep (K4's
core without the stencil) beside them.  ``--set kK4Warps=8`` (any
``constexpr`` of csrc/theta_sweep.cu or csrc/stencil.cu) measures a copy
of the package under build/tune/ with that constant changed.
"""
import contextlib
import importlib.util
import io
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adi_thermal_fields_tpu_torch"


def patched_copy(sets):
    """A copy of the package under build/tune/ with the constants set."""
    tag = "_".join(s.replace("=", "") for s in sets)
    root = os.path.join(HERE, "build", "tune", tag)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for s in sets:
        name, value = s.split("=")
        hits = 0
        for src in ("theta_sweep.cu", "stencil.cu"):
            path = os.path.join(root, PKG, "csrc", src)
            text, n = re.subn(
                rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};",
                open(path).read())
            open(path, "w").write(text)
            hits += n
        if hits != 1:
            raise SystemExit(f"theta_tune: constant {name} found {hits} "
                             "times")
    return root


def ptxas_report(build_library):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        build_library(verbose=True)
    for part in buf.getvalue().split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        if not any(k in name for k in ("theta_sweep_kernel",
                                        "theta_rhs_kernel",
                                        "sweep_strided_kernel")):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        print(f"ptxas {name[:90]}: {regs.group(1) if regs else '?'} regs, "
              f"spills {spill.groups() if spill else '?'}", flush=True)


def measure(root):
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adi_thermal_fields_tpu_torch.kernels.build import build_library
    from adi_thermal_fields_tpu_torch.solvers import (
        fused_theta_sweep, fused_theta_sweep_plain, sweep_code, sweep_strided,
        theta_rhs, theta_rhs_plain)

    if not torch.cuda.is_available():
        raise SystemExit("theta_tune: no CUDA card")
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(0)}; package {root}",
          flush=True)
    ptxas_report(build_library)
    c_exp, inv = 3.5e-7, (1.0e6, 1.1e6, 0.9e6)
    tg, dt, tinf, rob = 0.21, 0.05, 20.0, 0.0031

    def case(shape, seed, dtype, mask=None):
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = (lambda: torch.rand(shape, generator=g, device=dev))
        if mask is None:
            mask = rnd() > 0.25
        T = torch.where(mask, 20.0 + 1480.0 * rnd(), 20.0).to(dtype)
        return mask, T

    def calls(mask, T, seed=None):
        code = sweep_code(mask, None, 0, stencil_bits=True)
        m8 = mask.to(torch.uint8)
        k4 = (T, code, c_exp, inv, tg, dt, tinf, rob)
        return [("K3", lambda: theta_rhs(T, m8, c_exp, inv, rng_seed=seed),
                 lambda: theta_rhs_plain(T, m8, c_exp, inv, rng_seed=seed)),
                ("K4", lambda: fused_theta_sweep(*k4, rng_seed=seed,
                                                 rng_offset=1),
                 lambda: fused_theta_sweep_plain(*k4, rng_seed=seed,
                                                 rng_offset=1))]

    worst = {"K3": 0.0, "K4": 0.0}
    shapes = [(37, 45, 70), (97, 203, 131), (1, 5, 7), (3, 4, 33),
              (2, 3, 1), (40, 33, 1030), (64, 64, 256), (5000, 3, 40),
              (1800, 5, 9)]
    for shape in shapes:
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            mask, T = case(shape, 3, dtype)
            for seed in ((None, 7) if dtype == torch.bfloat16 else (None,)):
                for name, kern, plain in calls(mask, T, seed):
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    err = float((got.double() - want.double()).abs().max())
                    scale = max(1.0, float(want.double().abs().max()))
                    if dtype == torch.bfloat16:
                        g64, w64 = got.double(), want.double()
                        big = torch.maximum(g64.abs(), w64.abs()).clamp_min(
                            1e-30)
                        ulps = float(((g64 - w64).abs() / torch.exp2(
                            torch.floor(torch.log2(big)) - 7)).max())
                        bad = ulps > 1.0
                    elif dtype == torch.float64:
                        ulps = err / (torch.finfo(dtype).eps * scale)
                        bad = err > 1e-9
                    else:
                        ulps = err / (torch.finfo(dtype).eps * scale)
                        bad = ulps > 8.0
                        worst[name] = max(worst[name], ulps)
                    if bad or shape == shapes[0]:
                        print(f"{'FAIL ' if bad else ''}{name} {shape} "
                              f"{str(dtype)[6:]:8s} seed {seed}: {ulps:.3f} "
                              "ulp (bf16: bf16 ulp)", flush=True)
    print(f"check done: worst float32 K3 {worst['K3']:.3f}, K4 "
          f"{worst['K4']:.3f} ulp of scale", flush=True)

    for label, shape, dtypes in (
            ("256^3", (256,) * 3, (torch.float32, torch.bfloat16)),
            ("512^3", (512,) * 3, (torch.float32,)),
            ("8192x64x64", (8192, 64, 64), (torch.float32,)),
            ("1x512x512", (1, 512, 512), (torch.float32,)),
            ("3x512x512", (3, 512, 512), (torch.float32,))):
        for dtype in dtypes:
            waam = shape[0] == shape[2]
            mask, T = case(shape, 5, dtype,
                           cs.waam_mask(torch, shape, dev) if waam else None)
            bpc = 5 if dtype == torch.bfloat16 else 9
            rows = calls(mask, T)
            if waam and dtype == torch.float32:   # K4's core alone
                c0 = sweep_code(mask, None, 0)
                rows.append(("K1 lite x", lambda: sweep_strided(
                    T, c0, tg, dt, tinf, axis=0, rob_c=rob), None))
            for name, kern, _ in rows:
                if name == "K3" and not waam:
                    continue
                ms = cs.cuda_ms(torch, kern, 20)
                pct = (100.0 * T.numel() * bpc / (ms * 1e-3)
                       / cs.HBM_BYTES_PER_S)
                print(f"{name}{'b' if bpc == 5 else ''} {label}: {ms:.4f} "
                      f"ms, {pct:.1f}% of its {bpc} B/cell bound",
                      flush=True)
            del T, mask
            torch.cuda.empty_cache()


def main():
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        measure(args[1])
        return
    sets = [a.split("--set=")[-1] for a in args if a != "--set"]
    root = patched_copy(sets) if sets else HERE
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--measure", root])
    sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
