#!/usr/bin/env python3
"""K23, the g-stream fields pass (csrc/gstreams.cu), on one CUDA card: its
registers and spills, a bitwise check against its plain version on ragged
tiles, and its times; for the source as it is or a patched copy.  With
``--kernels K24,K25`` the same for the x and y sweeps K24 and K25.

    python3 scripts/gstream_tune.py [--kernels K24,K25] [--set NAME=VALUE
                                    ...] [--sub OLD=NEW ...]

builds csrc/gstreams.cu alone (a library of K23-K26 only, ~20 s) and
prints the ptxas report of K23's kernels, then a check of K23 against
``gstream_fields_plain`` (``torch.equal``, every film mode with and
without a source, float32, bfloat16 and float64, on chip_smoke.py's
97x203x131 random mask and odd shapes), then one line per case: the
CUDA-event median ms of K23 at chip_smoke.py phase 10's 384^3 WAAM mask
and 97x203x131 (bfloat16 and float32, film modes const and rad + src)
and the share of its bound (21 B/cell at bfloat16, 41 at float32, +2/+4
with a source).  ``--set kGfMinBlocks=2`` (any ``constexpr`` of
csrc/gstreams.cu) or ``--sub OLD=NEW`` (a text substitution in it)
measures a copy of the package under build/tune/ so changed.

K24 and K25 (``--kernels K24,K25``): the ptxas report of their split-line
kernels, a check against their plain versions (8 float32 ulp of the
output's scale, 1e-12 of it at float64, one bfloat16 ulp at bfloat16; on
lines of 1-8192 rows, every path of the strided kernel, to nearest and
seeded), the CUDA-event median ms at chip_smoke.py phase 10's 384^3 WAAM
mask and 97x203x131 (bfloat16 seeded and float32) and on its 8192-row
lines (bfloat16), and phase 10's bfloat16 varprop step at 384^3 (ms/step
and its profile: scripts/vp2_gstream_ab.py ``bf16_step``; the step runs
K23-K26 alone, all in csrc/gstreams.cu).  ``--set kGxyWarps=16 --set
kGxyBlocks=2`` measures another block shape.
"""
import contextlib
import importlib.util
import io
import math
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adi_thermal_fields_tpu_torch"


def patched_copy(sets, subs):
    """A copy of the package under build/tune/ with the constants of
    csrc/gstreams.cu set and the substitutions made."""
    tag = "gs_" + "_".join(re.sub(r"\W", "", s) for s in sets + subs)[:80]
    root = os.path.join(HERE, "build", "tune", tag)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, PKG, "csrc", "gstreams.cu")
    text = open(path).read()
    for s in sets:
        name, value = s.split("=")
        text, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"gstream_tune: constant {name} found {n} "
                             "times")
    for s in subs:
        old, new = s.split("=", 1)
        if old not in text:
            raise SystemExit(f"gstream_tune: {old} not in gstreams.cu")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return root


def gate(torch, got, want):
    """|got - want| over its gate: 8 float32 ulp of the output's scale
    (1e-12 of it at float64, one bfloat16 ulp at bfloat16)."""
    scale = float(want.double().abs().max())
    err = float((got.double() - want.double()).abs().max())
    if want.dtype == torch.bfloat16:
        return err / 2.0 ** (math.floor(math.log2(scale)) - 7)
    return err / ((1e-12 if want.dtype == torch.float64 else 8 * 2.0 ** -23)
                  * scale)


def measure_xy(torch, cs, dev):
    """K24 and K25: check, times, the bfloat16 varprop step."""
    import json
    import numpy as np
    from adi_thermal_fields_tpu_torch.solvers import (
        gstream_sweep_y, gstream_sweep_y_plain, gstream_theta_sweep,
        gstream_theta_sweep_plain)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from vp2_gstream_ab import bf16_step
    from z_pencils_ab import gstream_case

    worst, bad = {}, 0
    for i, shape in enumerate(((1, 9, 37), (2, 5, 33), (37, 45, 70),
                               (384, 3, 50), (600, 3, 11), (1100, 2, 35),
                               (2100, 1, 33), (8192, 1, 40))):
        rng = np.random.default_rng(90 + i)
        live = rng.random(shape) > 0.2
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            cast = (lambda a: torch.from_numpy(a).to(dev, torch.float64)
                    .to(dtype))
            g = [cast(3.0 * rng.random(shape) * live) for _ in range(6)]
            sw = cast(0.2 * rng.random(shape) * live)
            T = cast(20.0 + 1480.0 * rng.random(shape))
            src = cast(5.0 * rng.random(shape) * live)
            yt = (lambda t: t.transpose(0, 1).contiguous())
            for seed in (None, 12):
                kw = dict(rng_seed=seed)
                pairs = [("K24", lambda: gstream_theta_sweep(
                              T, *g, sw, 1.0, 20.0, src_pre=src, **kw),
                          lambda: gstream_theta_sweep_plain(
                              T, *g, sw, 1.0, 20.0, src_pre=src, **kw))]
                ins = [yt(t) for t in (T, g[2], g[3], sw)]
                pairs.append(("K25",
                              lambda: gstream_sweep_y(*ins, 20.0, **kw),
                              lambda: gstream_sweep_y_plain(*ins, 20.0,
                                                            **kw)))
                for kname, kern, plain in pairs:
                    r = gate(torch, kern(), plain())
                    key = f"{kname} {str(dtype)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), r)
                    if r > 1.0:
                        bad += 1
                        print(f"FAIL {kname} {shape} {dtype} seed {seed}: "
                              f"{r:.2f} of its gate", flush=True)
    print(f"check done: {bad} cases past the gate; worst share of the "
          f"gate {json.dumps({k: round(v, 3) for k, v in worst.items()})}",
          flush=True)
    out = {}
    seed = dict(rng_seed=cs.P10_SEED)
    cases = [(label, shape, dtype) for label, shape in cs.P10_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [("waam", cs.LONG_LINES[0], torch.bfloat16),
              ("waam", cs.LONG_LINES[1], torch.bfloat16)]
    for label, shape, dtype in cases:
        T, R, g_lo, g_hi, sw = gstream_case(torch, cs, dev, label, shape,
                                            dtype)
        where = f"{'x'.join(map(str, shape))} {str(dtype)[6:]}"
        th = (T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2], g_hi[2],
              sw[0], 1.0, 20.0)
        for kname, fn in (
                ("K24", lambda: gstream_theta_sweep(*th, rng_offset=1,
                                                    **seed)),
                ("K25", lambda: gstream_sweep_y(R, g_lo[1], g_hi[1], sw[1],
                                                20.0, rng_offset=2,
                                                **seed))):
            if shape == cs.LONG_LINES[1 - (kname == "K25")]:
                continue
            out[f"{kname} {where}"] = round(cs.cuda_ms(torch, fn, 20), 4)
        del T, R, g_lo, g_hi, sw, th
        torch.cuda.empty_cache()
    bf16_step(torch, cs, dev, out)
    prof = out.pop("profile_bf16 varprop 384^3")
    out["step busy ms"] = round(prof["busy_ms"], 4)
    out["step kernels"] = {k: round(v, 4)
                           for k, v in prof["kernels"].items()}
    print(json.dumps(out), flush=True)


def measure(root, kernels=("K23",)):
    sys.path.insert(0, root)
    import torch
    from adi_thermal_fields_tpu_torch.kernels import build
    # the library of csrc/gstreams.cu alone
    build._sources = lambda: [build._CSRC / "gstreams.cu"]
    build._SIGNATURES = {k: v for k, v in build._SIGNATURES.items()
                         if k.startswith("atf_gstream")}
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (gstream_fields,
                                                      gstream_fields_plain)

    if not torch.cuda.is_available():
        raise SystemExit("gstream_tune: no CUDA card")
    dev = torch.device("cuda", 0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, secs = build.build_library(verbose=True)
    print(f"card: {torch.cuda.get_device_name(0)}; package {root}; build "
          f"{secs:.1f} s", flush=True)
    for part in buf.getvalue().split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        if not any(("gstream_fields" in name) if k == "K23" else
                   ("GThetaRows" in name) if k == "K24" else
                   ("GStreamYRows" in name) for k in kernels):
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        print(f"ptxas {name[:90]}: {regs.group(1) if regs else '?'} regs, "
              f"spills {spill.groups() if spill else '?'}", flush=True)

    if "K23" not in kernels:
        measure_xy(torch, cs, dev)
        return
    mat = Material(7800.0, 490.0, 54.0)
    kt, ct = cs.varprop_tables()

    def case(shape, dtype, waam):
        sc = cs.vp_scalars(CartesianGrid(*shape, 0.5e-3), mat, cs.P10_VP_DT)
        if waam:
            mask = cs.waam_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(3)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        T = cs.mushy_field(torch, mask, seed=7).to(dtype)
        g = torch.Generator(device=dev).manual_seed(5)
        h = (5.0 + 40.0 * torch.rand(shape, generator=g, device=dev)
             ).to(dtype)
        src = torch.where(mask, 1e8 * torch.rand(shape, generator=g,
                                                 device=dev), 0.0).to(dtype)
        fk = dict(k_spec=kt, cp_spec=ct, rho=mat.rho, dt=sc["dt"],
                  t_inf=20.0)
        modes = {"const": dict(h_mode="const", hpar=cs.H_CONV),
                 "stream": dict(h_mode="stream", h=h),
                 "rad": dict(h_mode="rad", hpar=cs.EMISSIVITY,
                             h_conv=cs.H_CONV),
                 "rad + src": dict(h_mode="rad", hpar=cs.EMISSIVITY,
                                   h_conv=cs.H_CONV, src=src)}
        args = (T, mask.to(torch.uint8), sc["tg"], sc["sk"])
        return {name: (lambda kw=kw: gstream_fields(*args, **fk, **kw),
                       lambda kw=kw: gstream_fields_plain(*args, **fk, **kw))
                for name, kw in modes.items()}

    bad = 0
    for shape in ((97, 203, 131), (37, 45, 70), (5, 9, 131), (130, 10, 12),
                  (2, 8, 256), (1, 1, 1)):
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            for name, (kern, plain) in case(shape, dtype, False).items():
                got, want = kern(), plain()
                flat = (lambda o: [t for grp in o[:3] for t in grp]
                        + ([o[3]] if o[3] is not None else []))
                same = all(torch.equal(a, b)
                           for a, b in zip(flat(got), flat(want)))
                if not same:
                    bad += 1
                    print(f"FAIL K23 {name} {shape} {dtype}", flush=True)
    print(f"check done: {bad} cases not bitwise", flush=True)
    for label, shape, waam in (("384^3 waam", (384,) * 3, True),
                               ("97x203x131", (97, 203, 131), False)):
        for dtype in (torch.bfloat16, torch.float32):
            for name, (kern, _) in case(shape, dtype, waam).items():
                if name not in ("const", "rad + src"):
                    continue
                bpc = (21 if dtype == torch.bfloat16 else 41) + (
                    (2 if dtype == torch.bfloat16 else 4)
                    if "src" in name else 0)
                ms = cs.cuda_ms(torch, kern, 20)
                b = cs.bound("K23", bpc * math.prod(shape),
                             math.prod(shape))["bound_ms"]
                print(f"K23 {name} {label} {str(dtype)[6:]}: {ms:.4f} ms, "
                      f"{100.0 * b / ms:.1f}% of its bound", flush=True)
            torch.cuda.empty_cache()


def main():
    args = sys.argv[1:]
    if args[:1] == ["--measure"]:
        measure(args[1], tuple(args[2].split(",")))
        return
    sets, subs, kernels = [], [], "K23"
    for flag, value in zip(args[::2], args[1::2]):
        if flag == "--kernels":
            kernels = value
        else:
            (sets if flag == "--set" else subs).append(value)
    root = patched_copy(sets, subs) if sets or subs else HERE
    sys.exit(subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--measure", root, kernels]).returncode)


if __name__ == "__main__":
    main()
