#!/usr/bin/env python3
"""K23, the g-stream fields pass (csrc/gstreams.cu), on one CUDA card: its
registers and spills, a bitwise check against its plain version on ragged
tiles, and its times; for the source as it is or a patched copy.

    python3 scripts/gstream_tune.py [--set NAME=VALUE ...] [--sub OLD=NEW ...]

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


def measure(root):
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
        if "gstream_fields" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        print(f"ptxas {name[:90]}: {regs.group(1) if regs else '?'} regs, "
              f"spills {spill.groups() if spill else '?'}", flush=True)

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
        measure(args[1])
        return
    sets, subs = [], []
    for flag, value in zip(args[::2], args[1::2]):
        (sets if flag == "--set" else subs).append(value)
    root = patched_copy(sets, subs) if sets or subs else HERE
    sys.exit(subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--measure", root]).returncode)


if __name__ == "__main__":
    main()
