#!/usr/bin/env python3
"""Launch-shape and design probe of K9 (the masked r march) and K13 (the
constant-row z sweep) on one CUDA card: csrc/masked.cu and
csrc/const_sweeps.cu built alone for each variant, timed in one process
in turns.

    python3 scripts/pencils_probe.py '[{}, {"kK13Warps": 8},
        {"__sub__": [["old text", "new text"]]}]'

Each variant sets ``constexpr`` values of the two sources (and the
headers they include) and, under ``__sub__``, replaces source text (a
diagnostic variant: a pass skipped, a path switched off).  The variants'
two objects build at once into build/probe/<i>/lib.so (no PyTorch
headers, ~1.5 min); the wrappers of K9, K13 and K13t are pointed at each
library in turn (variants in order, then in reverse), and each turn
prints one JSON line: the CUDA-event medians in ms of K9 on phase 6's
(37, 203, 131) disk and on tubes of phase 6's kind with 64, 96, 128, 192
and 256-row r lines (~2^25 cells; the (64, 512, 1024) tube itself at
64), their largest distance from the plain version (float32 ulp of the
output's scale) and whether bit for bit, and K13 at phase 7's (128, 512,
512) annulus and (37, 203, 131) disk and on 64x64x8192 lines with the
step's table, its distance, and K13t; then each variant's registers and
spills (ptxas) and the card's name and power limit.
"""
import concurrent.futures as cf
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
CSRC = os.path.join(HERE, "adi_thermal_fields_tpu_torch", "csrc")
SOURCES = ("masked.cu", "const_sweeps.cu")
ENTRIES = ("atf_masked_sweep_strided", "atf_const_sweep_z",
           "atf_const_sweep_table")


def build(idx, sets):
    """The variant's two sources (and every header) patched into
    build/probe/<idx>/, compiled and linked; (library, ptxas report)."""
    from adi_thermal_fields_tpu_torch.kernels import build as kb
    nvcc = kb.find_nvcc()
    d = os.path.join(HERE, "build", "probe", str(idx))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in os.listdir(CSRC):
        if not (f.endswith(".cuh") or f in SOURCES):
            continue
        text = open(os.path.join(CSRC, f)).read()
        for name, value in sets.items():
            if name == "__sub__":
                for old, new in value:
                    text = text.replace(old, new)
            else:
                text = re.sub(rf"(constexpr \w+ {name} = )[^;]+;",
                              rf"\g<1>{value};", text)
        open(os.path.join(d, f), "w").write(text)
    procs = [subprocess.Popen(
        [nvcc, *kb.NVCC_FLAGS, "-Xptxas", "-v", "-I", d, "-c", "-o",
         os.path.join(d, src + ".o"), os.path.join(d, src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src in SOURCES]
    report = ""
    for p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"variant {sets}: nvcc exit {p.returncode}\n"
                             f"{err[-3000:]}")
        report += out + err
    lib = os.path.join(d, "lib.so")
    subprocess.run([nvcc, "-shared", "-o", lib,
                    *(os.path.join(d, s + ".o") for s in SOURCES)],
                   check=True)
    lines = report.splitlines()
    regs = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?"
                      r"((?:masked_march|const_sweep_z(?:_vec)?)_kernel"
                      r"I[fd]L?[ib]?\d*)", line)
        if m:
            tail = " ".join(lines[i + 1:i + 4])
            rg = re.search(r"Used (\d+) registers", tail)
            sp = re.search(r"(\d+) bytes spill stores", tail)
            regs[m.group(1)] = (rg and int(rg.group(1)),
                                sp and int(sp.group(1)))
    return lib, regs


def main():
    variants = json.loads(sys.argv[1])
    with cf.ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(lambda iv: build(*iv), enumerate(variants)))
    import torch
    from adi_thermal_fields_tpu_torch.kernels import build as kb
    from adi_thermal_fields_tpu_torch import CylindricalGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (
        const_sweep_table, const_sweep_z, const_sweep_z_plain,
        masked_sweep_strided, masked_sweep_strided_plain)
    from adi_thermal_fields_tpu_torch.solvers import const_sweeps as scs
    from adi_thermal_fields_tpu_torch.solvers import masked as smk
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    libs = []
    for lib, _ in built:
        L = ctypes.CDLL(lib)
        for name in ENTRIES:
            f = getattr(L, name)
            f.argtypes, f.restype = kb._SIGNATURES[name]
        libs.append(L)
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    eps = torch.finfo(f32).eps
    mat = Material(7800.0, 490.0, 54.0)
    fac = float(torch.tensor(cs.CYL_DT, dtype=f32)
                * torch.tensor(mat.alpha, dtype=f32))
    k9 = []
    for n in (37, 64, 96, 128, 192, 256):
        disk = n == 37
        shape = ((37, 203, 131) if disk else (64, 512, 1024) if n == 64
                 else (n, 512, max(8, 2 ** 25 // (512 * n))))
        grid = CylindricalGrid(*shape, 5e-4, 5e-4,
                               r_inner=0.0 if disk else 0.02)
        if disk:
            g = torch.Generator(device=dev).manual_seed(29)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        else:
            mask = cs.tube_mask(torch, shape, dev)
        plan = cs.cyl_plan(torch, grid, mask,
                           "neumann0" if disk else "dirichlet")
        R = cs.random_field(torch, mask, seed=17)
        k9.append((n, R, plan,
                   masked_sweep_strided_plain(R, *plan.r, fac, 20.0)))
    k13 = []
    for label, shape in (*cs.P7_SHAPES, ("64x64x8192 annular",
                                         (64, 64, 8192))):
        grid, mat_, _, zbc = cs.be_case(label, shape)
        R = cs.random_field(torch, torch.ones(shape, dtype=torch.bool,
                                              device=dev), 23)
        vecs, _ = cyl._z_coefficients(grid, mat_, zbc, cs.P7_DT, f32, dev)
        tab = cyl._z_table(grid, mat_, zbc, cs.P7_DT, f32, dev)
        k13.append((label, R, vecs, tab, const_sweep_z_plain(R, *vecs)))
    res = [dict() for _ in variants]
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for j in order:
        smk.load_library = scs.load_library = (lambda L=libs[j]: L)
        r = res[j]

        def record(key, fn, want):
            got = fn()
            torch.cuda.synchronize()
            r.setdefault(f"{key} ms", []).append(cs.cuda_ms(torch, fn, 20))
            r[f"{key} ulp"] = float((got - want).abs().max()) / (
                eps * float(want.abs().max()))
            r[f"{key} bitwise"] = bool(torch.equal(got, want))

        for n, R, plan, want in k9:
            record(f"K9 n{n}",
                   lambda: masked_sweep_strided(R, *plan.r, fac, 20.0), want)
        for label, R, vecs, tab, want in k13:
            record(f"K13 {label}", lambda: const_sweep_z(R, *vecs, tab),
                   want)
        vecs = k13[0][2]
        r.setdefault("K13t ms", []).append(cs.cuda_ms(
            torch, lambda: const_sweep_table(*vecs[:3]), 10))
        print(json.dumps(dict(variant=variants[j], **r)), flush=True)
    for (_, regs), v in zip(built, variants):
        print(json.dumps(dict(variant=v, ptxas=regs)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
