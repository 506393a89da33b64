#!/usr/bin/env python3
"""K9 and K13 (the cylindrical steps' r and z pencil sweeps), K12 and K14
(the r sweep and the periodic phi solve of the unmasked cylindrical step)
and K15 with its y entry K15y (the tier-2 r and y sweeps) on one CUDA
card: their launch shapes, K9's, K12's and K15's crossovers, K12's, K13's
and K14's stiffness ratios and K15's replays.

    python3 scripts/cyl_be_tune.py [--variants 'NAME=VALUE,...;...']
                                   [--kernels K9,K12,K13,K14,K15]
                                   [--crossover 64,96,128]
                                   [--seeds 17,23] [--dts 1,10]
                                   [--no-ratio]

Each variant is a set of ``constexpr`` values of csrc/masked.cu
(kK9MarchRows: 0 sends every line to the split kernel, 128 every line of
up to 128 rows to the march; kK9MarchThreads, kK9MarchGroup,
kK9MarchBlocks, kK9MarchBlocks64), csrc/const_sweeps.cu (kK12MarchRows,
as kK9MarchRows, and kK12MarchRows64; kK12RegRows, kK12MarchThreads,
kK12Warps, kK12Blocks, kK12Stiff,
kK13Warps, kK13StageKB, kK13Stiff, kK14Warps, kK14Blocks, kK14Stiff) and
csrc/vp2_sweep.cu (kK15MarchRows: 0 sends every line to the split kernel,
a large value every line to the march; kK15MarchCells, kK15MarchThreads,
kK15MarchGroup, kK15MarchBlocks) in a copy of the package under
build/tune/ so changed (the empty variant: this checkout).  The variants'
libraries build at once; then, for each, one JSON line: the registers and
spills ptxas reports for K9's, K12's and K15's marches and K12's, K13's
and K14's kernels, and CUDA-event medians in ms, of the kernels named by
--kernels: K9 at chip_smoke.py phase 6's (64, 512, 1024) tube, (37, 203,
131) disk and 97-row r lines, and the masked step; K12 at phase 7's
(128, 512, 512) annulus and (37, 203, 131) disk, the spiral app's ring
and 512-row r lines, with the step's table and given none; K13 at phase 7's
(128, 512, 512) annulus, (37, 203, 131) disk and 8192-row lines, with the
step's table and given none, and K13t; K14 at phase 7's shapes; K15 at
phase 8's (64, 512, 1024) tube (the rhs T, and given), its disk and the
tube at 10x dt, K15y at the 512^3 WAAM mask, and phase 7's (K12, K13,
K14) and phase 8's (K15) backward-Euler steps.  With --crossover, in place
of those: K9 on tubes of phase 6's kind, K12 (float32 and float64, with
the step's table) on annuli of phase 7's kind and K15 (the rhs T, as the
BE step calls it) on tubes of phase 8's kind with r lines of each given
length (512 phi rows, about 2^25 cells), and K15y at 512^3, each with its
CUDA-event median ms and its largest |delta| from the plain version (K
and float32 ulp of the output's scale, against chip_smoke.py's
KERNEL_TOL_ULP for K9 and K12 and P8_TOL for K15; K9 and K12: bit for
bit or not): run with kK9MarchRows=0 and 128 (kK12MarchRows likewise,
kK15MarchRows=0 and a large value), the lengths where the march and the
split kernel cross.

Then (unless --no-ratio), in a copy with kK12Stiff = kK13Stiff = kK14Stiff
= 1e30 and kK12MarchRows = kK12MarchRows64 = 0:
K14 with every ring split on phase 7's shapes, the spiral app's ring (32,
720, 200) and 4096-row lines on a 20 mm annulus, for each seed of the
right-hand side and each multiple of the step's dt: per bin of the rings'
stiffness ratio 2 fac, the rings, their largest |delta| from the plain
version and the largest distances of the plain version and of the split
solve from the float64 plain version (float32 ulp of the output's scale),
and the share of rings past this checkout's kK14Stiff; K13 with every
table split on phase 7's shapes, the spiral app's z rows (0.25 mm, its
dt_fixed 0.05 s) and 8192-row lines, per seed and dt multiple: the
table's ratio, K13's largest distance from the plain version and both
from the float64 plain version, and whether this checkout's kK13Stiff
sends it to Thomas order; K12 likewise on phase 7's shapes, the spiral
app's r rows and 512-row r lines; and K15's share of blocks (32 lines)
with a row past kK8Stiff (Thomas order) on the tube at 1x and 10x dt,
the disk and the spiral app's tube (r_inner 52 mm, 0.25 mm cells, its
dt_fixed 0.05 s), with its |delta| from the plain version.
"""
import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adi_thermal_fields_tpu_torch"
SOURCES = ("const_sweeps.cu", "vp2_sweep.cu", "masked.cu")
# the cells of a crossover tube (512 phi rows)
CROSSOVER_CELLS = 2 ** 25
# bins of a ring's 2 fac (K14) or a block's largest row ratio (K15)
EDGES = (0, 1, 2, 4, 8, 12, 16, 24, 32, 64, 128, 1024, float("inf"))
# the copy in which K12 and K13 split every table and K14 every ring
SPLIT_ALL = ["kK14Stiff=1e30", "kK13Stiff=1e30", "kK12Stiff=1e30",
             "kK12MarchRows=0", "kK12MarchRows64=0"]


def source_constant(root, name, src):
    """``constexpr ... name = value;`` of root's csrc/src."""
    with open(os.path.join(root, PKG, "csrc", src)) as f:
        return float(re.search(rf"constexpr \w+ {name} = ([0-9.e+]+);",
                               f.read()).group(1))


def patched_copy(sets):
    """A copy of the package under build/tune/ with the constants set."""
    if not sets:
        return HERE
    tag = "_".join(re.sub(r"\W", "", s) for s in sets)[:80]
    root = os.path.join(HERE, "build", "tune", tag)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for s in sets:
        name, value = s.split("=")
        hits = 0
        for src in SOURCES:
            path = os.path.join(root, PKG, "csrc", src)
            text = open(path).read()
            new, k = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                             rf"\g<1>{value};", text)
            hits += k
            open(path, "w").write(new)
        if hits != 1:
            raise SystemExit(f"{name}: {hits} definitions in {SOURCES}")
    return root


def load_cs(torch_root):
    sys.path.insert(0, torch_root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build(root):
    """Build ``root``'s library; the registers and spills of K9's, K12's
    and K15's marches and K12's, K13's and K14's kernels (ptxas -v)."""
    sys.path.insert(0, root)
    import contextlib
    import io
    from adi_thermal_fields_tpu_torch.kernels.build import build_library
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, secs = build_library(verbose=True)
    lines = buf.getvalue().splitlines()
    report = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if not m or not re.search(r"cyclic_const_phi|march|const_sweep_z"
                                  r"|const_table|const_split", m.group(1)):
            continue
        name = m.group(1)
        k14 = re.search(r"cyclic_const_phi_kernelI([fd])Li(\d+)ELb(\d)",
                        name)
        k9 = re.search(r"masked_march_kernelI([fd])Li(\d+)", name)
        march = re.search(r"vp2_march_kernelI([fd])Li(\d+)", name)
        k13 = re.search(r"const_sweep_z_kernelI([fd])Lb(\d)", name)
        k13v = re.search(r"const_sweep_z_vec_kernelI([fd])", name)
        k12 = re.search(r"const_march_kernelI([fd])Li(\d+)", name)
        k12s = re.search(r"const_split_kernelI([fd])Li(\d+)ELb(\d)", name)
        if k12:
            key = "K12 march {} rows{}".format(*k12.groups())
        elif k12s:
            key = "K12 split {} M{} regs{}".format(*k12s.groups())
        elif k14:
            key = "K14 {} M{} regs{}".format(*k14.groups())
        elif k9:
            key = "K9 march {} rows{}".format(*k9.groups())
        elif march:
            key = "K15 march {} seg{}".format(*march.groups())
        elif k13:
            key = "K13 {} staged{}".format(*k13.groups())
        elif k13v:
            key = "K13 {} staged 16-byte".format(*k13v.groups())
        else:
            key = name[-60:]
        tail = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores", tail)
        report[key] = (int(regs.group(1)) if regs else None,
                       int(spill.group(1)) if spill else None)
    print(json.dumps(dict(build_s=secs, ptxas=report)), flush=True)


def times(root, crossover, kernels):
    """CUDA-event medians of ``kernels``' rows and steps, or
    (``crossover``: r line lengths) K9's, K12's, K15's and K15y's times and
    errors."""
    import torch
    cs = load_cs(root)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import cyl_be_ab
    dev = torch.device("cuda", 0)
    out = dict(root=root)
    if crossover:
        if "K9" in kernels:
            k9_crossover(torch, cs, dev, crossover, out)
        if "K12" in kernels:
            k12_crossover(torch, cs, dev, crossover, out)
        if "K15" in kernels:
            k15_crossover(torch, cs, dev, crossover, out)
    else:
        if "K9" in kernels:
            cyl_be_ab.k9_rows(torch, cs, dev, out)
            cyl_be_ab.masked_step(torch, cs, dev, out)
        if "K12" in kernels:
            cyl_be_ab.k12_rows(torch, cs, dev, out)
        if "K13" in kernels:
            cyl_be_ab.k13_rows(torch, cs, dev, out)
        if "K14" in kernels:
            cyl_be_ab.k14_rows(torch, cs, dev, out)
        if {"K12", "K13", "K14"} & set(kernels):
            cyl_be_ab.be_steps(torch, cs, dev, out)
        if "K15" in kernels:
            cyl_be_ab.k15_rows(torch, cs, dev, out)
            cyl_be_ab.varprop_be_step(torch, cs, dev, out)
    print(json.dumps({k: v for k, v in out.items()
                      if not k.startswith("profile")}), flush=True)


def bin_of(x):
    for lo, hi in zip(EDGES, EDGES[1:]):
        if lo <= x < hi:
            return f"{lo}-{hi}"
    return "nan"


def k14_ratio(torch, cs, dev, seeds, dts, stiff):
    """K14 split on every ring (a copy built with kK14Stiff = 1e30)
    against the plain version, by ring; ``stiff``: this checkout's
    ratio."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (cyclic_const_phi,
                                                      cyclic_const_phi_plain,
                                                      cyclic_const_phi_table)
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl

    eps = torch.finfo(torch.float32).eps
    mat = Material(7800.0, 490.0, 54.0)
    shapes = [(label, shape, 5e-4, 0.02 if label.endswith("annular")
               else 0.0) for label, shape in cs.P7_SHAPES]
    shapes += [cs.CYCLIC_SHAPES[0][:4], cs.CYCLIC_SHAPES[2][:4]]
    for label, shape, dr, r_inner in shapes:
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        n = shape[1]
        for mult in dts:
            dt = mult * cs.P7_DT
            fac = cyl._phi_fac(grid, mat, 1.0, dt, torch.float32, dev)
            fac64 = cyl._phi_fac(grid, mat, 1.0, dt, torch.float64, dev)
            split = cyclic_const_phi_table(fac, n)
            two_fac = (2.0 * fac).tolist()
            bins = {}
            for seed in seeds:
                R = cs.random_field(torch, torch.ones(
                    shape, dtype=torch.bool, device=dev), seed)
                got = cyclic_const_phi(R, fac, split)
                want = cyclic_const_phi_plain(R, fac)
                ref = cyclic_const_phi_plain(R.double(), fac64)
                scale = float(want.abs().max()) * eps
                ring = (lambda t: t.abs().amax(dim=(1, 2)) / scale)
                d_kp = ring(got - want).tolist()
                d_p = ring(want.double() - ref).tolist()
                d_k = ring(got.double() - ref).tolist()
                for i, x in enumerate(two_fac):
                    b = bins.setdefault(bin_of(x), [0, 0.0, 0.0, 0.0])
                    b[0] += 1
                    b[1] = max(b[1], d_kp[i])
                    b[2] = max(b[2], d_p[i])
                    b[3] = max(b[3], d_k[i])
                del R, got, want, ref
            flagged = sum(x > stiff for x in two_fac) / len(two_fac)
            print(json.dumps(dict(
                kernel="K14", shape=label, dt_x=mult, seeds=len(seeds),
                flagged_share=flagged, max_two_fac=max(two_fac),
                bins={k: dict(rings=v[0], ulp_vs_plain=round(v[1], 3),
                              plain_ulp_vs_f64=round(v[2], 3),
                              split_ulp_vs_f64=round(v[3], 3))
                      for k, v in sorted(bins.items(),
                                         key=lambda kv: float(
                                             kv[0].split("-")[0]))})),
                  flush=True)
            torch.cuda.empty_cache()


def k13_ratio(torch, cs, dev, seeds, dts, stiff):
    """K13 split on every table (a copy built with kK13Stiff = 1e30)
    against the plain version, per shape and dt; ``stiff``: this
    checkout's ratio."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid, Material
    from adi_thermal_fields_tpu_torch.solvers import (const_sweep_table,
                                                      const_sweep_z,
                                                      const_sweep_z_plain)
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl
    import cyl_be_ab

    eps = torch.finfo(torch.float32).eps
    mat = Material(7800.0, 490.0, 54.0)
    ring = cs.CYCLIC_SHAPES[0]
    shapes = [(label, shape, 5e-4, 0.02 if label.endswith("annular")
               else 0.0, cs.P7_DT) for label, shape in cs.P7_SHAPES]
    shapes += [(ring[0] + " z", ring[1], ring[2], ring[3], 0.05),
               cyl_be_ab.K13_LONG + (5e-4, 0.02, cs.P7_DT)]
    for label, shape, dr, r_inner, dt0 in shapes:
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        _, _, _, zbc = cs.be_case(label, shape)
        for mult in dts:
            dt = mult * dt0
            vecs, _ = cyl._z_coefficients(grid, mat, zbc, dt, torch.float32,
                                          dev)
            v64, _ = cyl._z_coefficients(grid, mat, zbc, dt, torch.float64,
                                         dev)
            table = const_sweep_table(*vecs[:3])
            ratio = float(table[-1])
            worst = [0.0, 0.0, 0.0]
            for seed in seeds:
                R = cs.random_field(torch, torch.ones(
                    shape, dtype=torch.bool, device=dev), seed)
                got = const_sweep_z(R, *vecs, table)
                want = const_sweep_z_plain(R, *vecs)
                ref = const_sweep_z_plain(R.double(), *v64)
                scale = float(want.abs().max()) * eps
                for j, d in enumerate((got - want, want.double() - ref,
                                       got.double() - ref)):
                    worst[j] = max(worst[j], float(d.abs().max()) / scale)
                del R, got, want, ref
            print(json.dumps(dict(
                kernel="K13", shape=label, dt_x=mult, seeds=len(seeds),
                ratio=ratio, thomas_order_here=ratio > stiff,
                ulp_vs_plain=round(worst[0], 3),
                plain_ulp_vs_f64=round(worst[1], 3),
                split_ulp_vs_f64=round(worst[2], 3))), flush=True)
            torch.cuda.empty_cache()


def k12_ratio(torch, cs, dev, seeds, dts, stiff):
    """K12 split on every table (a copy built with kK12Stiff = 1e30 and
    no march) against the plain version, per shape and dt;
    ``stiff``: this checkout's ratio."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid, RobinBC
    from adi_thermal_fields_tpu_torch.solvers import (
        const_sweep_strided, const_sweep_strided_plain)
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl
    import cyl_be_ab

    eps = torch.finfo(torch.float32).eps
    ring = cs.CYCLIC_SHAPES[0]
    shapes = [(label, shape, 5e-4, 0.02 if label.endswith("annular")
               else 0.0, cs.P7_DT) for label, shape in cs.P7_SHAPES]
    shapes += [(ring[0], ring[1], ring[2], ring[3], 0.05),
               cyl_be_ab.K12_LONG + (5e-4, 0.02, cs.P7_DT)]
    for label, shape, dr, r_inner, dt0 in shapes:
        grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
        _, mat, _, _ = cs.be_case(label, shape)
        for mult in dts:
            key = (grid, mat, RobinBC(300.0, 20.0), None, mult * dt0)
            vecs = cyl._r_coefficients(*key, torch.float32, dev)
            v64 = cyl._r_coefficients(*key, torch.float64, dev)
            table = cyl._r_table(*key, torch.float32, dev)
            ratio = float(table[-1])
            worst = [0.0, 0.0, 0.0]
            for seed in seeds:
                R = cs.random_field(torch, torch.ones(
                    shape, dtype=torch.bool, device=dev), seed)
                got = const_sweep_strided(R, *vecs, table)
                want = const_sweep_strided_plain(R, *vecs)
                ref = const_sweep_strided_plain(R.double(), *v64)
                scale = float(want.abs().max()) * eps
                for j, d in enumerate((got - want, want.double() - ref,
                                       got.double() - ref)):
                    worst[j] = max(worst[j], float(d.abs().max()) / scale)
                del R, got, want, ref
            print(json.dumps(dict(
                kernel="K12", shape=label, dt_x=mult, seeds=len(seeds),
                ratio=ratio, thomas_order_here=ratio > stiff,
                ulp_vs_plain=round(worst[0], 3),
                plain_ulp_vs_f64=round(worst[1], 3),
                split_ulp_vs_f64=round(worst[2], 3))), flush=True)
            torch.cuda.empty_cache()


def record(cs, out, key, got, want, ms, tol):
    """``key``'s ms and its largest |delta| from the plain version (K, and
    float32 ulp of the output's scale against ``tol``)."""
    import torch
    eps = torch.finfo(torch.float32).eps
    err = float((got - want).abs().max())
    out[f"{key} ms"] = ms
    out[f"{key} max_abs_err"] = err
    out[f"{key} ulp_of_scale"] = err / (eps * float(want.abs().max()))
    out[f"{key} within_tol"] = err <= tol(want)
    out[f"{key} bitwise"] = bool(torch.equal(got, want))


def k9_crossover(torch, cs, dev, lengths, out):
    """K9 on tubes of phase 6's kind with r lines of each length, 512 phi
    rows and about 2^25 cells, at the step's dt: the median ms and the
    largest |delta| from the plain version."""
    from adi_thermal_fields_tpu_torch import Material
    from adi_thermal_fields_tpu_torch.solvers import (
        masked_sweep_strided, masked_sweep_strided_plain)
    from z_pencils_ab import k10_case

    f32 = torch.float32
    fac = float(torch.tensor(cs.CYL_DT, dtype=f32)
                * torch.tensor(Material(7800.0, 490.0, 54.0).alpha,
                               dtype=f32))
    eps = torch.finfo(f32).eps
    for n in lengths:
        shape = (n, 512, max(8, CROSSOVER_CELLS // (512 * n)))
        R, plan = k10_case(torch, cs, dev, f"{n} tube", shape, 5e-4, 0.02)
        fn = (lambda: masked_sweep_strided(R, *plan.r, fac, 20.0))
        record(cs, out, f"K9 n{n}", fn(),
               masked_sweep_strided_plain(R, *plan.r, fac, 20.0),
               cs.cuda_ms(torch, fn, 20),
               lambda w: cs.KERNEL_TOL_ULP * eps * float(w.abs().max()))
        del R, plan
        torch.cuda.empty_cache()


def k12_crossover(torch, cs, dev, lengths, out):
    """K12 with the step's table on annuli of phase 7's kind with r lines
    of each length, 512 phi rows and about 2^25 cells, at the step's dt,
    float32 and float64: the median ms and the largest |delta| from the
    plain version."""
    from adi_thermal_fields_tpu_torch import CylindricalGrid, RobinBC
    from adi_thermal_fields_tpu_torch.solvers import (
        const_sweep_strided, const_sweep_strided_plain)
    from adi_thermal_fields_tpu_torch.step import cylindrical as cyl

    for dtype in (torch.float32, torch.float64):
        eps = torch.finfo(dtype).eps
        for n in lengths:
            shape = (n, 512, max(8, CROSSOVER_CELLS // (512 * n)))
            grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
            _, mat, _, _ = cs.be_case("annular", shape)
            key = (grid, mat, RobinBC(300.0, 20.0), None, cs.P7_DT, dtype,
                   dev)
            vecs = cyl._r_coefficients(*key)
            table = cyl._r_table(*key)
            R = cs.random_field(torch, torch.ones(
                shape, dtype=torch.bool, device=dev), 23).to(dtype)
            fn = (lambda: const_sweep_strided(R, *vecs, table))
            record(cs, out, f"K12 {str(dtype)[6:]} n{n}", fn(),
                   const_sweep_strided_plain(R, *vecs),
                   cs.cuda_ms(torch, fn, 20),
                   lambda w: cs.KERNEL_TOL_ULP * eps * float(w.abs().max()))
            del R
            torch.cuda.empty_cache()


def k15_case(torch, cs, dev, label, shape, dr, r_inner, dt):
    """K15's arguments as the varprop BE step passes them (the rhs T
    itself) on a phase 8 configuration, and its rows (a, b, c) as the
    plain version forms them."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.bc.faces import shift_in
    from adi_thermal_fields_tpu_torch.solvers.vp2 import (_col, _faces_hi,
                                                          _open_films,
                                                          _scaled_rows)
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    kt, ct = cs.varprop_tables()
    grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape,
                                            torch.float32, dev, dr, r_inner)
    code = cvp.build_cyl_vp2_plan(mask, grid, zbc)[0]
    cols = cvp._vp2_columns(grid, zbc, torch.float32, dev)
    f = np.float32
    inv = float(f(1.0) / f(f(dt) / f(mat.rho)))
    r, r_imh, r_iph = cvp._radii(grid)
    films = dict(h_lo=80.0, h_hi=80.0, tinf=20.0, emissivity=cs.EMISSIVITY,
                 edge0=((50.0, r_imh[0] / (r[0] * grid.dr), 20.0)
                        if grid.is_annular else None),
                 edge1=(300.0, r_iph[-1] / (r[-1] * grid.dr), 20.0))
    glo, ghi, gsl, gsh = (cols[k] for k in ("glo_r", "ghi_r", "gsl_r",
                                            "gsh_r"))
    fhi = _faces_hi(T, code, kt, 0)
    sink, srhs = _open_films(T, code, gsl, gsh, 0, films["h_lo"],
                             films["h_hi"], films["tinf"],
                             films["emissivity"], films["edge0"],
                             films["edge1"])
    a, b, c, _ = _scaled_rows(T, T, ct, inv,
                              _col(glo, 0, 3) * shift_in(fhi, 0, -1,
                                                         fill=0.0),
                              _col(ghi, 0, 3) * fhi, sink, srhs)
    a[0] = 0.0
    c[-1] = 0.0
    rk = dict(k_spec=kt, cp_spec=ct, h_lo=80.0, h_hi=80.0, tinf_void=20.0,
              emissivity=cs.EMISSIVITY, edge0=films["edge0"],
              edge1=films["edge1"])
    return (None, T, code, glo, ghi, gsl, gsh, inv), rk, (a, b, c)


def k15_replays(torch, cs, dev):
    """K15's share of replayed blocks and its |delta| from the plain
    version."""
    import numpy as np
    from adi_thermal_fields_tpu_torch.solvers import (vp2_sweep_strided,
                                                      vp2_sweep_strided_plain)

    q = np.float32(12.0 / 13.0)                  # kK8Stiff = 12
    cases = [(cs.P8_SHAPES[0][:2], 5e-4, None, cs.P8_DT, "1x dt"),
             (cs.P8_SHAPES[0][:2], 5e-4, None, 10.0 * cs.P8_DT, "10x dt"),
             (cs.P8_SHAPES[1][:2], 5e-4, None, cs.P8_DT, "1x dt"),
             (("32x720x200 app tube", (32, 720, 200)), 2.5e-4, 0.052, 0.05,
              "the app's dt 0.05 s")]
    for (label, shape), dr, r_inner, dt, what in cases:
        args, rk, (a, b, c) = k15_case(torch, cs, dev, label, shape, dr,
                                       r_inner, dt)
        ratio = ((a.abs() + c.abs()) / (b - a.abs() - c.abs())).amax(0)
        stiff = ((a.abs() + c.abs()) > float(q) * b).any(0).reshape(-1)
        lines = stiff.numel()
        blocks = torch.cat([stiff, stiff.new_zeros(-lines % 32)]).view(
            -1, 32).any(1)
        got = vp2_sweep_strided(*args, **rk)
        want = vp2_sweep_strided_plain(*args, **rk)
        err = float((got - want).abs().max())
        print(json.dumps(dict(
            kernel="K15", shape=label, dt=what,
            replayed_block_share=float(blocks.float().mean()),
            stiff_line_share=float(stiff.float().mean()),
            max_row_ratio=float(ratio.max()), max_abs_err=err,
            ulp_of_scale=err / (torch.finfo(torch.float32).eps
                                * float(want.abs().max())))), flush=True)
        del args, a, b, c, got, want
        torch.cuda.empty_cache()


def k15_crossover(torch, cs, dev, lengths, out):
    """K15 (the rhs T) on phase 8 tubes of r lines of each length, 512 phi
    rows and about 2^25 cells, at the step's dt, and K15y at 512^3: the
    median ms and the largest |delta| from the plain version."""
    from adi_thermal_fields_tpu_torch.solvers import (vp2_sweep_strided,
                                                      vp2_sweep_strided_plain)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import cyl_be_ab

    def k15_record(key, got, want, ms):
        record(cs, out, key, got, want, ms,
               lambda w: cs.P8_TOL["float32"])

    for n in lengths:
        shape = (n, 512, max(8, CROSSOVER_CELLS // (512 * n)))
        label = f"{n}x512x{shape[2]} tube"
        args, rk, _ = k15_case(torch, cs, dev, label, shape, 5e-4, None,
                               cs.P8_DT)
        got = vp2_sweep_strided(*args, **rk)
        want = vp2_sweep_strided_plain(*args, **rk)
        k15_record(f"K15 n{n}", got, want,
                   cs.cuda_ms(torch, lambda: vp2_sweep_strided(*args, **rk),
                              20))
        del args, got, want
        torch.cuda.empty_cache()
    # K15y's 512-row y lines: cyl_be_ab's row and its error
    cyl_be_ab.k15y_row(torch, cs, dev, out, k15_record)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default="")
    p.add_argument("--crossover", default="")
    p.add_argument("--kernels", default="K9,K12,K13,K14,K15")
    p.add_argument("--seeds", default="17,23,31,47,59")
    p.add_argument("--dts", default="1,2.5,5,10")
    p.add_argument("--no-ratio", action="store_true")
    p.add_argument("--build", help=argparse.SUPPRESS)
    p.add_argument("--times", help=argparse.SUPPRESS)
    p.add_argument("--ratio", help=argparse.SUPPRESS)
    a = p.parse_args()
    crossover = [int(n) for n in a.crossover.split(",") if n]
    if a.build:
        build(a.build)
        return
    kernels = a.kernels.split(",")
    if a.times:
        times(a.times, crossover, kernels)
        return
    if a.ratio:
        import torch
        cs = load_cs(a.ratio)
        sys.path.insert(0, os.path.join(HERE, "scripts"))
        dev = torch.device("cuda", 0)
        seeds = [int(s) for s in a.seeds.split(",")]
        dts = [float(d) for d in a.dts.split(",")]
        if "K12" in kernels:
            k12_ratio(torch, cs, dev, seeds, dts,
                      source_constant(HERE, "kK12Stiff", "const_sweeps.cu"))
        if "K13" in kernels:
            k13_ratio(torch, cs, dev, seeds, dts,
                      source_constant(HERE, "kK13Stiff", "const_sweeps.cu"))
        if "K14" in kernels:
            k14_ratio(torch, cs, dev, seeds, dts,
                      source_constant(HERE, "kK14Stiff", "const_sweeps.cu"))
        if "K15" in kernels:
            k15_replays(torch, cs, dev)
        return
    variants = [[s for s in v.split(",") if s]
                for v in a.variants.split(";")] if a.variants else [[]]
    roots = [patched_copy(v) for v in variants]
    ratio_root = None if a.no_ratio else patched_copy(SPLIT_ALL)
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", r],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
              for r in roots + ([ratio_root] if ratio_root else [])]
    for v, proc in zip(variants + [SPLIT_ALL], builds):
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"build of {v}: exit {proc.returncode}\n{err}")
        print(json.dumps(dict(variant=v, **json.loads(
            out.strip().splitlines()[-1]))), flush=True)
    for v, r in zip(variants, roots):
        proc = subprocess.run([sys.executable, me, "--times", r,
                               "--crossover", a.crossover, "--kernels",
                               a.kernels], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"times of {v}: exit {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
        print(json.dumps(dict(variant=v, **json.loads(
            proc.stdout.strip().splitlines()[-1]))), flush=True)
    if ratio_root:
        proc = subprocess.run([sys.executable, me, "--ratio", ratio_root,
                               "--seeds", a.seeds, "--dts", a.dts,
                               "--kernels", a.kernels],
                              capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"ratio: exit {proc.returncode}\n"
                             f"{proc.stderr}")


if __name__ == "__main__":
    main()
