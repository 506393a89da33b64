"""The bfloat16 entries of K5, K6 and K7 (K5b: csrc/varprop_fields.cu; K6b,
K7xb, K7b: csrc/varprop_sweeps.cu with the row formers of
csrc/vp_rows.cuh), and the float32 K5, in several source variants, on
one H100 card, at bench.py run_corrected's N^3 (its mask and per-face
film streams, T through the mushy interval, chip_smoke.py phase 2's
tables), seeded as the step rounds them.

Each variant is a copy of csrc/ with text substitutions, its
varprop_sweeps.cu and varprop_fields.cu built into a library of its own
(plain C entry points, the package's signatures) and called through
ctypes on the same tensors; the variants run in turns (A B ... B A),
CUDA-event medians, each held to its plain version (one bfloat16 ulp of
the output's scale; the float32 K5's distance in float32 ulp of scale
printed).  The float32 kernels of the first variant run on the bfloat16
cases' inputs widened.

    python scripts/vp_bf16_ab.py [--n 384] [--cases K6b,K7b]
        [--variants 'as is,K5 on _rn']
    python scripts/vp_bf16_ab.py --n 512 --cases K5 \
        --variants 'as is,K5 on _rn'

Variants: "as is" (K5b takes two cells of a z row a thread, K6b reads two
rows a load, K6b, K7b and K7xb run 16 warps, two blocks an SM), "32
warps" (one block of 32 warps an SM), "singles" (K5b one cell a thread,
K6b one row a load), "singles, 32 warps" and "K5 on _rn" (K5 and K5b on
the one-rounding-per-operation helpers `clamp_sum_rn`, `harm_rn`,
`rad_film_rn` of csrc/varprop.cuh, the film's `+ hconv` as `atf::add`,
where the sources use the contracted ones).  The sources that took K7b's
rows two a load (ld_pair, since removed) ran K7b at 1.01 ms and K7xb at
1.02 with 32 warps, 0.94 and 0.96 with 16 (PERF.md section 6).
"""
import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from adi_thermal_fields_tpu_torch import (  # noqa: E402
    CartesianGrid, apparent_cp, build_varprop_codes, melt_pool_enhanced_k)
from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (  # noqa
    build_face_h_axes)
from adi_thermal_fields_tpu_torch.bc.radiation import radiative_h  # noqa
from adi_thermal_fields_tpu_torch.kernels import dtype_code  # noqa: E402
from adi_thermal_fields_tpu_torch.kernels.build import (  # noqa: E402
    NVCC_FLAGS, _SIGNATURES, find_nvcc)
from adi_thermal_fields_tpu_torch.solvers import (  # noqa: E402
    varprop_fields_plain, varprop_sweep_x_plain, varprop_sweep_y_plain,
    varprop_theta_sweep_plain)
from adi_thermal_fields_tpu_torch.solvers.rounding import sr_key  # noqa
from adi_thermal_fields_tpu_torch.solvers.varprop import (  # noqa: E402
    _rad_scalars, _table_arg)

DT, SEED, REPS = 0.02, 12345, 20
CSRC = os.path.join(HERE, "adi_thermal_fields_tpu_torch", "csrc")
SINGLES = [("varprop_sweeps.cu",
            "if constexpr (sizeof(S) == 2 && M % 2 == 0)",
            "if constexpr (false)"),
           ("varprop_fields.cu", "if (nz % 2 == 0 && word(Tf)",
            "if (false && word(Tf)")]
WARPS32 = [(f, "sizeof(S) == 2 ? 16 : kSplitWarps<C>", "kSplitWarps<C>")
           for f in ("vp_rows.cuh", "varprop_sweeps.cu")] \
    + [(f, "sizeof(S) == 2 ? 2 : 1", "1")
       for f in ("vp_rows.cuh", "varprop_sweeps.cu")]
RN = [("varprop_fields.cu", "atf::clamp_sum(", "atf::clamp_sum_rn("),
      ("varprop_fields.cu", "atf::harm(", "atf::harm_rn(")] \
    + [("varprop_fields.cu", f"atf::rad_film({t}, rc, tik, tik2) + hconv",
        f"atf::add(atf::rad_film_rn({t}, rc, tik, tik2), hconv)")
       for t in ("t", "t.x", "t.y")]
VARIANTS = {"as is": [], "32 warps": WARPS32, "singles": SINGLES,
            "singles, 32 warps": SINGLES + WARPS32, "K5 on _rn": RN}


def build_all(work, names):
    """Each named variant's varprop_sweeps.cu and varprop_fields.cu as a
    library, built at once (every substitution must match)."""
    nvcc = find_nvcc()
    jobs = {}
    for i, name in enumerate(names):
        subs = VARIANTS[name]
        src = os.path.join(work, f"v{i}")
        shutil.copytree(CSRC, src)
        for fname, old, new in subs:
            path = os.path.join(src, fname)
            text = open(path).read()
            assert old in text, (name, fname, old)
            open(path, "w").write(text.replace(old, new))
        lib = os.path.join(work, f"libv{i}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-I", src, "-o", lib,
               *(os.path.join(src, f) for f in ("varprop_sweeps.cu",
                                                "varprop_fields.cu"))]
        jobs[name] = (lib, subprocess.Popen(cmd))
    libs = {}
    for name, (lib, proc) in jobs.items():
        assert proc.wait() == 0, name
        so = ctypes.CDLL(lib)
        fns = {}
        for entry in ("atf_varprop_theta_sweep",
                      "atf_varprop_sweep_strided", "atf_varprop_fields"):
            fn = getattr(so, entry)
            fn.argtypes, fn.restype = _SIGNATURES[entry]
            fns[entry] = fn
        libs[name] = fns
    return libs


def ulps(got, want):
    """|got - want| at most, in ulps of the output's scale at its type."""
    scale = float(want.float().abs().max())
    if want.dtype == torch.bfloat16:
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    else:
        ulp = torch.finfo(torch.float32).eps * scale
    return float((got.float() - want.float()).abs().max()) / ulp


def median_ms(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=384, help="the cube's edge")
    ap.add_argument("--cases", default="", help="comma-separated heads of "
                    "the cases to time (default: all)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variant names")
    args = ap.parse_args()
    N = args.n
    names = args.variants.split(",")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    work = os.path.join(HERE, "build", "vp_bf16_ab")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    libs = build_all(work, names)
    grid = CartesianGrid(N, N, N, 1e-3)
    f = np.float32
    dt = f(DT)
    inv_d2 = [1.0 / (d * d) for d in grid.spacing]
    cw = float(f(0.5) * dt)
    tg = [float(f(0.5) * dt * f(iv)) for iv in inv_d2]
    sk = [float(dt / f(d)) for d in grid.spacing]
    # bench.py run_corrected: the plate and block mask, per-face h fields
    # and radiation scales (chip_smoke.py corrected_fields)
    mask = torch.ones(grid.shape, dtype=torch.bool, device=dev)
    z = 3 * N // 4
    mask[:, :, z:] = False
    mask[N // 4:3 * N // 4, N // 4:3 * N // 4, z:z + N // 8] = True
    rng = np.random.default_rng(5)
    cuda = (lambda a: torch.from_numpy(a).to(dev, torch.float32))
    faces = ("x-", "x+", "y-", "y+", "z-", "z+")
    hf = {fc: cuda(10.0 + 10.0 * rng.random(grid.shape)) for fc in faces}
    sc = {fc: cuda(0.7 + 0.6 * rng.random(grid.shape)) for fc in faces}
    g = torch.Generator(device=dev).manual_seed(7)
    T = torch.where(mask, 20.0 + 1480.0 * torch.rand(
        grid.shape, generator=g, device=dev), 20.0)
    T.view(-1)[::97] = 1420.0
    T.view(-1)[31::101] = 1470.0
    g = torch.Generator(device=dev).manual_seed(13)
    R = torch.where(mask, 20.0 + 1480.0 * torch.rand(
        grid.shape, generator=g, device=dev), 20.0)
    bf = torch.bfloat16
    T, R = T.to(bf), R.to(bf)
    kt = melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0)
    ct = apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0)
    fc, w = varprop_fields_plain(T, mask.to(torch.uint8), k_spec=kt,
                                 cp_spec=ct, rho=7800.0)
    h_ab = build_face_h_axes(mask, hf, sc, dtype=torch.float32)
    h_rad = radiative_h(T, 0.5, 20.0, h_conv=0.0)
    hs = [(A + h_rad * B).to(bf) for A, B in h_ab]
    del hf, sc, h_ab, h_rad
    codes = build_varprop_codes(mask)
    stream = torch.cuda.current_stream().cuda_stream
    p = (lambda t: t.data_ptr())

    def k6(fns, d):
        out = torch.empty_like(d[0])
        key = sr_key(SEED, 1) if d[0].dtype == bf else -1
        err = fns["atf_varprop_theta_sweep"](
            dtype_code(d[0].dtype), 0, p(d[0]), p(codes[0]),
            *(p(x) for x in d[1:5]), p(d[5]), None, p(out), N, N, N, cw,
            float(dt), *inv_d2, tg[0], sk[0], 20.0, 0.0, key, stream)
        assert err == 0, err
        return out

    def k7(fns, d, ax):
        out = torch.empty_like(d[0])
        key = sr_key(SEED, ax + 1) if d[0].dtype == bf else -1
        dims = (1, N, N * N) if ax == 0 else (N, N, N)
        err = fns["atf_varprop_sweep_strided"](
            dtype_code(d[0].dtype), 0, p(d[0]), p(codes[ax]), p(d[1]),
            p(d[2]), p(d[3]), p(out), *dims, tg[ax], sk[ax], 20.0, 0.0, key,
            stream)
        assert err == 0, err
        return out

    ktab, kn = _table_arg(kt)
    ctab, cn = _table_arg(ct)
    rc, tik, tik2 = _rad_scalars(0.5, 20.0, torch.float32)
    m8 = mask.to(torch.uint8)

    def k5(fns, d, rad=True):
        outs = [torch.empty_like(d[0]) for _ in range(5)]
        err = fns["atf_varprop_fields"](
            dtype_code(d[0].dtype), 0, p(d[0]), p(m8),
            *(p(o) for o in outs[:4]), p(outs[4]) if rad else None, N, N, N,
            ktab, kn, ctab, cn, 7800.0,
            *((rc, tik, tik2, 30.0) if rad else (0.0,) * 4), stream)
        assert err == 0, err
        return outs if rad else outs[:4]

    def k5_plain(T, rad):
        fcs, ww, *h = varprop_fields_plain(
            T, m8, k_spec=kt, cp_spec=ct, rho=7800.0,
            rad=(0.5, 20.0, 30.0) if rad else None)
        return [*fcs, ww, *h]

    T32 = T.float()
    cases = {
        "K5 fields, float32": (lambda fns, d: k5(fns, d, False), (T32,),
                               lambda: k5_plain(T32, False)),
        "K5 fields + rad, float32": (lambda fns, d: k5(fns, d), (T32,),
                                     lambda: k5_plain(T32, True)),
        "K5b fields + rad": (lambda fns, d: k5(fns, d), (T,),
                             lambda: k5_plain(T, True)),
        "K6b theta + x": (lambda fns, d: k6(fns, d),
                          (T, *fc, w, hs[0]),
                          lambda: varprop_theta_sweep_plain(
                              T, codes[0], *fc, w, cw, inv_d2, tg[0], sk[0],
                              20.0, h=hs[0], rng_seed=SEED, rng_offset=1)),
        "K7xb x": (lambda fns, d: k7(fns, d, 0), (R, fc[0], w, hs[0]),
                   lambda: varprop_sweep_x_plain(
                       R, codes[0], fc[0], w, tg[0], sk[0], 20.0, h=hs[0],
                       rng_seed=SEED, rng_offset=1)),
        "K7b y": (lambda fns, d: k7(fns, d, 1), (R, fc[1], w, hs[1]),
                  lambda: varprop_sweep_y_plain(
                      R, codes[1], fc[1], w, tg[1], sk[1], 20.0, h=hs[1],
                      rng_seed=SEED, rng_offset=2))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[vp_bf16_ab] {smi}; {N}^3 run_corrected, seeded", flush=True)
    heads = [c for c in args.cases.split(",") if c]
    for case, (call, data, plain) in cases.items():
        if heads and not any(case.startswith(h) for h in heads):
            continue
        listed = (lambda o: o if isinstance(o, list) else [o])
        want = listed(plain())
        dist = {}
        for name in names:
            got = listed(call(libs[name], data))
            dist[name] = max(ulps(a, b) for a, b in zip(got, want))
            assert data[0].dtype != torch.bfloat16 or dist[name] <= 1.0, \
                (case, name, dist[name])
            if data[0].dtype == torch.float32:
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                dist[name] = (f"{dist[name]:.2f} f32 ulp of scale, bit for "
                              f"bit: {same}")
        res = {name: [] for name in names}
        for name in names + names[::-1]:
            res[name].append(median_ms(lambda: call(libs[name], data)))
        f32 = ""
        if data[0].dtype == torch.bfloat16:
            wide = tuple(x.float() for x in data)
            ms32 = median_ms(lambda: call(libs[names[0]], wide))
            f32 = f"; float32 {ms32:.3f} ms"
            del wide
        print(f"[vp_bf16_ab] {case}: " + "; ".join(
            f"{name} {v[0]:.3f} / {v[1]:.3f}" for name, v in res.items())
              + f" ms{f32}", flush=True)
        if data[0].dtype == torch.float32:
            print(f"[vp_bf16_ab] {case} against its plain version: "
                  + "; ".join(f"{k} {v}" for k, v in dist.items()),
                  flush=True)
        del want, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
