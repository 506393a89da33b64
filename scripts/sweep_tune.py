#!/usr/bin/env python3
"""K1 and K2 (the split-line masked sweeps, csrc/sweeps.cu) on one CUDA
card: their register and spill report, a check against the plain versions
over odd shapes and every entry, and their times.

    python3 scripts/sweep_tune.py

Prints one line per case; the full ptxas report goes to
build/torch_kernels/ptxas_report.txt.  Times: CUDA-event medians at
chip_smoke.py's 256^3 and 512^3 WAAM masks and on 8192-row lines with
random masks (8192x64x64 along x: K1's reduced rows in global memory;
64x64x8192 along z: K2 with every field on K1's kernel), float32, with
the share of 3.35 TB/s under each variant's byte model.  The launch
shapes are the constants kK1Warps and kK2Lines in csrc/sweeps.cu: to time
another, edit them and run this again.
"""
import contextlib
import importlib.util
import io
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def ptxas_report(build_library, build_dir):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        build_library(verbose=True)
    text = buf.getvalue()
    (build_dir() / "ptxas_report.txt").write_text(text)
    for part in text.split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        if "sweep_strided_kernel" not in name and "sweep_z_kernel" not in name:
            continue
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          part)
        print(f"ptxas {name[:90]}: {regs.group(1) if regs else '?'} regs, "
              f"spills {spill.groups() if spill else '?'}", flush=True)


def main():
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adi_thermal_fields_tpu_torch.kernels.build import (build_dir,
                                                            build_library)
    from adi_thermal_fields_tpu_torch.solvers.sweeps import (
        sweep_code, sweep_strided, sweep_strided_plain, sweep_z,
        sweep_z_plain)

    if not torch.cuda.is_available():
        raise SystemExit("sweep_tune: no CUDA card")
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    ptxas_report(build_library, build_dir)
    tg, dt, tinf, rob = 0.21, 0.05, 20.0, 0.0031

    def case(shape, seed, dtype, mask=None):
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = (lambda: torch.rand(shape, generator=g, device=dev))
        if mask is None:
            mask = rnd() > 0.25
        dirm = (rnd() > 0.85) & mask
        T = torch.where(mask, 20.0 + 1480.0 * rnd(), 20.0).to(dtype)
        flds = dict(coeff=torch.where(mask & (rnd() > 0.5), 0.3, 0.0),
                    qflux=rnd() * 50.0 * mask,
                    dir_val=500.0 + 500.0 * rnd())
        return mask, dirm, T, {k: v.to(dtype) for k, v in flds.items()}

    def nat(mask, dm, axis):
        return sweep_code(mask, dm, axis).movedim(0, axis).contiguous()

    worst = 0.0
    shapes = [(37, 45, 70), (97, 203, 131), (5, 3, 7), (3, 2, 1),
              (40, 33, 1030), (1100, 6, 5), (64, 64, 256)]
    for shape in shapes:
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            mask, dirm, T, fl = case(shape, 3, dtype)
            calls = []
            for axis in (0, 1):
                c_lite, c_pin = nat(mask, None, axis), nat(mask, dirm, axis)
                calls += [
                    (f"K1 lite {'xy'[axis]}", sweep_strided,
                     sweep_strided_plain, (T, c_lite, tg, dt, tinf),
                     dict(axis=axis, rob_c=rob)),
                    (f"K1 field+neu+dir {'xy'[axis]}", sweep_strided,
                     sweep_strided_plain, (T, c_pin, tg, dt, tinf),
                     dict(axis=axis, **fl)),
                    (f"K1 lite+neu {'xy'[axis]}", sweep_strided,
                     sweep_strided_plain, (T, c_lite, tg, dt, tinf),
                     dict(axis=axis, rob_c=rob, qflux=fl["qflux"])),
                ]
                if dtype != torch.bfloat16:
                    calls.append((f"K1v1 {'xy'[axis]}", sweep_strided,
                                  sweep_strided_plain,
                                  (T, c_pin, tg, dt, tinf),
                                  dict(axis=axis, coeff=fl["coeff"],
                                       pin_from_code=True)))
            c2, c2p = nat(mask, None, 2), nat(mask, dirm, 2)
            calls += [
                ("K2 lite z", sweep_z, sweep_z_plain,
                 (T, c2, tg, dt, tinf, rob), {}),
                ("K2 lite+neu z", sweep_z, sweep_z_plain,
                 (T, c2, tg, dt, tinf, rob), dict(qflux=fl["qflux"])),
                ("K2 field+neu+dir z", sweep_z, sweep_z_plain,
                 (T, c2p, tg, dt, tinf), fl),
            ]
            zxy = (lambda t: t.permute(2, 0, 1).contiguous())
            calls.append(("K1 zxy field", sweep_strided, sweep_strided_plain,
                          (zxy(T), sweep_code(mask, dirm, 2), tg, dt, tinf),
                          dict(axis=0, zxy=True,
                               **{k: zxy(v) for k, v in fl.items()})))
            for seed in ((None, 7) if dtype == torch.bfloat16 else (None,)):
                for name, kern, plain, args, kw in calls:
                    got = kern(*args, **kw, rng_seed=seed)
                    want = plain(*args, **kw, rng_seed=seed)
                    torch.cuda.synchronize()
                    err = float((got.double() - want.double()).abs().max())
                    scale = max(1.0, float(want.double().abs().max()))
                    eps = (2.0 ** -7 if dtype == torch.bfloat16
                           else torch.finfo(dtype).eps)
                    ulps = err / (eps * scale)
                    if dtype == torch.float32:
                        worst = max(worst, ulps)
                    bad = ulps > (1.0 if dtype == torch.bfloat16 else 8.0)
                    if bad or shape == shapes[0]:
                        print(f"{'FAIL ' if bad else ''}{name:22s} {shape} "
                              f"{str(dtype)[6:]:8s} seed {seed}: {ulps:.3f} "
                              "ulp of scale", flush=True)
    print(f"check done: worst float32 {worst:.3f} ulp of scale", flush=True)

    # the WAAM masks, then 8192-row lines (K1's reduced rows in global
    # memory; K2 with every field on K1's kernel)
    for label, shape in (("256^3", (256,) * 3), ("512^3", (512,) * 3),
                         ("8192x64x64", (8192, 64, 64)),
                         ("64x64x8192", (64, 64, 8192))):
        waam = shape[0] == shape[2]
        mask = cs.waam_mask(torch, shape, dev) if waam else None
        mask, dirm, T, fl = case(shape, 5, torch.float32, mask)
        cells = T.numel()
        c1, c2 = nat(mask, None, 1), nat(mask, None, 2)
        rows = []
        if shape[2] <= 512:
            c0, d0 = nat(mask, None, 0), nat(mask, dirm, 0)
            rows += [
                ("K1", "lite x", 9, lambda: sweep_strided(
                    T, c0, tg, dt, tinf, axis=0, rob_c=rob)),
                ("K1", "field+neu+dir x", 21, lambda: sweep_strided(
                    T, d0, tg, dt, tinf, axis=0, **fl))]
        if waam:
            rows.append(("K1", "lite y", 9, lambda: sweep_strided(
                T, c1, tg, dt, tinf, axis=1, rob_c=rob)))
        if shape[0] <= 512:
            d2 = nat(mask, dirm, 2)
            rows += [
                ("K2", "lite z", 9, lambda: sweep_z(T, c2, tg, dt, tinf,
                                                    rob)),
                ("K2", "field+neu+dir z", 21, lambda: sweep_z(
                    T, d2, tg, dt, tinf, **fl))]
        for kname, vname, bpc, fn in rows:
            ms = cs.cuda_ms(torch, fn, 20)
            pct = 100.0 * cells * bpc / (ms * 1e-3) / cs.HBM_BYTES_PER_S
            print(f"{kname} {vname:16s} {label}: {ms:.4f} ms, {pct:.1f}% of "
                  f"its {bpc} B/cell bound", flush=True)
        del T, mask, fl
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
