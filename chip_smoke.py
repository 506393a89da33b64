#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one CUDA card, through its four
hand-written kernels, and check every result.

    python3 chip_smoke.py        # from the root of a checkout; one card

Phases (each asserts; a failure exits non-zero and prints no result):

0. The card: CUDA must be available.  Prints the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
1. Build: compiles csrc/*.cu for sm_90a (ptxas register/spill report) and
   prints the build seconds.
2. Each kernel against its plain PyTorch version on the same CUDA tensors,
   float32, at 256^3 with a WAAM mask (plate, two walls, a deposited
   block), 256^3 with a random mask, and 97x203x131: max |delta| and the
   CUDA-event median time of kernel and plain version.
3. The full step at 512^3 float32 through make_cartesian_engine, kernels
   against reference after 3 steps, on three BC sets: plan-lite (scalar
   h: K4, K1, K2), __graft_entry__'s (scalar h + Neumann flux on z+: K3,
   K1 x3) and the same as per-face coefficient fields (K3, K1 x3).  After
   two warm-up steps each step is timed with CUDA events; prints the
   median ms/step and Gcell/s and checks each kernel's launch count.
4. The WAAM app on a 160x40x40 mm STL box at 0.5 mm (~2.5 M cells), 20
   layers of 3 s, 4 frames, float32, with the kernels and again with the
   reference step: T finite, every solid voxel active at the end,
   Tmax <= --Ts, and the two runs agree.

The line before the last is a JSON summary of the kernels (launches of the
main-path runs of phases 3 and 4); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "adi_thermal_fields_tpu_torch"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak

# Tolerances (float32; temperatures up to 1500 C, ulp there = 1.2e-4 K):
KERNEL_TOL_ULP = 8  # one kernel vs its plain version, in float32 ulp of the
#                     largest output (division vs reciprocal-multiply, FMA
#                     contraction; the stencil's R0 of a random field
#                     reaches ~9000 K)
STEP_TOL = 1e-2     # 3 full steps (3 sweeps + stencil each), ~80 ulp
APP_TOL = 0.5       # ~1700 sub-steps of ulp-level differences, which the
#                     diffusion does not fully damp: 0.03% of the range

# sizes: phase 2 kernel shapes, phase 3 step edge, phase 4 STL box and cell
P2_SHAPES = (("256^3 waam", (256, 256, 256)), ("256^3 random", (256,) * 3),
             ("97x203x131 random", (97, 203, 131)))
P3_N = 512
P3_WARMUP, P3_STEPS = 2, 3
P4_BOX_MM = (160.0, 40.0, 40.0)
P4_DX_MM = 0.5

KERNEL_INFO = {
    "K1": ("sweep_strided", "csrc/sweeps.cu",
           "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:686"),
    "K2": ("sweep_z", "csrc/sweeps.cu",
           "adi_thermal_fields_tpu/solvers/pallas_sweeps.py:950"),
    "K3": ("theta_rhs", "csrc/stencil.cu",
           "adi_thermal_fields_tpu/solvers/pallas_stencil.py:115"),
    "K4": ("fused_theta_sweep", "csrc/theta_sweep.cu",
           "adi_thermal_fields_tpu/solvers/pallas_theta_sweep.py:454"),
}


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def load_port():
    """Import torch and the port from this checkout, or fail."""
    if not os.path.isdir(os.path.join(HERE, PKG)):
        fail(f"the package {PKG}/ is not beside this script: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a "
             "CUDA card only")
    return torch


def cuda_ms(torch, fn, reps):
    """Median CUDA-event milliseconds of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def waam_mask(torch, shape, device):
    """A build plate, two deposited walls and a deposited block."""
    nx, ny, nz = shape
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    plate = nz // 4
    m[:, :, :plate] = True
    w = max(2, nx // 32)
    m[nx // 8:nx // 8 + w, :, plate:3 * nz // 4] = True
    m[7 * nx // 8 - w:7 * nx // 8, :, plate:3 * nz // 4] = True
    m[3 * nx // 8:5 * nx // 8, 3 * ny // 8:5 * ny // 8,
      plate:plate + nz // 8] = True
    return m


def random_field(torch, mask, seed):
    g = torch.Generator(device=mask.device).manual_seed(seed)
    r = torch.rand(mask.shape, generator=g, device=mask.device)
    return torch.where(mask, 20.0 + 1480.0 * r, 20.0).contiguous()


def phase0(torch):
    name = torch.cuda.get_device_name(0)
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    smi = proc.stdout.strip().splitlines()[0]
    print(f"[phase 0] card: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    return name, smi


def phase1():
    from adi_thermal_fields_tpu_torch.kernels import (build_library,
                                                      load_library)
    path, secs = build_library(verbose=True)
    load_library()
    print(f"[phase 1] built {os.path.relpath(path, HERE)} in {secs:.1f} s",
          flush=True)
    return secs


def phase2(torch, dev):
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              build_coeff_packs)
    from adi_thermal_fields_tpu_torch.solvers import (
        fused_theta_sweep, fused_theta_sweep_plain, sweep_code,
        sweep_strided, sweep_strided_plain, sweep_z, sweep_z_plain,
        theta_rhs, theta_rhs_plain)
    from adi_thermal_fields_tpu_torch.step.cartesian import step_scalars

    f32 = torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    rows = []
    for label, shape in P2_SHAPES:
        grid = CartesianGrid(*shape, 0.5e-3)
        dt = 2.0 * grid.dx ** 2 / mat.alpha          # the app's dt cap
        dt, inv_d2, tg, c_exp = step_scalars(f32, grid, mat, dt, 0.5)
        rc = [float(torch.tensor(30.0, dtype=f32)
                    * torch.tensor(1.0 / (mat.rho * mat.cp * d), dtype=f32))
              for d in grid.spacing]
        if label.endswith("waam"):
            mask = waam_mask(torch, shape, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(len(rows) + 1)
            mask = torch.rand(shape, generator=g, device=dev) > 0.25
        T = random_field(torch, mask, seed=7)
        dirm = torch.zeros_like(mask)
        dirm[:, :, 0] = mask[:, :, 0]
        pk = build_coeff_packs(mask, grid, mat, dtype=f32, robin_h=200.0,
                               neumann={"z+": 5e5}, dirichlet_mask=dirm,
                               dirichlet_value=20.0)

        def nat(axis, dm=None, **kw):
            return sweep_code(mask, dm, axis, **kw).movedim(0, axis) \
                .contiguous()

        c0, c1, c2 = nat(0), nat(1), nat(2)
        c0s = nat(0, stencil_bits=True)
        d0, d1 = nat(0, dirm), nat(1, dirm)
        m_u8 = mask.to(torch.uint8)
        fkw = [dict(coeff=pk.coeff[a], qflux=pk.qflux[a], dir_val=pk.dir_val)
               for a in (0, 1)]
        variants = [
            ("K1", "lite x", 9,
             lambda: sweep_strided(T, c0, tg[0], dt, 20.0, axis=0,
                                   rob_c=rc[0]),
             lambda: sweep_strided_plain(T, c0, tg[0], dt, 20.0, axis=0,
                                         rob_c=rc[0])),
            ("K1", "lite y", 9,
             lambda: sweep_strided(T, c1, tg[1], dt, 20.0, axis=1,
                                   rob_c=rc[1]),
             lambda: sweep_strided_plain(T, c1, tg[1], dt, 20.0, axis=1,
                                         rob_c=rc[1])),
            ("K1", "field+neumann+dirichlet x", 21,
             lambda: sweep_strided(T, d0, tg[0], dt, 20.0, axis=0, **fkw[0]),
             lambda: sweep_strided_plain(T, d0, tg[0], dt, 20.0, axis=0,
                                         **fkw[0])),
            ("K1", "field+neumann+dirichlet y", 21,
             lambda: sweep_strided(T, d1, tg[1], dt, 20.0, axis=1, **fkw[1]),
             lambda: sweep_strided_plain(T, d1, tg[1], dt, 20.0, axis=1,
                                         **fkw[1])),
            ("K2", "lite z", 9,
             lambda: sweep_z(T, c2, tg[2], dt, 20.0, rc[2]),
             lambda: sweep_z_plain(T, c2, tg[2], dt, 20.0, rc[2])),
            ("K3", "stencil", 9,
             lambda: theta_rhs(T, m_u8, c_exp, inv_d2),
             lambda: theta_rhs_plain(T, m_u8, c_exp, inv_d2)),
            ("K4", "stencil + lite x", 9,
             lambda: fused_theta_sweep(T, c0s, c_exp, inv_d2, tg[0], dt,
                                       20.0, rc[0]),
             lambda: fused_theta_sweep_plain(T, c0s, c_exp, inv_d2, tg[0],
                                             dt, 20.0, rc[0])),
        ]
        cells = mask.numel()
        for kname, vname, bpc, kern, plain in variants:
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()),
                  f"{kname} {vname} {label}: non-finite output")
            err = float((got - want).abs().max())
            tol = KERNEL_TOL_ULP * torch.finfo(f32).eps * max(
                1.0, float(want.abs().max()))
            ms = cuda_ms(torch, kern, 20)
            plain_ms = cuda_ms(torch, plain, 3)
            pct = 100.0 * cells * bpc / (ms * 1e-3) / HBM_BYTES_PER_S
            rows.append(dict(kernel=kname, variant=vname, shape=label,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bytes_per_cell=bpc, pct_hbm=pct))
            print(f"[phase 2] {kname} {vname:32s} {label:18s} "
                  f"max|d|={err:.3e} K (tol {tol:.1e})  kernel "
                  f"{ms:8.3f} ms  plain {plain_ms:9.3f} ms  {pct:5.1f}% of "
                  f"3.35 TB/s at {bpc} B/cell", flush=True)
            check(err <= tol, f"{kname} {vname} {label}: max|d| "
                  f"{err:.3e} K > {tol:.3e} K")
        del T, mask, pk
        torch.cuda.empty_cache()
    return rows


def phase3(torch, dev):
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.bc.faces import FACES
    from adi_thermal_fields_tpu_torch.solvers import launch_counts

    n = P3_N
    grid = CartesianGrid(n, n, n, 0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    mask = waam_mask(torch, grid.shape, dev)
    T0 = random_field(torch, mask, seed=11)
    unfused = {"K1": 3, "K2": 0, "K3": 1, "K4": 0}
    plans = {
        "lite (scalar h=30)": (dict(robin_h=30.0),
                               {"K1": 1, "K2": 1, "K3": 0, "K4": 1}),
        # __graft_entry__'s BC set: scalar h, so K1 runs plan-lite with
        # the Neumann fold
        "entry (h=200, q''=5e5 on z+)": (
            dict(robin_h=200.0, neumann={"z+": 5e5}), unfused),
        # the same physics through coefficient fields
        "field (h=200 per-face fields, q''=5e5 on z+)": (
            dict(robin_h={f: 200.0 for f in FACES}, neumann={"z+": 5e5}),
            unfused),
    }
    out = {}
    for pname, (bcs, per_step) in plans.items():
        res = {}
        for impl in ("kernels", "reference"):
            prepare, advance = make_cartesian_engine(
                grid, mat, implementation=impl, device=dev,
                dtype=torch.float32, theta=0.5, t_inf=20.0, **bcs)
            prep = prepare(mask)
            before = launch_counts()
            # warm-up: two steps reach the allocator's steady state (the
            # second step holds one more field than the first)
            advance(T0, prep, dt, P3_WARMUP, 0.0)
            torch.cuda.synchronize()
            T, step_ms = T0, []
            for i in range(P3_STEPS):          # each step timed on its own
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                T = advance(T, prep, dt, 1, i * dt)
                end.record()
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
            ms = statistics.median(step_ms)
            delta = {k: v - before[k] for k, v in launch_counts().items()}
            want = ({k: (P3_WARMUP + P3_STEPS) * v
                     for k, v in per_step.items()}
                    if impl == "kernels" else {k: 0 for k in per_step})
            check(delta == want, f"phase 3 {pname} {impl}: launches "
                  f"{delta} != expected {want}")
            check(bool(torch.isfinite(T).all()),
                  f"phase 3 {pname} {impl}: non-finite T")
            gcells = grid.ncells / (ms * 1e-3) / 1e9
            res[impl] = (T, ms)
            print(f"[phase 3] {n}^3 f32 {pname} {impl:9s}: "
                  f"{ms:9.3f} ms/step (median; steps "
                  f"{', '.join(f'{s:.3f}' for s in step_ms)})  "
                  f"{gcells:7.3f} Gcell/s  launches {delta}", flush=True)
        err = float((res["kernels"][0] - res["reference"][0]).abs().max())
        print(f"[phase 3] {pname}: max|T_kernels - T_reference| = "
              f"{err:.3e} K after {P3_STEPS} steps", flush=True)
        check(err <= STEP_TOL, f"phase 3 {pname}: {err:.3e} K > {STEP_TOL}")
        out[pname] = dict(ms_kernels=res["kernels"][1],
                          ms_reference=res["reference"][1], max_abs_err=err)
        del res
        torch.cuda.empty_cache()
    return out


def phase4(torch, dev):
    from adi_thermal_fields_tpu_torch.apps import waam_from_stl as app
    from adi_thermal_fields_tpu_torch.geometry.primitives import box_mesh
    from adi_thermal_fields_tpu_torch.geometry.stl import save_stl_binary

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    stl = os.path.join(work, "bar.stl")
    save_stl_binary(stl, box_mesh(size=P4_BOX_MM,
                                  center=tuple(v / 2 for v in P4_BOX_MM)))
    argv = ["--stl", stl, "--dx_mm", str(P4_DX_MM), "--nframes", "4",
            "--layer_times_s", ",".join(["3"] * 20), "--precision",
            "float32", "--device", str(dev)]
    runs = {}
    for impl in ("kernels", "reference"):
        args = app.build_argparser().parse_args(
            argv + ["--implementation", impl])
        t0 = time.perf_counter()
        res = app.run(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[impl] = (res, wall)
        T, active = res["T"], res["active"]
        tmax = float(T[active].max())
        print(f"[phase 4] app {impl:9s}: grid {res['grid'].shape} "
              f"({res['grid'].ncells / 1e6:.2f} M cells), "
              f"{len(res['layers'])} layers, {res['substeps']} sub-steps, "
              f"wall {wall:.2f} s, Tmax {tmax:.2f} C", flush=True)
        check(len(res["layers"]) == 20, f"{len(res['layers'])} layers != 20")
        check(bool(torch.isfinite(T).all()), f"app {impl}: non-finite T")
        check(tmax <= args.Ts, f"app {impl}: Tmax {tmax} > Ts {args.Ts}")
        check(all(m <= args.Ts for _, _, m in res["frames"]),
              f"app {impl}: a frame's Tmax exceeds Ts")
    _, solid, _, _ = app.load_voxels(args)
    for impl, (res, _) in runs.items():
        check(bool((res["active"].cpu().numpy() == solid).all()),
              f"app {impl}: the active set at the end is not the solid")
    err = float((runs["kernels"][0]["T"]
                 - runs["reference"][0]["T"]).abs().max())
    print(f"[phase 4] max|T_kernels - T_reference| = {err:.3e} K",
          flush=True)
    check(err <= APP_TOL, f"app: kernels vs reference {err:.3e} K > "
          f"{APP_TOL} K")
    return dict(wall_kernels=runs["kernels"][1],
                wall_reference=runs["reference"][1],
                substeps=runs["kernels"][0]["substeps"], max_abs_err=err)


def main():
    torch = load_port()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, _ = phase0(torch)
    phase1()
    rows = phase2(torch, dev)

    from adi_thermal_fields_tpu_torch.solvers import (launch_counts,
                                                      reset_launch_counts)
    reset_launch_counts()          # phase 2's comparison launches excluded
    phase3(torch, dev)
    phase4(torch, dev)
    counts = launch_counts()
    check(all(counts[k] > 0 for k in KERNEL_INFO),
          f"a kernel of the main path never launched: {counts}")

    main_variant = {"K1": "lite y", "K2": "lite z", "K3": "stencil",
                    "K4": "stencil + lite x"}
    summary = []
    for k, (fn, src, replaces) in KERNEL_INFO.items():
        mine = [r for r in rows if r["kernel"] == k]
        ref = next(r for r in mine if r["variant"] == main_variant[k]
                   and r["shape"] == P2_SHAPES[0][0])
        summary.append({"name": f"{k} {fn}", "route": "cuda",
                        "source": f"{PKG}/{src}", "replaces": replaces,
                        "launches": counts[k],
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": ref["ms"], "plain_ms": ref["plain_ms"]})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
