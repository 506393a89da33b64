#!/usr/bin/env python3
"""A/B of K1 and K2 (the masked sweeps, ``sweep_strided`` and ``sweep_z``),
K3 and K4 (the theta-pass stencil ``theta_rhs`` and the stencil fused into
the plan-lite x sweep, ``fused_theta_sweep``), the field plan's z pass and
the constant-property WAAM steps, with K15 (the tier-2 sweep along
cylindrical r, ``vp2_sweep_strided``) beside them, between two checkouts of
the PyTorch port, on one CUDA card.

    python3 scripts/sweep_rows_ab.py OTHER_CHECKOUT

runs, in turns, OTHER, this checkout, this checkout, OTHER, each in its
own process (each builds its own kernel library), and prints one JSON line
per run: CUDA-event medians, float32, at chip_smoke.py's 256^3 and 512^3
WAAM masks of K1 (plan-lite y; the entry plan's x, plan-lite with the
Neumann field; the field plan's x with Neumann and Dirichlet), K2
(plan-lite z), K3 and K4 (float32, and their bfloat16 entries K3b and K4b
at 256^3, stochastically rounded as the bf16 engine stores), the field
plan's z pass (where ``sweep_z`` takes no fields:
permute to (z, x, y), K1, permute back; else K2 on the natural layout),
K15 at phase 8's 64x512x1024 tube, and chip_smoke.py phase 3's three
512^3 steps (plan-lite, entry, per-face field) in ms/step, each with its
device time per kernel and their sum (busy ms) from torch.profiler over
three steps, and the idle share 1 - busy / (CUDA-event ms/step).
"""
import importlib.util
import inspect
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_WARMUP, STEP_REPS = 2, 5


def sweep_rows(torch, cs, dev, n, out):
    """K1-K4 and the field plan's z pass at the n^3 WAAM mask."""
    from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                              build_coeff_packs)
    from adi_thermal_fields_tpu_torch.solvers import (fused_theta_sweep,
                                                      sweep_code,
                                                      sweep_strided, sweep_z,
                                                      theta_rhs)
    from adi_thermal_fields_tpu_torch.step.cartesian import step_scalars

    f32 = torch.float32
    mat = Material(7800.0, 490.0, 54.0)
    grid = CartesianGrid(n, n, n, 0.5e-3)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    dt, inv_d2, tg, c_exp = step_scalars(f32, grid, mat, dt, 0.5)
    rc = float(torch.tensor(30.0, dtype=f32)
               * torch.tensor(1.0 / (mat.rho * mat.cp * grid.dy), dtype=f32))
    mask = cs.waam_mask(torch, grid.shape, dev)
    T = cs.random_field(torch, mask, seed=7)
    dirm = torch.zeros_like(mask)
    dirm[:, :, 0] = mask[:, :, 0]
    pk = build_coeff_packs(mask, grid, mat, dtype=f32, robin_h=200.0,
                           neumann={"z+": 5e5}, dirichlet_mask=dirm,
                           dirichlet_value=20.0)
    c0 = sweep_code(mask, None, 0)
    c1 = sweep_code(mask, None, 1).movedim(0, 1).contiguous()
    c2 = sweep_code(mask, None, 2).movedim(0, 2).contiguous()
    d0 = sweep_code(mask, dirm, 0)
    dz = sweep_code(mask, dirm, 2)                 # (z, x, y)
    fz = dict(coeff=pk.coeff[2], qflux=pk.qflux[2], dir_val=pk.dir_val)
    tag = f"{n}^3"
    out[f"K1_lite_y_ms {tag}"] = cs.cuda_ms(torch, lambda: sweep_strided(
        T, c1, tg[1], dt, 20.0, axis=1, rob_c=rc), 30)
    out[f"K1_entry_x_ms {tag}"] = cs.cuda_ms(torch, lambda: sweep_strided(
        T, c0, tg[0], dt, 20.0, axis=0, rob_c=rc, qflux=pk.qflux[0]), 30)
    out[f"K1_field_x_ms {tag}"] = cs.cuda_ms(torch, lambda: sweep_strided(
        T, d0, tg[0], dt, 20.0, axis=0, coeff=pk.coeff[0],
        qflux=pk.qflux[0], dir_val=pk.dir_val), 30)
    out[f"K2_lite_z_ms {tag}"] = cs.cuda_ms(torch, lambda: sweep_z(
        T, c2, tg[2], dt, 20.0, rc), 30)
    if "coeff" in inspect.signature(sweep_z).parameters:
        dzn = dz.movedim(0, 2).contiguous()
        z_pass = (lambda: sweep_z(T, dzn, tg[2], dt, 20.0, **fz))
        out["z_pass"] = "K2, natural layout"
    else:
        zxy = (lambda t: t.permute(2, 0, 1).contiguous())
        fzxy = {k: zxy(v) for k, v in fz.items()}
        z_pass = (lambda: sweep_strided(
            zxy(T), dz, tg[2], dt, 20.0, axis=0, zxy=True, **fzxy)
            .permute(1, 2, 0).contiguous())
        out["z_pass"] = "permute, K1, permute back"
    out[f"field_z_pass_ms {tag}"] = cs.cuda_ms(torch, z_pass, 30)
    m8 = mask.to(torch.uint8)
    cs4 = sweep_code(mask, None, 0, stencil_bits=True)
    for name, Tk, sr in ((("", T, {}),) + ((("b", T.to(torch.bfloat16),
                                              dict(rng_seed=cs.P10_SEED)),)
                                            if n == 256 else ())):
        out[f"K3{name}_ms {tag}"] = cs.cuda_ms(torch, lambda: theta_rhs(
            Tk, m8, c_exp, inv_d2, **sr), 30)
        out[f"K4{name}_ms {tag}"] = cs.cuda_ms(
            torch, lambda: fused_theta_sweep(Tk, cs4, c_exp, inv_d2, tg[0],
                                             dt, 20.0, rc, rng_offset=1,
                                             **sr), 30)


def step_rows(torch, cs, dev, out):
    """chip_smoke.py phase 3's three 512^3 steps, ms/step."""
    from adi_thermal_fields_tpu_torch import CartesianGrid, Material
    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.bc.faces import FACES

    n = cs.P3_N
    grid = CartesianGrid(n, n, n, 0.5e-3)
    mat = Material(7800.0, 490.0, 54.0)
    dt = 2.0 * grid.dx ** 2 / mat.alpha
    mask = cs.waam_mask(torch, grid.shape, dev)
    T0 = cs.random_field(torch, mask, seed=11)
    plans = {"lite": dict(robin_h=30.0),
             "entry": dict(robin_h=200.0, neumann={"z+": 5e5}),
             "field": dict(robin_h={f: 200.0 for f in FACES},
                           neumann={"z+": 5e5})}
    for name, bcs in plans.items():
        prepare, advance = make_cartesian_engine(
            grid, mat, implementation="kernels", device=dev,
            dtype=torch.float32, theta=0.5, t_inf=20.0, **bcs)
        prep = prepare(mask)
        T = advance(T0, prep, dt, STEP_WARMUP, 0.0)
        times = []
        for i in range(STEP_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            T = advance(T, prep, dt, 1, i * dt)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        prof = profile_steps(torch, lambda T: advance(T, prep, dt, 1, 0.0),
                             T)
        prof["idle_share"] = max(0.0, 1.0 - prof["busy_ms"] / ms)
        out[f"step_{name}_ms 512^3"] = ms
        out[f"profile_{name} 512^3"] = prof
        del prep, T
        torch.cuda.empty_cache()


def profile_steps(torch, step, T, n=3):
    """Device ms per step by kernel under torch.profiler and their sum, the
    device's busy ms per step (the idle share is taken against the
    CUDA-event step time: the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            T = step(T)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0.0)
        # host ops (aten::*) report their kernels' time again
        if dev > 0 and not ev.key.startswith("aten::"):
            # the kernel's name, mangled or demangled
            m = (re.search(r"cu_[0-9a-f]{8}\d+(\w+?_kernel)", ev.key)
                 or re.search(r"::(\w+_kernel)<", ev.key))
            name = m.group(1) if m else ev.key[:60]
            # the split-line core's strided, cyclic and staged kernels: by
            # their row formers
            r = re.search(r"split_(?:strided|cyclic|staged)_kernel(?:I(?:[fd]"
                          r"|13__nv_bfloat16)+NS_\d+(\w+?)I|<(?:[\w ]+, )+"
                          r"\(anonymous namespace\)::(\w+)<)", ev.key)
            if r:
                name += f"<{r.group(1) or r.group(2)}>"
            by_name[name] = by_name.get(name, 0.0) + dev / 1e3 / n
    return dict(busy_ms=sum(by_name.values()),
                kernels=dict(sorted(by_name.items(),
                                    key=lambda kv: -kv[1])[:8]))


def k15_row(torch, cs, dev, out):
    """K15 at phase 8's tube, r."""
    from adi_thermal_fields_tpu_torch.solvers import vp2_sweep_strided
    from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as cvp

    f32 = torch.float32
    label, shape, _ = cs.P8_SHAPES[0]
    grid, mat, mask, zbc, T = cs.cylvp_case(torch, label, shape, f32, dev)
    R = cs.random_field(torch, mask, seed=43)
    code_r = cvp.build_cyl_vp2_plan(mask, grid, zbc)[0]
    cols = cvp._vp2_columns(grid, zbc, f32, dev)
    inv = float(torch.tensor(1.0, dtype=f32)
                / (torch.tensor(cs.P8_DT, dtype=f32)
                   / torch.tensor(mat.rho, dtype=f32)))
    r, r_imh, r_iph = cvp._radii(grid)
    kt, ct = cs.varprop_tables()
    rk = dict(k_spec=kt, cp_spec=ct, h_lo=80.0, h_hi=80.0, tinf_void=20.0,
              emissivity=cs.EMISSIVITY,
              edge0=(50.0, r_imh[0] / (r[0] * grid.dr), 20.0),
              edge1=(300.0, r_iph[-1] / (r[-1] * grid.dr), 20.0))
    rcols = (cols["glo_r"], cols["ghi_r"], cols["gsl_r"], cols["gsh_r"])
    out["K15_r_ms"] = cs.cuda_ms(torch, lambda: vp2_sweep_strided(
        R, T, code_r, *rcols, inv, **rk), 50)


def measure(root):
    sys.path.insert(0, root)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda", 0)
    out = dict(root=root)
    for n in (256, 512):
        sweep_rows(torch, cs, dev, n, out)
        torch.cuda.empty_cache()
    k15_row(torch, cs, dev, out)
    torch.cuda.empty_cache()
    step_rows(torch, cs, dev, out)
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1] == "--measure":
        measure(os.path.abspath(sys.argv[2]))
        return
    other = os.path.abspath(sys.argv[1])
    for root in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--measure", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
