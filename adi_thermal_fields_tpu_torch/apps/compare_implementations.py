"""Implementation A/B app: the kernel path against the plain reference
step (CLI app).

Counterpart: ``adi_thermal_fields_tpu/apps/compare_implementations.py``
(:1-165), the analogue of the reference's CPU-vs-GPU backend comparison
(quick_compare_neumann_robin_backend.py:172-231): runs the identical
Neumann-heated / Robin-cooled cylinder on both paths and reports the wall
time per step and the RMS / max field difference at the end.

* ``--case cartesian``: ``reference`` (step/cartesian.adi_step, thomas)
  against ``kernels`` (step/cartesian_fused.adi_step_fused: K3, K1 x2,
  K2 on this entry plan with its Neumann flux);
* ``--case cyl_varprop``: the variable-property cylindrical step's
  ``reference`` / ``fields`` / ``kernels`` tiers, where the JAX app runs
  ``xla`` / ``pallas_fields`` / ``pallas`` (:130, :151).

The returned dict has the JAX app's keys (``timings``, ``rms``, ``max``;
``timings`` and ``max_fields``/``max_kernels``), each timing keyed by the
port's tier names.  ``--device`` defaults to ``cuda`` and the run raises
when CUDA is absent; ``--device cpu`` runs the kernels' plain versions.

    python -m adi_thermal_fields_tpu_torch.apps.compare_implementations --n 128
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import resolve_device


def build_argparser():
    p = argparse.ArgumentParser(
        description="reference vs kernels ADI step comparison")
    p.add_argument("--n", type=int, default=128, help="grid edge (n^3)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("--precision", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--case", choices=["cartesian", "cyl_varprop"],
                   default="cartesian",
                   help="cartesian: the theta step, reference vs kernels "
                        "(the reference backend A/B); cyl_varprop: the "
                        "variable-property cylindrical step's three tiers "
                        "(reference / fields / kernels)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run raises when CUDA is absent")
    return p


def _time_paths(paths, T0, steps, device, cells, log):
    """Each path's ms per step after one warm-up step, and its field."""
    results, timings = {}, {}
    sync = (lambda: torch.cuda.synchronize(device)
            if device.type == "cuda" else None)
    for name, step in paths.items():
        T = step(T0)
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            T = step(T)
        sync()
        el = (time.perf_counter() - t0) / steps
        timings[name] = el
        results[name] = T.double().cpu().numpy()
        log(f"{name:9s}: {el * 1e3:8.2f} ms/step  "
            f"({cells / el / 1e9:6.2f} Gcell/s)", tag="time")
    return results, timings


def run(args) -> dict:
    if getattr(args, "case", "cartesian") == "cyl_varprop":
        return run_cyl_varprop(args)
    from ..bc.packs import build_coeff_packs
    from ..core.grid import CartesianGrid
    from ..core.material import Material
    from ..geometry.shapes import cylinder_mask
    from ..io.logging import log
    from ..step.cartesian import adi_step
    from ..step.cartesian_fused import adi_step_fused, build_sweep_plan

    device = resolve_device(args.device)
    n = args.n
    dtype = torch.float32 if args.precision == "float32" else torch.float64
    grid = CartesianGrid(n, n, n, 1e-3)
    mat = Material(7800.0, 490.0, 54.0)
    mask = torch.from_numpy(
        cylinder_mask(n, n, n, grid.dx, 0.45 * n * grid.dx)).to(device)
    packs = build_coeff_packs(mask, grid, mat, robin_h=300.0,
                              neumann={"z-": 2e5}, dtype=dtype)
    T0 = torch.full(grid.shape, 20.0, dtype=dtype, device=device)
    plan = build_sweep_plan(mask, packs, has_neumann=True,
                            has_dirichlet=False)
    kw = dict(dt=args.dt, theta=0.5, t_inf=20.0)
    paths = {
        "reference": lambda T: adi_step(T, mask, packs, grid, mat, **kw),
        "kernels": lambda T: adi_step_fused(T, plan, grid, mat, **kw),
    }
    results, timings = _time_paths(paths, T0, args.steps, device,
                                   grid.ncells, log)
    m = mask.cpu().numpy()
    diff = results["reference"] - results["kernels"]
    rms = float(np.sqrt(np.mean(diff[m] ** 2)))
    mx = float(np.abs(diff[m]).max())
    log(f"reference vs kernels: RMS={rms:.3e}  max={mx:.3e}", tag="diff")
    return {"timings": timings, "rms": rms, "max": mx}


def run_cyl_varprop(args) -> dict:
    """Three-tier A/B of the variable-property cylindrical step on a
    part-deposited annulus (latent heat + melt-pool k + radiation):
    ``reference`` (thomas) vs ``fields`` (materialized a/b/c/d on K21/K22)
    vs ``kernels`` (the tier-2 chain K15 -> K16 -> K8's general form)."""
    from ..core.grid import CylindricalGrid
    from ..core.material import Material
    from ..io.logging import log
    from ..step.cartesian_varprop import apparent_cp, melt_pool_enhanced_k
    from ..step.cylindrical import RobinBC, ZFaceBC
    from ..step.cylindrical_varprop import adi_step_cyl_varprop

    device = resolve_device(args.device)
    n = args.n
    dtype = torch.float32 if args.precision == "float32" else torch.float64
    nr, nphi, nz = max(8, n // 8), 4 * n, n
    grid = CylindricalGrid(nr, nphi, nz, 5e-4, 5e-4, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    kt = melt_pool_enhanced_k(mat.k, 1420.0, 1470.0, enhancement=4.0)
    ct = apparent_cp(mat.cp, mat.cp, 2.7e5, 1420.0, 1470.0)
    act = np.zeros(grid.shape, bool)
    act[:, :, :nz // 2] = True
    act[:, :(3 * nphi) // 5, nz // 2:nz // 2 + max(1, nz // 8)] = True
    active = torch.from_numpy(act).to(device)
    T0 = torch.where(active, 1600.0, 20.0).to(dtype)
    kw = dict(robin_outer=RobinBC(300.0, 20.0),
              zbc=ZFaceBC(kind_top="robin", h_top=400.0, T_inf_top=20.0),
              robin_inner=RobinBC(50.0, 20.0), k_table=kt, cp_table=ct,
              h_void=80.0, T_inf_void=20.0, h_front=200.0, emissivity=0.5)
    paths = {impl: (lambda T, impl=impl: adi_step_cyl_varprop(
        T, grid, mat, dt=args.dt, active=active, implementation=impl, **kw))
        for impl in ("reference", "fields", "kernels")}
    results, timings = _time_paths(paths, T0, args.steps, device,
                                   nr * nphi * nz, log)
    out = {"timings": timings}
    for a, b in (("reference", "fields"), ("reference", "kernels")):
        diff = (results[a] - results[b])[act]
        rms = float(np.sqrt(np.mean(diff ** 2)))
        mx = float(np.abs(diff).max())
        log(f"{a} vs {b}: RMS={rms:.3e}  max={mx:.3e}", tag="diff")
        out[f"max_{b}"] = mx
    return out


def main(argv=None):
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
