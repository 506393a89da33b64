#!/usr/bin/env python3
"""Where the two y routes of the float32 varprop step part: the classic y
sweep (JAX ``fused_varprop_sweep_axis1``, the port's K7) against the
tier-2 y sweep behind ``VP2_Y_DEFAULT`` (JAX ``fused_vp2_sweep_axis1``,
the port's K15y), each against the float64 print (whose y always takes the
classic route), in the JAX package and in the PyTorch port.

The print is chip_smoke.py's WAAM varprop print (the 160x40x40 mm bar,
2 mm layers of 3 s, --melt_k_factor 4 and --emissivity 0.5) at 1 mm voxels
by default (a 164x44x44 grid, 20 layers; ``--dx_mm 0.5`` is chip_smoke's
resolution, ``--bar_mm`` and ``--layers`` cut the bar), once without
latent heat and once (``--prints`` picks one)
with --latent_J_kg 2.7e5 (mushy interval 1420-1470 C).  For each, one JSON
line: the float32 prints with the switch on and off against each other
(max and mean |d| over the solid, cells above 0.5 K and how far from the
solidus the farthest of them lies) and each against the float64 print
(max, mean |d| and mean signed d over the solid).

Each side runs the WAAM app of its own package, in its own process, and
imports nothing of the other:

    python scripts/vp2_y_solidus.py --side jax     # JAX, interpret mode, CPU
    python scripts/vp2_y_solidus.py --side port    # the port's plain versions
    python scripts/vp2_y_solidus.py --side port --device cuda   # the kernels
    python scripts/vp2_y_solidus.py --side jax --dx_mm 0.5 --bar_mm 40,40,20 \
        --layers 10 --prints "without latent heat"
"""
import argparse
import functools
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "vp2_y_solidus")
LAYER_S = 3.0
SOLIDUS = 1420.0
FLAGS = {"without latent heat": ["--melt_k_factor", "4",
                                 "--emissivity", "0.5"],
         "with latent heat": ["--latent_J_kg", "2.7e5", "--melt_k_factor",
                              "4", "--emissivity", "0.5"]}


def bar_stl(box_mm):
    """The bar as a binary STL: 12 triangles of the box [0, box_mm]."""
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "bar_{:g}x{:g}x{:g}.stl".format(*box_mm))
    c = np.array([[(i >> a) & 1 for a in range(3)] for i in range(8)],
                 float) * box_mm
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3),
             (0, 4, 6, 2), (1, 3, 7, 5)]
    tris = [(q[0], q[1], q[2]) for q in quads] + \
        [(q[0], q[2], q[3]) for q in quads]
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            v = c[list(t)]
            n = np.cross(v[1] - v[0], v[2] - v[0])
            n /= np.linalg.norm(n)
            fh.write(struct.pack("<12fH", *n, *v.ravel(), 0))
    return path


def argv(a, flags, precision):
    return ["--stl", bar_stl(a.bar_mm), "--dx_mm", str(a.dx_mm),
            "--nframes", "4",
            "--layer_times_s", ",".join([str(LAYER_S)] * a.layers),
            "--precision", precision] + flags


def jax_side(a):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from adi_thermal_fields_tpu.apps import engine
    from adi_thermal_fields_tpu.apps import waam_from_stl as app
    from adi_thermal_fields_tpu.step import cartesian_varprop as cv

    # the app's engine on its fused kernels (Pallas interpret mode off the
    # TPU), whose step holds both y routes; "auto" picks the XLA scan here
    make = engine.make_cartesian_engine
    engine.make_cartesian_engine = functools.partial(
        make, implementation="pallas", interpret=True)

    def run(flags, precision, on):
        # the switch is read when the step is traced: drop the traces
        cv.VP2_Y_DEFAULT = on
        jax.clear_caches()
        res = app.run(app.build_argparser().parse_args(
            argv(a, flags, precision)
            + ["--outdir", os.path.join(WORK, "out")]))
        return (np.asarray(res["T"], np.float64),
                np.asarray(res["active"], bool))

    return run


def port_side(a):
    import torch
    sys.path.insert(0, ROOT)
    import adi_thermal_fields_tpu_torch.step.cartesian_varprop as cv
    from adi_thermal_fields_tpu_torch.apps import waam_from_stl as app

    torch.set_num_threads(8)

    def run(flags, precision, on):
        cv.VP2_Y_DEFAULT = on
        res = app.run(app.build_argparser().parse_args(
            argv(a, flags, precision) + ["--device", a.device,
                                         "--implementation", "kernels"]))
        return (res["T"].double().cpu().numpy(),
                res["active"].bool().cpu().numpy())

    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=("jax", "port"), required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dx_mm", type=float, default=1.0)
    ap.add_argument("--bar_mm", default="160,40,40")
    ap.add_argument("--layers", type=int, default=20)
    ap.add_argument("--prints", choices=("both", *FLAGS), default="both")
    a = ap.parse_args()
    a.bar_mm = np.array([float(v) for v in a.bar_mm.split(",")])
    run = jax_side(a) if a.side == "jax" else port_side(a)
    for name, flags in FLAGS.items():
        if a.prints not in ("both", name):
            continue
        f64, m = run(flags, "float64", False)
        on, off = run(flags, "float32", True)[0], run(flags, "float32",
                                                      False)[0]
        d = np.abs(on - off)[m]
        far = d > 0.5
        near = np.minimum(np.abs(on - SOLIDUS), np.abs(off - SOLIDUS))[m]
        out = dict(side=a.side, device=a.device, dx_mm=a.dx_mm,
                   bar_mm=a.bar_mm.tolist(), print=name,
                   on_vs_off=dict(max=float(d.max()), mean=float(d.mean()),
                                  cells_above_0_5=int(far.sum()),
                                  farthest_from_solidus=float(near[far].max())
                                  if far.any() else None))
        for key, t in (("on", on), ("off", off)):
            e = (t - f64)[m]
            out[f"{key}_vs_f64"] = dict(max=float(np.abs(e).max()),
                                        mean=float(np.abs(e).mean()),
                                        mean_signed=float(e.mean()))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
