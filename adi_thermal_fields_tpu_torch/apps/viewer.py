"""Interactive slice viewer for saved frame series (CLI app).

Counterpart: ``adi_thermal_fields_tpu/apps/viewer.py`` — ``main``, a copy
over the port's ``io/vtk.py``.  A matplotlib Slider (time, slice index)
and RadioButtons (XY/XZ/YZ plane) over a directory of VTK frames written
by the WAAM or single-track app (``--save_vtk 1``).  matplotlib is
imported inside ``main`` only: nothing else of the package needs it.

    python -m adi_thermal_fields_tpu_torch.apps.viewer --dir waam_out/
"""
from __future__ import annotations

import argparse
import glob
import os
import re


__all__ = ["read_vtk_structured_points", "main"]


from ..io.vtk import read_vtk_structured_points  # noqa: F401 (re-export)


def main(argv=None):
    p = argparse.ArgumentParser(description="Slice viewer for VTK frame series")
    p.add_argument("--dir", type=str, required=True)
    p.add_argument("--pattern", type=str, default="*.vtk")
    p.add_argument("--field", type=str, default="Temperature")
    args = p.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.dir, args.pattern)))
    if not paths:
        raise SystemExit(f"no VTK files matching {args.pattern} in {args.dir}")
    times = []
    for pth in paths:
        m = re.search(r"(\d+\.\d+)", os.path.basename(pth))
        times.append(float(m.group(1)) if m else len(times))
    frames = [read_vtk_structured_points(p) for p in paths]

    import matplotlib.pyplot as plt
    from matplotlib.widgets import RadioButtons, Slider

    field = args.field
    data0 = frames[0][field]
    vmin = min(f[field].min() for f in frames)
    vmax = max(f[field].max() for f in frames)

    fig, ax = plt.subplots(figsize=(8, 6))
    plt.subplots_adjust(left=0.25, bottom=0.22)
    state = {"plane": "XY", "k": data0.shape[2] // 2, "ti": 0}

    def slice_of(arr):
        if state["plane"] == "XY":
            return arr[:, :, min(state["k"], arr.shape[2] - 1)].T
        if state["plane"] == "XZ":
            return arr[:, min(state["k"], arr.shape[1] - 1), :].T
        return arr[min(state["k"], arr.shape[0] - 1), :, :].T

    im = ax.imshow(slice_of(data0), origin="lower", vmin=vmin, vmax=vmax,
                   cmap="inferno")
    fig.colorbar(im, ax=ax, label=field)

    ax_t = plt.axes([0.25, 0.10, 0.6, 0.03])
    s_t = Slider(ax_t, "frame", 0, len(frames) - 1, valinit=0, valstep=1)
    ax_k = plt.axes([0.25, 0.05, 0.6, 0.03])
    s_k = Slider(ax_k, "slice", 0, max(data0.shape) - 1,
                 valinit=state["k"], valstep=1)
    ax_r = plt.axes([0.03, 0.4, 0.15, 0.2])
    r_p = RadioButtons(ax_r, ("XY", "XZ", "YZ"))

    def update(_):
        state["ti"] = int(s_t.val)
        state["k"] = int(s_k.val)
        arr = frames[state["ti"]][field]
        im.set_data(slice_of(arr))
        ax.set_title(f"t = {times[state['ti']]:.3f} s  [{state['plane']}]")
        fig.canvas.draw_idle()

    def set_plane(label):
        state["plane"] = label
        update(None)

    s_t.on_changed(update)
    s_k.on_changed(update)
    r_p.on_clicked(set_plane)
    update(None)
    plt.show()


if __name__ == "__main__":
    main()
