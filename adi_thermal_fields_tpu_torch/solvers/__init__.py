"""Solvers: the plain Thomas solve and the eight hand-written kernels.

Constant properties: K1 ``sweep_strided`` and K2 ``sweep_z`` (sweeps.py),
K3 ``theta_rhs`` (stencil.py), K4 ``fused_theta_sweep`` (theta_sweep.py).
Variable properties: K5 ``varprop_fields``, K6 ``varprop_theta_sweep``
and K7 ``varprop_sweep_y`` (varprop.py), K8 ``vp2_sweep_z`` (vp2.py).
Each wrapper counts its CUDA launches in a ``launches`` attribute.
"""
from .stencil import theta_rhs, theta_rhs_plain
from .sweeps import (sweep_code, sweep_strided, sweep_strided_plain, sweep_z,
                     sweep_z_plain)
from .theta_sweep import fused_theta_sweep, fused_theta_sweep_plain
from .thomas import thomas
from .varprop import (varprop_fields, varprop_fields_plain,
                      varprop_sweep_y, varprop_sweep_y_plain,
                      varprop_theta_sweep, varprop_theta_sweep_plain)
from .vp2 import build_vp2_code, vp2_sweep_z, vp2_sweep_z_plain

KERNELS = {"K1": sweep_strided, "K2": sweep_z, "K3": theta_rhs,
           "K4": fused_theta_sweep, "K5": varprop_fields,
           "K6": varprop_theta_sweep, "K7": varprop_sweep_y,
           "K8": vp2_sweep_z}

__all__ = ["thomas", "sweep_code", "sweep_strided", "sweep_strided_plain",
           "sweep_z", "sweep_z_plain", "theta_rhs", "theta_rhs_plain",
           "fused_theta_sweep", "fused_theta_sweep_plain", "varprop_fields",
           "varprop_fields_plain", "varprop_theta_sweep",
           "varprop_theta_sweep_plain", "varprop_sweep_y",
           "varprop_sweep_y_plain", "build_vp2_code", "vp2_sweep_z",
           "vp2_sweep_z_plain", "KERNELS", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
