"""Solvers: the plain Thomas solve and the four hand-written kernels.

K1 ``sweep_strided`` and K2 ``sweep_z`` (sweeps.py), K3 ``theta_rhs``
(stencil.py), K4 ``fused_theta_sweep`` (theta_sweep.py).  Each wrapper
counts its CUDA launches in a ``launches`` attribute.
"""
from .stencil import theta_rhs, theta_rhs_plain
from .sweeps import (sweep_code, sweep_strided, sweep_strided_plain, sweep_z,
                     sweep_z_plain)
from .theta_sweep import fused_theta_sweep, fused_theta_sweep_plain
from .thomas import thomas

KERNELS = {"K1": sweep_strided, "K2": sweep_z, "K3": theta_rhs,
           "K4": fused_theta_sweep}

__all__ = ["thomas", "sweep_code", "sweep_strided", "sweep_strided_plain",
           "sweep_z", "sweep_z_plain", "theta_rhs", "theta_rhs_plain",
           "fused_theta_sweep", "fused_theta_sweep_plain", "KERNELS",
           "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
