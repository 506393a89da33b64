"""Solvers: the plain Thomas solves, the spectral phi solve, the bfloat16
stores and the twenty-six hand-written kernels (differentiable.py: the
autograd Functions that carry gradients across them).

Constant properties: K1 ``sweep_strided`` and K2 ``sweep_z`` (sweeps.py;
K1's v1 entry "K1v1" behind the JAX v1 names ``fused_sweep``,
``fused_sweep_axis0`` and ``fused_sweep_axis1``),
K3 ``theta_rhs`` (stencil.py), K4 ``fused_theta_sweep`` (theta_sweep.py).
Variable properties: K5 ``varprop_fields``, K6 ``varprop_theta_sweep``,
K7 ``varprop_sweep_y`` and its x entry ``varprop_sweep_x`` (counted as
"K7x"), K19 ``varprop_sweep_z`` and K20 ``varprop_theta_rhs``
(varprop.py), K8 ``vp2_sweep_z`` and K15's y entry ``vp2_sweep_y``
("K15y", the tier-2 y sweep behind ``VP2_Y_DEFAULT``) (vp2.py).
Field-coefficient solves: K21 ``tridiag_fields`` and K22
``cyclic_fields`` (fields.py).  The g-stream
varprop tier: K23 ``gstream_fields``, K24 ``gstream_theta_sweep``, K25
``gstream_sweep_y`` and K26 ``gstream_sweep_z`` (gstreams.py).  K1-K7,
K19, K20 and K23-K26 take bfloat16 states (float32 solves, stores to
nearest or stochastic: rounding.py).
Masked-Robin cylindrical step: K9 ``masked_sweep_strided``, K10
``masked_sweep_z`` and K11 ``masked_cyclic_phi`` (masked.py).
Unmasked cylindrical step: K12 ``const_sweep_strided``, K13
``const_sweep_z`` and K14 ``cyclic_const_phi`` (const_sweeps.py).
Cylindrical variable-property step: K15 ``vp2_sweep_strided``, K16
``vp2_cyclic_phi`` and K8's general form (vp2.py), K17
``vp_fields_sweep_strided`` (with its z entry ``vp_fields_sweep_z``) and
K18 ``vp_fields_cyclic_phi`` (vpfields.py).
K11, K16, K18 and K22 run one periodic split-line kernel
(csrc/split_cyclic.cuh) with their own row formers.
Each wrapper counts its CUDA launches in a ``launches`` attribute; K1-K7,
K19 and K20 count their bfloat16 entries apart, in
``<wrapper>.bf16.launches`` ("K1b"-"K7b", "K7xb", "K19b", "K20b"), K1
its v1 entry in ``sweep_strided.v1.launches``, K12's and K13's table
kernel in ``const_sweep_table.launches`` ("K13t") and
K14 its table's kernel in ``cyclic_const_phi_table.launches`` ("K14t");
``vp_fields_sweep_z`` counts in ``vp_fields_sweep_strided.launches``
(K17).
"""
from .const_sweeps import (const_sweep_strided,
                           const_sweep_strided_plain, const_sweep_table,
                           const_sweep_table_plain, const_sweep_z,
                           const_sweep_z_plain, cyclic_const_phi,
                           cyclic_const_phi_plain, cyclic_const_phi_table,
                           cyclic_const_phi_table_plain)
from .fields import (cyclic_fields, cyclic_fields_plain, tridiag_fields,
                     tridiag_fields_plain)
from .gstreams import (gstream_fields, gstream_fields_plain, gstream_sweep_y,
                       gstream_sweep_y_plain, gstream_sweep_z,
                       gstream_sweep_z_plain, gstream_theta_sweep,
                       gstream_theta_sweep_plain)
from .masked import (masked_cyclic_phi, masked_cyclic_phi_plain,
                     masked_sweep_strided, masked_sweep_strided_plain,
                     masked_sweep_z, masked_sweep_z_plain)
from .spectral import phi_eigenvalue_factors, phi_solve_spectral
from .stencil import theta_rhs, theta_rhs_plain
from .sweeps import (fused_sweep, fused_sweep_axis0,
                     fused_sweep_axis0_plain, fused_sweep_axis1,
                     fused_sweep_axis1_plain, fused_sweep_plain, sweep_code,
                     sweep_strided, sweep_strided_plain, sweep_z,
                     sweep_z_plain)
from .theta_sweep import fused_theta_sweep, fused_theta_sweep_plain
from .thomas import cyclic_thomas, thomas, thomas_along_axis
from .varprop import (varprop_fields, varprop_fields_plain,
                      varprop_sweep_x, varprop_sweep_x_plain,
                      varprop_sweep_y, varprop_sweep_y_plain,
                      varprop_sweep_z, varprop_sweep_z_plain,
                      varprop_theta_rhs, varprop_theta_rhs_plain,
                      varprop_theta_sweep, varprop_theta_sweep_plain)
from .vp2 import (build_vp2_code, vp2_cyclic_phi, vp2_cyclic_phi_plain,
                  vp2_sweep_strided, vp2_sweep_strided_plain, vp2_sweep_y,
                  vp2_sweep_y_plain, vp2_sweep_z, vp2_sweep_z_plain)
from .vpfields import (vp_fields_cyclic_phi, vp_fields_cyclic_phi_plain,
                       vp_fields_sweep_strided,
                       vp_fields_sweep_strided_plain, vp_fields_sweep_z,
                       vp_fields_sweep_z_plain)

KERNELS = {"K1": sweep_strided, "K2": sweep_z, "K3": theta_rhs,
           "K4": fused_theta_sweep, "K5": varprop_fields,
           "K6": varprop_theta_sweep, "K7": varprop_sweep_y,
           "K8": vp2_sweep_z, "K9": masked_sweep_strided,
           "K10": masked_sweep_z, "K11": masked_cyclic_phi,
           "K12": const_sweep_strided, "K13": const_sweep_z,
           "K13t": const_sweep_table,
           "K14": cyclic_const_phi, "K14t": cyclic_const_phi_table,
           "K15": vp2_sweep_strided,
           "K16": vp2_cyclic_phi, "K17": vp_fields_sweep_strided,
           "K18": vp_fields_cyclic_phi, "K7x": varprop_sweep_x,
           "K19": varprop_sweep_z, "K20": varprop_theta_rhs,
           "K21": tridiag_fields, "K22": cyclic_fields,
           "K23": gstream_fields, "K24": gstream_theta_sweep,
           "K25": gstream_sweep_y, "K26": gstream_sweep_z,
           # the bfloat16 entries of K1-K7, K19 and K20, counted apart
           "K1b": sweep_strided.bf16, "K2b": sweep_z.bf16,
           "K3b": theta_rhs.bf16, "K4b": fused_theta_sweep.bf16,
           "K5b": varprop_fields.bf16, "K6b": varprop_theta_sweep.bf16,
           "K7b": varprop_sweep_y.bf16, "K7xb": varprop_sweep_x.bf16,
           "K19b": varprop_sweep_z.bf16, "K20b": varprop_theta_rhs.bf16,
           # K1's v1 entry and K15's y entry, counted apart
           "K1v1": sweep_strided.v1, "K15y": vp2_sweep_y}

__all__ = ["thomas", "thomas_along_axis", "cyclic_thomas", "sweep_code", "sweep_strided", "sweep_strided_plain",
           "sweep_z", "sweep_z_plain", "theta_rhs", "theta_rhs_plain",
           "fused_theta_sweep", "fused_theta_sweep_plain", "varprop_fields",
           "varprop_fields_plain", "varprop_theta_sweep",
           "varprop_theta_sweep_plain", "varprop_sweep_y",
           "varprop_sweep_y_plain", "build_vp2_code", "vp2_sweep_z",
           "vp2_sweep_z_plain", "masked_sweep_strided",
           "masked_sweep_strided_plain", "masked_sweep_z",
           "masked_sweep_z_plain", "masked_cyclic_phi",
           "masked_cyclic_phi_plain", "const_sweep_strided",
           "const_sweep_strided_plain", "const_sweep_table",
           "const_sweep_table_plain", "const_sweep_z",
           "const_sweep_z_plain", "cyclic_const_phi",
           "cyclic_const_phi_plain", "cyclic_const_phi_table",
           "cyclic_const_phi_table_plain", "vp2_sweep_strided",
           "vp2_sweep_strided_plain", "vp2_cyclic_phi",
           "vp2_cyclic_phi_plain", "vp_fields_sweep_strided",
           "vp_fields_sweep_strided_plain", "vp_fields_sweep_z",
           "vp_fields_sweep_z_plain", "vp_fields_cyclic_phi",
           "vp_fields_cyclic_phi_plain", "varprop_sweep_x",
           "varprop_sweep_x_plain", "varprop_sweep_z",
           "varprop_sweep_z_plain", "varprop_theta_rhs",
           "varprop_theta_rhs_plain", "tridiag_fields",
           "tridiag_fields_plain", "cyclic_fields", "cyclic_fields_plain",
           "phi_eigenvalue_factors",
           "phi_solve_spectral", "gstream_fields", "gstream_fields_plain",
           "gstream_theta_sweep", "gstream_theta_sweep_plain",
           "gstream_sweep_y", "gstream_sweep_y_plain", "gstream_sweep_z",
           "gstream_sweep_z_plain", "fused_sweep", "fused_sweep_plain",
           "fused_sweep_axis0", "fused_sweep_axis0_plain",
           "fused_sweep_axis1", "fused_sweep_axis1_plain", "vp2_sweep_y",
           "vp2_sweep_y_plain", "KERNELS",
           "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
