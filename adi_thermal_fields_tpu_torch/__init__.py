"""adi_thermal_fields_tpu_torch — the PyTorch + CUDA port of
adi_thermal_fields_tpu (transient 3-D heat conduction for WAAM).

This package imports torch and numpy, never jax.  Its modules mirror the
JAX package's paths; each docstring names its counterpart.  The slices
ported so far are the Cartesian WAAM path: voxelized STL parts, element
birth, constant properties, scalar or field Robin h, Neumann flux and
Dirichlet pins; its variable-property step: k(T) and cp(T) tables
(latent heat, melt-pool conductivity), the radiative film, scalar,
per-face or field convective h (the STL area-corrected fields of
``--corrected_bc``), Neumann flux and Dirichlet pins; and the
cylindrical spiral-tube path: the masked-Robin (r, phi, z)
backward-Euler step with element birth by a spiral schedule, the
unmasked cylindrical step (backward Euler and Douglas-Gunn) with its
ambient-clamp birth wrapper, and the variable-property cylindrical step
(tables, radiation, backward Euler and Douglas-Gunn, face-cut or clamp
birth, and its field-coefficient tier); and the bf16 bandwidth mode
(bfloat16 states solved at float32, stores rounded stochastically from
the engine's integer step counter); and the apps' outputs and the
single-track app: VTK frames (``io.vtk``), npz checkpoints and resume
(``io.checkpoint``), the per-voxel thermal history and interpass dwell of
the engine (``apps.engine``), the frame viewer, and ``apps.single_track``
with its Goldak torch (``birth.heat_source``).  They run on CUDA kernels written by
hand for the H100 (csrc/):

* K1 ``solvers.sweeps.sweep_strided`` — masked sweep along x or y;
* K2 ``solvers.sweeps.sweep_z`` — masked sweep along contiguous z;
* K3 ``solvers.stencil.theta_rhs`` — the explicit theta-pass stencil;
* K4 ``solvers.theta_sweep.fused_theta_sweep`` — K3 fused into the
  x-sweep;
* K5 ``solvers.varprop.varprop_fields`` — face conductivities, 1/(rho cp)
  and the radiative film from T;
* K6 ``solvers.varprop.varprop_theta_sweep`` — the varprop theta pass
  fused into the x-sweep;
* K7 ``solvers.varprop.varprop_sweep_y`` — the varprop y-sweep;
* K8 ``solvers.vp2.vp2_sweep_z`` — the tier-2 z-sweep deriving k, cp
  and films from T;
* K9 ``solvers.masked.masked_sweep_strided`` — the masked-Robin r sweep;
* K10 ``solvers.masked.masked_sweep_z`` — the masked-Robin sweep along
  contiguous z;
* K11 ``solvers.masked.masked_cyclic_phi`` — the mask-broken periodic phi
  sweep;
* K12 ``solvers.const_sweeps.const_sweep_strided`` — the constant-row r
  sweep (its rows' factors from ``const_sweep_table``);
* K13 ``solvers.const_sweeps.const_sweep_z`` — the constant-row sweep
  along contiguous z (its rows' factors from ``const_sweep_table``);
* K14 ``solvers.const_sweeps.cyclic_const_phi`` — the constant-coefficient
  periodic phi solve (its rings' factors from ``cyclic_const_phi_table``);
* K15 ``solvers.vp2.vp2_sweep_strided`` — the tier-2 r sweep deriving k,
  cp and films from T (K8's general form takes z);
* K16 ``solvers.vp2.vp2_cyclic_phi`` — the tier-2 periodic phi sweep;
* K17 ``solvers.vpfields.vp_fields_sweep_strided`` — the five-stream
  sweep (r; its entry ``vp_fields_sweep_z`` takes z, natural);
* K18 ``solvers.vpfields.vp_fields_cyclic_phi`` — the five-stream
  periodic phi sweep;
* K19 ``solvers.varprop.varprop_sweep_z`` — the stream-reading varprop
  sweep along contiguous z (K7's entry point also takes x:
  ``varprop_sweep_x``);
* K20 ``solvers.varprop.varprop_theta_rhs`` — the explicit varprop theta
  pass;
* K21 ``solvers.fields.tridiag_fields`` — Thomas on a/b/c/d fields along
  any axis;
* K22 ``solvers.fields.cyclic_fields`` — the periodic field-coefficient
  solve;
* K23 ``solvers.gstreams.gstream_fields`` — the pre-multiplied coupling
  and sink streams of the g-stream varprop tier;
* K24 ``solvers.gstreams.gstream_theta_sweep`` — its theta pass fused
  into the x-sweep;
* K25 ``solvers.gstreams.gstream_sweep_y`` and K26
  ``solvers.gstreams.gstream_sweep_z`` — its y and z sweeps.

K1-K4 and K23-K26 take bfloat16 states (``solvers.rounding``).  The
periodic sweeps K11, K16, K18 and K22 share one split-line kernel
(csrc/split_cyclic.cuh), each with its own row former.

Each kernel wrapper runs its plain PyTorch version on CPU tensors and the
kernel on CUDA tensors (built from csrc/*.cu at first use).
"""

from .bc.faces import FACES, exposed_face, exposed_faces
from .bc.packs import CoeffPacks, build_coeff_packs
from .core.grid import CartesianGrid, CylindricalGrid
from .core.material import Material
from .core.timestep import TimeControls
from .step.cartesian import adi_step as adi_step_cartesian
from .step.cartesian import apply_surface_impulse
from .step.cartesian_fused import SweepPlan, adi_step_fused, build_sweep_plan
from .step.cartesian_varprop import (PropertyTable, adi_step_varprop,
                                     adi_step_varprop_fused,
                                     adi_step_varprop_gstreams, apparent_cp,
                                     build_varprop_codes,
                                     melt_pool_enhanced_k)
from .step.cylindrical import RobinBC, ZFaceBC
from .step.cylindrical import adi_step as adi_step_cylindrical
from .step.cylindrical import adi_step_masked as adi_step_cylindrical_masked
from .solvers.spectral import phi_solve_spectral
from .step.cylindrical_masked import (MaskedRobinPlan, adi_step_masked_robin,
                                      build_masked_robin_plan,
                                      masked_robin_solve)
from .step.cylindrical_varprop import (adi_step_cyl_varprop,
                                       adi_step_cyl_varprop_masked,
                                       build_cyl_vp2_plan)
from .bc.radiation import STEFAN_BOLTZMANN, radiative_h

__version__ = "0.1.0"

__all__ = ["CartesianGrid", "Material", "TimeControls", "FACES",
           "exposed_face", "exposed_faces", "CoeffPacks", "build_coeff_packs",
           "adi_step_cartesian", "apply_surface_impulse", "SweepPlan", "build_sweep_plan",
           "adi_step_fused", "PropertyTable", "apparent_cp",
           "melt_pool_enhanced_k", "adi_step_varprop",
           "adi_step_varprop_fused", "adi_step_varprop_gstreams",
           "build_varprop_codes",
           "STEFAN_BOLTZMANN", "radiative_h", "CylindricalGrid", "RobinBC",
           "ZFaceBC", "adi_step_cylindrical", "adi_step_cylindrical_masked",
           "phi_solve_spectral", "MaskedRobinPlan", "build_masked_robin_plan",
           "masked_robin_solve", "adi_step_masked_robin",
           "adi_step_cyl_varprop", "adi_step_cyl_varprop_masked",
           "build_cyl_vp2_plan"]
