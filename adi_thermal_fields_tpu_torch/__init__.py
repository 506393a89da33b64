"""adi_thermal_fields_tpu_torch — the PyTorch + CUDA port of
adi_thermal_fields_tpu (transient 3-D heat conduction for WAAM).

This package imports torch and numpy, never jax.  Its modules mirror the
JAX package's paths; each docstring names its counterpart.  The slice
ported so far is the Cartesian WAAM path: voxelized STL parts, element
birth, constant properties, scalar or field Robin h, Neumann flux and
Dirichlet pins, stepped by the masked theta-scheme ADI on four CUDA
kernels written by hand for the H100 (csrc/):

* K1 ``solvers.sweeps.sweep_strided`` — masked sweep along x or y;
* K2 ``solvers.sweeps.sweep_z`` — plan-lite sweep along contiguous z;
* K3 ``solvers.stencil.theta_rhs`` — the explicit theta-pass stencil;
* K4 ``solvers.theta_sweep.fused_theta_sweep`` — K3 fused into the
  x-sweep.

Each kernel wrapper runs its plain PyTorch version on CPU tensors and the
kernel on CUDA tensors (built from csrc/*.cu at first use).
"""

from .bc.faces import FACES, exposed_face, exposed_faces
from .bc.packs import CoeffPacks, build_coeff_packs
from .core.grid import CartesianGrid
from .core.material import Material
from .step.cartesian import adi_step as adi_step_cartesian
from .step.cartesian_fused import SweepPlan, adi_step_fused, build_sweep_plan

__version__ = "0.1.0"

__all__ = ["CartesianGrid", "Material", "FACES", "exposed_face",
           "exposed_faces", "CoeffPacks", "build_coeff_packs",
           "adi_step_cartesian", "SweepPlan", "build_sweep_plan",
           "adi_step_fused"]
