"""ADI steps: Cartesian (plain reference and kernel path), the unmasked
cylindrical step with its ambient-clamp wrapper, the masked-Robin
cylindrical step, and the variable-property cylindrical step with its
ambient-clamp wrapper."""
from .cartesian import adi_step, apply_surface_impulse
from .cartesian_fused import SweepPlan, adi_step_fused, build_sweep_plan
from .cylindrical import RobinBC, ZFaceBC
from .cylindrical import adi_step as adi_step_cylindrical
from .cylindrical import adi_step_masked as adi_step_cylindrical_masked
from .cylindrical_masked import (MaskedRobinPlan, adi_step_masked_robin,
                                 build_masked_robin_plan, masked_robin_solve)
from .cylindrical_varprop import (adi_step_cyl_varprop,
                                  adi_step_cyl_varprop_masked,
                                  build_cyl_vp2_plan)

__all__ = ["adi_step", "apply_surface_impulse", "SweepPlan", "build_sweep_plan", "adi_step_fused",
           "RobinBC", "ZFaceBC", "adi_step_cylindrical",
           "adi_step_cylindrical_masked", "MaskedRobinPlan", "build_masked_robin_plan",
           "masked_robin_solve", "adi_step_masked_robin",
           "adi_step_cyl_varprop", "adi_step_cyl_varprop_masked",
           "build_cyl_vp2_plan"]
