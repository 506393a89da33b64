"""Cartesian ADI steps: the plain reference and the kernel path."""
from .cartesian import adi_step
from .cartesian_fused import SweepPlan, adi_step_fused, build_sweep_plan

__all__ = ["adi_step", "SweepPlan", "build_sweep_plan", "adi_step_fused"]
