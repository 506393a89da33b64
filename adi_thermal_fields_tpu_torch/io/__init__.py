"""Host I/O: logging, VTK frames, npz checkpoints (numpy) and profiling
(io/profiling.py: torch.profiler traces and a step timer)."""
from .checkpoint import RunState, load_checkpoint, save_checkpoint
from .logging import fmt_bytes, log
from .vtk import (read_vtk_structured_grid, read_vtk_structured_points,
                  write_vtk_cylindrical_grid, write_vtk_structured_points)

__all__ = ["log", "fmt_bytes", "RunState", "save_checkpoint",
           "load_checkpoint", "write_vtk_structured_points",
           "read_vtk_structured_points", "write_vtk_cylindrical_grid",
           "read_vtk_structured_grid"]
