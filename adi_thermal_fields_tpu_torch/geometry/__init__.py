"""Host geometry: STL I/O, primitives, voxelization, morphology (numpy)."""
from .morphology import solidify_mask
from .primitives import box_mesh
from .stl import TriMesh, load_stl, save_stl_binary
from .voxelize import (auto_cell_size, grid_from_mesh, voxelize_shell,
                       voxelize_solid)

__all__ = ["TriMesh", "load_stl", "save_stl_binary", "box_mesh",
           "voxelize_solid", "voxelize_shell", "grid_from_mesh",
           "auto_cell_size", "solidify_mask"]
