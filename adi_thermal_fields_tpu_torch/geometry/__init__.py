"""Host geometry: STL I/O, primitives, voxelization, morphology, shape
masks, perimeter and per-slice corrections (numpy)."""
from .morphology import solidify_mask
from .perimeter import digital_perimeter, perimeter_correction_factor
from .primitives import box_mesh
from .shapes import cylinder_mask, plate_mask
from .slices import (per_slice_perimeter_scale, section_segments,
                     slice_perimeter_area)
from .stl import TriMesh, load_stl, save_stl_binary
from .voxelize import (auto_cell_size, grid_from_mesh, voxelize_shell,
                       voxelize_solid)

__all__ = ["TriMesh", "load_stl", "save_stl_binary", "box_mesh",
           "voxelize_solid", "voxelize_shell", "grid_from_mesh",
           "auto_cell_size", "solidify_mask", "digital_perimeter",
           "perimeter_correction_factor", "cylinder_mask", "plate_mask",
           "section_segments", "slice_perimeter_area",
           "per_slice_perimeter_scale"]
