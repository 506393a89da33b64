"""Static metadata: grids, material and time controls (numpy-only
copies)."""
from .grid import CartesianGrid, CylindricalGrid
from .material import Material
from .timestep import TimeControls

__all__ = ["CartesianGrid", "CylindricalGrid", "Material", "TimeControls"]
