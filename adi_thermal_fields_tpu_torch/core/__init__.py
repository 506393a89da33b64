"""Static metadata: grids and material (numpy-only copies)."""
from .grid import CartesianGrid, CylindricalGrid
from .material import Material

__all__ = ["CartesianGrid", "CylindricalGrid", "Material"]
