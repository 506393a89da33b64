"""Static metadata: grid and material (numpy-only copies)."""
from .grid import CartesianGrid
from .material import Material

__all__ = ["CartesianGrid", "Material"]
