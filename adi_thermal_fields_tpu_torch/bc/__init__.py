"""Boundary conditions: exposed faces and coefficient packs."""
from .faces import FACES, exposed_face, exposed_faces, shift_in
from .packs import CoeffPacks, build_coeff_packs

__all__ = ["FACES", "exposed_face", "exposed_faces", "shift_in",
           "CoeffPacks", "build_coeff_packs"]
