"""Boundary conditions: exposed faces, coefficient packs, radiation."""
from .faces import FACES, exposed_face, exposed_faces, shift_in
from .packs import CoeffPacks, build_coeff_packs
from .radiation import STEFAN_BOLTZMANN, radiative_h

__all__ = ["FACES", "exposed_face", "exposed_faces", "shift_in",
           "CoeffPacks", "build_coeff_packs", "STEFAN_BOLTZMANN",
           "radiative_h"]
