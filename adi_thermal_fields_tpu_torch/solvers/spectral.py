"""Spectral solve of the periodic-phi implicit operator by a real FFT.

Counterpart: ``adi_thermal_fields_tpu/solvers/spectral.py`` —
``phi_eigenvalue_factors`` and ``phi_solve_spectral`` (:27-52), the JAX
package's phi solve off the TPU.

Solves ``(I - theta*dt*alpha*L_phi) X = Tin`` along axis 1 of the natural
(r, phi, z) field, where ``L_phi`` is the periodic second difference over
``r_i^2 dphi^2``.  ``L_phi`` is circulant along phi, so the DFT
diagonalises it: ``lam_k = 1 + 2*fac_i*(1 - cos(2 pi k / nphi))`` with
``fac_i = theta*alpha*dt / (r_i^2 dphi^2)``.  On a full disk the axis row
has ``fac = 0`` (regularity at r = 0), so its system is the identity.

In the port this is the phi solve of the ``implementation="reference"``
cylindrical step; the kernel route solves the same systems with K14
(solvers/const_sweeps.py).  No kernel replaces it: it is not a TPU kernel.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.grid import CylindricalGrid
from ..core.material import Material

__all__ = ["phi_solve_spectral", "phi_eigenvalue_factors"]


def phi_eigenvalue_factors(grid: CylindricalGrid,
                           dtype: torch.dtype = torch.float64,
                           device: torch.device | str | None = None
                           ) -> torch.Tensor:
    """Per-radius coefficient ``1/(r_i^2 dphi^2)``, shape (nr,), with the
    axis row zeroed on full-disk grids."""
    r = np.asarray(grid.r, dtype=np.float64)
    inv = 1.0 / (r * r * grid.dphi * grid.dphi)
    if not grid.is_annular:
        inv = inv.copy()
        inv[0] = 0.0
    return torch.as_tensor(inv, device=device).to(dtype)


def phi_solve_spectral(Tin: torch.Tensor, grid: CylindricalGrid,
                       mat: Material, theta: float,
                       dt: float) -> torch.Tensor:
    """Apply ``(I - theta*dt*alpha*L_phi)^{-1}`` along axis 1 of an
    (nr, nphi, nz) field; ``nphi == 1`` is the identity."""
    nphi = grid.nphi
    if nphi == 1:
        return Tin
    inv_r2dphi2 = phi_eigenvalue_factors(grid, Tin.dtype, Tin.device)
    fac = theta * mat.alpha * dt * inv_r2dphi2                  # (nr,)
    k = torch.arange(nphi // 2 + 1, dtype=Tin.dtype, device=Tin.device)
    cosk = torch.cos(2.0 * math.pi * k / nphi)
    lam = 1.0 + 2.0 * fac[:, None] * (1.0 - cosk[None, :])     # (nr, K)
    F = torch.fft.rfft(Tin, dim=1)
    F = F / lam[:, :, None]
    return torch.fft.irfft(F, n=nphi, dim=1).to(Tin.dtype)
