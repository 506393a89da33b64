"""The explicit theta-pass stencil: kernel K3 and its plain version.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_stencil.py::theta_rhs``
(:115, body ``_theta_rhs_kernel`` :47).  CUDA source: ``csrc/stencil.cu``.

``R0 = T + (c*M) * sum_ax inv_ax * (m_lo*T_lo + m_hi*T_hi - (m_lo+m_hi)*T)``
with M the cell's mask and m_lo/m_hi its neighbors' masks as 0/1
multiplies (0 beyond the domain edge), accumulated x, then y, then z — the
TPU kernel's order.  Void cells return T unchanged.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..bc.faces import shift_in
from ..kernels import (STATE_DTYPES, check_kernel_inputs, dtype_code,
                       load_library, ptr, raise_on_error, stream_ptr,
                       use_kernel)
from .rounding import sr_key, to_state, widen

__all__ = ["theta_rhs", "theta_rhs_plain"]


def _inv3(inv_d2) -> tuple[float, float, float]:
    """A scalar 1/d^2 (cubic voxels) or a per-axis triple, as 3 floats."""
    if isinstance(inv_d2, (int, float)):
        return (float(inv_d2),) * 3
    iv = tuple(float(v) for v in inv_d2)
    if len(iv) != 3:
        raise ValueError(f"inv_d2 must be a scalar or 3 values, got {iv}")
    return iv


def theta_rhs_plain(T, mask_u8, c, inv_d2, *, rng_seed=None, rng_offset=0):
    """Plain version of K3 (any device); a bfloat16 T at float32, R0
    stored back by ``to_state``."""
    dtype = T.dtype
    T = widen(T)
    M = (mask_u8 != 0).to(T.dtype)
    acc = None
    for ax, iv in enumerate(_inv3(inv_d2)):
        ml = shift_in(M, ax, -1, fill=0.0)
        mh = shift_in(M, ax, +1, fill=0.0)
        s = ml * shift_in(T, ax, -1, fill=0.0) + mh * shift_in(T, ax, +1,
                                                              fill=0.0)
        term = (s - (ml + mh) * T) * iv
        acc = term if acc is None else acc + term
    return to_state(T + (c * M) * acc, dtype, sr_key(rng_seed, rng_offset))


def theta_rhs(T: torch.Tensor, mask_u8: torch.Tensor, c: float,
              inv_d2, *, rng_seed: int | None = None,
              rng_offset: int = 0) -> torch.Tensor:
    """K3: ``R0 = T + c*(Lx+Ly+Lz) T`` with mask-aware Laplacians.

    ``c`` is ``dt*kappa*(1-theta)``; ``inv_d2`` a scalar ``1/dx^2`` or the
    per-axis triple; ``mask_u8`` the solid mask as uint8 (nonzero =
    in-mask).  A bfloat16 T is computed at float32 and R0 rounded to
    nearest, or stochastically with ``rng_seed`` / ``rng_offset``
    (solvers/rounding.py)."""
    if not use_kernel(T, mask_u8):
        return theta_rhs_plain(T, mask_u8, c, inv_d2, rng_seed=rng_seed,
                               rng_offset=rng_offset)
    if T.dim() != 3:
        raise ValueError(f"theta_rhs: field must be 3-D, got {T.dim()}")
    check_kernel_inputs("theta_rhs", T, mask_u8, dtypes=STATE_DTYPES)
    ivx, ivy, ivz = _inv3(inv_d2)
    out = torch.empty_like(T)
    err = load_library().atf_theta_rhs(
        dtype_code(T.dtype), T.device.index, ptr(T), ptr(mask_u8), ptr(out),
        *T.shape, c, ivx, ivy, ivz, sr_key(rng_seed, rng_offset),
        stream_ptr(T.device))
    raise_on_error(err, "theta_rhs")
    counter = theta_rhs.bf16 if T.dtype == torch.bfloat16 else theta_rhs
    counter.launches += 1
    return out


theta_rhs.launches = 0
theta_rhs.bf16 = SimpleNamespace(launches=0)   # the bfloat16 entry
