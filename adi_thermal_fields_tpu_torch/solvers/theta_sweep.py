"""The explicit theta-pass fused into the plan-lite x-sweep: kernel K4.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_theta_sweep.py::
fused_theta_sweep_axis0`` (:454; its ring kernel ``_theta_sweep_ring``
:551 and halo-DMA kernel :54 compute the same function).  CUDA source:
``csrc/theta_sweep.cu``.

``U = A_x^{-1} [(I + c_exp L) T + dt*cf*t_inf]``: the mask-aware Laplacian
of K3 evaluated from the x-sweep code's neighbor bits (1/2 = x, 16/32 = y,
64/128 = z, 8 = in-mask; ``sweep_code(mask, None, 0, stencil_bits=True)``)
and fed straight into K1's plan-lite solve along x, each line split
across threads (csrc/split_line.cuh): no c'/d' scratch.  Scope: plan-lite
(scalar-h Robin), no Neumann fold, no Dirichlet pins.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..bc.faces import shift_in
from ..kernels import (STATE_DTYPES, check_kernel_inputs, dtype_code,
                       load_library, ptr, raise_on_error, stream_ptr,
                       use_kernel)
from .rounding import sr_key, to_state, widen
from .stencil import _inv3
from .sweeps import _solve_plain

__all__ = ["fused_theta_sweep", "fused_theta_sweep_plain"]


def fused_theta_sweep_plain(T, code, c_exp, inv_d2, tg, dt, t_inf, rob_c,
                            *, rng_seed=None, rng_offset=0):
    """Plain version of K4 (any device): the stencil from the code bits,
    accumulated x, y, z as in K3, then the plain lite x-sweep; a bfloat16
    T at float32, U stored back by ``to_state``."""
    state = T.dtype
    T = widen(T)
    dtype = T.dtype
    bit = (lambda b: ((code & b) != 0).to(dtype))
    acc = None
    for (ax, b_lo, b_hi), iv in zip(((0, 1, 2), (1, 16, 32), (2, 64, 128)),
                                    _inv3(inv_d2)):
        ml, mh = bit(b_lo), bit(b_hi)
        s = ml * shift_in(T, ax, -1, fill=0.0) + mh * shift_in(T, ax, +1,
                                                              fill=0.0)
        term = (s - (ml + mh) * T) * iv
        acc = term if acc is None else acc + term
    d = T + (c_exp * bit(8)) * acc
    x = _solve_plain(d, code, 0, tg, dt, t_inf, None, rob_c, None)
    return to_state(x, state, sr_key(rng_seed, rng_offset))


def fused_theta_sweep(T: torch.Tensor, code: torch.Tensor, c_exp: float,
                      inv_d2, tg: float, dt: float, t_inf: float,
                      rob_c: float, *, rng_seed: int | None = None,
                      rng_offset: int = 0) -> torch.Tensor:
    """K4: fused explicit theta-pass + plan-lite x-sweep on the natural
    (x, y, z) field.  ``c_exp = dt*kappa*(1-theta)``; ``inv_d2`` per-axis
    1/d^2; ``tg`` and ``rob_c`` are the x axis' values.  A bfloat16 T
    solves at float32 and U is rounded as K1's result."""
    if not use_kernel(T, code):
        return fused_theta_sweep_plain(T, code, c_exp, inv_d2, tg, dt,
                                       t_inf, rob_c, rng_seed=rng_seed,
                                       rng_offset=rng_offset)
    if T.dim() != 3:
        raise ValueError(
            f"fused_theta_sweep: field must be 3-D, got {T.dim()}")
    check_kernel_inputs("fused_theta_sweep", T, code, dtypes=STATE_DTYPES)
    ivx, ivy, ivz = _inv3(inv_d2)
    out = torch.empty_like(T)
    err = load_library().atf_theta_sweep(
        dtype_code(T.dtype), T.device.index, ptr(T), ptr(code), ptr(out),
        *T.shape, c_exp, ivx, ivy, ivz, tg, dt, t_inf, rob_c,
        sr_key(rng_seed, rng_offset), stream_ptr(T.device))
    raise_on_error(err, "fused_theta_sweep")
    counter = (fused_theta_sweep.bf16 if T.dtype == torch.bfloat16
               else fused_theta_sweep)
    counter.launches += 1
    return out


fused_theta_sweep.launches = 0
fused_theta_sweep.bf16 = SimpleNamespace(launches=0)   # the bfloat16 entry
