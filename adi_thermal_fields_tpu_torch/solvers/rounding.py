"""float32 -> bfloat16 stores: round to nearest, or stochastically.

Counterpart: ``adi_thermal_fields_tpu/dist/cartesian_pallas.py::
_stoch_round_bf16`` (:30-42) and the ``pltpu.stochastic_round`` stores of
the bf16 Pallas kernels.  The bit trick is the JAX one: add 16 random low
bits to the float32 bit pattern and truncate to its upper 16 bits, so a
value between two bf16 neighbours rounds up with probability equal to its
distance from the lower one (unbiased), and a value that is a bf16 number
is kept exactly.

The random bits are a counter-based integer hash (no generator state) of
the step's seed, the sweep's offset (0 for the stencil, 1-3 for the x, y
and z sweeps, as the JAX step's ``rng_seed + k``) and the cell's linear
index in the natural (x, y, z) layout: they depend on nothing else, not on
a kernel's block shape or launch order.  So a kernel and its plain version
given the same float32 value round it to the same bf16 number.  The JAX
bits come from the TPU's generator, so the realisation differs from
JAX's; its statistics do not.

``sr_key(seed, offset)`` folds the two into the 32-bit key that the CUDA
entry points take (``csrc/common.cuh`` ``atf::sr_bits`` repeats
``sr_bits`` here); a negative key means round to nearest.
"""
from __future__ import annotations

import torch

__all__ = ["NEAREST", "sr_key", "sr_bits", "natural_index", "widen",
           "to_state", "round_bf16"]

NEAREST = -1      # the C entry points' key for round-to-nearest stores
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mix_int(x: int) -> int:
    """The 32-bit integer finaliser of ``sr_bits`` on a Python int."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


def sr_key(seed: int | None, offset: int = 0) -> int:
    """The 32-bit key of ``(seed, offset)``, or ``NEAREST`` for no seed.

    ``seed`` is the step counter (any int; taken modulo 2^32), ``offset``
    the pass within the step."""
    if seed is None:
        return NEAREST
    return _mix_int((int(seed) & _M32) ^ _mix_int(int(offset) + _GOLDEN))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32), without
    overflowing int64: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sr_bits(key: int, idx: torch.Tensor) -> torch.Tensor:
    """The 32 random bits (int64 in [0, 2^32)) of each linear index
    ``idx`` (int64) under ``key``: ``mix(mix(lo(idx) ^ key) + hi(idx))``."""
    lo = idx & _M32
    hi = idx >> 32
    return _mix((_mix(lo ^ key) + hi) & _M32)


def natural_index(shape, device) -> torch.Tensor:
    """Each cell's linear index in a C-contiguous field of ``shape``."""
    n = 1
    for s in shape:
        n *= s
    return torch.arange(n, dtype=torch.int64, device=device).view(shape)


def widen(t: torch.Tensor | None) -> torch.Tensor | None:
    """A bfloat16 field at its solve type, float32; others unchanged."""
    return t.float() if t is not None and t.dtype == torch.bfloat16 else t


def to_state(x: torch.Tensor, dtype: torch.dtype, key: int = NEAREST,
             idx: torch.Tensor | None = None) -> torch.Tensor:
    """A solve's result ``x`` stored at the state ``dtype``: unchanged for
    float32 and float64, ``round_bf16`` for bfloat16."""
    if dtype != torch.bfloat16:
        return x
    return round_bf16(x, key, idx)


def round_bf16(x: torch.Tensor, key: int = NEAREST,
               idx: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` (float32) as bfloat16: round to nearest for ``key`` < 0, else
    stochastically with the bits of ``sr_bits(key, idx)``; ``idx``
    defaults to the natural linear index of ``x``'s shape."""
    x = x.to(torch.float32)
    if key < 0:
        return x.to(torch.bfloat16)
    if idx is None:
        idx = natural_index(x.shape, x.device)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    bits = ((bits + (sr_bits(key, idx) & 0xFFFF)) & _M32) >> 16
    # to a signed 16-bit pattern, then reinterpret as bfloat16
    return ((bits ^ 0x8000) - 0x8000).to(torch.int16).view(torch.bfloat16)
