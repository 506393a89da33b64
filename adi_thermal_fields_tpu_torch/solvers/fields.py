"""Tridiagonal solves with general field coefficients: kernels K21 and K22
with their plain versions.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_fields.py`` —
``fused_tridiag_fields`` (:129, body ``_field_kernel`` :40) -> K21
``tridiag_fields`` and ``fused_cyclic_fields`` (:311, body
``_cyclic_field_kernel`` :179) -> K22 ``cyclic_fields``.  CUDA source:
``csrc/fields.cu``.

The JAX kernels solve along axis 0 of (n, B1, B2) arrays, so their callers
move the solve axis to the front (a transpose pair per sweep).  Here the
coefficients stay in the caller's natural layout and the wrapper names the
solve axis: K21 runs a strided entry for any axis but the last and a
staged entry for the contiguous last axis, both on the split-line core
(``csrc/split_line.cuh``: chunks in registers, the reduced system by
cyclic reduction, no c'/d' scratch; the hardware reciprocal at float32,
divisions at float64), within a few float32 ulp of the output's scale of
its plain version (at float32 a block of lines with a row past the
stiffness ratio ``kOpenStiff`` of ``csrc/field_rows.cuh`` is solved again
in Thomas order, bit for bit); K22 runs the periodic solve along any axis
of a (B1, n, B2) view on the periodic split-line kernel
(``csrc/split_cyclic.cuh``: Sherman-Morrison's second right-hand side in
the reduced system only, rounded divisions, no c'/y/z scratch), as near
its plain version (at float32 a block of lines with a row past
``kCyclicFieldStiff`` is solved again in Thomas order, bit for bit; lines
on which that replay does not fit in shared memory, past ~91,000 rows at
float32 and ~22,000 at float64, are refused).  Plain versions:
``thomas`` and ``cyclic_thomas`` (``a[0]`` and ``c[n-1]`` ignored by the
open solve; the wrap couplings of the periodic one).
"""
from __future__ import annotations

import math

import torch

from ..kernels import dtype_code, load_library, ptr, raise_on_error, \
    stream_ptr, use_kernel
from .thomas import cyclic_thomas, thomas

__all__ = ["tridiag_fields", "tridiag_fields_plain", "cyclic_fields",
           "cyclic_fields_plain", "stiff_flags"]


def _check(name, d, axis, *coeffs):
    """Contiguous float32/float64 a, b, c, d of one shape; a valid axis."""
    if d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: field dtype {d.dtype} is not supported "
                        "(float32 or float64)")
    if not 0 <= axis < d.dim():
        raise ValueError(f"{name}: axis {axis} out of range for a "
                         f"{d.dim()}-D field")
    for t in (*coeffs, d):
        if t.shape != d.shape or t.dtype != d.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: a, b, c and d must be contiguous "
                             f"{tuple(d.shape)} {d.dtype} tensors, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _view3(shape, axis):
    """(B1, n, B2) of a C-contiguous field solved along ``axis``."""
    return (math.prod(shape[:axis]), shape[axis],
            math.prod(shape[axis + 1:]))


def stiff_flags(ref: torch.Tensor, lines: int) -> torch.Tensor | None:
    """The staged z entries' byte a line (K17, K21): at float32 the kernel
    flags the lines it solves again in Thomas order there (none at
    float64).  A buffer of the caching allocator, not scratch of the
    solve."""
    if ref.dtype != torch.float32:
        return None
    return torch.empty(lines, dtype=torch.uint8, device=ref.device)


def tridiag_fields_plain(a, b, c, d, axis: int = 0):
    """Plain version of K21: ``thomas`` along ``axis``."""
    mv = (lambda t: t.movedim(axis, 0))
    return thomas(mv(a), mv(b), mv(c), mv(d)).movedim(0, axis).contiguous()


def tridiag_fields(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   d: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """K21: solve ``a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]`` along
    ``axis`` of C-contiguous coefficient fields (``a[0]`` and ``c[n-1]``
    ignored), result in the same layout."""
    if not use_kernel(a, b, c, d):
        return tridiag_fields_plain(a, b, c, d, axis)
    name = "tridiag_fields"
    _check(name, d, axis, a, b, c)
    out = torch.empty_like(d)
    B1, n, B2 = _view3(tuple(d.shape), axis)
    lib = load_library()
    if B2 == 1:          # the contiguous last axis: the staged entry
        flags = stiff_flags(d, B1)
        err = lib.atf_tridiag_fields_z(
            dtype_code(d.dtype), d.device.index, ptr(a), ptr(b), ptr(c),
            ptr(d), ptr(out), ptr(flags), B1, n, stream_ptr(d.device))
    else:
        err = lib.atf_tridiag_fields_strided(
            dtype_code(d.dtype), d.device.index, ptr(a), ptr(b), ptr(c),
            ptr(d), ptr(out), B1, n, B2, stream_ptr(d.device))
    raise_on_error(err, name)
    tridiag_fields.launches += 1
    return out


tridiag_fields.launches = 0


def cyclic_fields_plain(a, b, c, d, axis: int = 1):
    """Plain version of K22: ``cyclic_thomas`` along ``axis``."""
    mv = (lambda t: t.movedim(axis, 0))
    return cyclic_thomas(mv(a), mv(b), mv(c), mv(d)).movedim(0, axis) \
        .contiguous()


def cyclic_fields(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  d: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """K22: the periodic solve along ``axis`` (length >= 2) of C-contiguous
    coefficient fields: row 0 couples to the last row by ``a[0]`` and the
    last row to row 0 by ``c[n-1]`` (``cyclic_thomas``, gauge
    ``-b[0]``).  The last axis (B2 = 1) is solved too, with one line of
    each warp's 32 busy."""
    if d.shape[axis] < 2:
        raise ValueError("cyclic_fields solves periodic lines of length "
                         f">= 2, got {d.shape[axis]} along axis {axis}")
    if not use_kernel(a, b, c, d):
        return cyclic_fields_plain(a, b, c, d, axis)
    name = "cyclic_fields"
    _check(name, d, axis, a, b, c)
    out = torch.empty_like(d)
    B1, n, B2 = _view3(tuple(d.shape), axis)
    err = load_library().atf_cyclic_fields(
        dtype_code(d.dtype), d.device.index, ptr(a), ptr(b), ptr(c), ptr(d),
        ptr(out), B1, n, B2, stream_ptr(d.device))
    raise_on_error(err, name)
    cyclic_fields.launches += 1
    return out


cyclic_fields.launches = 0
