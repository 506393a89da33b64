"""Masked-Robin cylindrical sweeps: kernels K9, K10 and K11 with their plain
versions.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_fields.py`` —
``fused_masked_sweep`` (:655; pipelined site :744 and streaming site
:802) -> K9 ``masked_sweep_strided`` (its solve-leading forms) and K10
``masked_sweep_z`` (its ``nat_rhs_out`` form); ``fused_masked_cyclic_axis1``
(:977) -> K11 ``masked_cyclic_phi``.  CUDA source: ``csrc/masked.cu``.

Row i of a sweep, from the uint8 code (bits 1/2 = coupling to i-1/i+1, 4 =
pinned row, 8 = in-mask), the Robin sink, ``srhs`` (sink*T_inf on live
rows, the pin value on pinned rows) and the per-row geometry glo/ghi:

    a = -fac*glo[i]*low,  c = -fac*ghi[i]*high,
    b = 1 + fac*(glo[i]*low + ghi[i]*high + sink),
    d = pin ? srhs : (inmask ? rhs + fac*srhs : ambient).

Void and pinned rows are identity rows (code bits 1/2 clear, sink 0).  K9
solves along axis 0 of a C-contiguous field (r of the natural (r, phi, z)
layout), K10 along the contiguous last axis (z) with code, sink and srhs
in the same natural layout (the JAX z sweep reads them solve-leading), and
K11 along axis 1 of a (B1, n, B2) field (phi) as a periodic system whose
wrap couplings are row 0's ``a`` and row n-1's ``c``, with one geometry
value per system (``geo``, shape (B1, B2)).

K9 marches a thread a line on lines of up to ``kK9MarchRows`` rows
(``csrc/masked.cu``; every cylindrical configuration in the repo has r
lines of 64 rows or fewer), c' in shared memory and d' in registers,
repeating its plain version's arithmetic bit for bit; longer lines go to
the core's strided split kernel on K10's rows (within the split kernels'
gate, float32 blocks past ``kK10Stiff`` in Thomas order).  K10 forms its
rows so but solves each line split across a warp's lanes, on the staged
split-line kernel of ``csrc/split_staged.cuh`` (lines too long to stage on
the core's strided kernel), with no c'/d' scratch; at float32 a line with
a row past ``kK10Stiff`` (``csrc/masked.cu``) is solved again in Thomas
order, bit for bit ``thomas``.  K11 forms its rows so but solves each line
split across the block's warps with the wrap by Sherman-Morrison
(``csrc/split_cyclic.cuh``), except on blocks of stiff rings (past
``kK11Stiff``), which it solves in Thomas order, bit for bit
``cyclic_thomas``; it refuses lines too long for that replay's shared
memory (past ~91,000 rows at float32, ~22,000 at float64).  Each wrapper
runs its plain version on CPU tensors and its kernel on CUDA tensors (or
raises), and counts the launches in ``launches``.
"""
from __future__ import annotations

import torch

from ..kernels import (check_kernel_inputs, check_vectors, dtype_code,
                       load_library, ptr, raise_on_error, stream_ptr,
                       use_kernel)
from .fields import stiff_flags
from .thomas import cyclic_thomas, thomas

__all__ = ["masked_sweep_strided", "masked_sweep_strided_plain",
           "masked_sweep_z", "masked_sweep_z_plain", "masked_cyclic_phi",
           "masked_cyclic_phi_plain"]

_LOW, _HIGH, _PIN, _INMASK = 1, 2, 4, 8


def _prefold(rhs, code, srhs, fac, ambient):
    """d of the rows: the pin value, the live rhs + fac*srhs, or ambient."""
    return torch.where((code & _PIN) != 0, srhs,
                       torch.where((code & _INMASK) != 0, rhs + fac * srhs,
                                   ambient))


def _masked_plain(rhs, code, sink, srhs, glo, ghi, fac, ambient, axis):
    """The row formula (glo/ghi along ``axis``), then ``thomas``."""
    shape = [1] * rhs.dim()
    shape[axis] = -1
    low = ((code & _LOW) != 0).to(rhs.dtype)
    high = ((code & _HIGH) != 0).to(rhs.dtype)
    al = glo.view(shape) * low
    ch = ghi.view(shape) * high
    b = 1.0 + fac * (al + ch + sink)
    d = _prefold(rhs, code, srhs, fac, ambient)
    mv = (lambda t: t.movedim(axis, 0))
    x = thomas(mv(-fac * al), mv(b), mv(-fac * ch), mv(d))
    return x.movedim(0, axis).contiguous()


def masked_sweep_strided_plain(rhs, code, sink, srhs, glo, ghi, fac,
                               ambient):
    """Plain version of K9 (any device)."""
    return _masked_plain(rhs, code, sink, srhs, glo, ghi, fac, ambient, 0)


def masked_sweep_z_plain(rhs, code, sink, srhs, glo, ghi, fac, ambient):
    """Plain version of K10 (any device)."""
    return _masked_plain(rhs, code, sink, srhs, glo, ghi, fac, ambient,
                         rhs.dim() - 1)


def masked_cyclic_phi_plain(rhs, code, sink, srhs, geo, fac, ambient):
    """Plain version of K11 (any device): the cyclic systems built
    explicitly and solved by ``cyclic_thomas`` along axis 1."""
    g3 = geo[:, None, :]
    a = torch.where((code & _LOW) != 0, -fac * g3, 0.0)
    c = torch.where((code & _HIGH) != 0, -fac * g3, 0.0)
    b = 1.0 - (a + c) + fac * sink          # void/pinned rows: exactly 1
    d = _prefold(rhs, code, srhs, fac, ambient)
    mv = (lambda t: t.movedim(1, 0))
    return cyclic_thomas(mv(a), mv(b), mv(c), mv(d)).movedim(0, 1) \
        .contiguous()


def _sweep(name, entry, axis, rhs, code, sink, srhs, glo, ghi, fac,
           ambient):
    """Launch K9 (axis 0) or K10 (last axis; ``stiff_flags``' byte a
    line) on CUDA tensors."""
    check_kernel_inputs(name, rhs, code, sink, srhs)
    n = rhs.shape[axis]
    check_vectors(name, rhs, n, glo, ghi)
    out = torch.empty_like(rhs)
    if axis == 0:
        sizes, extra = (n, rhs.numel() // n), ()
    else:
        sizes = (rhs.numel() // n, n)
        extra = (ptr(stiff_flags(rhs, sizes[0])),)
    err = getattr(load_library(), entry)(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(code),
        ptr(sink), ptr(srhs), ptr(glo), ptr(ghi), ptr(out), *extra,
        *sizes, fac, ambient, stream_ptr(rhs.device))
    raise_on_error(err, name)
    return out


def masked_sweep_strided(rhs: torch.Tensor, code: torch.Tensor,
                         sink: torch.Tensor, srhs: torch.Tensor,
                         glo: torch.Tensor, ghi: torch.Tensor, fac: float,
                         ambient: float) -> torch.Tensor:
    """K9: masked-Robin sweep along axis 0 of a C-contiguous field (the r
    sweep of the natural (r, phi, z) field); ``glo``/``ghi``: (n,)
    per-row geometry; ``fac = dt*alpha`` at the field's dtype."""
    if not use_kernel(rhs, code, sink, srhs, glo, ghi):
        return masked_sweep_strided_plain(rhs, code, sink, srhs, glo, ghi,
                                          fac, ambient)
    out = _sweep("masked_sweep_strided", "atf_masked_sweep_strided", 0, rhs,
                 code, sink, srhs, glo, ghi, fac, ambient)
    masked_sweep_strided.launches += 1
    return out


masked_sweep_strided.launches = 0


def masked_sweep_z(rhs: torch.Tensor, code: torch.Tensor, sink: torch.Tensor,
                   srhs: torch.Tensor, glo: torch.Tensor, ghi: torch.Tensor,
                   fac: float, ambient: float) -> torch.Tensor:
    """K10: masked-Robin sweep along the contiguous last axis (z of the
    natural field), every input in that natural layout; split across a
    warp's lanes (within the split kernels' gate of ``thomas``)."""
    if not use_kernel(rhs, code, sink, srhs, glo, ghi):
        return masked_sweep_z_plain(rhs, code, sink, srhs, glo, ghi, fac,
                                    ambient)
    out = _sweep("masked_sweep_z", "atf_masked_sweep_z", rhs.dim() - 1, rhs,
                 code, sink, srhs, glo, ghi, fac, ambient)
    masked_sweep_z.launches += 1
    return out


masked_sweep_z.launches = 0


def masked_cyclic_phi(rhs: torch.Tensor, code: torch.Tensor,
                      sink: torch.Tensor, srhs: torch.Tensor,
                      geo: torch.Tensor, fac: float,
                      ambient: float) -> torch.Tensor:
    """K11: mask-broken periodic sweep along axis 1 of a (B1, n, B2) field
    (phi of the natural field); ``geo``: (B1, B2) per-system geometry.  The
    code's bits 1/2 carry the wrap couplings of rows 0 and n-1."""
    if rhs.dim() != 3 or rhs.shape[1] < 2:
        raise ValueError("masked_cyclic_phi solves periodic lines of length "
                         f">= 2 along axis 1 of a 3-D field, got "
                         f"{tuple(rhs.shape)}")
    if not use_kernel(rhs, code, sink, srhs, geo):
        return masked_cyclic_phi_plain(rhs, code, sink, srhs, geo, fac,
                                       ambient)
    check_kernel_inputs("masked_cyclic_phi", rhs, code, sink, srhs)
    B1, n, B2 = rhs.shape
    if (geo.shape != (B1, B2) or geo.dtype != rhs.dtype
            or not geo.is_contiguous()):
        raise ValueError(f"masked_cyclic_phi: geo must be contiguous "
                         f"({B1}, {B2}) {rhs.dtype}")
    out = torch.empty_like(rhs)
    err = load_library().atf_masked_cyclic_phi(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(code),
        ptr(sink), ptr(srhs), ptr(geo), ptr(out), B1, n, B2, fac, ambient,
        stream_ptr(rhs.device))
    raise_on_error(err, "masked_cyclic_phi")
    masked_cyclic_phi.launches += 1
    return out


masked_cyclic_phi.launches = 0
