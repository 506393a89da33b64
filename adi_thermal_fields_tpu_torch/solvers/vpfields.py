"""Variable-property sweeps from five physical streams: kernels K17 and K18
with their plain versions.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_vpfields.py`` —
``fused_vp_fields_sweep`` (:190; pipelined site :273, body
``_vp_fields_pipe_kernel`` :628; streaming site :324, body
``_vp_fields_kernel`` :53) -> K17 ``vp_fields_sweep_strided``, and
``fused_vp_fields_cyclic_axis1`` (:525; site :611, body
``_vp_cyclic_axis1_kernel`` :342) -> K18 ``vp_fields_cyclic_phi``; and the
forward halves of ``solvers/differentiable.vp_sweep_solve`` (:438) and
``vp_cyclic_solve`` (:494), which are the calls the cylindrical varprop
step makes.  K17 has a second entry, ``vp_fields_sweep_z``: the same
solve along the last axis of the natural (r, phi, z) streams, where the
JAX step solves z on the (z, r, phi) transposes.  CUDA source:
``csrc/vp_fields.cu``.

The streams are the rhs, the hi-face harmonic conductivity ``fhi`` (zero
across void and domain edges), ``dw = dt/(rho cp(T^n))``, the Robin
``sink = sum h*A/V`` and ``srhs = sum h*A/V*T_inf``; per-row geometry
columns ``glo``/``ghi`` carry the metric (zeros at Dirichlet rows, whose
pin the caller folds into the rhs).  Row i of the open sweep (the lo face
is the previous row's hi face):

    al = glo[i]*f_lo, ch = ghi[i]*f_hi, a = -dw*al, c = -dw*ch,
    b = 1 + dw*(al + ch + sink), d = rhs + dw*srhs.

The cyclic sweep reads the lo faces ``flo`` and derives the hi faces by
periodicity, ``fhi[i] = flo[i+1 mod n]``, with one metric ``geo`` per ring:

    al = dw*(geo*flo), ch = dw*(geo*fhi), a = -al, c = -ch,
    b = 1 + dw*(geo*(flo + fhi) + sink), d = rhs + dw*srhs,

solved by Sherman-Morrison (``cyclic_thomas``).  All-zero lines (a full
disk's axis ring, void lines) are identities.  The plain versions build
the rows with one tensor op per operation and solve them with ``thomas`` /
``cyclic_thomas``; the kernels form the same rows one IEEE rounding at a
time, bit for bit.  K17 solves its rows on the split-line core
(``csrc/split_line.cuh``: chunks in registers, the reduced system by
cyclic reduction, no c'/d' scratch; the hardware reciprocal at float32,
divisions at float64), K18 on its periodic kernel
(``csrc/split_cyclic.cuh``: Sherman-Morrison's second right-hand side in
the reduced system only, rounded divisions, no c'/y/z scratch); each
within a few float32 ulp of the output's scale of its plain version (at
float32 a block of lines with a row past the stiffness ratio of
``csrc/field_rows.cuh``, ``kOpenStiff`` or ``kCyclicFieldStiff``, is
solved again in Thomas order, bit for bit).
"""
from __future__ import annotations

import torch

from ..bc.faces import shift_in
from ..kernels import (check_vectors, dtype_code, load_library, ptr,
                       raise_on_error, stream_ptr, use_kernel)
from .fields import stiff_flags
from .thomas import cyclic_thomas, thomas

__all__ = ["vp_fields_sweep_strided", "vp_fields_sweep_strided_plain",
           "vp_fields_sweep_z", "vp_fields_sweep_z_plain",
           "vp_fields_cyclic_phi", "vp_fields_cyclic_phi_plain"]


def _check_streams(name, rhs, *streams):
    """Contiguous float32/float64 streams of one shape and dtype."""
    if rhs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: field dtype {rhs.dtype} is not supported "
                        "(float32 or float64)")
    for t in (rhs, *streams):
        if t.shape != rhs.shape or t.dtype != rhs.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: every stream must be a contiguous "
                             f"{tuple(rhs.shape)} {rhs.dtype} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")


def vp_fields_sweep_strided_plain(rhs, fhi, dw, sink, srhs, glo, ghi):
    """Plain version of K17: the open rows along axis 0, ``thomas``."""
    shape = [-1] + [1] * (rhs.dim() - 1)
    al = glo.view(shape) * shift_in(fhi, 0, -1, fill=0.0)
    ch = ghi.view(shape) * fhi
    a = -dw * al
    c = -dw * ch
    b = 1.0 + dw * (al + ch + sink)
    return thomas(a, b, c, rhs + dw * srhs)


def vp_fields_sweep_strided(rhs: torch.Tensor, fhi: torch.Tensor,
                            dw: torch.Tensor, sink: torch.Tensor,
                            srhs: torch.Tensor, glo: torch.Tensor,
                            ghi: torch.Tensor) -> torch.Tensor:
    """K17: the five-stream sweep along axis 0 of C-contiguous fields (the
    r sweep of the natural (r, phi, z) field; ``vp_fields_sweep_z`` solves
    z).  ``glo``/``ghi``: (n,) geometry columns."""
    if not use_kernel(rhs, fhi, dw, sink, srhs, glo, ghi):
        return vp_fields_sweep_strided_plain(rhs, fhi, dw, sink, srhs, glo,
                                             ghi)
    name = "vp_fields_sweep_strided"
    _check_streams(name, rhs, fhi, dw, sink, srhs)
    n = rhs.shape[0]
    check_vectors(name, rhs, n, glo, ghi)
    out = torch.empty_like(rhs)
    err = load_library().atf_vp_fields_sweep_strided(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(fhi), ptr(dw),
        ptr(sink), ptr(srhs), ptr(glo), ptr(ghi), ptr(out), 1, n,
        rhs.numel() // n, stream_ptr(rhs.device))
    raise_on_error(err, name)
    vp_fields_sweep_strided.launches += 1
    return out


vp_fields_sweep_strided.launches = 0


def vp_fields_sweep_z_plain(rhs, fhi, dw, sink, srhs, glo, ghi):
    """Plain version of K17's z entry: the strided plain version on the
    streams with their last axis moved to the front, moved back."""
    zl = (lambda t: t.movedim(-1, 0).contiguous())
    return vp_fields_sweep_strided_plain(
        *(zl(t) for t in (rhs, fhi, dw, sink, srhs)), glo, ghi) \
        .movedim(0, -1).contiguous()


def vp_fields_sweep_z(rhs: torch.Tensor, fhi: torch.Tensor,
                      dw: torch.Tensor, sink: torch.Tensor,
                      srhs: torch.Tensor, glo: torch.Tensor,
                      ghi: torch.Tensor) -> torch.Tensor:
    """K17's z entry: the five-stream sweep along the contiguous last axis
    of C-contiguous fields (z of the natural (r, phi, z) field), nothing
    permuted.  ``glo``/``ghi``: geometry columns along that axis.  Counted
    as K17's launch."""
    if not use_kernel(rhs, fhi, dw, sink, srhs, glo, ghi):
        return vp_fields_sweep_z_plain(rhs, fhi, dw, sink, srhs, glo, ghi)
    name = "vp_fields_sweep_z"
    _check_streams(name, rhs, fhi, dw, sink, srhs)
    n = rhs.shape[-1]
    check_vectors(name, rhs, n, glo, ghi)
    out = torch.empty_like(rhs)
    flags = stiff_flags(rhs, rhs.numel() // n)
    err = load_library().atf_vp_fields_sweep_z(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(fhi), ptr(dw),
        ptr(sink), ptr(srhs), ptr(glo), ptr(ghi), ptr(out), ptr(flags),
        rhs.numel() // n, n, stream_ptr(rhs.device))
    raise_on_error(err, name)
    vp_fields_sweep_strided.launches += 1
    return out


def vp_fields_cyclic_phi_plain(rhs, flo, dw, sink, srhs, geo):
    """Plain version of K18: the cyclic rows along axis 1 (hi faces
    ``roll(flo, -1)``), ``cyclic_thomas``."""
    g3 = geo[:, None, None]
    fhi = torch.roll(flo, -1, 1)
    al = dw * (g3 * flo)
    ch = dw * (g3 * fhi)
    b = 1.0 + dw * (g3 * (flo + fhi) + sink)
    mv = (lambda t: t.movedim(1, 0))
    return cyclic_thomas(mv(-al), mv(b), mv(-ch), mv(rhs + dw * srhs)) \
        .movedim(0, 1).contiguous()


def vp_fields_cyclic_phi(rhs: torch.Tensor, flo: torch.Tensor,
                         dw: torch.Tensor, sink: torch.Tensor,
                         srhs: torch.Tensor, geo: torch.Tensor
                         ) -> torch.Tensor:
    """K18: the five-stream periodic sweep along axis 1 of (B1, n, B2)
    fields (phi of the natural field); ``flo``: the lo-face conductivities
    (``flo[:, 0]`` is the wrap face); ``geo``: (B1,) metric
    ``1/(r dphi)^2`` per ring."""
    if rhs.dim() != 3 or rhs.shape[1] < 2:
        raise ValueError("vp_fields_cyclic_phi solves periodic lines of "
                         f"length >= 2 along axis 1 of a 3-D field, got "
                         f"{tuple(rhs.shape)}")
    if not use_kernel(rhs, flo, dw, sink, srhs, geo):
        return vp_fields_cyclic_phi_plain(rhs, flo, dw, sink, srhs, geo)
    name = "vp_fields_cyclic_phi"
    _check_streams(name, rhs, flo, dw, sink, srhs)
    B1, n, B2 = rhs.shape
    check_vectors(name, rhs, B1, geo)
    out = torch.empty_like(rhs)
    err = load_library().atf_vp_fields_cyclic_phi(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(flo), ptr(dw),
        ptr(sink), ptr(srhs), ptr(geo), ptr(out), B1, n, B2,
        stream_ptr(rhs.device))
    raise_on_error(err, name)
    vp_fields_cyclic_phi.launches += 1
    return out


vp_fields_cyclic_phi.launches = 0
