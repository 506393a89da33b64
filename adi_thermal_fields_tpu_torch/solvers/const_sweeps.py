"""Constant-row cylindrical sweeps: kernels K12, K13 and K14 with their
plain versions.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_sweeps.py`` —
``fused_sweep_const`` (:1567) -> K12 ``const_sweep_strided`` (its axis-0
form, body ``_const_sweep_kernel`` :1479) and K13 ``const_sweep_z`` (its
``nat_rhs_out`` form, body ``_const_sweep_kernel_nat`` :1512); the
``fused_cyclic_const`` family (:1727, ``_axis1`` :1851, ``_nat`` :1958,
one computation in three TPU layouts) -> K14 ``cyclic_const_phi``.  CUDA
source: ``csrc/const_sweeps.cu``.

K12 and K13 solve ``a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i] +
radd[i]`` with per-row scalar coefficient vectors (shape (n,)) along axis
0 of a C-contiguous field (r of the natural (r, phi, z) field) and along
its contiguous last axis (z), by the Pallas bodies' recurrence with
reciprocal multiplies; ``a[0]`` and ``c[n-1]`` are ignored.  K14 solves
the periodic system ``(I - fac L_per) x = d`` along axis 1 of a (B1, n,
B2) field (phi), ``a = c = -fac``, ``b = 1 + 2 fac``, by Sherman-Morrison
with gauge ``gamma = -b``, with one ``fac`` per B1 index (per ring).

The coefficients depend on the row (K14: the ring and the row) only, so
``inv[i] = 1/(b[i] - a[i] cp[i-1])``, ``cp[i] = c[i] inv[i]`` and K14's
Sherman-Morrison vector z are computed once per row or ring, by the plain
versions and the kernels alike, and each line carries only its rhs.

Each wrapper checks its inputs on every device (float32/float64,
contiguous, (n,) coefficient vectors of the field's dtype), then runs its
plain version on CPU tensors and its kernel on CUDA tensors (or raises),
and counts the launches in ``launches``.
"""
from __future__ import annotations

import torch

from ..kernels import (check_vectors, dtype_code, load_library, ptr,
                       raise_on_error, stream_ptr, use_kernel)

__all__ = ["const_sweep_strided", "const_sweep_strided_plain",
           "const_sweep_z", "const_sweep_z_plain", "cyclic_const_phi",
           "cyclic_const_phi_plain"]


def _row_factors(a, b, c):
    """``inv`` and ``cp`` of the rows along axis 0 (trailing axes batch)."""
    inv = torch.empty_like(b)
    cp = torch.empty_like(b)
    cp_prev = torch.zeros_like(b[0])
    for i in range(b.shape[0]):
        torch.reciprocal(b[i] - a[i] * cp_prev, out=inv[i])
        torch.mul(c[i], inv[i], out=cp[i])
        cp_prev = cp[i]
    return inv, cp


def _const_plain(rhs, a, b, c, radd, axis):
    """The constant-row solve along ``axis``, as per-row vector ops over the
    other axes."""
    inv, cp = _row_factors(a, b, c)
    d = rhs.movedim(axis, 0)
    out = torch.empty_like(d)
    dp = torch.zeros_like(d[0])
    for i in range(d.shape[0]):
        torch.mul((d[i] + radd[i]) - a[i] * dp, inv[i], out=out[i])
        dp = out[i]
    x = torch.zeros_like(d[0])
    for i in range(d.shape[0] - 1, -1, -1):
        torch.sub(out[i], cp[i] * x, out=out[i])
        x = out[i]
    return out.movedim(0, axis).contiguous()


def const_sweep_strided_plain(rhs, a, b, c, radd):
    """Plain version of K12 (any device)."""
    return _const_plain(rhs, a, b, c, radd, 0)


def const_sweep_z_plain(rhs, a, b, c, radd):
    """Plain version of K13 (any device)."""
    return _const_plain(rhs, a, b, c, radd, rhs.dim() - 1)


def cyclic_const_phi_plain(rhs, fac):
    """Plain version of K14 (any device): ``_cyclic_const_kernel``'s
    operations along axis 1, the ring's system (inv, cp, z) once per
    ring."""
    n = rhs.shape[1]
    f = fac[:, None]                     # (B1, 1): broadcast over B2
    a = -f
    b = 1.0 + 2.0 * f
    gamma = -b
    b0 = 2.0 * b                         # b - gamma
    bn = b - a * a / gamma               # b - alpha*beta/gamma
    zero = torch.zeros_like(a)
    av = torch.stack([zero] + [a] * (n - 1))
    cv = torch.stack([a] * (n - 1) + [zero])
    bv = torch.stack([b0] + [b] * (n - 2) + [bn])
    uv = torch.stack([gamma] + [zero] * (n - 2) + [a])
    inv, cp = _row_factors(av, bv, cv)   # (n, B1, 1)
    z = torch.empty_like(uv)
    dz = zero
    for i in range(n):
        torch.mul(uv[i] - av[i] * dz, inv[i], out=z[i])
        dz = z[i]
    zn = zero
    for i in range(n - 1, -1, -1):
        torch.sub(z[i], cp[i] * zn, out=z[i])
        zn = z[i]
    y = torch.empty_like(rhs)
    dy = torch.zeros_like(rhs[:, 0])
    for i in range(n):
        torch.mul(rhs[:, i] - av[i] * dy, inv[i], out=y[:, i])
        dy = y[:, i]
    yn = torch.zeros_like(dy)
    for i in range(n - 1, -1, -1):
        torch.sub(y[:, i], cp[i] * yn, out=y[:, i])
        yn = y[:, i]
    fact = ((y[:, 0] + a * y[:, n - 1] / gamma)
            / (1.0 + z[0] + a * z[n - 1] / gamma))
    return y - fact[:, None, :] * z.movedim(0, 1)


def _check(name, rhs, n, *vecs):
    if rhs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: field dtype {rhs.dtype} is not supported "
                        "(float32 or float64)")
    if not rhs.is_contiguous():
        raise ValueError(f"{name}: the field must be contiguous")
    check_vectors(name, rhs, n, *vecs)


def _sweep(name, entry, axis, rhs, a, b, c, radd):
    """Launch K12 (axis 0) or K13 (last axis) on CUDA tensors."""
    n = rhs.shape[axis]
    out = torch.empty_like(rhs)
    sizes = (n, rhs.numel() // n) if axis == 0 else (rhs.numel() // n, n)
    err = getattr(load_library(), entry)(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(a), ptr(b),
        ptr(c), ptr(radd), ptr(out), *sizes, stream_ptr(rhs.device))
    raise_on_error(err, name)
    return out


def const_sweep_strided(rhs: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, radd: torch.Tensor) -> torch.Tensor:
    """K12: constant-row sweep along axis 0 of a C-contiguous field (the r
    sweep of the natural (r, phi, z) field); ``a, b, c, radd``: (n,)."""
    kernel = use_kernel(rhs, a, b, c, radd)
    _check("const_sweep_strided", rhs, rhs.shape[0], a, b, c, radd)
    if not kernel:
        return const_sweep_strided_plain(rhs, a, b, c, radd)
    out = _sweep("const_sweep_strided", "atf_const_sweep_strided", 0, rhs, a,
                 b, c, radd)
    const_sweep_strided.launches += 1
    return out


const_sweep_strided.launches = 0


def const_sweep_z(rhs: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, radd: torch.Tensor) -> torch.Tensor:
    """K13: constant-row sweep along the contiguous last axis (z of the
    natural field); ``a, b, c, radd``: (n,)."""
    kernel = use_kernel(rhs, a, b, c, radd)
    _check("const_sweep_z", rhs, rhs.shape[-1], a, b, c, radd)
    if not kernel:
        return const_sweep_z_plain(rhs, a, b, c, radd)
    out = _sweep("const_sweep_z", "atf_const_sweep_z", rhs.dim() - 1, rhs, a,
                 b, c, radd)
    const_sweep_z.launches += 1
    return out


const_sweep_z.launches = 0


def cyclic_const_phi(rhs: torch.Tensor, fac: torch.Tensor) -> torch.Tensor:
    """K14: periodic constant-coefficient solve ``(I - fac L_per) x = rhs``
    along axis 1 of a (B1, n, B2) field (phi of the natural field);
    ``fac``: (B1,), one value per ring."""
    if rhs.dim() != 3 or rhs.shape[1] < 2:
        raise ValueError("cyclic_const_phi solves periodic lines of length "
                         f">= 2 along axis 1 of a 3-D field, got "
                         f"{tuple(rhs.shape)}")
    kernel = use_kernel(rhs, fac)
    B1, n, B2 = rhs.shape
    _check("cyclic_const_phi", rhs, B1, fac)
    if not kernel:
        return cyclic_const_phi_plain(rhs, fac)
    out = torch.empty_like(rhs)
    err = load_library().atf_cyclic_const_phi(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(fac),
        ptr(out), B1, n, B2, stream_ptr(rhs.device))
    raise_on_error(err, "cyclic_const_phi")
    cyclic_const_phi.launches += 1
    return out


cyclic_const_phi.launches = 0
