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
versions and the kernels alike, and each line carries only its rhs.  The
kernels take their factors from a table (``const_sweep_table`` for K12
and K13, built by a kernel of one thread, and ``cyclic_const_phi_table``
for K14, of one thread a ring; each bit for bit its plain version's; the
step keeps them for its dt).  K12 marches a thread a line on lines of up
to ``kK12MarchRows`` rows (d' in registers): bit for bit its plain
version.  Longer K12 lines, and K13 and K14, split each line across a
block's warps, by run and carry (csrc/const_sweeps.cu): within a few
float32 ulp of the output's scale of their plain versions, except past a
stiffness ratio (K12 and K13: the table's ratio past ``kK12Stiff`` and
``kK13Stiff``; K14: the rings whose 2 fac passes ``kK14Stiff``; constants
of the CUDA source), where they solve in Thomas order, bit for bit.

Each wrapper checks its inputs on every device (float32/float64,
contiguous, (n,) coefficient vectors of the field's dtype), then runs its
plain version on CPU tensors and its kernel on CUDA tensors (or raises),
and counts the launches in ``launches`` (the table kernels in
``const_sweep_table.launches``, "K13t" (K12's table too), and
``cyclic_const_phi_table.launches``, "K14t").
"""
from __future__ import annotations

import torch

from ..kernels import (check_vectors, dtype_code, load_library, ptr,
                       raise_on_error, stream_ptr, use_kernel)

__all__ = ["const_sweep_strided", "const_sweep_strided_plain",
           "const_sweep_table", "const_sweep_table_plain",
           "const_sweep_z", "const_sweep_z_plain", "cyclic_const_phi",
           "cyclic_const_phi_plain", "cyclic_const_phi_table",
           "cyclic_const_phi_table_plain"]

# K12's and K13's table: its values past the 2n factors (the stiffness
# ratio); K14's: its values a ring past the 3n factors (kK14Tail)
K13_TAIL = 1
K14_TAIL = 3


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


def const_sweep_table_plain(a, b, c):
    """Plain version of K12's and K13's table: (2n + 1,) values, ``inv``
    and ``cp`` (``_row_factors``' bit for bit), then the rows' stiffness
    ratio, the largest ``(|a_i| + |c_i|)/(b_i - |a_i| - |c_i|)``
    (``a[0]`` and ``c[n-1]`` do not count; infinity where the denominator
    is not positive)."""
    inv, cp = _row_factors(a, b, c)
    aa, ca = a.abs(), c.abs()
    aa[0] = 0.0
    ca[-1] = 0.0
    off = aa + ca
    den = b - off
    ratio = torch.where(den > 0, off / den, torch.inf).max()
    return torch.cat([inv, cp, ratio[None]])


def _ring_system(fac, n):
    """Each ring's system as cyclic_const_phi_plain forms it: ``a``,
    ``gamma`` ((B1, 1)), the rows' ``av``, ``inv``, ``cp`` and z of B z =
    u ((n, B1, 1)), one operation at a time."""
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
    return a, gamma, av, inv, cp, z


def cyclic_const_phi_plain(rhs, fac):
    """Plain version of K14 (any device): ``_cyclic_const_kernel``'s
    operations along axis 1, the ring's system (inv, cp, z) once per
    ring."""
    n = rhs.shape[1]
    a, gamma, av, inv, cp, z = _ring_system(fac, n)
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


def cyclic_const_phi_table_plain(fac, n):
    """Plain version of K14's table: (B1, 3n + 3) values a ring, ``inv``,
    ``cp`` and ``z`` (n each, bit for bit cyclic_const_phi_plain's), then
    ``den = 1 + z_0 + a z_{n-1}/gamma``, ``a/gamma`` and ``1/den``."""
    a, gamma, _, inv, cp, z = _ring_system(fac, n)
    den = 1.0 + z[0] + a * z[n - 1] / gamma
    return torch.cat([inv[..., 0].T, cp[..., 0].T, z[..., 0].T, den,
                      a / gamma, 1.0 / den], 1).contiguous()


def _check(name, rhs, n, *vecs):
    if rhs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: field dtype {rhs.dtype} is not supported "
                        "(float32 or float64)")
    if not rhs.is_contiguous():
        raise ValueError(f"{name}: the field must be contiguous")
    check_vectors(name, rhs, n, *vecs)


def _check_table(name, rhs, n, table):
    """A K12 or K13 table: (2n + K13_TAIL,), the field's dtype, contiguous."""
    if table is not None and (table.shape != (2 * n + K13_TAIL,)
                              or table.dtype != rhs.dtype
                              or not table.is_contiguous()):
        raise ValueError(f"{name}: the table must be the contiguous "
                         f"({2 * n + K13_TAIL},) table of the field's dtype "
                         "(const_sweep_table)")


def const_sweep_strided(rhs: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, radd: torch.Tensor,
                        table: torch.Tensor | None = None) -> torch.Tensor:
    """K12: constant-row sweep along axis 0 of a C-contiguous field (the r
    sweep of the natural (r, phi, z) field); ``a, b, c, radd``: (n,);
    ``table``: their ``const_sweep_table`` (built in the call where None:
    a launch of its kernel too).  Lines of up to the kernel's march rows
    are solved a thread a line in Thomas order, bit for bit the plain
    version; longer lines are split across a block's warps, except where
    the table's stiffness ratio passes the kernel's."""
    kernel = use_kernel(rhs, a, b, c, radd, table)
    n = rhs.shape[0]
    _check("const_sweep_strided", rhs, n, a, b, c, radd)
    _check_table("const_sweep_strided", rhs, n, table)
    if not kernel:
        return const_sweep_strided_plain(rhs, a, b, c, radd)
    if table is None:
        table = const_sweep_table(a, b, c)
    out = torch.empty_like(rhs)
    err = load_library().atf_const_sweep_strided(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(a),
        ptr(radd), ptr(table), ptr(out), n, rhs.numel() // n,
        stream_ptr(rhs.device))
    raise_on_error(err, "const_sweep_strided")
    const_sweep_strided.launches += 1
    return out


const_sweep_strided.launches = 0


def const_sweep_table(a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """K12's and K13's table of the rows' factors (see
    ``const_sweep_table_plain``): on CUDA tensors built by a kernel of one
    thread ("K13t"), bit for bit the plain version's.  It depends on
    ``a``, ``b`` and ``c`` alone: the step keeps it beside them for its
    dt."""
    n = b.shape[0] if b.dim() == 1 else -1
    _check("const_sweep_table", b, n, a, b, c)
    if not use_kernel(a, b, c):
        return const_sweep_table_plain(a, b, c)
    tab = torch.empty(2 * n + K13_TAIL, dtype=b.dtype, device=b.device)
    err = load_library().atf_const_sweep_table(
        dtype_code(b.dtype), b.device.index, ptr(a), ptr(b), ptr(c),
        ptr(tab), n, stream_ptr(b.device))
    raise_on_error(err, "const_sweep_table")
    const_sweep_table.launches += 1
    return tab


const_sweep_table.launches = 0


def const_sweep_z(rhs: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, radd: torch.Tensor,
                  table: torch.Tensor | None = None) -> torch.Tensor:
    """K13: constant-row sweep along the contiguous last axis (z of the
    natural field); ``a, b, c, radd``: (n,); ``table``: their
    ``const_sweep_table`` (built in the call where None: a launch of its
    kernel too).  Each line is split across a block's warps, except where
    the table's stiffness ratio passes the kernel's, where it is solved in
    Thomas order, bit for bit the plain version."""
    kernel = use_kernel(rhs, a, b, c, radd, table)
    n = rhs.shape[-1]
    _check("const_sweep_z", rhs, n, a, b, c, radd)
    _check_table("const_sweep_z", rhs, n, table)
    if not kernel:
        return const_sweep_z_plain(rhs, a, b, c, radd)
    if table is None:
        table = const_sweep_table(a, b, c)
    out = torch.empty_like(rhs)
    err = load_library().atf_const_sweep_z(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(a),
        ptr(radd), ptr(table), ptr(out), rhs.numel() // n, n,
        stream_ptr(rhs.device))
    raise_on_error(err, "const_sweep_z")
    const_sweep_z.launches += 1
    return out


const_sweep_z.launches = 0


def cyclic_const_phi_table(fac: torch.Tensor, n: int) -> torch.Tensor:
    """K14's table of the rings' factors for lines of ``n`` rows (see
    ``cyclic_const_phi_table_plain``): on CUDA tensors built by a kernel of
    one thread a ring ("K14t"), bit for bit the plain version's.  It
    depends on ``fac`` alone: the step keeps it beside ``fac`` for its
    dt."""
    if fac.dim() != 1 or n < 2:
        raise ValueError("cyclic_const_phi_table: fac must be (B1,) and the "
                         f"lines >= 2 rows, got {tuple(fac.shape)}, n={n}")
    _check("cyclic_const_phi_table", fac, fac.shape[0], fac)
    if not use_kernel(fac):
        return cyclic_const_phi_table_plain(fac, n)
    tab = torch.empty((fac.shape[0], 3 * n + K14_TAIL), dtype=fac.dtype,
                      device=fac.device)
    err = load_library().atf_cyclic_const_table(
        dtype_code(fac.dtype), fac.device.index, ptr(fac), ptr(tab),
        fac.shape[0], n, stream_ptr(fac.device))
    raise_on_error(err, "cyclic_const_phi_table")
    cyclic_const_phi_table.launches += 1
    return tab


cyclic_const_phi_table.launches = 0


def cyclic_const_phi(rhs: torch.Tensor, fac: torch.Tensor,
                     table: torch.Tensor | None = None) -> torch.Tensor:
    """K14: periodic constant-coefficient solve ``(I - fac L_per) x = rhs``
    along axis 1 of a (B1, n, B2) field (phi of the natural field);
    ``fac``: (B1,), one value per ring; ``table``: its
    ``cyclic_const_phi_table`` (built in the call where None: a launch of
    its kernel too).  Each line is split across a block's warps, except on
    the rings past the kernel's stiffness ratio, which are solved in
    Thomas order, bit for bit the plain version."""
    if rhs.dim() != 3 or rhs.shape[1] < 2:
        raise ValueError("cyclic_const_phi solves periodic lines of length "
                         f">= 2 along axis 1 of a 3-D field, got "
                         f"{tuple(rhs.shape)}")
    kernel = use_kernel(rhs, fac, table)
    B1, n, B2 = rhs.shape
    _check("cyclic_const_phi", rhs, B1, fac)
    if table is not None and (table.shape != (B1, 3 * n + K14_TAIL)
                              or table.dtype != rhs.dtype
                              or table.device != rhs.device
                              or not table.is_contiguous()):
        raise ValueError("cyclic_const_phi: the table must be the contiguous "
                         f"({B1}, {3 * n + K14_TAIL}) table of the field's "
                         "dtype and device (cyclic_const_phi_table)")
    if not kernel:
        return cyclic_const_phi_plain(rhs, fac)
    if table is None:
        table = cyclic_const_phi_table(fac, n)
    out = torch.empty_like(rhs)
    err = load_library().atf_cyclic_const_phi(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(fac),
        ptr(table), ptr(out), B1, n, B2, stream_ptr(rhs.device))
    raise_on_error(err, "cyclic_const_phi")
    cyclic_const_phi.launches += 1
    return out


cyclic_const_phi.launches = 0
