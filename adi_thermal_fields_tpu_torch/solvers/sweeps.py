"""Masked implicit ADI sweeps: kernels K1 and K2 with their plain versions.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_sweeps.py`` —
``sweep_code`` (:50), ``fused_sweep_axis0_v2`` (:686) and
``fused_sweep_axis1_v2`` (:1363) -> K1 ``sweep_strided``;
``fused_sweep_axis2_v2`` (:950) -> K2 ``sweep_z``, which also takes K1's
coefficient, Neumann and Dirichlet fields (the field plan's z solve in
the natural layout, where JAX solves the (z, x, y) transpose); the v1
field-coefficient sweeps ``fused_sweep_axis0`` (:289),
``fused_sweep_axis1`` (:215) and their dispatcher ``fused_sweep`` (:2025)
-> K1's v1 entry (``pin_from_code``, counted apart as "K1v1"), under the
JAX names.  The CUDA sources are
``csrc/sweeps.cu``.

One sweep solves, per pencil along the sweep axis, the tridiagonal system
built from the per-cell code byte (bits 1/2 = coupling to i-1/i+1, 4 =
Dirichlet pin, 8 = in-mask):
``a = -tg*low``, ``c = -tg*high``, ``b = 1 + tg*(low+high) + dt*cf``,
``d = rhs + dt*cf*t_inf``; pinned rows have ``b = 1``.  ``cf`` is the Robin
coefficient field (field plan) or ``rob_c*(2-low-high)*inmask`` (plan-lite:
domain edges have no coupling but count as exposed faces).  Void rows are
identity rows that carry the rhs through.  The v1 sweeps pin every row
with bit 4 (``b = 1``) whether or not ``dir_val`` is given; without it a
pinned row keeps ``d = rhs + dt*coeff*t_inf`` (pallas_sweeps.py:116-121,
298-303).

Each wrapper dispatches by device (kernels/__init__.py): CPU tensors run
the plain version (``thomas`` plus tensor ops), CUDA tensors launch the
kernel and count the launch in the wrapper's ``launches`` attribute.  The
kernels split each line across threads (csrc/sweeps.cu): the wrappers
allocate nothing but their output.  bfloat16 fields solve at float32 and
store bfloat16, rounded to nearest or, with ``rng_seed``, stochastically
(solvers/rounding.py), as the JAX kernels' bf16 mode does.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..bc.faces import shift_in
from ..kernels import (FLOAT_DTYPES, STATE_DTYPES, check_kernel_inputs,
                       dtype_code, load_library, ptr, raise_on_error,
                       stream_ptr, use_kernel)
from .rounding import natural_index, sr_key, to_state, widen
from .thomas import thomas

__all__ = ["sweep_code", "sweep_strided", "sweep_strided_plain", "sweep_z",
           "sweep_z_plain", "fused_sweep", "fused_sweep_plain",
           "fused_sweep_axis0", "fused_sweep_axis0_plain",
           "fused_sweep_axis1", "fused_sweep_axis1_plain"]

_LOW, _HIGH, _PIN, _INMASK = 1, 2, 4, 8


def sweep_code(mask: torch.Tensor, dir_mask: torch.Tensor | None, axis: int,
               *, stencil_bits: bool = False) -> torch.Tensor:
    """uint8 per-cell sweep code for ``axis``, in the axis-first layout.

    Bits: 1 = coupling to the i-1 neighbor, 2 = coupling to i+1, 4 =
    Dirichlet-pinned row, 8 = cell is in-mask.  Pinned rows carry ONLY bit
    4 (their couplings and Robin sink are dropped); their neighbors keep
    their couplings to them.

    ``stencil_bits``: also pack the other two axes' neighbor couplings —
    bits 16/32 = coupling to the (axis+1) -1/+1 neighbor, bits 64/128 = the
    (axis+2) -1/+1 neighbor — so the fused theta+x-sweep kernel (K4) reads
    every mask-aware Laplacian term from this one byte.  Bit 128 is why the
    codes are unsigned bytes."""
    mask = mask.to(torch.bool)
    u8 = torch.uint8
    low = mask & shift_in(mask, axis, -1, fill=False)
    high = mask & shift_in(mask, axis, +1, fill=False)
    code = low.to(u8) * _LOW | high.to(u8) * _HIGH | mask.to(u8) * _INMASK
    if stencil_bits:
        for nth, bit_lo, bit_hi in (((axis + 1) % 3, 16, 32),
                                    ((axis + 2) % 3, 64, 128)):
            nlo = mask & shift_in(mask, nth, -1, fill=False)
            nhi = mask & shift_in(mask, nth, +1, fill=False)
            code = code | nlo.to(u8) * bit_lo | nhi.to(u8) * bit_hi
    if dir_mask is not None:
        pin = dir_mask.to(torch.bool) & mask
        code = code.masked_fill(pin, _PIN)
    return code.movedim(axis, 0).contiguous()


def _fold_rhs(rhs, code, dt, qflux, dir_val):
    """Neumann source and Dirichlet values folded into the rhs (the TPU
    wrappers' prepass, pallas_sweeps.py:714-720).  Returns (rhs, pin)."""
    pin = None
    if qflux is not None:
        rhs = rhs + dt * qflux
    if dir_val is not None:
        pin = (code & _PIN) != 0
        rhs = torch.where(pin, dir_val, rhs)
    return rhs, pin


def _rows_plain(rhs, code, tg, dt, t_inf, coeff, rob_c, pin, pin_rows):
    """The row system ``(a, b, c, d)`` from the code bits, in the layout of
    its inputs.  ``pin``: the Dirichlet rows (coefficient zeroed);
    ``pin_rows``: the rows with ``b = 1``."""
    dtype = rhs.dtype
    low = ((code & _LOW) != 0).to(dtype)
    high = ((code & _HIGH) != 0).to(dtype)
    if coeff is None:
        inm = ((code & _INMASK) != 0).to(dtype)
        cf = rob_c * ((2.0 - low - high) * inm)
    else:
        cf = coeff if pin is None else torch.where(pin, 0.0, coeff)
    a = -tg * low
    c = -tg * high
    dtcf = dt * cf
    b = 1.0 + tg * (low + high) + dtcf
    if pin_rows is not None:
        pinf = pin_rows.to(dtype)
        b = b * (1.0 - pinf) + pinf
    return a, b, c, rhs + dtcf * t_inf


def _solve_plain(rhs, code, axis, tg, dt, t_inf, coeff, rob_c, pin,
                 pin_rows=None):
    """Build the row system from the code bits and solve along ``axis``
    (``pin_rows`` None: ``pin``; the v1 rule: every bit-4 row)."""
    if pin_rows is None:
        pin_rows = pin
    mv = (lambda t: None if t is None else t.movedim(axis, 0))
    a, b, c, d = _rows_plain(mv(rhs), mv(code), tg, dt, t_inf, mv(coeff),
                             rob_c, mv(pin), mv(pin_rows))
    return thomas(a, b, c, d, reciprocal=True).movedim(0, axis).contiguous()


def _zxy_index(shape, device) -> torch.Tensor:
    """Natural linear indices of the cells of a (z, x, y) permuted field
    of ``shape`` = (nz, nx, ny)."""
    nz, nx, ny = shape
    return natural_index((nx, ny, nz), device).permute(2, 0, 1)


def sweep_strided_plain(rhs, code, tg, dt, t_inf, *, axis, coeff=None,
                        rob_c=None, qflux=None, dir_val=None,
                        rng_seed=None, rng_offset=0, zxy=False,
                        pin_from_code=False):
    """Plain version of K1 (any device).  A bfloat16 field is solved at
    float32 and stored back by ``to_state``."""
    dtype = rhs.dtype
    rhs, coeff, qflux, dir_val = (widen(t) for t in (rhs, coeff, qflux,
                                                     dir_val))
    rhs, pin = _fold_rhs(rhs, code, dt, qflux, dir_val)
    x = _solve_plain(rhs, code, axis, tg, dt, t_inf, coeff, rob_c, pin,
                     (code & _PIN) != 0 if pin_from_code else None)
    idx = (_zxy_index(x.shape, x.device)
           if zxy and dtype == torch.bfloat16 else None)
    return to_state(x, dtype, sr_key(rng_seed, rng_offset), idx)


def sweep_strided(rhs: torch.Tensor, code: torch.Tensor, tg: float,
                  dt: float, t_inf: float, *, axis: int,
                  coeff: torch.Tensor | None = None,
                  rob_c: float | None = None,
                  qflux: torch.Tensor | None = None,
                  dir_val: torch.Tensor | None = None,
                  rng_seed: int | None = None, rng_offset: int = 0,
                  zxy: bool = False,
                  pin_from_code: bool = False) -> torch.Tensor:
    """K1: masked sweep along ``axis`` (0 or 1) of a C-contiguous 3-D field.

    ``coeff`` (field plan) or the scalar ``rob_c`` (plan-lite) gives the
    Robin sink; ``qflux`` and ``dir_val`` are folded into the rhs.
    ``zxy``: the field is the (z, x, y) permutation of a natural field,
    solved along ``axis=0`` (z; the stochastic rounding takes each cell's
    natural index).  float32 and float64 fields solve at their
    type; a bfloat16 field (coefficient fields bfloat16 too) solves at
    float32 and rounds its result to nearest, or stochastically with
    ``rng_seed`` (the step counter) and ``rng_offset`` (the pass), at each
    cell's natural index (solvers/rounding.py).  ``pin_from_code``: the v1
    pin rule (module docstring), float32 and float64 only; its launches
    count apart, in ``sweep_strided.v1.launches`` ("K1v1").  Lines of any
    length: past 4,096 rows at float32 and bfloat16 (1,792 at float64) the
    kernel keeps a line's reduced rows in a global buffer of 6/16 of the
    field's cells, which it takes and frees on the stream."""
    if axis not in (0, 1):
        raise ValueError(f"sweep_strided solves along axis 0 or 1, not {axis}")
    if coeff is None and rob_c is None:
        raise ValueError("plan-lite sweep (coeff=None) requires rob_c")
    if zxy and axis != 0:
        raise ValueError("sweep_strided: zxy needs axis 0")
    if not use_kernel(rhs, code, coeff, qflux, dir_val):
        return sweep_strided_plain(rhs, code, tg, dt, t_inf, axis=axis,
                                   coeff=coeff, rob_c=rob_c, qflux=qflux,
                                   dir_val=dir_val, rng_seed=rng_seed,
                                   rng_offset=rng_offset, zxy=zxy,
                                   pin_from_code=pin_from_code)
    if rhs.dim() != 3:
        raise ValueError(f"sweep_strided: field must be 3-D, got {rhs.dim()}")
    check_kernel_inputs("sweep_strided", rhs, code, coeff, qflux, dir_val,
                        dtypes=FLOAT_DTYPES if pin_from_code
                        else STATE_DTYPES)
    s0, s1, s2 = rhs.shape
    B1, n, B2 = (1, s0, s1 * s2) if axis == 0 else (s0, s1, s2)
    out = torch.empty_like(rhs)
    err = load_library().atf_sweep_strided(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(code),
        ptr(coeff), ptr(qflux), ptr(dir_val), ptr(out), B1, n, B2, tg, dt,
        t_inf, 0.0 if rob_c is None else rob_c,
        sr_key(rng_seed, rng_offset), int(zxy), int(pin_from_code),
        stream_ptr(rhs.device))
    raise_on_error(err, "sweep_strided")
    counter = (sweep_strided.v1 if pin_from_code else sweep_strided.bf16
               if rhs.dtype == torch.bfloat16 else sweep_strided)
    counter.launches += 1
    return out


sweep_strided.launches = 0
sweep_strided.bf16 = SimpleNamespace(launches=0)   # the bfloat16 entry
sweep_strided.v1 = SimpleNamespace(launches=0)     # the v1 entry


def sweep_z_plain(rhs, code, tg, dt, t_inf, rob_c=None, *, coeff=None,
                  qflux=None, dir_val=None, rng_seed=None, rng_offset=0):
    """Plain version of K2 (any device): K1's along axis 2, with
    ``fused_sweep_axis2_v2``'s pin rule on plan-lite inputs alone."""
    lite_only = coeff is None and qflux is None and dir_val is None
    return sweep_strided_plain(rhs, code, tg, dt, t_inf, axis=2, coeff=coeff,
                               rob_c=rob_c, qflux=qflux, dir_val=dir_val,
                               rng_seed=rng_seed, rng_offset=rng_offset,
                               pin_from_code=lite_only)


def sweep_z(rhs: torch.Tensor, code: torch.Tensor, tg: float, dt: float,
            t_inf: float, rob_c: float | None = None, *,
            coeff: torch.Tensor | None = None,
            qflux: torch.Tensor | None = None,
            dir_val: torch.Tensor | None = None,
            rng_seed: int | None = None,
            rng_offset: int = 0) -> torch.Tensor:
    """K2: masked sweep along the contiguous z axis of a natural (x, y, z)
    field; ``code`` and the fields in the same natural layout.  The Robin
    sink, Neumann and Dirichlet folds, types and rounding as K1's: the
    field plan's z solve.  Given plan-lite inputs alone (``rob_c``, no
    field) it pins every row whose code has bit 4 (``b = 1``), as JAX
    ``fused_sweep_axis2_v2`` (``has_pin=True``) does; with any field it
    pins as K1 does (only where ``dir_val`` is given).  Lines of any
    length: a line too long to stage in shared memory (~5,800 rows at
    float32 with every field, ~3,000 at float64) is solved by K1's kernel
    on the z layout."""
    if coeff is None and rob_c is None:
        raise ValueError("plan-lite sweep (coeff=None) requires rob_c")
    if not use_kernel(rhs, code, coeff, qflux, dir_val):
        return sweep_z_plain(rhs, code, tg, dt, t_inf, rob_c, coeff=coeff,
                             qflux=qflux, dir_val=dir_val, rng_seed=rng_seed,
                             rng_offset=rng_offset)
    if rhs.dim() != 3:
        raise ValueError(f"sweep_z: field must be 3-D, got {rhs.dim()}")
    check_kernel_inputs("sweep_z", rhs, code, coeff, qflux, dir_val,
                        dtypes=STATE_DTYPES)
    out = torch.empty_like(rhs)
    err = load_library().atf_sweep_z(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(code),
        ptr(coeff), ptr(qflux), ptr(dir_val), ptr(out),
        rhs.shape[0] * rhs.shape[1], rhs.shape[2], tg, dt, t_inf,
        0.0 if rob_c is None else rob_c, sr_key(rng_seed, rng_offset),
        stream_ptr(rhs.device))
    raise_on_error(err, "sweep_z")
    counter = sweep_z.bf16 if rhs.dtype == torch.bfloat16 else sweep_z
    counter.launches += 1
    return out


sweep_z.launches = 0
sweep_z.bf16 = SimpleNamespace(launches=0)   # the bfloat16 entry


# ---------------------------------------------------------------------------
# the v1 field-coefficient sweeps, under the JAX names (K1's v1 entry)
# ---------------------------------------------------------------------------

def _v1(solve, rhs, code, coeff, theta_gam, dt, t_inf, qflux, dir_val,
        axis):
    return solve(rhs, code, theta_gam, dt, t_inf, axis=axis, coeff=coeff,
                 qflux=qflux, dir_val=dir_val, pin_from_code=True)


def fused_sweep_axis0_plain(rhs, code, coeff, theta_gam, dt, t_inf,
                            qflux=None, dir_val=None):
    """Plain version of ``fused_sweep_axis0``."""
    return _v1(sweep_strided_plain, rhs, code, coeff, theta_gam, dt, t_inf,
               qflux, dir_val, 0)


def fused_sweep_axis0(rhs: torch.Tensor, code: torch.Tensor,
                      coeff: torch.Tensor, theta_gam: float, dt: float,
                      t_inf: float, qflux: torch.Tensor | None = None,
                      dir_val: torch.Tensor | None = None) -> torch.Tensor:
    """The v1 masked sweep along axis 0 of (n, B1, B2) fields (JAX
    ``fused_sweep_axis0``): the Robin coefficient field ``coeff``,
    optional Neumann ``qflux`` and Dirichlet ``dir_val``, the code
    (``sweep_code``) in the same layout.  K1's v1 entry."""
    return _v1(sweep_strided, rhs, code, coeff, theta_gam, dt, t_inf, qflux,
               dir_val, 0)


def fused_sweep_axis1_plain(rhs, code, coeff, theta_gam, dt, t_inf,
                            qflux=None, dir_val=None):
    """Plain version of ``fused_sweep_axis1``."""
    return _v1(sweep_strided_plain, rhs, code, coeff, theta_gam, dt, t_inf,
               qflux, dir_val, 1)


def fused_sweep_axis1(rhs: torch.Tensor, code: torch.Tensor,
                      coeff: torch.Tensor, theta_gam: float, dt: float,
                      t_inf: float, qflux: torch.Tensor | None = None,
                      dir_val: torch.Tensor | None = None) -> torch.Tensor:
    """The v1 masked sweep along axis 1 of (B1, n, B2) fields, the code in
    the same layout (JAX ``fused_sweep_axis1``, which pads n to a multiple
    of 8 with identity rows; K1 needs no padding).  K1's v1 entry."""
    return _v1(sweep_strided, rhs, code, coeff, theta_gam, dt, t_inf, qflux,
               dir_val, 1)


def _axis_first(sweep0, rhs, code_ax0, coeff, theta_gam, dt, t_inf, axis,
                qflux, dir_val):
    """The JAX dispatcher: fields to the axis-first layout, ``sweep0``,
    and back."""
    if axis not in (0, 1, 2):
        raise ValueError(f"fused_sweep: axis must be 0, 1 or 2, not {axis}")
    mv = (lambda t: None if t is None else t.movedim(axis, 0).contiguous())
    out = sweep0(mv(rhs), code_ax0, mv(coeff), theta_gam, dt, t_inf,
                 qflux=mv(qflux), dir_val=mv(dir_val))
    return out if axis == 0 else out.movedim(0, axis).contiguous()


def fused_sweep_plain(rhs, code_ax0, coeff, theta_gam, dt, t_inf, axis,
                      qflux=None, dir_val=None):
    """Plain version of ``fused_sweep``."""
    return _axis_first(fused_sweep_axis0_plain, rhs, code_ax0, coeff,
                       theta_gam, dt, t_inf, axis, qflux, dir_val)


def fused_sweep(rhs: torch.Tensor, code_ax0: torch.Tensor,
                coeff: torch.Tensor, theta_gam: float, dt: float,
                t_inf: float, axis: int, qflux: torch.Tensor | None = None,
                dir_val: torch.Tensor | None = None) -> torch.Tensor:
    """The v1 masked implicit sweep along ``axis`` of natural (nx, ny, nz)
    fields (JAX ``fused_sweep``, the public v1 entry): ``rhs``, ``coeff``,
    ``qflux`` and ``dir_val`` in the natural layout, ``code_ax0`` from
    ``sweep_code`` in the axis-first layout.  The fields move to the
    axis-first layout ((z, x, y) for axis 2), ``fused_sweep_axis0`` solves,
    and the result moves back.  float32 and float64."""
    return _axis_first(fused_sweep_axis0, rhs, code_ax0, coeff, theta_gam,
                       dt, t_inf, axis, qflux, dir_val)
