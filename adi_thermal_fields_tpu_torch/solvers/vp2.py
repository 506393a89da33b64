"""Tier-2 variable-property sweeps: kernels K8, K15 (with its y entry
"K15y") and K16 and their plain versions.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_vp2.py`` —
``build_vp2_code`` (:88), ``_rad`` (:139), ``vp2_streams_xla`` (:147),
``vp2_cyclic_streams_xla`` (:180), ``fused_vp2_sweep`` (:402),
``fused_vp2_cyclic_axis1`` (:812) and ``fused_vp2_sweep_axis1`` (:1029):

* ``fused_vp2_sweep`` with ``nat_rhs_out=True`` (streaming site :611, body
  ``_vp2_kernel`` :201-389) -> K8 ``vp2_sweep_z``, the sweep along the
  contiguous z axis: the Cartesian form (scalar columns, symmetric films)
  and the general form (per-row columns, h_lo != h_hi, domain-edge films),
  one kernel in ``csrc/vp2_sweep.cu``;
* ``fused_vp2_sweep`` in its solve-leading forms (pipelined site :539, body
  ``_vp2_pipe_kernel`` :1109; streaming site :611 without ``nat_rhs_out``)
  -> K15 ``vp2_sweep_strided``, the sweep along axis 0 (cylindrical r);
* ``fused_vp2_sweep_axis1`` (body ``_vp2_axis1_kernel`` :903) -> K15's y
  entry ``vp2_sweep_y``, the Cartesian y sweep of the natural (x, y, z)
  field with uniform geometry (constant columns, no edge films);
* ``fused_vp2_cyclic_axis1`` (site :882, body ``_vp2_cyclic_kernel`` :633)
  -> K16 ``vp2_cyclic_phi``, the periodic sweep along axis 1 (phi).

The kernels derive every per-cell quantity from T^n and a 1-byte code
instead of reading prebuilt streams: k(T) and cp(T) (clamp-sum tables),
the harmonic face ``f_hi = harm(k[i], k[i+1])`` where bit 1 is set (the
open sweeps carry it to the next row as ``f_lo``), the interface films
``sink = bit2*gsl*(h_lo + hr) + bit4*gsh*(h_hi + hr)`` with ``hr`` the
Picard radiative film against ``tinf_void``, ``srhs = sink*tinf_void``,
and the domain-edge films ``edge0``/``edge1`` = ``(h, geo, t_inf)`` at rows
0 and n-1, gated by bit 8, each against its own ambient.  Rows are scaled
by ``cp(T)/dtor`` (scaled-row elimination, pallas_vp2.py:335-349):

    al = glo*f_lo, ch = ghi*f_hi, coup = al + ch + sink,
    w_r = cp(T)*inv_dtor if coup > 0 else 1,
    b = w_r + coup, d = rhs*w_r + srhs, a = -al, c = -ch.

Rows with no coupling and no film keep scale 1, so identity rows (void
cells, the axis ring of a full disk, whose code is 0) pass their rhs
through bit for bit.  The gate ``coup > 0`` is right only for films >= 0;
the varprop steps and the engine refuse negative films.  The cyclic sweep
takes its lo face from ``harm(k[i-1], k[i])*bit16`` (the wrap face at
row 0) and its hi face from ``harm(k[i], k[i+1 mod n])*bit1``, and solves
the periodic system by Sherman-Morrison (``cyclic_thomas``).

Code bits (``build_vp2_code``): 1 = hi-face coupling live, 2 = lo face
exposed, 4 = hi face exposed, 8 = cell active, 16 = lo-face coupling live.
The port keeps every code in the natural layout of its field (the JAX
cylindrical step moves its z code to (z, r, phi)), so nothing is
transposed.

The plain versions build the rows with one tensor op per operation and
solve them with ``thomas`` / ``cyclic_thomas``.  K8 (both forms) forms the
same rows bit for bit but solves each line split across a warp (the
split-line core of ``csrc/split_line.cuh``), not in Thomas order: within a
few float32 ulp of the output's scale; at float32 its general form solves
a line with a row past ``kK8Stiff`` (``csrc/vp2_sweep.cu``) again in
Thomas order, bit for bit ``thomas``.  K15 and its y entry form the same
rows: lines of up to 96 rows (the cylindrical r) in Thomas order, a thread
a line with c' in shared memory, bit for bit ``thomas``; longer lines
(K15y's y) on the core's strided kernel, split across a block's warps
with K8's bounds and replay (a block of 32 lines with a row past
``kK8Stiff``); neither takes a c'/d' scratch field.  K16 forms its rows
bit for bit and solves them split across the block's warps with the wrap
by Sherman-Morrison (``csrc/split_cyclic.cuh``), except on blocks of stiff
rings (past ``kK16Stiff`` in ``csrc/vp2_cyl.cu``), which it solves in
Thomas order, bit for bit ``cyclic_thomas``, and refuses lines too long
for that replay (K11's limits, ``solvers/masked.py``).  Each wrapper runs
the plain version on CPU tensors and its kernel on CUDA tensors (or
raises), counting the launch in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..bc.faces import shift_in
from ..bc.radiation import STEFAN_BOLTZMANN
from ..kernels import (check_kernel_inputs, check_vectors, dtype_code,
                       load_library, ptr, raise_on_error, stream_ptr,
                       use_kernel)
from .fields import stiff_flags
from .thomas import cyclic_thomas, thomas
from .varprop import _table_arg, eval_spec, harm

__all__ = ["build_vp2_code", "vp2_streams", "vp2_open_streams",
           "vp2_cyclic_streams", "vp2_sweep_z",
           "vp2_sweep_z_plain", "vp2_sweep_strided", "vp2_sweep_strided_plain",
           "vp2_sweep_y", "vp2_sweep_y_plain", "vp2_cyclic_phi",
           "vp2_cyclic_phi_plain"]

_T0K = 273.15


def build_vp2_code(act: torch.Tensor, axis: int, *, periodic: bool = False,
                   clear_rows=(), edge_exposed: bool = False) -> torch.Tensor:
    """uint8 face code along ``axis`` from the active mask, in the mask's
    own layout (module bits).

    ``periodic``: wrap neighbours (phi).  ``clear_rows``: row indices along
    ``axis`` whose film bits (2|4) are cleared — Dirichlet pins carry no
    films, but their coupling bits stay: the neighbour keeps its coupling
    into the pinned value.  ``edge_exposed``: domain-edge faces count as
    exposed (the Cartesian Robin convention); otherwise they are film-free
    (the cylindrical convention: dedicated edge films instead)."""
    act = act.to(torch.bool)
    u8 = torch.uint8
    if periodic:
        nb_hi = torch.roll(act, -1, axis)
        nb_lo = torch.roll(act, 1, axis)
        ex_hi, ex_lo = nb_hi, nb_lo
    else:
        nb_hi = shift_in(act, axis, +1, fill=False)
        nb_lo = shift_in(act, axis, -1, fill=False)
        if edge_exposed:
            ex_hi, ex_lo = nb_hi, nb_lo
        else:
            ex_hi = shift_in(act, axis, +1, fill=True)
            ex_lo = shift_in(act, axis, -1, fill=True)
    code = ((act & nb_hi).to(u8) | (act & ~ex_lo).to(u8) * 2
            | (act & ~ex_hi).to(u8) * 4 | act.to(u8) * 8
            | (act & nb_lo).to(u8) * 16)
    n = act.shape[axis]
    for idx in clear_rows:
        code.select(axis, int(idx) % n).bitwise_and_(0xF9)
    return code


def _rad(Tc: torch.Tensor, emissivity: float, tinf: float):
    """Picard radiative film of the vp2 kernels (JAX ``_rad``):
    ``(eps*sigma)*(Tk + Tik)*(Tk^2 + Tik^2)`` with ``Tik = tinf + 273.15``
    and ``Tik^2`` formed in float64."""
    Tk = Tc + _T0K
    Tik = tinf + _T0K
    return (emissivity * STEFAN_BOLTZMANN) * (Tk + Tik) * (Tk * Tk + Tik * Tik)


def _rad_args(emissivity: float, tinf: float):
    """``(eps*sigma, Tik, Tik^2)`` in float64, as ``_rad`` forms them."""
    tik = tinf + _T0K
    return emissivity * STEFAN_BOLTZMANN, tik, tik * tik


def _col(v, axis: int, ndim: int):
    """A per-row (n,) vector shaped to broadcast along ``axis``; a number
    stays a number."""
    if not torch.is_tensor(v):
        return v
    shape = [1] * ndim
    shape[axis] = -1
    return v.view(shape)


def _open_films(T, code, gsl, gsh, axis, h_lo, h_hi, tinf, emissivity,
                edge0, edge1):
    """``(sink, srhs)`` of an open sweep along ``axis``: the interface
    films, then the domain-edge films at rows 0 and n-1."""
    bit = (lambda b: ((code & b) != 0).to(T.dtype))
    col = (lambda v: _col(v, axis, T.dim()))
    hr = _rad(T, emissivity, tinf) if emissivity > 0.0 else 0.0
    sink = bit(2) * col(gsl) * (h_lo + hr) + bit(4) * col(gsh) * (h_hi + hr)
    srhs = sink * tinf
    n = T.shape[axis]
    for idx, edge in ((0, edge0), (n - 1, edge1)):
        if edge is None:
            continue
        h_e, g_e, t_e = (float(v) for v in edge)
        t_row = T.narrow(axis, idx, 1)
        hr_e = _rad(t_row, emissivity, t_e) if emissivity > 0.0 else 0.0
        s_e = bit(8).narrow(axis, idx, 1) * g_e * (h_e + hr_e)
        sink.narrow(axis, idx, 1).add_(s_e)
        srhs.narrow(axis, idx, 1).add_(s_e * t_e)
    return sink, srhs


def _faces_hi(T, code, k_spec, axis):
    """``f_hi = harm(k[i], k[i+1])*bit1`` along ``axis`` (the last row's
    neighbour replicates it; bit 1 is 0 there)."""
    k = eval_spec(k_spec, T)
    n = T.shape[axis]
    k_up = torch.cat([k.narrow(axis, 1, n - 1), k.narrow(axis, n - 1, 1)],
                     axis)
    return harm(k, k_up) * ((code & 1) != 0).to(T.dtype)


def _scaled_rows(rhs, T, cp_spec, inv_dtor, al, ch, sink, srhs):
    """(a, b, c, d) of the scaled rows (module docstring)."""
    coup = al + ch + sink
    w_r = torch.where(coup > 0.0, eval_spec(cp_spec, T) * inv_dtor, 1.0)
    return -al, w_r + coup, -ch, rhs * w_r + srhs


def vp2_open_streams(T, code, gsl, gsh, axis, *, k_spec, h_lo, h_hi,
                     tinf, emissivity=0.0, edge0=None, edge1=None):
    """``(fhi, sink, srhs)`` of an open sweep along ``axis`` from T^n (JAX
    ``vp2_streams_xla``, unscaled): the harmonic hi faces, the interface
    films and the domain-edge films.  The plain versions build their rows
    from these, and the gradient route pulls their cotangents back."""
    fhi = _faces_hi(T, code, k_spec, axis)
    sink, srhs = _open_films(T, code, gsl, gsh, axis, h_lo, h_hi, tinf,
                             emissivity, edge0, edge1)
    return fhi, sink, srhs


def vp2_cyclic_streams(T, code, gs, *, k_spec, h_void=0.0, tinf_void=0.0,
                       emissivity=0.0):
    """``(flo, fhi, sink, srhs)`` of the periodic sweep along axis 1 from
    T^n (JAX ``vp2_cyclic_streams_xla``, with the hi faces beside the lo
    faces; ``gs``: (B1,) per ring)."""
    bit = (lambda b: ((code & b) != 0).to(T.dtype))
    k = eval_spec(k_spec, T)
    flo = harm(torch.roll(k, 1, 1), k) * bit(16)
    fhi = harm(k, torch.roll(k, -1, 1)) * bit(1)
    hr = _rad(T, emissivity, tinf_void) if emissivity > 0.0 else 0.0
    sink = (bit(2) + bit(4)) * gs[:, None, None] * (h_void + hr)
    return flo, fhi, sink, sink * tinf_void


def vp2_streams(T, code, gs, dtor, *, k_spec, cp_spec, h: float,
                tinf: float, emissivity: float = 0.0):
    """``(fhi, dw, sink, srhs)`` along z, JAX ``vp2_streams_xla`` for the
    symmetric Cartesian use (``gs_lo = gs_hi = gs``, ``h_lo = h_hi = h``,
    no edge films), in the natural layout; ``dw = dtor/cp(T)``."""
    fhi, sink, srhs = vp2_open_streams(T, code, gs, gs, 2, k_spec=k_spec,
                                       h_lo=h, h_hi=h, tinf=tinf,
                                       emissivity=emissivity)
    return fhi, dtor / eval_spec(cp_spec, T), sink, srhs


def _open_plain(rhs, T, code, glo, ghi, gsl, gsh, inv_dtor, axis, *, k_spec,
                cp_spec, h_lo, h_hi, tinf, emissivity, edge0, edge1):
    """The open sweep's streams and scaled rows along ``axis``, solved by
    ``thomas``."""
    col = (lambda v: _col(v, axis, T.dim()))
    fhi, sink, srhs = vp2_open_streams(
        T, code, gsl, gsh, axis, k_spec=k_spec, h_lo=h_lo, h_hi=h_hi,
        tinf=tinf, emissivity=emissivity, edge0=edge0, edge1=edge1)
    al = col(glo) * shift_in(fhi, axis, -1, fill=0.0)
    ch = col(ghi) * fhi
    rows = _scaled_rows(T if rhs is None else rhs, T, cp_spec, inv_dtor, al,
                        ch, sink, srhs)
    mv = (lambda t: t.movedim(axis, 0))
    return thomas(*(mv(t) for t in rows)).movedim(0, axis).contiguous()


def _edge_arg(edges, emissivity: float):
    """The two domain-edge films as the C entry points take them:
    ``[on, h, geo, t_inf, Tik, Tik^2]`` each, in float64."""
    flat = []
    for edge in edges:
        if edge is None:
            flat += [0.0] * 6
        else:
            h_e, g_e, t_e = (float(v) for v in edge)
            _, tik, tik2 = _rad_args(emissivity, t_e)
            flat += [1.0, h_e, g_e, t_e, tik, tik2]
    return (ctypes.c_double * 12)(*flat)


def _launch_open(name, rhs, T, code, glo, ghi, gsl, gsh, inv_dtor, axis, *,
                 k_spec, cp_spec, h_lo, h_hi, tinf, emissivity, edge0,
                 edge1):
    """K15 (axis 0 or 1 of a 3-D field: ``rhs`` None passes T) or K8's
    general form (the last axis) on CUDA tensors."""
    check_kernel_inputs(name, T, code, rhs)
    n = T.shape[axis]
    check_vectors(name, T, n, glo, ghi, gsl, gsh)
    ktab, kn = _table_arg(k_spec)
    ctab, cn = _table_arg(cp_spec)
    rc, tik, tik2 = _rad_args(emissivity, tinf)
    rad = emissivity > 0.0
    out = torch.empty_like(T)
    lib = load_library()
    films = (ktab, kn, ctab, cn, float(inv_dtor), float(h_lo), float(h_hi),
             float(tinf), rc if rad else 0.0, tik, tik2, int(rad),
             _edge_arg((edge0, edge1), emissivity), stream_ptr(T.device))
    head = (dtype_code(T.dtype), T.device.index,
            ptr(T if rhs is None else rhs), ptr(T), ptr(code), ptr(glo),
            ptr(ghi), ptr(gsl), ptr(gsh), ptr(out))
    if axis == T.dim() - 1:
        # K8's general form: npen lines of n contiguous rows (a flag byte a
        # line at float32 for the stiff lines' replay)
        npen = T.numel() // n
        err = lib.atf_vp2_sweep_z_general(*head, ptr(stiff_flags(T, npen)),
                                          npen, n, *films)
    else:
        # K15: the field as (B1, n, B2), B1*B2 lines of n rows B2 apart
        B1 = math.prod(T.shape[:axis])
        err = lib.atf_vp2_sweep_strided(*head, B1, n, T.numel() // (B1 * n),
                                        *films)
    raise_on_error(err, name)
    return out


# ---------------------------------------------------------------------------
# K8: the sweep along contiguous z
# ---------------------------------------------------------------------------

def vp2_sweep_z_plain(rhs, T, code, glo, gs, inv_dtor, *, k_spec, cp_spec,
                      h=0.0, t_inf=0.0, emissivity=0.0, ghi=None, gsh=None,
                      h_hi=None, edge0=None, edge1=None):
    """Plain version of K8 (both forms): the streams, the scaled rows,
    ``thomas`` along the last axis."""
    return _open_plain(rhs, T, code, glo, glo if ghi is None else ghi, gs,
                       gs if gsh is None else gsh, inv_dtor, T.dim() - 1,
                       k_spec=k_spec, cp_spec=cp_spec, h_lo=h,
                       h_hi=h if h_hi is None else h_hi, tinf=t_inf,
                       emissivity=emissivity, edge0=edge0, edge1=edge1)


def vp2_sweep_z(rhs: torch.Tensor, T: torch.Tensor, code: torch.Tensor,
                glo, gs, inv_dtor: float, *, k_spec, cp_spec,
                h: float = 0.0, t_inf: float = 0.0, emissivity: float = 0.0,
                ghi: torch.Tensor | None = None,
                gsh: torch.Tensor | None = None, h_hi: float | None = None,
                edge0=None, edge1=None) -> torch.Tensor:
    """K8: the tier-2 sweep along the contiguous z axis.

    ``rhs``: the chained right-hand side; ``T``: the step's start field
    T^n, from which k, cp and the films are derived; ``code``: the z code
    in the natural layout; ``inv_dtor = rho/dt`` at the field's dtype.

    Both forms run on one kernel (``csrc/vp2_sweep.cu``, each line split
    across a warp, no c'/d' scratch).  Cartesian form: ``glo =
    theta/dz^2`` and ``gs = 1/dz`` numbers, ``code = build_vp2_code(mask,
    2, edge_exposed=True)``, the film ``h`` on both faces against
    ``t_inf``.
    General form (taken when ``glo`` is a tensor; its columns staged once
    a block; at float32 a line with a row past the kernel's stiffness
    ratio solved again in Thomas order, bit for bit the plain version):
    per-row (n,) coupling columns ``glo``/``ghi`` (zeros at Dirichlet
    rows) and film columns ``gs``/``gsh``, the lo-face film ``h`` and the
    hi-face film ``h_hi``, both against ``t_inf``, and the domain-edge
    films ``edge0``/``edge1`` = ``(h, geo, t_inf)``.  ``emissivity > 0``
    adds the radiative film to every film."""
    general = torch.is_tensor(glo)
    if not use_kernel(rhs, T, code, *((glo, ghi, gs, gsh) if general
                                       else ())):
        return vp2_sweep_z_plain(rhs, T, code, glo, gs, inv_dtor,
                                 k_spec=k_spec, cp_spec=cp_spec, h=h,
                                 t_inf=t_inf, emissivity=emissivity, ghi=ghi,
                                 gsh=gsh, h_hi=h_hi, edge0=edge0,
                                 edge1=edge1)
    if rhs.dim() != 3:
        raise ValueError(f"vp2_sweep_z: field must be 3-D, got {rhs.dim()}")
    if general:
        out = _launch_open(
            "vp2_sweep_z", rhs, T, code, glo, glo if ghi is None else ghi,
            gs, gs if gsh is None else gsh, inv_dtor, 2, k_spec=k_spec,
            cp_spec=cp_spec, h_lo=h, h_hi=h if h_hi is None else h_hi,
            tinf=t_inf, emissivity=emissivity, edge0=edge0, edge1=edge1)
        vp2_sweep_z.launches += 1
        return out
    if ghi is not None or gsh is not None or edge0 is not None \
            or edge1 is not None or (h_hi is not None and h_hi != h):
        raise ValueError("vp2_sweep_z: per-row columns, edge films and "
                         "h_hi take the general form (glo as an (n,) tensor)")
    check_kernel_inputs("vp2_sweep_z", rhs, code, T)
    ktab, kn = _table_arg(k_spec)
    ctab, cn = _table_arg(cp_spec)
    rad = emissivity > 0.0
    tik = t_inf + _T0K
    out = torch.empty_like(rhs)
    err = load_library().atf_vp2_sweep_z(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(T), ptr(code),
        ptr(out), rhs.shape[0] * rhs.shape[1], rhs.shape[2],
        ktab, kn, ctab, cn, glo, gs, inv_dtor, h, t_inf,
        emissivity * STEFAN_BOLTZMANN if rad else 0.0, tik, tik * tik,
        int(rad), stream_ptr(rhs.device))
    raise_on_error(err, "vp2_sweep_z")
    vp2_sweep_z.launches += 1
    return out


vp2_sweep_z.launches = 0


# ---------------------------------------------------------------------------
# K15: the sweep along axis 0
# ---------------------------------------------------------------------------

def vp2_sweep_strided_plain(rhs, T, code, glo, ghi, gsl, gsh, inv_dtor, *,
                            k_spec, cp_spec, h_lo=0.0, h_hi=0.0,
                            tinf_void=0.0, emissivity=0.0, edge0=None,
                            edge1=None):
    """Plain version of K15: the streams, the scaled rows, ``thomas`` along
    axis 0 (``rhs=None``: the rhs is T)."""
    return _open_plain(rhs, T, code, glo, ghi, gsl, gsh, inv_dtor, 0,
                       k_spec=k_spec, cp_spec=cp_spec, h_lo=h_lo, h_hi=h_hi,
                       tinf=tinf_void, emissivity=emissivity, edge0=edge0,
                       edge1=edge1)


def vp2_sweep_strided(rhs: torch.Tensor | None, T: torch.Tensor,
                      code: torch.Tensor, glo: torch.Tensor,
                      ghi: torch.Tensor, gsl: torch.Tensor,
                      gsh: torch.Tensor, inv_dtor: float, *, k_spec,
                      cp_spec, h_lo: float = 0.0, h_hi: float = 0.0,
                      tinf_void: float = 0.0, emissivity: float = 0.0,
                      edge0=None, edge1=None) -> torch.Tensor:
    """K15: the tier-2 sweep along axis 0 of a C-contiguous field (the r
    sweep of the natural (r, phi, z) field).

    ``rhs``: the chained right-hand side, or None when it is ``T`` (the
    first sweep of a backward-Euler step: one stream fewer); ``code``:
    ``build_vp2_code(act, 0)`` in T's layout; ``glo``/``ghi``: (n,)
    coupling columns; ``gsl``/``gsh``: (n,) interface-film columns;
    ``h_lo``/``h_hi``: the lo/hi interface films against ``tinf_void``;
    ``edge0``/``edge1``: None or ``(h, geo, t_inf)`` domain-edge films at
    rows 0 and n-1 (gated by bit 8); ``inv_dtor = rho/dt``.  Lines of up
    to 96 rows run in Thomas order, bit for bit the plain version; longer
    ones are split across a block's warps (``csrc/vp2_sweep.cu``; float32
    blocks with a row past ``kK8Stiff`` in Thomas order); the wrapper
    allocates the output alone."""
    if not use_kernel(rhs, T, code, glo, ghi, gsl, gsh):
        return vp2_sweep_strided_plain(
            rhs, T, code, glo, ghi, gsl, gsh, inv_dtor, k_spec=k_spec,
            cp_spec=cp_spec, h_lo=h_lo, h_hi=h_hi, tinf_void=tinf_void,
            emissivity=emissivity, edge0=edge0, edge1=edge1)
    out = _launch_open("vp2_sweep_strided", rhs, T, code, glo, ghi, gsl,
                       gsh, inv_dtor, 0, k_spec=k_spec, cp_spec=cp_spec,
                       h_lo=h_lo, h_hi=h_hi, tinf=tinf_void,
                       emissivity=emissivity, edge0=edge0, edge1=edge1)
    vp2_sweep_strided.launches += 1
    return out


vp2_sweep_strided.launches = 0


# ---------------------------------------------------------------------------
# K15's y entry: the Cartesian y sweep
# ---------------------------------------------------------------------------

def vp2_sweep_y_plain(rhs, T, code, glo, gs, inv_dtor, *, k_spec, cp_spec,
                      h=0.0, t_inf=0.0, emissivity=0.0):
    """Plain version of K15's y entry: the streams, the scaled rows,
    ``thomas`` along axis 1, with the numbers ``glo`` and ``gs`` for every
    row and the film ``h`` on both faces."""
    return _open_plain(rhs, T, code, glo, glo, gs, gs, inv_dtor, 1,
                       k_spec=k_spec, cp_spec=cp_spec, h_lo=h, h_hi=h,
                       tinf=t_inf, emissivity=emissivity, edge0=None,
                       edge1=None)


def vp2_sweep_y(rhs: torch.Tensor, T: torch.Tensor, code: torch.Tensor,
                glo: float, gs: float, inv_dtor: float, *, k_spec, cp_spec,
                h: float = 0.0, t_inf: float = 0.0,
                emissivity: float = 0.0) -> torch.Tensor:
    """K15's y entry ("K15y"): the tier-2 sweep along axis 1 of the natural
    (x, y, z) field, the y solve of ``adi_step_varprop_fused`` with
    ``VP2_Y_DEFAULT`` on.

    ``rhs``: the chained right-hand side; ``T``: the step's start field;
    ``code``: ``build_vp2_code(mask, 1, edge_exposed=True)``; ``glo =
    theta/dy^2`` and ``gs = 1/dy``: numbers already rounded to the field's
    dtype (the uniform geometry of JAX ``fused_vp2_sweep_axis1``), passed
    to K15 as constant columns; ``h``: the film on both faces against
    ``t_inf``, plus the radiative film with ``emissivity > 0``;
    ``inv_dtor = rho/dt``."""
    if not use_kernel(rhs, T, code):
        return vp2_sweep_y_plain(rhs, T, code, glo, gs, inv_dtor,
                                 k_spec=k_spec, cp_spec=cp_spec, h=h,
                                 t_inf=t_inf, emissivity=emissivity)
    if T.dim() != 3:
        raise ValueError(f"vp2_sweep_y: field must be 3-D, got {T.dim()}")
    g, s = (torch.full((T.shape[1],), float(v), dtype=T.dtype,
                       device=T.device) for v in (glo, gs))
    out = _launch_open("vp2_sweep_y", rhs, T, code, g, g, s, s, inv_dtor, 1,
                       k_spec=k_spec, cp_spec=cp_spec, h_lo=h, h_hi=h,
                       tinf=t_inf, emissivity=emissivity, edge0=None,
                       edge1=None)
    vp2_sweep_y.launches += 1
    return out


vp2_sweep_y.launches = 0


# ---------------------------------------------------------------------------
# K16: the periodic sweep along axis 1
# ---------------------------------------------------------------------------

def vp2_cyclic_phi_plain(rhs, T, code, geo, gs, inv_dtor, *, k_spec,
                         cp_spec, h_void=0.0, tinf_void=0.0, emissivity=0.0):
    """Plain version of K16: the cyclic streams (JAX
    ``vp2_cyclic_streams_xla`` with the hi faces beside the lo faces), the
    scaled rows, ``cyclic_thomas`` along axis 1."""
    g3 = geo[:, None, None]
    flo, fhi, sink, srhs = vp2_cyclic_streams(
        T, code, gs, k_spec=k_spec, h_void=h_void, tinf_void=tinf_void,
        emissivity=emissivity)
    rows = _scaled_rows(rhs, T, cp_spec, inv_dtor, g3 * flo, g3 * fhi, sink,
                        srhs)
    mv = (lambda t: t.movedim(1, 0))
    return cyclic_thomas(*(mv(t) for t in rows)).movedim(0, 1).contiguous()


def vp2_cyclic_phi(rhs: torch.Tensor, T: torch.Tensor, code: torch.Tensor,
                   geo: torch.Tensor, gs: torch.Tensor, inv_dtor: float, *,
                   k_spec, cp_spec, h_void: float = 0.0,
                   tinf_void: float = 0.0,
                   emissivity: float = 0.0) -> torch.Tensor:
    """K16: the tier-2 periodic sweep along axis 1 of a (B1, n, B2) field
    (phi of the natural field).

    ``code``: ``build_vp2_code(act, 1, periodic=True)`` (rows whose code is
    0 pass their rhs through: zero it on a full disk's axis ring);
    ``geo``/``gs``: (B1,) coupling ``1/(r dphi)^2`` and film ``1/(r dphi)``
    per ring; ``h_void``: the film on exposed phi faces against
    ``tinf_void``."""
    if rhs.dim() != 3 or rhs.shape[1] < 2:
        raise ValueError("vp2_cyclic_phi solves periodic lines of length "
                         f">= 2 along axis 1 of a 3-D field, got "
                         f"{tuple(rhs.shape)}")
    if not use_kernel(rhs, T, code, geo, gs):
        return vp2_cyclic_phi_plain(rhs, T, code, geo, gs, inv_dtor,
                                    k_spec=k_spec, cp_spec=cp_spec,
                                    h_void=h_void, tinf_void=tinf_void,
                                    emissivity=emissivity)
    check_kernel_inputs("vp2_cyclic_phi", T, code, rhs)
    B1, n, B2 = T.shape
    check_vectors("vp2_cyclic_phi", T, B1, geo, gs)
    ktab, kn = _table_arg(k_spec)
    ctab, cn = _table_arg(cp_spec)
    rc, tik, tik2 = _rad_args(emissivity, tinf_void)
    rad = emissivity > 0.0
    out = torch.empty_like(T)
    err = load_library().atf_vp2_cyclic_phi(
        dtype_code(T.dtype), T.device.index, ptr(rhs), ptr(T), ptr(code),
        ptr(geo), ptr(gs), ptr(out), B1, n, B2, ktab, kn, ctab, cn,
        float(inv_dtor), float(h_void), float(tinf_void), rc if rad else 0.0,
        tik, tik2, int(rad), stream_ptr(T.device))
    raise_on_error(err, "vp2_cyclic_phi")
    vp2_cyclic_phi.launches += 1
    return out


vp2_cyclic_phi.launches = 0
