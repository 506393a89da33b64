"""Tier-2 variable-property z sweep: kernel K8 and its plain version.

Counterpart: ``adi_thermal_fields_tpu/solvers/pallas_vp2.py`` —
``build_vp2_code`` (:88), ``_rad`` (:139), ``vp2_streams_xla`` (:147) and
``fused_vp2_sweep`` with ``nat_rhs_out=True`` (:402; its streaming body
``_vp2_kernel`` :201-389) -> K8 ``vp2_sweep_z``.  CUDA source:
``csrc/vp2_sweep.cu``.

K8 solves along the contiguous z axis of the natural (x, y, z) field and
derives every per-cell quantity from T^n and a 1-byte code instead of
reading prebuilt streams: k(T) and cp(T) (clamp-sum tables), the harmonic
face ``f_hi = harm(k[r], k[r+1])`` where bit 1 is set (carried to the next
row as ``f_lo``), the films ``bit2*gs*(h+hr) + bit4*gs*(h+hr)`` with ``hr``
the Picard radiative film and ``srhs = sink*t_inf``.  Rows are scaled by
``cp(T)/dtor`` (scaled-row elimination, pallas_vp2.py:335-349):

    al = glo*f_lo, ch = ghi*f_hi, coup = al + ch + sink,
    w_r = cp(T)*inv_dtor if coup > 0 else 1,
    b = w_r + coup, d = rhs*w_r + srhs, a = -al, c = -ch.

The gate ``coup > 0`` is right only for films >= 0; the varprop step and
engine refuse negative ``robin_h`` and ``emissivity``.  Code bits
(``build_vp2_code``): 1 = hi-face coupling live, 2 = lo face exposed,
4 = hi face exposed, 8 = cell active, 16 = lo-face coupling live.  The
code stays in the natural layout (the JAX step moves it to (z, x, y)), so
nothing is transposed.  Ported: the open sweep along z with symmetric
columns (``glo = ghi``, ``gs_lo = gs_hi`` scalars) and no domain-edge films
— the Cartesian step's use.  The cylindrical forms (geometry columns, edge
films, the cyclic and axis-1 kernels) are later slices.
"""
from __future__ import annotations

import torch

from ..bc.faces import shift_in
from ..bc.radiation import STEFAN_BOLTZMANN
from ..kernels import (check_kernel_inputs, dtype_code, load_library, ptr,
                       raise_on_error, stream_ptr, use_kernel)
from .thomas import thomas
from .varprop import _table_arg, eval_spec, harm

__all__ = ["build_vp2_code", "vp2_streams", "vp2_sweep_z",
           "vp2_sweep_z_plain"]

_T0K = 273.15


def build_vp2_code(act: torch.Tensor, axis: int, *,
                   edge_exposed: bool = False) -> torch.Tensor:
    """uint8 face code along ``axis`` from the active mask, in the mask's
    own layout (module bits).  ``edge_exposed``: domain-edge faces count as
    exposed (the Cartesian Robin convention); otherwise they are film-free.
    The JAX function's ``periodic`` and ``clear_rows`` (cylindrical) are
    not ported yet."""
    act = act.to(torch.bool)
    u8 = torch.uint8
    nb_hi = shift_in(act, axis, +1, fill=False)
    nb_lo = shift_in(act, axis, -1, fill=False)
    if edge_exposed:
        ex_hi, ex_lo = nb_hi, nb_lo
    else:
        ex_hi = shift_in(act, axis, +1, fill=True)
        ex_lo = shift_in(act, axis, -1, fill=True)
    return ((act & nb_hi).to(u8) | (act & ~ex_lo).to(u8) * 2
            | (act & ~ex_hi).to(u8) * 4 | act.to(u8) * 8
            | (act & nb_lo).to(u8) * 16)


def _rad(Tc: torch.Tensor, emissivity: float, tinf: float):
    """Picard radiative film of the vp2 kernels (JAX ``_rad``):
    ``(eps*sigma)*(Tk + Tik)*(Tk^2 + Tik^2)`` with ``Tik = tinf + 273.15``
    and ``Tik^2`` formed in float64."""
    Tk = Tc + _T0K
    Tik = tinf + _T0K
    return (emissivity * STEFAN_BOLTZMANN) * (Tk + Tik) * (Tk * Tk + Tik * Tik)


def _films(T, code, gs, h, tinf, emissivity):
    """(sink, srhs) of the symmetric open sweep."""
    bit = (lambda b: ((code & b) != 0).to(T.dtype))
    hh = h + (_rad(T, emissivity, tinf) if emissivity > 0.0 else 0.0)
    sink = bit(2) * gs * hh + bit(4) * gs * hh
    return sink, sink * tinf


def _faces_hi(T, code, k_spec):
    """``f_hi = harm(k[r], k[r+1])*bit1`` along z (the last row's
    neighbour replicates it; bit 1 is 0 there)."""
    k = eval_spec(k_spec, T)
    k_up = torch.cat([k[..., 1:], k[..., -1:]], dim=-1)
    return harm(k, k_up) * ((code & 1) != 0).to(T.dtype)


def vp2_streams(T, code, gs, dtor, *, k_spec, cp_spec, h: float,
                tinf: float, emissivity: float = 0.0):
    """``(fhi, dw, sink, srhs)`` along z, JAX ``vp2_streams_xla`` for the
    symmetric Cartesian use (``gs_lo = gs_hi = gs``, ``h_lo = h_hi = h``,
    no edge films), in the natural layout; ``dw = dtor/cp(T)``."""
    sink, srhs = _films(T, code, gs, h, tinf, emissivity)
    return (_faces_hi(T, code, k_spec), dtor / eval_spec(cp_spec, T), sink,
            srhs)


def vp2_sweep_z_plain(rhs, T, code, glo, gs, inv_dtor, *, k_spec, cp_spec,
                      h=0.0, t_inf=0.0, emissivity=0.0):
    """Plain version of K8: the streams, the scaled rows, ``thomas``."""
    fhi = _faces_hi(T, code, k_spec)
    sink, srhs = _films(T, code, gs, h, t_inf, emissivity)
    al = glo * shift_in(fhi, 2, -1, fill=0.0)
    ch = glo * fhi
    coup = al + ch + sink
    w_r = torch.where(coup > 0.0, eval_spec(cp_spec, T) * inv_dtor, 1.0)
    b = w_r + coup
    d = rhs * w_r + srhs
    mv = (lambda t: t.movedim(2, 0))
    return thomas(mv(-al), mv(b), mv(-ch), mv(d)).movedim(0, 2).contiguous()


def vp2_sweep_z(rhs: torch.Tensor, T: torch.Tensor, code: torch.Tensor,
                glo: float, gs: float, inv_dtor: float, *, k_spec, cp_spec,
                h: float = 0.0, t_inf: float = 0.0,
                emissivity: float = 0.0) -> torch.Tensor:
    """K8: the tier-2 sweep along the contiguous z axis.

    ``rhs``: the chained right-hand side (the y sweep's output); ``T``: the
    step's start field T^n, from which k, cp and the films are derived;
    ``code``: ``build_vp2_code(mask, 2, edge_exposed=True)`` (natural
    layout); ``glo = theta/dz^2``; ``gs = 1/dz``; ``inv_dtor = rho/dt`` at
    the field's dtype; ``h``: the convective film; ``emissivity > 0`` adds
    the radiative film against ``t_inf``."""
    if not use_kernel(rhs, T, code):
        return vp2_sweep_z_plain(rhs, T, code, glo, gs, inv_dtor,
                                 k_spec=k_spec, cp_spec=cp_spec, h=h,
                                 t_inf=t_inf, emissivity=emissivity)
    if rhs.dim() != 3:
        raise ValueError(f"vp2_sweep_z: field must be 3-D, got {rhs.dim()}")
    check_kernel_inputs("vp2_sweep_z", rhs, code, T)
    ktab, kn = _table_arg(k_spec)
    ctab, cn = _table_arg(cp_spec)
    rad = emissivity > 0.0
    tik = t_inf + _T0K
    out = torch.empty_like(rhs)
    scratch = torch.empty_like(rhs)
    err = load_library().atf_vp2_sweep_z(
        dtype_code(rhs.dtype), rhs.device.index, ptr(rhs), ptr(T), ptr(code),
        ptr(out), ptr(scratch), rhs.shape[0] * rhs.shape[1], rhs.shape[2],
        ktab, kn, ctab, cn, glo, gs, inv_dtor, h, t_inf,
        emissivity * STEFAN_BOLTZMANN if rad else 0.0, tik, tik * tik,
        int(rad), stream_ptr(rhs.device))
    raise_on_error(err, "vp2_sweep_z")
    vp2_sweep_z.launches += 1
    return out


vp2_sweep_z.launches = 0
