"""K4's split-line design (csrc/theta_sweep.cu) against the JAX package on
the CPU.

A plain torch model of the kernel's algorithm: each x line cut into chunks
of m rows; each chunk forms its rows' right-hand sides from the stencil
with T at its m rows and one halo row on each side (zero beyond the
field), the y neighbours from the plane, and the z neighbours as the
kernel's lanes take them, from the neighbouring (y, z) pencil of the
flattened plane, kept only where the code's bit is set; then the
plan-lite rows and ``split_solve`` from tests/test_torch_split_sweeps.py
(chunk elimination, the reduced system by PCR, back substitution).  It is
held against JAX ``fused_theta_sweep_axis0(interpret=True)`` and against
``fused_theta_sweep_plain``: at float64 within 1e-10 K, at float32 within
8 float32 ulp of the output's scale.  Cases: 1, 2, 16 and 32 chunks; nx
no multiple of the chunk and below the chunk count; void gaps and mask
edges on chunk boundaries; scalar and per-axis ``inv_d2``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers import pallas_sweeps as jsw
from adi_thermal_fields_tpu.solvers.pallas_theta_sweep import (
    fused_theta_sweep_axis0)

from adi_thermal_fields_tpu_torch.bc.faces import shift_in
from adi_thermal_fields_tpu_torch.solvers import (fused_theta_sweep,
                                                  fused_theta_sweep_plain,
                                                  sweep_code)
from adi_thermal_fields_tpu_torch.solvers.sweeps import _rows_plain
from test_torch_split_sweeps import split_solve

torch.set_num_threads(1)

ATOL = 1e-10          # K, float64, fields up to 1500 C
ULP32 = 8             # float32 ulp of the output's scale
TG, DT, TINF, ROB = 0.21, 0.05, 20.0, 0.0031
C_EXP = 3.5e-7
INVS = {"scalar": 1.0e6, "per_axis": (1.0e6, 1.1e6, 0.9e6)}


def _inv3(inv):
    return (inv,) * 3 if isinstance(inv, float) else inv


def _lanes_z(t, code, bit_lo, bit_hi):
    """z-1 and z+1 of every cell as the kernel's lanes take them: the
    previous and next pencil of the flattened (y, z) plane (lane b2 -+ 1),
    kept where the code's bit is set.  Across a y row the flat neighbour
    is no z neighbour, and there the bit is clear."""
    flat = t.reshape(t.shape[0], -1)
    lo = torch.zeros_like(flat)
    hi = torch.zeros_like(flat)
    lo[:, 1:] = flat[:, :-1]
    hi[:, :-1] = flat[:, 1:]
    keep = (lambda v, b: torch.where((code & b) != 0, v.reshape(t.shape),
                                     0.0))
    return keep(lo, bit_lo), keep(hi, bit_hi)


def _chunk_rhs(T, code, row0, m, inv):
    """Phase (a)'s right-hand sides of rows row0..row0+m-1 (zero rows past
    the line): T at rows row0-1..row0+m, accumulated x, then y, then z."""
    nx = T.shape[0]
    rows = [T[i] if 0 <= i < nx else torch.zeros_like(T[0])
            for i in range(row0 - 1, row0 + m + 1)]
    t = torch.stack(rows)
    c = torch.stack([code[i] if i < nx else torch.zeros_like(code[0])
                     for i in range(row0, row0 + m)])
    bit = (lambda b: ((c & b) != 0).to(T.dtype))
    tc = t[1:-1]
    ivx, ivy, ivz = _inv3(inv)
    low, high = bit(1), bit(2)
    acc = (low * t[:-2] + high * t[2:] - (low + high) * tc) * ivx
    ylo = torch.where((c & 16) != 0, shift_in(tc, 1, -1, fill=0.0), 0.0)
    yhi = torch.where((c & 32) != 0, shift_in(tc, 1, +1, fill=0.0), 0.0)
    acc = acc + (bit(16) * ylo + bit(32) * yhi - (bit(16) + bit(32)) * tc) \
        * ivy
    zlo, zhi = _lanes_z(tc, c, 64, 128)
    acc = acc + (bit(64) * zlo + bit(128) * zhi - (bit(64) + bit(128)) * tc) \
        * ivz
    return tc + (C_EXP * bit(8)) * acc


def theta_split(T, code, inv, chunks):
    """K4's algorithm: the stencil chunk by chunk, then the split solve."""
    nx = T.shape[0]
    m = max(2, -(-nx // chunks))
    d = torch.cat([_chunk_rhs(T, code, j * m, m, inv)
                   for j in range(chunks)])[:nx]
    a, b, c, d = _rows_plain(d, code, TG, DT, TINF, None, ROB, None, None)
    return split_solve(a, b, c, d, chunks, "pcr")


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.25
    T = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    return mask, T


def _code(mask):
    return sweep_code(torch.from_numpy(mask), None, 0, stencil_bits=True)


@functools.cache
def _jax_ref(shape, seed, inv_name):
    mask, T = _case(shape, seed)
    jcode = jsw.sweep_code(jnp.asarray(mask), None, 0, stencil_bits=True)
    return np.array(fused_theta_sweep_axis0(
        jnp.asarray(T), jcode, C_EXP, jnp.asarray(_inv3(INVS[inv_name])),
        TG, DT, TINF, ROB, interpret=True))


def _within(got, want, dtype):
    err = float((got - want).abs().max())
    if dtype == torch.float64:
        assert err <= ATOL, err
    else:
        scale = max(1.0, float(want.abs().max()))
        assert err <= ULP32 * torch.finfo(torch.float32).eps * scale, err


@pytest.mark.parametrize("inv", list(INVS))
@pytest.mark.parametrize("chunks", [1, 2, 16, 32])
@pytest.mark.parametrize("nx", [27, 13], ids=["nx27", "nx13"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_theta_split_model_matches_jax_and_plain(nx, chunks, dtype, inv):
    """nx = 27 and 13 are no multiple of the chunk and, at 16 and 32
    chunks, below the chunk count (chunks of identity rows).  (ny, nz) =
    (5, 7): 35 lines, a group of 32 lanes and a partial one."""
    shape = (nx, 5, 7)
    mask, T = _case(shape, nx)
    code = _code(mask)
    Tt = torch.from_numpy(T).to(dtype)
    got = theta_split(Tt, code, INVS[inv], chunks)
    want = fused_theta_sweep_plain(Tt, code, C_EXP, INVS[inv], TG, DT, TINF,
                                   ROB)
    _within(got, want, dtype)
    ref = torch.from_numpy(_jax_ref(shape, nx, inv)).to(dtype)
    _within(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_theta_split_void_gaps_and_mask_edges_on_chunk_edges(dtype):
    """32 rows in 4 chunks of 8: void cells on the first and last rows of
    chunks (the halo rows then drop out), a void plane on a chunk edge
    and the mask's y and z edges through every chunk."""
    n, m = 32, 8
    mask, T = _case((n, 6, 9), 43)
    mask[:] = True
    for edge in (m - 1, m, 3 * m - 1):
        mask[edge, :3, 2:5] = False
    mask[2 * m] = False                             # a void plane
    mask[:, 5, :] = False                           # a y edge inside
    mask[:, :, 0] = False                           # a z edge inside
    code = _code(mask)
    for inv in INVS.values():
        Tt = torch.from_numpy(T).to(dtype)
        got = theta_split(Tt, code, inv, 4)
        want = fused_theta_sweep_plain(Tt, code, C_EXP, inv, TG, DT, TINF,
                                       ROB)
        _within(got, want, dtype)
    if dtype == torch.float64:
        jcode = jsw.sweep_code(jnp.asarray(mask), None, 0, stencil_bits=True)
        ref = fused_theta_sweep_axis0(
            jnp.asarray(T), jcode, C_EXP, jnp.asarray(_inv3(inv)), TG, DT,
            TINF, ROB, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("nz", [1, 13, 32, 33])
def test_lane_z_neighbours_are_the_z_neighbours(nz):
    """The flattened plane's next pencil is the z neighbour wherever the
    code's z bit is set, also when a group of 32 lanes ends inside a y row
    or a y row inside a group: the kernel's shuffle needs no z index."""
    mask, T = _case((3, 7, nz), nz)
    code = _code(mask)
    Tt = torch.from_numpy(T)
    zlo, zhi = _lanes_z(Tt, code, 64, 128)
    want_lo = torch.where((code & 64) != 0, shift_in(Tt, 2, -1, fill=0.0),
                          0.0)
    want_hi = torch.where((code & 128) != 0, shift_in(Tt, 2, +1, fill=0.0),
                          0.0)
    assert torch.equal(zlo, want_lo) and torch.equal(zhi, want_hi)


def test_k4_wrapper_on_cpu_takes_the_plain_version():
    """On CPU tensors ``fused_theta_sweep`` is its plain version (the
    kernel has no CPU form) and launches nothing."""
    mask, T = _case((9, 4, 6), 5)
    code = _code(mask)
    Tt = torch.from_numpy(T)
    before = fused_theta_sweep.launches
    got = fused_theta_sweep(Tt, code, C_EXP, INVS["per_axis"], TG, DT, TINF,
                            ROB)
    want = fused_theta_sweep_plain(Tt, code, C_EXP, INVS["per_axis"], TG,
                                   DT, TINF, ROB)
    assert torch.equal(got, want)
    assert fused_theta_sweep.launches == before
