"""The split-line solve of K21 and K17 on their own rows, against the JAX
package on the CPU.

K21 (Thomas on a/b/c/d fields) and K17 (the five-stream sweep of the
cylindrical varprop step) run on the split-line core of
csrc/split_line.cuh: each line cut into chunks of m rows, each chunk's
rows formed and eliminated in registers, the chunks' first and last rows
solved as a reduced system by cyclic reduction, then each chunk
back-substituted; along the strided axes on the core's strided kernel,
along the contiguous last axis on the staged kernel of
csrc/split_staged.cuh.  The plain torch model of that solve
(``split_solve`` of tests/test_torch_split_varprop.py) is fed with the
rows as the kernels form them, chunk by chunk:

* ``k21_rows``: the rows as given (``FieldRows``), a[0] and c[n-1]
  dropped and rows past the line's end identities, as ``split_solve``
  takes them;
* ``k17_rows``: ``VpFieldRows``: a chunk's first lo face is fhi[row0 - 1]
  (0 at row 0), each row's hi face carried on as the next row's lo face,
  one tensor op per operation of ``vp_field_row``; these rows equal the
  plain version's bit for bit.

The model is held against JAX ``fused_tridiag_fields`` and
``fused_vp_fields_sweep`` (interpret mode) and against the port's plain
versions: within 1e-10 K at float64, and at float32 within 8 float32 ulp
of the output's scale (the kernels' gate in chip_smoke.py).  1, 2, 4, 16
and 32 chunks; lines of 1, 2 and 3 rows and lines no multiple of the
chunk; Dirichlet rows (a = c = 0, b = 1; for K17 a zero metric) and void
identity rows on chunk edges; K17's lo face carried across chunk edges.
Also: K17's natural-z plain version bit for bit its strided one on the
(z, r, phi) permutation, the ``kernels`` tier's z solve with no permute,
and, on a stiff tube, the split solve per bin of the rows' ratio and the
kernels' Thomas-order replay of blocks past kOpenStiff (~35 s on one
worker).
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers.pallas_fields import fused_tridiag_fields
from adi_thermal_fields_tpu.solvers.pallas_vpfields import (
    fused_vp_fields_sweep)

from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material, RobinBC,
                                          ZFaceBC, adi_step_cyl_varprop,
                                          apparent_cp, melt_pool_enhanced_k)
from adi_thermal_fields_tpu_torch.bc.faces import shift_in
from adi_thermal_fields_tpu_torch.solvers import (
    thomas, tridiag_fields_plain, vp_fields_sweep_strided_plain,
    vp_fields_sweep_z_plain)
from adi_thermal_fields_tpu_torch.solvers import differentiable as pdiff

from test_torch_split_varprop import ULP32, _chunk, _t, _within, split_solve

torch.set_num_threads(1)

DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])
SHAPE_B = (3, 5)           # the lines' batch: lines along axis 0
EDGE_M = 8                 # the chunk whose edges the "edges" cases load


# ---------------------------------------------------------------------------
# the kernels' rows, chunk by chunk
# ---------------------------------------------------------------------------

def k21_rows(a, b, c, d, m):
    """K21's rows along axis 0 as ``FieldRows`` forms them, chunk by chunk
    of ``m`` rows: the rows as given (``split_solve`` drops a[0] and
    c[n-1] and pads the line with identity rows, as ``Chunk::load_rows``
    and the former do)."""
    n = d.shape[0]
    rows = [torch.empty_like(d) for _ in range(4)]
    for row0 in range(0, n, m):
        sel = slice(row0, min(row0 + m, n))
        for out, t in zip(rows, (a, b, c, d)):
            out[sel] = t[sel]
    return tuple(rows)


def k17_rows(rhs, fhi, dw, sink, srhs, glo, ghi, m):
    """K17's rows along axis 0 as ``VpFieldRows`` forms them: per chunk
    f_lo = fhi[row0 - 1] (0 at row 0) read once, each row's f_hi carried
    on as the next row's f_lo; one tensor op per operation of
    ``vp_field_row``."""
    n = rhs.shape[0]
    a, b, c, d = (torch.empty_like(rhs) for _ in range(4))
    for row0 in range(0, n, m):
        f_lo = fhi[row0 - 1] if row0 > 0 else torch.zeros_like(fhi[0])
        for i in range(row0, min(row0 + m, n)):
            f_hi = fhi[i]
            al = glo[i] * f_lo
            ch = ghi[i] * f_hi
            a[i] = -dw[i] * al
            c[i] = -dw[i] * ch
            b[i] = 1.0 + dw[i] * ((al + ch) + sink[i])
            d[i] = rhs[i] + dw[i] * srhs[i]
            f_lo = f_hi
    return a, b, c, d


def k17_plain_rows(rhs, fhi, dw, sink, srhs, glo, ghi):
    """The plain version's rows (solvers/vpfields.py)."""
    shape = [-1] + [1] * (rhs.dim() - 1)
    al = glo.view(shape) * shift_in(fhi, 0, -1, fill=0.0)
    ch = ghi.view(shape) * fhi
    return (-dw * al, 1.0 + dw * (al + ch + sink), -dw * ch,
            rhs + dw * srhs)


# ---------------------------------------------------------------------------
# cases: lines along axis 0 of (n, 3, 5)
# ---------------------------------------------------------------------------

def _edge_rows(n):
    """Rows on the edges of EDGE_M-row chunks: identity (void) rows and
    Dirichlet rows."""
    m = EDGE_M
    return ([r for r in (m - 1, m, 3 * m - 1) if r < n],
            [r for r in (0, 2 * m - 1, 2 * m) if r < n])


def k21_case(n, seed, edges=False):
    """Diagonally dominant a/b/c/d; ``edges``: void identity rows in the
    first two lines and Dirichlet rows (a = c = 0, b = 1, d = 1400) in
    the others on the edges of 8-row chunks."""
    rng = np.random.default_rng(seed)
    shape = (n, *SHAPE_B)
    a = -rng.random(shape)
    c = -rng.random(shape)
    b = 1.0 + 2.0 * rng.random(shape) - a - c
    d = 20.0 + 1480.0 * rng.random(shape)
    if edges:
        void, pins = _edge_rows(n)
        for rows, sel, val in ((void, np.s_[:, :2], 20.0),
                               (pins, np.s_[:, 2:], 1400.0)):
            for r in rows:
                a[r][sel], c[r][sel], b[r][sel] = 0.0, 0.0, 1.0
                d[r][sel] = val
    return a, b, c, d


def k17_case(n, seed, edges=False, fo=2.0):
    """Streams of the cylindrical varprop step (rhs, fhi, dw, sink, srhs)
    and metric columns glo/ghi, coupling dw*glo*fhi ~ ``fo``; the last hi
    face zero (the domain edge); ``edges``: void cells (both faces and the
    sink zero: identity rows) in the first two lines and Dirichlet rows
    (zero metric, zero sink) on the edges of 8-row chunks."""
    rng = np.random.default_rng(seed)
    shape = (n, *SHAPE_B)
    rhs = 1000.0 + 600.0 * rng.random(shape)
    fhi = 54.0 * (1.0 + 3.0 * rng.random(shape)) * (rng.random(shape) > 0.1)
    fhi[-1] = 0.0
    dw = fo / 216.0 / 4e6 * (0.5 + rng.random(shape))
    sink = 3e3 * rng.random(shape) * (rng.random(shape) > 0.5)
    glo, ghi = 4e6 * (0.5 + rng.random(n)), 4e6 * (0.5 + rng.random(n))
    if edges:
        void, pins = _edge_rows(n)
        for r in void:
            fhi[r][:2] = 0.0
            if r > 0:
                fhi[r - 1][:2] = 0.0
            sink[r][:2] = 0.0
        for r in pins:
            glo[r] = ghi[r] = 0.0
            sink[r] = 0.0
    return rhs, fhi, dw, sink, sink * 20.0, glo, ghi


# (rows, chunk-edge rows): 27 and 13 rows are no multiple of the chunk
# and, at 16 and 32 chunks, below the chunk count
CASES = {"n1": (1, False), "n2": (2, False), "n3": (3, False),
         "n13": (13, False), "n27": (27, False), "edges32": (32, True)}


def _jd(dtype):
    return jnp.float64 if dtype == torch.float64 else jnp.float32


@functools.lru_cache(maxsize=None)
def _k21_ref(name, dtype):
    """A K21 case and its JAX solution (one interpret-mode call for every
    chunk count)."""
    n, edges = CASES[name]
    case = k21_case(n, seed=n, edges=edges)
    want = fused_tridiag_fields(*(jnp.asarray(x, _jd(dtype)) for x in case),
                                interpret=True)
    return case, np.asarray(want)


@functools.lru_cache(maxsize=None)
def _k17_ref(name, dtype):
    n, edges = CASES[name]
    case = k17_case(n, seed=50 + n, edges=edges)
    want = fused_vp_fields_sweep(*(jnp.asarray(x, _jd(dtype)) for x in case),
                                 interpret=True)
    return case, np.asarray(want)


# ---------------------------------------------------------------------------
# K21 and K17: the model against JAX and the plain versions
# ---------------------------------------------------------------------------

@DTYPES
@pytest.mark.parametrize("name", list(CASES))
@CHUNKS
def test_k21_split_model_matches_jax(chunks, name, dtype):
    """K21's rows chunk by chunk, the split solve, against JAX
    ``fused_tridiag_fields`` and the plain version; "edges32": void
    identity rows and Dirichlet rows on the edges of 8-row chunks."""
    case, ref = _k21_ref(name, dtype)
    rows = [_t(x, dtype) for x in case]
    m = _chunk(rows[3].shape[0], chunks)
    got = split_solve(*k21_rows(*rows, m), m)
    _within(got, torch.from_numpy(ref), dtype)
    _within(got, tridiag_fields_plain(*rows, 0), dtype)


@DTYPES
@pytest.mark.parametrize("name", list(CASES))
@CHUNKS
def test_k17_split_model_matches_jax(chunks, name, dtype):
    """K17's rows chunk by chunk (each chunk's first lo face from the
    chunk before), bit for bit the plain version's rows, the split solve,
    against JAX ``fused_vp_fields_sweep`` and the plain version;
    "edges32": void cells and Dirichlet rows on the edges of 8-row
    chunks."""
    case, ref = _k17_ref(name, dtype)
    streams = [_t(x, dtype) for x in case]
    m = _chunk(streams[0].shape[0], chunks)
    rows = k17_rows(*streams, m)
    for got_r, want_r in zip(rows, k17_plain_rows(*streams)):
        assert torch.equal(got_r, want_r)
    got = split_solve(*rows, m)
    _within(got, torch.from_numpy(ref), dtype)
    _within(got, vp_fields_sweep_strided_plain(*streams), dtype)


@DTYPES
def test_k17_natural_z_plain_is_the_permuted_plain(dtype):
    """K17's z entry's plain version on the natural (r, phi, z) streams
    equals, bit for bit, the strided plain version on their (z, r, phi)
    permutation moved back (the step's former z solve)."""
    rng = np.random.default_rng(7)
    rhs, fhi, dw, sink, srhs, glo, ghi = k17_case(19, 7, edges=True)
    nat = [_t(np.moveaxis(x, 0, 2), dtype) for x in (rhs, fhi, dw, sink,
                                                      srhs)]
    nat[0] = nat[0] + _t(rng.random(nat[0].shape), dtype)
    cols = (_t(glo, dtype), _t(ghi, dtype))
    got = vp_fields_sweep_z_plain(*nat, *cols)
    zl = [t.permute(2, 0, 1).contiguous() for t in nat]
    want = vp_fields_sweep_strided_plain(*zl, *cols).permute(1, 2, 0) \
        .contiguous()
    assert got.is_contiguous() and got.shape == nat[0].shape
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the kernels tier's z solve permutes nothing
# ---------------------------------------------------------------------------

def test_kernels_tier_solves_z_on_the_natural_streams(monkeypatch):
    """The Douglas step of the ``kernels`` tier hands K17's z entry the
    natural (r, phi, z) streams and permutes nothing: no permute, movedim
    or transpose outside the kernel wrappers (whose plain versions run
    here, on the CPU)."""
    grid = CylindricalGrid(6, 8, 11, 5e-4, 5e-4, r_inner=0.02)
    rng = np.random.default_rng(3)
    act = torch.from_numpy(rng.random(grid.shape) > 0.2)
    T = torch.where(act, _t(1400.0 + 100.0 * rng.random(grid.shape)), 20.0)
    moves = []
    inside = [0]

    def count(name, fn):
        def call(*args, **kwargs):
            if not inside[0]:
                moves.append(name)
            return fn(*args, **kwargs)
        return call

    for name in ("permute", "movedim", "moveaxis", "transpose", "swapaxes"):
        monkeypatch.setattr(torch.Tensor, name,
                            count(name, getattr(torch.Tensor, name)))
        monkeypatch.setattr(torch, name, count(name, getattr(torch, name)))
    z_calls = []

    def kernel(name, fn):
        def call(*args):
            if name == "vp_fields_sweep_z":
                z_calls.append([tuple(t.shape) for t in args[:5]])
            inside[0] += 1
            try:
                return fn(*args)
            finally:
                inside[0] -= 1
        return call

    # the kernels tier calls the wrappers through solvers/differentiable.py
    for name in ("vp_fields_sweep_strided", "vp_fields_cyclic_phi",
                 "vp_fields_sweep_z"):
        monkeypatch.setattr(pdiff, name, kernel(name, getattr(pdiff, name)))
    out = adi_step_cyl_varprop(
        T, grid, Material(7800.0, 490.0, 54.0), dt=0.05,
        robin_outer=RobinBC(300.0, 20.0),
        zbc=ZFaceBC(kind_bot="dirichlet", T_bot=1400.0, kind_top="robin",
                    h_top=400.0, T_inf_top=20.0),
        k_table=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
        cp_table=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0),
        active=act, h_void=80.0, emissivity=0.5, scheme="douglas")
    assert bool(torch.isfinite(out).all())
    assert z_calls == [[grid.shape] * 5]
    assert moves == []


# ---------------------------------------------------------------------------
# stiffness: the split solve per bin of the rows' ratio, and the replay
# ---------------------------------------------------------------------------

# bins of a line's largest |a| + |c| over b - |a| - |c| (for K17's rows
# dw*(al + ch) / (1 + dw*sink), about twice the Fourier number)
EDGES = (0.0, 2.0, 8.0, 16.0, 32.0, 128.0)


def open_stiff():
    """kOpenStiff of csrc/field_rows.cuh: the ratio past which a block of
    lines is solved again in Thomas order."""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "adi_thermal_fields_tpu_torch", "csrc",
                       "field_rows.cuh")
    return float(re.search(r"constexpr double kOpenStiff = ([0-9.e+]+);",
                           open(src).read()).group(1))


def line_ratio(rows):
    """Each line's largest ratio, as the kernels take it (a[0] and c[n-1]
    do not count)."""
    a, b, c, _ = (t.double() for t in rows)
    a, c = a.clone(), c.clone()
    a[0] = 0.0
    c[-1] = 0.0
    off = a.abs() + c.abs()
    return (off / (b - off)).amax(dim=0)


def test_k17_split_model_and_replay_on_a_stiff_tube():
    """K17's rows at float32 on 64-row lines whose Fourier numbers span
    0.2-50 (the chip's step rows reach ~9 at the tube's dt, ~45 on the
    spiral app's Douglas print), in chunks of 8 rows, in blocks of 32
    lines as the strided kernel takes them: the split solve alone stays
    within 8 float32 ulp of the output's scale from the plain version in
    every bin of the lines' ratio up to kOpenStiff; with the kernels'
    rule at float32 (a block with a line past kOpenStiff solved in Thomas
    order) the stiff blocks equal the plain version bit for bit and every
    block is within 8 ulp."""
    n, lines, m = 64, 32 * 8, 8
    stiff_at = open_stiff()
    fos = np.logspace(np.log10(0.2), np.log10(50.0), lines)
    for seed in (11, 12):
        rng = np.random.default_rng(seed)
        shape = (n, lines)
        fhi = 54.0 * (1.0 + 3.0 * rng.random(shape))
        fhi[-1] = 0.0
        sink = 3e3 * rng.random(shape) * (rng.random(shape) > 0.5)
        case = (1000.0 + 600.0 * rng.random(shape), fhi,
                fos / 216.0 / 4e6 * (0.5 + rng.random(shape)), sink,
                sink * 20.0, 4e6 * (0.5 + rng.random(n)),
                4e6 * (0.5 + rng.random(n)))
        streams = [_t(x, torch.float32) for x in case]
        rows = k17_rows(*streams, m)
        split = split_solve(*rows, m)
        want = vp_fields_sweep_strided_plain(*streams)
        ratio = line_ratio(rows)
        ulp = torch.finfo(torch.float32).eps * float(want.abs().max())
        err = (split - want).abs().amax(dim=0) / ulp
        reached = 0
        for lo, hi in zip(EDGES[:-1], EDGES[1:]):
            sel = (ratio >= lo) & (ratio < hi)
            reached += bool(sel.any())
            if hi <= stiff_at and bool(sel.any()):
                assert float(err[sel].max()) <= ULP32, (lo, hi)
        assert reached == len(EDGES) - 1
        # the kernels' rule, block by block
        stiff = (ratio.view(-1, 32) > stiff_at).any(dim=1)
        assert 0 < int(stiff.sum()) < stiff.numel()
        got = torch.where(stiff.repeat_interleave(32)[None], thomas(*rows),
                          split)
        blk = stiff.repeat_interleave(32)
        assert torch.equal(got[:, blk], want[:, blk])
        _within(got, want, torch.float32)
