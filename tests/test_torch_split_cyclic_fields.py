"""The periodic split solve of K22 and K18 on their own rows, against the
JAX package on the CPU.

K22 (the periodic solve of a/b/c/d fields) and K18 (the five-stream phi
sweep of the cylindrical varprop step) run on the periodic split-line
kernel of csrc/split_cyclic.cuh, K11's and K16's: chunks of m rows,
Sherman-Morrison in ``cyclic_thomas``'s gauge with the second right-hand
side in the reduced system only, rounded divisions.  The plain torch model
of that solve (``split_cyclic``, ``cyclic_split_solve`` and
``stiff_blocks`` of tests/test_torch_split_cyclic.py) is fed with the rows
as the kernels' row formers (csrc/field_rows.cuh) form them:

* K22 ``FieldCyclicRows``: the rows as given, row 0's a the wrap coupling
  beta and row n-1's c alpha;
* ``k18_rows``: ``VpFieldCyclicRows``, chunk by chunk: each row's hi face
  flo[i + 1 mod n] (a chunk reads flo at rows row0 .. row0 + m, the last
  mod n), one tensor op per operation; these rows equal the plain
  version's bit for bit.

Both formers test a chunk's rows against ``kCyclicFieldStiff`` once all
are formed and replay a block (one b1, 32 adjacent b2) past it in Thomas
order: ``cyclic_thomas`` bit for bit.  The model is held against the plain versions and
against JAX ``fused_cyclic_fields`` and ``fused_vp_fields_cyclic_axis1``
(``fhi=None``) in interpret mode: within 1e-10 K at float64 and 8 float32
ulp of the output's scale at float32 (JAX, whose calls take most of the
file's time, on the cases of ``JAX_CASES``: every case but n = 2 at
float64, the 27-row case at float32).  1, 2, 4, 16
and 32 chunks; n = 2, 3 and 27 (no multiple of the chunk, below the chunk
count); films on and off; a full disk's zero-face axis ring (its rows
identities: the rhs passes through bit for bit); a disk whose rings past
the axis are stiff (held to the plain version bit for bit; at float32
the split solve alone parts from it by more than the gate); K22 along each axis of a field, the last one (B2 = 1) a
block a line (~20 s on one worker).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers.pallas_fields import fused_cyclic_fields
from adi_thermal_fields_tpu.solvers.pallas_vpfields import (
    fused_vp_fields_cyclic_axis1)

from adi_thermal_fields_tpu_torch.solvers import (cyclic_fields,
                                                  cyclic_fields_plain,
                                                  vp_fields_cyclic_phi,
                                                  vp_fields_cyclic_phi_plain)

from test_torch_split_cyclic import (DISK_GEO, ULP32, _chunk, _kernel_ratio,
                                     _t, _within, cyclic_split_solve,
                                     split_cyclic, stiff_blocks)

torch.set_num_threads(1)

DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])
STIFF = _kernel_ratio("field_rows.cuh", "kCyclicFieldStiff")
SHAPE_B = (4, 6)                  # (B1, B2) of every case
# the (case, dtype) pairs also held against JAX
JAX_CASES = {("n3", torch.float64), ("n27-films-disk", torch.float64),
             ("stiff-disk", torch.float64), ("n27-films-disk", torch.float32)}


def kernel_solve(a, b, c, d, m):
    """The kernels' solve along axis 0 of (n, B1, B2) rows in chunks of
    ``m``: the split solve, the blocks past STIFF in Thomas order."""
    return cyclic_split_solve(a, b, c, d, m, STIFF)


def _mv(t):
    return t.movedim(1, 0)


# ---------------------------------------------------------------------------
# K18's rows
# ---------------------------------------------------------------------------

def k18_rows(rhs, flo, dw, sink, srhs, geo, m):
    """K18's rows along axis 0 of (n, B1, B2) streams as
    ``VpFieldCyclicRows::each`` forms them chunk by chunk: a chunk's first
    lo face flo[row0], each row's hi face flo[i + 1 mod n] carried on as
    the next row's lo face, one metric geo[b1] a ring."""
    n = rhs.shape[0]
    g = geo[:, None]
    a, b, c, d = (torch.empty_like(rhs) for _ in range(4))
    for row0 in range(0, n, m):
        f_lo = flo[row0]
        for i in range(row0, min(row0 + m, n)):
            f_hi = flo[(i + 1) % n]
            w = dw[i]
            al = w * (g * f_lo)
            ch = w * (g * f_hi)
            a[i], c[i] = -al, -ch
            b[i] = 1.0 + w * (g * (f_lo + f_hi) + sink[i])
            d[i] = rhs[i] + w * srhs[i]
            f_lo = f_hi
    return a, b, c, d


def k18_plain_rows(rhs, flo, dw, sink, srhs, geo):
    """The rows of vp_fields_cyclic_phi_plain on (B1, n, B2) streams, as
    the ``fields`` tier materializes them for K22."""
    g3 = geo[:, None, None]
    fhi = torch.roll(flo, -1, 1)
    al = dw * (g3 * flo)
    ch = dw * (g3 * fhi)
    b = 1.0 + dw * (g3 * (flo + fhi) + sink)
    return -al, b, -ch, rhs + dw * srhs


# (rows, films, a full disk's zero-face axis ring, stiff rings past it)
K18_CASES = {"n2-films": (2, True, False, False),
             "n3": (3, False, False, False),
             "n27-films-disk": (27, True, True, False),
             "stiff-disk": (64, True, True, True)}


def k18_case(name):
    """(rhs, flo, dw, sink, srhs, geo) on (B1, n, B2): faces of k ~ 54-216
    W/m/K with void faces zero, dw*geo*flo ~ 0.3-2 (a tube's phi rows), a
    Robin film on a third of the cells or none; a full disk's ring 0 with
    zero faces and no film (the step's axis-ring regularity); or rings 0-3
    of a 203-cell disk at 0.5 mm with dw*geo*flo in the hundreds past the
    axis."""
    n, films, disk, stiff = K18_CASES[name]
    rng = np.random.default_rng(100 + n)
    shape = (SHAPE_B[0], n, SHAPE_B[1])
    rhs = 20.0 + 1480.0 * rng.random(shape)
    flo = 54.0 * (1.0 + 3.0 * rng.random(shape)) * (rng.random(shape) > 0.2)
    dw = 2e-8 * (0.5 + rng.random(shape))
    geo = (0.5 + rng.random(shape[0])) * 3e5
    sink = np.zeros(shape)
    if films:
        sink = np.where(rng.random(shape) < 0.3, 2e6 * rng.random(shape),
                        0.0)
    if stiff:
        geo = DISK_GEO.copy()
        dw = 1.5e-9 * (0.5 + rng.random(shape))
    if disk:
        flo[0] = 0.0
        sink[0] = 0.0
    return rhs, flo, dw, sink, sink * 20.0, geo


@functools.lru_cache(maxsize=None)
def _k18_ref(name, dtype):
    """A K18 case at ``dtype`` and its JAX solution (one interpret-mode
    call for every chunk count, made when first asked for)."""
    ins = k18_case(name)
    f = np.float64 if dtype == torch.float64 else np.float32

    @functools.cache
    def ref():
        rhs, flo, dw, sink, srhs, geo = (jnp.asarray(v.astype(f))
                                         for v in ins)
        geo2 = jnp.broadcast_to(geo[:, None], SHAPE_B)
        return _t(np.asarray(fused_vp_fields_cyclic_axis1(
            rhs, flo, None, dw, sink, srhs, geo2, interpret=True)))

    return tuple(_t(v, dtype) for v in ins), ref


@DTYPES
@pytest.mark.parametrize("name", list(K18_CASES))
@CHUNKS
def test_k18_split_model_matches_jax(chunks, name, dtype):
    """K18's rows chunk by chunk (bit for bit the plain version's), the
    periodic split solve (the Thomas order on stiff blocks),
    against JAX fused_vp_fields_cyclic_axis1 and the plain version; the
    zero-face axis ring passes its rhs through bit for bit; the stiff
    disk against the plain version bit for bit."""
    ins, ref = _k18_ref(name, dtype)
    rhs, flo, dw, sink, srhs, geo = ins
    n = rhs.shape[1]
    m = _chunk(n, chunks)
    rows = k18_rows(*(_mv(t) for t in (rhs, flo, dw, sink, srhs)), geo, m)
    for got_r, want_r in zip(rows, k18_plain_rows(*ins)):
        assert torch.equal(got_r, _mv(want_r))
    got = kernel_solve(*rows, m).movedim(0, 1)
    plain = vp_fields_cyclic_phi_plain(*ins)
    assert torch.equal(vp_fields_cyclic_phi(*ins), plain)   # CPU: plain
    _within(got, plain, dtype, "plain")
    if K18_CASES[name][2]:
        assert torch.equal(got[0], rhs[0])      # the axis ring
    if K18_CASES[name][3]:
        _stiff_rings(rows, m, got, plain, dtype)
    if (name, dtype) in JAX_CASES:
        _within(got, ref(), dtype, "jax")


def _stiff_rings(rows, m, got, plain, dtype):
    """Rings 1-3 of the stiff disk: past STIFF in every block, replayed,
    bit for bit the plain version; at float32 the split solve alone parts
    from it by more than the gate."""
    assert bool(stiff_blocks(*rows[:3], STIFF)[1:].all())
    assert torch.equal(got[1:], plain[1:])
    if dtype == torch.float32:
        split = split_cyclic(*rows, m).movedim(0, 1)
        err = float((split - plain).abs().max())
        assert err > ULP32 * torch.finfo(dtype).eps * float(
            plain.abs().max())


# ---------------------------------------------------------------------------
# K22
# ---------------------------------------------------------------------------

def dominant_rows(n, seed, dtype):
    """Diagonally dominant periodic field systems on (B1, n, B2) (chip_smoke
    phase 9's: a, c in (-1, 0], b = 1 + 2 U - a - c) and a right-hand side
    over 20-1500."""
    rng = np.random.default_rng(seed)
    shape = (SHAPE_B[0], n, SHAPE_B[1])
    a, c = -rng.random(shape), -rng.random(shape)
    b = 1.0 + 2.0 * rng.random(shape) - a - c
    return tuple(_t(v, dtype) for v in (a, b, c,
                                        20.0 + 1480.0 * rng.random(shape)))


# random systems of n rows, or K18's rows of a case materialized (the
# cylindrical `fields` tier's)
K22_CASES = {"n2": 2, "n3": 3, "n27-films-disk": "n27-films-disk",
             "stiff-disk": "stiff-disk"}


@functools.lru_cache(maxsize=None)
def _k22_ref(name, dtype):
    """A K22 case's (a, b, c, d) at ``dtype`` on (B1, n, B2) and its JAX
    solution (made when first asked for)."""
    src = K22_CASES[name]
    if isinstance(src, int):
        rows = dominant_rows(src, 200 + src, dtype)
    else:
        rows = k18_plain_rows(*_k18_ref(src, dtype)[0])

    @functools.cache
    def ref():
        out = fused_cyclic_fields(*(jnp.asarray(_mv(t).numpy())
                                    for t in rows), interpret=True)
        return _t(np.asarray(out)).movedim(0, 1)

    return rows, ref


@DTYPES
@pytest.mark.parametrize("name", list(K22_CASES))
@CHUNKS
def test_k22_split_model_matches_jax(chunks, name, dtype):
    """K22's rows as given, the periodic split solve (the Thomas order on
    stiff blocks), against JAX fused_cyclic_fields and the plain version;
    the zero-face ring's identity rows pass d through bit for bit; the
    stiff disk bit for bit the plain version."""
    rows, ref = _k22_ref(name, dtype)
    n = rows[3].shape[1]
    m = _chunk(n, chunks)
    mrows = tuple(_mv(t) for t in rows)
    got = kernel_solve(*mrows, m).movedim(0, 1)
    plain = cyclic_fields_plain(*rows, 1)
    assert torch.equal(cyclic_fields(*rows, 1), plain)     # CPU: plain
    _within(got, plain, dtype, "plain")
    if name.endswith("disk"):
        assert torch.equal(got[0], rows[3][0])   # identity rows
    if name.startswith("stiff"):
        _stiff_rings(mrows, m, got, plain, dtype)
    if (name, dtype) in JAX_CASES:
        _within(got, ref(), dtype, "jax")


@DTYPES
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_k22_split_model_along_each_axis(axis, dtype):
    """K22 along each axis of a (5, 7, 40) field as the kernel views it,
    (B1, n, B2) with 32-line blocks along B2 (axis 0: B1 = 1; axis 2:
    B2 = 1, a block a line), one stiff line among mild ones: the model
    against the plain version, the stiff line's block bit for bit."""
    rng = np.random.default_rng(7 + axis)
    shape = (5, 7, 40)
    a, c = -rng.random(shape), -rng.random(shape)
    b = 1.0 + 2.0 * rng.random(shape) - a - c
    idx = [2, 3, 33]
    idx[axis] = slice(None)
    a[tuple(idx)] *= 40.0                       # ratio past STIFF
    b[tuple(idx)] = 1.0 + 0.1 - a[tuple(idx)] - c[tuple(idx)]
    d = 20.0 + 1480.0 * rng.random(shape)
    rows = tuple(_t(v, dtype) for v in (a, b, c, d))
    B1 = int(np.prod(shape[:axis]))
    n = shape[axis]
    view = (lambda t: t.reshape(B1, n, -1).movedim(1, 0))
    m = _chunk(n, 4)
    got = kernel_solve(*(view(t) for t in rows), m).movedim(0, 1) \
        .reshape(shape)
    plain = cyclic_fields_plain(*rows, axis)
    _within(got, plain, dtype, "plain")
    blk = stiff_blocks(*(view(t) for t in rows[:3]), STIFF)
    line = blk[:, None, :].expand(B1, n, blk.shape[1]).reshape(shape)
    assert bool(line.any())
    assert torch.equal(got[line], plain[line])
