"""The split-line solve of K24 and K25 on their own rows, against the JAX
package on the CPU.

K24 (the g-stream theta pass fused into the x sweep) and K25 (the g-stream
y sweep) of the bfloat16 varprop step run on the strided kernel of
csrc/split_line.cuh: each x (y) line cut into chunks of m rows, lanes 32
adjacent (y, z) pencils (z columns), each chunk's rows formed and
eliminated in registers, the chunks' first and last rows solved as a
reduced system by cyclic reduction, then each chunk back-substituted.  The
plain torch model of that solve (``split_solve`` of
tests/test_torch_split_varprop.py) is fed with the rows as the kernels'
row formers form them, chunk by chunk:

* ``k24_rhs``: ``GThetaRows``'s right-hand sides, d = t + rr*((gterm_x +
  gterm_y) + gterm_z) (+ src_pre) with gterm = g_lo*(t_lo - t) + g_hi*(t_hi
  - t): T carried from row to row from the halo row before the chunk (and
  the one after it), the y neighbours from the plane, the z neighbours as
  the kernel's lanes take them, from the neighbouring pencil of the
  flattened (y, z) plane, selected by k > 0 and k + 1 < nz; each
  neighbour 0 past the domain edge.  They equal the plain version's
  (``_theta_rhs``) bit for bit.  The rows on them are ``GStreamRows``'s
  from the x streams (``k26_rows`` of tests/test_torch_split_z_pencils.py);
* K25: ``k26_rows`` along the y-first view.

Held against JAX ``gstream_theta_sweep`` and ``gstream_sweep_axis1`` in
interpret mode and against the port's plain versions: at float32 within 8
float32 ulp of the output's scale; at bfloat16 (to nearest and seeded) the
model's float32 solution, rounded as the kernels store it (the plain
version's key, the natural index), within one bfloat16 ulp of the output's
scale of the plain version and equal to it on at least 99% of the cells.
1, 2, 4, 16 and 32 chunks; n no multiple of the chunk; nz no multiple of
32 (a y row ends inside a warp); void gaps on chunk edges; src_pre.  Stiff
lines: at float32 a block of 32 lines with a row past the kernels' ratio
(``kK24Stiff`` of csrc/gstreams.cu; K25 shares K26's ``kK26Stiff``) is
solved again in Thomas order (grow's reciprocal order); on lines whose
ratios span 0.5-60
the model's split solve stays within 8 ulp below the ratio and the lines
past it equal the plain version bit for bit (~25 s on one worker).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers.pallas_gstreams import (
    gstream_sweep_axis1, gstream_theta_sweep)

from adi_thermal_fields_tpu_torch.solvers import (gstream_sweep_y_plain,
                                                  gstream_theta_sweep_plain)
from adi_thermal_fields_tpu_torch.solvers.gstreams import _theta_rhs
from adi_thermal_fields_tpu_torch.solvers.rounding import round_bf16, sr_key

from test_torch_split_varprop import _chunk, _t, _within, split_solve
from test_torch_split_z_pencils import (_replay_rule, k26_rows, stiff_ratio)

torch.set_num_threads(1)

CHUNKS = (1, 2, 4, 16, 32)
RR, TINF = 1.0, 20.0
# (nx, ny, nz): lines of 37 and 29 rows (no multiple of the chunks' 2-19
# rows), nz of 13 and 5 (y rows end inside a warp), one y row of 1
SHAPES = ((37, 4, 13), (29, 5, 5), (37, 1, 7))
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]


@functools.cache
def _case(shape, axis):
    """T and the seven streams g_lo/g_hi along x, y, z and sw along
    ``axis`` (numpy float64, natural layout), and src_pre: void cells (25%,
    and rows m - 1, m of each chunk count along ``axis`` in the first
    pencils) have all-zero streams, a coupling to a void cell is 0, ratios
    (g_lo + g_hi) / (1 + sw) up to ~6.  The couplings past the domain edge
    are not 0 (K23 makes them 0), so that a neighbour read past the edge
    instead of 0 would show."""
    rng = np.random.default_rng(11 + sum(shape) + axis)
    live = rng.random(shape) > 0.25
    n = shape[axis]
    for chunks in CHUNKS:
        m = _chunk(n, chunks)
        for i in (m - 1, m):
            if i < n:
                np.moveaxis(live, axis, 0)[i, 0, :3] = False
    T = np.where(live, 20.0 + 1480.0 * rng.random(shape), 20.0)
    streams = []
    for ax in range(3):
        lo_nb = np.ones(shape, bool)
        hi_nb = np.ones(shape, bool)
        a, b = [slice(None)] * 3, [slice(None)] * 3
        a[ax], b[ax] = slice(1, None), slice(None, -1)
        lo_nb[tuple(a)] = live[tuple(b)]
        hi_nb[tuple(b)] = live[tuple(a)]
        streams += [3.0 * rng.random(shape) * (live & lo_nb),
                    3.0 * rng.random(shape) * (live & hi_nb)]
    sw = 0.2 * rng.random(shape) * live * (rng.random(shape) > 0.5)
    src = 5.0 * rng.random(shape) * live
    return T, streams, sw, src


def _inputs(shape, axis, dtype):
    T, streams, sw, src = _case(shape, axis)
    cast = (lambda a: _t(a, torch.float32).to(dtype))
    return cast(T), [cast(s) for s in streams], cast(sw), cast(src)


def _lanes(t):
    """The previous and next pencil of the flattened (y, z) plane of ``t``
    (lanes b2 -+ 1; lanes 0 and 31 load the same cells from memory), zero
    past the plane."""
    flat = t.reshape(-1)
    lo, hi = torch.zeros_like(flat), torch.zeros_like(flat)
    lo[1:] = flat[:-1]
    hi[:-1] = flat[1:]
    return lo.reshape(t.shape), hi.reshape(t.shape)


def _y(t, step):
    """``t`` (a (y, z) plane) at y + step, zero past the plane."""
    out = torch.zeros_like(t)
    if step > 0:
        out[:-step] = t[step:]
    else:
        out[-step:] = t[:step]
    return out


def _gterm(lo, hi, t_lo, t_hi, t):
    return lo * (t_lo - t) + hi * (t_hi - t)


def k24_rhs(T, g, rr, src_pre, m):
    """Phase (a)'s right-hand sides of K24 (``GThetaRows::form``), chunk by
    chunk along x, at float32 from the state widened."""
    wide = (lambda t: None if t is None else t.float()
            if t.dtype == torch.bfloat16 else t)
    T, src_pre = wide(T), wide(src_pre)
    gx_lo, gx_hi, gy_lo, gy_hi, gz_lo, gz_hi = (wide(s) for s in g)
    nx, ny, nz = T.shape
    zero = torch.zeros_like(T[0])
    j = torch.arange(ny).view(ny, 1).expand(ny, nz)
    k = torch.arange(nz).view(1, nz).expand(ny, nz)
    ylo, yhi, zlo, zhi = j > 0, j + 1 < ny, k > 0, k + 1 < nz
    sel = (lambda cond, v: torch.where(cond, v, zero))
    rows = []
    for row0 in range(0, nx, m):
        t_lo = T[row0 - 1] if row0 > 0 else zero
        t_c = T[row0]
        for i in range(row0, min(row0 + m, nx)):
            t_hi = T[i + 1] if i + 1 < nx else zero
            tz_lo, tz_hi = _lanes(t_c)
            acc = _gterm(gx_lo[i], gx_hi[i], t_lo, t_hi, t_c)
            acc = acc + _gterm(gy_lo[i], gy_hi[i], sel(ylo, _y(T[i], -1)),
                               sel(yhi, _y(T[i], 1)), t_c)
            acc = acc + _gterm(gz_lo[i], gz_hi[i], sel(zlo, tz_lo),
                               sel(zhi, tz_hi), t_c)
            d = t_c + rr * acc
            if src_pre is not None:
                d = d + src_pre[i]
            rows.append(d)
            t_lo, t_c = t_c, t_hi
    return torch.stack(rows)


def k24_split(T, g, sw, src_pre, m):
    """K24's algorithm: the stencil chunk by chunk, the x rows, the split
    solve (float32); also returns the right-hand sides."""
    d = k24_rhs(T, g, RR, src_pre, m)
    return split_solve(*k26_rows(d, g[0], g[1], sw, TINF, m), m), d


def k25_split(rhs, g_lo, g_hi, sw, m):
    """K25's algorithm: the y rows chunk by chunk, the split solve."""
    ys = [t.movedim(1, 0) for t in (rhs, g_lo, g_hi, sw)]
    return split_solve(*k26_rows(*ys, TINF, m), m).movedim(0, 1)


@functools.cache
def _jax_k24(shape, src):
    T, g, sw, src_pre = _inputs(shape, 0, torch.float32)
    j = (lambda t: jnp.asarray(t.numpy()))
    out = gstream_theta_sweep(j(T), *(j(s) for s in g), j(sw), RR, TINF,
                              src_pre=j(src_pre) if src else None,
                              interpret=True)
    return torch.from_numpy(np.asarray(out).copy())


@functools.cache
def _jax_k25(shape):
    T, g, sw, _ = _inputs(shape, 1, torch.float32)
    j = (lambda t: jnp.asarray(t.numpy()))
    out = gstream_sweep_axis1(j(T), j(g[2]), j(g[3]), j(sw), TINF,
                              interpret=True)
    return torch.from_numpy(np.asarray(out).copy())


def _bf16_gate(x, want, key):
    """``x`` (float32) stored as the kernels store it, against the plain
    version: within one bfloat16 ulp of the output's scale, equal on at
    least 99% of the cells."""
    got = round_bf16(x.contiguous(), key)
    scale = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp
    assert float((got != want).double().mean()) <= 0.01


# ---------------------------------------------------------------------------
# K24
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [False, True], ids=["", "src_pre"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_k24_split_model_matches_jax_and_plain_f32(shape, src):
    T, g, sw, sp = _inputs(shape, 0, torch.float32)
    sp = sp if src else None
    want = gstream_theta_sweep_plain(T, *g, sw, RR, TINF, src_pre=sp)
    ref = _jax_k24(shape, src)
    plain_d = _theta_rhs(T, *g, RR, sp)
    for chunks in CHUNKS:
        m = _chunk(shape[0], chunks)
        got, d = k24_split(T, g, sw, sp, m)
        assert torch.equal(d, plain_d), (chunks, m)
        _within(got, ref, torch.float32)
        _within(got, want, torch.float32)


@pytest.mark.parametrize("seed", [None, 12345], ids=["nearest", "seeded"])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_k24_split_model_rounds_as_plain_bf16(shape, seed):
    """bfloat16 T and streams: the right-hand sides equal the plain
    version's bit for bit (float32 from the widened state); the solution
    stored under the plain version's key lies within one bfloat16 ulp of
    it."""
    T, g, sw, sp = _inputs(shape, 0, torch.bfloat16)
    want = gstream_theta_sweep_plain(T, *g, sw, RR, TINF, src_pre=sp,
                                     rng_seed=seed, rng_offset=1)
    plain_d = _theta_rhs(T, *g, RR, sp)
    for chunks in CHUNKS:
        m = _chunk(shape[0], chunks)
        x, d = k24_split(T, g, sw, sp, m)
        assert torch.equal(d, plain_d), (chunks, m)
        _bf16_gate(x, want, sr_key(seed, 1))


def test_k24_voids_reach_chunk_edges():
    """The cases put void cells (all-zero streams) on the first and last
    rows of chunks along x at every chunk count."""
    for shape in SHAPES[:2]:
        _, streams, _, _ = _case(shape, 0)
        n = shape[0]
        void = sum(s != 0.0 for s in streams) == 0
        for chunks in CHUNKS:
            m = _chunk(n, chunks)
            if m >= n:
                continue
            assert void[m - 1].any() and void[m].any(), (shape, chunks)


# ---------------------------------------------------------------------------
# K25
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_k25_split_model_matches_jax_and_plain_f32(shape):
    T, g, sw, _ = _inputs(shape, 1, torch.float32)
    want = gstream_sweep_y_plain(T, g[2], g[3], sw, TINF)
    ref = _jax_k25(shape)
    for chunks in CHUNKS:
        got = k25_split(T, g[2], g[3], sw, _chunk(shape[1], chunks))
        _within(got, ref, torch.float32)
        _within(got, want, torch.float32)


@pytest.mark.parametrize("seed", [None, 12345], ids=["nearest", "seeded"])
def test_k25_split_model_rounds_as_plain_bf16(seed):
    shape = (5, 37, 13)                            # 37-row y lines
    T, g, sw, _ = _inputs(shape, 1, torch.bfloat16)
    want = gstream_sweep_y_plain(T, g[2], g[3], sw, TINF, rng_seed=seed,
                                 rng_offset=2)
    for chunks in CHUNKS:
        x = k25_split(T, g[2], g[3], sw, _chunk(shape[1], chunks))
        _bf16_gate(x, want, sr_key(seed, 2))


# ---------------------------------------------------------------------------
# stiff lines: the split solve per ratio, and the Thomas-order replay
# ---------------------------------------------------------------------------

def _stiff_streams(rng, shape, axis):
    """Streams whose lines along ``axis`` (of (n, 12, 8): 96 lines) span
    ratios 0.5-60 (the g-stream step's rows sit at 1-9 at its dt)."""
    n = shape[axis]
    target = np.logspace(np.log10(0.5), np.log10(60.0), 96).reshape(12, 8)
    g = 0.5 * np.moveaxis(np.broadcast_to(target, (n, 12, 8)), 0, axis) \
        * (0.9 + 0.1 * rng.random(shape))
    g_lo, g_hi = g.copy(), g.copy()
    first, last = [slice(None)] * 3, [slice(None)] * 3
    first[axis], last[axis] = 0, -1
    g_lo[tuple(first)] = 0.0
    g_hi[tuple(last)] = 0.0
    return g_lo, g_hi, 0.05 * rng.random(shape)


def test_k24_replay_rule_on_stiff_lines():
    """K24's float32 rows on 48-row x lines whose ratios span 0.5-60, in
    chunks of 8 rows, the y and z streams mild."""
    shape = (48, 12, 8)
    rng = np.random.default_rng(8)
    gx_lo, gx_hi, sw = _stiff_streams(rng, shape, 0)
    g = [gx_lo, gx_hi] + [0.5 * rng.random(shape) for _ in range(4)]
    for ax, (lo, hi) in ((1, g[2:4]), (2, g[4:6])):
        first, last = [slice(None)] * 3, [slice(None)] * 3
        first[ax], last[ax] = 0, -1
        lo[tuple(first)] = 0.0
        hi[tuple(last)] = 0.0
    T = _t(20.0 + 1480.0 * rng.random(shape), torch.float32)
    g = [_t(s, torch.float32) for s in g]
    sw = _t(sw, torch.float32)
    want = gstream_theta_sweep_plain(T, *g, sw, RR, TINF)
    split, d = k24_split(T, g, sw, None, 8)
    rows = k26_rows(d, g[0], g[1], sw, TINF, 8)
    _replay_rule(rows, want.movedim(0, -1), split, "K26",
                 stiff_ratio("kK24Stiff", "gstreams.cu"))


def test_k25_replay_rule_on_stiff_lines():
    """K25's float32 rows on 48-row y lines whose ratios span 0.5-60, in
    chunks of 8 rows."""
    shape = (12, 48, 8)
    rng = np.random.default_rng(9)
    g_lo, g_hi, sw = _stiff_streams(rng, shape, 1)
    ins = [_t(a, torch.float32) for a in
           (20.0 + 1480.0 * rng.random(shape), g_lo, g_hi, sw)]
    ys = [t.movedim(1, 0) for t in ins]
    rows = k26_rows(*ys, TINF, 8)
    want = gstream_sweep_y_plain(*ins, TINF)
    _replay_rule(rows, want.movedim(1, -1), split_solve(*rows, 8), "K26",
                 stiff_ratio("kK26Stiff", "gstreams.cu"))
