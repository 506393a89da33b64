"""The split-line solve of K10 and K26 on their own rows, against the JAX
package on the CPU.

K10 (the masked-Robin z sweep of the cylindrical masked step) and K26 (the
g-stream z sweep of the bfloat16 varprop step) run on the staged kernel of
csrc/split_staged.cuh: each contiguous z line cut into chunks of m rows,
each chunk's rows formed from the staged tiles and eliminated in
registers, the chunks' first and last rows solved as a reduced system by
cyclic reduction, then each chunk back-substituted.  The plain torch model
of that solve (``split_solve`` of tests/test_torch_split_varprop.py) is
fed with the rows as the kernels' row formers form them, chunk by chunk:

* ``k10_rows``: ``MaskedRows``: ``masked_row`` and ``prefold`` of
  csrc/masked.cu from the code byte, glo/ghi, sink, rhs and srhs, one
  tensor op per operation;
* ``k26_rows``: ``GStreamRows``: a = -g_lo, c = -g_hi, b = ((1 + g_lo) +
  g_hi) + sw, d = rhs + sw*t_inf from streams widened to float32.

Both equal their plain versions' rows bit for bit.  The model is held
against JAX ``fused_masked_sweep(nat_rhs_out=True)`` and ``gstream_sweep``
(on the (z, x, y) transpose) in interpret mode: K10 within 1e-10 K at
float64 and 8 float32 ulp of the output's scale at float32, K26 within 8
ulp at float32.  At bfloat16 the model's float32 solution, rounded with
the port's stochastic rounding under the plain version's key, lies within
one bfloat16 ulp of the output's scale of ``gstream_sweep_z_plain`` and
equals it on almost every cell.  1, 2, 4, 16 and 32 chunks; n no multiple
of the chunk; lines of 1 and 2 rows; void gaps and pinned rows on chunk
edges.  Stiff lines: at float32 the kernels solve a line with a row past
their ratio (``kK10Stiff`` of csrc/masked.cu, ``kK26Stiff`` of
csrc/gstreams.cu) again in Thomas order; on lines whose ratios span
0.5-60 the model's split solve stays within 8 ulp below the ratio and,
under the kernels' rule, the stiff lines equal the plain version bit for
bit (~25 s on one worker).
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers.pallas_fields import fused_masked_sweep
from adi_thermal_fields_tpu.solvers.pallas_gstreams import gstream_sweep

from adi_thermal_fields_tpu_torch.solvers import (gstream_sweep_z_plain,
                                                  masked_sweep_z_plain, thomas)
from adi_thermal_fields_tpu_torch.solvers.rounding import round_bf16, sr_key

from test_torch_split_varprop import _chunk, _t, _within, split_solve

torch.set_num_threads(1)

CHUNKS = (1, 2, 4, 16, 32)
FAC, AMB = 0.37, 20.0            # K10: fac*geo ~ O(1), as in a step
TINF = 20.0
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])
# (r, phi, z) or (x, y, z): line counts of 12 and 6, z of 1, 2 and rows no
# multiple of the chunks' 2-37 rows
SHAPES = ((3, 4, 37), (2, 3, 64), (3, 4, 1), (2, 3, 2))


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

@functools.cache
def _masked_case(shape):
    """rhs, code, sink, srhs, glo, ghi (numpy, natural layout): void (30%)
    and pinned (10%) cells, couplings between live neighbours along z."""
    rng = np.random.default_rng(sum(shape))
    active = rng.random(shape) > 0.3
    pin = (rng.random(shape) > 0.9) & active
    n = shape[-1]
    for chunks in CHUNKS:                # a chunk's last and first rows
        m = _chunk(n, chunks)
        for i in (m - 1, m):
            if i < n:
                active[0, 0, i] = False              # void
                active[-1, -1, i] = pin[-1, -1, i] = True
    live = active & ~pin
    idx = np.arange(n)
    lowm = live & np.roll(live, 1, -1) & (idx > 0)
    highm = live & np.roll(live, -1, -1) & (idx < n - 1)
    sink = np.where(live, rng.random(shape), 0.0)
    srhs = np.where(pin, 77.0, np.where(live, sink * 20.0, 0.0))
    code = (lowm.astype(np.uint8) | (highm.astype(np.uint8) << 1)
            | (pin.astype(np.uint8) << 2) | (active.astype(np.uint8) << 3))
    return (rng.random(shape) * 900.0, code, sink, srhs,
            0.5 + rng.random(n), 0.5 + rng.random(n))


@functools.cache
def _masked_jax(shape, dtype):
    rhs, code, sink, srhs, glo, ghi = _masked_case(shape)
    f = np.float64 if dtype == torch.float64 else np.float32
    zf = (lambda a: jnp.asarray(np.moveaxis(a, 2, 0)))
    out = fused_masked_sweep(
        jnp.asarray(rhs.astype(f)), zf(code.view(np.int8)),
        zf(sink.astype(f)), jnp.asarray(glo.astype(f)),
        jnp.asarray(ghi.astype(f)), FAC, zf(srhs.astype(f)), AMB,
        interpret=True, nat_rhs_out=True)
    return np.asarray(out)


def _masked_inputs(shape, dtype):
    rhs, code, sink, srhs, glo, ghi = _masked_case(shape)
    return (_t(rhs, dtype), torch.from_numpy(code), _t(sink, dtype),
            _t(srhs, dtype), _t(glo, dtype), _t(ghi, dtype))


def k10_rows(rhs, code, sink, srhs, glo, ghi, fac, ambient, m):
    """``MaskedRows::load_staged``'s rows along axis 0 (z moved first),
    chunk by chunk: al = glo*low, ch = ghi*high, a = -fac*al, c =
    -fac*ch, b = 1 + fac*((al + ch) + sink), d = pin ? srhs : (in-mask ?
    rhs + fac*srhs : ambient)."""
    dtype, n = rhs.dtype, rhs.shape[0]
    f = torch.tensor(fac, dtype=dtype)
    a, b, c, d = (torch.empty_like(rhs) for _ in range(4))
    for row0 in range(0, n, m):
        s = slice(row0, min(row0 + m, n))
        cd = code[s]
        bshape = (-1,) + (1,) * (rhs.dim() - 1)
        al = glo[s].view(bshape) * ((cd & 1) != 0).to(dtype)
        ch = ghi[s].view(bshape) * ((cd & 2) != 0).to(dtype)
        a[s] = -f * al
        c[s] = -f * ch
        b[s] = 1.0 + f * ((al + ch) + sink[s])
        d[s] = torch.where((cd & 4) != 0, srhs[s],
                           torch.where((cd & 8) != 0, rhs[s] + f * srhs[s],
                                       torch.tensor(ambient, dtype=dtype)))
    return a, b, c, d


def _plain_masked_rows(rhs, code, sink, srhs, glo, ghi, fac, ambient):
    """The rows ``masked_sweep_z_plain`` hands to ``thomas`` (z first)."""
    low = ((code & 1) != 0).to(rhs.dtype)
    high = ((code & 2) != 0).to(rhs.dtype)
    al = glo.view(-1, *([1] * (rhs.dim() - 1))) * low
    ch = ghi.view(-1, *([1] * (rhs.dim() - 1))) * high
    d = torch.where((code & 4) != 0, srhs,
                    torch.where((code & 8) != 0, rhs + fac * srhs, ambient))
    return -fac * al, 1.0 + fac * (al + ch + sink), -fac * ch, d


def _zfirst(t):
    return t.movedim(-1, 0)


@DTYPES
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k10_split_model_matches_jax_and_plain(shape, dtype):
    rhs, code, sink, srhs, glo, ghi = _masked_inputs(shape, dtype)
    zs = [_zfirst(t) for t in (rhs, code, sink, srhs)]
    want = masked_sweep_z_plain(rhs, code, sink, srhs, glo, ghi, FAC, AMB)
    ref = torch.from_numpy(_masked_jax(shape, dtype).copy())
    plain_rows = _plain_masked_rows(*zs, glo, ghi, FAC, AMB)
    n = shape[-1]
    for chunks in CHUNKS:
        m = _chunk(n, chunks)
        rows = k10_rows(*zs, glo, ghi, FAC, AMB, m)
        for got_r, want_r in zip(rows, plain_rows):
            assert torch.equal(got_r, want_r), (chunks, m)
        got = split_solve(*rows, m).movedim(0, -1)
        _within(got, ref, dtype)
        _within(got, want, dtype)


def test_k10_voids_and_pins_reach_chunk_edges():
    """The cases put void and pinned rows on the first and last rows of
    chunks at every chunk count (where a chunk's rows couple to the
    neighbouring chunk's)."""
    for shape in SHAPES[:2]:
        code = _masked_case(shape)[1]
        n = shape[-1]
        for chunks in CHUNKS:
            m = _chunk(n, chunks)
            if m >= n:
                continue
            edge = np.zeros(n, bool)
            edge[m - 1::m] = True
            edge[m::m] = True
            at = code[..., edge]
            assert ((at & 8) == 0).any(), (shape, chunks)          # void
            assert ((at & 4) != 0).any(), (shape, chunks)          # pinned


# ---------------------------------------------------------------------------
# K26
# ---------------------------------------------------------------------------

@functools.cache
def _gstream_case(shape):
    """rhs, g_lo, g_hi, sw (numpy float64, natural layout): ratios
    (g_lo + g_hi) / (1 + sw) up to ~6, all-zero streams on void cells."""
    rng = np.random.default_rng(7 + sum(shape))
    live = rng.random(shape) > 0.2
    g_lo = 3.0 * rng.random(shape) * live
    g_hi = 3.0 * rng.random(shape) * live
    g_lo[..., 0] = 0.0
    g_hi[..., -1] = 0.0
    sw = 0.2 * rng.random(shape) * live * (rng.random(shape) > 0.5)
    return 20.0 + 1480.0 * rng.random(shape), g_lo, g_hi, sw


@functools.cache
def _gstream_jax(shape):
    zxy = (lambda a: jnp.asarray(np.moveaxis(a, 2, 0).astype(np.float32)))
    out = gstream_sweep(*(zxy(a) for a in _gstream_case(shape)), TINF,
                        interpret=True)
    return np.moveaxis(np.asarray(out), 0, 2)


def k26_rows(rhs, g_lo, g_hi, sw, t_inf, m):
    """``GStreamRows::load_staged``'s rows along axis 0, chunk by chunk,
    from the streams widened to float32 (bfloat16) or as they are."""
    wide = (lambda t: t.float() if t.dtype == torch.bfloat16 else t)
    rhs, g_lo, g_hi, sw = (wide(t) for t in (rhs, g_lo, g_hi, sw))
    a, b, c, d = (torch.empty_like(rhs) for _ in range(4))
    for row0 in range(0, rhs.shape[0], m):
        s = slice(row0, row0 + m)
        a[s] = -g_lo[s]
        c[s] = -g_hi[s]
        b[s] = ((1.0 + g_lo[s]) + g_hi[s]) + sw[s]
        d[s] = rhs[s] + sw[s] * t_inf
    return a, b, c, d


def _plain_gstream_rows(rhs, g_lo, g_hi, sw, t_inf):
    """The rows ``_gsolve`` hands to ``thomas`` (z first)."""
    wide = (lambda t: t.float() if t.dtype == torch.bfloat16 else t)
    rhs, g_lo, g_hi, sw = (wide(t) for t in (rhs, g_lo, g_hi, sw))
    return -g_lo, 1.0 + g_lo + g_hi + sw, -g_hi, rhs + sw * t_inf


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k26_split_model_matches_jax_and_plain_f32(shape):
    ins = [_t(a, torch.float32) for a in _gstream_case(shape)]
    zs = [_zfirst(t) for t in ins]
    want = gstream_sweep_z_plain(*ins, TINF)
    ref = torch.from_numpy(_gstream_jax(shape).copy())
    plain_rows = _plain_gstream_rows(*zs, TINF)
    n = shape[-1]
    for chunks in CHUNKS:
        m = _chunk(n, chunks)
        rows = k26_rows(*zs, TINF, m)
        for got_r, want_r in zip(rows, plain_rows):
            assert torch.equal(got_r, want_r), (chunks, m)
        got = split_solve(*rows, m).movedim(0, -1)
        _within(got, ref, torch.float32)
        _within(got, want, torch.float32)


@pytest.mark.parametrize("seed", [None, 12345], ids=["nearest", "seeded"])
@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
def test_k26_split_model_rounds_as_plain_bf16(shape, seed):
    """bfloat16 streams: the model's rows equal ``_gsolve``'s bit for bit;
    its float32 solution stored as the kernel stores it (``round_bf16``
    under the plain version's key, at the natural index) lies within one
    bfloat16 ulp of the output's scale of the plain version and equals it
    on at least 99% of the cells."""
    ins = [_t(a, torch.float32).to(torch.bfloat16)
           for a in _gstream_case(shape)]
    zs = [_zfirst(t) for t in ins]
    want = gstream_sweep_z_plain(*ins, TINF, rng_seed=seed, rng_offset=3)
    plain_rows = _plain_gstream_rows(*zs, TINF)
    scale = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    for chunks in CHUNKS:
        m = _chunk(shape[-1], chunks)
        rows = k26_rows(*zs, TINF, m)
        for got_r, want_r in zip(rows, plain_rows):
            assert torch.equal(got_r, want_r), (chunks, m)
        x = split_solve(*rows, m).movedim(0, -1).contiguous()
        got = round_bf16(x, sr_key(seed, 3))
        assert float((got.float() - want.float()).abs().max()) <= ulp
        assert float((got != want).double().mean()) <= 0.01


# ---------------------------------------------------------------------------
# stiff lines: the split solve per ratio, and the Thomas-order replay
# ---------------------------------------------------------------------------

def stiff_ratio(name, src):
    """A kernel's replay ratio, ``constexpr double name`` of csrc/src."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "adi_thermal_fields_tpu_torch", "csrc", src)
    return float(re.search(rf"constexpr double {name} = ([0-9.e+]+);",
                           open(path).read()).group(1))


def _line_ratio(rows):
    """Each line's largest (|a| + |c|) / (b - |a| - |c|) (z first; a[0]
    and c[n-1] do not count) and the kernels' flag at ``ratio`` (float32:
    |a| + |c| > q b, q = ratio / (1 + ratio))."""
    a, b, c, _ = rows
    a, c = a.clone(), c.clone()
    a[0] = 0.0
    c[-1] = 0.0
    off = a.abs() + c.abs()
    ratio = (off / (b - off)).double().flatten(1).amax(dim=0)
    return ratio, off, b


def _replay_rule(rows, want, split, kind, stiff_at):
    """The split solve within 8 ulp below ``stiff_at``; the lines past it
    (the kernels' float32 test) in Thomas order equal ``want``."""
    ratio, off, b = _line_ratio(rows)
    q = torch.tensor(stiff_at / (1.0 + stiff_at), dtype=torch.float32)
    flag = (off > q * b).flatten(1).any(dim=0)
    assert 0 < int(flag.sum()) < flag.numel()
    w = want.movedim(-1, 0).flatten(1)
    ulp = torch.finfo(torch.float32).eps * float(want.abs().max())
    err = (split.flatten(1) - w).abs().amax(dim=0) / ulp
    assert float(err[ratio < stiff_at].max()) <= 8.0
    x = (thomas(*rows, reciprocal=True) if kind == "K26"
         else thomas(*rows)).flatten(1)
    assert torch.equal(x[:, flag], w[:, flag])


def test_k10_replay_rule_on_stiff_lines():
    """K10's float32 rows on 48-row lines whose ratios span 0.5-60 (the
    sink per line sets it; the step's tube sits near 2, the spiral app's
    ring near 9 at the step's dt), in chunks of 8 rows."""
    n, lines = 48, 96
    rng = np.random.default_rng(5)
    fac = 20.0
    glo, ghi = 1.0 + 0.2 * rng.random(n), 1.0 + 0.2 * rng.random(n)
    target = np.logspace(np.log10(0.5), np.log10(60.0), lines)
    sink = (2.0 * fac * 1.1 / target - 1.0) / fac
    sink = np.broadcast_to(np.clip(sink, 0.0, None), (n, lines)).copy()
    code = np.full((n, lines), 8 | 1 | 2, np.uint8)
    code[0] &= ~np.uint8(1)
    code[-1] &= ~np.uint8(2)
    ins = (_t(600.0 + 900.0 * rng.random((n, lines)), torch.float32),
           torch.from_numpy(code), _t(sink, torch.float32),
           _t(sink * 20.0, torch.float32), _t(glo, torch.float32),
           _t(ghi, torch.float32))
    rows = k10_rows(*ins[:4], ins[4], ins[5], fac, AMB, 8)
    nat = [t.movedim(0, -1) for t in ins[:4]]
    want = masked_sweep_z_plain(*nat, ins[4], ins[5], fac, AMB)
    _replay_rule(rows, want, split_solve(*rows, 8), "K10",
                 stiff_ratio("kK10Stiff", "masked.cu"))


def test_k26_replay_rule_on_stiff_lines():
    """K26's float32 rows on 48-row lines whose ratios span 0.5-60 (the
    streams per line set it; the step's rows sit at 1-9 at its dt), in
    chunks of 8 rows: the Thomas order in grow's reciprocal form."""
    n, lines = 48, 96
    rng = np.random.default_rng(6)
    target = np.logspace(np.log10(0.5), np.log10(60.0), lines)
    shape = (n, 12, lines // 12)                   # z first
    g = 0.5 * target.reshape(shape[1:]) * (0.9 + 0.1 * rng.random(shape))
    g_lo, g_hi = g.copy(), g.copy()
    g_lo[0] = 0.0
    g_hi[-1] = 0.0
    sw = 0.05 * rng.random(shape)
    ins = [_t(a, torch.float32) for a in
           (20.0 + 1480.0 * rng.random(shape), g_lo, g_hi, sw)]
    rows = k26_rows(*ins, TINF, 8)
    want = gstream_sweep_z_plain(*(t.movedim(0, -1) for t in ins), TINF)
    _replay_rule(rows, want, split_solve(*rows, 8), "K26",
                 stiff_ratio("kK26Stiff", "gstreams.cu"))
