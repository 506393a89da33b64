"""K9 and K13, the cylindrical steps' r and z pencil sweeps, on their
designs, as torch models against the JAX package and the plain versions on
the CPU.

K9 (the masked-Robin r sweep, csrc/masked.cu) marches a thread a line on
lines of up to kK9MarchRows rows: each row formed by ``masked_row`` and
``prefold``, eliminated in Thomas order (two rounded divisions), c' kept
in shared memory and d' in registers, then the back substitution.
``k9_march`` repeats that order one tensor op per operation and must equal
``masked_sweep_strided_plain`` bit for bit (float32 and float64, r lines
of 2, 37 and 64 rows); the plain version is held against JAX
``fused_masked_sweep`` (pipelined and streaming, interpret) at float64.
Past kK9MarchRows the lines go to the core's strided split kernel on
K10's rows (``MaskedRows``): ``k9_split_model`` feeds the rows formed
chunk by chunk (``k10_rows``) to ``split_solve``, and at float32 replays
every block of 32 lines with a row past kK10Stiff in Thomas order: within
8 float32 ulp of the output's scale, the stiff blocks bit for bit.

K13 (the constant-row z sweep of the unmasked step, csrc/const_sweeps.cu)
takes its rows' factors from a table (``const_sweep_table``: inv and cp in
``_row_factors``' order, then the rows' stiffness ratio) and splits each
line into runs, one a warp (K14's run-and-carry order): a forward pass
from zero gives each run's last l and G (the product of -a_i inv_i), the
carries chain as D = l + G D, a second forward pass from D gives d'
(d_i + radd_i first), and the backward pass does the same with H (the
product of -cp_i).  ``k13_model`` repeats that order, or, where the
table's ratio passes the source's ``kK13Stiff``, the Thomas order on the
table's factors (``k13_thomas``, bit for bit ``const_sweep_z_plain``).
Held against JAX ``fused_sweep_const(nat_rhs_out=True)`` in interpret mode
at float64 (1e-10 K) and the plain version at float32 (8 ulp of the
output's scale); 1-32 runs, n = 2, 3, 7, 131 and 512.  The table equals
``_row_factors`` bit for bit, the step builds it once per theta_dt
(~40 s on one worker).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers.pallas_fields import fused_masked_sweep
from adi_thermal_fields_tpu.solvers.pallas_sweeps import fused_sweep_const

from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material, RobinBC,
                                          ZFaceBC, adi_step_cylindrical)
from adi_thermal_fields_tpu_torch.solvers import (
    const_sweep_table, const_sweep_table_plain, const_sweep_z,
    const_sweep_z_plain, masked_sweep_strided, masked_sweep_strided_plain,
    thomas)
from adi_thermal_fields_tpu_torch.solvers.const_sweeps import _row_factors
from adi_thermal_fields_tpu_torch.step import cylindrical as pcyl
from test_torch_split_varprop import _chunk, _t, _within, split_solve
from test_torch_split_z_pencils import _masked_case, k10_rows, stiff_ratio

torch.set_num_threads(1)

ATOL = 1e-10                       # K, float64
FAC, AMB = 0.37, 20.0              # K9: fac*geo ~ O(1), as in a step
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])
K10_STIFF = stiff_ratio("kK10Stiff", "masked.cu")
K13_STIFF = stiff_ratio("kK13Stiff", "const_sweeps.cu")


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def _k9_inputs(n, dtype):
    """rhs, code, sink, srhs (r first: (n, 3, 4)), glo, ghi of an r sweep:
    void and pinned rows, couplings between live neighbours along r
    (``_masked_case``'s z lines moved first)."""
    rhs, code, sink, srhs, glo, ghi = _masked_case((3, 4, n))
    first = (lambda a: np.ascontiguousarray(np.moveaxis(a, -1, 0)))
    return (_t(first(rhs), dtype), torch.from_numpy(first(code)),
            _t(first(sink), dtype), _t(first(srhs), dtype), _t(glo, dtype),
            _t(ghi, dtype))


def k9_march(rhs, code, sink, srhs, glo, ghi, fac, ambient):
    """The march's order along axis 0, one tensor op per operation: each
    row by ``masked_row`` and ``prefold``, ``eliminate`` (c' = c/den, d' =
    (d - a d')/den, den = b - a c'), then x = d' - c' x."""
    dtype, n = rhs.dtype, rhs.shape[0]
    f = torch.tensor(fac, dtype=dtype)
    amb = torch.tensor(ambient, dtype=dtype)
    cp = torch.zeros_like(rhs[0])
    dp = torch.zeros_like(rhs[0])
    cps, dps = [], []
    for i in range(n):
        cd = code[i]
        al = glo[i] * ((cd & 1) != 0).to(dtype)
        ch = ghi[i] * ((cd & 2) != 0).to(dtype)
        a = -f * al
        c = -f * ch
        b = 1.0 + f * ((al + ch) + sink[i])
        d = torch.where((cd & 4) != 0, srhs[i],
                        torch.where((cd & 8) != 0, rhs[i] + f * srhs[i],
                                    amb))
        den = b - a * cp
        cp = c / den
        dp = (d - a * dp) / den
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(rhs[0])
    out = torch.empty_like(rhs)
    for i in range(n - 1, -1, -1):
        x = dps[i] - cps[i] * x
        out[i] = x
    return out


@functools.cache
def _k9_jax(n, pipelined):
    rhs, code, sink, srhs, glo, ghi = _k9_inputs(n, torch.float64)
    j = (lambda t: jnp.asarray(t.numpy()))
    return np.asarray(fused_masked_sweep(
        j(rhs), jnp.asarray(code.numpy().view(np.int8)), j(sink), j(glo),
        j(ghi), FAC, j(srhs), AMB, interpret=True, pipelined=pipelined))


@DTYPES
@pytest.mark.parametrize("n", [2, 37, 64])
def test_k9_march_is_the_plain_version_bit_for_bit(n, dtype):
    ins = _k9_inputs(n, dtype)
    want = masked_sweep_strided_plain(*ins, FAC, AMB)
    assert torch.equal(k9_march(*ins, FAC, AMB), want)
    assert torch.equal(masked_sweep_strided(*ins, FAC, AMB), want)


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "streaming"])
@pytest.mark.parametrize("n", [2, 37, 64])
def test_k9_plain_matches_jax_f64(n, pipelined):
    ins = _k9_inputs(n, torch.float64)
    got = masked_sweep_strided_plain(*ins, FAC, AMB)
    np.testing.assert_allclose(got.numpy(), _k9_jax(n, pipelined), rtol=0,
                               atol=ATOL)


def _stiff_blocks(rows):
    """Each line's flag (trailing axes flattened) where its block of 32
    lines has a row past kK10Stiff, as the float32 test takes it: |a| +
    |c| > q b, q = float32(r/(1 + r)), a[0] and c[n-1] dropped."""
    a, b, c, _ = (t.reshape(t.shape[0], -1) for t in rows)
    a, c = a.clone(), c.clone()
    a[0] = 0.0
    c[-1] = 0.0
    q = torch.tensor(K10_STIFF / (1.0 + K10_STIFF), dtype=torch.float32)
    f = (lambda t: t.to(torch.float32))
    stiff = ((f(a).abs() + f(c).abs()) > q * f(b)).any(0)
    lines = stiff.numel()
    pad = torch.cat([stiff, stiff.new_zeros(-lines % 32)])
    return pad.view(-1, 32).any(1).repeat_interleave(32)[:lines]


def k9_split_model(rows, m, dtype):
    """The strided split kernel on K10's rows along axis 0: split, and at
    float32 every block of 32 lines with a row past kK10Stiff in Thomas
    order."""
    got = split_solve(*rows, m)
    if dtype == torch.float32:
        blocks = _stiff_blocks(rows).view(rows[0].shape[1:])
        got = torch.where(blocks, thomas(*rows), got)
    return got


@DTYPES
@CHUNKS
def test_k9_past_its_march_split_model_matches_plain(chunks, dtype):
    """r lines of 97 rows (past the march) on the split kernel: the rows
    formed chunk by chunk are the plain rows bit for bit, the solve within
    8 float32 ulp of the output's scale (1e-10 K at float64) of the plain
    version."""
    n = 97
    ins = _k9_inputs(n, dtype)
    want = masked_sweep_strided_plain(*ins, FAC, AMB)
    m = _chunk(n, chunks)
    rows = k10_rows(*ins, FAC, AMB, m)
    assert torch.equal(thomas(*rows), want)
    _within(k9_split_model(rows, m, dtype), want, dtype)


def test_k9_past_its_march_stiff_blocks_replay_bit_for_bit():
    """Float32 r lines of 97 rows whose ratios span 0.5-60 (the sink per
    line sets it), 96 lines in chunks of 8 rows: the blocks with a line
    past kK10Stiff equal the plain version bit for bit, the others stay
    within 8 ulp of the output's scale."""
    n, lines, fac = 97, 96, 20.0
    rng = np.random.default_rng(9)
    glo, ghi = 1.0 + 0.2 * rng.random(n), 1.0 + 0.2 * rng.random(n)
    target = np.logspace(np.log10(0.5), np.log10(60.0), lines)
    target = target[rng.permutation(lines)]
    target[32:64] = np.minimum(target[32:64], 8.0)   # one block below
    sink = np.clip((2.0 * fac * 1.1 / target - 1.0) / fac, 0.0, None)
    sink = np.broadcast_to(sink, (n, lines)).copy()
    code = np.full((n, lines), 8 | 1 | 2, np.uint8)
    code[0] &= ~np.uint8(1)
    code[-1] &= ~np.uint8(2)
    f32 = torch.float32
    ins = (_t(600.0 + 900.0 * rng.random((n, lines)), f32),
           torch.from_numpy(code), _t(sink, f32), _t(sink * 20.0, f32),
           _t(glo, f32), _t(ghi, f32))
    want = masked_sweep_strided_plain(*ins, fac, AMB)
    rows = k10_rows(*ins, fac, AMB, 8)
    blocks = _stiff_blocks(rows)
    assert bool(blocks.any()) and not bool(blocks.all())
    got = k9_split_model(rows, 8, f32)
    assert torch.equal(got[:, blocks], want[:, blocks])
    _within(got, want, f32)


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------

def _k13_vecs(n, dtype, dt=0.05):
    """The step's z rows for nz = n (Dirichlet bottom, Robin top, 0.5 mm
    cells; ratio 2 fac ~ 5.7 at 0.05 s)."""
    grid = CylindricalGrid(2, 3, n, 5e-4, 5e-4, r_inner=0.02)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                  h_top=400.0)
    (a, b, c, radd), _ = pcyl._z_coefficients(
        grid, Material(7800.0, 490.0, 54.0), zbc, dt, dtype,
        torch.device("cpu"))
    return a, b, c, radd


def _k13_rhs(n, dtype, B1=3, B2=5):
    rng = np.random.default_rng(n)
    return _t(20.0 + 1480.0 * rng.random((B1, B2, n)), dtype)


def k13_thomas(rhs, a, radd, table):
    """A stiff table's march: forward's and the back substitution's
    operations on the table's factors, one rounding each."""
    n = rhs.shape[-1]
    inv, cp = table[:n], table[n:2 * n]
    d = rhs.movedim(-1, 0)
    out = torch.empty_like(d)
    dp = torch.zeros_like(d[0])
    for i in range(n):
        dp = ((d[i] + radd[i]) - a[i] * dp) * inv[i]
        out[i] = dp
    x = torch.zeros_like(d[0])
    for i in range(n - 1, -1, -1):
        x = out[i] - cp[i] * x
        out[i] = x
    return out.movedim(0, -1)


def k13_split(rhs, a, radd, table, m):
    """The kernel's run-and-carry order: runs of ``m`` rows, the carries
    chained in run order."""
    n = rhs.shape[-1]
    inv, cp = table[:n], table[n:2 * n]
    d = rhs.movedim(-1, 0)
    zero = torch.zeros_like(d[0])
    one = torch.ones((), dtype=d.dtype)
    runs = [range(r, min(n, r + m)) for r in range(0, n, m)]
    coef = (lambda i: torch.zeros_like(a[0]) if i == 0 else a[i])
    ends = []                                    # forward from zero
    for run in runs:
        l, g = zero, one
        for i in run:
            l = ((d[i] + radd[i]) - coef(i) * l) * inv[i]
            g = g * (-coef(i) * inv[i])
        ends.append((l, g))
    dps = torch.empty_like(d)                    # forward again: d'
    carry = zero
    for run, (l, g) in zip(runs, ends):
        dp = carry
        for i in run:
            dp = ((d[i] + radd[i]) - coef(i) * dp) * inv[i]
            dps[i] = dp
        carry = l + g * carry
    starts = []                                  # backward from zero
    for run in runs:
        mv, h = zero, one
        for i in reversed(run):
            mv = dps[i] - cp[i] * mv
            h = h * -cp[i]
        starts.append((mv, h))
    y_in = [None] * len(runs)
    y = zero
    for j in range(len(runs) - 1, -1, -1):
        y_in[j] = y
        y = starts[j][0] + starts[j][1] * y
    x = torch.empty_like(d)                      # backward again: x
    for run, yv in zip(runs, y_in):
        for i in reversed(run):
            yv = dps[i] - cp[i] * yv
            x[i] = yv
    return x.movedim(0, -1)


def k13_model(rhs, a, radd, table, runs):
    """K13: the run-and-carry order on ``runs`` runs, or the Thomas order
    where the table's ratio passes kK13Stiff."""
    if float(table[-1]) > K13_STIFF:
        return k13_thomas(rhs, a, radd, table)
    n = rhs.shape[-1]
    return k13_split(rhs, a, radd, table, -(-n // runs))


@functools.cache
def _k13_jax(n):
    a, b, c, radd = _k13_vecs(n, torch.float64)
    j = (lambda t: jnp.asarray(t.numpy()))
    return np.asarray(fused_sweep_const(
        j(_k13_rhs(n, torch.float64)), j(a), j(b), j(c), j(radd),
        interpret=True, nat_rhs_out=True))


@pytest.mark.parametrize("n", [2, 3, 7, 131, 512])
@CHUNKS
def test_k13_split_model_matches_jax_f64(chunks, n):
    a, b, c, radd = _k13_vecs(n, torch.float64)
    table = const_sweep_table_plain(a, b, c)
    assert float(table[-1]) < K13_STIFF
    got = k13_model(_k13_rhs(n, torch.float64), a, radd, table, chunks)
    np.testing.assert_allclose(got.numpy(), _k13_jax(n), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [2, 3, 7, 131, 512])
@CHUNKS
def test_k13_split_model_matches_plain_f32(chunks, n):
    dtype = torch.float32
    a, b, c, radd = _k13_vecs(n, dtype)
    table = const_sweep_table_plain(a, b, c)
    R = _k13_rhs(n, dtype)
    want = const_sweep_z_plain(R, a, b, c, radd)
    assert torch.equal(k13_thomas(R, a, radd, table), want)
    _within(k13_model(R, a, radd, table, chunks), want, dtype)


@DTYPES
@pytest.mark.parametrize("n", [3, 131])
def test_k13_stiff_table_takes_thomas_order_bit_for_bit(n, dtype):
    """At a dt whose table passes kK13Stiff (2 fac ~ 2.3e5 at 2000 s) the
    model takes the Thomas order: the plain version bit for bit, at every
    run count."""
    a, b, c, radd = _k13_vecs(n, dtype, dt=2000.0)
    table = const_sweep_table_plain(a, b, c)
    assert float(table[-1]) > K13_STIFF
    R = _k13_rhs(n, dtype)
    want = const_sweep_z_plain(R, a, b, c, radd)
    for runs in (1, 2, 16):
        assert torch.equal(k13_model(R, a, radd, table, runs), want)


@DTYPES
def test_k13_table_wrapper_and_step_cache(dtype, monkeypatch):
    """The table: ``_row_factors``' inv and cp bit for bit, then the rows'
    stiffness ratio; const_sweep_z with and without it alike; a wrong one
    refused; the steps build one z table (and one r table) per
    theta_dt."""
    n = 9
    a, b, c, radd = _k13_vecs(n, dtype)
    table = const_sweep_table(a, b, c)
    assert table.shape == (2 * n + 1,) and table.dtype == dtype
    assert torch.equal(table, const_sweep_table_plain(a, b, c))
    inv, cp = _row_factors(a, b, c)
    assert torch.equal(table[:n], inv) and torch.equal(table[n:2 * n], cp)
    off = a.abs() + c.abs()
    off[0] = c[0].abs()
    off[-1] = a[-1].abs()
    assert torch.equal(table[-1], (off / (b - off)).max())
    R = _k13_rhs(n, dtype)
    assert torch.equal(const_sweep_z(R, a, b, c, radd, table),
                       const_sweep_z(R, a, b, c, radd))
    with pytest.raises(ValueError):
        const_sweep_z(R, a, b, c, radd, table[:-1].contiguous())
    # a row that is not diagonally dominant: an infinite ratio
    assert float(const_sweep_table_plain(a, b - 2.0 * b, c)[-1]) == \
        float("inf")

    built = []

    def counting(*args):
        built.append(args[1].numel())
        return const_sweep_table(*args)

    monkeypatch.setattr(pcyl, "const_sweep_table", counting)
    pcyl._r_table.cache_clear()
    pcyl._z_table.cache_clear()
    grid = CylindricalGrid(4, 6, n, 5e-4, 5e-4, r_inner=0.02)
    mat = Material(7800.0, 490.0, 54.0)
    kw = dict(dt=0.02, robin_outer=RobinBC(300.0, 20.0),
              zbc=ZFaceBC(kind_bot="neumann0", kind_top="robin",
                          h_top=400.0), implementation="kernels")
    T = _t(20.0 + 1480.0 * np.random.default_rng(3).random(grid.shape),
           dtype)
    for scheme in ("be", "douglas"):
        X = T
        for _ in range(3):
            X = adi_step_cylindrical(X, grid, mat, scheme=scheme, **kw)
    # theta_dt: dt, then 0.5 dt; at each, K12's r table (nr rows) first
    assert built == [grid.nr, n, grid.nr, n]
    pcyl._r_table.cache_clear()
    pcyl._z_table.cache_clear()
