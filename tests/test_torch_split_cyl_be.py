"""K14 and K15 on their split designs, as torch models against the JAX
package and the plain versions on the CPU.

K14 (the unmasked cylindrical step's periodic phi solve, csrc/
const_sweeps.cu) takes each ring's factors from a table built once a ring
(``cyclic_const_phi_table``: inv, cp and z of Sherman-Morrison's B z = u,
the fix-up's denominator, a/gamma and 1/den) and splits
each line into runs of m rows, one run a warp: a forward pass from zero
gives each run's last l and the row-only multiplier G (the product of
-a_i inv_i), the runs' carries chain as D = l + G D, and a second forward
pass from D gives d'; the backward pass does the same with H (the product
of -cp_i), its chain ending at y_0; then x = y - fact z with fact = (y_0 +
(a/gamma) y_{n-1}) (1/den).  ``k14_model`` repeats that order; rings whose
2 fac passes the source's ``kK14Stiff`` go to ``k14_thomas``, the Thomas
march on the
table's factors, which must equal ``cyclic_const_phi_plain`` bit for bit.
Held against JAX ``fused_cyclic_const``, ``_axis1`` and ``_nat`` in
interpret mode at float64 (1e-10 K) and the plain version at float32 (8
ulp of the output's scale on rings below the ratio, ``torch.equal`` on
flagged rings); 1-32 runs, n = 2, 3, 7, 45 and 720, a zero-fac axis ring
(the identity), a full disk's stiff rings.

K15 (the cylindrical varprop step's r sweep) and its y entry form K8's
general rows (``Vp2GenRows``, csrc/vp2_sweep.cu); lines of up to
kK15MarchRows (96) rows run in Thomas order (bit for bit the plain
version: the rows formed chunk by chunk equal the plain rows, and
``thomas`` on them the plain version), longer lines on the core's strided
kernel: ``k8_general_rows`` forms them chunk by chunk, ``split_solve``
solves them, and a block of 32 lines with a row past kK8Stiff goes to
Thomas order (``k15_model``).  Held against JAX
``fused_vp2_sweep`` (solve-leading, interpret) at float32 and JAX's
streams with its ``thomas`` at float64, and the plain version: the right-
hand side None (T) and given, both edge films, h_lo != h_hi, n = 37 and
64; K15y's constant columns along y at float32.  ~40 s on one worker.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers import pallas_vp2 as jvp2
from adi_thermal_fields_tpu.solvers.pallas_sweeps import (
    fused_cyclic_const, fused_cyclic_const_axis1, fused_cyclic_const_nat)
from adi_thermal_fields_tpu.solvers.thomas import thomas as j_thomas

from adi_thermal_fields_tpu_torch import CylindricalGrid, Material
from adi_thermal_fields_tpu_torch.solvers import (
    build_vp2_code, cyclic_const_phi, cyclic_const_phi_plain,
    cyclic_const_phi_table, cyclic_const_phi_table_plain, vp2_sweep_strided,
    vp2_sweep_strided_plain, vp2_sweep_y, vp2_sweep_y_plain)
from adi_thermal_fields_tpu_torch.solvers.thomas import thomas
from adi_thermal_fields_tpu_torch.step import cylindrical as pcyl
from test_torch_split_varprop import (_chunk, _field, _spec, _t, _tables,
                                      _within, split_solve)
from test_torch_split_vp2_gstream import k8_general_rows, stiff_lines
from test_torch_split_z_pencils import stiff_ratio

torch.set_num_threads(1)

ATOL = 1e-10                       # K, float64
ULP32 = 8                          # float32 ulp of the output's scale
# K14's stiffness ratio: rings with 2 fac past it go to Thomas order
K14_STIFF = stiff_ratio("kK14Stiff", "const_sweeps.cu")
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------

def k14_thomas(rhs, fac, table):
    """A flagged ring's march: Thomas order on the table's factors,
    ``cyclic_const_thomas``'s operations (one rounding each)."""
    B1, n, _ = rhs.shape
    inv, cp, z = (table[:, j * n:(j + 1) * n, None] for j in range(3))
    den = table[:, 3 * n, None]
    a = -fac[:, None]
    gamma = -(1.0 + 2.0 * fac[:, None])
    y = torch.empty_like(rhs)
    dy = torch.zeros_like(rhs[:, 0])
    for i in range(n):
        ai = torch.zeros_like(a) if i == 0 else a
        dy = (rhs[:, i] - ai * dy) * inv[:, i]
        y[:, i] = dy
    yn = torch.zeros_like(dy)
    for i in range(n - 1, -1, -1):
        yn = y[:, i] - cp[:, i] * yn
        y[:, i] = yn
    fact = (y[:, 0] + a * y[:, n - 1] / gamma) / den
    return y - fact[:, None] * z


def k14_split(rhs, fac, table, m):
    """The kernel's split order on every ring: runs of ``m`` rows, the
    carries chained in run order, x = y - fact z."""
    B1, n, B2 = rhs.shape
    inv, cp, z = (table[:, j * n:(j + 1) * n, None] for j in range(3))
    e, rden = table[:, 3 * n + 1, None], table[:, 3 * n + 2, None]
    a = -fac[:, None]
    zero = torch.zeros_like(rhs[:, 0])
    runs = [range(r, min(n, r + m)) for r in range(0, n, m)]
    coef = (lambda i: torch.zeros_like(a) if i == 0 else a)
    # forward from zero: each run's last l and G
    ends = []
    for run in runs:
        l, g = zero, torch.ones_like(a)
        for i in run:
            l = (rhs[:, i] - coef(i) * l) * inv[:, i]
            g = g * (-coef(i) * inv[:, i])
        ends.append((l, g))
    # the carries, then forward again from them: d'
    dp_all = torch.empty_like(rhs)
    carry = zero
    for run, (l, g) in zip(runs, ends):
        dp = carry
        for i in run:
            dp = (rhs[:, i] - coef(i) * dp) * inv[:, i]
            dp_all[:, i] = dp
        carry = l + g * carry
    yn = dp_all[:, n - 1]
    # backward from zero: each run's first m and H
    starts = []
    for run in runs:
        mv, h = zero, torch.ones_like(a)
        for i in reversed(run):
            mv = dp_all[:, i] - cp[:, i] * mv
            h = h * -cp[:, i]
        starts.append((mv, h))
    y_in = [None] * len(runs)
    y = zero
    for j in range(len(runs) - 1, -1, -1):
        y_in[j] = y
        y = starts[j][0] + starts[j][1] * y
    fact = (y + e * yn) * rden                   # y is y_0
    x = torch.empty_like(rhs)
    for run, yv in zip(runs, y_in):
        for i in reversed(run):
            yv = dp_all[:, i] - cp[:, i] * yv
            x[:, i] = yv - fact * z[:, i]
    return x


def k14_model(rhs, fac, table, m):
    """K14: the split order, the flagged rings in Thomas order."""
    flag = 2.0 * fac > K14_STIFF
    return torch.where(flag[:, None, None], k14_thomas(rhs, fac, table),
                       k14_split(rhs, fac, table, m))


def _k14_case(n, seed, B1=5, B2=7, fac_scale=5.0):
    """rhs (B1, n, B2) and fac (B1,): ring 0 the axis ring (fac 0), ring
    B1-1 past the ratio."""
    rng = np.random.default_rng(seed)
    rhs = 20.0 + 1480.0 * rng.random((B1, n, B2))
    fac = fac_scale * rng.random(B1)
    fac[0] = 0.0
    fac[-1] = 100.0 + 300.0 * rng.random()
    return rhs, fac


@functools.lru_cache(maxsize=None)
def _k14_jax(n, seed, layout):
    rhs, fac = _k14_case(n, seed)
    fac2 = jnp.asarray(np.broadcast_to(fac[:, None],
                                       (fac.size, rhs.shape[2])))
    if layout == "axis0":
        return np.asarray(jnp.transpose(fused_cyclic_const(
            jnp.transpose(jnp.asarray(rhs), (1, 0, 2)), fac2,
            interpret=True), (1, 0, 2)))
    fn = {"axis1": fused_cyclic_const_axis1,
          "nat": fused_cyclic_const_nat}[layout]
    return np.asarray(fn(jnp.asarray(rhs), fac2, interpret=True))


@pytest.mark.parametrize("layout,n", [("axis0", 2), ("nat", 3),
                                      ("nat", 7), ("axis1", 16),
                                      ("axis0", 45), ("nat", 45)])
@CHUNKS
def test_k14_split_model_matches_jax_f64(chunks, layout, n):
    """The split order on 1-32 runs against the three JAX layouts at
    float64 (the axis-1 layout takes n % 8 == 0), the zero-fac ring the
    identity."""
    rhs, fac = _k14_case(n, n)
    R, F = _t(rhs), _t(fac)
    table = cyclic_const_phi_table_plain(F, n)
    got = k14_model(R, F, table, _chunk(n, chunks))
    want = _k14_jax(n, n, layout)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[0].numpy(), rhs[0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [2, 3, 7, 45, 720])
@CHUNKS
def test_k14_split_model_matches_plain_f32(chunks, n):
    """At float32: rings below the ratio within 8 ulp of the output's
    scale of the plain version, the flagged ring (2 fac past K14_STIFF)
    bit for bit, by the Thomas march on the table's factors."""
    rhs, fac = _k14_case(n, 100 + n, B2=5 if n == 720 else 7)
    R, F = _t(rhs, torch.float32), _t(fac, torch.float32)
    table = cyclic_const_phi_table_plain(F, n)
    flag = 2.0 * F > K14_STIFF
    assert bool(flag[-1]) and not bool(flag[:-1].any())
    got = k14_model(R, F, table, _chunk(n, chunks))
    want = cyclic_const_phi_plain(R, F)
    assert torch.equal(got[flag], want[flag])
    assert torch.equal(k14_thomas(R, F, table), want)
    _within(got[~flag], want[~flag], torch.float32)
    assert torch.equal(got[0], R[0])             # the axis ring


@DTYPES
def test_k14_full_disk_stiff_rings_replay_bit_for_bit(dtype):
    """A full disk at 0.5 mm cells and chip_smoke.py's phase 7 dt: its
    inner rings pass the ratio (Thomas order, bit for bit), its outer
    rings split."""
    grid = CylindricalGrid(24, 203, 3, 5e-4, 5e-4, r_inner=0.0)
    mat = Material(7800.0, 490.0, 54.0)
    F = pcyl._phi_fac(grid, mat, 1.0, 0.02, dtype, torch.device("cpu"))
    table = cyclic_const_phi_table_plain(F, grid.nphi)
    flag = 2.0 * F > K14_STIFF
    assert 3 <= int(flag.sum()) < grid.nr - 3
    assert not bool(flag[0])                      # fac 0: the axis ring
    rng = np.random.default_rng(5)
    R = _t(20.0 + 1480.0 * rng.random(grid.shape), dtype)
    want = cyclic_const_phi_plain(R, F)
    for m in (4, 8, 16):
        got = k14_model(R, F, table, m)
        assert torch.equal(got[flag], want[flag])
        _within(got[~flag], want[~flag], dtype)


@DTYPES
def test_k14_table_and_wrapper_on_cpu(dtype):
    """The table's factors are the plain version's (the Thomas march on
    them equals it bit for bit, every ring), its tail is den, a/gamma and
    1/den; the wrapper takes a table, refuses a wrong one,
    and the step keeps one table per dt."""
    rhs, fac = _k14_case(9, 3)
    R, F = _t(rhs, dtype), _t(fac, dtype)
    table = cyclic_const_phi_table(F, 9)
    assert table.shape == (5, 3 * 9 + 3) and table.dtype == dtype
    assert torch.equal(table, cyclic_const_phi_table_plain(F, 9))
    assert torch.equal(k14_thomas(R, F, table), cyclic_const_phi_plain(R, F))
    den, e, rden = table[:, 27], table[:, 28], table[:, 29]
    assert torch.equal(e, -F / -(1.0 + 2.0 * F))
    assert torch.equal(rden, 1.0 / den)
    assert torch.equal(cyclic_const_phi(R, F, table),
                       cyclic_const_phi_plain(R, F))
    with pytest.raises(ValueError):
        cyclic_const_phi(R, F, table[:, :-1].contiguous())
    with pytest.raises(ValueError):
        cyclic_const_phi_table(F, 1)
    grid = CylindricalGrid(6, 9, 4, 5e-4, 5e-4, r_inner=0.01)
    mat = Material(7800.0, 490.0, 54.0)
    key = (grid, mat, 1.0, 0.02, dtype, torch.device("cpu"))
    assert pcyl._phi_table(*key) is pcyl._phi_table(*key)
    assert torch.equal(pcyl._phi_table(*key), cyclic_const_phi_table_plain(
        pcyl._phi_fac(*key), grid.nphi))


# ---------------------------------------------------------------------------
# K15 and K15y
# ---------------------------------------------------------------------------

def k15_model(rows, m, dtype, B1=1):
    """The strided kernel's solve of ``rows`` along axis 0 (the trailing
    axes flattened to (B1, B2) lines): split, and at float32 every block
    of 32 lines adjacent in B2 with a row past kK8Stiff in Thomas
    order."""
    got = split_solve(*rows, m)
    if dtype == torch.float32:
        stiff = stiff_lines(*rows[:3]).reshape(B1, -1)
        B2 = stiff.shape[1]
        pad = stiff.new_zeros(B1, -B2 % 32)
        blocks = torch.cat([stiff, pad], 1).view(B1, -1, 32).any(2)
        blocks = blocks.repeat_interleave(32, 1)[:, :B2]
        got = torch.where(blocks.reshape(rows[0].shape[1:]), thomas(*rows),
                          got)
    return got


def _k15_case(n, seed):
    """(mask, T, rhs, cols, films) of an r sweep on an (n, 5, 8) field:
    distinct per-row columns, h_lo != h_hi, both edge films."""
    rng = np.random.default_rng(seed)
    shape = (n, 5, 8)
    mask = rng.random(shape) > 0.2
    T = _field(rng, mask)
    rhs = np.where(mask, 20.0 + 1580.0 * rng.random(shape), 20.0)
    cols = tuple(base * (0.5 + rng.random(n))
                 for base in (4e6, 4e6, 2e3, 2e3))     # glo, ghi, gsl, gsh
    films = (80.0, 200.0, 20.0, 0.5, (50.0, 1.4e3, 30.0),
             (300.0, 2.2e3, 25.0))
    return mask, T, rhs, cols, films


def _dtor(dtype, dt=0.02):
    f = np.float32 if dtype == torch.float32 else np.float64
    dtor = f(f(dt) / f(7800.0))
    return dtor, float(f(1.0) / dtor)


def _k15_args(case, dtype, no_rhs):
    mask, T, rhs, cols, films = case
    _, _, pk, pc = _tables()
    _, inv = _dtor(dtype)
    h_lo, h_hi, tinf, eps, edge0, edge1 = films
    code = build_vp2_code(torch.from_numpy(mask), 0)
    Tt = _t(T, dtype)
    args = (None if no_rhs else _t(rhs, dtype), Tt, code,
            *(_t(c, dtype) for c in cols), inv)
    kw = dict(k_spec=pk, cp_spec=pc, h_lo=h_lo, h_hi=h_hi, tinf_void=tinf,
              emissivity=eps, edge0=edge0, edge1=edge1)
    return args, kw


@functools.lru_cache(maxsize=None)
def _k15_jax(n, seed, no_rhs, dtype):
    """JAX's K15: fused_vp2_sweep (solve-leading) at float32; at float64
    its streams and scaled rows solved by the JAX thomas."""
    mask, T, rhs, cols, films = _k15_case(n, seed)
    jk, jc, _, _ = _tables()
    dtor, _ = _dtor(dtype)
    h_lo, h_hi, tinf, eps, edge0, edge1 = films
    jcode = jvp2.build_vp2_code(jnp.asarray(mask), 0)
    kw = dict(k_spec=_spec(jk), cp_spec=_spec(jc), h_lo=h_lo, h_hi=h_hi,
              tinf_void=tinf, emissivity=eps, edge0=edge0, edge1=edge1)
    r = T if no_rhs else rhs
    if dtype == torch.float32:
        c32 = [jnp.asarray(v, jnp.float32) for v in cols]
        return np.asarray(jvp2.fused_vp2_sweep(
            None if no_rhs else jnp.asarray(rhs, jnp.float32),
            jnp.asarray(T, jnp.float32), jcode, *c32, jnp.float32(dtor),
            interpret=True, **kw))
    glo, ghi = (jnp.asarray(v)[:, None, None] for v in cols[:2])
    fhi, dw, sink, srhs = jvp2.vp2_streams_xla(
        jnp.asarray(T), jcode, jnp.asarray(cols[2]), jnp.asarray(cols[3]),
        dtor, **kw)
    al = glo * jnp.concatenate([jnp.zeros_like(fhi[:1]), fhi[:-1]], axis=0)
    ch = ghi * fhi
    coup = al + ch + sink
    w_r = jnp.where(coup > 0.0, 1.0 / dw, 1.0)
    return np.asarray(j_thomas(-al, w_r + coup, -ch,
                               jnp.asarray(r) * w_r + srhs))


def _k15_model(case, dtype, no_rhs, chunks):
    """K15's rows chunk by chunk (bit for bit the plain rows through the
    plain solve), the kernel's solve of them, and the plain version."""
    args, kw = _k15_args(case, dtype, no_rhs)
    rhs, T, code, glo, ghi, gsl, gsh, inv = args
    films = (kw["h_lo"], kw["h_hi"], kw["tinf_void"], kw["emissivity"],
             kw["edge0"], kw["edge1"])
    rows = k8_general_rows(T if rhs is None else rhs, T, code,
                           (glo, ghi, gsl, gsh), inv, kw["k_spec"],
                           kw["cp_spec"], films, _chunk(T.shape[0], chunks))
    plain = vp2_sweep_strided_plain(*args, **kw)
    assert torch.equal(thomas(*rows), plain)
    assert torch.equal(vp2_sweep_strided(*args, **kw), plain)
    return k15_model(rows, _chunk(T.shape[0], chunks), dtype), plain, rows


@DTYPES
@pytest.mark.parametrize("n,no_rhs", [(37, True), (37, False), (64, True)],
                         ids=["n37-rhs-is-T", "n37-rhs", "n64-rhs-is-T"])
@CHUNKS
def test_k15_split_model_matches_jax(chunks, n, no_rhs, dtype):
    """K15's rows on the split solve (per-row columns, h_lo != h_hi, the
    edge films at rows 0 and n-1, the rhs T itself or given) against JAX
    and the plain version."""
    case = _k15_case(n, 300 + n)
    got, plain, _ = _k15_model(case, dtype, no_rhs, chunks)
    want = torch.from_numpy(np.array(_k15_jax(n, 300 + n, no_rhs, dtype)))
    _within(got, want, dtype)
    _within(got, plain, dtype)


@pytest.mark.parametrize("chunks", [2, 8])
def test_k15_stiff_blocks_replay_bit_for_bit(chunks):
    """With couplings x3 the lines through the melt have rows past kK8Stiff:
    their blocks of 32 lines are solved in Thomas order, bit for bit the
    plain version; the other blocks split, within 8 float32 ulp."""
    dtype = torch.float32
    mask, T, rhs, cols, films = _k15_case(40, 77)
    T[:, :, 4:] = np.where(mask[:, :, 4:], 600.0, 20.0)   # solid lines
    cols = (cols[0] * 3.0, cols[1] * 3.0, cols[2], cols[3])
    got, plain, rows = _k15_model((mask, T, rhs, cols, films), dtype, False,
                                  chunks)
    stiff = stiff_lines(*rows[:3])
    assert bool(stiff.any()) and not bool(stiff.all())
    _within(got, plain, dtype)
    blocks = stiff.reshape(-1)[:32].any()
    assert bool(blocks)
    assert torch.equal(got.reshape(40, -1)[:, :32],
                       plain.reshape(40, -1)[:, :32])


@pytest.mark.parametrize("eps", [0.0, 0.5], ids=["h30", "rad"])
@CHUNKS
def test_k15y_split_model_matches_plain_f32(chunks, eps):
    """K15's y entry: constant columns glo = ghi, gsl = gsh, one film on
    both faces, no edge films, the Cartesian code (edges exposed), along
    axis 1 at float32."""
    dtype = torch.float32
    rng = np.random.default_rng(41)
    shape = (4, 45, 8)
    mask = rng.random(shape) > 0.2
    T = _t(_field(rng, mask), dtype)
    R = _t(np.where(mask, 20.0 + 1580.0 * rng.random(shape), 20.0), dtype)
    code = build_vp2_code(torch.from_numpy(mask), 1, edge_exposed=True)
    _, _, pk, pc = _tables()
    _, inv = _dtor(dtype, 0.05)
    glo = float(np.float32(0.5 / 0.5e-3 ** 2))
    gs = float(np.float32(1.0 / 0.5e-3))
    kw = dict(k_spec=pk, cp_spec=pc, h=30.0, t_inf=20.0, emissivity=eps)
    plain = vp2_sweep_y_plain(R, T, code, glo, gs, inv, **kw)
    assert torch.equal(vp2_sweep_y(R, T, code, glo, gs, inv, **kw), plain)
    n = shape[1]
    col = (lambda v: torch.full((n,), v, dtype=dtype))
    yl = (lambda t: t.movedim(1, 0))
    m = _chunk(n, chunks)
    rows = k8_general_rows(yl(R), yl(T), yl(code),
                           (col(glo), col(glo), col(gs), col(gs)), inv, pk,
                           pc, (30.0, 30.0, 20.0, eps, None, None), m)
    assert torch.equal(thomas(*rows).movedim(0, 1), plain)
    got = k15_model(rows, m, dtype, B1=shape[0]).movedim(0, 1)
    _within(got, plain, dtype)
