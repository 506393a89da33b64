"""K12, the unmasked cylindrical step's r sweep, on its design, as torch
models against the JAX package and the plain version on the CPU.

K12 (csrc/const_sweeps.cu) takes its rows' factors from a table
(``const_sweep_table``: inv and cp in ``_row_factors``' order, then the
rows' stiffness ratio), which the step builds once per theta_dt and keeps
(``_r_table``).  On r lines of up to kK12MarchRows rows (kK12MarchRows64
at float64) it marches a thread a line: forward's roundings, d' kept on
chip (in registers, past kK12RegRows rows in shared memory), then the
back substitution.  ``k12_march`` repeats that order one tensor op per
operation and must equal ``const_sweep_strided_plain`` bit for bit
(float32 and float64, r lines of 2, 3, 37 and the march's last rows).
Longer lines are split as K14's and K13's: a tile's lanes are 32 adjacent
lines, its warps runs of rows, a forward pass from zero gives each run's
last l and G, the carries chain as D = l + G D, a second pass gives d',
and the backward pass does the same with H.  ``k12_split_model`` repeats
that order along axis 0 (``k13_split``'s), or, where the table's ratio
passes the source's ``kK12Stiff``, the Thomas order (bit for bit).  Held
against JAX ``fused_sweep_const`` (its axis-0 form, interpret mode) at
float64 (1e-10 K) and the plain version at float32 (8 ulp of the output's
scale); 1-32 runs, n = 2, 3, 7, 37 and 131 (~10 s on one worker).
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers.pallas_sweeps import fused_sweep_const

from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material, RobinBC,
                                          ZFaceBC, adi_step_cylindrical)
from adi_thermal_fields_tpu_torch.solvers import (
    const_sweep_strided, const_sweep_strided_plain, const_sweep_table,
    const_sweep_table_plain, launch_counts, reset_launch_counts)
from adi_thermal_fields_tpu_torch.step import cylindrical as pcyl
from test_torch_split_cyl_pencils import k13_split, k13_thomas
from test_torch_split_varprop import _t, _within

torch.set_num_threads(1)

ATOL = 1e-10                       # K, float64
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])
MAT = Material(7800.0, 490.0, 54.0)


def _source_constant(name):
    """``constexpr ... name = value;`` of csrc/const_sweeps.cu."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "adi_thermal_fields_tpu_torch", "csrc",
                        "const_sweeps.cu")
    return float(re.search(rf"constexpr \w+ {name} = ([0-9.e+]+);",
                           open(path).read()).group(1))


K12_MARCH = int(_source_constant("kK12MarchRows"))
K12_MARCH64 = int(_source_constant("kK12MarchRows64"))
K12_STIFF = _source_constant("kK12Stiff")


def _k12_key(n, dtype, dt=0.02):
    """The step's r rows for nr = n as ``_r_coefficients`` takes them: a
    20 mm annulus at 0.5 mm, Robin outside (h 300) and inside (h 150);
    ratio 2 fac ~ 2.3 at 0.02 s."""
    grid = CylindricalGrid(n, 3, 4, 5e-4, 5e-4, r_inner=0.02)
    return (grid, MAT, RobinBC(300.0, 20.0), RobinBC(150.0, 30.0), dt, dtype,
            torch.device("cpu"))


def _k12_vecs(n, dtype, dt=0.02):
    return pcyl._r_coefficients(*_k12_key(n, dtype, dt))


def _k12_rhs(n, dtype, B1=3, B2=5):
    rng = np.random.default_rng(200 + n)
    return _t(20.0 + 1480.0 * rng.random((n, B1, B2)), dtype)


def k12_march(rhs, a, radd, table):
    """The march's order along axis 0 on the table's factors: d'_i =
    ((d_i + radd_i) - a_i d'_{i-1}) inv_i, then x_i = d'_i - cp_i x_{i+1},
    one rounding each."""
    return k13_thomas(rhs.movedim(0, -1), a, radd, table).movedim(-1, 0)


def k12_split_model(rhs, a, radd, table, runs):
    """K12 past its march: the run-and-carry order along axis 0 on
    ``runs`` runs, or the Thomas order where the table's ratio passes
    kK12Stiff."""
    if float(table[-1]) > K12_STIFF:
        return k12_march(rhs, a, radd, table)
    n = rhs.shape[0]
    return k13_split(rhs.movedim(0, -1), a, radd, table,
                     -(-n // runs)).movedim(-1, 0)


@functools.cache
def _k12_jax(n):
    a, b, c, radd = _k12_vecs(n, torch.float64)
    j = (lambda t: jnp.asarray(t.numpy()))
    return np.asarray(fused_sweep_const(
        j(_k12_rhs(n, torch.float64)), j(a), j(b), j(c), j(radd),
        interpret=True))


@DTYPES
@pytest.mark.parametrize("n", sorted({2, 3, 37, K12_MARCH64, K12_MARCH}))
def test_k12_march_is_the_plain_version_bit_for_bit(n, dtype):
    a, b, c, radd = _k12_vecs(n, dtype)
    table = const_sweep_table_plain(a, b, c)
    R = _k12_rhs(n, dtype)
    want = const_sweep_strided_plain(R, a, b, c, radd)
    assert torch.equal(k12_march(R, a, radd, table), want)
    assert torch.equal(const_sweep_strided(R, a, b, c, radd, table), want)


@pytest.mark.parametrize("n", [2, 3, 7, 37, 131])
@CHUNKS
def test_k12_split_model_matches_jax_f64(chunks, n):
    a, b, c, radd = _k12_vecs(n, torch.float64)
    table = const_sweep_table_plain(a, b, c)
    assert float(table[-1]) < K12_STIFF
    got = k12_split_model(_k12_rhs(n, torch.float64), a, radd, table, chunks)
    np.testing.assert_allclose(got.numpy(), _k12_jax(n), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [2, 3, 7, 37, 131])
@CHUNKS
def test_k12_split_model_matches_plain_f32(chunks, n):
    dtype = torch.float32
    a, b, c, radd = _k12_vecs(n, dtype)
    table = const_sweep_table_plain(a, b, c)
    R = _k12_rhs(n, dtype)
    want = const_sweep_strided_plain(R, a, b, c, radd)
    _within(k12_split_model(R, a, radd, table, chunks), want, dtype)


@DTYPES
@pytest.mark.parametrize("n", [3, 131])
def test_k12_stiff_table_takes_thomas_order_bit_for_bit(n, dtype):
    """At a dt whose table passes kK12Stiff (2 fac ~ 2e5 at 2000 s) the
    model takes the Thomas order: the plain version bit for bit, at every
    run count."""
    a, b, c, radd = _k12_vecs(n, dtype, dt=2000.0)
    table = const_sweep_table_plain(a, b, c)
    assert float(table[-1]) > K12_STIFF
    R = _k12_rhs(n, dtype)
    want = const_sweep_strided_plain(R, a, b, c, radd)
    for runs in (1, 2, 16):
        assert torch.equal(k12_split_model(R, a, radd, table, runs), want)


@DTYPES
def test_k12_wrapper_on_the_cpu_with_and_without_a_table(dtype):
    """On CPU tensors K12 runs its plain version, given its table or not
    (no launch); a table of another length or dtype is refused."""
    n = 9
    a, b, c, radd = _k12_vecs(n, dtype)
    table = const_sweep_table(a, b, c)
    assert torch.equal(table, const_sweep_table_plain(a, b, c))
    R = _k12_rhs(n, dtype)
    reset_launch_counts()
    want = const_sweep_strided_plain(R, a, b, c, radd)
    assert torch.equal(const_sweep_strided(R, a, b, c, radd, table), want)
    assert torch.equal(const_sweep_strided(R, a, b, c, radd), want)
    assert all(v == 0 for v in launch_counts().values())
    for bad in (table[:-1].contiguous(), table.to(torch.float16)):
        with pytest.raises(ValueError, match="table"):
            const_sweep_strided(R, a, b, c, radd, bad)


@DTYPES
def test_k12_step_builds_its_r_table_once_per_theta_dt(dtype):
    """adi_step_cylindrical (kernels route) keeps K12's table beside the r
    rows: three BE steps at dt and three Douglas steps (theta_dt = dt/2)
    build two tables, each ``const_sweep_table_plain`` of the rows."""
    grid = CylindricalGrid(5, 6, 7, 5e-4, 5e-4, r_inner=0.02)
    rob, rin = RobinBC(300.0, 20.0), RobinBC(150.0, 30.0)
    kw = dict(dt=0.02, robin_outer=rob, robin_inner=rin,
              zbc=ZFaceBC(kind_bot="neumann0", kind_top="robin",
                          h_top=400.0), implementation="kernels")
    T = _t(20.0 + 1480.0 * np.random.default_rng(5).random(grid.shape),
           dtype)
    pcyl._r_table.cache_clear()
    for scheme in ("be", "douglas"):
        X = T
        for _ in range(3):
            X = adi_step_cylindrical(X, grid, MAT, scheme=scheme, **kw)
    info = pcyl._r_table.cache_info()
    assert (info.misses, info.hits) == (2, 4)
    for theta_dt in (0.02, 0.01):
        key = (grid, MAT, rob, rin, theta_dt, dtype, torch.device("cpu"))
        a, b, c, _ = pcyl._r_coefficients(*key)
        assert torch.equal(pcyl._r_table(*key),
                           const_sweep_table_plain(a, b, c))
    pcyl._r_table.cache_clear()
