"""The port's field-coefficient solves (K21, K22) and the routes that run
them, against the JAX package, on the CPU.

Same inputs, made from a seed with numpy, go through the JAX function and
the port's counterpart; the JAX Pallas kernels run in interpret mode.
Tolerances (float64):

* the plain versions of K21 (``tridiag_fields`` along x, y and z of the
  natural field) and K22 (``cyclic_fields`` along phi) against
  ``fused_tridiag_fields`` / ``fused_cyclic_fields`` on the moved axes:
  1e-10;
* ``adi_step_varprop(implementation="kernels")`` with Neumann flux,
  Dirichlet pins and a per-axis k tuple against the JAX pallas and xla
  steps: 1e-9 K;
* the engine, both implementations, with Neumann flux and Dirichlet pins
  (the configurations of tests/test_varprop.py:16-80, the chip check's
  Robin + Neumann + Dirichlet set with radiation, per-face h beside a
  Neumann flux) against the JAX engine: 1e-9 K;
* ``adi_step_cyl_varprop(implementation="fields")`` against the JAX
  ``implementation="pallas_fields"`` step, backward Euler and Douglas,
  annular and full disk: 1e-9 K (and bitwise equal to the port's
  reference tier on the CPU, where K21 and K22 run ``thomas`` and
  ``cyclic_thomas``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import CylindricalGrid as JCGrid
from adi_thermal_fields_tpu import Material as JMaterial
from adi_thermal_fields_tpu import RobinBC as JRobin
from adi_thermal_fields_tpu import ZFaceBC as JZ
from adi_thermal_fields_tpu.apps.engine import (
    make_cartesian_engine as j_engine)
from adi_thermal_fields_tpu.bc.packs import build_coeff_packs as j_packs
from adi_thermal_fields_tpu.solvers.pallas_fields import (
    fused_cyclic_fields, fused_tridiag_fields)
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv
from adi_thermal_fields_tpu.step import cylindrical_varprop as jcvp

from adi_thermal_fields_tpu_torch import (CartesianGrid, CylindricalGrid,
                                          Material, PropertyTable, RobinBC,
                                          ZFaceBC, adi_step_cyl_varprop,
                                          adi_step_varprop, apparent_cp,
                                          build_coeff_packs,
                                          melt_pool_enhanced_k)
from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
from adi_thermal_fields_tpu_torch.solvers import (cyclic_fields,
                                                  tridiag_fields)
from adi_thermal_fields_tpu_torch.step import cartesian_varprop as pcv
from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as pcvp

torch.set_num_threads(1)

FACES = ("x-", "x+", "y-", "y+", "z-", "z+")
RHO, CP, K = 7800.0, 490.0, 54.0
ATOL = 1e-9


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(x):
    return np.asarray(x)


def _systems(seed, shape):
    """Diagonally dominant a/b/c/d fields (the rows of an implicit
    sweep), with some identity rows."""
    rng = np.random.default_rng(seed)
    a = -rng.random(shape)
    c = -rng.random(shape)
    b = 1.0 + 2.0 * rng.random(shape) - a - c
    d = 20.0 + 1480.0 * rng.random(shape)
    ident = rng.random(shape) < 0.1
    a, c = np.where(ident, 0.0, a), np.where(ident, 0.0, c)
    b = np.where(ident, 1.0, b)
    return a, b, c, d


# ---------------------------------------------------------------------------
# K21 and K22: plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
def test_tridiag_fields_plain_matches_jax(axis):
    abcd = _systems(axis, (11, 9, 13))
    mv = (lambda x: jnp.moveaxis(jnp.asarray(x), axis, 0))
    want = jnp.moveaxis(fused_tridiag_fields(*(mv(x) for x in abcd),
                                             interpret=True), 0, axis)
    got = tridiag_fields(*(_t(x) for x in abcd), axis)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("ring0", ["coupled", "identity"])
def test_cyclic_fields_plain_matches_jax(ring0):
    """Periodic lines along axis 1 of (r, phi, z); ``identity``: ring 0
    is identity rows, as a full disk's axis ring."""
    a, b, c, d = _systems(5, (7, 10, 12))
    if ring0 == "identity":
        a[0], c[0], b[0] = 0.0, 0.0, 1.0
    mv = (lambda x: jnp.moveaxis(jnp.asarray(x), 1, 0))
    want = jnp.moveaxis(fused_cyclic_fields(mv(a), mv(b), mv(c), mv(d),
                                            interpret=True), 0, 1)
    got = cyclic_fields(_t(a), _t(b), _t(c), _t(d), 1)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


def test_field_solve_wrappers_contract():
    a, b, c, d = (_t(x) for x in _systems(6, (4, 3, 5)))
    with pytest.raises(ValueError, match=">= 2"):
        cyclic_fields(a[:, :1], b[:, :1], c[:, :1], d[:, :1], 1)
    for call in (lambda: tridiag_fields(a, b, c, d.requires_grad_(), 2),
                 lambda: cyclic_fields(a, b, c, d, 1)):
        with pytest.raises(RuntimeError, match="forward only"):
            call()


# ---------------------------------------------------------------------------
# the materialized Cartesian step on K21
# ---------------------------------------------------------------------------

def _tables():
    return (jcv.melt_pool_enhanced_k(K, 1420.0, 1470.0, enhancement=4.0),
            jcv.apparent_cp(CP, CP, 2.7e5, 1420.0, 1470.0),
            melt_pool_enhanced_k(K, 1420.0, 1470.0, enhancement=4.0),
            apparent_cp(CP, CP, 2.7e5, 1420.0, 1470.0))


def test_adi_step_varprop_kernels_matches_jax_pallas(monkeypatch):
    shape = (10, 9, 8)
    rng = np.random.default_rng(10)
    mask = rng.random(shape) > 0.2
    T = np.where(mask, 20.0 + 1580.0 * rng.random(shape), 20.0)
    dirm = np.zeros(shape, bool)
    dirm[:, :, 0] = mask[:, :, 0]
    kw = dict(robin_h=25.0, neumann={"z+": 4e5}, dirichlet_value=300.0)
    gk = dict(dy=1.3e-3, dz=0.8e-3)
    jg, pg = JGrid(*shape, 1e-3, **gk), CartesianGrid(*shape, 1e-3, **gk)
    jk, jc, pk, pc = _tables()
    jpk = j_packs(jnp.asarray(mask), jg, JMaterial(RHO, CP, K),
                  dirichlet_mask=jnp.asarray(dirm), dtype=jnp.float64, **kw)
    ppk = build_coeff_packs(torch.from_numpy(mask), pg, Material(RHO, CP, K),
                            dirichlet_mask=torch.from_numpy(dirm),
                            dtype=torch.float64, **kw)
    jk3 = (jk, 40.0, jcv.melt_pool_enhanced_k(30.0, 1420.0, 1470.0))
    pk3 = (pk, 40.0, melt_pool_enhanced_k(30.0, 1420.0, 1470.0))
    calls = []
    monkeypatch.setattr(pcv, "tridiag_fields",
                        lambda *a: calls.append(a[-1]) or tridiag_fields(*a))
    got = adi_step_varprop(_t(T), torch.from_numpy(mask), ppk, pg,
                           Material(RHO, CP, K), k_table=pk3, cp_table=pc,
                           dt=0.02, theta=1.0, t_inf=20.0,
                           implementation="kernels")
    assert calls == [0, 1, 2]           # K21 along x, y, z: no movedim
    for impl in ("pallas", "xla"):
        want = jcv.adi_step_varprop(
            jnp.asarray(T), jnp.asarray(mask), jpk, jg,
            JMaterial(RHO, CP, K), k_table=jk3, cp_table=jc, dt=0.02,
            theta=1.0, t_inf=20.0, implementation=impl)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the engine with Neumann flux and Dirichlet pins
# ---------------------------------------------------------------------------

def _engine_case(case):
    """(shape, spacing, T0, mask, steps, dt, theta, JAX kwargs, port
    kwargs) of one engine configuration."""
    if case == "constant_tables_neumann":      # tests/test_varprop.py:16
        shape = (10, 9, 8)
        rng = np.random.default_rng(0)
        mask = rng.random(shape) > 0.3
        T0 = np.where(mask, 20 + 880 * rng.random(shape), 20.0)
        pts = (0.0, 2000.0)
        jkw = dict(robin_h=250.0, neumann={"z+": 1e5},
                   k_table=jcv.PropertyTable(pts, (54.0, 54.0)),
                   cp_table=jcv.PropertyTable(pts, (490.0, 490.0)))
        pkw = dict(robin_h=250.0, neumann={"z+": 1e5},
                   k_table=PropertyTable(pts, (54.0, 54.0)),
                   cp_table=PropertyTable(pts, (490.0, 490.0)))
        return shape, {}, T0, mask, 3, 0.05, 0.5, jkw, pkw
    if case == "kirchhoff_dirichlet":          # tests/test_varprop.py:38
        shape = (48, 1, 1)
        mask = np.ones(shape, bool)
        dirm = np.zeros(shape, bool)
        dirm[0] = dirm[-1] = True
        dval = np.zeros(shape)
        dval[0], dval[-1] = 100.0, 900.0
        Tp = np.linspace(0.0, 1200.0, 25)
        kv = tuple(10.0 + 0.04 * Tp)
        common = dict(dirichlet_mask=dirm, dirichlet_value=dval)
        jkw = dict(k_table=jcv.PropertyTable(tuple(Tp), kv),
                   **{k: jnp.asarray(v) for k, v in common.items()})
        pkw = dict(k_table=PropertyTable(tuple(Tp), kv),
                   **{k: torch.from_numpy(v) for k, v in common.items()})
        return (shape, {}, np.full(shape, 500.0), mask, 12, 2.0, 1.0, jkw,
                pkw)
    # the chip check's BC set (robin 200, Neumann z+ 5e5, a Dirichlet
    # bottom plane) with radiation, or per-face h beside the flux
    shape = (9, 8, 7)
    rng = np.random.default_rng(3)
    mask = rng.random(shape) > 0.25
    mask[:, :, 0] = True
    T0 = np.where(mask, 1300.0 + 250.0 * rng.random(shape), 20.0)
    jk, jc, pk, pc = _tables()
    if case == "graft_bcs_radiation":
        dirm = np.zeros(shape, bool)
        dirm[:, :, 0] = True
        common = dict(robin_h=200.0, neumann={"z+": 5e5}, emissivity=0.5)
        jkw = dict(dirichlet_mask=jnp.asarray(dirm), dirichlet_value=1350.0,
                   k_table=jk, cp_table=jc, **common)
        pkw = dict(dirichlet_mask=torch.from_numpy(dirm),
                   dirichlet_value=1350.0, k_table=pk, cp_table=pc, **common)
    else:
        hf = {f: 20.0 + 15.0 * rng.random(shape) for f in FACES}
        jkw = dict(robin_h={f: jnp.asarray(v) for f, v in hf.items()},
                   neumann={"z+": 5e5}, k_table=jk, cp_table=jc)
        pkw = dict(robin_h=hf, neumann={"z+": 5e5}, k_table=pk, cp_table=pc)
    return shape, dict(dz=0.7e-3), T0, mask, 3, 0.02, 0.5, jkw, pkw


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("case", ["constant_tables_neumann",
                                  "kirchhoff_dirichlet",
                                  "graft_bcs_radiation",
                                  "face_h_neumann"])
def test_engine_neumann_dirichlet_matches_jax(case, impl):
    shape, sp, T0, mask, steps, dt, theta, jkw, pkw = _engine_case(case)
    pj, aj = j_engine(JGrid(*shape, 1e-3, **sp), JMaterial(RHO, CP, K),
                      implementation="xla", t_inf=20.0, theta=theta, **jkw)
    want = aj(jnp.asarray(T0), pj(jnp.asarray(mask)), jnp.asarray(dt),
              jnp.int32(steps), 0.0)
    pp, ap = make_cartesian_engine(CartesianGrid(*shape, 1e-3, **sp),
                                   Material(RHO, CP, K), implementation=impl,
                                   device="cpu", dtype=torch.float64,
                                   t_inf=20.0, theta=theta, **pkw)
    got = ap(_t(T0), pp(torch.from_numpy(mask)), dt, steps, 0.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)


def test_engine_materialized_route_runs_k21(monkeypatch):
    """With Neumann flux the kernels engine takes the materialized step and
    solves it with K21, three solves per step."""
    shape, sp, T0, mask, _, dt, theta, _, pkw = _engine_case(
        "graft_bcs_radiation")
    calls = []
    monkeypatch.setattr(pcv, "tridiag_fields",
                        lambda *a: calls.append(a[-1]) or tridiag_fields(*a))
    pp, ap = make_cartesian_engine(CartesianGrid(*shape, 1e-3, **sp),
                                   Material(RHO, CP, K),
                                   implementation="kernels", device="cpu",
                                   dtype=torch.float64, t_inf=20.0,
                                   theta=theta, **pkw)
    ap(_t(T0), pp(torch.from_numpy(mask)), dt, 2, 0.0)
    assert calls == [0, 1, 2, 0, 1, 2]


# ---------------------------------------------------------------------------
# the cylindrical fields tier
# ---------------------------------------------------------------------------

CYL = {"annular": ((6, 9, 10), 0.02, ("neumann0", "robin")),
       "disk": ((7, 8, 9), 0.0, ("dirichlet", "robin"))}


def _cyl_case(config):
    shape, r_inner, (kb, kt) = CYL[config]
    rng = np.random.default_rng(21)
    T = 1380.0 + 150.0 * rng.random(shape)
    act = rng.random(shape) > 0.3
    src = rng.random(shape) * 1e8
    geo = (*shape, 5e-4, 1e-3)
    jk, jc, pk, pc = _tables()
    zkw = dict(kind_bot=kb, kind_top=kt, h_bot=250.0, h_top=400.0,
               T_inf_bot=30.0, T_inf_top=25.0, T_bot=1400.0, T_top=90.0)
    common = dict(dt=0.05, h_void=80.0, T_inf_void=15.0, h_front=200.0,
                  emissivity=0.5)
    jargs = dict(robin_outer=JRobin(300.0, 20.0), zbc=JZ(**zkw),
                 robin_inner=JRobin(150.0, 30.0), k_table=jk, cp_table=jc,
                 active=jnp.asarray(act), source=jnp.asarray(src), **common)
    pargs = dict(robin_outer=RobinBC(300.0, 20.0), zbc=ZFaceBC(**zkw),
                 robin_inner=RobinBC(150.0, 30.0), k_table=pk, cp_table=pc,
                 active=_t(act, torch.bool), source=_t(src), **common)
    return (JCGrid(*geo, r_inner=r_inner), CylindricalGrid(*geo,
                                                           r_inner=r_inner),
            T, jargs, pargs)


@pytest.mark.parametrize("scheme", ["be", "douglas"])
@pytest.mark.parametrize("config", list(CYL))
def test_cyl_fields_tier_matches_jax_pallas_fields(config, scheme,
                                                   monkeypatch):
    jg, pg, T, jargs, pargs = _cyl_case(config)
    want = jcvp.adi_step_cyl_varprop(jnp.asarray(T), jg,
                                     JMaterial(RHO, 490.0, K), scheme=scheme,
                                     implementation="pallas_fields",
                                     interpret=True, **jargs)
    calls = []
    for name, fn in (("tridiag_fields", tridiag_fields),
                     ("cyclic_fields", cyclic_fields)):
        monkeypatch.setattr(pcvp, name,
                            lambda *a, _n=name, _f=fn:
                            calls.append((_n, a[-1])) or _f(*a))
    got = adi_step_cyl_varprop(_t(T), pg, Material(RHO, 490.0, K),
                               scheme=scheme, implementation="fields",
                               **pargs)
    assert calls == [("tridiag_fields", 0), ("cyclic_fields", 1),
                     ("tridiag_fields", 2)]
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    ref = adi_step_cyl_varprop(_t(T), pg, Material(RHO, 490.0, K),
                               scheme=scheme, implementation="reference",
                               **pargs)
    assert torch.equal(got, ref)
