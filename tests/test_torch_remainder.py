"""The last three TPU kernels' counterparts against the JAX package, on the
CPU: the v1 field-coefficient sweeps (K1's v1 entry, JAX
``fused_sweep``, ``fused_sweep_axis0`` and ``fused_sweep_axis1``) and the
Cartesian tier-2 y sweep (K15's y entry, JAX ``fused_vp2_sweep_axis1``)
with the step's ``VP2_Y_DEFAULT`` switch.

Same inputs, made from a seed with numpy, go through the JAX function and
the port's counterpart; the JAX Pallas kernels run in interpret mode, as
tests/test_pallas_sweeps.py and tests/test_vp2.py run them.  Tolerances:

* the v1 sweeps at float64: 1e-12 K, the JAX test's own
  (tests/test_pallas_sweeps.py:35);
* ``vp2_sweep_y`` at float64 against the JAX streams (``vp2_streams_xla``
  along y) solved by the JAX ``thomas``: 1e-10 K;
* ``vp2_sweep_y`` at float32 against ``fused_vp2_sweep_axis1``: 5e-3 K,
  the bound of tests/test_vp2.py (the JAX kernel multiplies by a
  reciprocal where the plain version divides; at 1500 C one float32 ulp is
  1.2e-4 K);
* the step with ``VP2_Y_DEFAULT`` on against the JAX step with its switch
  on, and against the port with the switch off: rtol 2e-5, atol 5e-3 K,
  the tolerance of tests/test_vp2.py:367-368;
* the routing: which y sweep ran, by spies on the step module's names.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import Material as JMaterial
from adi_thermal_fields_tpu.solvers import pallas_sweeps as jps
from adi_thermal_fields_tpu.solvers import pallas_vp2 as jvp2
from adi_thermal_fields_tpu.solvers.thomas import thomas as j_thomas
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

import adi_thermal_fields_tpu_torch.step.cartesian_varprop as pcv
from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          apparent_cp, build_varprop_codes,
                                          melt_pool_enhanced_k)
from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
from adi_thermal_fields_tpu_torch.convert import vp2_code_from_numpy
from adi_thermal_fields_tpu_torch.solvers import (
    KERNELS, build_vp2_code, fused_sweep, fused_sweep_axis0,
    fused_sweep_axis0_plain, fused_sweep_axis1, fused_sweep_axis1_plain,
    fused_sweep_plain, sweep_code, sweep_strided_plain, vp2_sweep_y,
    vp2_sweep_y_plain)

torch.set_num_threads(1)

RHO, CP, K = 7800.0, 490.0, 54.0
TG, DT, TINF = 0.37, 0.05, 20.0
V1_TOL = 1e-12
STEP_RTOL, STEP_ATOL = 2e-5, 5e-3


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the v1 sweeps (TPU rows 7-8)
# ---------------------------------------------------------------------------

def _v1_case(axis):
    """tests/test_pallas_sweeps.py:20's configuration: 9x11x13, random
    mask, pinned cells, a 0.3 coefficient, Neumann flux and Dirichlet
    values, all float64."""
    rng = np.random.default_rng(axis)
    shape = (9, 11, 13)
    mask = rng.random(shape) > 0.25
    dirm = rng.random(shape) > 0.9
    rhs = rng.random(shape) * 100
    coeff = np.where(rng.random(shape) > 0.5, 0.3, 0.0) * mask
    q = rng.random(shape) * mask
    dval = rng.random(shape) * 500
    return mask, dirm, rhs, coeff, q, dval


_BCS = {"pinned_no_dir_val": (False, False), "neumann": (True, False),
        "dirichlet": (False, True), "neumann_dirichlet": (True, True)}


@pytest.mark.parametrize("bcs", list(_BCS))
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fused_sweep_matches_jax_v1(axis, bcs):
    """The public v1 entry for every axis, with and without the Neumann
    and Dirichlet folds; the codes carry pinned rows in every case."""
    mask, dirm, rhs, coeff, q, dval = _v1_case(axis)
    with_q, with_d = _BCS[bcs]
    jkw = dict(qflux=jnp.asarray(q) if with_q else None,
               dir_val=jnp.asarray(dval) if with_d else None)
    pkw = dict(qflux=_t(q) if with_q else None,
               dir_val=_t(dval) if with_d else None)
    jcode = jps.sweep_code(jnp.asarray(mask), jnp.asarray(dirm), axis)
    want = jps.fused_sweep(jnp.asarray(rhs), jcode, jnp.asarray(coeff), TG,
                           DT, TINF, axis, interpret=True, **jkw)
    code = sweep_code(torch.from_numpy(mask), torch.from_numpy(dirm), axis)
    assert torch.equal(code,
                       torch.from_numpy(_np(jcode).view(np.uint8).copy()))
    got = fused_sweep(_t(rhs), code, _t(coeff), TG, DT, TINF, axis, **pkw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=V1_TOL,
                               atol=V1_TOL)
    plain = fused_sweep_plain(_t(rhs), code, _t(coeff), TG, DT, TINF, axis,
                              **pkw)
    assert torch.equal(plain, got)


def test_v1_pin_rule_differs_from_k1():
    """Without dir_val a v1 pinned row is an identity row that keeps its
    coefficient's d term; K1's main entry (the v2 rule) couples it as a
    free row, far from JAX's v1 answer.  Axis 0 in the (n, B1, B2) form."""
    mask, dirm, rhs, coeff, _, _ = _v1_case(0)
    jcode = jps.sweep_code(jnp.asarray(mask), jnp.asarray(dirm), 0)
    want = _np(jps.fused_sweep_axis0(jnp.asarray(rhs), jcode,
                                     jnp.asarray(coeff), TG, DT, TINF,
                                     interpret=True))
    code = sweep_code(torch.from_numpy(mask), torch.from_numpy(dirm), 0)
    got = fused_sweep_axis0(_t(rhs), code, _t(coeff), TG, DT, TINF)
    np.testing.assert_allclose(got.numpy(), want, rtol=V1_TOL, atol=V1_TOL)
    v2 = sweep_strided_plain(_t(rhs), code, TG, DT, TINF, axis=0,
                             coeff=_t(coeff))
    assert float(np.abs(v2.numpy() - want).max()) > 1.0


@pytest.mark.parametrize("with_bcs", [False, True],
                         ids=["pinned_no_dir_val", "neumann_dirichlet"])
def test_fused_sweep_axis1_matches_jax_at_n11(with_bcs):
    """The axis-1 form on (B1, n, B2) = (5, 11, 7): JAX pads n to 16 with
    identity rows, K1 solves the 11 rows as they are."""
    rng = np.random.default_rng(11)
    shape = (5, 11, 7)
    mask = rng.random(shape) > 0.2
    dirm = rng.random(shape) > 0.85
    rhs = rng.random(shape) * 100
    coeff = 0.3 * mask * (rng.random(shape) > 0.3)
    q = rng.random(shape) * mask
    dval = 400.0 + 100.0 * rng.random(shape)
    jcode = jnp.moveaxis(jps.sweep_code(jnp.asarray(mask),
                                        jnp.asarray(dirm), 1), 0, 1)
    jkw = (dict(qflux=jnp.asarray(q), dir_val=jnp.asarray(dval)) if with_bcs
           else {})
    pkw = dict(qflux=_t(q), dir_val=_t(dval)) if with_bcs else {}
    want = jps.fused_sweep_axis1(jnp.asarray(rhs), jcode, jnp.asarray(coeff),
                                 TG, DT, TINF, interpret=True, **jkw)
    code = torch.from_numpy(_np(jcode).view(np.uint8).copy())
    got = fused_sweep_axis1(_t(rhs), code, _t(coeff), TG, DT, TINF, **pkw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=V1_TOL,
                               atol=V1_TOL)
    assert torch.equal(got, fused_sweep_axis1_plain(
        _t(rhs), code, _t(coeff), TG, DT, TINF, **pkw))


def test_v1_sweeps_at_float32_match_jax():
    """float32 fields: the v1 entry against JAX at float32 (a few ulp of
    the 500 K scale: JAX folds in an XLA pass, the port in the rows)."""
    mask, dirm, rhs, coeff, q, dval = _v1_case(2)
    f32 = (lambda a: np.asarray(a, np.float32))
    jcode = jps.sweep_code(jnp.asarray(mask), jnp.asarray(dirm), 2)
    want = jps.fused_sweep(jnp.asarray(f32(rhs)), jcode,
                           jnp.asarray(f32(coeff)), TG, DT, TINF, 2,
                           qflux=jnp.asarray(f32(q)),
                           dir_val=jnp.asarray(f32(dval)), interpret=True)
    code = sweep_code(torch.from_numpy(mask), torch.from_numpy(dirm), 2)
    got = fused_sweep(_t(rhs, torch.float32), code, _t(coeff, torch.float32),
                      TG, DT, TINF, 2, qflux=_t(q, torch.float32),
                      dir_val=_t(dval, torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=8 * 2 ** -23 * 500.0)


def test_v1_wrappers_contract():
    mask, dirm, rhs, coeff, _, _ = _v1_case(1)
    code = sweep_code(torch.from_numpy(mask), torch.from_numpy(dirm), 0)
    with pytest.raises(ValueError, match="axis"):
        fused_sweep(_t(rhs), code, _t(coeff), TG, DT, TINF, 3)
    with pytest.raises(RuntimeError, match="forward only"):
        fused_sweep_axis0(_t(rhs).requires_grad_(), code, _t(coeff), TG, DT,
                          TINF)
    assert fused_sweep_axis0_plain(_t(rhs), code, _t(coeff), TG, DT,
                                   TINF).shape == rhs.shape
    # the v1 entry and K15's y entry are counted apart
    assert "K1v1" in KERNELS and "K15y" in KERNELS


# ---------------------------------------------------------------------------
# the tier-2 y sweep (TPU row 23)
# ---------------------------------------------------------------------------

def _tables():
    return (jcv.melt_pool_enhanced_k(K, 1420.0, 1470.0, enhancement=4.0),
            jcv.apparent_cp(CP, 520.0, 2.7e5, 1420.0, 1470.0),
            melt_pool_enhanced_k(K, 1420.0, 1470.0, 4.0),
            apparent_cp(CP, 520.0, 2.7e5, 1420.0, 1470.0))


def _spec(tab):
    return (tuple(tab.points), tuple(tab.values))


def _y_case(seed=31, shape=(24, 40, 16)):
    """tests/test_vp2.py:339's mask (a slab and a bead along y) and a
    field through the mushy interval."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    m[:, :28, :] = True
    m[:12, 28:34, :8] = True
    T = np.where(m, 1500.0, 20.0) + 40.0 * rng.random(shape)
    T.reshape(-1)[::9] = 1420.0
    rhs = T + 20.0 * rng.random(shape) * m
    return m, T, rhs


def _y_scalars(f):
    dy, theta, dt = 1.3e-3, 0.5, 0.05
    dtor = f(f(dt) / f(RHO))
    return (float(f(theta / dy ** 2)), float(f(1.0 / dy)), dtor,
            float(f(1.0) / dtor))


_FILMS = {"scalar": (0.0, 150.0), "radiative": (0.5, 30.0)}


@pytest.mark.parametrize("film", list(_FILMS))
def test_vp2_sweep_y_plain_matches_jax_streams_thomas(film):
    eps, h = _FILMS[film]
    m, T, rhs = _y_case(33)
    jk, jc, pk, pc = _tables()
    glo, gs, dtor, inv_dtor = _y_scalars(np.float64)
    yl = (lambda a: jnp.moveaxis(jnp.asarray(a), 1, 0))
    jcode = yl(jvp2.build_vp2_code(jnp.asarray(m), 1, edge_exposed=True))
    col = jnp.full((m.shape[1],), gs)
    fhi, dw, sink, srhs = jvp2.vp2_streams_xla(
        yl(T), jcode, col, col, dtor, k_spec=_spec(jk), cp_spec=_spec(jc),
        h_lo=h, h_hi=h, tinf_void=TINF, emissivity=eps)
    al = glo * jnp.concatenate([jnp.zeros_like(fhi[:1]), fhi[:-1]], axis=0)
    ch = glo * fhi
    coup = al + ch + sink
    w_r = jnp.where(coup > 0.0, 1.0 / dw, 1.0)
    want = jnp.moveaxis(j_thomas(-al, w_r + coup, -ch, yl(rhs) * w_r + srhs),
                        0, 1)
    code = build_vp2_code(torch.from_numpy(m), 1, edge_exposed=True)
    got = vp2_sweep_y(_t(rhs), _t(T), code, glo, gs, inv_dtor, k_spec=pk,
                      cp_spec=pc, h=h, t_inf=TINF, emissivity=eps)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("film", list(_FILMS))
def test_vp2_sweep_y_matches_jax_kernel_f32(film):
    """(24, 40, 16) float32, the same state through JAX
    ``fused_vp2_sweep_axis1`` (interpret mode) and the port; 5e-3 K."""
    eps, h = _FILMS[film]
    m, T, rhs = _y_case()
    jk, jc, pk, pc = _tables()
    glo, gs, dtor, inv_dtor = _y_scalars(np.float32)
    dy = 1.3e-3
    want = jvp2.fused_vp2_sweep_axis1(
        jnp.asarray(rhs, jnp.float32), jnp.asarray(T, jnp.float32),
        jvp2.build_vp2_code(jnp.asarray(m), 1, edge_exposed=True),
        jnp.float32(dtor), k_spec=_spec(jk), cp_spec=_spec(jc),
        glo=0.5 / dy ** 2, ghi=0.5 / dy ** 2, gs_lo=1.0 / dy,
        gs_hi=1.0 / dy, h_lo=h, h_hi=h, tinf_void=TINF, emissivity=eps,
        interpret=True)
    code = build_vp2_code(torch.from_numpy(m), 1, edge_exposed=True)
    args = (_t(rhs, torch.float32), _t(T, torch.float32), code, glo, gs,
            inv_dtor)
    kw = dict(k_spec=pk, cp_spec=pc, h=h, t_inf=TINF, emissivity=eps)
    got = vp2_sweep_y(*args, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=5e-3)
    assert torch.equal(got, vp2_sweep_y_plain(*args, **kw))


def test_varprop_codes_carry_the_vp2_y_code(monkeypatch):
    """The vp2 y code is built with the other codes while the switch is
    on, and not at all while it is off."""
    m, _, _ = _y_case()
    want = vp2_code_from_numpy(
        _np(jvp2.build_vp2_code(jnp.asarray(m), 1, edge_exposed=True)),
        device="cpu")
    for flag in (True, False):
        monkeypatch.setattr(pcv, "VP2_Y_DEFAULT", flag)
        codes = build_varprop_codes(torch.from_numpy(m))
        assert len(codes) == 5
        if flag:
            assert torch.equal(codes[4], want)
        else:
            assert codes[4] is None


def test_step_builds_a_missing_vp2_y_code(monkeypatch):
    """Codes built with the switch off reach K15's y entry once it is on:
    the step builds the vp2 y code itself, and the result equals the step
    with the code built beforehand."""
    m, T, _ = _y_case(shape=(10, 14, 8))
    _, _, pk, pc = _tables()
    pmask = torch.from_numpy(m)
    monkeypatch.setattr(pcv, "VP2_Y_DEFAULT", False)
    late = build_varprop_codes(pmask)
    monkeypatch.setattr(pcv, "VP2_Y_DEFAULT", True)
    early = build_varprop_codes(pmask)
    args = (_t(T, torch.float32), pmask)
    rest = (CartesianGrid(*m.shape, 1e-3), Material(RHO, CP, K))
    kw = dict(k_table=pk, cp_table=pc, **_step_kw(True))
    calls = []
    _spy(monkeypatch, "vp2_sweep_y", calls)
    got = pcv.adi_step_varprop_fused(*args, late, *rest, **kw)
    want = pcv.adi_step_varprop_fused(*args, early, *rest, **kw)
    assert calls == ["vp2_sweep_y"] * 2
    assert torch.equal(got, want)


def _step_kw(rad):
    return dict(dt=0.05, theta=0.5, t_inf=TINF,
                robin_h=0.0 if rad else 150.0,
                emissivity=0.5 if rad else None,
                h_conv=30.0 if rad else 0.0)


@pytest.mark.parametrize("rad", [False, True], ids=["scalar", "radiative"])
def test_step_with_vp2_y_matches_jax(rad, monkeypatch):
    """``adi_step_varprop_fused`` with ``VP2_Y_DEFAULT`` on, float32, on
    tests/test_vp2.py:339's case: against the JAX step with its switch on
    and against the port with the switch off."""
    m, T, _ = _y_case()
    jk, jc, pk, pc = _tables()
    shape = m.shape
    jg, pg = JGrid(*shape, 1e-3), CartesianGrid(*shape, 1e-3)
    jm, pmask = jnp.asarray(m), torch.from_numpy(m)
    kw = _step_kw(rad)
    monkeypatch.setattr(jcv, "VP2_Y_DEFAULT", True)
    want = _np(jcv.adi_step_varprop_fused(
        jnp.asarray(T, jnp.float32), jm, jcv.build_varprop_codes(jm), jg,
        JMaterial(RHO, CP, K), k_table=jk, cp_table=jc, interpret=True,
        **kw))
    res = {}
    for flag in (True, False):
        monkeypatch.setattr(pcv, "VP2_Y_DEFAULT", flag)
        res[flag] = pcv.adi_step_varprop_fused(
            _t(T, torch.float32), pmask, build_varprop_codes(pmask), pg,
            Material(RHO, CP, K), k_table=pk, cp_table=pc, **kw).numpy()
    np.testing.assert_allclose(res[True], want, rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    np.testing.assert_allclose(res[True], res[False], rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    assert not np.array_equal(res[True], res[False])


def _spy(monkeypatch, name, calls):
    real = getattr(pcv, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(pcv, name, spy)


_ROUTES = {
    # route: (y sweep the switch-on step runs, or None: not the classic y)
    "float32": "vp2_sweep_y",
    "float64": "varprop_sweep_y",
    "bfloat16": None,
    "h_axes": "varprop_sweep_y",
    "h_field": "varprop_sweep_y",
    "callable_k": "varprop_sweep_y",
}


@pytest.mark.parametrize("route", list(_ROUTES))
def test_vp2_y_routing(route, monkeypatch):
    """With the switch on, only the tier-2 gate's states take K15's y
    entry: a float64 state, film streams or fields and callables stay on
    K7, and a bfloat16 state takes the g-stream tier (no classic y)."""
    m, T, _ = _y_case(shape=(10, 14, 8))
    _, _, pk, pc = _tables()
    pmask = torch.from_numpy(m)
    dtype = {"float64": torch.float64,
             "bfloat16": torch.bfloat16}.get(route, torch.float32)
    kw = dict(k_table=pk, cp_table=pc, **_step_kw(False))
    if route == "h_axes":
        kw["h_axes"] = pcv.build_face_h_axes(pmask, 150.0, dtype=dtype)
    elif route == "h_field":
        kw["h_field"] = torch.full(m.shape, 150.0, dtype=dtype)
    elif route == "callable_k":
        kw["k_table"] = (lambda t: 30.0 + 0.01 * t)
    args = (_t(T, dtype), pmask, build_varprop_codes(pmask),
            CartesianGrid(*m.shape, 1e-3), Material(RHO, CP, K))
    res = {}
    for flag in (False, True):
        calls = []
        monkeypatch.setattr(pcv, "VP2_Y_DEFAULT", flag)
        for name in ("vp2_sweep_y", "varprop_sweep_y"):
            _spy(monkeypatch, name, calls)
        res[flag] = pcv.adi_step_varprop_fused(*args, **kw)
        want = (_ROUTES[route] if flag else
                None if route == "bfloat16" else "varprop_sweep_y")
        assert calls == ([] if want is None else [want])
        monkeypatch.undo()
    if _ROUTES[route] != "vp2_sweep_y":
        assert torch.equal(res[True], res[False])


def test_engine_reaches_vp2_y(monkeypatch):
    """The varprop engine (the WAAM app's step) takes K15's y entry on
    every sub-step when the switch is on, with no flag of its own, and
    stays within the step tolerance of the switch-off engine."""
    m, T, _ = _y_case(shape=(12, 20, 10))
    _, _, pk, pc = _tables()
    grid = CartesianGrid(*m.shape, 1e-3)
    mat = Material(RHO, CP, K)
    res, calls = {}, []
    for flag in (False, True):
        monkeypatch.setattr(pcv, "VP2_Y_DEFAULT", flag)
        _spy(monkeypatch, "vp2_sweep_y", calls)
        prep, adv = make_cartesian_engine(
            grid, mat, implementation="kernels", device="cpu",
            dtype=torch.float32, robin_h=15.0, t_inf=TINF, emissivity=0.5,
            k_table=pk, cp_table=pc)
        res[flag] = adv(_t(T, torch.float32), prep(torch.from_numpy(m)),
                        0.02, 4, 0.0).numpy()
        monkeypatch.undo()
    assert calls == ["vp2_sweep_y"] * 4
    np.testing.assert_allclose(res[True], res[False], rtol=STEP_RTOL,
                               atol=STEP_ATOL)
