"""The port's variable-property slice against the JAX package, on the CPU.

Same inputs, made from a seed with numpy, go through the JAX function and
the port's counterpart.  The JAX Pallas kernels run in interpret mode, as
tests/test_varprop.py runs them.  Tolerances (absolute, K for fields):

* tables, ``radiative_h``, the fields pass and the vp2 streams at float64:
  1e-12 (relative to each output's scale for the fields);
* the fields pass against the JAX Pallas kernel at float32: 4 float32 ulp
  of each output's scale — that kernel computes at float32 whatever its
  input dtype, so the comparison runs there;
* the K6/K7/K8 plain versions at float64: 1e-10;
* K8's plain version against ``fused_vp2_sweep(nat_rhs_out=True)`` at
  float32: 5e-3 K (the bound of tests/test_vp2.py);
* the fused step (K5-K7 and K19 plain versions: float64 z runs the
  stream-reading sweep in both) against JAX ``adi_step_varprop_fused`` and
  ``adi_step_varprop(xla)`` at float64: 1e-9 K;
* the engine over 4 sub-steps with a moving source: rtol 1e-10, atol
  1e-9; the WAAM app's varprop flags against the JAX app: 1e-9 K.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import Material as JMaterial
from adi_thermal_fields_tpu.apps import waam_from_stl as jax_app
from adi_thermal_fields_tpu.apps.engine import (
    make_cartesian_engine as j_engine)
from adi_thermal_fields_tpu.bc.packs import build_coeff_packs as j_packs
from adi_thermal_fields_tpu.bc.radiation import radiative_h as j_radiative_h
from adi_thermal_fields_tpu.solvers import pallas_varprop as jpv
from adi_thermal_fields_tpu.solvers import pallas_vp2 as jvp2
from adi_thermal_fields_tpu.solvers.pallas_sweeps import (
    sweep_code as j_sweep_code)
from adi_thermal_fields_tpu.solvers.thomas import thomas as j_thomas
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          PropertyTable, adi_step_varprop,
                                          adi_step_varprop_fused,
                                          apparent_cp, build_coeff_packs,
                                          build_varprop_codes,
                                          melt_pool_enhanced_k, radiative_h)
from adi_thermal_fields_tpu_torch.apps import waam_from_stl as port_app
from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
from adi_thermal_fields_tpu_torch.convert import (property_table_from_jax,
                                                  vp2_code_from_numpy)
from adi_thermal_fields_tpu_torch.geometry.primitives import box_mesh
from adi_thermal_fields_tpu_torch.geometry.stl import save_stl_binary
from adi_thermal_fields_tpu_torch.solvers import (
    build_vp2_code, sweep_code, varprop_fields, varprop_fields_plain,
    varprop_sweep_y, varprop_theta_sweep, vp2_sweep_z, vp2_sweep_z_plain)
from adi_thermal_fields_tpu_torch.solvers.vp2 import vp2_streams

torch.set_num_threads(1)

RHO, CP, K = 7800.0, 490.0, 54.0
SHAPE = (24, 20, 16)
K_ARGS = (K, 1420.0, 1470.0)
CP_ARGS = (CP, CP, 2.7e5, 1420.0, 1470.0)


def _tables():
    """(JAX k, JAX cp, port k, port cp): melt-pool k x4 and apparent cp."""
    return (jcv.melt_pool_enhanced_k(*K_ARGS, enhancement=4.0),
            jcv.apparent_cp(*CP_ARGS),
            melt_pool_enhanced_k(*K_ARGS, enhancement=4.0),
            apparent_cp(*CP_ARGS))


def _spec(tab):
    return (tuple(tab.points), tuple(tab.values))


def _case(seed, shape=SHAPE, frac=0.8):
    """Random mask and a field over 20-1600 C through the mushy interval,
    with cells exactly at the solidus, the liquidus and inside."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < frac
    T = np.where(mask, 20.0 + 1580.0 * rng.random(shape), 20.0)
    flat = T.reshape(-1)
    flat[::7] = 1420.0
    flat[3::11] = 1470.0
    flat[5::13] = 1445.0
    return rng, mask, T


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# tables, radiation, conversion
# ---------------------------------------------------------------------------

def test_property_tables_match_jax():
    rng = np.random.default_rng(0)
    T = rng.random(4000) * 2200.0 - 100.0
    T[:4] = (1420.0, 1470.0, 1420.0 - 1e-9, 1470.0 + 1e-9)
    jk, jc, pk, pc = _tables()
    pts = tuple(np.linspace(0, 2000, 17))
    vals = tuple(rng.random(17) * 100 + 10)
    pairs = [(jk, pk), (jc, pc),
             (jcv.PropertyTable(pts, vals), PropertyTable(pts, vals)),
             (jcv.PropertyTable((0.0, 500.0, 500.0, 900.0),
                                (10.0, 20.0, 35.0, 35.0)),
              PropertyTable((0.0, 500.0, 500.0, 900.0),
                            (10.0, 20.0, 35.0, 35.0)))]
    for jt, pt in pairs:
        assert tuple(pt.points) == tuple(jt.points)
        assert tuple(pt.values) == tuple(jt.values)
        np.testing.assert_allclose(pt(_t(T)).numpy(), _np(jt(jnp.asarray(T))),
                                   rtol=0, atol=1e-12 * max(vals + (6000,)))
        # float32: the same operations in the same order
        got32 = pt(_t(T, torch.float32)).numpy()
        want32 = _np(jt(jnp.asarray(T, jnp.float32)))
        np.testing.assert_allclose(got32, want32, rtol=2e-7, atol=0)


def test_radiative_h_matches_jax():
    _, mask, T = _case(1)
    got = radiative_h(_t(T), 0.45, 20.0, h_conv=30.0)
    want = j_radiative_h(jnp.asarray(T), 0.45, 20.0, h_conv=30.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-14, atol=0)
    got = radiative_h(_t(T), 0.8, 300.0, celsius=False)
    want = j_radiative_h(jnp.asarray(T), 0.8, 300.0, celsius=False)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-14, atol=0)


def test_convert_property_table_and_vp2_code_round_trip():
    jk, jc, pk, pc = _tables()
    assert property_table_from_jax(jk) == pk
    assert property_table_from_jax(jc) == pc
    _, mask, _ = _case(2)
    for axis in range(3):
        for edge in (False, True):
            jcode = _np(jvp2.build_vp2_code(jnp.asarray(mask), axis,
                                            edge_exposed=edge))
            got = vp2_code_from_numpy(jcode, device="cpu")
            want = build_vp2_code(torch.from_numpy(mask), axis,
                                  edge_exposed=edge)
            assert got.dtype == torch.uint8
            assert torch.equal(got, want)
    # the JAX Cartesian step's z code layout, (z, x, y)
    jz = _np(jnp.moveaxis(jvp2.build_vp2_code(jnp.asarray(mask), 2,
                                              edge_exposed=True), 2, 0))
    assert torch.equal(vp2_code_from_numpy(jz, device="cpu", zxy=True),
                       build_varprop_codes(torch.from_numpy(mask))[2])


# ---------------------------------------------------------------------------
# K5: the fields pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rad", [None, (0.5, 20.0, 30.0)],
                         ids=["no_rad", "rad"])
def test_varprop_fields_plain_matches_jax_xla(rad):
    _, mask, T = _case(3)
    jk, jc, pk, pc = _tables()
    jmat = JMaterial(RHO, CP, K)
    want = jcv.build_varprop_fields(jnp.asarray(T), jnp.asarray(mask), jmat,
                                    jk, jc, rad=rad)
    got = varprop_fields(_t(T), torch.from_numpy(mask).to(torch.uint8),
                         k_spec=pk, cp_spec=pc, rho=RHO, rad=rad)
    for a, b in zip(got[0] + got[1:], want[0] + tuple(want[1:])):
        scale = float(np.abs(_np(b)).max())
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0,
                                   atol=1e-12 * scale)
    # constants as specs: the JAX defaults from the material
    want = jcv.build_varprop_fields(jnp.asarray(T), jnp.asarray(mask), jmat)
    got = varprop_fields(_t(T), torch.from_numpy(mask).to(torch.uint8),
                         k_spec=K, cp_spec=CP, rho=RHO)
    for a, b in zip(got[0] + (got[1],), want[0] + (want[1],)):
        np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("rad", [None, (0.5, 20.0, 30.0)],
                         ids=["no_rad", "rad"])
def test_varprop_fields_plain_matches_jax_kernel_f32(rad):
    _, mask, T = _case(4)
    jk, jc, pk, pc = _tables()
    want = jpv.varprop_fields(jnp.asarray(T, jnp.float32),
                              jnp.asarray(mask, jnp.int8), k_spec=_spec(jk),
                              cp_spec=_spec(jc), rho=RHO, rad=rad,
                              interpret=True)
    got = varprop_fields_plain(_t(T, torch.float32),
                               torch.from_numpy(mask).to(torch.uint8),
                               k_spec=pk, cp_spec=pc, rho=RHO, rad=rad)
    for a, b in zip(got[0] + got[1:], want[0] + tuple(want[1:])):
        scale = float(np.abs(_np(b)).max())
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0,
                                   atol=4 * 2**-23 * scale)


# ---------------------------------------------------------------------------
# K6 and K7: the sweeps that read the face streams
# ---------------------------------------------------------------------------

def _stream_case(seed):
    rng, mask, T = _case(seed)
    shape = mask.shape
    kf = rng.random(shape) * 40 + 10
    jm = jnp.asarray(mask)
    fcs = [_np(jcv._face_g(jnp.asarray(kf), ax, -1, jm)) for ax in range(3)]
    w = rng.random(shape) * 1e-7 + 2e-7
    h = rng.random(shape) * 40 + 5
    src = rng.random(shape) * 1e6
    return mask, T, fcs, w, h, src


@pytest.mark.parametrize("film", ["h_stream", "rob_c_src"])
def test_varprop_theta_sweep_plain_matches_jax(film):
    mask, T, (fx, fy, fz), w, h, src = _stream_case(5)
    dt, theta, t_inf = 0.02, 0.5, 20.0
    inv_d2 = [1e6, 0.25e6, 1.0 / 9e-6]
    cw, tg, sk = (1 - theta) * dt, theta * dt * inv_d2[0], dt / 1e-3
    kw = (dict(h=h) if film == "h_stream" else dict(src=src, dt=dt))
    want = jpv.fused_varprop_theta_sweep(
        jnp.asarray(T), j_sweep_code(jnp.asarray(mask), None, 0),
        *(jnp.asarray(a) for a in (fx, fy, fz, w)), cw, inv_d2, tg, sk,
        t_inf, rob_c=15.0, interpret=True,
        **{k: (jnp.asarray(v) if k != "dt" else v) for k, v in kw.items()})
    got = varprop_theta_sweep(
        _t(T), sweep_code(torch.from_numpy(mask), None, 0),
        *(_t(a) for a in (fx, fy, fz, w)), cw, inv_d2, tg, sk, t_inf,
        rob_c=15.0, **{k: (_t(v) if k != "dt" else v)
                       for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("film", ["h_stream", "rob_c"])
def test_varprop_sweep_y_plain_matches_jax(film):
    mask, T, (_, fy, _), w, h, _ = _stream_case(6)
    tg, sk, t_inf = 0.37, 0.01, 20.0
    jcode = jnp.moveaxis(j_sweep_code(jnp.asarray(mask), None, 1), 0, 1)
    want = jpv.fused_varprop_sweep_axis1(
        jnp.asarray(T), jcode, jnp.asarray(fy), jnp.asarray(w), tg, sk,
        t_inf, h=jnp.asarray(h) if film == "h_stream" else None,
        rob_c=15.0, interpret=True)
    code = sweep_code(torch.from_numpy(mask), None, 1).movedim(0, 1)
    got = varprop_sweep_y(_t(T), code.contiguous(), _t(fy), _t(w), tg, sk,
                          t_inf, h=_t(h) if film == "h_stream" else None,
                          rob_c=15.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# K8: the tier-2 z sweep
# ---------------------------------------------------------------------------

def _vp2_inputs(seed, dtype):
    rng, mask, T = _case(seed)
    rhs = np.where(mask, 20.0 + 1580.0 * rng.random(mask.shape), 20.0)
    dt, theta, dz = 0.05, 0.5, 0.8e-3
    f = np.float32 if dtype == torch.float32 else np.float64
    glo = float(f(theta / dz ** 2))
    gs = float(f(1.0 / dz))
    dtor = f(f(dt) / f(RHO))
    return mask, T, rhs, glo, gs, dtor, float(f(1.0) / dtor)


@pytest.mark.parametrize("eps,h", [(0.0, 30.0), (0.5, 15.0)],
                         ids=["conv", "rad"])
def test_vp2_sweep_z_plain_matches_jax_streams_thomas(eps, h):
    mask, T, rhs, glo, gs, dtor, inv_dtor = _vp2_inputs(7, torch.float64)
    jk, jc, pk, pc = _tables()
    t_inf = 20.0
    zl = (lambda a: jnp.moveaxis(jnp.asarray(a), 2, 0))
    jcode = jnp.moveaxis(jvp2.build_vp2_code(jnp.asarray(mask), 2,
                                             edge_exposed=True), 2, 0)
    col = jnp.full((mask.shape[2],), gs)
    fhi, dw, sink, srhs = jvp2.vp2_streams_xla(
        zl(T), jcode, col, col, dtor, k_spec=_spec(jk), cp_spec=_spec(jc),
        h_lo=h, h_hi=h, tinf_void=t_inf, emissivity=eps)
    code = build_vp2_code(torch.from_numpy(mask), 2, edge_exposed=True)
    streams = vp2_streams(_t(T), code, gs, dtor, k_spec=pk, cp_spec=pc,
                          h=h, tinf=t_inf, emissivity=eps)
    for a, b in zip(streams, (fhi, dw, sink, srhs)):
        b = _np(jnp.moveaxis(b, 0, 2))
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(b).max()))
    # the scaled rows of pallas_vp2.py:335-349, solved by the JAX thomas
    al = glo * jnp.concatenate([jnp.zeros_like(fhi[:1]), fhi[:-1]], axis=0)
    ch = glo * fhi
    coup = al + ch + sink
    w_r = jnp.where(coup > 0.0, 1.0 / dw, 1.0)
    want = j_thomas(-al, w_r + coup, -ch, zl(rhs) * w_r + srhs)
    got = vp2_sweep_z(_t(rhs), _t(T), code, glo, gs, inv_dtor, k_spec=pk,
                      cp_spec=pc, h=h, t_inf=t_inf, emissivity=eps)
    np.testing.assert_allclose(got.numpy(), _np(jnp.moveaxis(want, 0, 2)),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("eps,h", [(0.0, 30.0), (0.5, 15.0)],
                         ids=["conv", "rad"])
def test_vp2_sweep_z_plain_matches_jax_kernel_f32(eps, h):
    mask, T, rhs, glo, gs, dtor, inv_dtor = _vp2_inputs(8, torch.float32)
    jk, jc, pk, pc = _tables()
    nz = mask.shape[2]
    jcode = jnp.moveaxis(jvp2.build_vp2_code(jnp.asarray(mask), 2,
                                             edge_exposed=True), 2, 0)
    g = jnp.full((nz,), glo, jnp.float32)
    s = jnp.full((nz,), gs, jnp.float32)
    want = jvp2.fused_vp2_sweep(
        jnp.asarray(rhs, jnp.float32), jnp.asarray(T, jnp.float32), jcode,
        g, g, s, s, jnp.float32(dtor), k_spec=_spec(jk), cp_spec=_spec(jc),
        h_lo=h, h_hi=h, tinf_void=20.0, emissivity=eps, nat_rhs_out=True,
        interpret=True)
    code = build_vp2_code(torch.from_numpy(mask), 2, edge_exposed=True)
    got = vp2_sweep_z_plain(_t(rhs, torch.float32), _t(T, torch.float32),
                            code, glo, gs, inv_dtor, k_spec=pk, cp_spec=pc,
                            h=h, t_inf=20.0, emissivity=eps)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=5e-3)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _grids(shape=SHAPE):
    kw = dict(dy=1.3e-3, dz=0.8e-3)
    return JGrid(*shape, 1e-3, **kw), CartesianGrid(*shape, 1e-3, **kw)


@pytest.mark.parametrize("film", ["scalar_h_source", "radiation"])
def test_adi_step_varprop_fused_matches_jax(film):
    rng, mask, T = _case(9, frac=0.85)
    src = rng.random(mask.shape) * 1e6
    jg, pg = _grids()
    jmat, pmat = JMaterial(RHO, CP, K), Material(RHO, CP, K)
    jk, jc, pk, pc = _tables()
    dt, h, jm = 0.01, 35.0, jnp.asarray(mask)
    if film == "radiation":
        jkw = dict(emissivity=0.5, h_conv=15.0)
        pkw = dict(emissivity=0.5, h_conv=15.0)
        hf = j_radiative_h(jnp.asarray(T), 0.5, 20.0, h_conv=15.0)
        jpk = j_packs(jm, jg, jmat, robin_h=hf, dtype=jnp.float64)
    else:
        jkw = dict(robin_h=h, source=jnp.asarray(src))
        pkw = dict(robin_h=h, source=_t(src))
        jpk = j_packs(jm, jg, jmat, robin_h=h, dtype=jnp.float64)
    got = adi_step_varprop_fused(
        _t(T), torch.from_numpy(mask), build_varprop_codes(
            torch.from_numpy(mask)), pg, pmat, k_table=pk, cp_table=pc,
        dt=dt, theta=0.5, t_inf=20.0, **pkw)
    want_fused = jcv.adi_step_varprop_fused(
        jnp.asarray(T), jm, jcv.build_varprop_codes(jm), jg, jmat,
        k_table=jk, cp_table=jc, dt=dt, theta=0.5, t_inf=20.0,
        interpret=True, **jkw)
    want_xla = jcv.adi_step_varprop(
        jnp.asarray(T), jm, jpk, jg, jmat, k_table=jk, cp_table=jc, dt=dt,
        theta=0.5, t_inf=20.0, implementation="xla",
        source=jkw.get("source"))
    for want in (want_fused, want_xla):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=1e-9)


def test_adi_step_varprop_reference_matches_jax_xla():
    """The plain reference step, with a per-axis k tuple and Dirichlet
    pins, which only the reference takes."""
    rng, mask, T = _case(10)
    jg, pg = _grids()
    jmat, pmat = JMaterial(RHO, CP, K), Material(RHO, CP, K)
    jk, jc, pk, pc = _tables()
    dirm = np.zeros(mask.shape, bool)
    dirm[:, :, 0] = mask[:, :, 0]
    jpk = j_packs(jnp.asarray(mask), jg, jmat, robin_h=25.0,
                  neumann={"z+": 4e5}, dirichlet_mask=jnp.asarray(dirm),
                  dirichlet_value=300.0, dtype=jnp.float64)
    ppk = build_coeff_packs(torch.from_numpy(mask), pg, pmat,
                            dtype=torch.float64, robin_h=25.0,
                            neumann={"z+": 4e5},
                            dirichlet_mask=torch.from_numpy(dirm),
                            dirichlet_value=300.0)
    want = jcv.adi_step_varprop(
        jnp.asarray(T), jnp.asarray(mask), jpk, jg, jmat,
        k_table=(jk, 40.0, jcv.melt_pool_enhanced_k(30.0, 1420.0, 1470.0)),
        cp_table=jc, dt=0.02, theta=1.0, t_inf=20.0, implementation="xla")
    got = adi_step_varprop(
        _t(T), torch.from_numpy(mask), ppk, pg, pmat,
        k_table=(pk, 40.0, melt_pool_enhanced_k(30.0, 1420.0, 1470.0)),
        cp_table=pc, dt=0.02, theta=1.0, t_inf=20.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-9)


@pytest.mark.parametrize("impl,jimpl", [("kernels", "pallas"),
                                        ("reference", "xla")])
def test_engine_varprop_matches_jax_engine(impl, jimpl):
    shape = (12, 10, 8)
    jg = JGrid(*shape, 1e-3, dz=0.7e-3)
    pg = CartesianGrid(*shape, 1e-3, dz=0.7e-3)
    rng = np.random.default_rng(11)
    mask = rng.random(shape) > 0.25
    T0 = np.where(mask, 100 + 1400 * rng.random(shape), 20.0)
    jk, jc, pk, pc = _tables()
    xs = (np.arange(shape[0]) + 0.5)[:, None, None]

    def src_np(t):     # a heat source moving along x at 40 cells/s
        x0 = 2.0 + 40.0 * t
        return 1e8 * np.exp(-((xs - x0) ** 2) / 2.0) * np.ones(shape)

    common = dict(robin_h=40.0, t_inf=20.0, emissivity=0.45, theta=0.5)
    pj, aj = j_engine(jg, JMaterial(RHO, CP, K), implementation=jimpl,
                      k_table=jk, cp_table=jc,
                      source_fn=lambda t: jnp.asarray(1e8) * jnp.exp(
                          -((jnp.asarray(xs) - (2.0 + 40.0 * t)) ** 2) / 2.0)
                      * jnp.ones(shape), **common)
    want = aj(jnp.asarray(T0), pj(jnp.asarray(mask)), 0.05, jnp.int32(4),
              0.0)
    pp, ap = make_cartesian_engine(pg, Material(RHO, CP, K),
                                   implementation=impl, device="cpu",
                                   dtype=torch.float64, k_table=pk,
                                   cp_table=pc,
                                   source_fn=lambda t: _t(src_np(t)),
                                   **common)
    got = ap(_t(T0), pp(torch.from_numpy(mask)), 0.05, 4, 0.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-10,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# the app, refusals, guards
# ---------------------------------------------------------------------------

@pytest.fixture
def box_stl(tmp_path):
    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    return stl


def test_waam_varprop_flags_match_jax_app(box_stl, tmp_path):
    argv = ["--stl", box_stl, "--dx_mm", "1", "--nframes", "3",
            "--precision", "float64", "--bead_height_mm", "2",
            "--latent_J_kg", "2.7e5", "--melt_k_factor", "4",
            "--emissivity", "0.5", "--cp_liquid", "520"]
    ref = jax_app.run(jax_app.build_argparser().parse_args(
        argv + ["--outdir", str(tmp_path / "jax_out")]))
    res = {impl: port_app.run(port_app.build_argparser().parse_args(
        argv + ["--device", "cpu", "--implementation", impl]))
        for impl in ("kernels", "reference")}
    for got in res.values():
        assert got["layers"] == ref["layers"] and got["t"] == ref["t"]
        np.testing.assert_array_equal(got["active"].numpy(),
                                      np.asarray(ref["active"]))
        np.testing.assert_allclose(got["T"].numpy(), np.asarray(ref["T"]),
                                   rtol=0, atol=1e-9)
        for (t1, n1, m1), (t2, n2, m2) in zip(got["frames"], ref["frames"]):
            assert t1 == t2 and n1 == n2
            assert m1 == pytest.approx(m2, rel=0, abs=1e-9)
    # the flags reach the step: the constant-property run differs
    const = port_app.run(port_app.build_argparser().parse_args(
        argv[:10] + ["--device", "cpu"]))
    assert float((const["T"] - res["kernels"]["T"]).abs().max()) > 1.0


def _fused_kw():
    _, pk, pc = None, *_tables()[2:]
    return dict(k_table=pk, cp_table=pc, dt=0.02, theta=0.5, t_inf=20.0)


def test_negative_films_are_refused():
    """K8 scales a row only where couplings + films > 0, right for films
    >= 0 only: the varprop step and engine refuse negative films."""
    mask = torch.ones((6, 5, 4), dtype=torch.bool)
    T = torch.full(mask.shape, 900.0, dtype=torch.float64)
    grid, mat = CartesianGrid(6, 5, 4, 1e-3), Material(RHO, CP, K)
    codes = build_varprop_codes(mask)
    for kw in (dict(robin_h=-5.0), dict(emissivity=-0.1),
               dict(emissivity=0.5, h_conv=-3.0)):
        with pytest.raises(ValueError, match=">= 0"):
            adi_step_varprop_fused(T, mask, codes, grid, mat, **kw,
                                   **_fused_kw())
    for impl in ("kernels", "reference"):
        for kw in (dict(robin_h=-5.0, k_table=40.0),
                   dict(robin_h=10.0, emissivity=-0.2)):
            with pytest.raises(ValueError, match=">= 0"):
                make_cartesian_engine(grid, mat, implementation=impl,
                                      device="cpu", dtype=torch.float64,
                                      **kw)


def test_unported_varprop_routes_raise():
    mask = torch.ones((6, 5, 4), dtype=torch.bool)
    T = torch.full(mask.shape, 900.0, dtype=torch.float64)
    grid, mat = CartesianGrid(6, 5, 4, 1e-3), Material(RHO, CP, K)
    codes = build_varprop_codes(mask)
    # the g-stream tier runs now: float64 with gstreams=True takes the
    # classic tier, as in JAX; a bfloat16 state with a per-axis k tuple
    # runs the classic tier's bfloat16 entries (JAX's route); a float16
    # state raises
    assert torch.equal(
        adi_step_varprop_fused(T, mask, codes, grid, mat, gstreams=True,
                               **_fused_kw()),
        adi_step_varprop_fused(T, mask, codes, grid, mat, gstreams=False,
                               **_fused_kw()))
    kw = {**_fused_kw(), "k_table": (40.0, 50.0, 60.0)}
    got = adi_step_varprop_fused(T.to(torch.bfloat16), mask, codes, grid,
                                 mat, **kw)
    assert got.dtype == torch.bfloat16
    assert float((got.double() - adi_step_varprop_fused(
        T, mask, codes, grid, mat, **kw)).abs().max()) <= 8.0
    with pytest.raises(NotImplementedError, match="float16"):
        adi_step_varprop_fused(T.to(torch.float16), mask, codes, grid, mat,
                               **kw)
    with pytest.raises(ValueError, match="requires emissivity"):
        make_cartesian_engine(grid, mat, implementation="kernels",
                              device="cpu", dtype=torch.float64,
                              radiation_scale=1.0)
    # a kernel table holds at most 32 breakpoints
    big = PropertyTable(tuple(range(33)), tuple(float(v) for v in range(33)))
    with pytest.raises(ValueError, match="32 breakpoints"):
        from adi_thermal_fields_tpu_torch.solvers.varprop import _table_arg
        _table_arg(big)


def test_varprop_wrappers_refuse_inputs_that_require_grad():
    mask = torch.ones((4, 5, 6), dtype=torch.bool)
    T = torch.full((4, 5, 6), 900.0, dtype=torch.float64, requires_grad=True)
    f = torch.full((4, 5, 6), 1.0, dtype=torch.float64)
    m8 = mask.to(torch.uint8)
    code0 = sweep_code(mask, None, 0)
    code1 = sweep_code(mask, None, 1).movedim(0, 1).contiguous()
    code2 = build_vp2_code(mask, 2, edge_exposed=True)
    calls = [
        lambda: varprop_fields(T, m8, k_spec=K, cp_spec=CP, rho=RHO),
        lambda: varprop_theta_sweep(T, code0, f, f, f, f, 1e-2, 1e6, 0.1,
                                    10.0, 20.0),
        lambda: varprop_sweep_y(T, code1, f, f, 0.1, 10.0, 20.0),
        lambda: vp2_sweep_z(T, T.detach(), code2, 1e6, 1e3, 1e5, k_spec=K,
                            cp_spec=CP),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward only"):
            call()
