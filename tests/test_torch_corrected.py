"""The port's corrected-BC and general-film varprop routes against the JAX
package, on the CPU.

Same inputs, made from a seed with numpy, go through the JAX function and
the port's counterpart; the JAX Pallas kernels run in interpret mode.
Tolerances:

* ``corrected_robin_fields`` / ``voxel_projected_areas``: bitwise (numpy
  on both sides) on the box STL, the cylinder of
  tests/test_geometry.py:139 and the tilted cone at anisotropic voxels;
* ``build_face_h_axes`` (z pair transposed) and ``convert.h_axes_from_jax``:
  1e-12;
* the plain versions of row 17 (``varprop_sweep_x``, ``varprop_sweep_z``,
  with and without a film stream) and row 19 (``varprop_theta_rhs``, with
  and without a source) against ``fused_varprop_sweep`` and
  ``varprop_theta_rhs`` in interpret mode at float64: 1e-10 K;
* ``adi_step_varprop_fused`` with ``h_axes``, ``h_field``,
  ``fuse_theta=False``, a per-axis k tuple and a callable k against JAX
  ``adi_step_varprop_fused(interpret=True)`` and the xla step at float64:
  1e-9 K;
* the engine, both implementations, on the five configurations of
  tests/test_round5_fixes.py (per-face fields with radiation and area
  scales, one convective field, constant fields against the scalar lane,
  unit scales against the scalar radiative lane, a birth rebuild) against
  the JAX engine: 1e-9 K (the exposure fold against the scalar lane:
  1e-11 K);
* the WAAM app with ``--corrected_bc`` (alone, with ``--emissivity`` and
  the varprop flags, and with ``--dz_mm 0.5``) against the JAX app at
  float64 on a box STL: 1e-9 K.
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
from adi_thermal_fields_tpu.geometry import bc_correction as jbc
from adi_thermal_fields_tpu.geometry.primitives import cylinder_mesh
from adi_thermal_fields_tpu.geometry.stl import TriMesh as JTriMesh
from adi_thermal_fields_tpu.geometry.voxelize import (
    voxelize_solid as j_voxelize)
from adi_thermal_fields_tpu.solvers import pallas_varprop as jpv
from adi_thermal_fields_tpu.solvers.pallas_sweeps import (
    sweep_code as j_sweep_code)
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          PropertyTable, apparent_cp,
                                          adi_step_varprop_fused,
                                          build_varprop_codes,
                                          melt_pool_enhanced_k)
from adi_thermal_fields_tpu_torch.apps import waam_from_stl as port_app
from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
from adi_thermal_fields_tpu_torch.convert import (faces_from_numpy,
                                                  h_axes_from_jax)
from adi_thermal_fields_tpu_torch.geometry import bc_correction as pbc
from adi_thermal_fields_tpu_torch.geometry.primitives import box_mesh
from adi_thermal_fields_tpu_torch.geometry.stl import TriMesh, save_stl_binary
from adi_thermal_fields_tpu_torch.solvers import (sweep_code,
                                                  varprop_sweep_x,
                                                  varprop_sweep_z,
                                                  varprop_theta_rhs)
from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
    build_face_h_axes)

torch.set_num_threads(1)

FACES = ("x-", "x+", "y-", "y+", "z-", "z+")
RHO, CP, K = 7800.0, 490.0, 54.0
ATOL = 1e-9


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# geometry/bc_correction
# ---------------------------------------------------------------------------

def _cone_triangles(R=0.02, H=0.05, tilt=0.4, n_phi=64):
    """The tilted cone of tests/test_geometry.py:209."""
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    base = np.stack([R * np.cos(ph), R * np.sin(ph), np.zeros_like(ph)], 1)
    apex = np.array([0.0, 0.0, H])
    b2 = np.roll(base, -1, axis=0)
    side = np.stack([base, b2, np.broadcast_to(apex, base.shape)], axis=1)
    cap = np.stack([np.broadcast_to(np.zeros(3), base.shape), b2, base], 1)
    tris = np.concatenate([side, cap])
    cs, sn = np.cos(tilt), np.sin(tilt)
    tris = tris @ np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]]).T
    tris[:, :, 2] -= tris[:, :, 2].min() - 0.001
    return tris


@pytest.mark.parametrize("body", ["box", "cylinder", "cone-anisotropic"])
def test_corrected_robin_fields_match_jax(body):
    if body == "box":
        tris = box_mesh(size=(6e-3, 6e-3, 8e-3),
                        center=(3e-3, 3e-3, 4e-3)).triangles
        d = 1e-3
    elif body == "cylinder":
        R, H = 0.02, 0.04
        tris = np.asarray(cylinder_mesh(R, H, center=(0, 0, H / 2),
                                        n_phi=128).triangles)
        d = R / 8
    else:
        tris = _cone_triangles()
        d = (2e-3, 2e-3, 1e-3)
    mask, origin = j_voxelize(JTriMesh(tris), d)
    mask = np.asarray(mask)
    base_h = {f: 30.0 + 5.0 * i for i, f in enumerate(FACES)}
    want = jbc.corrected_robin_fields(JTriMesh(tris), mask, origin, d,
                                      base_h)
    got = pbc.corrected_robin_fields(TriMesh(tris), mask, origin, d, base_h)
    for w_dict, g_dict in zip(want, got):
        assert set(g_dict) == set(w_dict)
        for f in w_dict:
            np.testing.assert_array_equal(g_dict[f], w_dict[f])
    want = jbc.voxel_projected_areas(JTriMesh(tris), mask, origin, d)
    got = pbc.voxel_projected_areas(TriMesh(tris), mask, origin, d)
    for f in FACES:
        np.testing.assert_array_equal(got[f], want[f])


# ---------------------------------------------------------------------------
# build_face_h_axes
# ---------------------------------------------------------------------------

def _face_fields(seed, shape):
    rng = np.random.default_rng(seed)
    hf = {f: 20.0 + 15.0 * rng.random(shape) for f in FACES}
    sc = {f: 0.6 + 0.8 * rng.random(shape) for f in FACES}
    return hf, sc


@pytest.mark.parametrize("scaled", [False, True], ids=["conv", "scaled"])
def test_build_face_h_axes_matches_jax(scaled):
    shape = (9, 8, 7)
    mask = np.random.default_rng(2).random(shape) > 0.3
    hf, sc = _face_fields(3, shape)
    hf["y+"] = 12.5                     # a scalar face
    sc_j = {**{f: jnp.asarray(v) for f, v in sc.items()}, "z-": None}
    sc_p = {**sc, "z-": None}           # a face without a scale counts 1
    hf_j = {f: (v if isinstance(v, float) else jnp.asarray(v))
            for f, v in hf.items()}
    want = jcv.build_face_h_axes(jnp.asarray(mask), hf_j,
                                 sc_j if scaled else None,
                                 dtype=jnp.float64)
    got = build_face_h_axes(torch.from_numpy(mask),
                            faces_from_numpy(hf, device="cpu"),
                            (faces_from_numpy(sc_p, device="cpu")
                             if scaled else None), dtype=torch.float64)
    conv = h_axes_from_jax(want, device="cpu")
    for ax in range(3):
        for g, w, c in zip(got[ax], want[ax], conv[ax]):
            if w is None:
                assert g is None and c is None
                continue
            w = _np(w)
            if ax == 2:                 # the JAX z pair is (z, x, y)
                w = np.moveaxis(w, 0, 2)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12)
            np.testing.assert_allclose(c.numpy(), w, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# rows 17 and 19: plain versions against the JAX kernels
# ---------------------------------------------------------------------------

def _stream_case(seed, shape=(12, 10, 9)):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < 0.8
    T = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    kf = rng.random(shape) * 40 + 10
    jm = jnp.asarray(mask)
    fcs = [_np(jcv._face_g(jnp.asarray(kf), ax, -1, jm)) for ax in range(3)]
    w = rng.random(shape) * 1e-7 + 2e-7
    h = rng.random(shape) * 40 + 5
    src = rng.random(shape) * 1e6
    return mask, T, fcs, w, h, src


@pytest.mark.parametrize("film", ["h_stream", "rob_c"])
@pytest.mark.parametrize("axis", ["x", "z"])
def test_varprop_sweep_plain_matches_jax_row17(axis, film):
    mask, T, fcs, w, h, _ = _stream_case(5)
    tg, sk, t_inf = 0.37, 0.01, 20.0
    hs = h if film == "h_stream" else None
    mt = torch.from_numpy(mask)
    if axis == "x":
        want = jpv.fused_varprop_sweep(
            jnp.asarray(T), j_sweep_code(jnp.asarray(mask), None, 0),
            jnp.asarray(fcs[0]), jnp.asarray(w), tg, sk, t_inf,
            h=None if hs is None else jnp.asarray(hs), rob_c=15.0,
            interpret=True)
        got = varprop_sweep_x(_t(T), sweep_code(mt, None, 0), _t(fcs[0]),
                              _t(w), tg, sk, t_inf,
                              h=None if hs is None else _t(hs), rob_c=15.0)
    else:
        zl = (lambda a: jnp.moveaxis(jnp.asarray(a), 2, 0))
        want = jpv.fused_varprop_sweep(
            jnp.asarray(T), j_sweep_code(jnp.asarray(mask), None, 2),
            zl(fcs[2]), zl(w), tg, sk, t_inf,
            h=None if hs is None else zl(hs), rob_c=15.0, interpret=True,
            nat_rhs_out=True)
        code = sweep_code(mt, None, 2).movedim(0, 2).contiguous()
        got = varprop_sweep_z(_t(T), code, _t(fcs[2]), _t(w), tg, sk, t_inf,
                              h=None if hs is None else _t(hs), rob_c=15.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("with_src", [False, True], ids=["no_src", "src"])
def test_varprop_theta_rhs_plain_matches_jax_row19(with_src):
    mask, T, (fx, fy, fz), w, _, src = _stream_case(6)
    dt, inv_d2 = 0.02, [1e6, 0.25e6, 1.0 / 9e-6]
    cw = 0.5 * dt
    kw_j = dict(src=jnp.asarray(src), dt=dt) if with_src else {}
    kw_p = dict(src=_t(src), dt=dt) if with_src else {}
    want = jpv.varprop_theta_rhs(
        jnp.asarray(T), *(jnp.asarray(a) for a in (fx, fy, fz, w)),
        jnp.asarray(mask, jnp.int8), cw, inv_d2, interpret=True, **kw_j)
    got = varprop_theta_rhs(_t(T), _t(fx), _t(fy), _t(fz), _t(w),
                            torch.from_numpy(mask).to(torch.uint8), cw,
                            inv_d2, **kw_p)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# adi_step_varprop_fused: the general routes
# ---------------------------------------------------------------------------

def _tables():
    return (jcv.melt_pool_enhanced_k(K, 1420.0, 1470.0, enhancement=4.0),
            jcv.apparent_cp(CP, CP, 2.7e5, 1420.0, 1470.0),
            melt_pool_enhanced_k(K, 1420.0, 1470.0, enhancement=4.0),
            apparent_cp(CP, CP, 2.7e5, 1420.0, 1470.0))


ROUTES = ["h_axes", "h_field", "fuse_theta_false", "k_tuple", "callable_k"]


@pytest.mark.parametrize("route", ROUTES)
def test_adi_step_varprop_fused_routes_match_jax(route):
    shape = (12, 10, 8)
    rng = np.random.default_rng(9)
    mask = rng.random(shape) < 0.85
    T = np.where(mask, 20.0 + 1580.0 * rng.random(shape), 20.0)
    T.reshape(-1)[::7] = 1420.0
    src = rng.random(shape) * 1e6
    gk = dict(dy=1.3e-3, dz=0.8e-3)
    jg, pg = JGrid(*shape, 1e-3, **gk), CartesianGrid(*shape, 1e-3, **gk)
    jmat, pmat = JMaterial(RHO, CP, K), Material(RHO, CP, K)
    jk, jc, pk, pc = _tables()
    jm, pm = jnp.asarray(mask), torch.from_numpy(mask)
    dt, h, t_inf = 0.01, 35.0, 20.0
    jkw, pkw = dict(k_table=jk, cp_table=jc), dict(k_table=pk, cp_table=pc)
    h_xla = h                          # the film of the xla step's packs
    if route == "h_axes":
        hf, sc = _face_fields(4, shape)
        ja = jcv.build_face_h_axes(jm, {f: jnp.asarray(v)
                                        for f, v in hf.items()},
                                   {f: jnp.asarray(v) for f, v in sc.items()},
                                   dtype=jnp.float64)
        jkw.update(h_axes=ja, emissivity=0.65)
        pkw.update(h_axes=build_face_h_axes(pm, hf, sc, dtype=torch.float64),
                   emissivity=0.65)
        hr = j_radiative_h(jnp.asarray(T), 0.65, t_inf)
        h_xla = {f: jnp.asarray(hf[f]) + hr * jnp.asarray(sc[f])
                 for f in FACES}
    elif route == "h_field":
        hfield = 10.0 + 30.0 * rng.random(shape)
        jkw.update(h_field=jnp.asarray(hfield))
        pkw.update(h_field=_t(hfield))
        h_xla = jnp.asarray(hfield)
    elif route == "fuse_theta_false":
        jkw.update(robin_h=h, source=jnp.asarray(src), fuse_theta=False)
        pkw.update(robin_h=h, source=_t(src), fuse_theta=False)
    elif route == "k_tuple":
        k3 = jcv.melt_pool_enhanced_k(30.0, 1420.0, 1470.0)
        jkw.update(k_table=(jk, 40.0, k3), robin_h=h)
        pkw.update(k_table=(pk, 40.0, melt_pool_enhanced_k(30.0, 1420.0,
                                                           1470.0)),
                   robin_h=h)
    else:
        # the bimetal substrate of tests/test_varprop.py:701: a closure
        # over a spatial field, with the tables for cp
        sub_np = (np.arange(shape[2]) < 4)[None, None, :]
        jsub, psub = jnp.asarray(sub_np), torch.from_numpy(sub_np)
        jkw.update(k_table=lambda T: jnp.where(jsub, 540.0, 54.0 + 0.0 * T),
                   robin_h=h)
        pkw.update(k_table=lambda T: torch.where(psub, 540.0, 54.0 + 0.0 * T),
                   robin_h=h)
    got = adi_step_varprop_fused(_t(T), pm, build_varprop_codes(pm), pg,
                                 pmat, dt=dt, theta=0.5, t_inf=t_inf, **pkw)
    want_fused = jcv.adi_step_varprop_fused(
        jnp.asarray(T), jm, jcv.build_varprop_codes(jm), jg, jmat, dt=dt,
        theta=0.5, t_inf=t_inf, interpret=True, **jkw)
    packs = j_packs(jm, jg, jmat, robin_h=h_xla, dtype=jnp.float64)
    want_xla = jcv.adi_step_varprop(
        jnp.asarray(T), jm, packs, jg, jmat, k_table=jkw["k_table"],
        cp_table=jc, dt=dt, theta=0.5, t_inf=t_inf,
        source=jkw.get("source"), implementation="xla")
    for want in (want_fused, want_xla):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the engine: the configurations of tests/test_round5_fixes.py
# ---------------------------------------------------------------------------

def _round5_setup(n=8):
    m = np.zeros((n, n, n), bool)
    m[:, :, : n // 2] = True
    m[: n // 2, : n // 2, n // 2: n // 2 + 2] = True     # a step feature
    T0 = np.where(m, 1400.0, 20.0)
    rng = np.random.default_rng(7)
    hf = {f: 20.0 + 15.0 * rng.random(m.shape) for f in FACES}
    sc = {f: 0.6 + 0.8 * rng.random(m.shape) for f in FACES}
    return m, T0, hf, sc


def _round5_tables():
    pts, vals = (0.0, 800.0, 1600.0), (40.0, 50.0, 58.0)
    return (jcv.PropertyTable(jnp.asarray(pts), jnp.asarray(vals)),
            jcv.apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0),
            PropertyTable(pts, vals),
            apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0))


def _round5_kw(case, m, hf, sc):
    """(JAX kwargs, port kwargs) of one engine configuration."""
    n = m.shape[0]
    if case in ("field_h_radiative", "birth_rebuild"):
        return (dict(robin_h={f: jnp.asarray(v) for f, v in hf.items()},
                     emissivity=0.65,
                     radiation_scale={f: jnp.asarray(v)
                                      for f, v in sc.items()}),
                dict(robin_h=hf, emissivity=0.65, radiation_scale=sc))
    if case == "field_h_convective":
        return (dict(robin_h=jnp.asarray(hf["x-"])), dict(robin_h=hf["x-"]))
    const = {f: np.full((n,) * 3, 27.5 if case == "constant_fields"
                        else 18.0) for f in FACES}
    if case == "constant_fields":
        return (dict(robin_h={f: jnp.asarray(v) for f, v in const.items()}),
                dict(robin_h=const))
    ones = {f: np.ones((n,) * 3) for f in FACES}
    return (dict(robin_h={f: jnp.asarray(v) for f, v in const.items()},
                 emissivity=0.5,
                 radiation_scale={f: jnp.asarray(v) for f, v in ones.items()}),
            dict(robin_h=const, emissivity=0.5, radiation_scale=ones))


def _round5_run(make, advance_args, case, m, T0, mask_of, T_of):
    """Run one engine for 6 sub-steps (3 + a birth + 3 for birth_rebuild)."""
    prepare, advance = make
    if case != "birth_rebuild":
        return advance(T_of(T0), prepare(mask_of(m)), *advance_args(6))
    m2 = m.copy()
    m2[:, :, m.shape[2] // 2: m.shape[2] // 2 + 2] = True
    T = advance(T_of(T0), prepare(mask_of(m)), *advance_args(3))
    T = np.where(m2 & ~m, 1500.0, np.asarray(T))
    return advance(T_of(T), prepare(mask_of(m2)), *advance_args(3))


@pytest.mark.parametrize("case", ["field_h_radiative", "field_h_convective",
                                  "constant_fields", "unit_scales",
                                  "birth_rebuild"])
def test_engine_round5_configurations_match_jax(case):
    m, T0, hf, sc = _round5_setup()
    n = m.shape[0]
    jkt, jct, pkt, pct = _round5_tables()
    jkw, pkw = _round5_kw(case, m, hf, sc)
    jeng = j_engine(JGrid(n, n, n, 1e-3), JMaterial(RHO, CP, K), t_inf=20.0,
                    implementation="xla", k_table=jkt, cp_table=jct, **jkw)
    want = _np(_round5_run(
        jeng, lambda k: (jnp.asarray(0.02), jnp.int32(k), 0.0), case, m, T0,
        jnp.asarray, jnp.asarray))
    got = {}
    for impl in ("kernels", "reference"):
        peng = make_cartesian_engine(
            CartesianGrid(n, n, n, 1e-3), Material(RHO, CP, K),
            implementation=impl, device="cpu", dtype=torch.float64,
            t_inf=20.0, k_table=pkt, cp_table=pct, **pkw)
        got[impl] = _round5_run(peng, lambda k: (0.02, k, 0.0), case, m, T0,
                                torch.from_numpy, _t).numpy()
        np.testing.assert_allclose(got[impl], want, rtol=0, atol=ATOL)
    if case in ("constant_fields", "unit_scales"):
        # the exposure fold rebuilds the face sum: the scalar lane agrees
        scalar = (dict(robin_h=27.5) if case == "constant_fields"
                  else dict(robin_h=18.0, emissivity=0.5))
        peng = make_cartesian_engine(
            CartesianGrid(n, n, n, 1e-3), Material(RHO, CP, K),
            implementation="kernels", device="cpu", dtype=torch.float64,
            t_inf=20.0, k_table=pkt, cp_table=pct, **scalar)
        lane = _round5_run(peng, lambda k: (0.02, k, 0.0), case, m, T0,
                           torch.from_numpy, _t).numpy()
        tol = 1e-11 if case == "constant_fields" else ATOL
        np.testing.assert_allclose(got["kernels"], lane, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the WAAM app
# ---------------------------------------------------------------------------

@pytest.fixture
def box_stl(tmp_path):
    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    return stl


@pytest.mark.parametrize("extra,impls", [
    ([], ("kernels",)),
    (["--emissivity", "0.5", "--latent_J_kg", "2.7e5", "--melt_k_factor",
      "4"], ("kernels", "reference")),
    (["--emissivity", "0.5", "--dz_mm", "0.5"], ("kernels",))],
    ids=["corrected", "corrected-rad-varprop", "corrected-rad-dz"])
def test_waam_corrected_bc_matches_jax_app(box_stl, tmp_path, extra, impls):
    argv = ["--stl", box_stl, "--dx_mm", "1", "--nframes", "3",
            "--precision", "float64", "--bead_height_mm", "2",
            "--h_side", "40", "--corrected_bc", "1", *extra]
    ref = jax_app.run(jax_app.build_argparser().parse_args(
        argv + ["--outdir", str(tmp_path / "jax_out")]))
    for impl in impls:
        got = port_app.run(port_app.build_argparser().parse_args(
            argv + ["--device", "cpu", "--implementation", impl]))
        assert got["layers"] == ref["layers"] and got["t"] == ref["t"]
        np.testing.assert_array_equal(got["active"].numpy(),
                                      np.asarray(ref["active"]))
        np.testing.assert_allclose(got["T"].numpy(), np.asarray(ref["T"]),
                                   rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_h_axes_and_h_field_are_mutually_exclusive():
    mask = torch.ones((6, 5, 4), dtype=torch.bool)
    T = torch.full(mask.shape, 900.0, dtype=torch.float64)
    h_ab = build_face_h_axes(mask, 10.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="mutually exclusive"):
        adi_step_varprop_fused(T, mask, build_varprop_codes(mask),
                               CartesianGrid(6, 5, 4, 1e-3),
                               Material(RHO, CP, K), dt=0.02, h_axes=h_ab,
                               h_field=T)


def test_row17_row19_wrappers_refuse_inputs_that_require_grad():
    mask = torch.ones((4, 5, 6), dtype=torch.bool)
    T = torch.full((4, 5, 6), 900.0, dtype=torch.float64, requires_grad=True)
    f = torch.full((4, 5, 6), 1.0, dtype=torch.float64)
    code0 = sweep_code(mask, None, 0)
    code2 = sweep_code(mask, None, 2).movedim(0, 2).contiguous()
    calls = [
        lambda: varprop_sweep_x(T, code0, f, f, 0.1, 10.0, 20.0),
        lambda: varprop_sweep_z(T, code2, f, f, 0.1, 10.0, 20.0),
        lambda: varprop_theta_rhs(T, f, f, f, f, mask.to(torch.uint8), 1e-2,
                                  1e6),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward only"):
            call()
