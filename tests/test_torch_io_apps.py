"""The apps' outputs and the single-track app: the port against the JAX
package, on the CPU, at float64 (grids of at most 32^3, one thread).

Same inputs, made from a seed with numpy, go through the JAX function and
the port's counterpart.  Tolerances:

* VTK files: the same bytes from both writers (ASCII and binary,
  structured points and the cylindrical grid); each package reads the
  other's files back exactly (binary) or to the printed digits (ASCII);
* npz checkpoints: exact round trips between the packages, both ways;
* ``history_update``: exact; the engine's thermal history against the JAX
  engine's XLA branch after 4 sub-steps: T 1e-9 K, T_peak 1e-9 K, t_above
  1e-12 s; history on against off: the field bit for bit, on every route;
* ``EventLoop`` with interpass dwell: the same ``dwell_log`` as JAX and T
  within 1e-9 K; resumed from ``start_t`` and ``history_state``: equal to
  the straight run;
* the WAAM app with ``--history_t_crit 800,500 --save_vtk 1
  --checkpoint`` and after ``--resume`` (from the port's or the JAX app's
  checkpoint): T and the history within 1e-9 against the JAX app;
* the spiral app interrupted and resumed against the JAX app's straight
  run: 1e-12 K (T) and 1e-12 s (t_above);
* the single-track app: 1e-9 K against the JAX app without the torch, and
  with the Goldak torch when both build its field at float64 (the JAX app
  builds it at float32, its ``goldak_source`` default, and then the two
  part by the float32 rounding of the source, up to 3448 K: held at 5e-3
  K); ``goldak_source`` and ``gaussian_ellipsoid_source``: 1e-12
  relative;
* the numpy copies (birth/layers, shapes, perimeter, slices,
  ``TimeControls``) exact; ``apply_surface_impulse`` and
  ``thomas_along_axis`` 1e-12.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import Material as JMaterial
from adi_thermal_fields_tpu.apps import engine as jeng
from adi_thermal_fields_tpu.apps import single_track as jax_track
from adi_thermal_fields_tpu.apps import spiral_tube as jax_spiral
from adi_thermal_fields_tpu.apps import waam_from_stl as jax_waam
from adi_thermal_fields_tpu.bc.radiation import radiative_h as j_radiative_h
from adi_thermal_fields_tpu.birth import heat_source as jhs
from adi_thermal_fields_tpu.birth import layers as jlayers
from adi_thermal_fields_tpu.core.timestep import TimeControls as JTime
from adi_thermal_fields_tpu.geometry import perimeter as jperim
from adi_thermal_fields_tpu.geometry import shapes as jshapes
from adi_thermal_fields_tpu.geometry import slices as jslices
from adi_thermal_fields_tpu.geometry.primitives import (
    cylinder_mesh as j_cylinder_mesh)
from adi_thermal_fields_tpu.io import checkpoint as jck
from adi_thermal_fields_tpu.io import vtk as jvtk
from adi_thermal_fields_tpu.solvers.thomas import (
    thomas_along_axis as j_thomas_along_axis)
from adi_thermal_fields_tpu.step.cartesian import (
    apply_surface_impulse as j_impulse)
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          TimeControls, apparent_cp,
                                          apply_surface_impulse,
                                          melt_pool_enhanced_k, radiative_h)
from adi_thermal_fields_tpu_torch.apps import engine as peng
from adi_thermal_fields_tpu_torch.apps import single_track as port_track
from adi_thermal_fields_tpu_torch.apps import spiral_tube as port_spiral
from adi_thermal_fields_tpu_torch.apps import viewer
from adi_thermal_fields_tpu_torch.apps import waam_from_stl as port_waam
from adi_thermal_fields_tpu_torch.birth import heat_source as phs
from adi_thermal_fields_tpu_torch.birth import layers as players
from adi_thermal_fields_tpu_torch.geometry import perimeter as pperim
from adi_thermal_fields_tpu_torch.geometry import shapes as pshapes
from adi_thermal_fields_tpu_torch.geometry import slices as pslices
from adi_thermal_fields_tpu_torch.geometry.primitives import box_mesh
from adi_thermal_fields_tpu_torch.geometry.stl import (TriMesh,
                                                       save_stl_binary)
from adi_thermal_fields_tpu_torch.io import checkpoint as pck
from adi_thermal_fields_tpu_torch.io import vtk as pvtk
from adi_thermal_fields_tpu_torch.solvers.thomas import thomas_along_axis

torch.set_num_threads(1)

RHO, CP, K = 7800.0, 490.0, 54.0
ATOL = 1e-9


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# VTK and checkpoints
# ---------------------------------------------------------------------------

def _vtk_fields(kind, seed=0):
    rng = np.random.default_rng(seed)
    shape = (4, 5, 6) if kind == "points" else (3, 8, 5)
    return {"Temperature": 20.0 + 1480.0 * rng.random(shape),
            "Mask": (rng.random(shape) > 0.4).astype(np.float32)}


def _write_vtk(mod, kind, path, fields, binary):
    if kind == "points":
        mod.write_vtk_structured_points(path, fields, spacing=(0.5, 1.0, 2.0),
                                        origin=(1.0, 2.0, 3.0),
                                        binary=binary)
    else:
        mod.write_vtk_cylindrical_grid(path, fields,
                                       r=10.0 + np.arange(3.0),
                                       dphi=2 * np.pi / 8, dz=0.5,
                                       binary=binary, comment="tube [mm]")


def _read_vtk(mod, kind, path):
    if kind == "points":
        return mod.read_vtk_structured_points(path)
    pts, fields = mod.read_vtk_structured_grid(path)
    return {"__points": pts, **fields}


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("kind", ["points", "cylindrical"])
def test_vtk_writers_write_the_same_bytes_and_read_each_other(
        tmp_path, kind, binary):
    fields = _vtk_fields(kind)
    pj, pp = str(tmp_path / "jax.vtk"), str(tmp_path / "port.vtk")
    _write_vtk(jvtk, kind, pj, fields, binary)
    _write_vtk(pvtk, kind, pp, fields, binary)
    assert filecmp.cmp(pj, pp, shallow=False)
    a, b = _read_vtk(pvtk, kind, pj), _read_vtk(jvtk, kind, pp)
    assert sorted(a) == sorted(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
    got = a["Temperature"] if kind == "points" else a["Temperature"][:, :-1]
    want = np.asarray(fields["Temperature"], np.float32)
    np.testing.assert_allclose(got, want, rtol=0 if binary else 1e-5,
                               atol=0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    rng = np.random.default_rng(1)
    T = rng.random((3, 4, 5)) * 1000
    meta = {"history_peak": rng.random((3, 4, 5)),
            "history_above": rng.random((2, 3, 4, 5)),
            "history_crits": np.asarray([800.0, 500.0])}
    path = str(tmp_path / "ck.npz")
    save, load = ((pck.save_checkpoint, jck.load_checkpoint)
                  if writer == "port" else
                  (jck.save_checkpoint, pck.load_checkpoint))
    state = (pck.RunState if writer == "port" else jck.RunState)(
        T=_t(T) if writer == "port" else T, active=T > 500.0, t=12.5,
        meta=meta)
    save(path, state)
    back = load(path)
    np.testing.assert_array_equal(back.T, T)
    np.testing.assert_array_equal(back.active, T > 500.0)
    assert back.t == 12.5 and sorted(back.meta) == sorted(meta)
    for k, v in meta.items():
        np.testing.assert_array_equal(back.meta[k], v)


def test_checkpoint_takes_tensors_at_any_dtype(tmp_path):
    path = str(tmp_path / "ck.npz")
    T = torch.tensor([[[1500.0, 20.25]]], dtype=torch.bfloat16)
    pck.save_checkpoint(path, pck.RunState(T=T, active=T > 100, t=1.0))
    back = jck.load_checkpoint(path)
    assert back.T.dtype == np.float32 and back.meta is None
    np.testing.assert_array_equal(back.T, T.float().numpy())


# ---------------------------------------------------------------------------
# the engine's thermal history
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True])
def test_history_update_matches_jax(multi):
    rng = np.random.default_rng(3)
    shape = (5, 6, 7)
    T = 300.0 + 1000.0 * rng.random(shape)
    pk = 300.0 + 1000.0 * rng.random(shape)
    crits = (800.0, 500.0) if multi else (800.0,)
    ta = rng.random(((2,) if multi else ()) + shape)
    tc = np.asarray(crits)
    want_pk, want_ta = jeng.history_update(
        jnp.asarray(pk), jnp.asarray(ta), jnp.asarray(T), 0.0375,
        jnp.asarray(tc), multi)
    ppk, pta = _t(pk.copy()), _t(ta.copy())
    got = peng.history_update(ppk, pta, _t(T), 0.0375, _t(tc), multi)
    assert got[0] is ppk and got[1] is pta          # in place
    np.testing.assert_array_equal(ppk.numpy(), np.asarray(want_pk))
    np.testing.assert_array_equal(pta.numpy(), np.asarray(want_ta))


def test_history_update_compares_at_the_thresholds_dtype():
    # a bfloat16 state against float32 thresholds: 801 rounds to 800 in
    # bfloat16 and 799.5 does not exist there; compared at float32 (as
    # JAX's promote_types(T.dtype, float32)) 800 > 799.5
    T = torch.tensor([800.0, 804.0, 796.0], dtype=torch.bfloat16)
    for multi, tc in ((False, [799.5]), (True, [799.5, 803.0])):
        pk = T.clone()
        ta = torch.zeros(((len(tc),) if multi else ()) + (3,))
        peng.history_update(pk, ta, T, 0.5, torch.tensor(tc), multi)
        want_pk, want_ta = jeng.history_update(
            jnp.asarray(T.float().numpy(), jnp.bfloat16),
            jnp.zeros(ta.shape, jnp.float32),
            jnp.asarray(T.float().numpy(), jnp.bfloat16), 0.5,
            jnp.asarray(tc, jnp.float32), multi)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(want_ta))
        assert ta.reshape(-1, 3)[0].tolist() == [0.5, 0.5, 0.0]


def _engine_case(seed=5, shape=(12, 10, 8)):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.25
    mask[:, :, :2] = True
    T = np.where(mask, 200.0 + 1300.0 * rng.random(shape), 20.0)
    return mask, T


ROUTE_KW = {"lite": {}, "varprop": {"varprop": True},
            "reference": {"implementation": "reference"}}


@pytest.mark.parametrize("crit", [800.0, (800.0, 500.0)],
                         ids=["one", "two"])
@pytest.mark.parametrize("route", sorted(ROUTE_KW))
def test_engine_history_matches_jax(route, crit):
    mask, T = _engine_case()
    shape = mask.shape
    kw = dict(theta=0.5, t_inf=20.0, robin_h=60.0, history_t_crit=crit)
    jkw, pkw = dict(kw), dict(kw)
    impl = ROUTE_KW[route].get("implementation", "kernels")
    if ROUTE_KW[route].get("varprop"):
        jkw.update(k_table=jcv.melt_pool_enhanced_k(K, 1420.0, 1470.0,
                                                    enhancement=3.0),
                   cp_table=jcv.apparent_cp(CP, CP, 2.7e5, 1420.0, 1470.0),
                   emissivity=0.4)
        pkw.update(k_table=melt_pool_enhanced_k(K, 1420.0, 1470.0,
                                                enhancement=3.0),
                   cp_table=apparent_cp(CP, CP, 2.7e5, 1420.0, 1470.0),
                   emissivity=0.4)
    jg = JGrid(*shape, 1e-3, dz=0.8e-3)
    pg = CartesianGrid(*shape, 1e-3, dz=0.8e-3)
    pj, aj = jeng.make_cartesian_engine(jg, JMaterial(RHO, CP, K),
                                        implementation="xla",
                                        dtype=jnp.float64, **jkw)
    multi = isinstance(crit, tuple)
    ta0 = np.zeros(((2,) if multi else ()) + shape)
    want_T, (want_pk, want_ta) = aj(
        jnp.asarray(T), pj(jnp.asarray(mask)), jnp.float64(0.05),
        jnp.int32(4), jnp.float64(0.0), (jnp.asarray(T), jnp.asarray(ta0)))
    pp, ap = peng.make_cartesian_engine(pg, Material(RHO, CP, K),
                                        implementation=impl, device="cpu",
                                        dtype=torch.float64, **pkw)
    assert ap.history_thresholds == (tuple(crit) if multi else None)
    # copies: the engine updates its history in place, and the JAX call
    # above may still be reading ta0 (a CPU array it can alias)
    got_T, (pk, ta) = ap(_t(T), pp(_t(mask)), 0.05, 4, 0.0,
                         (_t(T.copy()), _t(ta0.copy())))
    np.testing.assert_allclose(got_T.numpy(), np.asarray(want_T), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(want_pk), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(want_ta), rtol=0,
                               atol=1e-12)
    assert ta.dtype == torch.float64 and (ta.numpy() > 0).any()


def _route_engine(route, history):
    """(prepare, advance, dtype) of the port's engine on ``route``."""
    shape = (10, 9, 8)
    grid = CartesianGrid(*shape, 1e-3)
    mat = Material(RHO, CP, K)
    tabs = dict(k_table=melt_pool_enhanced_k(K, 1420.0, 1470.0,
                                             enhancement=3.0),
                cp_table=apparent_cp(CP, CP, 2.7e5, 1420.0, 1470.0))
    h_field = 40.0 + 10.0 * torch.rand(shape, generator=torch.Generator()
                                       .manual_seed(2), dtype=torch.float64)
    dtype = torch.bfloat16 if route == "bf16 g-stream" else torch.float64
    kw = {"plan-lite": dict(robin_h=60.0),
          "entry": dict(robin_h=60.0, neumann={"z+": 4e5}),
          "field": dict(robin_h=h_field),
          "varprop fused": dict(robin_h=60.0, emissivity=0.4, **tabs),
          "varprop materialized": dict(robin_h=60.0, neumann={"z+": 4e5},
                                       **tabs),
          "bf16 g-stream": dict(robin_h=60.0, emissivity=0.4,
                                stochastic_rounding=True, **tabs),
          "reference": dict(robin_h=60.0)}[route]
    impl = "reference" if route == "reference" else "kernels"
    prep, adv = peng.make_cartesian_engine(
        grid, mat, implementation=impl, device="cpu", dtype=dtype,
        t_inf=20.0, history_t_crit=(800.0, 500.0) if history else None,
        **kw)
    return shape, prep, adv, dtype


@pytest.mark.parametrize("route", ["plan-lite", "entry", "field",
                                   "varprop fused", "varprop materialized",
                                   "bf16 g-stream", "reference"])
def test_engine_history_leaves_the_field_bit_for_bit(route):
    shape, prep, adv, dtype = _route_engine(route, history=False)
    _, prep_h, adv_h, _ = _route_engine(route, history=True)
    mask, T = _engine_case(7, shape)
    T0 = _t(T).to(dtype)
    off = adv(T0, prep(_t(mask)), 0.05, 3, 0.25)
    pk = T0.clone()
    ta = torch.zeros((2,) + shape, dtype=torch.promote_types(dtype,
                                                             torch.float32))
    on, (pk2, ta2) = adv_h(T0, prep_h(_t(mask)), 0.05, 3, 0.25, (pk, ta))
    assert torch.equal(on, off) and pk2 is pk and ta2 is ta
    assert torch.equal(pk, torch.maximum(T0, pk))
    assert ta.dtype == torch.promote_types(dtype, torch.float32)
    # t_above counts 0, 1, 2 or 3 sub-steps of dt at float32 or above
    dt = float(torch.tensor(0.05, dtype=ta.dtype))
    assert set(np.unique(np.round(ta.double().numpy() / dt, 6))) <= {
        0.0, 1.0, 2.0, 3.0}
    assert not adv.has_source and not adv_h.has_source


# ---------------------------------------------------------------------------
# EventLoop: interpass dwell, resume, refusals
# ---------------------------------------------------------------------------

def _loop_case():
    """A 12x10x12 block printed in 4 layers of 3 cells on a 3-cell plate,
    0.3 s a layer; engines of both packages."""
    shape = (12, 10, 12)
    act = np.full(shape, np.inf)
    act[:, :, :3] = -np.inf
    for j in range(4):
        act[2:10, 2:8, 3 + 3 * j:6 + 3 * j] = 0.3 * j
    return shape, act


def _engines(shape, history=None):
    jp, ja = jeng.make_cartesian_engine(
        JGrid(*shape, 1e-3), JMaterial(RHO, CP, K), theta=0.5, t_inf=20.0,
        robin_h=80.0, implementation="xla", dtype=jnp.float64,
        history_t_crit=history)
    pp, pa = peng.make_cartesian_engine(
        CartesianGrid(*shape, 1e-3), Material(RHO, CP, K),
        implementation="kernels", device="cpu", dtype=torch.float64,
        t_inf=20.0, robin_h=80.0, history_t_crit=history)
    return (jp, ja), (pp, pa)


def test_event_loop_interpass_dwell_matches_jax():
    shape, act = _loop_case()
    (jp, ja), (pp, pa) = _engines(shape)
    kw = dict(deposit_T=1500.0, dt_cap=0.04)
    dwell = dict(interpass_T=1000.0, interpass_dwell=0.15,
                 interpass_max_dwell=0.6)
    jl = jeng.EventLoop(advance=ja, prepare=jp,
                        activation_times=jnp.asarray(act), **kw, **dwell)
    want, _, t_j = jl.run(jnp.full(shape, 20.0), frame_times=[0.0, 1.2])
    pl = peng.EventLoop(advance=pa, prepare=pp, activation_times=_t(act),
                        **kw, **dwell)
    T0 = torch.full(shape, 20.0, dtype=torch.float64)
    got, _, t_p = pl.run(T0, frame_times=[0.0, 1.2])
    assert pl.dwell_log == jl.dwell_log and t_p == t_j
    # one layer dwells part of the cap, one the whole cap
    assert [d for _, d in pl.dwell_log] == [0.15, 0.6]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    plain = peng.EventLoop(advance=pa, prepare=pp, activation_times=_t(act),
                           **kw)
    plain.run(T0, frame_times=[0.0, 1.2])
    assert plain.dwell_log is None
    # each dwell increment is ceil(0.15 / 0.04) = 4 sub-steps
    assert pl.substeps == plain.substeps + 4 * (1 + 4)


def test_event_loop_resume_equals_the_straight_run():
    shape, act = _loop_case()
    _, (pp, pa) = _engines(shape, history=(800.0, 500.0))
    kw = dict(advance=pa, prepare=pp, activation_times=_t(act),
              deposit_T=1500.0, dt_cap=0.04, history=True)
    T0 = torch.full(shape, 20.0, dtype=torch.float64)
    straight = peng.EventLoop(**kw)
    T_s, a_s, _ = straight.run(T0, frame_times=[0.0, 0.45, 1.2])
    first = peng.EventLoop(**kw)
    T_h, _, t_h = first.run(T0, frame_times=[0.0, 0.45], t_end=0.45)
    hist = tuple(x.clone() for x in first.history_state)
    second = peng.EventLoop(**kw)
    T_r, a_r, _ = second.run(T_h, frame_times=[0.0, 0.45, 1.2],
                             start_t=t_h, history_state=hist)
    assert torch.equal(T_r, T_s) and torch.equal(a_r, a_s)
    for x, y in zip(second.history_state, straight.history_state):
        assert torch.equal(x, y)
    # the state handed in was copied, not updated in place
    assert all(torch.equal(x, y) for x, y in zip(hist,
                                                 first.history_state))
    assert first.substeps + second.substeps == straight.substeps


def test_event_loop_refusals():
    shape, act = _loop_case()
    _, (pp, pa) = _engines(shape)
    T0 = torch.full(shape, 20.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="interpass_dwell must be positive"):
        peng.EventLoop(advance=pa, prepare=pp, activation_times=_t(act),
                       deposit_T=1500.0, dt_cap=0.04, interpass_T=300.0,
                       interpass_dwell=0.0).run(T0, frame_times=[1.0])
    src = peng.make_cartesian_advance(
        CartesianGrid(*shape, 1e-3), Material(RHO, CP, K),
        implementation="kernels", device="cpu",
        source_fn=lambda t: torch.zeros(shape, dtype=torch.float64))
    assert src.has_source
    with pytest.raises(ValueError, match="continuous source_fn"):
        peng.EventLoop(advance=src, activation_times=_t(act),
                       deposit_T=1500.0, dt_cap=0.04,
                       interpass_T=300.0).run(T0, frame_times=[1.0])
    with pytest.raises(ValueError, match="requires prepare"):
        peng.EventLoop(advance=src, activation_times=_t(act),
                       deposit_T=1500.0, dt_cap=0.04,
                       history=True).run(T0, frame_times=[1.0])


def test_make_cartesian_advance_matches_jax():
    """The fused convenience form with a T-dependent film (robin_h_fn:
    the radiative film with a convective part), without prepare."""
    shape, act = _loop_case()
    eps = 0.5
    ja = jeng.make_cartesian_advance(
        JGrid(*shape, 1e-3), JMaterial(RHO, CP, K), t_inf=20.0,
        implementation="xla",
        robin_h_fn=lambda T: j_radiative_h(T, eps, 20.0, h_conv=30.0))
    pa = peng.make_cartesian_advance(
        CartesianGrid(*shape, 1e-3), Material(RHO, CP, K),
        implementation="kernels", device="cpu", t_inf=20.0,
        robin_h_fn=lambda T: radiative_h(T, eps, 20.0, h_conv=30.0))
    kw = dict(deposit_T=1500.0, dt_cap=0.04)
    want, _, _ = jeng.EventLoop(advance=ja, activation_times=jnp.asarray(act),
                                **kw).run(jnp.full(shape, 20.0),
                                          frame_times=[0.0, 1.0])
    loop = peng.EventLoop(advance=pa, activation_times=_t(act), **kw)
    got, _, _ = loop.run(torch.full(shape, 20.0, dtype=torch.float64),
                         frame_times=[0.0, 1.0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert loop.substeps > 0


# ---------------------------------------------------------------------------
# the WAAM app: history, VTK, checkpoints, resume, interpass
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def box_stl(tmp_path_factory):
    stl = str(tmp_path_factory.mktemp("stl") / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    return stl


def _waam(stl, *extra):
    # 4 layers of 0.75 s on the 6x6x8 mm box of tests/test_torch_waam.py
    return ["--stl", stl, "--dx_mm", "1", "--precision", "float64",
            "--bead_height_mm", "2", *extra]


def _run_waam(side, argv):
    if side == "jax":
        return jax_waam.run(jax_waam.build_argparser().parse_args(argv))
    return port_waam.run(port_waam.build_argparser().parse_args(
        argv + ["--device", "cpu"]))


HIST = ("--history_t_crit", "800,500")


@pytest.fixture(scope="module")
def waam_runs(box_stl, tmp_path_factory):
    """The JAX app's straight print (3 s and a 3 s hold, 5 frames) and its
    first 3 s (3 frames: the same events up to 3 s) with checkpoints."""
    d = tmp_path_factory.mktemp("waam")
    first = str(d / "jax_first.npz")
    _run_waam("jax", _waam(box_stl, *HIST, "--nframes", "3", "--save_vtk",
                           "1", "--outdir", str(d / "jax_first"),
                           "--checkpoint", first))
    straight = str(d / "jax_straight.npz")
    res = _run_waam("jax", _waam(box_stl, *HIST, "--nframes", "5",
                                 "--t_hold_s", "3", "--outdir",
                                 str(d / "jax_straight"), "--checkpoint",
                                 straight))
    return d, first, res, jck.load_checkpoint(straight)


def test_waam_history_vtk_and_checkpoint_match_jax(box_stl, waam_runs):
    d, first, _, _ = waam_runs
    out = str(d / "port_first")
    ck = str(d / "port_first.npz")
    got = _run_waam("port", _waam(box_stl, *HIST, "--nframes", "3",
                                  "--save_vtk", "1", "--outdir", out,
                                  "--checkpoint", ck))
    want, mine = jck.load_checkpoint(first), pck.load_checkpoint(ck)
    assert mine.t == want.t == got["t"] == 3.0
    np.testing.assert_allclose(got["T"].numpy(), want.T, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(mine.active, want.active)
    assert sorted(mine.meta) == sorted(want.meta)
    for k in ("history_peak", "history_above"):
        np.testing.assert_allclose(mine.meta[k], want.meta[k], rtol=0,
                                   atol=ATOL)
    np.testing.assert_array_equal(mine.meta["history_crits"], [800, 500])
    # the VTK frames and the history file: the JAX app's names and bytes
    names = sorted(os.listdir(str(d / "jax_first")))
    assert sorted(os.listdir(out)) == names and "waam_history.vtk" in names
    assert len(names) == 4
    for name in names:
        assert filecmp.cmp(os.path.join(out, name),
                           str(d / "jax_first" / name), shallow=False), name
    hist = pvtk.read_vtk_structured_points(os.path.join(out,
                                                        "waam_history.vtk"))
    a = hist["Mask"] > 0.5
    assert sorted(hist) == ["Mask", "T_peak", "t_above_500", "t_above_800"]
    assert (hist["T_peak"][a] >= 1499.9).all()
    assert not hist["T_peak"][~a].any() and not hist["t_above_800"][~a].any()
    assert (hist["t_above_500"] >= hist["t_above_800"]).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_waam_resume_matches_the_jax_straight_run(box_stl, waam_runs,
                                                  writer):
    d, first, res, straight = waam_runs
    if writer == "port":
        first = str(d / "port_for_resume.npz")
        _run_waam("port", _waam(box_stl, *HIST, "--nframes", "3",
                                "--checkpoint", first, "--outdir",
                                str(d / "port_for_resume")))
    got = _run_waam("port", _waam(box_stl, *HIST, "--nframes", "5",
                                  "--t_hold_s", "3", "--resume", first,
                                  "--outdir", str(d / f"resumed_{writer}")))
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(res["T"]),
                               rtol=0, atol=ATOL)
    pk, ta = got["history"]
    np.testing.assert_allclose(pk.numpy(), straight.meta["history_peak"],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), straight.meta["history_above"],
                               rtol=0, atol=ATOL)
    assert [f[0] for f in got["frames"]] == [3.0, 4.5, 6.0]


@pytest.mark.parametrize("crits,match", [("800", "does not match"),
                                         ("800,400", "!= --history_t_crit")])
def test_waam_resume_refuses_other_thresholds(box_stl, waam_runs, crits,
                                              match):
    _, first, _, _ = waam_runs
    with pytest.raises(SystemExit, match=match):
        _run_waam("port", _waam(box_stl, "--history_t_crit", crits,
                                "--nframes", "5", "--t_hold_s", "3",
                                "--resume", first))


def test_waam_interpass_matches_jax(box_stl, tmp_path):
    argv = _waam(box_stl, "--nframes", "3", "--interpass_T", "1000",
                 "--interpass_dwell_s", "0.5", "--interpass_max_dwell_s",
                 "2", "--outdir", str(tmp_path))
    want = _run_waam("jax", argv)
    got = _run_waam("port", argv)
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(want["T"]),
                               rtol=0, atol=ATOL)
    assert [t for t, _ in got["dwell_log"]] == [0.75, 1.5, 2.25]


# ---------------------------------------------------------------------------
# the spiral app: interrupt and resume, VTK
# ---------------------------------------------------------------------------

# tests/test_io_apps.py::test_spiral_tube_app_checkpoint_resume's tube
SPIRAL = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
          "--z_back", "8", "--nr", "4", "--nphi", "16", "--dz", "2",
          "--pitch", "2", "--speed", "40", "--dt_fixed", "0.2",
          "--nframes", "2", "--precision", "float64",
          "--latent_J_kg", "250000", "--history_t_crit", "800,500",
          "--history_out", "", "--out", ""]


def _spiral(side, *extra):
    argv = SPIRAL + list(extra)
    if side == "jax":
        return jax_spiral.run(jax_spiral.build_argparser().parse_args(argv))
    return port_spiral.run(port_spiral.build_argparser().parse_args(
        argv + ["--device", "cpu"]))


def test_spiral_interrupt_and_resume_match_jax(tmp_path):
    ck = str(tmp_path / "ck.npz")
    _spiral("port", "--t_tot", "1", "--checkpoint", ck)
    resumed = _spiral("port", "--t_tot", "2", "--resume", ck, "--vtk",
                      str(tmp_path / "port.vtk"), "--history_out",
                      str(tmp_path / "port_hist.npz"))
    want = _spiral("jax", "--t_tot", "2", "--vtk", str(tmp_path / "jax.vtk"),
                   "--history_out", str(tmp_path / "jax_hist.npz"))
    assert resumed["steps_run"] == 5
    np.testing.assert_allclose(resumed["T"].numpy(), np.asarray(want["T"]),
                               rtol=0, atol=1e-12)
    for k in ("peak", "t_above"):
        np.testing.assert_allclose(resumed["history"][k],
                                   want["history"][k], rtol=0, atol=1e-12)
    assert (resumed["history"]["t_above"] > 0).any()
    assert filecmp.cmp(str(tmp_path / "port.vtk"), str(tmp_path / "jax.vtk"),
                       shallow=False)
    with np.load(str(tmp_path / "port_hist.npz")) as a, \
            np.load(str(tmp_path / "jax_hist.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_allclose(a["t_above"], b["t_above"], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("extra,match", [
    (["--dt_fixed", "0.3"], "resume needs the same dt"),
    (["--history_t_crit", "800"], "1 thresholds|has 2 thresholds"),
    (["--history_t_crit", "800,400"], "!= --history_t_crit")])
def test_spiral_resume_guards(tmp_path, extra, match):
    ck = str(tmp_path / "ck.npz")
    _spiral("port", "--t_tot", "1", "--checkpoint", ck)
    with pytest.raises(SystemExit, match=match):
        _spiral("port", "--t_tot", "2", "--resume", ck, *extra)


def test_spiral_resume_without_history_in_the_checkpoint(tmp_path):
    ck = str(tmp_path / "ck.npz")
    argv = [a for a in SPIRAL if a not in ("--history_t_crit", "800,500")]
    port_spiral.run(port_spiral.build_argparser().parse_args(
        argv + ["--t_tot", "1", "--checkpoint", ck, "--device", "cpu"]))
    with pytest.raises(SystemExit, match="carries no thermal-history"):
        _spiral("port", "--t_tot", "2", "--resume", ck)


# ---------------------------------------------------------------------------
# the single-track app and its torch
# ---------------------------------------------------------------------------

# tests/test_io_apps.py::test_single_track_with_goldak_torch's plate
TRACK = ["--plate_x_mm", "10", "--plate_y_mm", "14", "--plate_z_mm", "3",
         "--dx_mm", "1", "--track_len_mm", "6", "--t_tail", "0.2",
         "--nframes", "2", "--precision", "float64", "--out", ""]
GOLDAK = ["--goldak_power", "1500"]


def _track(side, *extra):
    argv = TRACK + list(extra)
    if side == "jax":
        return jax_track.run(jax_track.build_argparser().parse_args(argv))
    return port_track.run(port_track.build_argparser().parse_args(
        argv + ["--device", "cpu"]))


@pytest.fixture(scope="module")
def jax_tracks():
    """The JAX app without the torch, with it (its float32 field) and with
    its field built at float64, as the port builds it at a float64
    state."""
    out = {"birth": _track("jax"), "goldak f32": _track("jax", *GOLDAK)}
    orig = jhs.goldak_source
    try:
        jhs.goldak_source = (lambda grid, g, center, dtype=None:
                             orig(grid, g, center, dtype=jnp.float64))
        out["goldak"] = _track("jax", *GOLDAK)
    finally:
        jhs.goldak_source = orig
    return out


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("case", ["birth", "goldak"])
def test_single_track_matches_jax(jax_tracks, case, impl):
    want = jax_tracks[case]
    got = _track("port", *(GOLDAK if case == "goldak" else []),
                 "--implementation", impl)
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(want["T"]),
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got["active"].numpy(),
                                  np.asarray(want["active"]))
    assert len(got["frames"]) == len(want["frames"]) == 2
    for (t1, T1, a1), (t2, T2, a2) in zip(got["frames"], want["frames"]):
        assert t1 == t2
        np.testing.assert_array_equal(a1, np.asarray(a2))
        np.testing.assert_allclose(T1, np.asarray(T2), rtol=0, atol=ATOL)
    assert got["substeps"] > 0


def test_single_track_torch_heats_and_parts_from_jax_by_its_f32_source(
        jax_tracks):
    cold = _track("port")
    hot = _track("port", *GOLDAK)
    _, T0, a = cold["frames"][-1]
    _, T1, _ = hot["frames"][-1]
    assert np.nanmean(np.where(a, T1, np.nan)) \
        > np.nanmean(np.where(a, T0, np.nan)) + 5.0
    assert np.isfinite(T1[a]).all()
    d = np.abs(hot["T"].numpy() - np.asarray(jax_tracks["goldak f32"]["T"]))
    assert 1e-6 < d.max() <= 5e-3


def test_single_track_writes_vtk_and_gif(tmp_path):
    gif = str(tmp_path / "track.gif")
    res = port_track.run(port_track.build_argparser().parse_args(
        TRACK[:-2] + ["--out", gif, "--save_vtk", "1", "--outdir",
                      str(tmp_path / "vtk"), "--device", "cpu"]))
    assert os.path.getsize(gif) > 0
    names = sorted(os.listdir(str(tmp_path / "vtk")))
    assert names == ["track_00000.000.vtk", "track_00000.950.vtk"]
    back = pvtk.read_vtk_structured_points(str(tmp_path / "vtk" / names[-1]))
    np.testing.assert_allclose(back["Temperature"], res["T"].numpy(),
                               rtol=1e-5)
    # the viewer reads the frames (Agg: no window)
    import matplotlib
    matplotlib.use("Agg")
    viewer.main(["--dir", str(tmp_path / "vtk")])


def test_single_track_refuses_cuda_when_absent():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    args = port_track.build_argparser().parse_args(TRACK)
    assert args.device == "cuda" and args.implementation == "kernels"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_track.run(args)


@pytest.mark.parametrize("axis", [0, 1])
def test_goldak_and_gaussian_sources_match_jax(axis):
    jg, pg = JGrid(9, 11, 7, 1e-3, dz=0.5e-3), \
        CartesianGrid(9, 11, 7, 1e-3, dz=0.5e-3)
    g = dict(power=1500.0, a_f=2e-3, a_r=4e-3, b=2e-3, c=1.5e-3,
             travel_axis=axis)
    center = (4.3e-3, 5.1e-3, 2.0e-3)
    want = jhs.goldak_source(jg, jhs.GoldakSource(**g), center,
                             dtype=jnp.float64)
    got = phs.goldak_source(pg, phs.GoldakSource(**g), center,
                            device="cpu", dtype=torch.float64)
    assert got.shape == (9, 11, 7) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)
    radii = (2e-3, 3e-3, 1e-3) if axis else (1e-3, 1e-3, 1e-3)
    want = jhs.gaussian_ellipsoid_source(jg, 900.0, center, radii,
                                         dtype=jnp.float64)
    got = phs.gaussian_ellipsoid_source(pg, 900.0, center, radii,
                                        device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)


# ---------------------------------------------------------------------------
# the numpy copies and the small torch pieces
# ---------------------------------------------------------------------------

def test_birth_layers_match_jax():
    kw = dict(iz_base=3, cells_per_layer=2)
    np.testing.assert_array_equal(
        players.layer_activation_times(14, n_layers=7, t_step=1.5,
                                       t_first=0.25, **kw),
        jlayers.layer_activation_times(14, n_layers=7, t_step=1.5,
                                       t_first=0.25, **kw))
    np.testing.assert_array_equal(
        players.activation_times_from_layer_times(
            12, layer_times=[0.0, 2.0, 3.5, 9.0, 11.0], **kw),
        jlayers.activation_times_from_layer_times(
            12, layer_times=[0.0, 2.0, 3.5, 9.0, 11.0], **kw))
    np.testing.assert_array_equal(
        players.track_activation_times(20, y_start=4, n_columns=30,
                                       dt_per_column=0.125, t_first=1e-9),
        jlayers.track_activation_times(20, y_start=4, n_columns=30,
                                       dt_per_column=0.125, t_first=1e-9))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_shapes_and_perimeter_match_jax(axis):
    m = pshapes.cylinder_mask(13, 11, 9, 1e-3, 4.2e-3, axis=axis)
    np.testing.assert_array_equal(
        m, jshapes.cylinder_mask(13, 11, 9, 1e-3, 4.2e-3, axis=axis))
    np.testing.assert_array_equal(pshapes.plate_mask(5, 6, 7, 3),
                                  jshapes.plate_mask(5, 6, 7, 3))
    sec = np.moveaxis(m, axis, -1)[:, :, 0]
    assert pperim.digital_perimeter(sec, 1e-3) == \
        jperim.digital_perimeter(sec, 1e-3)
    assert pperim.perimeter_correction_factor(sec, 1e-3, 0.026) == \
        jperim.perimeter_correction_factor(sec, 1e-3, 0.026)


def test_slices_match_jax():
    jmesh = j_cylinder_mesh(radius=4.0, height=6.0, n_phi=48,
                            center=(5.0, 5.0, 3.0))
    mesh = TriMesh(np.asarray(jmesh.triangles))
    for z in (0.7, 3.0, 5.5):
        np.testing.assert_array_equal(pslices.section_segments(mesh, z),
                                      jslices.section_segments(jmesh, z))
        assert pslices.slice_perimeter_area(mesh, z) == \
            jslices.slice_perimeter_area(jmesh, z)
    mask = np.zeros((10, 10, 6), bool)
    mask[1:9, 1:9, :] = pshapes.cylinder_mask(8, 8, 6, 1.0, 4.0)
    np.testing.assert_array_equal(
        pslices.per_slice_perimeter_scale(mesh, mask, (0.0, 0.0, 0.0), 1.0),
        jslices.per_slice_perimeter_scale(jmesh, mask, (0.0, 0.0, 0.0), 1.0))


@pytest.mark.parametrize("face", ["x-", "x+", "y-", "y+", "z-", "z+"])
def test_apply_surface_impulse_matches_jax(face):
    rng = np.random.default_rng(9)
    mask = rng.random((6, 7, 8)) > 0.3
    T = 20.0 + 500.0 * rng.random((6, 7, 8))
    want = j_impulse(jnp.asarray(T), jnp.asarray(mask),
                     JGrid(6, 7, 8, 1e-3, dz=0.5e-3), JMaterial(RHO, CP, K),
                     2.5e4, face=face)
    got = apply_surface_impulse(_t(T), _t(mask),
                                CartesianGrid(6, 7, 8, 1e-3, dz=0.5e-3),
                                Material(RHO, CP, K), 2.5e4, face=face)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert (got.numpy() != T).any()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_thomas_along_axis_matches_jax(axis):
    rng = np.random.default_rng(axis)
    shape = (5, 6, 7)
    a, c = -rng.random(shape), -rng.random(shape)
    b = 2.5 + rng.random(shape)
    d = rng.random(shape)
    want = j_thomas_along_axis(*(jnp.asarray(v) for v in (a, b, c, d)),
                               axis)
    got = thomas_along_axis(*(_t(v) for v in (a, b, c, d)), axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


def test_time_controls_match_jax():
    for kw in (dict(dt=1), dict(dt=0.05, theta=1, scheme="Douglas")):
        p, j = TimeControls(**kw), JTime(**kw)
        assert (p.dt, p.theta, p.scheme) == (j.dt, j.theta, j.scheme)
        assert type(p.dt) is float and type(p.theta) is float
