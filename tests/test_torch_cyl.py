"""The port's cylindrical spiral-tube path against the JAX package's.

Same inputs from one numpy seed go to both sides, at float64:

* ``CylindricalGrid`` radii and the spiral/ring activation times: exact;
* the masked-Robin plan against JAX ``plan.compressed`` (its z arrays moved
  back to the natural layout): codes exact, fields to 1e-14 relative;
* the plain versions of K9, K10 and K11 (the wrappers on CPU tensors)
  against JAX ``fused_masked_sweep`` (pipelined, streaming and
  ``nat_rhs_out`` forms) and ``fused_masked_cyclic_axis1`` in interpret
  mode: 1e-10 (the two sides solve the same recurrence with a different
  operation order, ~1e-13 apart);
* ``adi_step_masked_robin`` with both implementations, with and without a
  source, against JAX ``implementation="xla"`` and ``"pallas"``
  (interpret): 1e-10 K;
* ``apps/spiral_tube.run`` against the JAX app on the small tube of
  tests/test_io_apps.py, ``--out ""``, float64, ``--device cpu``: 1e-9 K;
* the app's refused flags, and the wrappers' CPU contract.

The CUDA kernels themselves are compared with their plain versions on the
card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CylindricalGrid as JGrid
from adi_thermal_fields_tpu import Material as JMat
from adi_thermal_fields_tpu import RobinBC as JRobin
from adi_thermal_fields_tpu import ZFaceBC as JZ
from adi_thermal_fields_tpu.apps import spiral_tube as jax_app
from adi_thermal_fields_tpu.birth import spiral as jspiral
from adi_thermal_fields_tpu.solvers.pallas_fields import (
    fused_masked_cyclic_axis1, fused_masked_sweep)
from adi_thermal_fields_tpu.solvers.thomas import cyclic_thomas as j_cyclic
from adi_thermal_fields_tpu.step.cylindrical_masked import (
    adi_step_masked_robin as j_step, build_masked_robin_plan as j_plan)

from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material, RobinBC,
                                          ZFaceBC, adi_step_masked_robin,
                                          build_masked_robin_plan)
from adi_thermal_fields_tpu_torch.apps import spiral_tube as port_app
from adi_thermal_fields_tpu_torch.birth import spiral
from adi_thermal_fields_tpu_torch.convert import masked_plan_from_jax
from adi_thermal_fields_tpu_torch.solvers import (
    KERNELS, cyclic_thomas, launch_counts, masked_cyclic_phi,
    masked_sweep_strided, masked_sweep_z, reset_launch_counts)

torch.set_num_threads(1)

ATOL = 1e-10                 # K, float64
MAT = (7800.0, 490.0, 54.0)
FAC, AMB = 0.37, 20.0        # kernel tests: fac*geo ~ O(1), as in a step
# (shape, r_inner, z bottom): annular with Dirichlet pins, full disk
CONFIGS = {"annular-dirichlet": ((6, 12, 10), 0.02, "dirichlet"),
           "disk-neumann0": ((8, 16, 24), 0.0, "neumann0")}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(config, seed=7):
    """Grids, mask, T, source and BCs of one configuration, both sides:
    Robin top, h_void != h_front, T_inf_top != T_inf_void."""
    shape, r_inner, kind_bot = CONFIGS[config]
    rng = np.random.default_rng(seed)
    geo = (*shape, 5e-4, 1e-3)
    act = rng.random(shape) > 0.35
    T = np.where(act, 50.0 + 850.0 * rng.random(shape), 20.0)
    src = rng.random(shape) * 1e6
    zkw = dict(kind_bot=kind_bot, T_bot=140.0, kind_top="robin",
               h_top=400.0, T_inf_top=25.0)
    bc = dict(h_void=80.0, T_inf_void=20.0, h_front=60.0)
    jbc = dict(robin_outer=JRobin(300.0, 20.0), zbc=JZ(**zkw),
               robin_inner=JRobin(150.0, 30.0), **bc)
    pbc = dict(robin_outer=RobinBC(300.0, 20.0), zbc=ZFaceBC(**zkw),
               robin_inner=RobinBC(150.0, 30.0), **bc)
    return (JGrid(*geo, r_inner=r_inner), CylindricalGrid(*geo,
                                                          r_inner=r_inner),
            act, T, src, jbc, pbc)


@pytest.mark.parametrize("r_inner", [0.0, 0.02])
def test_grid_and_schedules_match_jax(r_inner):
    jg, pg = JGrid(7, 20, 30, 5e-4, 4e-4, r_inner), \
        CylindricalGrid(7, 20, 30, 5e-4, 4e-4, r_inner)
    for name in ("r", "r_imh", "r_iph"):
        np.testing.assert_array_equal(getattr(pg, name), getattr(jg, name))
    assert (pg.shape, pg.dphi, pg.is_annular, pg.r_outer_face, pg.height) \
        == (jg.shape, jg.dphi, jg.is_annular, jg.r_outer_face, jg.height)
    for q in (1, 2):
        kw = dict(iz_base=6, layer_cells=4, n_layers=7, tau_dep=0.7,
                  loops_per_layer=q)
        act = spiral.spiral_activation_times(pg, **kw)
        np.testing.assert_array_equal(
            act, jspiral.spiral_activation_times(jg, **kw))
        for t0, t1 in ((0.0, 0.05), (0.7, 0.75), (3.1, 3.3)):
            np.testing.assert_array_equal(
                spiral.active_at(act, t1), np.asarray(jspiral.active_at(
                    jnp.asarray(act), t1)))
            np.testing.assert_array_equal(
                spiral.newborn_between(act, t0, t1),
                np.asarray(jspiral.newborn_between(jnp.asarray(act), t0,
                                                   t1)))
    kw = dict(iz_base=6, layer_cells=4, n_layers=9, tau_per_layer=1.5)
    np.testing.assert_array_equal(spiral.ring_activation_times(pg, **kw),
                                  jspiral.ring_activation_times(jg, **kw))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_masked_plan_matches_jax(config):
    jg, pg, act, _, _, jbc, pbc = _case(config)
    jp = j_plan(jg, JMat(*MAT), jnp.asarray(act), dtype=jnp.float64, **jbc)
    pp = build_masked_robin_plan(pg, Material(*MAT), _t(act), **pbc)
    ref = masked_plan_from_jax(jp)        # z arrays back to (r, phi, z)
    np.testing.assert_array_equal(pp.active.numpy(), act)
    assert pp.ambient == ref.ambient == 20.0
    for name in ("r", "phi", "z"):
        got, want = getattr(pp, name), getattr(ref, name)
        assert len(got) == len(want)
        assert got[0].dtype == want[0].dtype == torch.uint8
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        for g, w in zip(got[1:], want[1:]):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-14,
                                       atol=0)
    # every bit is used: pins (bottom Dirichlet) and both couplings
    codes = torch.cat([getattr(pp, n)[0].flatten() for n in ("r", "phi",
                                                             "z")])
    bits = {b for b in (1, 2, 4, 8) if bool(((codes & b) != 0).any())}
    assert bits == ({1, 2, 4, 8} if config.startswith("annular")
                    else {1, 2, 8})


def _random_rows(shape, axis, seed, periodic=False):
    """rhs, code (with pinned and void rows), sink, srhs for a sweep along
    ``axis``: void/pinned rows are identity rows, as a plan makes them."""
    rng = np.random.default_rng(seed)
    active = rng.random(shape) > 0.3
    pin = (rng.random(shape) > 0.9) & active
    live = active & ~pin
    if periodic:
        lowm = live & np.roll(live, 1, axis)
        highm = live & np.roll(live, -1, axis)
    else:
        n = shape[axis]
        idx = np.arange(n).reshape([-1 if a == axis else 1
                                    for a in range(len(shape))])
        lowm = live & np.roll(live, 1, axis) & (idx > 0)
        highm = live & np.roll(live, -1, axis) & (idx < n - 1)
    sink = np.where(live, rng.random(shape), 0.0)
    srhs = np.where(pin, 77.0, np.where(live, sink * 20.0, 0.0))
    rhs = rng.random(shape) * 900.0
    code = (lowm.astype(np.uint8) | (highm.astype(np.uint8) << 1)
            | (pin.astype(np.uint8) << 2) | (active.astype(np.uint8) << 3))
    return rhs, code, sink, srhs, rng


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "streaming"])
def test_k9_matches_jax_masked_sweep(pipelined):
    rhs, code, sink, srhs, rng = _random_rows((10, 6, 20), 0, seed=3)
    glo, ghi = 0.5 + rng.random(10), 0.5 + rng.random(10)
    ref = fused_masked_sweep(
        jnp.asarray(rhs), jnp.asarray(code.view(np.int8)), jnp.asarray(sink),
        jnp.asarray(glo), jnp.asarray(ghi), FAC, jnp.asarray(srhs), AMB,
        interpret=True, pipelined=pipelined)
    got = masked_sweep_strided(_t(rhs), _t(code), _t(sink), _t(srhs),
                               _t(glo), _t(ghi), FAC, AMB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_k10_matches_jax_natural_z_sweep():
    # natural (r, phi, z); the JAX z kernel reads code/sink/srhs as
    # (z, r, phi) and rhs/out in the natural layout
    rhs, code, sink, srhs, rng = _random_rows((5, 9, 40), 2, seed=4)
    glo, ghi = 0.5 + rng.random(40), 0.5 + rng.random(40)
    zf = (lambda a: jnp.asarray(np.moveaxis(a, 2, 0)))
    ref = fused_masked_sweep(
        jnp.asarray(rhs), zf(code.view(np.int8)), zf(sink), jnp.asarray(glo),
        jnp.asarray(ghi), FAC, zf(srhs), AMB, interpret=True,
        nat_rhs_out=True)
    got = masked_sweep_z(_t(rhs), _t(code), _t(sink), _t(srhs), _t(glo),
                         _t(ghi), FAC, AMB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("n", [3, 24])
def test_k11_matches_jax_masked_cyclic(n):
    rhs, code, sink, srhs, rng = _random_rows((5, n, 7), 1, seed=n,
                                              periodic=True)
    geo = 0.5 + rng.random((5, 7))
    ref = fused_masked_cyclic_axis1(
        jnp.asarray(rhs), jnp.asarray(code.view(np.int8)), jnp.asarray(sink),
        jnp.asarray(srhs), jnp.asarray(geo), FAC, AMB, interpret=True)
    got = masked_cyclic_phi(_t(rhs), _t(code), _t(sink), _t(srhs), _t(geo),
                            FAC, AMB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_cyclic_thomas_matches_jax():
    rng = np.random.default_rng(11)
    shape = (17, 4, 5)
    a, c = -rng.random(shape), -rng.random(shape)
    b = 2.5 + rng.random(shape)
    d = rng.random(shape) * 100.0
    ref = j_cyclic(*(jnp.asarray(v) for v in (a, b, c, d)))
    got = cyclic_thomas(*(_t(v) for v in (a, b, c, d)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


@functools.cache
def _jax_step(config, with_source, impl):
    jg, _, act, T, src, jbc, _ = _case(config)
    return np.asarray(j_step(
        jnp.asarray(T), jg, JMat(*MAT), dt=0.05, active=jnp.asarray(act),
        source=jnp.asarray(src) if with_source else None,
        implementation=impl, **jbc))


@pytest.mark.parametrize("with_source", [False, True],
                         ids=["no-source", "source"])
@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_masked_step_matches_jax(config, impl, with_source):
    _, pg, act, T, src, _, pbc = _case(config)
    got = adi_step_masked_robin(
        _t(T), pg, Material(*MAT), dt=0.05, active=_t(act),
        source=_t(src) if with_source else None, implementation=impl, **pbc)
    assert got.dtype == torch.float64
    for jimpl in ("xla", "pallas"):
        np.testing.assert_allclose(got.numpy(),
                                   _jax_step(config, with_source, jimpl),
                                   rtol=0, atol=ATOL)


# the small tube of tests/test_io_apps.py::test_spiral_tube_app_smoke
TUBE = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
        "--z_back", "8", "--nr", "4", "--nphi", "12", "--dz", "2",
        "--pitch", "2", "--auto_speed", "--t_tot", "2", "--dt_fixed", "0.2",
        "--nframes", "2", "--out", "", "--precision", "float64"]
# steps of 0.05 s are shorter than the 1/12 s between births: the plan is
# reused on steps without one
APP_CASES = {"tube": [], "torch": ["--torch_Q", "2000"],
             "short-steps": ["--dt_fixed", "0.05"]}


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("case", sorted(APP_CASES))
def test_spiral_app_matches_jax(case, impl):
    argv = TUBE + APP_CASES[case]
    ref = jax_app.run(jax_app.build_argparser().parse_args(argv))
    got = port_app.run(port_app.build_argparser().parse_args(
        argv + ["--device", "cpu", "--implementation", impl]))
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(ref["T"]),
                               rtol=0, atol=1e-9)
    assert len(got["frames"]) == len(ref["frames"]) == 2
    for (t1, T1, a1), (t2, T2, a2) in zip(got["frames"], ref["frames"]):
        assert t1 == t2
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_allclose(T1, np.asarray(T2), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got["active"], ref["frames"][-1][2][0])
    if case == "short-steps":
        assert 0 < got["plans_built"] < got["steps"] == 40


# the history, VTK and checkpoint flags run now
# (tests/test_torch_io_apps.py)
@pytest.mark.parametrize("flag,needs", [
    (["--mesh", "2x4"], "multi-device")])
def test_spiral_app_refuses_unported_flags(flag, needs):
    args = port_app.build_argparser().parse_args(
        TUBE + ["--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="not supported by the PyTorch port"
                       ) as exc:
        port_app.run(args)
    assert flag[-2] in str(exc.value) and needs in str(exc.value)


def test_spiral_app_refuses_cuda_when_absent():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    args = port_app.build_argparser().parse_args(TUBE)
    assert args.device == "cuda" and args.implementation == "kernels"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_app.run(args)


def test_masked_wrappers_cpu_contract():
    rhs, code, sink, srhs, rng = _random_rows((4, 6, 5), 1, seed=1,
                                              periodic=True)
    g = _t(0.5 + rng.random(4))
    args = (_t(rhs), _t(code), _t(sink), _t(srhs))
    reset_launch_counts()
    masked_sweep_strided(*args, g, g, FAC, AMB)
    masked_cyclic_phi(*args, _t(0.5 + rng.random((4, 5))), FAC, AMB)
    masked_sweep_z(*args, _t(0.5 + rng.random(5)), _t(0.5 + rng.random(5)),
                   FAC, AMB)
    assert launch_counts() == {k: 0 for k in KERNELS}
    with pytest.raises(ValueError, match="length >= 2"):
        masked_cyclic_phi(*(t[:, :1].contiguous() for t in args),
                          _t(np.ones((4, 5))), FAC, AMB)
    grad = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        masked_sweep_strided(grad, *args[1:], g, g, FAC, AMB)
