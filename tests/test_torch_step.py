"""The port's Cartesian ADI step against the JAX package's, on the CPU.

* ``adi_step`` (plain reference) against JAX ``adi_step`` at theta 0.5
  and 1, on random masks and on the BC set of __graft_entry__.entry
  (Robin sides, Neumann top flux) at a reduced size;
* ``adi_step_fused`` (the kernel path; plain versions on the CPU) against
  JAX ``adi_step_pallas(interpret=True)`` for the plan-lite and field
  plans, and with Dirichlet pins;
* the lite and field plans agree bitwise in the port;
* convert.py carries JAX state across bit for bit.

Tolerance: 1e-10 K absolute at float64 on fields up to 1500 C.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import Material as JMaterial
from adi_thermal_fields_tpu import adi_step_cartesian as j_adi_step
from adi_thermal_fields_tpu import build_coeff_packs as j_packs
from adi_thermal_fields_tpu.step.cartesian_pallas import (
    adi_step_pallas as j_adi_step_pallas)
from adi_thermal_fields_tpu.step.cartesian_pallas import (
    build_sweep_plan as j_build_plan)

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          adi_step_cartesian, adi_step_fused,
                                          build_coeff_packs, build_sweep_plan)
from adi_thermal_fields_tpu_torch.convert import (field_from_numpy,
                                                  packs_from_numpy,
                                                  plan_from_numpy)

torch.set_num_threads(1)

ATOL = 1e-10
RHO, CP, K = 7800.0, 490.0, 54.0
DT = 0.05


def _grid(shape, dz=None):
    return (JGrid(*shape, 1e-3, dz=dz), CartesianGrid(*shape, 1e-3, dz=dz))


def _random_case(shape, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.25
    T = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    return mask, T


def _entry_case(n=20):
    """The entry configuration (__graft_entry__.entry) cut to n^3:
    a plate, void above, and a deposited block on it."""
    mask = np.ones((n, n, n), bool)
    top = 3 * n // 4
    mask[:, :, top:] = False
    mask[n // 3:2 * n // 3, n // 3:2 * n // 3, top:top + 2] = True
    T = np.where(mask, 900.0, 20.0)
    return mask, T


BCS = {
    "robin": dict(robin_h=200.0),
    "entry": dict(robin_h=200.0, neumann={"z+": 5e5}),
}


def _both_packs(mask, grids, bcs, dirm=None):
    jg, pg = grids
    jd, pd = {}, {}
    if dirm is not None:
        jd = dict(dirichlet_mask=jnp.asarray(dirm), dirichlet_value=77.0)
        pd = dict(dirichlet_mask=torch.from_numpy(dirm), dirichlet_value=77.0)
    jp = j_packs(jnp.asarray(mask), jg, JMaterial(RHO, CP, K),
                 dtype=jnp.float64, **bcs, **jd)
    pp = build_coeff_packs(torch.from_numpy(mask), pg, Material(RHO, CP, K),
                           dtype=torch.float64, **bcs, **pd)
    return jp, pp


def _lite_const(h, grid):
    return tuple(float(np.float64(h) * np.float64(1.0 / (RHO * CP * d)))
                 for d in grid.spacing)


@pytest.mark.parametrize("theta", [0.5, 1.0])
@pytest.mark.parametrize("case", ["random", "entry"])
def test_adi_step_matches_jax(theta, case):
    if case == "random":
        mask, T = _random_case((12, 10, 14), seed=1)
        grids = _grid(mask.shape, dz=0.8e-3)
        bcs = BCS["robin"]
    else:
        mask, T = _entry_case()
        grids = _grid(mask.shape)
        bcs = BCS["entry"]
    jp, pp = _both_packs(mask, grids, bcs)
    ref = j_adi_step(jnp.asarray(T), jnp.asarray(mask), jp, grids[0],
                     JMaterial(RHO, CP, K), dt=jnp.float64(DT), theta=theta,
                     t_inf=20.0)
    got = adi_step_cartesian(torch.from_numpy(T), torch.from_numpy(mask), pp,
                             grids[1], Material(RHO, CP, K), dt=DT,
                             theta=theta, t_inf=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("plan", ["lite", "field", "entry", "dirichlet"])
def test_adi_step_fused_matches_jax_pallas(plan):
    mask, T = (_entry_case(16) if plan == "entry"
               else _random_case((12, 10, 14), seed=3))
    grids = _grid(mask.shape, dz=None if plan == "entry" else 0.8e-3)
    bcs = dict(BCS["entry" if plan == "entry" else "robin"])
    dirm = None
    if plan == "dirichlet":
        dirm = np.zeros(mask.shape, bool)
        dirm[:, :, 0] = mask[:, :, 0]
        bcs["neumann"] = {"x-": 3e5}
    jp, pp = _both_packs(mask, grids, bcs, dirm)
    lite = plan == "lite"
    rc = _lite_const(200.0, grids[1]) if lite else None
    jplan = j_build_plan(jnp.asarray(mask), None if lite else jp,
                         robin_const=None if rc is None else jnp.asarray(rc))
    pplan = build_sweep_plan(torch.from_numpy(mask), None if lite else pp,
                             robin_const=rc)
    ref = j_adi_step_pallas(jnp.asarray(T), jplan, grids[0],
                            JMaterial(RHO, CP, K), dt=DT, theta=0.5,
                            t_inf=20.0, interpret=True)
    got = adi_step_fused(torch.from_numpy(T), pplan, grids[1],
                         Material(RHO, CP, K), dt=DT, theta=0.5, t_inf=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("dz", [None, 0.8e-3], ids=["cubic", "aniso"])
def test_lite_plan_equals_field_plan_bitwise(dz):
    """Scalar h through the plan-lite path (K4, K1, K2) and through the
    coefficient fields (K3, K1 x3) gives the same bits: the lite constant
    uses the packs' op order."""
    mask, T = _random_case((11, 13, 9), seed=4)
    grid = CartesianGrid(*mask.shape, 1e-3, dz=dz)
    mat = Material(RHO, CP, K)
    packs = build_coeff_packs(torch.from_numpy(mask), grid, mat,
                              dtype=torch.float64, robin_h=200.0)
    lite = build_sweep_plan(torch.from_numpy(mask), None,
                            robin_const=_lite_const(200.0, grid))
    field = build_sweep_plan(torch.from_numpy(mask), packs)
    a = adi_step_fused(torch.from_numpy(T), lite, grid, mat, dt=DT,
                       t_inf=20.0)
    b = adi_step_fused(torch.from_numpy(T), field, grid, mat, dt=DT,
                       t_inf=20.0)
    assert torch.equal(a, b)


@pytest.mark.parametrize("plan", ["lite", "field"])
def test_convert_round_trip(plan):
    """JAX packs, plan and field carried across equal the port's own, bit
    for bit, and step identically."""
    mask, T = _random_case((9, 10, 11), seed=6)
    grids = _grid(mask.shape)
    jp, pp = _both_packs(mask, grids, BCS["entry"] if plan == "field"
                         else BCS["robin"])
    packs = packs_from_numpy(*(np.asarray(a) for a in jp), device="cpu")
    for a, b in zip(packs, pp):
        assert torch.equal(a, b)

    rc = _lite_const(200.0, grids[1]) if plan == "lite" else None
    jplan = j_build_plan(jnp.asarray(mask), None if rc else jp,
                         robin_const=None if rc is None else jnp.asarray(rc))
    conv = plan_from_numpy(
        np.asarray(jplan.mask), [np.asarray(c) for c in jplan.codes],
        None if jplan.coeffs is None
        else [np.asarray(c) for c in jplan.coeffs],
        None if jplan.qfluxes is None
        else [np.asarray(c) for c in jplan.qfluxes],
        None, None if jplan.rob_c is None else np.asarray(jplan.rob_c),
        device="cpu")
    native = build_sweep_plan(torch.from_numpy(mask), None if rc else pp,
                              robin_const=rc)
    # every input, z's too, in the natural (x, y, z) layout
    for t in (*conv.codes, *(conv.coeffs or ()), *(conv.qfluxes or ())):
        assert t.shape == mask.shape
    for a, b in zip(conv.codes, native.codes):
        assert a.dtype == torch.uint8 and torch.equal(a, b)
    for name in ("coeffs", "qfluxes"):
        ca, cb = getattr(conv, name), getattr(native, name)
        assert (ca is None) == (cb is None)
        if ca is not None:
            assert all(torch.equal(x, y) for x, y in zip(ca, cb))
    assert conv.rob_c == native.rob_c
    Tt = field_from_numpy(T, device="cpu")
    assert np.array_equal(Tt.numpy(), T)
    mat = Material(RHO, CP, K)
    assert torch.equal(
        adi_step_fused(Tt, conv, grids[1], mat, dt=DT, t_inf=20.0),
        adi_step_fused(Tt, native, grids[1], mat, dt=DT, t_inf=20.0))


def test_bfloat16_state_is_not_ported_yet():
    """bfloat16 states run now (the name records when they did not): the
    plan-lite step on a bfloat16 state stays bfloat16 and lies within one
    bfloat16 ulp of JAX ``adi_step_pallas`` on the same state (rounding
    to nearest; tests/test_torch_bf16.py holds the other plans)."""
    mask, T = _random_case((6, 5, 4), seed=8)
    grids = (JGrid(*mask.shape, 1e-3), CartesianGrid(*mask.shape, 1e-3))
    rc = _lite_const(200.0, grids[1])
    rc32 = tuple(float(np.float32(v)) for v in rc)
    plan = build_sweep_plan(torch.from_numpy(mask), None, robin_const=rc32)
    Tb = jnp.asarray(T, jnp.bfloat16)
    ref = np.asarray(j_adi_step_pallas(
        Tb, j_build_plan(jnp.asarray(mask), None,
                         robin_const=jnp.asarray(rc32, jnp.float32)),
        grids[0], JMaterial(RHO, CP, K), dt=DT, theta=0.5, t_inf=20.0,
        interpret=True).astype(jnp.float32))
    got = adi_step_fused(torch.from_numpy(np.array(
        Tb.astype(jnp.float32))).to(torch.bfloat16), plan, grids[1],
        Material(RHO, CP, K), dt=DT, t_inf=20.0)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    big = np.maximum(np.abs(got), np.abs(ref))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)


@pytest.mark.parametrize("bcs", ["robin", "entry", "dirichlet", "per_face"])
def test_engine_matches_jax_engine(bcs):
    """make_cartesian_engine, both implementations, against the JAX
    engine's XLA branch over 3 sub-steps.  Scalar h with Neumann and/or
    Dirichlet takes the plan-lite branch that still needs packs (K3, then
    K1 with the folds along x, y and the permuted z)."""
    from adi_thermal_fields_tpu.apps.engine import (
        make_cartesian_engine as j_engine)

    from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
    from adi_thermal_fields_tpu_torch.bc.faces import FACES

    mask, T = _entry_case(14)
    jg, pg = _grid(mask.shape, dz=0.8e-3)
    dirm = np.zeros(mask.shape, bool)
    dirm[:, :, 0] = True
    kw = {"robin": dict(robin_h=200.0),
          "entry": dict(robin_h=200.0, neumann={"z+": 5e5}),
          "dirichlet": dict(robin_h=200.0, neumann={"x-": 3e5},
                            dirichlet_value=77.0),
          "per_face": dict(robin_h={f: 150.0 + 10 * i
                                    for i, f in enumerate(FACES)})}[bcs]
    jkw, pkw = dict(kw), dict(kw)
    if bcs == "dirichlet":
        jkw["dirichlet_mask"] = jnp.asarray(dirm)
        pkw["dirichlet_mask"] = torch.from_numpy(dirm)
    prep_j, adv_j = j_engine(jg, JMaterial(RHO, CP, K), theta=0.5,
                             t_inf=20.0, implementation="xla",
                             dtype=jnp.float64, **jkw)
    ref = adv_j(jnp.asarray(T), prep_j(jnp.asarray(mask)), jnp.float64(DT),
                jnp.int32(3), jnp.float64(0.0))
    for impl in ("kernels", "reference"):
        prep, adv = make_cartesian_engine(
            pg, Material(RHO, CP, K), implementation=impl, device="cpu",
            dtype=torch.float64, theta=0.5, t_inf=20.0, **pkw)
        got = adv(torch.from_numpy(T), prep(torch.from_numpy(mask)), DT, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
