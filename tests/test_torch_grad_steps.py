"""The port's differentiable steps against the JAX package's, on the CPU.

Same inputs, made from a seed with numpy, go through the JAX step and the
port's at float64; the JAX Pallas kernels run in interpret mode
(the Functions themselves: tests/test_torch_grad.py).  Tolerances:

* F2: the plain and kernel steps take a 0-d tensor ``dt``; at float32 and
  float64 it gives the float ``dt``'s values bit for bit, and the
  gradient w.r.t. ``dt`` (and a tensor ``robin_h`` through
  ``build_coeff_packs``, a fitted k through a callable table) matches
  ``jax.grad`` of the JAX step: 1e-10 relative;
* ``adi_step_fused``'s gradient w.r.t. T and dt against ``jax.grad`` of
  ``adi_step_pallas`` with and without BCs (tests/test_pallas_sweeps.py:42
  config) and on the plan-lite route: 1e-9 relative;
* the cylindrical varprop kernels tier against JAX's ``pallas`` tier
  (tests/test_cyl_varprop.py:564 with callables: w.r.t. T and k0; tables
  on the tier-2 chain, as tests/test_vp2.py:247: w.r.t. T and dt):
  1e-9 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import CylindricalGrid as JCGrid
from adi_thermal_fields_tpu import Material as JMat
from adi_thermal_fields_tpu import RobinBC as JRobin
from adi_thermal_fields_tpu import ZFaceBC as JZ
from adi_thermal_fields_tpu.bc.packs import build_coeff_packs as j_packs
from adi_thermal_fields_tpu.step import cartesian as jc
from adi_thermal_fields_tpu.step import cartesian_pallas as jcp
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv
from adi_thermal_fields_tpu.step import cylindrical_varprop as jcvp

from adi_thermal_fields_tpu_torch import (CartesianGrid, CylindricalGrid,
                                          Material, RobinBC, ZFaceBC,
                                          adi_step_cartesian,
                                          adi_step_cyl_varprop,
                                          adi_step_fused, adi_step_varprop,
                                          apparent_cp, build_coeff_packs,
                                          build_sweep_plan,
                                          melt_pool_enhanced_k)

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-9
MAT = (7800.0, 490.0, 54.0)


def _t(a, grad=False):
    x = torch.from_numpy(np.array(a, dtype=np.float64))
    return x.requires_grad_(True) if grad else x


def _close(got, want, rtol=RTOL, what=""):
    """|got - want| <= rtol * max|want| (a field's scale, or a scalar)."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol:.0e} of {scale:.3e}"


def _pgrad(fn, args, w):
    ins = [a for a in args if torch.is_tensor(a) and a.requires_grad]
    return torch.autograd.grad((torch.as_tensor(w) * fn(*args)).sum(), ins)


def _jgrad(fn, args, argnums, w):
    return jax.jit(jax.grad(lambda *a: jnp.sum(jnp.asarray(w) * fn(*a)),
                            argnums=argnums))(*args)


# ---------------------------------------------------------------------------
# F2: a tensor dt (and tensor h, k) through the plain steps
# ---------------------------------------------------------------------------

def _cart_case(seed=11, shape=(6, 5, 7)):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.3
    T0 = np.where(mask, 20 + 880 * rng.random(shape), 20.0)
    return mask, T0, rng.standard_normal(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tensor_dt_gives_the_float_dt_values(dtype):
    mask_np, T_np, _ = _cart_case()
    grid, mat = CartesianGrid(6, 5, 7, 1e-3), Material(*MAT)
    mask = torch.from_numpy(mask_np)
    T = _t(T_np).to(dtype)
    packs = build_coeff_packs(mask, grid, mat, dtype=dtype, robin_h=250.0,
                              neumann={"z+": 2e5})
    plan = build_sweep_plan(mask, packs, has_neumann=True,
                            has_dirichlet=False)
    dtt = torch.tensor(0.02, dtype=F64)
    steps = (
        lambda dt: adi_step_cartesian(T, mask, packs, grid, mat, dt=dt,
                                      t_inf=20.0),
        lambda dt: adi_step_fused(T, plan, grid, mat, dt=dt, t_inf=20.0),
        lambda dt: adi_step_varprop(T, mask, packs, grid, mat, dt=dt,
                                    t_inf=20.0,
                                    k_table=melt_pool_enhanced_k(
                                        54.0, 400.0, 600.0, 4.0)))
    for step in steps:
        assert torch.equal(step(0.02), step(dtt))
    cg, _, act, Tc, kw = _cyl_case(dtype)
    for impl, tabs in (("kernels", dict(k_table=kw["k_table"])),
                       ("kernels", {}), ("reference", {})):
        kws = dict(kw, **tabs) if tabs else {
            k: v for k, v in kw.items() if k != "k_table"}
        a, b = (adi_step_cyl_varprop(Tc, cg, Material(*MAT), dt=dt,
                                     implementation=impl, **kws)
                for dt in (0.02, dtt))
        assert torch.equal(a, b)


def test_plain_step_grads_match_jax():
    """dL/dT0, dL/ddt and dL/dh (a tensor robin_h through
    build_coeff_packs) of two plain steps against jax.grad."""
    mask_np, T_np, w = _cart_case()
    pg, pm = CartesianGrid(6, 5, 7, 1e-3), Material(*MAT)
    jg, jm = JGrid(6, 5, 7, 1e-3), JMat(*MAT)

    def port(T, dt, h):
        packs = build_coeff_packs(torch.from_numpy(mask_np), pg, pm,
                                  dtype=F64, robin_h=h)
        for _ in range(2):
            T = adi_step_cartesian(T, torch.from_numpy(mask_np), packs, pg,
                                   pm, dt=dt, t_inf=20.0)
        return T

    def jx(T, dt, h):
        packs = j_packs(jnp.asarray(mask_np), jg, jm, robin_h=h)
        for _ in range(2):
            T = jc.adi_step(T, jnp.asarray(mask_np), packs, jg, jm, dt=dt,
                            t_inf=20.0)
        return T

    got = _pgrad(port, [_t(T_np, True), _t(0.03, True), _t(150.0, True)], w)
    want = _jgrad(jx, [jnp.asarray(T_np), 0.03, 150.0], (0, 1, 2), w)
    for name, g, j in zip(("T0", "dt", "h"), got, want):
        _close(g, j, 1e-10, name)


def test_varprop_reference_grads_match_jax():
    """The varprop reference step with a callable k(T) closing over a
    fitted k0, and a tensor dt, against the JAX "xla" step."""
    mask_np, T_np, w = _cart_case(seed=5)
    pg, pm = CartesianGrid(6, 5, 7, 1e-3), Material(*MAT)
    jg, jm = JGrid(6, 5, 7, 1e-3), JMat(*MAT)
    ct_p = apparent_cp(490.0, 490.0, 2.7e5, 400.0, 600.0)
    ct_j = jcv.apparent_cp(490.0, 490.0, 2.7e5, 400.0, 600.0)
    mask_p, mask_j = torch.from_numpy(mask_np), jnp.asarray(mask_np)
    pk_p = build_coeff_packs(mask_p, pg, pm, dtype=F64, robin_h=80.0)
    pk_j = j_packs(mask_j, jg, jm, robin_h=80.0)

    def port(T, dt, k0):
        return adi_step_varprop(T, mask_p, pk_p, pg, pm, dt=dt, theta=1.0,
                                t_inf=25.0, k_table=lambda t: k0 + 0.02 * t,
                                cp_table=ct_p)

    def jx(T, dt, k0):
        return jcv.adi_step_varprop(T, mask_j, pk_j, jg, jm, dt=dt,
                                    theta=1.0, t_inf=25.0,
                                    k_table=lambda t: k0 + 0.02 * t,
                                    cp_table=ct_j, implementation="xla")

    got = _pgrad(port, [_t(T_np, True), _t(0.05, True), _t(30.0, True)], w)
    want = _jgrad(jx, [jnp.asarray(T_np), 0.05, 30.0], (0, 1, 2), w)
    for name, g, j in zip(("T0", "dt", "k0"), got, want):
        _close(g, j, 1e-10, name)


# ---------------------------------------------------------------------------
# the steps: adi_step_fused and the cylindrical varprop kernels tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_bcs", [False, True], ids=["lite", "bcs"])
def test_fused_step_grad_matches_jax(with_bcs):
    """tests/test_pallas_sweeps.py:42's case on a smaller grid: two steps,
    dL/dT0 and dL/ddt of adi_step_fused against jax.grad of
    adi_step_pallas."""
    shape = (6, 5, 7)
    rng = np.random.default_rng(11)
    mask = rng.random(shape) > 0.3
    T0 = np.where(mask, 20 + 880 * rng.random(shape), 20.0)
    w = rng.random(shape)
    pg, pm = CartesianGrid(*shape, 1e-3), Material(*MAT)
    jg, jm = JGrid(*shape, 1e-3), JMat(*MAT)
    dirm = np.zeros(shape, bool)
    dirm[:, :, 0] = mask[:, :, 0]
    kw = (dict(robin_h=250.0, neumann={"z+": 2e5},
               dirichlet_value=77.0) if with_bcs else dict(robin_h=250.0))
    pp = build_coeff_packs(torch.from_numpy(mask), pg, pm, dtype=F64,
                           dirichlet_mask=torch.from_numpy(dirm)
                           if with_bcs else None, **kw)
    jp = j_packs(jnp.asarray(mask), jg, jm, dirichlet_mask=jnp.asarray(dirm)
                 if with_bcs else None, **kw)
    plan_p = build_sweep_plan(torch.from_numpy(mask), pp,
                              has_neumann=with_bcs, has_dirichlet=with_bcs)
    plan_j = jcp.build_sweep_plan(jnp.asarray(mask), jp,
                                  has_neumann=with_bcs,
                                  has_dirichlet=with_bcs)

    def port(T, dt):
        for _ in range(2):
            T = adi_step_fused(T, plan_p, pg, pm, dt=dt, t_inf=20.0)
        return T

    def jx(T, dt):
        for _ in range(2):
            T = jcp.adi_step_pallas(T, plan_j, jg, jm, dt=dt, theta=0.5,
                                    t_inf=20.0, interpret=True)
        return T

    got = _pgrad(port, [_t(T0, True), _t(0.02, True)], w)
    want = _jgrad(jx, [jnp.asarray(T0), 0.02], (0, 1), w)
    _close(got[0], want[0], RTOL, "dL/dT0")
    _close(got[1], want[1], RTOL, "dL/ddt")


def test_fused_lite_step_grad_matches_jax():
    """The flagship plan-lite route (K4 -> K1 -> K2) through
    fused_theta_solve_lite and sweep_solve_lite against JAX's."""
    shape = (8, 7, 10)
    rng = np.random.default_rng(12)
    mask = rng.random(shape) > 0.3
    T0 = np.where(mask, 20 + 880 * rng.random(shape), 20.0)
    w = rng.standard_normal(shape)
    pg, pm = CartesianGrid(*shape, 1e-3), Material(*MAT)
    jg, jm = JGrid(*shape, 1e-3), JMat(*MAT)
    rc = 250.0 / (7800.0 * 490.0 * 1e-3)
    plan_p = build_sweep_plan(torch.from_numpy(mask), None,
                              has_neumann=False, has_dirichlet=False,
                              robin_const=rc)
    plan_j = jcp.build_sweep_plan(jnp.asarray(mask), None,
                                  has_neumann=False, has_dirichlet=False,
                                  robin_const=rc)
    got = _pgrad(lambda T, dt: adi_step_fused(T, plan_p, pg, pm, dt=dt,
                                              t_inf=20.0),
                 [_t(T0, True), _t(0.02, True)], w)
    want = _jgrad(lambda T, dt: jcp.adi_step_pallas(
        T, plan_j, jg, jm, dt=dt, theta=0.5, t_inf=20.0, interpret=True),
        [jnp.asarray(T0), 0.02], (0, 1), w)
    _close(got[0], want[0], RTOL, "dL/dT0")
    _close(got[1], want[1], RTOL, "dL/ddt")


def _cyl_case(dtype=F64):
    """tests/test_cyl_varprop.py:564's configuration (a masked annulus,
    void films, a Dirichlet bottom, a Robin top)."""
    shape = (4, 8, 6)
    rng = np.random.default_rng(12)
    act = rng.random(shape) > 0.3
    T = 100.0 + 800.0 * rng.random(shape)
    kw = dict(robin_outer=RobinBC(300.0, 20.0),
              zbc=ZFaceBC(kind_bot="dirichlet", T_bot=140.0,
                          kind_top="robin", h_top=400.0, T_inf_top=25.0),
              active=torch.from_numpy(act), h_void=50.0, T_inf_void=20.0,
              h_front=120.0,
              k_table=melt_pool_enhanced_k(54.0, 400.0, 600.0, 4.0))
    return (CylindricalGrid(*shape, 6e-4, 8e-4, r_inner=0.015),
            JCGrid(*shape, 6e-4, 8e-4, r_inner=0.015), act,
            _t(T).to(dtype), kw)


@pytest.mark.parametrize("scheme", ["be", "douglas"])
def test_cyl_varprop_kernels_tier_grads_match_jax(scheme):
    cg, jg, act, T, kw = _cyl_case()
    w = np.random.default_rng(13).random(T.shape)
    kw = {k: v for k, v in kw.items() if k != "k_table"}
    jkw = dict(robin_outer=JRobin(300.0, 20.0),
               zbc=JZ(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                      h_top=400.0, T_inf_top=25.0),
               active=jnp.asarray(act), h_void=50.0, T_inf_void=20.0,
               h_front=120.0)

    def port(T, k0):
        return adi_step_cyl_varprop(T, cg, Material(*MAT), dt=0.05,
                                    scheme=scheme,
                                    k_table=lambda t: k0 + 0.01 * t,
                                    cp_table=lambda t: 430.0 + 0.1 * t,
                                    **kw)

    def jx(T, k0):
        return jcvp.adi_step_cyl_varprop(
            T, jg, JMat(*MAT), dt=0.05, scheme=scheme,
            k_table=lambda t: k0 + 0.01 * t,
            cp_table=lambda t: 430.0 + 0.1 * t, implementation="pallas",
            interpret=True, **jkw)

    got = _pgrad(port, [T.clone().requires_grad_(True), _t(30.0, True)], w)
    want = _jgrad(jx, [jnp.asarray(T.numpy()), 30.0], (0, 1), w)
    _close(got[0], want[0], RTOL, "dL/dT")
    _close(got[1], want[1], RTOL, "dL/dk0")


def test_cyl_varprop_tier2_grads_match_jax():
    """Tables take the tier-2 chain (K15 -> K16 -> K8's general form);
    JAX's pallas tier at float64 runs its stream tier: the same
    gradient w.r.t. T and dt."""
    cg, jg, act, T, kw = _cyl_case()
    w = np.random.default_rng(14).random(T.shape)
    ct = apparent_cp(490.0, 490.0, 2.7e5, 400.0, 600.0)
    jkw = dict(robin_outer=JRobin(300.0, 20.0),
               zbc=JZ(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                      h_top=400.0, T_inf_top=25.0),
               active=jnp.asarray(act), h_void=50.0, T_inf_void=20.0,
               h_front=120.0,
               k_table=jcv.melt_pool_enhanced_k(54.0, 400.0, 600.0, 4.0),
               cp_table=jcv.apparent_cp(490.0, 490.0, 2.7e5, 400.0, 600.0))
    got = _pgrad(lambda T, dt: adi_step_cyl_varprop(
        T, cg, Material(*MAT), dt=dt, cp_table=ct, emissivity=0.5, **kw),
        [T.clone().requires_grad_(True), _t(0.05, True)], w)
    want = _jgrad(lambda T, dt: jcvp.adi_step_cyl_varprop(
        T, jg, JMat(*MAT), dt=dt, emissivity=0.5, implementation="pallas",
        interpret=True, **jkw), [jnp.asarray(T.numpy()), 0.05], (0, 1), w)
    _close(got[0], want[0], RTOL, "dL/dT")
    _close(got[1], want[1], RTOL, "dL/ddt")
