"""The port's unmasked cylindrical step against the JAX package's.

Same inputs from one numpy seed go to both sides, at float64:

* ``_r_geometry`` / ``_z_geometry`` on annular and full-disk grids, inner
  Robin on, off and h = 0, every pair of z-end kinds: exact;
* ``phi_eigenvalue_factors`` and ``phi_solve_spectral``: 1e-12;
* the plain versions of K12 and K13 (the wrappers on CPU tensors) against
  JAX ``fused_sweep_const`` (axis-0 and ``nat_rhs_out`` forms) in
  interpret mode, random per-row vectors with ``radd``: 1e-10;
* the plain version of K14 against ``fused_cyclic_const`` (transposed
  field, n in {2, 3, 7, 16}), ``fused_cyclic_const_axis1`` (n = 16) and
  ``fused_cyclic_const_nat`` (n = 7), fac per ring broadcast over z on the
  JAX side, with a zero-fac ring: 1e-10;
* ``adi_step`` (be and douglas, implementation kernels and reference)
  against JAX ``"pallas"`` and ``"xla"``, annular with inner Robin and a
  neumann0/robin z pair, full disk with a dirichlet/robin pair, with and
  without a source, and nphi = 1: 1e-10 K;
* ``adi_step_masked`` against JAX ``adi_step_masked``, random mask: 1e-10 K;
* ``apps/spiral_tube.run --void_mode clamp`` against the JAX app on
  tests/test_torch_cyl.py's tube, with and without ``--torch_Q``: 1e-9 K;
* the three wrappers' CPU contract.

The CUDA kernels themselves are compared with their plain versions on the
card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CylindricalGrid as JGrid
from adi_thermal_fields_tpu import Material as JMat
from adi_thermal_fields_tpu import RobinBC as JRobin
from adi_thermal_fields_tpu import ZFaceBC as JZ
from adi_thermal_fields_tpu.apps import spiral_tube as jax_app
from adi_thermal_fields_tpu.solvers import spectral as jspectral
from adi_thermal_fields_tpu.solvers.pallas_sweeps import (
    fused_cyclic_const, fused_cyclic_const_axis1, fused_cyclic_const_nat,
    fused_sweep_const)
from adi_thermal_fields_tpu.step import cylindrical as jcyl

from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material, RobinBC,
                                          ZFaceBC, adi_step_cylindrical,
                                          adi_step_cylindrical_masked,
                                          phi_solve_spectral)
from adi_thermal_fields_tpu_torch.apps import spiral_tube as port_app
from adi_thermal_fields_tpu_torch.solvers import (
    KERNELS, const_sweep_strided, const_sweep_z, cyclic_const_phi,
    launch_counts, phi_eigenvalue_factors, reset_launch_counts)
from adi_thermal_fields_tpu_torch.step import cylindrical as pcyl

torch.set_num_threads(1)

ATOL = 1e-10                 # K, float64
MAT = (7800.0, 490.0, 54.0)
DT = 0.05
# (shape, r_inner, z kinds): annular with inner Robin, full disk with a
# Dirichlet bottom
CONFIGS = {"annular-neumann0": ((6, 12, 10), 0.02, ("neumann0", "robin")),
           "disk-dirichlet": ((8, 9, 14), 0.0, ("dirichlet", "robin")),
           "nphi1": ((6, 1, 10), 0.02, ("neumann0", "robin"))}
KINDS = ("neumann0", "dirichlet", "robin")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _zkw(kind_bot, kind_top):
    return dict(kind_bot=kind_bot, kind_top=kind_top, h_bot=250.0,
                h_top=400.0, T_inf_bot=30.0, T_inf_top=25.0, T_bot=140.0,
                T_top=90.0)


def _case(config, seed=5):
    """Grids, T, source and BCs of one configuration, both sides."""
    shape, r_inner, kinds = CONFIGS[config]
    rng = np.random.default_rng(seed)
    geo = (*shape, 5e-4, 1e-3)
    T = 50.0 + 850.0 * rng.random(shape)
    src = rng.random(shape) * 1e6
    act = rng.random(shape) > 0.35
    jbc = dict(robin_outer=JRobin(300.0, 20.0), zbc=JZ(**_zkw(*kinds)),
               robin_inner=JRobin(150.0, 30.0))
    pbc = dict(robin_outer=RobinBC(300.0, 20.0), zbc=ZFaceBC(**_zkw(*kinds)),
               robin_inner=RobinBC(150.0, 30.0))
    return (JGrid(*geo, r_inner=r_inner),
            CylindricalGrid(*geo, r_inner=r_inner), T, src, act, jbc, pbc)


@pytest.mark.parametrize("inner", [None, (150.0, 30.0), (0.0, 30.0)],
                         ids=["no-inner", "inner-robin", "inner-h0"])
@pytest.mark.parametrize("r_inner", [0.0, 0.02], ids=["disk", "annular"])
def test_r_geometry_matches_jax(r_inner, inner):
    jg, pg = JGrid(7, 5, 4, 5e-4, 1e-3, r_inner), \
        CylindricalGrid(7, 5, 4, 5e-4, 1e-3, r_inner)
    got = pcyl._r_geometry(pg, Material(*MAT), RobinBC(300.0, 20.0),
                           None if inner is None else RobinBC(*inner))
    want = jcyl._r_geometry(jg, JMat(*MAT), JRobin(300.0, 20.0),
                            None if inner is None else JRobin(*inner))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kinds", list(itertools.product(KINDS, KINDS)),
                         ids=lambda k: "-".join(k))
def test_z_geometry_matches_jax(kinds):
    jg, pg = JGrid(3, 4, 9, 5e-4, 1e-3), CylindricalGrid(3, 4, 9, 5e-4, 1e-3)
    got = pcyl._z_geometry(pg, Material(*MAT), ZFaceBC(**_zkw(*kinds)))
    want = jcyl._z_geometry(jg, JMat(*MAT), JZ(**_zkw(*kinds)))
    for g, w in zip(got[:4], want[:4], strict=True):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


@pytest.mark.parametrize("nphi", [1, 2, 7, 16])
@pytest.mark.parametrize("r_inner", [0.0, 0.02], ids=["disk", "annular"])
def test_spectral_phi_solve_matches_jax(r_inner, nphi):
    geo = (5, nphi, 6, 5e-4, 1e-3)
    jg, pg = JGrid(*geo, r_inner=r_inner), CylindricalGrid(*geo,
                                                           r_inner=r_inner)
    np.testing.assert_allclose(
        phi_eigenvalue_factors(pg).numpy(),
        np.asarray(jspectral.phi_eigenvalue_factors(jg)), rtol=1e-12, atol=0)
    X = 20.0 + 900.0 * np.random.default_rng(nphi).random(pg.shape)
    want = jspectral.phi_solve_spectral(jnp.asarray(X), jg, JMat(*MAT), 0.5,
                                        DT)
    got = phi_solve_spectral(_t(X), pg, Material(*MAT), 0.5, DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12 * 900.0)


def _rows(n, rng):
    """Diagonally dominant per-row vectors a, b, c and a per-row radd."""
    return (-rng.random(n), 2.5 + rng.random(n), -rng.random(n),
            50.0 * rng.random(n))


def test_k12_matches_jax_const_sweep():
    rng = np.random.default_rng(3)
    rhs = 900.0 * rng.random((10, 6, 20))
    vecs = _rows(10, rng)
    want = fused_sweep_const(jnp.asarray(rhs),
                             *(jnp.asarray(v) for v in vecs), interpret=True)
    got = const_sweep_strided(_t(rhs), *(_t(v) for v in vecs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_k13_matches_jax_natural_const_sweep():
    rng = np.random.default_rng(4)
    rhs = 900.0 * rng.random((5, 9, 40))
    vecs = _rows(40, rng)
    want = fused_sweep_const(jnp.asarray(rhs),
                             *(jnp.asarray(v) for v in vecs), interpret=True,
                             nat_rhs_out=True)
    got = const_sweep_z(_t(rhs), *(_t(v) for v in vecs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("layout,n", [("axis0", 2), ("axis0", 3),
                                      ("axis0", 7), ("axis0", 16),
                                      ("axis1", 16), ("nat", 7)])
def test_k14_matches_jax_cyclic_const(layout, n):
    rng = np.random.default_rng(n)
    B1, B2 = 5, 7
    rhs = 900.0 * rng.random((B1, n, B2))
    fac = 300.0 * rng.random(B1)
    fac[0] = 0.0                      # the axis ring of a full disk
    fac2 = jnp.asarray(np.broadcast_to(fac[:, None], (B1, B2)))
    if layout == "axis0":
        want = jnp.transpose(fused_cyclic_const(
            jnp.transpose(jnp.asarray(rhs), (1, 0, 2)), fac2,
            interpret=True), (1, 0, 2))
    else:
        fn = {"axis1": fused_cyclic_const_axis1,
              "nat": fused_cyclic_const_nat}[layout]
        want = fn(jnp.asarray(rhs), fac2, interpret=True)
    got = cyclic_const_phi(_t(rhs), _t(fac))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # the zero-fac ring is the identity
    np.testing.assert_allclose(got[0].numpy(), rhs[0], rtol=0, atol=ATOL)


@functools.cache
def _jax_step(config, scheme, with_source, impl):
    jg, _, T, src, _, jbc, _ = _case(config)
    return np.asarray(jcyl.adi_step(
        jnp.asarray(T), jg, JMat(*MAT), dt=DT, scheme=scheme,
        source=jnp.asarray(src) if with_source else None,
        implementation=impl, **jbc))


@pytest.mark.parametrize("with_source", [False, True],
                         ids=["no-source", "source"])
@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("scheme", ["be", "douglas"])
@pytest.mark.parametrize("config", ["annular-neumann0", "disk-dirichlet"])
def test_step_matches_jax(config, scheme, impl, with_source):
    _, pg, T, src, _, _, pbc = _case(config)
    got = adi_step_cylindrical(
        _t(T), pg, Material(*MAT), dt=DT, scheme=scheme,
        source=_t(src) if with_source else None, implementation=impl, **pbc)
    assert got.dtype == torch.float64 and got.shape == pg.shape
    for jimpl in ("xla", "pallas"):
        np.testing.assert_allclose(
            got.numpy(), _jax_step(config, scheme, with_source, jimpl),
            rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("scheme", ["be", "douglas"])
def test_step_nphi1_matches_jax_without_phi_solve(scheme, impl,
                                                  monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("nphi == 1 must not solve along phi")

    monkeypatch.setattr(pcyl, "cyclic_const_phi", refuse)
    monkeypatch.setattr(pcyl, "phi_solve_spectral", refuse)
    _, pg, T, src, _, _, pbc = _case("nphi1")
    got = adi_step_cylindrical(_t(T), pg, Material(*MAT), dt=DT,
                               scheme=scheme, source=_t(src),
                               implementation=impl, **pbc)
    for jimpl in ("xla", "pallas"):
        np.testing.assert_allclose(
            got.numpy(), _jax_step("nphi1", scheme, True, jimpl), rtol=0,
            atol=ATOL)


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("config", ["annular-neumann0", "disk-dirichlet"])
def test_masked_clamp_step_matches_jax(config, impl):
    jg, pg, T, src, act, jbc, pbc = _case(config)
    void = dict(robin_void=JRobin(80.0, 15.0))
    want = jcyl.adi_step_masked(jnp.asarray(T), jg, JMat(*MAT), dt=DT,
                                active=jnp.asarray(act),
                                source=jnp.asarray(src), **void, **jbc)
    got = adi_step_cylindrical_masked(
        _t(T), pg, Material(*MAT), dt=DT, active=_t(act), source=_t(src),
        robin_void=RobinBC(80.0, 15.0), implementation=impl, **pbc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # void cells at the void ambient, inactive cells of ring 0 at the inner
    np.testing.assert_array_equal(got.numpy()[1:][~act[1:]], 15.0)
    np.testing.assert_array_equal(got[0].numpy()[~act[0]], 30.0)


# the small tube of tests/test_torch_cyl.py
TUBE = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
        "--z_back", "8", "--nr", "4", "--nphi", "12", "--dz", "2",
        "--pitch", "2", "--auto_speed", "--t_tot", "2", "--dt_fixed", "0.2",
        "--nframes", "2", "--out", "", "--precision", "float64",
        "--void_mode", "clamp"]
APP_CASES = {"tube": [], "torch": ["--torch_Q", "2000"]}


@functools.cache
def _jax_app(case):
    return jax_app.run(jax_app.build_argparser().parse_args(
        TUBE + APP_CASES[case]))


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("case", sorted(APP_CASES))
def test_clamp_spiral_app_matches_jax(case, impl):
    ref = _jax_app(case)
    got = port_app.run(port_app.build_argparser().parse_args(
        TUBE + APP_CASES[case] + ["--device", "cpu", "--implementation",
                                  impl]))
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(ref["T"]),
                               rtol=0, atol=1e-9)
    assert len(got["frames"]) == len(ref["frames"]) == 2
    for (t1, T1, a1), (t2, T2, a2) in zip(got["frames"], ref["frames"]):
        assert t1 == t2
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_allclose(T1, np.asarray(T2), rtol=0, atol=1e-9)


def test_const_wrappers_cpu_contract():
    rng = np.random.default_rng(1)
    rhs = _t(900.0 * rng.random((4, 6, 5)))
    a, b, c, radd = (_t(v) for v in _rows(4, rng))
    az, bz, cz, raddz = (_t(v) for v in _rows(5, rng))
    fac = _t(rng.random(4))
    reset_launch_counts()
    const_sweep_strided(rhs, a, b, c, radd)
    const_sweep_z(rhs, az, bz, cz, raddz)
    cyclic_const_phi(rhs, fac)
    assert launch_counts() == {k: 0 for k in KERNELS}
    grad = rhs.clone().requires_grad_(True)
    for call in (lambda: const_sweep_strided(grad, a, b, c, radd),
                 lambda: const_sweep_z(grad, az, bz, cz, raddz),
                 lambda: cyclic_const_phi(grad, fac)):
        with pytest.raises(RuntimeError, match="forward only"):
            call()
    with pytest.raises(ValueError, match="per-row vectors"):
        const_sweep_strided(rhs, az, b, c, radd)          # (5,) for n = 4
    with pytest.raises(ValueError, match="per-row vectors"):
        const_sweep_z(rhs, az, bz, cz, radd)
    with pytest.raises(ValueError, match="per-row vectors"):
        cyclic_const_phi(rhs, fac.float())
    with pytest.raises(ValueError, match="length >= 2"):
        cyclic_const_phi(rhs[:, :1].contiguous(), fac)
    with pytest.raises(TypeError, match="not supported"):
        const_sweep_strided(rhs.half(), a.half(), b.half(), c.half(),
                            radd.half())
    with pytest.raises(NotImplementedError, match="bfloat16"):
        adi_step_cylindrical(
            torch.zeros((4, 6, 5), dtype=torch.bfloat16),
            CylindricalGrid(4, 6, 5, 5e-4, 1e-3), Material(*MAT), dt=DT,
            robin_outer=RobinBC(300.0, 20.0), zbc=ZFaceBC())
