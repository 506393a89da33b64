"""The port's variable-property cylindrical step against the JAX package's.

Same inputs from one numpy seed go to both sides:

* ``build_vp2_code`` with ``periodic`` and ``clear_rows``: exact;
* the plain versions of K15, K8's general form and K16 (the wrappers on
  CPU tensors) against JAX ``fused_vp2_sweep`` (solve-leading and
  ``nat_rhs_out`` forms) and ``fused_vp2_cyclic_axis1`` in interpret mode
  at float32, T across 1000-1600 C: 1e-3 K; and at float64 against the
  stream tier ``fused_vp_fields_*`` (interpret) fed by
  ``vp2_streams_xla`` / ``vp2_cyclic_streams_xla``: 1e-10 K;
* the plain versions of K17 and K18 against ``fused_vp_fields_sweep`` and
  ``fused_vp_fields_cyclic_axis1`` (interpret, float64): 1e-10 K;
* ``adi_step_cyl_varprop`` (implementation kernels and reference, be and
  douglas) against the JAX ``implementation="xla"`` step at float64:
  annular and full disk, with and without a mask, a source, a Dirichlet
  bottom, emissivity, an anisotropic k tuple, a property callable and
  nphi = 1: 1e-9 K; the clamp wrapper; the plan through
  ``convert.cyl_vp2_plan_from_jax`` and plan reuse; the routing of each
  scheme to its kernels; steady states as fixed points of Douglas;
  negative films refused;
* ``apps/spiral_tube.run`` with ``--latent_J_kg``, ``--melt_k_factor``,
  ``--emissivity``, ``--scheme douglas`` and ``--void_mode clamp`` against
  the JAX app at float64: 1e-9 K, and a Douglas print on a thin wall at
  chip_smoke's cell size, where both apps overshoot --Ts.

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
from adi_thermal_fields_tpu.solvers import pallas_vp2 as jvp2
from adi_thermal_fields_tpu.solvers.pallas_vpfields import (
    fused_vp_fields_cyclic_axis1, fused_vp_fields_sweep)
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv
from adi_thermal_fields_tpu.step import cylindrical_varprop as jcvp

from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material, RobinBC,
                                          ZFaceBC, adi_step_cyl_varprop,
                                          adi_step_cyl_varprop_masked,
                                          build_cyl_vp2_plan)
from adi_thermal_fields_tpu_torch.apps import spiral_tube as port_app
from adi_thermal_fields_tpu_torch.convert import (cyl_vp2_plan_from_jax,
                                                  property_table_from_jax)
from adi_thermal_fields_tpu_torch.solvers import (
    KERNELS, build_vp2_code, launch_counts, reset_launch_counts,
    vp2_cyclic_phi, vp2_sweep_strided, vp2_sweep_z, vp_fields_cyclic_phi,
    vp_fields_sweep_strided)
from adi_thermal_fields_tpu_torch.solvers import differentiable as pdiff
from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as pcvp

torch.set_num_threads(1)

ATOL = 1e-9                  # K, float64 steps and apps
RHO, DT = 7800.0, 0.05
MAT = (RHO, 490.0, 54.0)
JK = jcv.melt_pool_enhanced_k(54.0, 1420.0, 1470.0, enhancement=4.0)
JCP = jcv.apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0)
PK, PCP = property_table_from_jax(JK), property_table_from_jax(JCP)
SPEC = dict(k_spec=(tuple(JK.points), tuple(JK.values)),
            cp_spec=(tuple(JCP.points), tuple(JCP.values)))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(a):
    return np.asarray(a)


def _u8(jcode):
    return _t(_np(jcode).view(np.uint8))


# ---------------------------------------------------------------------------
# codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,periodic,clear", [
    (0, False, ()), (1, True, ()), (2, False, (0,)), (2, False, (0, 8)),
    (1, True, (3,))], ids=["r", "phi-periodic", "z-clear-bottom",
                           "z-clear-both", "phi-clear"])
def test_build_vp2_code_matches_jax(axis, periodic, clear):
    mask = np.random.default_rng(axis + len(clear)).random((5, 7, 9)) > 0.3
    want = jvp2.build_vp2_code(jnp.asarray(mask), axis, periodic=periodic,
                               clear_rows=clear)
    got = build_vp2_code(_t(mask), axis, periodic=periodic, clear_rows=clear)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _np(want).view(np.uint8))


# ---------------------------------------------------------------------------
# the tier-2 sweeps' plain versions (K15, K8's general form, K16)
# ---------------------------------------------------------------------------

def _open_case(seed, shape, dtype):
    """T, rhs, mask, columns and edge films of an open sweep along axis
    0 of ``shape``; numbers rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    f = np.float32 if dtype == torch.float32 else np.float64
    n = shape[0]
    T = (1000.0 + 600.0 * rng.random(shape)).astype(f)
    rhs = (1000.0 + 600.0 * rng.random(shape)).astype(f)
    mask = rng.random(shape) > 0.2
    cols = [(0.3 + rng.random(n)).astype(f) * s
            for s in (4e6, 4e6, 2e3, 2e3)]        # glo, ghi, gsl, gsh
    dtor = f(f(0.02) / f(RHO))
    films = dict(h_lo=80.0, h_hi=200.0, tinf_void=20.0,
                 edge0=(50.0, 1.4e3, 30.0), edge1=(300.0, 2.2e3, 25.0))
    return T, rhs, mask, cols, dtor, films


@pytest.mark.parametrize("form,eps", [
    ("strided", 0.0), ("strided", 0.5), ("strided-rhs-is-T", 0.5),
    ("z", 0.5)], ids=["strided-conv", "strided-rad", "rhs-is-T-rad",
                      "z-rad"])
def test_vp2_open_plain_matches_jax_kernel_f32(form, eps):
    shape = (12, 5, 6)
    T, rhs, mask, cols, dtor, films = _open_case(3, shape, torch.float32)
    jcode = jvp2.build_vp2_code(jnp.asarray(mask), 0)
    jcols = [jnp.asarray(c) for c in cols]
    kw = dict(**films, emissivity=eps)
    no_rhs = form == "strided-rhs-is-T"
    want = jvp2.fused_vp2_sweep(None if no_rhs else jnp.asarray(rhs),
                                jnp.asarray(T), jcode, *jcols,
                                jnp.float32(dtor), interpret=True, **SPEC,
                                **kw)
    inv = float(np.float32(1.0) / dtor)
    pk = dict(k_spec=PK, cp_spec=PCP)
    if form == "z":
        nat = (lambda a: _t(np.moveaxis(a, 0, 2)))
        tcols = [_t(c) for c in cols]
        got = vp2_sweep_z(nat(rhs), nat(T), nat(_np(jcode).view(np.uint8)),
                          tcols[0], tcols[2], inv, ghi=tcols[1],
                          gsh=tcols[3], h=films["h_lo"], h_hi=films["h_hi"],
                          t_inf=films["tinf_void"], emissivity=eps,
                          edge0=films["edge0"], edge1=films["edge1"], **pk)
        got = got.movedim(2, 0)
    else:
        got = vp2_sweep_strided(None if no_rhs else _t(rhs), _t(T),
                                _u8(jcode), *(_t(c) for c in cols), inv,
                                **pk, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-3)


@pytest.mark.parametrize("eps", [0.0, 0.5], ids=["conv", "rad"])
def test_vp2_open_plain_matches_jax_stream_tier_f64(eps):
    shape = (12, 5, 6)
    T, rhs, mask, cols, dtor, films = _open_case(4, shape, torch.float64)
    jcode = jvp2.build_vp2_code(jnp.asarray(mask), 0)
    jcols = [jnp.asarray(c) for c in cols]
    fhi, dw, sink, srhs = jvp2.vp2_streams_xla(
        jnp.asarray(T), jcode, jcols[2], jcols[3], dtor, emissivity=eps,
        **SPEC, **films)
    want = fused_vp_fields_sweep(jnp.asarray(rhs), fhi, dw, sink, srhs,
                                 jcols[0], jcols[1], interpret=True)
    got = vp2_sweep_strided(_t(rhs), _t(T), _u8(jcode),
                            *(_t(c) for c in cols), 1.0 / dtor, k_spec=PK,
                            cp_spec=PCP, emissivity=eps, **films)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


def _cyclic_case(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    f = np.float32 if dtype == torch.float32 else np.float64
    T = (1000.0 + 600.0 * rng.random(shape)).astype(f)
    rhs = (1000.0 + 600.0 * rng.random(shape)).astype(f)
    mask = rng.random(shape) > 0.2
    mask[1] = True                       # one ring with no void
    geo = ((0.5 + rng.random(shape[0])) * 3e5).astype(f)
    gs = ((0.1 + rng.random(shape[0])) * 2e3).astype(f)
    return T, rhs, mask, geo, gs, f(f(0.02) / f(RHO))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n", [2, 9])
def test_vp2_cyclic_plain_matches_jax(n, dtype):
    shape = (4, n, 6)
    T, rhs, mask, geo, gs, dtor = _cyclic_case(n, shape, dtype)
    jcode = jvp2.build_vp2_code(jnp.asarray(mask), 1, periodic=True)
    jcode = jcode.at[0].set(jnp.int8(0))       # an identity ring
    b2 = (lambda v: jnp.asarray(np.broadcast_to(v[:, None],
                                                (shape[0], shape[2]))))
    kw = dict(h_void=80.0, tinf_void=20.0, emissivity=0.5)
    if dtype == torch.float32:
        want = jvp2.fused_vp2_cyclic_axis1(
            jnp.asarray(rhs), jnp.asarray(T), jcode, b2(geo), b2(gs),
            jnp.float32(dtor), interpret=True, **SPEC, **kw)
        inv, tol = float(np.float32(1.0) / dtor), 1e-3
    else:
        flo, dw, sink, srhs = jvp2.vp2_cyclic_streams_xla(
            jnp.asarray(T), jcode, b2(gs), dtor, **SPEC, **kw)
        want = fused_vp_fields_cyclic_axis1(jnp.asarray(rhs), flo, None, dw,
                                            sink, srhs, b2(geo),
                                            interpret=True)
        inv, tol = 1.0 / dtor, 1e-10
    got = vp2_cyclic_phi(_t(rhs), _t(T), _u8(jcode), _t(geo), _t(gs), inv,
                         k_spec=PK, cp_spec=PCP, **kw)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=tol)
    # the code-0 ring passes its rhs through bit for bit
    np.testing.assert_array_equal(got[0].numpy(), rhs[0])


# ---------------------------------------------------------------------------
# the stream tier's plain versions (K17, K18)
# ---------------------------------------------------------------------------

def _streams(rng, shape):
    fh = 54.0 * (1.0 + 3.0 * rng.random(shape)) * (rng.random(shape) > 0.2)
    return (1000.0 + 600.0 * rng.random(shape), fh,
            2e-8 * (0.5 + rng.random(shape)), 3e3 * rng.random(shape),
            6e4 * rng.random(shape))


def test_vp_fields_sweep_plain_matches_jax():
    rng = np.random.default_rng(21)
    shape, n = (11, 4, 5), 11
    rhs, fhi, dw, sink, srhs = _streams(rng, shape)
    fhi[-1] = 0.0                                  # the domain's hi edge
    glo, ghi = 4e6 * (0.5 + rng.random(n)), 4e6 * (0.5 + rng.random(n))
    glo[0] = ghi[0] = 0.0                          # a Dirichlet row
    args = (rhs, fhi, dw, sink, srhs, glo, ghi)
    want = fused_vp_fields_sweep(*(jnp.asarray(a) for a in args),
                                 interpret=True)
    got = vp_fields_sweep_strided(*(_t(a) for a in args))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [2, 9])
def test_vp_fields_cyclic_plain_matches_jax(n):
    rng = np.random.default_rng(n)
    shape = (4, n, 5)
    rhs, flo, dw, sink, srhs = _streams(rng, shape)
    flo[0] = sink[0] = srhs[0] = 0.0               # an identity ring
    geo = 3e5 * (0.5 + rng.random(shape[0]))
    want = fused_vp_fields_cyclic_axis1(
        *(jnp.asarray(a) for a in (rhs, flo)), None,
        *(jnp.asarray(a) for a in (dw, sink, srhs)),
        jnp.asarray(np.broadcast_to(geo[:, None], (4, 5))), interpret=True)
    got = vp_fields_cyclic_phi(*(_t(a) for a in (rhs, flo, dw, sink, srhs,
                                                 geo)))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got[0].numpy(), rhs[0])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

# (shape, r_inner, z kinds, mask, source, emissivity, k_table)
CONFIGS = {
    "annular": ((6, 9, 10), 0.02, ("neumann0", "robin"), False, False, 0.0,
                "table"),
    "annular-mask-source-rad": ((6, 9, 10), 0.02, ("neumann0", "robin"),
                                True, True, 0.5, "table"),
    "disk-dirichlet": ((7, 8, 9), 0.0, ("dirichlet", "robin"), False, False,
                       0.0, "table"),
    "disk-dirichlet-mask-rad": ((7, 8, 9), 0.0, ("dirichlet", "robin"), True,
                                True, 0.4, "table"),
    "anisotropic": ((6, 9, 10), 0.02, ("robin", "robin"), True, False, 0.3,
                    "tuple"),
    "callable": ((6, 9, 10), 0.02, ("neumann0", "robin"), True, True, 0.5,
                 "callable"),
    "nphi1": ((6, 1, 10), 0.02, ("neumann0", "dirichlet"), True, True, 0.5,
              "table"),
}


def _zkw(kinds):
    return dict(kind_bot=kinds[0], kind_top=kinds[1], h_bot=250.0,
                h_top=400.0, T_inf_bot=30.0, T_inf_top=25.0, T_bot=1400.0,
                T_top=90.0)


def _k_tables(kind):
    """The JAX and port k_table of a configuration."""
    if kind == "table":
        return JK, PK
    if kind == "tuple":
        return (JK, 60.0, None), (PK, 60.0, None)

    def jk(T):
        return 54.0 + 0.01 * T

    def pk(T):
        return 54.0 + 0.01 * T
    return jk, pk


def _case(config, seed=5):
    shape, r_inner, kinds, masked, with_src, eps, kk = CONFIGS[config]
    rng = np.random.default_rng(seed)
    T = 1380.0 + 150.0 * rng.random(shape)
    act = rng.random(shape) > 0.3 if masked else None
    src = rng.random(shape) * 1e8 if with_src else None
    geo = (*shape, 5e-4, 1e-3)
    jk, pk = _k_tables(kk)
    common = dict(dt=DT, h_void=80.0, T_inf_void=15.0, h_front=200.0,
                  emissivity=eps)
    jargs = dict(robin_outer=JRobin(300.0, 20.0), zbc=JZ(**_zkw(kinds)),
                 robin_inner=JRobin(150.0, 30.0), k_table=jk, cp_table=JCP,
                 active=None if act is None else jnp.asarray(act),
                 source=None if src is None else jnp.asarray(src), **common)
    pargs = dict(robin_outer=RobinBC(300.0, 20.0), zbc=ZFaceBC(**_zkw(kinds)),
                 robin_inner=RobinBC(150.0, 30.0), k_table=pk, cp_table=PCP,
                 active=None if act is None else _t(act),
                 source=None if src is None else _t(src), **common)
    return (JGrid(*geo, r_inner=r_inner),
            CylindricalGrid(*geo, r_inner=r_inner), T, act, jargs, pargs)


@functools.cache
def _jax_step(config, scheme):
    jg, _, T, _, jargs, _ = _case(config)
    return _np(jcvp.adi_step_cyl_varprop(jnp.asarray(T), jg, JMat(*MAT),
                                         scheme=scheme, implementation="xla",
                                         **jargs))


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("scheme", ["be", "douglas"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_step_matches_jax_xla(config, scheme, impl):
    _, pg, T, _, _, pargs = _case(config)
    got = adi_step_cyl_varprop(_t(T), pg, Material(*MAT), scheme=scheme,
                               implementation=impl, **pargs)
    assert got.dtype == torch.float64 and tuple(got.shape) == pg.shape
    np.testing.assert_allclose(got.numpy(), _jax_step(config, scheme),
                               rtol=0, atol=ATOL)


class _Calls:
    """Records which kernel wrappers a step calls (on CPU tensors); the
    kernels tier calls them through solvers/differentiable.py."""

    def __init__(self, monkeypatch):
        self.names = []
        for name in ("vp2_sweep_strided", "vp2_cyclic_phi", "vp2_sweep_z",
                     "vp_fields_sweep_strided", "vp_fields_cyclic_phi",
                     "vp_fields_sweep_z"):
            fn = getattr(pdiff, name)
            monkeypatch.setattr(pdiff, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            self.names.append(name)
            return fn(*args, **kwargs)
        return call


@pytest.mark.parametrize("config,scheme,route", [
    ("annular-mask-source-rad", "be",
     ["vp2_sweep_strided", "vp2_cyclic_phi", "vp2_sweep_z"]),
    ("annular-mask-source-rad", "douglas",
     ["vp_fields_sweep_strided", "vp_fields_cyclic_phi",
      "vp_fields_sweep_z"]),
    ("callable", "be", ["vp_fields_sweep_strided", "vp_fields_cyclic_phi",
                        "vp_fields_sweep_z"]),
    ("nphi1", "be", ["vp2_sweep_strided", "vp2_sweep_z"])],
    ids=["be-tables", "douglas", "be-callable", "nphi1"])
def test_step_routes_to_its_kernels(config, scheme, route, monkeypatch):
    calls = _Calls(monkeypatch)
    _, pg, T, _, _, pargs = _case(config)
    adi_step_cyl_varprop(_t(T), pg, Material(*MAT), scheme=scheme, **pargs)
    assert calls.names == route
    calls.names.clear()
    adi_step_cyl_varprop(_t(T), pg, Material(*MAT), scheme=scheme,
                         implementation="reference", **pargs)
    assert calls.names == []


def test_stream_tier_be_matches_tier2():
    """The tables wrapped in callables send backward Euler to K17/K18: the
    two tiers agree to round-off."""
    _, pg, T, _, _, pargs = _case("disk-dirichlet-mask-rad")
    a = adi_step_cyl_varprop(_t(T), pg, Material(*MAT), **pargs)
    wrapped = dict(pargs, k_table=lambda t: PK(t), cp_table=lambda t: PCP(t))
    b = adi_step_cyl_varprop(_t(T), pg, Material(*MAT), **wrapped)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        b.numpy(), _jax_step("disk-dirichlet-mask-rad", "be"), rtol=0,
        atol=ATOL)


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("scheme", ["be", "douglas"])
def test_clamp_wrapper_matches_jax(scheme, impl):
    jg, pg, T, _, jargs, pargs = _case("disk-dirichlet-mask-rad")
    act = np.random.default_rng(8).random(pg.shape) > 0.35
    drop = ("active", "h_void", "T_inf_void", "h_front")
    jkw = {k: v for k, v in jargs.items() if k not in drop}
    pkw = {k: v for k, v in pargs.items() if k not in drop}
    want = jcvp.adi_step_cyl_varprop_masked(
        jnp.asarray(T), jg, JMat(*MAT), active=jnp.asarray(act),
        robin_void=JRobin(80.0, 15.0), scheme=scheme, implementation="xla",
        **jkw)
    got = adi_step_cyl_varprop_masked(
        _t(T), pg, Material(*MAT), active=_t(act),
        robin_void=RobinBC(80.0, 15.0), scheme=scheme, implementation=impl,
        **pkw)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[1:][~act[1:]], 15.0)
    np.testing.assert_array_equal(got[0].numpy()[~act[0]], 30.0)


@pytest.mark.parametrize("config", ["annular-mask-source-rad",
                                    "disk-dirichlet-mask-rad"])
def test_vp2_plan_matches_jax_and_reuse_is_exact(config):
    jg, pg, T, act, jargs, pargs = _case(config)
    want = jcvp.build_cyl_vp2_plan(jnp.asarray(act), jg, jargs["zbc"])
    plan = build_cyl_vp2_plan(_t(act), pg, pargs["zbc"])
    for got, conv in zip(plan, cyl_vp2_plan_from_jax(want), strict=True):
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), conv.numpy())
    inline = adi_step_cyl_varprop(_t(T), pg, Material(*MAT), **pargs)
    reused = adi_step_cyl_varprop(_t(T), pg, Material(*MAT), vp2_plan=plan,
                                  **pargs)
    np.testing.assert_array_equal(reused.numpy(), inline.numpy())


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("state", ["linear-z", "ambient"])
def test_steady_states_are_fixed_points_of_douglas(state, impl):
    grid = CylindricalGrid(5, 8, 12, 5e-4, 1e-3, r_inner=0.01)
    shape = grid.shape
    if state == "linear-z":
        # constant k, insulated rings, Dirichlet ends on a linear profile:
        # every operator is zero
        z = np.arange(shape[2], dtype=np.float64)
        T = np.broadcast_to(100.0 + 25.0 * z, shape).copy()
        kw = dict(robin_outer=RobinBC(0.0, 20.0),
                  zbc=ZFaceBC(kind_bot="dirichlet", kind_top="dirichlet",
                              T_bot=T[0, 0, 0], T_top=T[0, 0, -1]),
                  k_table=54.0, cp_table=PCP)
    else:
        # a mask, tables and radiation at the one ambient of every film
        T = np.full(shape, 20.0)
        act = np.random.default_rng(2).random(shape) > 0.3
        kw = dict(robin_outer=RobinBC(300.0, 20.0),
                  robin_inner=RobinBC(150.0, 20.0),
                  zbc=ZFaceBC(kind_bot="robin", kind_top="robin", h_bot=50.0,
                              h_top=400.0),
                  active=_t(act), h_void=80.0, T_inf_void=20.0,
                  h_front=200.0, emissivity=0.5, k_table=PK, cp_table=PCP)
    got = adi_step_cyl_varprop(_t(T), grid, Material(*MAT), dt=1.0,
                               scheme="douglas", implementation=impl, **kw)
    np.testing.assert_allclose(got.numpy(), T, rtol=0, atol=ATOL)


def test_negative_films_are_refused():
    _, pg, T, _, _, pargs = _case("annular-mask-source-rad")
    bad = {"h_void": dict(h_void=-1.0), "h_front": dict(h_front=-1.0),
           "robin_outer": dict(robin_outer=RobinBC(-5.0, 20.0)),
           "robin_inner": dict(robin_inner=RobinBC(-5.0, 20.0)),
           "h_top": dict(zbc=ZFaceBC(kind_top="robin", h_top=-3.0)),
           "emissivity": dict(emissivity=-0.1)}
    for name, over in bad.items():
        with pytest.raises(ValueError, match=name):
            adi_step_cyl_varprop(_t(T), pg, Material(*MAT),
                                 **{**pargs, **over})
    # a film that no face uses is not checked: a neumann0 end's h
    adi_step_cyl_varprop(_t(T), pg, Material(*MAT),
                         **{**pargs, "zbc": ZFaceBC(kind_bot="neumann0",
                                                    h_bot=-1.0)})


def test_unported_routes_raise_and_bf16_is_solved_at_float32():
    _, pg, T, _, _, pargs = _case("annular")
    for over in (dict(constrain=lambda x, s: x), dict(z_solver=object()),
                 dict(pallas_solvers={})):
        with pytest.raises(NotImplementedError, match="multi-device"):
            adi_step_cyl_varprop(_t(T), pg, Material(*MAT), **pargs, **over)
    # the JAX name of the fields tier is not the port's ("fields")
    with pytest.raises(ValueError, match="implementation must be one of"):
        adi_step_cyl_varprop(_t(T), pg, Material(*MAT), **pargs,
                             implementation="pallas_fields")
    with pytest.raises(ValueError, match="unknown scheme"):
        adi_step_cyl_varprop(_t(T), pg, Material(*MAT), **pargs,
                             scheme="cn")
    Tb = _t(T).to(torch.bfloat16)
    got = adi_step_cyl_varprop(Tb, pg, Material(*MAT), **pargs)
    want = adi_step_cyl_varprop(Tb.float(), pg, Material(*MAT), **pargs)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_cyl_vp_wrappers_cpu_contract():
    rng = np.random.default_rng(1)
    shape = (4, 6, 5)
    T = _t(1400.0 + 100.0 * rng.random(shape))
    code = build_vp2_code(torch.ones(shape, dtype=torch.bool), 0)
    cols = [_t(1.0 + rng.random(4)) for _ in range(4)]
    ring = _t(1.0 + rng.random(4))
    streams = [T.clone() for _ in range(5)]
    reset_launch_counts()
    vp2_sweep_strided(None, T, code, *cols, 1e5, k_spec=PK, cp_spec=PCP)
    vp2_cyclic_phi(T, T, code, ring, ring, 1e5, k_spec=PK, cp_spec=PCP)
    vp2_sweep_z(T, T, code, _t(np.ones(5)), _t(np.ones(5)), 1e5, k_spec=PK,
                cp_spec=PCP)
    vp_fields_sweep_strided(*streams, cols[0], cols[1])
    vp_fields_cyclic_phi(*streams, ring)
    assert launch_counts() == {k: 0 for k in KERNELS}
    grad = T.clone().requires_grad_(True)
    for call in (
            lambda: vp2_sweep_strided(grad, T, code, *cols, 1e5, k_spec=PK,
                                      cp_spec=PCP),
            lambda: vp2_cyclic_phi(grad, T, code, ring, ring, 1e5,
                                   k_spec=PK, cp_spec=PCP),
            lambda: vp_fields_sweep_strided(grad, *streams[1:], cols[0],
                                            cols[1]),
            lambda: vp_fields_cyclic_phi(grad, *streams[1:], ring)):
        with pytest.raises(RuntimeError, match="forward only"):
            call()
    for call in (lambda: vp2_cyclic_phi(T[:, :1], T[:, :1], code[:, :1],
                                        ring, ring, 1e5, k_spec=PK,
                                        cp_spec=PCP),
                 lambda: vp_fields_cyclic_phi(*(s[:, :1] for s in streams),
                                              ring)):
        with pytest.raises(ValueError, match="length >= 2"):
            call()


# ---------------------------------------------------------------------------
# the spiral app
# ---------------------------------------------------------------------------

# tests/test_torch_cyl.py's small tube, hot enough to cross the mushy zone
TUBE = ["--R_out", "32", "--wall_thickness", "2", "--height", "4",
        "--z_back", "8", "--nr", "4", "--nphi", "12", "--dz", "2",
        "--pitch", "2", "--auto_speed", "--t_tot", "2", "--dt_fixed", "0.2",
        "--nframes", "2", "--out", "", "--precision", "float64",
        "--Ts", "1550"]
APP_CASES = {
    "latent": ["--latent_J_kg", "2.7e5"],
    "melt-k": ["--melt_k_factor", "3"],
    "emissivity": ["--emissivity", "0.5"],
    "douglas": ["--scheme", "douglas"],
    "douglas-varprop-torch": ["--scheme", "douglas", "--latent_J_kg",
                              "2.7e5", "--melt_k_factor", "3",
                              "--emissivity", "0.5", "--torch_Q", "2000"],
    "clamp-varprop": ["--void_mode", "clamp", "--emissivity", "0.4",
                      "--latent_J_kg", "2.7e5"],
}


@functools.cache
def _jax_app(case):
    return jax_app.run(jax_app.build_argparser().parse_args(
        TUBE + APP_CASES[case]))


@pytest.mark.parametrize("impl", ["kernels", "reference"])
@pytest.mark.parametrize("case", list(APP_CASES))
def test_varprop_spiral_app_matches_jax(case, impl):
    ref = _jax_app(case)
    got = port_app.run(port_app.build_argparser().parse_args(
        TUBE + APP_CASES[case] + ["--device", "cpu", "--implementation",
                                  impl]))
    np.testing.assert_allclose(got["T"].numpy(), _np(ref["T"]), rtol=0,
                               atol=ATOL)
    assert len(got["frames"]) == len(ref["frames"]) == 2
    for (t1, T1, a1), (t2, T2, a2) in zip(got["frames"], ref["frames"]):
        assert t1 == t2
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_allclose(T1, _np(T2), rtol=0, atol=ATOL)
    # the robin-mode tier-2 route rebuilds its codes on births only
    tier2 = (impl == "kernels" and "--scheme" not in APP_CASES[case]
             and "clamp" not in APP_CASES[case])
    assert (0 < got["plans_built"] <= got["steps"]) if tier2 \
        else got["plans_built"] == 0


# chip_smoke's spiral-app cells (0.25 mm, dt 0.05 s) on a 2 mm wall: the
# Fourier numbers at which Douglas-Gunn at theta 0.5 is not monotone
THIN_WALL = ["--R_out", "60", "--wall_thickness", "2", "--height", "2",
             "--z_back", "2", "--nr", "8", "--nphi", "180", "--dz", "0.25",
             "--pitch", "2", "--auto_speed", "--t_tot", "1", "--dt_fixed",
             "0.05", "--nframes", "1", "--out", "", "--precision", "float64",
             "--Ts", "1550", "--scheme", "douglas", "--latent_J_kg", "2.7e5",
             "--melt_k_factor", "4", "--emissivity", "0.5"]


@pytest.mark.parametrize("impl", ["kernels", "reference"])
def test_douglas_app_overshoot_matches_jax(impl):
    """The Douglas print overshoots --Ts at fine cells in the JAX app too,
    and the port follows it there."""
    ref = jax_app.run(jax_app.build_argparser().parse_args(THIN_WALL))
    got = port_app.run(port_app.build_argparser().parse_args(
        THIN_WALL + ["--device", "cpu", "--implementation", impl]))
    assert got["grid"].shape == (8, 180, 16) and got["steps"] == 20
    assert float(np.max(_np(ref["T"]))) > 1550.0
    np.testing.assert_allclose(got["T"].numpy(), _np(ref["T"]), rtol=0,
                               atol=ATOL)
