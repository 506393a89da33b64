"""The port's gradient path against the JAX package's, on the CPU: the
plain solves and the autograd Functions (the steps that run them:
tests/test_torch_grad_steps.py).

Same inputs, made from a seed with numpy, go through the JAX function and
the port's counterpart at float64; the JAX Pallas kernels run in interpret
mode, as tests/test_theta_sweep.py:123 runs them.  Tolerances:

* F1: autograd through the port's ``thomas`` and ``cyclic_thomas``
  against ``jax.grad`` through the JAX scan solves: 1e-12 relative;
* F3: a kernel wrapper called under grad mode with an input that
  requires grad raises; inside ``torch.no_grad`` it runs;
* the eight Functions of solvers/differentiable.py against ``jax.grad``
  through the JAX wrappers (the tier-2 pair through their JAX
  definition, ``vp2_streams_xla`` -> ``vp_sweep_solve``, whose kernels
  take float32 only), every input's cotangent: 1e-9 relative;
* each Function's hand pullback against autograd through its plain
  version: 1e-11 relative;
* the bfloat16 route of ``adi_step_fused`` refuses a gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adi_thermal_fields_tpu.solvers import differentiable as jd
from adi_thermal_fields_tpu.solvers import pallas_vp2 as jvp2
from adi_thermal_fields_tpu.solvers.pallas_sweeps import sweep_code as j_code
from adi_thermal_fields_tpu.solvers.thomas import cyclic_thomas as j_cyc
from adi_thermal_fields_tpu.solvers.thomas import thomas as j_thomas
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          adi_step_fused, apparent_cp,
                                          build_sweep_plan,
                                          melt_pool_enhanced_k)
from adi_thermal_fields_tpu_torch.solvers import differentiable as pd
from adi_thermal_fields_tpu_torch.solvers import (fused_theta_sweep,
                                                  sweep_code, sweep_strided,
                                                  theta_rhs, tridiag_fields)
from adi_thermal_fields_tpu_torch.solvers.stencil import theta_rhs_plain
from adi_thermal_fields_tpu_torch.solvers.sweeps import (sweep_strided_plain,
                                                         sweep_z_plain)
from adi_thermal_fields_tpu_torch.solvers.theta_sweep import (
    fused_theta_sweep_plain)
from adi_thermal_fields_tpu_torch.solvers.thomas import (cyclic_thomas,
                                                         thomas)
from adi_thermal_fields_tpu_torch.solvers.vp2 import (build_vp2_code,
                                                      vp2_cyclic_phi_plain,
                                                      vp2_sweep_strided_plain,
                                                      vp2_sweep_z_plain)
from adi_thermal_fields_tpu_torch.solvers.vpfields import (
    vp_fields_cyclic_phi_plain, vp_fields_sweep_strided_plain,
    vp_fields_sweep_z_plain)

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
    """The port's gradients of ``sum(w * fn(*args))`` w.r.t. every
    argument that requires grad."""
    ins = [a for a in args if torch.is_tensor(a) and a.requires_grad]
    return torch.autograd.grad((torch.as_tensor(w) * fn(*args)).sum(), ins)


def _jgrad(fn, args, argnums, w):
    return jax.jit(jax.grad(lambda *a: jnp.sum(jnp.asarray(w) * fn(*a)),
                            argnums=argnums))(*args)


# ---------------------------------------------------------------------------
# F1: autograd through the plain solves
# ---------------------------------------------------------------------------

def _rows(rng, shape):
    a = -rng.random(shape)
    c = -rng.random(shape)
    b = 1.0 + 2.0 * rng.random(shape) - a - c
    return a, b, c, 20.0 + 1480.0 * rng.random(shape)


@pytest.mark.parametrize("cyclic", [False, True], ids=["open", "cyclic"])
def test_thomas_autograd_matches_jax(cyclic):
    rng = np.random.default_rng(3)
    rows = _rows(rng, (9, 4, 3))
    w = rng.standard_normal((9, 4, 3))
    port, jax_fn = (cyclic_thomas, j_cyc) if cyclic else (thomas, j_thomas)
    got = _pgrad(port, [_t(r, True) for r in rows], w)
    want = _jgrad(jax_fn, [jnp.asarray(r) for r in rows], (0, 1, 2, 3), w)
    for i, (g, j) in enumerate(zip(got, want)):
        _close(g, j, 1e-12, f"row stream {i}")


def test_thomas_values_unchanged_by_the_stack():
    """The rows gathered in lists give the values of the old ``out=``
    loops: the same operations in the same order (here against a numpy
    Thomas in that order, bit for bit)."""
    rng = np.random.default_rng(4)
    a, b, c, d = _rows(rng, (7, 5))
    n = 7
    cp, dp = np.zeros_like(d), np.zeros_like(d)
    cprev = dprev = np.zeros(5)
    for i in range(n):
        den = b[i] - a[i] * cprev
        cp[i], dp[i] = c[i] / den, (d[i] - a[i] * dprev) / den
        cprev, dprev = cp[i], dp[i]
    x = np.zeros_like(d)
    nxt = np.zeros(5)
    for i in range(n - 1, -1, -1):
        x[i] = dp[i] - cp[i] * nxt
        nxt = x[i]
    assert np.array_equal(thomas(*(_t(v) for v in (a, b, c, d))).numpy(), x)


# ---------------------------------------------------------------------------
# F3: the kernel wrappers' guard
# ---------------------------------------------------------------------------

def test_kernel_wrappers_raise_under_grad_and_run_without():
    mask = torch.ones((4, 5, 6), dtype=torch.bool)
    T = torch.full((4, 5, 6), 100.0, dtype=F64, requires_grad=True)
    code0 = sweep_code(mask, None, 0, stencil_bits=True)
    rows = torch.ones((4, 5, 6), dtype=F64)
    calls = [
        lambda: sweep_strided(T, code0, 0.2, 0.05, 20.0, axis=0, rob_c=1e-3),
        lambda: theta_rhs(T, mask.to(torch.uint8), 1e-7, 1e6),
        lambda: fused_theta_sweep(T, code0, 1e-7, 1e6, 0.2, 0.05, 20.0, 1e-3),
        lambda: tridiag_fields(-0.1 * rows, 3 * rows, -0.1 * rows, T, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward only"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()).all()


# ---------------------------------------------------------------------------
# the eight Functions against jax.grad through the JAX wrappers
# ---------------------------------------------------------------------------

SHAPE = (7, 6, 5)


def _sweep_inputs(seed, axis, dirichlet):
    rng = np.random.default_rng(seed)
    mask = rng.random(SHAPE) > 0.25
    dirm = (rng.random(SHAPE) > 0.85) if dirichlet else None
    rhs = 100 * rng.random(SHAPE)
    coeff = np.where(rng.random(SHAPE) > 0.5, 0.3, 0.0) * mask
    q = rng.random(SHAPE) * mask
    dval = 500 * rng.random(SHAPE)
    pcode = sweep_code(torch.from_numpy(mask),
                       None if dirm is None else torch.from_numpy(dirm),
                       axis).movedim(0, axis).contiguous()
    jcode = j_code(jnp.asarray(mask), None if dirm is None else
                   jnp.asarray(dirm), axis)
    jcode = jcode if axis == 2 else jnp.moveaxis(jcode, 0, axis)
    return rng, rhs, coeff, q, dval, pcode, jcode


@pytest.mark.parametrize("axis", [0, 1])
def test_sweep_solve_matches_jax(axis):
    rng, rhs, coeff, q, dval, pcode, jcode = _sweep_inputs(axis, axis, True)
    w = rng.standard_normal(SHAPE)
    scal = (0.37, 0.05, 20.0)
    got = _pgrad(lambda r, c, tg, dt, ti, qq, dv: pd.sweep_solve(
        r, pcode, c, tg, dt, ti, qq, dv, axis=axis),
        [_t(v, True) for v in (rhs, coeff, *scal, q, dval)], w)
    want = _jgrad(lambda r, c, tg, dt, ti, qq, dv: jd.sweep_solve(
        r, jcode, c, tg, dt, ti, qq, dv, axis=axis, interpret=True),
        [jnp.asarray(v) for v in (rhs, coeff, *scal, q, dval)],
        tuple(range(7)), w)
    for i, (g, j) in enumerate(zip(got, want)):
        _close(g, j, RTOL, f"input {i}")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_solve_lite_matches_jax(axis):
    rng, rhs, _, q, _, pcode, jcode = _sweep_inputs(10 + axis, axis, False)
    w = rng.standard_normal(SHAPE)
    scal = (0.0031, 0.37, 0.05, 20.0)
    extra = () if axis == 2 else (q,)      # JAX's natural z takes no qflux
    got = _pgrad(lambda r, *a: pd.sweep_solve_lite(r, pcode, *a, axis=axis),
                 [_t(v, True) for v in (rhs, *scal, *extra)], w)
    want = _jgrad(lambda r, *a: jd.sweep_solve_lite(
        r, jcode, *a, axis=axis, interpret=True),
        [jnp.asarray(v) for v in (rhs, *scal, *extra)],
        tuple(range(5 + len(extra))), w)
    for i, (g, j) in enumerate(zip(got, want)):
        _close(g, j, RTOL, f"input {i}")


def _stencil_inputs(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(SHAPE) > 0.25
    T = np.where(mask, 20 + 1480 * rng.random(SHAPE), 20.0)
    return rng, mask, T


@pytest.mark.parametrize("per_axis", [False, True], ids=["cubic", "axes"])
def test_theta_rhs_diff_matches_jax(per_axis):
    rng, mask, T = _stencil_inputs(21)
    w = rng.standard_normal(SHAPE)
    inv = [1e6, 1.1e6, 0.9e6] if per_axis else 1.2e6
    got = _pgrad(lambda t, c, iv: pd.theta_rhs_diff(
        t, torch.from_numpy(mask).to(torch.uint8), c, iv),
        [_t(T, True), _t(1.3e-8, True), _t(inv, True)], w)
    want = _jgrad(lambda t, c, iv: jd.theta_rhs_diff(
        t, jnp.asarray(mask).astype(jnp.int8), c, iv, interpret=True),
        [jnp.asarray(T), 1.3e-8, jnp.asarray(inv)], (0, 1, 2), w)
    for name, g, j in zip(("T", "c", "inv"), got, want):
        _close(g, j, RTOL, name)


def test_fused_theta_solve_lite_matches_jax():
    rng, mask, T = _stencil_inputs(22)
    w = rng.standard_normal(SHAPE)
    pcode = sweep_code(torch.from_numpy(mask), None, 0, stencil_bits=True)
    jcode = j_code(jnp.asarray(mask), None, 0, stencil_bits=True)
    scal = (1.3e-8, [1e6, 1.1e6, 0.9e6], 0.0031, 0.21, 0.05, 20.0)
    got = _pgrad(lambda t, *a: pd.fused_theta_solve_lite(t, pcode, *a),
                 [_t(T, True)] + [_t(v, True) for v in scal], w)
    want = _jgrad(lambda t, *a: jd.fused_theta_solve_lite(
        t, jcode, *a, interpret=True),
        [jnp.asarray(T)] + [jnp.asarray(v) for v in scal], tuple(range(7)),
        w)
    for i, (g, j) in enumerate(zip(got, want)):
        _close(g, j, RTOL, f"input {i}")


def _streams(seed, shape):
    rng = np.random.default_rng(seed)
    return rng, [100 * rng.random(shape), 40 * rng.random(shape),
                 1e-5 * rng.random(shape), 30 * rng.random(shape),
                 300 * rng.random(shape)]


@pytest.mark.parametrize("axis", [0, 2], ids=["r", "z"])
def test_vp_sweep_solve_matches_jax(axis):
    rng, st = _streams(30 + axis, SHAPE)
    n = SHAPE[axis]
    glo, ghi = 1e5 + 1e6 * rng.random(n), 1e5 + 1e6 * rng.random(n)
    w = rng.standard_normal(SHAPE)
    got = _pgrad(lambda *s: pd.vp_sweep_solve(*s, _t(glo), _t(ghi),
                                              axis=axis),
                 [_t(v, True) for v in st], w)
    # JAX's z solve takes natural rhs/out beside z-leading streams
    zl = ((lambda v: v) if axis == 0 else
          (lambda v: jnp.transpose(v, (2, 0, 1))))
    want = _jgrad(lambda r, *s: jd.vp_sweep_solve(
        r, *(zl(v) for v in s), jnp.asarray(glo), jnp.asarray(ghi),
        interpret=True, nat_rhs_out=axis == 2),
        [jnp.asarray(v) for v in st], tuple(range(5)), w)
    for i, (g, j) in enumerate(zip(got, want)):
        _close(g, j, RTOL, f"stream {i}")


def test_vp_cyclic_solve_matches_jax():
    rng, st = _streams(40, SHAPE)
    geo = 1e5 + 1e6 * rng.random(SHAPE[0])
    w = rng.standard_normal(SHAPE)
    got = _pgrad(lambda *a: pd.vp_cyclic_solve(*a),
                 [_t(v, True) for v in st] + [_t(geo, True)], w)
    geo2 = np.broadcast_to(geo[:, None], (SHAPE[0], SHAPE[2]))
    want = _jgrad(lambda *a: jd.vp_cyclic_solve(*a, interpret=True),
                  [jnp.asarray(v) for v in st] + [jnp.asarray(geo2)],
                  tuple(range(6)), w)
    for i, (g, j) in enumerate(zip(got[:5], want[:5])):
        _close(g, j, RTOL, f"stream {i}")
    _close(got[5], np.asarray(want[5]).sum(1), RTOL, "geo (per ring)")


def _vp2_case(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    act = rng.random(shape) > 0.3
    T = 100.0 + 1400.0 * rng.random(shape)
    tabs_p = (melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
              apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0))
    tabs_j = tuple(jcv._table_spec(t, 0.0) for t in (
        jcv.melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
        jcv.apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0)))
    return rng, act, T, tabs_p, tabs_j


@pytest.mark.parametrize("axis,rhs_is_T", [(0, False), (0, True),
                                           (2, False)],
                         ids=["r", "r-rhs-T", "z"])
def test_vp2_sweep_solve_matches_jax_definition(axis, rhs_is_T):
    """The tier-2 open sweep's gradient w.r.t. rhs, T and dtor against
    jax.grad of its JAX definition at float64: the streams from T
    (``vp2_streams_xla``) solved by ``vp_sweep_solve`` (the JAX tier-2
    kernel takes float32 only)."""
    rng, act, T, (kp, cpp), (kj, cpj) = _vp2_case(50 + axis)
    n = SHAPE[axis]
    cols = [1e5 + 1e6 * rng.random(n) for _ in range(2)] + \
        [1e2 + 1e3 * rng.random(n) for _ in range(2)]
    rhs = 100.0 + 1400.0 * rng.random(SHAPE)
    w = rng.standard_normal(SHAPE)
    edges = ((300.0, 1e3, 25.0), (80.0, 2e3, 30.0))
    films = (50.0, 120.0, 20.0, 0.5)
    pcode = build_vp2_code(torch.from_numpy(act), axis)
    jcode = jvp2.build_vp2_code(jnp.asarray(act), axis)
    spec = (kp, cpp, *films, *edges)
    dtor = 0.02 / 7800.0

    def port(r, T, d):
        return pd.vp2_sweep_solve(None if rhs_is_T else r, T, pcode,
                                  *(_t(c) for c in cols), d, spec=spec,
                                  axis=axis)

    zl = ((lambda v: v) if axis == 0 else
          (lambda v: jnp.transpose(v, (2, 0, 1))))

    def jx(r, T, d):
        fhi, dw, sink, srhs = jvp2.vp2_streams_xla(
            zl(T), zl(jcode), jnp.asarray(cols[2]), jnp.asarray(cols[3]), d,
            k_spec=kj, cp_spec=cpj, h_lo=films[0], h_hi=films[1],
            tinf_void=films[2], emissivity=films[3], edge0=edges[0],
            edge1=edges[1])
        return jd.vp_sweep_solve(T if rhs_is_T else r, fhi, dw, sink, srhs,
                                 jnp.asarray(cols[0]), jnp.asarray(cols[1]),
                                 interpret=True, nat_rhs_out=axis == 2)

    args_p = [_t(rhs, not rhs_is_T), _t(T, True), _t(dtor, True)]
    got = _pgrad(port, args_p, w)
    want = _jgrad(jx, [jnp.asarray(rhs), jnp.asarray(T), dtor],
                  (1, 2) if rhs_is_T else (0, 1, 2), w)
    for i, (g, j) in enumerate(zip(got, want)):
        _close(g, j, RTOL, f"input {i}")


def test_vp2_cyclic_solve_matches_jax_definition():
    rng, act, T, (kp, cpp), (kj, cpj) = _vp2_case(60)
    geo, gs = 1e5 + 1e6 * rng.random(SHAPE[0]), 1e3 * rng.random(SHAPE[0])
    rhs = 100.0 + 1400.0 * rng.random(SHAPE)
    w = rng.standard_normal(SHAPE)
    pcode = build_vp2_code(torch.from_numpy(act), 1, periodic=True)
    jcode = jvp2.build_vp2_code(jnp.asarray(act), 1, periodic=True)
    plane = (lambda v: jnp.broadcast_to(jnp.asarray(v)[:, None],
                                        (SHAPE[0], SHAPE[2])))

    def jx(r, T, d):
        flo, dw, sink, srhs = jvp2.vp2_cyclic_streams_xla(
            T, jcode, plane(gs), d, k_spec=kj, cp_spec=cpj, h_void=50.0,
            tinf_void=20.0, emissivity=0.5)
        return jd.vp_cyclic_solve(r, flo, dw, sink, srhs, plane(geo),
                                  interpret=True)

    got = _pgrad(lambda r, T, d: pd.vp2_cyclic_solve(
        r, T, pcode, _t(geo), _t(gs), d, spec=(kp, cpp, 50.0, 20.0, 0.5)),
        [_t(rhs, True), _t(T, True), _t(0.02 / 7800.0, True)], w)
    want = _jgrad(jx, [jnp.asarray(rhs), jnp.asarray(T), 0.02 / 7800.0],
                  (0, 1, 2), w)
    for i, (g, j) in enumerate(zip(got, want)):
        _close(g, j, RTOL, f"input {i}")


# ---------------------------------------------------------------------------
# each Function's hand pullback against autograd through its plain version
# ---------------------------------------------------------------------------

def _plain_cases():
    """(name, Function call, plain call, inputs) on one seeded set."""
    rng = np.random.default_rng(70)
    mask = rng.random(SHAPE) > 0.25
    dirm = rng.random(SHAPE) > 0.85
    fld = (lambda s=100.0: _t(s * rng.random(SHAPE), True))
    sc = (lambda v: _t(v, True))
    out = []
    for axis in (0, 1, 2):
        code = sweep_code(torch.from_numpy(mask), torch.from_numpy(dirm),
                          axis).movedim(0, axis).contiguous()
        plain = (sweep_z_plain if axis == 2 else
                 (lambda *a, axis=axis, **k: sweep_strided_plain(
                     *a, axis=axis, **k)))
        coeff = _t(np.where(rng.random(SHAPE) > 0.5, 0.3, 0.0) * mask, True)
        out.append((f"sweep_solve {axis}",
                    lambda r, c, tg, dt, ti, q, dv, code=code, axis=axis:
                    pd.sweep_solve(r, code, c, tg, dt, ti, q, dv, axis=axis),
                    lambda r, c, tg, dt, ti, q, dv, code=code, plain=plain:
                    plain(r, code, tg, dt, ti, coeff=c, qflux=q, dir_val=dv),
                    [fld(), coeff, sc(0.37), sc(0.05), sc(20.0), fld(1.0),
                     fld(500.0)]))
        lcode = sweep_code(torch.from_numpy(mask), None,
                           axis).movedim(0, axis).contiguous()
        out.append((f"sweep_solve_lite {axis}",
                    lambda r, rc, tg, dt, ti, q, code=lcode, axis=axis:
                    pd.sweep_solve_lite(r, code, rc, tg, dt, ti, q,
                                        axis=axis),
                    lambda r, rc, tg, dt, ti, q, code=lcode, plain=plain:
                    plain(r, code, tg, dt, ti, rob_c=rc, qflux=q),
                    [fld(), sc(0.0031), sc(0.37), sc(0.05), sc(20.0),
                     fld(1.0)]))
    mu8 = torch.from_numpy(mask).to(torch.uint8)
    inv = (1e6, 1.1e6, 0.9e6)
    out.append(("theta_rhs_diff", lambda T, c: pd.theta_rhs_diff(
        T, mu8, c, inv), lambda T, c: theta_rhs_plain(T, mu8, c, inv),
        [fld(1500.0), sc(1.3e-8)]))
    code0 = sweep_code(torch.from_numpy(mask), None, 0, stencil_bits=True)
    out.append(("fused_theta_solve_lite",
                lambda T, ce, rc, tg, dt, ti: pd.fused_theta_solve_lite(
                    T, code0, ce, inv, rc, tg, dt, ti),
                lambda T, ce, rc, tg, dt, ti: fused_theta_sweep_plain(
                    T, code0, ce, inv, tg, dt, ti, rc),
                [fld(1500.0), sc(1.3e-8), sc(0.0031), sc(0.21), sc(0.05),
                 sc(20.0)]))
    cols = {n: _t(1e5 + 1e6 * rng.random(n)) for n in set(SHAPE)}
    streams = (lambda: [fld(), fld(40.0), fld(1e-5), fld(30.0), fld(300.0)])
    out.append(("vp_sweep_solve r", lambda *s: pd.vp_sweep_solve(
        *s, cols[7], cols[7], axis=0),
        lambda *s: vp_fields_sweep_strided_plain(*s, cols[7], cols[7]),
        streams()))
    out.append(("vp_sweep_solve z", lambda *s: pd.vp_sweep_solve(
        *s, cols[5], cols[5], axis=2),
        lambda *s: vp_fields_sweep_z_plain(*s, cols[5], cols[5]),
        streams()))
    out.append(("vp_cyclic_solve", lambda *s: pd.vp_cyclic_solve(
        *s, cols[7]),
        lambda *s: vp_fields_cyclic_phi_plain(*s, cols[7]), streams()))
    act = torch.from_numpy(rng.random(SHAPE) > 0.3)
    kp = melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0)
    cpp = apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0)
    edges = ((300.0, 1e3, 25.0), (80.0, 2e3, 30.0))
    spec = (kp, cpp, 50.0, 120.0, 20.0, 0.5, *edges)
    kw = dict(k_spec=kp, cp_spec=cpp, emissivity=0.5, edge0=edges[0],
              edge1=edges[1])
    for axis, plain in ((0, lambda r, T, c, d, n: vp2_sweep_strided_plain(
            r, T, c, n, n, n, n, 1.0 / d, h_lo=50.0, h_hi=120.0,
            tinf_void=20.0, **kw)),
            (2, lambda r, T, c, d, n: vp2_sweep_z_plain(
                r, T, c, n, n, 1.0 / d, h=50.0, t_inf=20.0, ghi=n, gsh=n,
                h_hi=120.0, **kw))):
        code = build_vp2_code(act, axis)
        n = cols[SHAPE[axis]]
        out.append((f"vp2_sweep_solve {axis}",
                    lambda r, T, d, code=code, n=n, axis=axis:
                    pd.vp2_sweep_solve(r, T, code, n, n, n, n, d, spec=spec,
                                       axis=axis),
                    lambda r, T, d, code=code, n=n, plain=plain:
                    plain(r, T, code, d, n),
                    [fld(1500.0), fld(1500.0), sc(0.02 / 7800.0)]))
    pcode = build_vp2_code(act, 1, periodic=True)
    out.append(("vp2_cyclic_solve", lambda r, T, d: pd.vp2_cyclic_solve(
        r, T, pcode, cols[7], cols[7], d, spec=(kp, cpp, 50.0, 20.0, 0.5)),
        lambda r, T, d: vp2_cyclic_phi_plain(
            r, T, pcode, cols[7], cols[7], 1.0 / d, k_spec=kp, cp_spec=cpp,
            h_void=50.0, tinf_void=20.0, emissivity=0.5),
        [fld(1500.0), fld(1500.0), sc(0.02 / 7800.0)]))
    return out


@pytest.mark.parametrize("case", _plain_cases(), ids=lambda c: c[0])
def test_function_pullback_matches_autograd_through_plain(case):
    name, fn, plain, args = case
    w = np.random.default_rng(71).standard_normal(SHAPE)
    assert torch.equal(fn(*args), plain(*args).to(F64))
    for g, j in zip(_pgrad(fn, args, w), _pgrad(plain, args, w)):
        _close(g, j.numpy(), 1e-11, name)


def test_bf16_route_refuses_a_gradient():
    mask = torch.ones((4, 5, 6), dtype=torch.bool)
    grid, mat = CartesianGrid(4, 5, 6, 1e-3), Material(*MAT)
    plan = build_sweep_plan(mask, None, has_neumann=False,
                            has_dirichlet=False, robin_const=1e-3)
    T = torch.full((4, 5, 6), 900.0, dtype=torch.bfloat16)
    for seed in (None, 3):
        with pytest.raises(ValueError, match="not differentiable"):
            adi_step_fused(T.clone().requires_grad_(True), plan, grid, mat,
                           dt=0.05, rng_seed=seed)
        with pytest.raises(ValueError, match="not differentiable"):
            adi_step_fused(T, plan, grid, mat, dt=_t(0.05, True),
                           rng_seed=seed)
        out = adi_step_fused(T, plan, grid, mat, dt=_t(0.05), rng_seed=seed)
        assert torch.equal(out, adi_step_fused(T, plan, grid, mat, dt=0.05,
                                               rng_seed=seed))
