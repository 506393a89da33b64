"""The classic varprop tier at bfloat16 against the JAX package, on the CPU.

The bfloat16 entries K5b, K6b, K7b, K7xb, K19b and K20b (their plain
versions here) and ``adi_step_varprop_fused`` on the routes that the
g-stream tier does not take.  Same inputs, made from a seed with numpy, go
through the JAX function at bfloat16 (its Pallas kernels in interpret mode,
rounding to nearest: interpret mode has no stochastic rounding) and the
port's counterpart.  Tolerances, in bfloat16 ulps at each cell (the spacing
of bfloat16 numbers at the larger of the two values):

* each plain version against its JAX kernel: at most one ulp (both solve at
  float32 and round once; the JAX kernels contract some products, so a
  value near a rounding boundary may land on the other side);
* the seeded plain versions: bit for bit ``round_bf16`` of their float32
  result under ``sr_key(seed, offset)``;
* ``adi_step_varprop_fused`` against JAX's classic step at bfloat16
  (``gstreams=False``): at most one ulp, also where the JAX step rebuilds
  z's faces and 1/(rho cp) on the (z, x, y) transposes from k and cp
  rounded to bfloat16 first (JAX cartesian_varprop.py:718-752; the port's
  z sweep reads K5's faces, rounded once: the rebuilt faces are up to one
  ulp apart, and on these cases the step stays within one);
* the engine's corrected configuration: round-to-nearest cools less than
  half as much as float32, the stochastic run within the drift envelope
  of tests/test_bf16_drift.py (max < 21 K, mean < 2.5 K).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import Material as JMaterial
from adi_thermal_fields_tpu.solvers import pallas_varprop as jpv
from adi_thermal_fields_tpu.solvers.pallas_sweeps import (
    sweep_code as j_sweep_code)
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          adi_step_varprop_fused,
                                          apparent_cp, build_varprop_codes,
                                          melt_pool_enhanced_k)
from adi_thermal_fields_tpu_torch.apps.engine import make_cartesian_engine
from adi_thermal_fields_tpu_torch.solvers import (
    sweep_code, varprop_fields_plain, varprop_sweep_x_plain,
    varprop_sweep_y_plain, varprop_sweep_z_plain, varprop_theta_rhs_plain,
    varprop_theta_sweep_plain)
from adi_thermal_fields_tpu_torch.solvers.rounding import round_bf16, sr_key
from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
    build_face_h_axes)

torch.set_num_threads(1)

BF = torch.bfloat16
FACES = ("x-", "x+", "y-", "y+", "z-", "z+")
RHO, CP, K = 7800.0, 490.0, 54.0
# solidus and liquidus on bfloat16 numbers, so that cells sit exactly on
# the tables' breakpoints
SOL, LIQ = 1416.0, 1472.0
SHAPE = (12, 10, 14)
SPACING = dict(dy=1.3e-3, dz=0.8e-3)
DT, T_INF = 0.02, 20.0


def _bf16_ulps(got, want):
    """|got - want| in bfloat16 ulps at the larger of the two values."""
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    return np.abs(got - want) / ulp


def _ulps(got, want):
    return _bf16_ulps(got.float().numpy(),
                      np.asarray(jnp.asarray(want).astype(jnp.float32)))


def _case(seed=0):
    """tests/test_gstreams.py's grid (anisotropic voxels, a void notch and
    a void column), T over 20-1600 C at bfloat16 with cells exactly at the
    solidus and the liquidus, and a bfloat16 film and source."""
    rng = np.random.default_rng(seed)
    mask = np.ones(SHAPE, bool)
    mask[7:, 2:5, :6] = False
    mask[0, :, -3:] = False
    T = 20.0 + 1580.0 * rng.random(SHAPE)
    T.reshape(-1)[::11] = SOL
    T.reshape(-1)[5::13] = LIQ
    T = np.where(mask, T, 20.0)
    bf = (lambda a: torch.from_numpy(a.astype(np.float32)).to(BF))
    return (mask, bf(T), bf(5.0 + 40.0 * rng.random(SHAPE)),
            bf(1e8 * rng.random(SHAPE)), bf(20.0 + 1480.0 * rng.random(SHAPE)))


def _tables():
    """(JAX, port) k and cp tables: the melt-pool k and the apparent cp."""
    return ((jcv.melt_pool_enhanced_k(K, SOL, LIQ, enhancement=4.0),
             jcv.apparent_cp(CP, 520.0, 2.7e5, SOL, LIQ)),
            (melt_pool_enhanced_k(K, SOL, LIQ, enhancement=4.0),
             apparent_cp(CP, 520.0, 2.7e5, SOL, LIQ)))


def _j(t):
    """A bfloat16 (or other) torch tensor as a JAX array of its dtype."""
    if t.dtype == BF:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _step_form(x):
    """A scalar as the JAX step passes it: the dt-derived scalars are
    float32 arrays there.  With the step's keywords (``rng_seed=None``)
    the kernels' compiles here then serve the step tests below (JAX's jit
    caches by the arguments' types and keywords)."""
    return jnp.float32(x)


def _scalars():
    """(cw, inv_d2, tg per axis, sk per axis) at float32, the JAX step's
    op order."""
    f = np.float32
    g = CartesianGrid(*SHAPE, 1e-3, **SPACING)
    dt = f(DT)
    inv_d2 = [1.0 / (d * d) for d in g.spacing]
    return (float(f(0.5) * dt), inv_d2,
            [float(f(0.5) * dt * f(iv)) for iv in inv_d2],
            [float(dt / f(d)) for d in g.spacing])


def _streams(mask, T, film):
    """K5b's fields from the port's plain version: (fx, fy, fz), w, h."""
    (_, _), (kt, ct) = _tables()
    m8 = torch.from_numpy(mask).to(torch.uint8)
    fc, w, h = varprop_fields_plain(T, m8, k_spec=kt, cp_spec=ct, rho=RHO,
                                    rad=(0.5, T_INF, 15.0))
    return fc, w, (h if film == "h" else None)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels at bfloat16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("film", [False, True], ids=["no_film", "film"])
def test_varprop_fields_bf16_matches_jax(film):
    """K5b's plain version: the three faces, w and the radiative film,
    float32 from a bfloat16 T, rounded to nearest, against JAX
    ``varprop_fields`` at bfloat16 (interpret): within one ulp."""
    mask, T, _, _, _ = _case(1)
    (jkt, jct), (kt, ct) = _tables()
    rad = (0.5, T_INF, 15.0) if film else None
    m8 = torch.from_numpy(mask).to(torch.uint8)
    got = varprop_fields_plain(T, m8, k_spec=kt, cp_spec=ct, rho=RHO,
                               rad=rad)
    want = jpv.varprop_fields(
        _j(T), jnp.asarray(mask, jnp.int8), k_spec=jcv._table_spec(jkt, K),
        cp_spec=jcv._table_spec(jct, CP), rho=RHO, rad=rad, interpret=True)
    outs = [*got[0], *got[1:]]
    wants = [*want[0], *want[1:]]
    assert len(outs) == (5 if film else 4)
    for g, w in zip(outs, wants):
        assert g.dtype == BF
        assert _ulps(g, w).max() <= 1.0


@pytest.mark.parametrize("variant", ["h", "rob_c", "src"])
def test_theta_sweep_bf16_matches_jax(variant):
    """K6b's plain version (R0 kept at float32, U rounded to nearest)
    against JAX ``fused_varprop_theta_sweep`` at bfloat16: with the film
    stream, with the scalar rob_c, and with a source."""
    mask, T, _, src, _ = _case(2)
    cw, inv_d2, tg, sk = _scalars()
    fc, w, h = _streams(mask, T, "h" if variant == "h" else None)
    s = src if variant == "src" else None
    kw = dict(rob_c=0.0 if variant == "h" else 15.0, dt=float(np.float32(DT)))
    code = sweep_code(torch.from_numpy(mask), None, 0)
    got = varprop_theta_sweep_plain(T, code, *fc, w, cw, inv_d2, tg[0],
                                    sk[0], T_INF, h=h, src=s, **kw)
    want = jpv.fused_varprop_theta_sweep(
        _j(T), j_sweep_code(jnp.asarray(mask), None, 0),
        *(_j(f) for f in fc), _j(w), _step_form(cw), inv_d2,
        _step_form(tg[0]), _step_form(sk[0]), T_INF,
        h=None if h is None else _j(h), src=None if s is None else _j(s),
        rng_seed=None, interpret=True,
        **dict(kw, dt=_step_form(kw["dt"])))
    assert got.dtype == BF
    assert _ulps(got, want).max() <= 1.0
    assert torch.equal(got[~torch.from_numpy(mask)].float(),
                       T[~torch.from_numpy(mask)].float())


@pytest.mark.parametrize("with_src", [False, True], ids=["no_src", "src"])
def test_theta_rhs_bf16_matches_jax(with_src):
    """K20b's plain version (R0 rounded to nearest) against JAX
    ``varprop_theta_rhs`` at bfloat16."""
    mask, T, _, src, _ = _case(3)
    cw, inv_d2, _, _ = _scalars()
    fc, w, _ = _streams(mask, T, None)
    dt = float(np.float32(DT))
    kw = dict(src=src, dt=dt) if with_src else {}
    got = varprop_theta_rhs_plain(T, *fc, w,
                                  torch.from_numpy(mask).to(torch.uint8), cw,
                                  inv_d2, **kw)
    want = jpv.varprop_theta_rhs(
        _j(T), *(_j(f) for f in fc), _j(w), jnp.asarray(mask, jnp.int8),
        _step_form(cw), inv_d2, src=_j(src) if with_src else None,
        dt=_step_form(dt), rng_seed=None, interpret=True)
    assert got.dtype == BF
    assert _ulps(got, want).max() <= 1.0


@pytest.mark.parametrize("film", ["h", "rob_c"])
@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
def test_sweeps_bf16_match_jax(axis, film):
    """K7xb (x: ``fused_varprop_sweep``), K7b (y:
    ``fused_varprop_sweep_axis1``) and K19b (z: ``fused_varprop_sweep``
    with ``nat_rhs_out=True``, its streams z-leading) plain versions against
    the JAX kernels at bfloat16, rounding to nearest."""
    mask, T, _, _, R = _case(4 + axis)
    _, _, tg, sk = _scalars()
    fc, w, h = _streams(mask, T, film)
    jm = jnp.asarray(mask)
    mt = torch.from_numpy(mask)
    kw = dict(rob_c=15.0)
    plain = (varprop_sweep_x_plain, varprop_sweep_y_plain,
             varprop_sweep_z_plain)[axis]
    code = sweep_code(mt, None, axis).movedim(0, axis).contiguous()
    got = plain(R, code, fc[axis], w, tg[axis], sk[axis], T_INF, h=h, **kw)
    if axis == 1:
        want = jpv.fused_varprop_sweep_axis1(
            _j(R), jnp.moveaxis(j_sweep_code(jm, None, 1), 0, 1),
            _j(fc[1]), _j(w), _step_form(tg[1]), _step_form(sk[1]), T_INF,
            h=None if h is None else _j(h), rng_seed=None, interpret=True,
            **kw)
    else:
        lay = ((lambda a: a) if axis == 0 else
               (lambda a: jnp.moveaxis(a, 2, 0)))
        nat = {"nat_rhs_out": True} if axis == 2 else {}
        want = jpv.fused_varprop_sweep(
            _j(R), j_sweep_code(jm, None, axis), lay(_j(fc[axis])),
            lay(_j(w)), _step_form(tg[axis]), _step_form(sk[axis]), T_INF,
            h=None if h is None else lay(_j(h)), rng_seed=None,
            interpret=True, **nat, **kw)
    assert got.dtype == BF
    assert _ulps(got, want).max() <= 1.0


def test_seeded_plain_versions_round_their_float32_result():
    """Each seeded plain version equals ``round_bf16`` of its float32
    result (the same inputs widened) under ``sr_key(seed, offset)`` bit for
    bit, and its nearest form the same result rounded to nearest; the seed
    and the offset both move the realisation."""
    mask, T, _, src, R = _case(7)
    cw, inv_d2, tg, sk = _scalars()
    fc, w, h = _streams(mask, T, "h")
    m8 = torch.from_numpy(mask).to(torch.uint8)
    mt = torch.from_numpy(mask)
    codes = [sweep_code(mt, None, ax).movedim(0, ax).contiguous()
             for ax in range(3)]
    dt = float(np.float32(DT))
    calls = {
        "K20b": (varprop_theta_rhs_plain,
                 lambda c: (c(T), *map(c, fc), c(w), m8, cw, inv_d2),
                 lambda c: dict(src=c(src), dt=dt), 0),
        "K6b": (varprop_theta_sweep_plain,
                lambda c: (c(T), codes[0], *map(c, fc), c(w), cw, inv_d2,
                           tg[0], sk[0], T_INF),
                lambda c: dict(h=c(h), src=c(src), dt=dt), 1),
        "K7xb": (varprop_sweep_x_plain,
                 lambda c: (c(R), codes[0], c(fc[0]), c(w), tg[0], sk[0],
                            T_INF), lambda c: dict(h=c(h)), 1),
        "K7b": (varprop_sweep_y_plain,
                lambda c: (c(R), codes[1], c(fc[1]), c(w), tg[1], sk[1],
                           T_INF), lambda c: dict(h=c(h)), 2),
        "K19b": (varprop_sweep_z_plain,
                 lambda c: (c(R), codes[2], c(fc[2]), c(w), tg[2], sk[2],
                            T_INF), lambda c: dict(rob_c=15.0), 3)}
    same = (lambda t: t)
    wide = (lambda t: t.float())
    bits = (lambda t: t.view(torch.int16))
    for name, (fn, args, kw, off) in calls.items():
        x32 = fn(*args(wide), **kw(wide))
        assert x32.dtype == torch.float32, name
        got = fn(*args(same), rng_seed=7, rng_offset=off, **kw(same))
        assert torch.equal(bits(got), bits(round_bf16(x32, sr_key(7, off)))), \
            name
        near = fn(*args(same), **kw(same))
        assert torch.equal(bits(near), bits(x32.to(BF))), name
        for seed, o in ((8, off), (7, off + 1)):
            other = fn(*args(same), rng_seed=seed, rng_offset=o, **kw(same))
            assert not torch.equal(bits(other), bits(got)), name


# ---------------------------------------------------------------------------
# the step on the routes the g-stream tier does not take
# ---------------------------------------------------------------------------

ROUTES = ["h_axes", "k_tuple", "callable_k", "theta0", "fuse_theta_false"]


def _face_fields(seed):
    rng = np.random.default_rng(seed)
    hf = {f: 20.0 + 15.0 * rng.random(SHAPE) for f in FACES}
    sc = {f: 0.6 + 0.8 * rng.random(SHAPE) for f in FACES}
    return hf, sc


@pytest.mark.parametrize("route", ROUTES)
def test_step_bf16_routes_match_jax(route):
    """``adi_step_varprop_fused`` on a bfloat16 state, rounding to nearest,
    against JAX ``adi_step_varprop_fused(gstreams=False, interpret=True)``
    on the same state: per-face film streams (``build_face_h_axes`` at
    float32, as both engines build them for bfloat16 states, with
    emissivity and radiation scales), a per-axis k tuple, a callable k
    closing over a spatial field, theta = 0 and ``fuse_theta=False`` (K20
    then K7's x entry, R0 stored at bfloat16) with a source."""
    mask, T, _, src, _ = _case(8)
    jg = JGrid(*SHAPE, 1e-3, **SPACING)
    pg = CartesianGrid(*SHAPE, 1e-3, **SPACING)
    jmat, pmat = JMaterial(RHO, CP, K), Material(RHO, CP, K)
    (jk, jc), (pk, pc) = _tables()
    jm, pm = jnp.asarray(mask), torch.from_numpy(mask)
    jkw, pkw = dict(k_table=jk, cp_table=jc), dict(k_table=pk, cp_table=pc)
    theta = 0.5
    if route == "h_axes":
        hf, sc = _face_fields(4)
        jkw.update(h_axes=jax.jit(
            jcv.build_face_h_axes, static_argnames="dtype")(
            jm, {f: jnp.asarray(v, jnp.float32) for f, v in hf.items()},
            {f: jnp.asarray(v, jnp.float32) for f, v in sc.items()},
            dtype=jnp.float32), emissivity=0.65)
        pkw.update(h_axes=build_face_h_axes(
            pm, {f: torch.from_numpy(v).float() for f, v in hf.items()},
            {f: torch.from_numpy(v).float() for f, v in sc.items()},
            dtype=torch.float32), emissivity=0.65)
    elif route == "k_tuple":
        k3 = (jcv.melt_pool_enhanced_k(30.0, SOL, LIQ),
              melt_pool_enhanced_k(30.0, SOL, LIQ))
        jkw.update(k_table=(jk, 40.0, k3[0]), robin_h=35.0)
        pkw.update(k_table=(pk, 40.0, k3[1]), robin_h=35.0)
    elif route == "callable_k":
        sub = (np.arange(SHAPE[2]) < 4)[None, None, :]
        jsub, psub = jnp.asarray(sub), torch.from_numpy(sub)
        jkw.update(k_table=lambda T: jnp.where(jsub, 540.0, 54.0 + 0.0 * T),
                   robin_h=35.0)
        pkw.update(k_table=lambda T: torch.where(psub, 540.0, 54.0 + 0.0 * T),
                   robin_h=35.0)
    elif route == "theta0":
        theta = 0.0
        jkw.update(robin_h=35.0)
        pkw.update(robin_h=35.0)
    else:
        jkw.update(robin_h=35.0, source=_j(src), fuse_theta=False)
        pkw.update(robin_h=35.0, source=src, fuse_theta=False)
    got = adi_step_varprop_fused(T, pm, build_varprop_codes(pm), pg, pmat,
                                 dt=DT, theta=theta, t_inf=T_INF,
                                 gstreams=False, **pkw)
    want = jcv.adi_step_varprop_fused(
        _j(T), jm, jcv.build_varprop_codes(jm), jg, jmat, dt=DT,
        theta=theta, t_inf=T_INF, interpret=True, gstreams=False, **jkw)
    assert got.dtype == BF
    ulps = _ulps(got, want)
    assert ulps.max() <= 1.0, ulps.max()
    assert torch.equal(got[~pm].float(), T[~pm].float())


def test_step_bf16_classic_routes_run_the_classic_entries(monkeypatch):
    """A bfloat16 state with per-face streams, a k tuple or a callable
    takes the classic tier (its six entries, seeded at offsets 0-3) and
    not the g-stream tier, whose tables-only route it would otherwise
    share."""
    from adi_thermal_fields_tpu_torch.step import cartesian_varprop as pcv
    mask, T, _, _, _ = _case(9)
    pg = CartesianGrid(*SHAPE, 1e-3, **SPACING)
    pm = torch.from_numpy(mask)
    _, (pk, pc) = _tables()
    seen = []
    for name in ("varprop_fields", "varprop_theta_sweep", "varprop_sweep_y",
                 "varprop_sweep_z", "varprop_theta_rhs", "varprop_sweep_x"):
        real = getattr(pcv, name)

        def spy(*a, _n=name, _f=real, **kw):
            seen.append((_n, kw.get("rng_seed"), kw.get("rng_offset")))
            return _f(*a, **kw)
        monkeypatch.setattr(pcv, name, spy)

    def gstream(*a, **kw):
        raise AssertionError("the g-stream tier ran")
    monkeypatch.setattr(pcv, "adi_step_varprop_gstreams", gstream)
    codes = build_varprop_codes(pm)
    h_ab = build_face_h_axes(pm, 30.0, dtype=torch.float32)
    adi_step_varprop_fused(T, pm, codes, pg, Material(RHO, CP, K),
                           k_table=pk, cp_table=pc, dt=DT, h_axes=h_ab,
                           rng_seed=5)
    assert seen == [("varprop_fields", None, None),
                    ("varprop_theta_sweep", 5, 1),
                    ("varprop_sweep_y", 5, 2), ("varprop_sweep_z", 5, 3)]
    seen.clear()
    adi_step_varprop_fused(T, pm, codes, pg, Material(RHO, CP, K),
                           k_table=(pk, 40.0, pk), cp_table=pc, dt=DT,
                           robin_h=30.0, fuse_theta=False, rng_seed=6)
    assert [s[1:] for s in seen] == [(6, 0), (6, 1), (6, 2), (6, 3)]
    assert [s[0] for s in seen] == ["varprop_theta_rhs", "varprop_sweep_x",
                                    "varprop_sweep_y", "varprop_sweep_z"]
    with pytest.raises(NotImplementedError, match="float16"):
        adi_step_varprop_fused(T.to(torch.float16), pm, codes, pg,
                               Material(RHO, CP, K), k_table=pk, dt=DT,
                               h_axes=h_ab)


# ---------------------------------------------------------------------------
# the engine: the freeze on the corrected configuration
# ---------------------------------------------------------------------------

def _corrected_cooling(dtype, stochastic, n_steps=30):
    """tests/test_bf16_drift.py's cooling run (900 C, dt 0.002 s, 30
    steps) at 20x18x16 on the corrected configuration: per-face film
    fields (200 W/m^2K on average) with radiation scales and emissivity
    0.5, a k table: the classic tier's bfloat16 entries."""
    grid = CartesianGrid(20, 18, 16, 1e-3)
    rng = np.random.default_rng(11)
    hf = {f: 150.0 + 100.0 * rng.random(grid.shape) for f in FACES}
    sc = {f: 0.8 + 0.4 * rng.random(grid.shape) for f in FACES}
    prepare, advance = make_cartesian_engine(
        grid, Material(RHO, CP, K), implementation="kernels", device="cpu",
        dtype=dtype, theta=0.5, t_inf=20.0, robin_h=hf, radiation_scale=sc,
        emissivity=0.5, k_table=melt_pool_enhanced_k(K, SOL, LIQ),
        stochastic_rounding=stochastic)
    T = torch.full(grid.shape, 900.0, dtype=dtype)
    out = advance(T, prepare(torch.ones(grid.shape, dtype=torch.bool)),
                  0.002, n_steps, 0.0)
    return out.double().numpy()


def test_stochastic_rounding_beats_the_nearest_freeze_on_the_classic_tier():
    """As tests/test_torch_bf16.py's g-stream freeze test: round-to-nearest
    cools less than half as much as float32, the stochastic run stays
    within the drift envelope and cools like float32."""
    ref = _corrected_cooling(torch.float32, False)
    rtn = _corrected_cooling(BF, False)
    sr = _corrected_cooling(BF, True)
    cooled_ref = 900.0 - ref.mean()
    assert cooled_ref > 0.5
    assert 900.0 - rtn.mean() < 0.5 * cooled_ref
    drift = np.abs(sr - ref)
    assert drift.max() < 21.0 and drift.mean() < 2.5
    assert abs((900.0 - sr.mean()) - cooled_ref) < 0.5 * cooled_ref
