"""The port's bfloat16 bandwidth mode against the JAX package, on the CPU.

Same inputs, made from a seed with numpy, go through the JAX function and
the port's counterpart; the JAX Pallas kernels run in interpret mode, as
tests/test_gstreams.py runs them, and JAX bfloat16 outputs are compared
through ``astype(float32)`` (exact).  Tolerances:

* the g-stream fields pass (K23's plain version) and the g-stream step at
  float32 against JAX: relative 2e-6, JAX's own tolerance
  (tests/test_gstreams.py; the clamp-sum slopes and the radiative film's
  scalars round once differently);
* the bfloat16 steps with rounding to nearest (the g-stream step and
  ``adi_step_fused``) against JAX: at most one bfloat16 ulp at each cell
  (the spacing of bfloat16 numbers at the larger of the two values: an
  intermediate store that lands on the other side of a rounding boundary
  moves the result by one ulp);
* the routing: bitwise; the stochastic rounding: P(up) = 0.25 +- 0.01 for
  1 + ulp/4 over 102400 cells (the JAX test's bound);
* the cooling runs of tests/test_bf16_drift.py at a reduced size: the
  stochastic run within that test's envelope (max < 21 K, mean < 2.5 K
  from float32) and round-to-nearest cooling less than half as much as
  float32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import Material as JMaterial
from adi_thermal_fields_tpu.solvers.pallas_gstreams import (
    gstream_fields as j_gstream_fields)
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv
from adi_thermal_fields_tpu.step.cartesian_pallas import (
    adi_step_pallas as j_adi_step_pallas)
from adi_thermal_fields_tpu.step.cartesian_pallas import (
    build_sweep_plan as j_build_plan)
from adi_thermal_fields_tpu import build_coeff_packs as j_packs

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          PropertyTable, adi_step_fused,
                                          adi_step_varprop_fused,
                                          apparent_cp, build_coeff_packs,
                                          build_sweep_plan,
                                          build_varprop_codes)
from adi_thermal_fields_tpu_torch.apps import waam_from_stl as port_app
from adi_thermal_fields_tpu_torch.apps.engine import (clock,
                                                      make_cartesian_engine)
from adi_thermal_fields_tpu_torch.geometry.primitives import box_mesh
from adi_thermal_fields_tpu_torch.geometry.stl import save_stl_binary
from adi_thermal_fields_tpu_torch.solvers.gstreams import gstream_fields
from adi_thermal_fields_tpu_torch.solvers.rounding import (natural_index,
                                                           round_bf16,
                                                           sr_bits, sr_key)
from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
    adi_step_varprop_gstreams)

torch.set_num_threads(1)

RHO, CP, K = 7800.0, 490.0, 54.0
DT = 0.05
KT = ((0.0, 500.0, 1200.0), (54.0, 40.0, 30.0))
CT = (490.0, 620.0, 2.5e5, 900.0, 1000.0)   # apparent_cp arguments
SPACING = dict(dy=1.3e-3, dz=0.8e-3)


def _case(seed=0, T0=800.0, dT=200.0):
    """tests/test_gstreams.py's grid (12x10x14, anisotropic voxels, a void
    notch and a void column) with numpy inputs."""
    rng = np.random.default_rng(seed)
    shape = (12, 10, 14)
    mask = np.ones(shape, bool)
    mask[7:, 2:5, :6] = False
    mask[0, :, -3:] = False
    T = (T0 + dT * rng.random(shape)).astype(np.float32)
    src = (2e7 * rng.random(shape)).astype(np.float32)
    h = (50.0 + 100.0 * rng.random(shape)).astype(np.float32)
    return mask, T, src, h


def _grids(shape):
    return (JGrid(*shape, 1e-3, **SPACING), CartesianGrid(*shape, 1e-3,
                                                          **SPACING))


def _tables():
    return ((jcv.PropertyTable(*KT), jcv.apparent_cp(*CT)),
            (PropertyTable(*KT), apparent_cp(*CT)))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _bf16_ulps(got, want):
    """|got - want| in bfloat16 ulps at the larger of the two values."""
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    return np.abs(got - want) / ulp


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


# ---------------------------------------------------------------------------
# K23-K26 and the g-stream step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h_mode", ["const", "stream", "rad"])
def test_gstream_fields_match_jax(h_mode):
    """K23's plain version: the nine streams and src_pre against JAX
    ``gstream_fields`` at float32, each film mode."""
    mask, T, src, h = _case(seed=2)
    jg, _ = _grids(T.shape)
    (jkt, jct), (kt, ct) = _tables()
    dt = jnp.float32(DT)
    tg3 = jnp.stack([0.5 * dt / d ** 2 for d in jg.spacing])
    sk3 = jnp.stack([dt / d for d in jg.spacing])
    hpar, h_conv = {"const": (140.0, 0.0), "stream": (0.0, 0.0),
                    "rad": (0.6, 12.0)}[h_mode]
    want = j_gstream_fields(
        _j(T), _j(mask).astype(jnp.int8), tg3, sk3, hpar, 20.0, h_conv, dt,
        h=_j(h) if h_mode == "stream" else None, src=_j(src),
        k_spec=jcv._table_spec(jkt, K), cp_spec=jcv._table_spec(jct, CP),
        rho=RHO, h_mode=h_mode, interpret=True)
    got = gstream_fields(
        _t(T), _t(mask).to(torch.uint8), [float(v) for v in tg3],
        [float(v) for v in sk3], k_spec=kt, cp_spec=ct, rho=RHO,
        h_mode=h_mode, hpar=hpar, t_inf=20.0, h_conv=h_conv, dt=float(dt),
        h=_t(h) if h_mode == "stream" else None, src=_t(src))
    for wgroup, ggroup in zip(want[:3], got[:3]):
        for w, g in zip(wgroup, ggroup):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                       atol=1e-12)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=2e-6, atol=1e-12)


@pytest.mark.parametrize("theta", [0.5, 1.0])
@pytest.mark.parametrize("film", ["const", "stream", "rad"])
def test_gstream_step_matches_jax_float32(theta, film):
    """adi_step_varprop_gstreams (K23-K26's plain versions) against JAX
    ``adi_step_varprop_gstreams`` at float32 with a volumetric source;
    void cells are identity rows in both."""
    mask, T, src, h = _case(seed=1, T0=1000.0, dT=500.0)
    jg, g = _grids(T.shape)
    (jkt, jct), (kt, ct) = _tables()
    films = {"const": (dict(robin_h=180.0), dict(robin_h=180.0)),
             "stream": (dict(h_field=_j(h)), dict(h_field=_t(h))),
             "rad": (dict(emissivity=0.6, h_conv=12.0),
                     dict(emissivity=0.6, h_conv=12.0))}[film]
    want = np.asarray(jcv.adi_step_varprop_gstreams(
        _j(T), _j(mask), jg, JMaterial(RHO, CP, K), k_table=jkt,
        cp_table=jct, dt=jnp.float32(DT), theta=theta, t_inf=20.0,
        source=_j(src), interpret=True, **films[0]))
    got = adi_step_varprop_gstreams(
        _t(T), _t(mask), g, Material(RHO, CP, K), k_table=kt, cp_table=ct,
        dt=DT, theta=theta, t_inf=20.0, source=_t(src), **films[1]).numpy()
    assert _rel(got, want) < 2e-6
    assert np.array_equal(got[~mask], T[~mask])


@pytest.mark.parametrize("film", ["const", "rad"])
def test_gstream_step_bf16_nearest_matches_jax(film):
    """The bfloat16 g-stream step with rounding to nearest: bfloat16 out,
    within one bfloat16 ulp of JAX's bfloat16 step at every cell."""
    mask, T, _, _ = _case(seed=1, T0=1000.0, dT=500.0)
    jg, g = _grids(T.shape)
    (jkt, jct), (kt, ct) = _tables()
    kw = dict(robin_h=180.0) if film == "const" else dict(emissivity=0.6,
                                                         h_conv=12.0)
    Tb = _j(T).astype(jnp.bfloat16)
    want = np.asarray(jcv.adi_step_varprop_gstreams(
        Tb, _j(mask), jg, JMaterial(RHO, CP, K), k_table=jkt, cp_table=jct,
        dt=jnp.float32(DT), theta=0.5, t_inf=20.0, interpret=True,
        **kw).astype(jnp.float32))
    got = adi_step_varprop_gstreams(
        _t(np.asarray(Tb.astype(jnp.float32)), torch.bfloat16), _t(mask), g,
        Material(RHO, CP, K), k_table=kt, cp_table=ct, dt=DT, theta=0.5,
        t_inf=20.0, **kw)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), want).max() <= 1.0


@pytest.mark.parametrize("plan", ["lite", "field"])
def test_fused_step_bf16_nearest_matches_jax(plan):
    """adi_step_fused on a bfloat16 state (K4, K1, K2 or K3, K1 x3 with
    bfloat16 coefficient fields), rounding to nearest: within one bfloat16
    ulp of JAX ``adi_step_pallas`` on the same bfloat16 state."""
    rng = np.random.default_rng(0)
    shape = (12, 10, 16)
    mask = rng.random(shape) > 0.2
    T = np.where(mask, 900.0 + 400.0 * rng.random(shape), 20.0)
    jg, g = JGrid(*shape, 1e-3), CartesianGrid(*shape, 1e-3)
    jmat, mat = JMaterial(RHO, CP, K), Material(RHO, CP, K)
    if plan == "lite":
        rc = jnp.float32(200.0) * jnp.float32(1.0 / (RHO * CP * 1e-3))
        jp = j_build_plan(_j(mask), None, has_neumann=False,
                          has_dirichlet=False, robin_const=rc)
        pp = build_sweep_plan(_t(mask), None, robin_const=float(rc))
    else:
        fk = {f: 200.0 for f in ("x-", "x+", "y-", "y+", "z-", "z+")}
        jp = j_build_plan(_j(mask), j_packs(_j(mask), jg, jmat, robin_h=fk,
                                            dtype=jnp.bfloat16))
        pp = build_sweep_plan(_t(mask), build_coeff_packs(
            _t(mask), g, mat, dtype=torch.bfloat16, robin_h=fk))
    Tb = _j(T, jnp.bfloat16)
    want = np.asarray(j_adi_step_pallas(
        Tb, jp, jg, jmat, dt=DT, theta=0.5, t_inf=20.0,
        interpret=True).astype(jnp.float32))
    got = adi_step_fused(_t(np.asarray(Tb.astype(jnp.float32)),
                            torch.bfloat16), pp, g, mat, dt=DT, t_inf=20.0)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), want).max() <= 1.0
    # a seeded step rounds stochastically: another realisation, the same
    # bits for the same seed
    a = adi_step_fused(got, pp, g, mat, dt=DT, t_inf=20.0, rng_seed=3)
    b = adi_step_fused(got, pp, g, mat, dt=DT, t_inf=20.0, rng_seed=3)
    c = adi_step_fused(got, pp, g, mat, dt=DT, t_inf=20.0, rng_seed=4)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert not torch.equal(a, c)


def test_gstream_routing():
    """adi_step_varprop_fused routes as JAX (:569-582): a bfloat16 state
    takes the g-stream tier by default, float32 stays classic unless
    gstreams=True, float64 with gstreams=True runs the classic tier."""
    mask, T, _, _ = _case(seed=3)
    _, g = _grids(T.shape)
    _, (kt, ct) = _tables()
    mat = Material(RHO, CP, K)
    mt = _t(mask)
    codes = build_varprop_codes(mt)
    kw = dict(k_table=kt, cp_table=ct, dt=DT, theta=0.5, t_inf=20.0,
              emissivity=0.6, h_conv=12.0)
    Tb = _t(T, torch.bfloat16)
    direct = adi_step_varprop_gstreams(Tb, mt, g, mat, rng_seed=9, **kw)
    routed = adi_step_varprop_fused(Tb, mt, codes, g, mat, rng_seed=9, **kw)
    assert torch.equal(routed.view(torch.int16), direct.view(torch.int16))
    T32 = _t(T)
    assert torch.equal(adi_step_varprop_fused(T32, mt, codes, g, mat, **kw),
                       adi_step_varprop_fused(T32, mt, codes, g, mat,
                                              gstreams=False, **kw))
    assert torch.equal(adi_step_varprop_fused(T32, mt, codes, g, mat,
                                              gstreams=True, **kw),
                       adi_step_varprop_gstreams(T32, mt, g, mat, **kw))
    T64 = _t(T, torch.float64)
    assert torch.equal(adi_step_varprop_fused(T64, mt, codes, g, mat,
                                              gstreams=True, **kw),
                       adi_step_varprop_fused(T64, mt, codes, g, mat,
                                              gstreams=False, **kw))


def test_gstream_refusals():
    """theta = 0, per-axis k tuples and float64 raise in the g-stream step
    (JAX's messages); on adi_step_varprop_fused a bfloat16 state that the
    g-stream tier does not take runs the classic tier's bfloat16 entries,
    as JAX routes it (tests/test_torch_bf16_varprop.py holds them to
    JAX)."""
    mask, T, _, _ = _case()
    _, g = _grids(T.shape)
    _, (kt, ct) = _tables()
    mat = Material(RHO, CP, K)
    mt = _t(mask)
    kw = dict(cp_table=ct, dt=DT, t_inf=20.0)
    with pytest.raises(ValueError, match="theta"):
        adi_step_varprop_gstreams(_t(T), mt, g, mat, k_table=kt, theta=0.0,
                                  **kw)
    with pytest.raises(ValueError, match="PropertyTable"):
        adi_step_varprop_gstreams(_t(T), mt, g, mat, k_table=(kt, 30.0, kt),
                                  **kw)
    with pytest.raises(ValueError, match="f32/bf16"):
        adi_step_varprop_gstreams(_t(T, torch.float64), mt, g, mat,
                                  k_table=kt, **kw)
    codes = build_varprop_codes(mt)
    Tb = _t(T, torch.bfloat16)
    for extra in (dict(k_table=(kt, 30.0, kt)), dict(k_table=kt, theta=0.0)):
        got = adi_step_varprop_fused(Tb, mt, codes, g, mat, **extra, **kw)
        assert got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all())
        assert torch.equal(got.view(torch.int16), adi_step_varprop_fused(
            Tb, mt, codes, g, mat, gstreams=False, **extra,
            **kw).view(torch.int16))


# ---------------------------------------------------------------------------
# the rounding
# ---------------------------------------------------------------------------

def test_stochastic_round_bf16():
    """The port of tests/test_round3_fixes.py::test_xla_stochastic_round_bf16:
    exact bfloat16 values are kept; 1 + ulp/4 rounds up with probability
    1/4 and only to its two neighbours; the same key gives the same bits,
    another key another realisation; the bits depend on the natural index
    alone (a permuted field with permuted indices rounds alike)."""
    exact = torch.tensor([1.0, -2.5, 0.0, 384.0, 2.0 ** -20])
    out = round_bf16(exact.expand(100, 5).contiguous(), sr_key(3, 1))
    assert torch.equal(out.float(),
                       exact.to(torch.bfloat16).float().expand(100, 5))

    ulp = 0.0078125                      # bfloat16 ulp at 1.0
    x = torch.full((200, 512), 1.0 + 0.25 * ulp)
    r = round_bf16(x, sr_key(7, 2)).float()
    assert abs(float((r > 1.0).float().mean()) - 0.25) < 0.01
    assert set(torch.unique(r).tolist()) <= {1.0, 1.0 + ulp}
    again = round_bf16(x, sr_key(7, 2))
    assert torch.equal(again.float(), r)
    assert not torch.equal(round_bf16(x, sr_key(8, 2)).float(), r)
    assert not torch.equal(round_bf16(x, sr_key(7, 3)).float(), r)

    y = torch.from_numpy(np.random.default_rng(4).normal(
        500.0, 300.0, (6, 7, 9)).astype(np.float32))
    key = sr_key(11, 1)
    perm = y.permute(2, 0, 1).contiguous()
    idx = natural_index(y.shape, "cpu").permute(2, 0, 1)
    assert torch.equal(round_bf16(perm, key, idx).float(),
                       round_bf16(y, key).float().permute(2, 0, 1))
    # unbiased over many values of one bfloat16 interval
    z = torch.full((1 << 18,), 1.0 + 0.6 * ulp)
    mean = float(round_bf16(z, key).double().mean())
    assert abs(mean - float(z[0])) < 0.01 * ulp
    # the bits of index i are those of i alone
    bits = sr_bits(key, torch.arange(1000, dtype=torch.int64))
    assert torch.equal(bits[500:],
                       sr_bits(key, torch.arange(500, 1000,
                                                 dtype=torch.int64)))


# ---------------------------------------------------------------------------
# the engine: clock, seeds, refusals, the freeze
# ---------------------------------------------------------------------------

def _grid_mat(shape=(8, 8, 6)):
    return CartesianGrid(*shape, 1e-3), Material(RHO, CP, K)


def test_engine_refuses_stochastic_where_it_cannot_round():
    """The ports of tests/test_round3_fixes.py:20-36 and of the JAX
    engine's varprop guard (:224-230): the reference implementation and
    the materialized Neumann/Dirichlet varprop step raise."""
    grid, mat = _grid_mat()
    with pytest.raises(ValueError, match="stochastic"):
        make_cartesian_engine(grid, mat, implementation="reference",
                              device="cpu", dtype=torch.bfloat16,
                              robin_h=30.0, stochastic_rounding=True)
    with pytest.raises(ValueError, match="stochastic"):
        make_cartesian_engine(grid, mat, implementation="kernels",
                              device="cpu", dtype=torch.bfloat16,
                              robin_h=30.0, neumann={"z+": 1e5},
                              k_table=40.0, stochastic_rounding=True)


def test_source_time_and_seed_at_solve_precision():
    """The port of test_round3_fixes.py::test_source_time_at_solve_precision
    and the JAX ``_clock``: a bfloat16 state's source sees t at float32
    (t0 + i*dt, not bfloat16 plateaus), the step counter is round(t0/dt)
    + i, and the step returns bfloat16."""
    grid, mat = _grid_mat()
    seen = []

    def src(t):
        seen.append(t)
        return torch.zeros(grid.shape, dtype=torch.bfloat16)

    prepare, advance = make_cartesian_engine(
        grid, mat, implementation="kernels", device="cpu",
        dtype=torch.bfloat16, robin_h=30.0, source_fn=src,
        stochastic_rounding=True)
    T = torch.full(grid.shape, 900.0, dtype=torch.bfloat16)
    dt = float(torch.tensor(0.05, dtype=torch.bfloat16))
    out = advance(T, prepare(torch.ones(grid.shape, dtype=torch.bool)), dt,
                  3, 100.0)
    assert out.dtype == torch.bfloat16
    f = np.float32
    assert seen == [float(f(100.0) + f(i) * f(dt)) for i in range(3)]
    assert len(set(seen)) == 3
    tick = clock(torch.bfloat16, dt, 1000 * dt)
    steps = [tick(i)[1] for i in range(600)]
    assert steps == list(range(1000, 1600))
    assert len({tick(i)[0] for i in range(600)}) == 600


def test_stochastic_seed_decorrelates_substeps():
    """The port of tests/test_bf16_drift.py:72-93 on the CPU: advances from
    one state with different step counters give different realisations;
    the same counter gives the same bits."""
    grid, mat = _grid_mat((12, 12, 12))
    prepare, advance = make_cartesian_engine(
        grid, mat, implementation="kernels", device="cpu",
        dtype=torch.bfloat16, robin_h=200.0, stochastic_rounding=True)
    T = torch.full(grid.shape, 900.0, dtype=torch.bfloat16)
    prep = prepare(torch.ones(grid.shape, dtype=torch.bool))
    a = advance(T, prep, 0.002, 1, 0.0)
    b = advance(T, prep, 0.002, 1, 1000 * 0.002)
    same = advance(T, prep, 0.002, 1, 0.0)
    assert torch.equal(same.view(torch.int16), a.view(torch.int16))
    assert not torch.equal(a, b)


def _cooling_run(dtype, stochastic, n_steps=30):
    """tests/test_bf16_drift.py's cooling run (900 C, Robin 200, dt
    0.002 s) at 20x18x16."""
    grid, mat = _grid_mat((20, 18, 16))
    prepare, advance = make_cartesian_engine(
        grid, mat, implementation="kernels", device="cpu", dtype=dtype,
        theta=0.5, t_inf=20.0, robin_h=200.0,
        stochastic_rounding=stochastic)
    T = torch.full(grid.shape, 900.0, dtype=dtype)
    out = advance(T, prepare(torch.ones(grid.shape, dtype=torch.bool)),
                  0.002, n_steps, 0.0)
    return out.double().numpy()


def test_stochastic_rounding_beats_the_nearest_freeze():
    """On the CPU too: round-to-nearest cools less than half as much as
    float32 (the freeze), the stochastic run stays within the drift
    envelope of tests/test_bf16_drift.py."""
    ref = _cooling_run(torch.float32, False)
    rtn = _cooling_run(torch.bfloat16, False)
    sr = _cooling_run(torch.bfloat16, True)
    cooled_ref = 900.0 - ref.mean()
    assert cooled_ref > 0.5
    assert 900.0 - rtn.mean() < 0.5 * cooled_ref
    drift = np.abs(sr - ref)
    assert drift.max() < 21.0 and drift.mean() < 2.5
    assert abs((900.0 - sr.mean()) - cooled_ref) < 0.5 * cooled_ref


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------

@pytest.fixture
def box_stl(tmp_path):
    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    return stl


@pytest.mark.parametrize("extra", [
    [], ["--latent_J_kg", "2.7e5", "--melt_k_factor", "4",
         "--emissivity", "0.5"],
    ["--corrected_bc", "1", "--emissivity", "0.5", "--melt_k_factor", "4"],
    ["--corrected_bc", "1", "--latent_J_kg", "2.7e5"]],
    ids=["constant", "varprop", "corrected_varprop", "corrected_latent"])
def test_waam_app_bfloat16_on_cpu(box_stl, extra):
    """``--precision bfloat16`` through the app on the CPU (the plain
    versions, stochastic rounding on): a bfloat16 field, finite, below
    --Ts, every solid voxel active, and within 8 K (one bfloat16 quantum
    at 1500 C) of the float32 run on average over the solid.  With
    ``--corrected_bc 1`` and variable properties the step runs the classic
    tier's bfloat16 entries (per-face film streams)."""
    argv = ["--stl", box_stl, "--dx_mm", "1", "--nframes", "3",
            "--bead_height_mm", "2", "--device", "cpu"] + extra
    runs = {p: port_app.run(port_app.build_argparser().parse_args(
        argv + ["--precision", p])) for p in ("float32", "bfloat16")}
    got, ref = runs["bfloat16"], runs["float32"]
    assert got["T"].dtype == torch.bfloat16
    _, solid, _, _ = port_app.load_voxels(port_app.build_argparser()
                                          .parse_args(argv))
    assert np.array_equal(got["active"].numpy(), solid)
    T = got["T"].float()
    assert bool(torch.isfinite(T).all())
    assert float(T[got["active"]].max()) <= 1500.0
    d = (T - ref["T"])[got["active"]].abs()
    assert float(d.mean()) < 8.0, float(d.mean())
    assert got["substeps"] == ref["substeps"]
