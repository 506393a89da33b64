"""The port's inverse tier and profiling apps against the JAX package's, on
the CPU.

Same inputs, made from a seed with numpy, go through the JAX app's
functions and the port's at float64.  Tolerances:

* ``optimize_process.make_forward``: the loss, t8/5 and the gradients
  w.r.t. deposit_T and dwell at fixed parameters on
  tests/test_optimize_process.py's ``_tiny_problem`` (the plain step) and
  with its latent-heat table (the varprop reference step): 1e-9
  relative;
* the dwell reparameterization: the softplus of its stable inverse gives
  the dwell back (1e-12 relative at 5-800 s, as JAX's), and three Adam
  iterations from 800 s dwells stay finite and positive;
* ``calibrate_params.make_measurement_forward``: the traces and the
  gradient w.r.t. h, k, cp and eps: 1e-9 relative; the h and the joint
  h, k round trips from clean data within the JAX tests' 1e-6 (L-BFGS
  takes another path than optax's, so only the end point is held); the
  Gauss-Newton sigmas against ``jax.jacfwd``'s: 1e-6 relative;
* both CLIs end to end with ``--device cpu`` and a few iterations (the
  loss falls; JSON written; a CSV of traces read back);
* ``StepTimer``'s slope (tests/test_io_apps.py:303) and ``trace``'s Chrome
  trace;
* ``compare_implementations`` at float64 on the CPU: the kernel path
  (plain versions) against the reference within 1e-9 K, both cases, the
  JAX app's keys.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adi_thermal_fields_tpu.apps import calibrate_params as jcal
from adi_thermal_fields_tpu.apps import optimize_process as jopt
from adi_thermal_fields_tpu.core.grid import CartesianGrid as JGrid
from adi_thermal_fields_tpu.core.material import Material as JMat
from adi_thermal_fields_tpu.step.cartesian_varprop import (
    apparent_cp as j_apparent_cp)

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          apparent_cp)
from adi_thermal_fields_tpu_torch.apps import calibrate_params as pcal
from adi_thermal_fields_tpu_torch.apps import compare_implementations
from adi_thermal_fields_tpu_torch.apps import optimize_process as popt
from adi_thermal_fields_tpu_torch.io.profiling import StepTimer, trace

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-9


def _close(got, want, rtol=RTOL, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol:.0e} of {scale:.3e}"


# ---------------------------------------------------------------------------
# optimize_process
# ---------------------------------------------------------------------------

def _wall(n_layers, target, latent=None, n_sub=8):
    """tests/test_optimize_process.py's _tiny_problem on both sides."""
    kw = dict(nx=10, ny=6, nz_plate=3, n_layers=n_layers, layer_vox=1,
              wall_w_vox=2, dx=2e-3, h=200.0, t_inf=25.0)
    fkw = dict(h=200.0, t_inf=25.0, n_sub=n_sub, target_t85=target)
    jm, pm = JMat(7800.0, 490.0, 30.0), Material(7800.0, 490.0, 30.0)
    jprob = jopt.build_wall_problem(mat=jm, dtype=jnp.float64, **kw)
    pprob = popt.build_wall_problem(mat=pm, dtype=F64, device="cpu", **kw)
    jcp = pcp = None
    if latent is not None:
        jcp = j_apparent_cp(490.0, 490.0, 2.7e5, *latent)
        pcp = apparent_cp(490.0, 490.0, 2.7e5, *latent)
    jf = jopt.make_forward(*jprob, jm, dtype=jnp.float64, cp_table=jcp,
                           **fkw)
    pf = popt.make_forward(*pprob, pm, dtype=F64, cp_table=pcp, **fkw)
    return jf, pf


@pytest.mark.parametrize("entry", ["build_wall_problem",
                                   "make_measurement_forward"])
def test_library_entry_points_default_to_the_card(entry):
    """With no device the inverse apps' library entry points run on the
    card: on a machine without CUDA they raise, not fall back to the
    CPU."""
    pm = Material(7800.0, 490.0, 30.0)
    if entry == "build_wall_problem":
        call = functools.partial(
            popt.build_wall_problem, nx=10, ny=6, nz_plate=3, n_layers=2,
            layer_vox=1, wall_w_vox=2, dx=2e-3, mat=pm, h=200.0,
            t_inf=25.0, dtype=F64)
    else:
        call = functools.partial(
            pcal.make_measurement_forward, CartesianGrid(6, 5, 4, 2e-3), pm,
            [(3, 2, 2)], t0=900.0, t_inf=25.0, dt=0.5, n_steps=4,
            sample_every=2, dtype=F64)
    if torch.cuda.is_available():
        out = call()
        first = out[1] if entry == "build_wall_problem" else out(
            {"h": torch.tensor(45.0, dtype=F64, device="cuda")})
        assert first.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("latent", [None, (350.0, 650.0)],
                         ids=["constant", "latent-heat"])
def test_make_forward_loss_and_grads_match_jax(latent):
    n = 3 if latent is None else 2
    jf, pf = _wall(n, 2.0, latent, n_sub=8 if latent is None else 12)
    dep = np.full(n, 1500.0 if latent is None else 1550.0) + \
        np.arange(n) * 7.0
    dw = np.full(n, 3.0) - np.arange(n) * 0.25
    jl = jax.jit(jax.value_and_grad(lambda a, b: jf(a, b)[0],
                                    argnums=(0, 1)))
    (jloss, (jg_dep, jg_dw)) = jl(jnp.asarray(dep), jnp.asarray(dw))
    jt85 = jax.jit(lambda a, b: jf(a, b)[1]["t85"])(jnp.asarray(dep),
                                                    jnp.asarray(dw))
    d, w = (torch.tensor(v, dtype=F64, requires_grad=True) for v in (dep, dw))
    loss, aux = pf(d, w)
    g_dep, g_dw = torch.autograd.grad(loss, (d, w))
    _close(loss, jloss, RTOL, "loss")
    _close(aux["t85"], jt85, RTOL, "t85")
    _close(g_dep, jg_dep, RTOL, "dL/ddeposit_T")
    _close(g_dw, jg_dw, RTOL, "dL/ddwell")


def test_dwell_reparameterization_at_long_dwells():
    d0 = torch.tensor([5.0, 31.0, 300.0, 800.0], dtype=F64)
    back = 0.5 + popt.softplus(popt.dwell_params(d0, 0.5))
    _close(back, d0.numpy(), 1e-12, "softplus of the inverse")
    j = jax.nn.softplus(jnp.asarray([-3.0, 0.0, 25.0, 40.0]))
    _close(popt.softplus(torch.tensor([-3.0, 0.0, 25.0, 40.0],
                                      dtype=F64)), j, 1e-15, "softplus")
    _, pf = _wall(2, 1.0)
    dep0 = torch.full((2,), 1500.0, dtype=F64)
    dep, dw, hist = popt.optimize(pf, "dwell", dep0,
                                  torch.full((2,), 800.0, dtype=F64),
                                  iters=3, lr=0.3, log=None)
    assert np.isfinite(hist).all(), hist
    assert bool(torch.isfinite(dw).all()) and bool((dw > 0).all())
    assert abs(float(dw[0]) - 800.0) < 800.0


def test_optimize_cli_end_to_end(tmp_path):
    out = tmp_path / "sched.json"
    res = popt.main(["--device", "cpu", "--nx", "10", "--ny", "6",
                     "--nz_plate", "3", "--layers", "3", "--layer_vox", "1",
                     "--wall_w_vox", "2", "--dx_mm", "2.0", "--n_sub", "6",
                     "--iters", "6", "--target_t85", "2.0", "--out",
                     str(out)])
    assert res["loss_final"] < res["loss_initial"]
    sched = json.loads(out.read_text())
    assert len(sched["deposit_T"]) == 3 and len(sched["history"]) == 6
    res = popt.main(["--device", "cpu", "--nx", "10", "--ny", "6",
                     "--nz_plate", "3", "--layers", "2", "--layer_vox", "1",
                     "--wall_w_vox", "2", "--dx_mm", "2.0", "--n_sub", "4",
                     "--iters", "2", "--var", "dwell", "--time_penalty",
                     "0.01", "--interpass_limit_C", "300"])
    assert all(d > 0 for d in res["dwell_s"])
    if not torch.cuda.is_available():     # --device defaults to cuda
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            popt.main(["--iters", "1"])


# ---------------------------------------------------------------------------
# calibrate_params
# ---------------------------------------------------------------------------

def _forwards(n_steps=16, dt=0.5, t0=900.0):
    jg, jm = JGrid(12, 10, 8, 2e-3), JMat(7800.0, 490.0, 54.0)
    pg, pm = CartesianGrid(12, 10, 8, 2e-3), Material(7800.0, 490.0, 54.0)
    kw = dict(t0=t0, t_inf=25.0, dt=dt, n_steps=n_steps, sample_every=4)
    jf = jcal.make_measurement_forward(
        jg, jm, jcal.default_probes(jg.shape), dtype=jnp.float64, **kw)
    pf = pcal.make_measurement_forward(
        pg, pm, pcal.default_probes(pg.shape), dtype=F64, device="cpu",
        **kw)
    return jf, pf


@pytest.mark.parametrize("keys", [("h",), ("h", "k", "cp"), ("eps", "h")],
                         ids=["h", "h-k-cp", "eps-h"])
def test_measurement_forward_and_grad_match_jax(keys):
    jf, pf = _forwards(t0=1200.0 if "eps" in keys else 900.0)
    vals = {"h": 45.0, "k": 38.0, "cp": 470.0, "eps": 0.7}
    rng = np.random.default_rng(5)
    meas = 25.0 + 900.0 * rng.random((4, 3))

    def jloss(*v):
        r = jf(dict(zip(keys, v))) - meas
        return jnp.mean(r * r)

    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(
        range(len(keys)))))(*(jnp.float64(vals[k]) for k in keys))
    ps = [torch.tensor(vals[k], dtype=F64, requires_grad=True) for k in keys]
    traces = pf(dict(zip(keys, ps)))
    r = traces - torch.from_numpy(meas)
    loss = (r * r).mean()
    pg = torch.autograd.grad(loss, ps)
    _close(traces, jf({k: jnp.float64(vals[k]) for k in keys}), RTOL,
           "traces")
    _close(loss, jl, RTOL, "loss")
    for k, g, j in zip(keys, pg, jg):
        _close(g, j, RTOL, f"dL/d{k}")


@pytest.mark.parametrize("truth,init,dt", [
    ({"h": 45.0}, {"h": 15.0}, 0.5),
    ({"h": 900.0, "k": 38.0}, {"h": 300.0, "k": 90.0}, 0.2)],
    ids=["h", "h-k"])
def test_calibration_round_trips(truth, init, dt):
    """The JAX tests' round trips (tests/test_calibrate_params.py:32-49),
    on 16 steps: the fit recovers the truth within 1e-6."""
    _, pf = _forwards(n_steps=16, dt=dt)
    with torch.no_grad():
        meas = pf({k: torch.tensor(v, dtype=F64) for k, v in truth.items()})
    fitted, hist = pcal.fit(pf, meas, list(truth), init, iters=25, log=None)
    for k, v in truth.items():
        assert abs(fitted[k] - v) / v < 1e-6, fitted
    assert hist[-1] < 1e-12 * hist[0]


def test_uncertainty_matches_jacfwd():
    jf, pf = _forwards(n_steps=16, dt=0.2)
    rng = np.random.default_rng(9)
    truth = {"h": 900.0, "k": 38.0}
    with torch.no_grad():
        clean = pf({k: torch.tensor(v, dtype=F64) for k, v in truth.items()})
    noisy = clean + torch.from_numpy(rng.normal(0.0, 2.0, clean.shape))
    fitted = {"h": 870.0, "k": 39.5}
    got = pcal.uncertainty(pf, noisy, fitted, ["h", "k"])
    want = jcal.uncertainty(jf, jnp.asarray(noisy.numpy()), fitted,
                            ["h", "k"])
    for k in ("h", "k"):
        _close(got[k], want[k], 1e-6, f"sigma {k}")


def test_calibrate_cli_end_to_end(tmp_path):
    out = tmp_path / "cal.json"
    base = ["--device", "cpu", "--nx", "12", "--ny", "10", "--nz", "8",
            "--n_steps", "16", "--sample_every", "4"]
    res = pcal.main(base + ["--fit", "h", "--true_h", "45.0", "--h", "15",
                            "--iters", "10", "--uq", "1", "--noise_K",
                            "0.5", "--out", str(out)])
    assert abs(res["fitted"]["h"] - 45.0) / 45.0 < 0.05
    assert res["sigma"]["h"] > 0 and out.exists()
    # the traces written as CSV, fitted from the file
    _, pf = _forwards(n_steps=16)
    with torch.no_grad():
        meas = pf({"h": torch.tensor(45.0, dtype=F64)}).numpy()
    times = (np.arange(meas.shape[0]) + 1) * 4 * 0.5
    csv = tmp_path / "traces.csv"
    csv.write_text("# t T0 T1 T2\n" + "\n".join(
        ", ".join([f"{t:.3f}"] + [f"{v:.10f}" for v in row])
        for t, row in zip(times, meas)) + "\n")
    _, m = pcal.load_measured(f"@{csv}", 3)
    np.testing.assert_allclose(m, meas, atol=1e-9)
    res2 = pcal.main(base + ["--fit", "h", "--h", "15", "--iters", "8",
                             "--measured", f"@{csv}", "--optimizer",
                             "adam", "--lr", "0.3"])
    assert res2["rms_final_K"] < res2["rms_initial_K"]


# ---------------------------------------------------------------------------
# profiling and compare_implementations
# ---------------------------------------------------------------------------

def test_step_timer_slope_counts_steps():
    timer = StepTimer()
    calls = []

    def step(x):
        calls.append(1)
        return x + 1.0

    per_step, out = timer.time_steps(step, torch.zeros(()), n_steps=8,
                                     warmup=1)
    assert abs(per_step) < 10.0
    assert len(calls) == 1 + 2 + 8
    assert float(out) == float(len(calls))


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    data = json.loads((tmp_path / "trace.json").read_text())
    assert "traceEvents" in data
    assert any("cumsum" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("argv,keys", [
    (["--n", "10", "--steps", "2"], {"timings", "rms", "max"}),
    (["--case", "cyl_varprop", "--n", "8", "--steps", "2"],
     {"timings", "max_fields", "max_kernels"})], ids=["cartesian", "cyl"])
def test_compare_implementations_on_cpu(argv, keys):
    res = compare_implementations.main(argv + ["--precision", "float64",
                                               "--device", "cpu"])
    assert set(res) == keys
    assert max(v for k, v in res.items() if k != "timings" and
               k != "rms") < 1e-9
    assert len(res["timings"]) == (2 if "rms" in keys else 3)
