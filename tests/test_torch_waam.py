"""The port's WAAM app against the JAX package's, and the port's contracts.

* ``waam_from_stl.run(--device cpu)`` against the JAX app on the
  6x6x8 mm box of tests/test_io_apps.py at float64: final T, active mask
  and frame list (tolerance 1e-9 K at float64 after its 24 sub-steps; the
  two sides differ by ~1e-12 K);
* the port imports no jax (checked in a fresh interpreter);
* the kernel wrappers are forward only: under grad mode they raise on
  inputs that require grad (gradients go through
  solvers/differentiable.py);
* flags the port does not support yet exit with a message naming them
  (the variable-property flags are supported: tests/test_torch_varprop.py;
  the outputs: tests/test_torch_io_apps.py).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adi_thermal_fields_tpu.apps import waam_from_stl as jax_app

from adi_thermal_fields_tpu_torch.apps import waam_from_stl as port_app
from adi_thermal_fields_tpu_torch.geometry.primitives import box_mesh
from adi_thermal_fields_tpu_torch.geometry.stl import save_stl_binary
from adi_thermal_fields_tpu_torch.solvers import (fused_theta_sweep,
                                                  sweep_code, sweep_strided,
                                                  sweep_z, theta_rhs)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def box_stl(tmp_path):
    stl = str(tmp_path / "cube_mm.stl")
    save_stl_binary(stl, box_mesh(size=(6.0, 6.0, 8.0), center=(3, 3, 4)))
    return stl


def _argv(stl):
    return ["--stl", stl, "--dx_mm", "1", "--nframes", "3",
            "--precision", "float64", "--bead_height_mm", "2"]


def test_waam_run_matches_jax_app(box_stl, tmp_path):
    ref = jax_app.run(jax_app.build_argparser().parse_args(
        _argv(box_stl) + ["--outdir", str(tmp_path / "jax_out")]))
    got = port_app.run(port_app.build_argparser().parse_args(
        _argv(box_stl) + ["--device", "cpu"]))
    assert got["layers"] == ref["layers"] and len(got["layers"]) == 4
    assert got["births"] == pytest.approx(ref["births"], rel=0, abs=0)
    assert got["t"] == ref["t"]
    np.testing.assert_array_equal(got["active"].numpy(),
                                  np.asarray(ref["active"]))
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(ref["T"]),
                               rtol=0, atol=1e-9)
    assert len(got["frames"]) == len(ref["frames"]) == 3
    for (t1, n1, m1), (t2, n2, m2) in zip(got["frames"], ref["frames"]):
        assert t1 == t2 and n1 == n2
        assert m1 == pytest.approx(m2, rel=0, abs=1e-9)
    assert got["substeps"] > 0


def test_waam_run_reference_implementation_matches_kernels(box_stl):
    args = _argv(box_stl) + ["--device", "cpu"]
    a = port_app.run(port_app.build_argparser().parse_args(args))
    b = port_app.run(port_app.build_argparser().parse_args(
        args + ["--implementation", "reference"]))
    np.testing.assert_allclose(a["T"].numpy(), b["T"].numpy(), rtol=0,
                               atol=1e-9)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import adi_thermal_fields_tpu_torch\n"
            "import adi_thermal_fields_tpu_torch.apps.waam_from_stl\n"
            "import adi_thermal_fields_tpu_torch.convert\n"
            "import adi_thermal_fields_tpu_torch.bc.radiation\n"
            "import adi_thermal_fields_tpu_torch.solvers.varprop\n"
            "import adi_thermal_fields_tpu_torch.solvers.vp2\n"
            "import adi_thermal_fields_tpu_torch.step.cartesian_varprop\n"
            "import adi_thermal_fields_tpu_torch.apps.engine\n"
            "import adi_thermal_fields_tpu_torch.apps.spiral_tube\n"
            "import adi_thermal_fields_tpu_torch.birth.spiral\n"
            "import adi_thermal_fields_tpu_torch.solvers.masked\n"
            "import adi_thermal_fields_tpu_torch.step.cylindrical_masked\n"
            "import adi_thermal_fields_tpu_torch.step.cylindrical\n"
            "import adi_thermal_fields_tpu_torch.solvers.const_sweeps\n"
            "import adi_thermal_fields_tpu_torch.solvers.spectral\n"
            "import adi_thermal_fields_tpu_torch.solvers.vpfields\n"
            "import adi_thermal_fields_tpu_torch.step.cylindrical_varprop\n"
            "import adi_thermal_fields_tpu_torch.solvers.fields\n"
            "import adi_thermal_fields_tpu_torch.geometry.bc_correction\n"
            "import adi_thermal_fields_tpu_torch.apps.single_track\n"
            "import adi_thermal_fields_tpu_torch.apps.viewer\n"
            "import adi_thermal_fields_tpu_torch.io.vtk\n"
            "import adi_thermal_fields_tpu_torch.io.checkpoint\n"
            "import adi_thermal_fields_tpu_torch.birth.layers\n"
            "import adi_thermal_fields_tpu_torch.birth.heat_source\n"
            "import adi_thermal_fields_tpu_torch.core.timestep\n"
            "import adi_thermal_fields_tpu_torch.geometry.shapes\n"
            "import adi_thermal_fields_tpu_torch.geometry.perimeter\n"
            "import adi_thermal_fields_tpu_torch.geometry.slices\n"
            "import adi_thermal_fields_tpu_torch.solvers.differentiable\n"
            "import adi_thermal_fields_tpu_torch.io.profiling\n"
            "import adi_thermal_fields_tpu_torch.apps.compare_implementations\n"
            "import adi_thermal_fields_tpu_torch.apps.optimize_process\n"
            "import adi_thermal_fields_tpu_torch.apps.calibrate_params\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax',\n"
            "                                    'adi_thermal_fields_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    mask = torch.ones((4, 5, 6), dtype=torch.bool)
    T = torch.full((4, 5, 6), 100.0, dtype=torch.float64, requires_grad=True)
    code0 = sweep_code(mask, None, 0, stencil_bits=True)
    code2 = sweep_code(mask, None, 2).movedim(0, 2).contiguous()
    calls = [
        lambda: sweep_strided(T, code0, 0.2, 0.05, 20.0, axis=0, rob_c=1e-3),
        lambda: sweep_z(T, code2, 0.2, 0.05, 20.0, 1e-3),
        lambda: theta_rhs(T, mask.to(torch.uint8), 1e-7, 1e6),
        lambda: fused_theta_sweep(T, code0, 1e-7, 1e6, 0.2, 0.05, 20.0, 1e-3),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward only"):
            call()


# the varprop flags, --precision bfloat16 (with --corrected_bc too:
# tests/test_torch_bf16.py::test_waam_app_bfloat16_on_cpu) and the outputs
# (history, VTK, checkpoints, interpass dwell: tests/test_torch_io_apps.py)
# run now; a flag the port lacks still exits, naming only that flag
@pytest.mark.parametrize("flag", [["--mesh", "2x2"]])
def test_unsupported_flags_exit_with_a_message(box_stl, flag):
    args = port_app.build_argparser().parse_args(
        _argv(box_stl)[:-4] + ["--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="not supported by the PyTorch port"
                       ) as exc:
        port_app.run(args)
    for ported in ("--emissivity", "--latent_J_kg", "--melt_k_factor",
                   "--corrected_bc"):
        assert ported not in str(exc.value)


def test_run_refuses_cuda_when_absent(box_stl):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    args = port_app.build_argparser().parse_args(_argv(box_stl))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_app.run(args)
