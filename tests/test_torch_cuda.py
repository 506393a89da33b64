"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc: marked ``cuda`` and skipped without a card.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures jax).  Tolerances at
the inputs' scale (fields up to 1500 C after a solve): float64 1e-9 K,
float32 2e-3 K (~16 ulp; division vs reciprocal-multiply and FMA
contraction).  chip_smoke.py runs the same comparison at full size.
"""
import numpy as np
import pytest
import torch

from adi_thermal_fields_tpu_torch.solvers import (
    fused_theta_sweep, fused_theta_sweep_plain, launch_counts,
    reset_launch_counts, sweep_code, sweep_strided, sweep_strided_plain,
    sweep_z, sweep_z_plain, theta_rhs, theta_rhs_plain)

TG, DT, TINF, ROB = 0.21, 0.05, 20.0, 0.0031
C_EXP, INV = 3.5e-7, (1.0e6, 1.1e6, 0.9e6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-3)],
                         ids=["f64", "f32"])
def test_kernels_match_plain_on_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    shape = (37, 45, 70)               # uneven: partial blocks and tiles
    mask_np = rng.random(shape) > 0.25
    mask = torch.from_numpy(mask_np).to(dev)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    T = cast(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
    coeff = cast(np.where(mask_np & (rng.random(shape) > 0.5), 0.3, 0.0))
    q = cast(rng.random(shape) * 50.0 * mask_np)
    dval = cast(500.0 + 500.0 * rng.random(shape))
    dirm = torch.from_numpy(rng.random(shape) > 0.85).to(dev)

    def nat(axis, dm=None, **kw):
        return sweep_code(mask, dm, axis, **kw).movedim(0, axis).contiguous()

    reset_launch_counts()
    pairs = []
    for axis in (0, 1):
        code = nat(axis, dirm)
        kw = dict(coeff=coeff, qflux=q, dir_val=dval)
        pairs.append((sweep_strided(T, code, TG, DT, TINF, axis=axis, **kw),
                      sweep_strided_plain(T, code, TG, DT, TINF, axis=axis,
                                          **kw)))
        code = nat(axis)
        pairs.append((sweep_strided(T, code, TG, DT, TINF, axis=axis,
                                    rob_c=ROB),
                      sweep_strided_plain(T, code, TG, DT, TINF, axis=axis,
                                          rob_c=ROB)))
    pairs.append((sweep_z(T, nat(2), TG, DT, TINF, ROB),
                  sweep_z_plain(T, nat(2), TG, DT, TINF, ROB)))
    m_u8 = mask.to(torch.uint8)
    pairs.append((theta_rhs(T, m_u8, C_EXP, INV),
                  theta_rhs_plain(T, m_u8, C_EXP, INV)))
    code0 = nat(0, stencil_bits=True)
    pairs.append((fused_theta_sweep(T, code0, C_EXP, INV, TG, DT, TINF, ROB),
                  fused_theta_sweep_plain(T, code0, C_EXP, INV, TG, DT, TINF,
                                          ROB)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and got.dtype == dtype
        assert float((got - want).abs().max()) <= tol
    assert launch_counts() == {"K1": 4, "K2": 1, "K3": 1, "K4": 1}
