"""The port's four kernels (K1-K4) against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, as the JAX package's own tests do.
Inputs come from one numpy seed and go to both.  Tolerance: 1e-10 K
absolute at float64 on fields up to 1500 C (the two sides solve the same
recurrence with divisions in a different order, ~1e-13 apart).

The CUDA kernels themselves are compared with the plain versions on the
card by tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers import pallas_sweeps as jsw
from adi_thermal_fields_tpu.solvers.pallas_stencil import (
    theta_rhs as j_theta_rhs)
from adi_thermal_fields_tpu.solvers.pallas_theta_sweep import (
    fused_theta_sweep_axis0)

from adi_thermal_fields_tpu_torch.solvers import (
    KERNELS, fused_theta_sweep, fused_theta_sweep_plain, launch_counts,
    reset_launch_counts, sweep_code, sweep_strided, sweep_strided_plain,
    sweep_z, sweep_z_plain, theta_rhs, theta_rhs_plain)

torch.set_num_threads(1)

ATOL = 1e-10          # K, float64, fields up to 1500 C
SHAPE = (10, 12, 14)
TG, DT, TINF, ROB = 0.21, 0.05, 20.0, 0.0031
C_EXP, INV = 3.5e-7, (1.0e6, 1.1e6, 0.9e6)


def _fields(shape=SHAPE, seed=0, dirichlet=False):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.25
    T = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    coeff = np.where(mask & (rng.random(shape) > 0.5), 0.3, 0.0)
    q = rng.random(shape) * 50.0 * mask
    dirm = (rng.random(shape) > 0.85) if dirichlet else None
    dval = 500.0 + 500.0 * rng.random(shape)
    return mask, T, coeff, q, dirm, dval


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _code_nat(mask, dirm, axis, **kw):
    """Port code in the natural layout of a sweep along ``axis``."""
    return sweep_code(_t(mask), None if dirm is None else _t(dirm), axis,
                      **kw).movedim(0, axis).contiguous()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("mode", ["lite", "field"])
@pytest.mark.parametrize("bcs", [False, True], ids=["robin", "neu_dir"])
def test_k1_matches_jax(axis, mode, bcs):
    mask, T, coeff, q, dirm, dval = _fields(seed=axis + 2 * bcs,
                                            dirichlet=bcs)
    jcode = jsw.sweep_code(jnp.asarray(mask),
                           None if dirm is None else jnp.asarray(dirm), axis)
    jcode = jnp.moveaxis(jcode, 0, axis)          # natural layout
    kw_j = dict(qflux=jnp.asarray(q), dir_val=jnp.asarray(dval)) if bcs else {}
    jfn = jsw.fused_sweep_axis0_v2 if axis == 0 else jsw.fused_sweep_axis1_v2
    ref = jfn(jnp.asarray(T), jcode,
              None if mode == "lite" else jnp.asarray(coeff), TG, DT, TINF,
              rob_c=ROB if mode == "lite" else None, interpret=True, **kw_j)

    code = _code_nat(mask, dirm, axis)
    kw = dict(qflux=_t(q), dir_val=_t(dval)) if bcs else {}
    got = sweep_strided(_t(T), code, TG, DT, TINF, axis=axis,
                        coeff=None if mode == "lite" else _t(coeff),
                        rob_c=ROB if mode == "lite" else None, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_k2_matches_jax():
    mask, T, *_ = _fields(seed=5)
    jcode = jsw.sweep_code(jnp.asarray(mask), None, 2)   # (z, x, y)
    ref = jsw.fused_sweep_axis2_v2(jnp.asarray(T), jcode, TG, DT, TINF, ROB,
                                   interpret=True)
    got = sweep_z(_t(T), _code_nat(mask, None, 2), TG, DT, TINF, ROB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("inv", [1.0e6, INV], ids=["scalar", "per_axis"])
def test_k3_matches_jax(inv):
    mask, T, *_ = _fields(seed=7)
    ref = j_theta_rhs(jnp.asarray(T), jnp.asarray(mask.astype(np.int8)),
                      C_EXP, jnp.asarray(inv), interpret=True)
    got = theta_rhs(_t(T), _t(mask.astype(np.uint8)), C_EXP, inv)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_k4_matches_jax():
    mask, T, *_ = _fields(seed=9)
    jcode = jsw.sweep_code(jnp.asarray(mask), None, 0, stencil_bits=True)
    ref = fused_theta_sweep_axis0(jnp.asarray(T), jcode, C_EXP,
                                  jnp.asarray(INV), TG, DT, TINF, ROB,
                                  interpret=True)
    got = fused_theta_sweep(_t(T), _code_nat(mask, None, 0,
                                             stencil_bits=True),
                            C_EXP, INV, TG, DT, TINF, ROB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("dirichlet", [False, True])
def test_sweep_code_matches_jax_bitwise(axis, dirichlet):
    """Bit for bit, with the JAX int8 codes read as uint8.  The stencil
    code's bit 128 (the int8 sign bit) must survive."""
    mask, _, _, _, dirm, _ = _fields(seed=11 + axis, dirichlet=dirichlet)
    for stencil in (False, True):
        jc = np.asarray(jsw.sweep_code(
            jnp.asarray(mask), None if dirm is None else jnp.asarray(dirm),
            axis, stencil_bits=stencil)).view(np.uint8)
        pc = sweep_code(_t(mask), None if dirm is None else _t(dirm), axis,
                        stencil_bits=stencil)
        assert pc.dtype == torch.uint8
        np.testing.assert_array_equal(pc.numpy(), jc)
        if stencil:
            assert (pc.numpy() & 128).any()
            assert (np.asarray(jsw.sweep_code(
                jnp.asarray(mask), None, axis, stencil_bits=True)) < 0).any()


def test_pinned_rows_carry_only_the_pin_bit():
    mask = np.ones((4, 5, 6), bool)
    dirm = np.zeros_like(mask)
    dirm[2, 2, 3] = True
    for axis in range(3):
        code = _code_nat(mask, dirm, axis).numpy()
        assert code[2, 2, 3] == 4
        # the neighbours keep their couplings to the pinned row
        lo = [2, 2, 3]
        lo[axis] -= 1
        assert code[tuple(lo)] & 2


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    mask, T, *_ = _fields(seed=13)
    reset_launch_counts()
    Tt = _t(T)
    code0 = _code_nat(mask, None, 0, stencil_bits=True)
    pairs = [
        (sweep_strided(Tt, code0, TG, DT, TINF, axis=0, rob_c=ROB),
         sweep_strided_plain(Tt, code0, TG, DT, TINF, axis=0, rob_c=ROB)),
        (sweep_z(Tt, _code_nat(mask, None, 2), TG, DT, TINF, ROB),
         sweep_z_plain(Tt, _code_nat(mask, None, 2), TG, DT, TINF, ROB)),
        (theta_rhs(Tt, _t(mask.astype(np.uint8)), C_EXP, INV),
         theta_rhs_plain(Tt, _t(mask.astype(np.uint8)), C_EXP, INV)),
        (fused_theta_sweep(Tt, code0, C_EXP, INV, TG, DT, TINF, ROB),
         fused_theta_sweep_plain(Tt, code0, C_EXP, INV, TG, DT, TINF, ROB)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert launch_counts() == {name: 0 for name in KERNELS}
