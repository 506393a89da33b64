"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and nvcc: marked ``cuda`` and skipped without a card.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures jax).  Tolerances at
the inputs' scale (fields up to 1500 C after a solve): float64 1e-9 K,
float32 2e-3 K (~16 ulp; division vs reciprocal-multiply and FMA
contraction).  The variable-property kernels K5-K8 are held to the same
bounds relative to each output's scale (face conductivities, 1/(rho cp)
and films are not temperatures), and so are the cylindrical sweeps K9-K18,
whose stiff phi systems near a full disk's axis amplify one rounding; the
cylindrical varprop step runs kernels against reference at float64.  K20
and K23 repeat their plain versions one rounding at a time: they are
held to bitwise equality, and so are K9, K15 and K15y on lines of up to
kK9MarchRows and kK15MarchRows rows (a thread a line), K13 where its
table passes kK13Stiff (Thomas order) and the tables K13t and K14t.
K6, K7, K7's x entry, K8, K9 past its march, K10, K13 below kK13Stiff,
K15 and K15y on longer lines, K17, K19, K21 and K24-K26 split each line
across threads (the split-line core of K1, K2 and K4): within 8 float32 ulp of the output's
scale, 1e-12 of it at float64 (K24-K26 at bfloat16: one bfloat16 ulp of
the output's scale); K20 then K7's x entry equals K6 bit for bit (the unfused
varprop step equals the fused one).  K11, K16, K18 and K22 split their
periodic lines the same way, in Thomas order on stiff rings: the same
bounds, on the spiral app's ring, 4096-row lines and lines of 2 and 3
rows too; so does K14, its rings past kK14Stiff bit for bit its plain
version.
K1's v1 entry is held to the field-plan K1 bounds.
The bfloat16 entries of K1-K4 solve at float32 like their plain versions
but round differently (FMA contraction): within one bfloat16 ulp of them;
those of K5, K6, K7, K7's x entry and K19 within one bfloat16 ulp of the
output's scale, and K20b bit for bit.
The engine's thermal history leaves the field bit for bit on the card,
and a resumed spiral print equals its straight run bit for bit.
chip_smoke.py runs the same comparisons at full size.
"""
import os
import re

import numpy as np
import pytest
import torch

from adi_thermal_fields_tpu_torch import apparent_cp, melt_pool_enhanced_k
from adi_thermal_fields_tpu_torch import (CylindricalGrid, Material, RobinBC,
                                          ZFaceBC, adi_step_cyl_varprop,
                                          build_cyl_vp2_plan,
                                          build_masked_robin_plan)
from adi_thermal_fields_tpu_torch.solvers import (
    KERNELS, build_vp2_code, const_sweep_strided, const_sweep_strided_plain,
    const_sweep_table, const_sweep_table_plain,
    const_sweep_z, const_sweep_z_plain, cyclic_const_phi,
    cyclic_const_phi_plain, cyclic_const_phi_table,
    cyclic_const_phi_table_plain, fused_sweep, fused_sweep_axis1,
    fused_sweep_axis1_plain, fused_sweep_plain, fused_theta_sweep,
    fused_theta_sweep_plain,
    launch_counts, masked_cyclic_phi, masked_cyclic_phi_plain,
    masked_sweep_strided, masked_sweep_strided_plain, masked_sweep_z,
    masked_sweep_z_plain, reset_launch_counts, sweep_code, sweep_strided,
    sweep_strided_plain, sweep_z, sweep_z_plain, theta_rhs, theta_rhs_plain,
    varprop_fields, varprop_fields_plain, varprop_sweep_y,
    varprop_sweep_y_plain, varprop_theta_sweep, varprop_theta_sweep_plain,
    vp2_cyclic_phi, vp2_cyclic_phi_plain, vp2_sweep_strided,
    vp2_sweep_strided_plain, vp2_sweep_y, vp2_sweep_y_plain, vp2_sweep_z,
    vp2_sweep_z_plain,
    vp_fields_cyclic_phi, vp_fields_cyclic_phi_plain,
    vp_fields_sweep_strided, vp_fields_sweep_strided_plain,
    vp_fields_sweep_z, vp_fields_sweep_z_plain, cyclic_fields,
    cyclic_fields_plain, tridiag_fields, tridiag_fields_plain,
    varprop_sweep_x, varprop_sweep_x_plain, varprop_sweep_z,
    varprop_sweep_z_plain, varprop_theta_rhs, varprop_theta_rhs_plain)
from adi_thermal_fields_tpu_torch.step import cylindrical as pcyl
from adi_thermal_fields_tpu_torch.step import cylindrical_varprop as pcvp

TG, DT, TINF, ROB = 0.21, 0.05, 20.0, 0.0031
C_EXP, INV = 3.5e-7, (1.0e6, 1.1e6, 0.9e6)


def _counts(**launched):
    """launch_counts() when only ``launched`` kernels ran."""
    return {**{k: 0 for k in KERNELS}, **launched}


def _source_constant(name, src):
    """A kernel's ``constexpr`` value ``name`` in csrc/src."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "adi_thermal_fields_tpu_torch", "csrc", src)
    return float(re.search(rf"constexpr \w+ {name} = ([0-9.e+]+);",
                           open(path).read()).group(1))


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
    # K2 with K1's inputs: the field plan's z solve, and Neumann on lite
    for args, kw in (((T, nat(2, dirm), TG, DT, TINF),
                      dict(coeff=coeff, qflux=q, dir_val=dval)),
                     ((T, nat(2), TG, DT, TINF, ROB), dict(qflux=q))):
        pairs.append((sweep_z(*args, **kw), sweep_z_plain(*args, **kw)))
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
    assert launch_counts() == _counts(K1=4, K2=3, K3=1, K4=1)


# Long lines for the split-line sweeps: K1 at 16 rows per thread (past
# 2,048 rows at float32, 896 at float64) and past its shared memory (4,096
# and 1,792 rows: the reduced rows in global memory); K2 past its staged
# lines with every field (5,825 rows at float32, 8,641 at bfloat16, 3,009
# at float64; 16,417 plan-lite at float32).
LONG_LINES = {torch.float32: dict(k1=(3000, 4100, 9000), k2=6000,
                                  k2_lite=17000),
              torch.bfloat16: dict(k1=(4100,), k2=8800, k2_lite=None),
              torch.float64: dict(k1=(1200, 1800, 4100), k2=3100,
                                  k2_lite=None)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(LONG_LINES),
                         ids=["f32", "bf16", "f64"])
def test_long_lines_match_plain_on_card(dtype):
    """K1 (x and y, plan-lite and the field plan's folds, the v1 entry) and
    K2 (the field plan's z, plan-lite with pinned codes) on lines too long
    for shared memory, against their plain versions: float64 1e-9 K,
    float32 2e-3 K, bfloat16 one ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    sizes = LONG_LINES[dtype]

    def fields(shape):
        mask = torch.from_numpy(rng.random(shape) > 0.1).to(dev)
        dirm = torch.from_numpy(rng.random(shape) > 0.97).to(dev) & mask
        r = (lambda: torch.from_numpy(rng.random(shape)).to(dev))
        T = torch.where(mask, 20.0 + 1480.0 * r(), 20.0).to(dtype)
        kw = dict(coeff=torch.where(mask & (r() > 0.5), 0.3, 0.0),
                  qflux=r() * 50.0 * mask, dir_val=500.0 + 500.0 * r())
        return mask, dirm, T, {k: v.to(dtype) for k, v in kw.items()}

    def nat(mask, dirm, axis):
        return sweep_code(mask, dirm, axis).movedim(0, axis).contiguous()

    cases = []
    for n in sizes["k1"]:
        for axis, shape in ((0, (n, 3, 45)), (1, (2, n, 37))):
            mask, dirm, T, kw = fields(shape)
            cases += [(sweep_strided, sweep_strided_plain,
                       (T, nat(mask, None, axis), TG, DT, TINF),
                       dict(axis=axis, rob_c=ROB)),
                      (sweep_strided, sweep_strided_plain,
                       (T, nat(mask, dirm, axis), TG, DT, TINF),
                       dict(axis=axis, **kw))]
            if dtype != torch.bfloat16:
                cases.append((sweep_strided, sweep_strided_plain,
                              (T, nat(mask, dirm, axis), TG, DT, TINF),
                              dict(axis=axis, coeff=kw["coeff"],
                                   pin_from_code=True)))
    mask, dirm, T, kw = fields((3, 5, sizes["k2"]))
    cases.append((sweep_z, sweep_z_plain, (T, nat(mask, dirm, 2), TG, DT,
                                           TINF), kw))
    if sizes["k2_lite"]:
        mask, _, T, kw = fields((3, 5, sizes["k2_lite"]))
        pins = torch.from_numpy(rng.random(mask.shape) > 0.9).to(dev)
        code = nat(mask, None, 2) | (pins.to(torch.uint8) * 4)
        cases += [(sweep_z, sweep_z_plain, (T, code, TG, DT, TINF, ROB), {}),
                  (sweep_z, sweep_z_plain, (T, code, TG, DT, TINF, ROB),
                   dict(qflux=kw["qflux"]))]
    for kern, plain, args, kw in cases:
        got, want = kern(*args, **kw), plain(*args, **kw)
        assert got.is_cuda and got.dtype == dtype
        if dtype == torch.bfloat16:
            assert _bf16_ulps(got, want) <= 1.0
        else:
            tol = 1e-9 if dtype == torch.float64 else 2e-3
            assert float((got - want).abs().max()) <= tol


# K3 and K4 at odd shapes: nz no multiple of 4 or 32 (K3's scalar path,
# K4's partial lane groups), 1-3 planes, and (K4) lines past shared memory
# (1,024 rows at float32 and bfloat16, 512 at float64).
THETA_SHAPES = {torch.float32: ((6, 7, 13), (5, 9, 34), (1, 5, 7),
                                (2, 3, 1), (3, 4, 64), (4200, 2, 37)),
                torch.bfloat16: ((6, 7, 13), (3, 4, 64), (4200, 2, 37)),
                torch.float64: ((6, 7, 13), (5, 9, 34), (2, 3, 1),
                                (1900, 3, 9))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(THETA_SHAPES),
                         ids=["f32", "bf16", "f64"])
def test_theta_kernels_at_odd_shapes_on_card(dtype):
    """K3 and K4 against their plain versions (float64 1e-9 K, float32
    2e-3 K, bfloat16 one bfloat16 ulp of the output's scale), scalar and
    per-axis 1/d^2, to nearest and (bfloat16) seeded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(71)
    seeds = (None, 5) if dtype == torch.bfloat16 else (None,)
    reset_launch_counts()
    calls = 0
    for shape in THETA_SHAPES[dtype]:
        mask_np = rng.random(shape) > 0.25
        mask = torch.from_numpy(mask_np).to(dev)
        T = torch.from_numpy(np.where(mask_np, 20.0 + 1480.0
                                      * rng.random(shape), 20.0)) \
            .to(dev, dtype)
        code = sweep_code(mask, None, 0, stencil_bits=True)
        m_u8 = mask.to(torch.uint8)
        for inv, seed in ((i, s) for i in (1.0e6, INV) for s in seeds):
            sr = dict(rng_seed=seed)
            k4 = (T, code, C_EXP, inv, TG, DT, TINF, ROB)
            for got, want in (
                    (theta_rhs(T, m_u8, C_EXP, inv, **sr),
                     theta_rhs_plain(T, m_u8, C_EXP, inv, **sr)),
                    (fused_theta_sweep(*k4, rng_offset=1, **sr),
                     fused_theta_sweep_plain(*k4, rng_offset=1, **sr))):
                assert got.is_cuda and got.dtype == dtype
                err = float((got.double() - want.double()).abs().max())
                if dtype == torch.bfloat16:
                    scale = float(want.double().abs().max())
                    assert err <= 2.0 ** (np.floor(np.log2(scale)) - 7), \
                        shape
                else:
                    assert err <= (1e-9 if dtype == torch.float64
                                   else 2e-3), shape
            calls += 1
    counts = (dict(K3b=calls, K4b=calls) if dtype == torch.bfloat16
              else dict(K3=calls, K4=calls))
    assert launch_counts() == _counts(**counts)


@pytest.mark.cuda
def test_theta_sweep_takes_no_field_sized_scratch_on_card():
    """K4 solves each line on chip: one call raises the allocator's peak
    by its output alone, under two fields (the first version took c' and
    d' scratch of two more fields)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    shape = (128, 96, 160)
    rng = np.random.default_rng(73)
    mask = torch.from_numpy(rng.random(shape) > 0.25).to(dev)
    T = torch.where(mask, 900.0, 20.0).to(torch.float32)
    code = sweep_code(mask, None, 0, stencil_bits=True)
    args = (T, code, C_EXP, INV, TG, DT, TINF, ROB)
    fused_theta_sweep(*args)                  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fused_theta_sweep(*args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(dev) - base
    field = T.numel() * T.element_size()
    assert out.shape == T.shape
    assert field <= rise < 2 * field, (rise, field)


# K7 and K8 on the split-line core: 8192-row lines (K7's reduced rows in
# global memory past 4,352 rows at float32 and 2,048 at float64; K8 with 16
# chunks a lane at float32, on the core's strided kernel at float64),
# fields of one and three planes across and along the sweep, odd lines.
VP_SPLIT_SHAPES = ((3, 8192, 37), (2, 37, 8192), (1, 512, 512),
                   (3, 512, 512), (512, 1, 512), (512, 3, 512),
                   (512, 512, 1), (512, 512, 3), (5, 700, 33), (5, 33, 700))


def _vp_split_calls(shape, dtype, seed):
    """(name, kernel, plain) of K7 (h stream, rob_c) and K8 (radiation) on
    ``shape``, T through the mushy interval."""
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_varprop_codes)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)
    mask_np = rng.random(shape) > 0.2
    mask = torch.from_numpy(mask_np).to(dev)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    T = cast(np.where(mask_np, 20.0 + 1580.0 * rng.random(shape), 20.0))
    T.view(-1)[::7] = 1420.0
    T.view(-1)[3::11] = 1470.0
    R = cast(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
    kt = melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0)
    ct = apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0)
    fc, w, h = varprop_fields_plain(T, mask.to(torch.uint8), k_spec=kt,
                                    cp_spec=ct, rho=7800.0,
                                    rad=(0.5, TINF, 30.0))
    codes = build_varprop_codes(mask)
    yk = (R, codes[1], fc[1], w, 7e4, 70.0, TINF)
    zk = (R, T, codes[2], 2e6, 2e3, 2.2e5)
    zkw = dict(k_spec=kt, cp_spec=ct, h=15.0, t_inf=TINF, emissivity=0.5)
    return [("K7", lambda: varprop_sweep_y(*yk, h=h),
             lambda: varprop_sweep_y_plain(*yk, h=h)),
            ("K7", lambda: varprop_sweep_y(*yk, rob_c=30.0),
             lambda: varprop_sweep_y_plain(*yk, rob_c=30.0)),
            ("K8", lambda: vp2_sweep_z(*zk, **zkw),
             lambda: vp2_sweep_z_plain(*zk, **zkw))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_vp_split_sweeps_on_long_lines_and_planes_on_card(dtype, rel):
    """K7 and K8 against their plain versions on 8192-row lines, on one-
    and three-plane fields and on odd lines, within ``rel`` of the
    output's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    reset_launch_counts()
    for i, shape in enumerate(VP_SPLIT_SHAPES):
        for name, kern, plain in _vp_split_calls(shape, dtype, 60 + i):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == dtype
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= rel * scale, \
                (name, shape)
    n = len(VP_SPLIT_SHAPES)
    assert launch_counts() == _counts(K7=2 * n, K8=n)


@pytest.mark.cuda
def test_vp_split_sweeps_take_no_field_sized_scratch_on_card():
    """K7 and K8 solve each line on chip: one call raises the allocator's
    peak by its output alone, under two fields (their first versions took
    a c'/d' scratch field beside the output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    for _, kern, _ in _vp_split_calls((128, 96, 160), torch.float32, 71):
        out = kern()                          # builds and loads the library
        torch.cuda.synchronize()
        del out
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = kern()
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - base
        field = out.numel() * out.element_size()
        assert field <= rise < 2 * field, (rise, field)
        del out


# K6 and K7x on x lines past their shared memory (8192 rows: reduced rows
# in global memory), on fields of one and three planes and odd lines; K19
# on z lines past its staging (8192 and 5000 rows: the core's strided
# kernel), of one and three rows, and odd.
VP_XZ_SHAPES = ((8192, 3, 37), (1, 512, 512), (3, 512, 512), (700, 5, 33),
                (2, 37, 8192), (3, 7, 5000), (512, 512, 1), (512, 512, 3),
                (5, 33, 700))


def _vp_xz_calls(shape, dtype, seed):
    """(name, kernel, plain) of K6 (h stream; rob_c + src), K7x (h stream)
    and K19 (h stream, rob_c) on ``shape``, T through the mushy interval."""
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_varprop_codes)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)
    mask_np = rng.random(shape) > 0.2
    mask = torch.from_numpy(mask_np).to(dev)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    T = cast(np.where(mask_np, 20.0 + 1580.0 * rng.random(shape), 20.0))
    T.view(-1)[::7] = 1420.0
    T.view(-1)[3::11] = 1470.0
    R = cast(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
    src = cast(rng.random(shape) * 1e6)
    fc, w, h = varprop_fields_plain(
        T, mask.to(torch.uint8), k_spec=melt_pool_enhanced_k(
            54.0, 1420.0, 1470.0, 4.0),
        cp_spec=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0),
        rho=7800.0, rad=(0.5, TINF, 30.0))
    codes = build_varprop_codes(mask)
    th = (T, codes[0], *fc, w, 0.0175, INV, 7e4, 70.0, TINF)
    sk = dict(rob_c=30.0, src=src, dt=DT)
    xk = (R, codes[0], fc[0], w, 7e4, 70.0, TINF)
    zk = (R, codes[3], fc[2], w, 7e4, 70.0, TINF)
    return [("K6", lambda: varprop_theta_sweep(*th, h=h),
             lambda: varprop_theta_sweep_plain(*th, h=h)),
            ("K6", lambda: varprop_theta_sweep(*th, **sk),
             lambda: varprop_theta_sweep_plain(*th, **sk)),
            ("K7x", lambda: varprop_sweep_x(*xk, h=h),
             lambda: varprop_sweep_x_plain(*xk, h=h)),
            ("K19", lambda: varprop_sweep_z(*zk, h=h),
             lambda: varprop_sweep_z_plain(*zk, h=h)),
            ("K19", lambda: varprop_sweep_z(*zk, rob_c=30.0),
             lambda: varprop_sweep_z_plain(*zk, rob_c=30.0))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_vp_x_and_z_sweeps_on_long_lines_and_planes_on_card(dtype, rel):
    """K6, K7x and K19 against their plain versions on 8192-row lines, on
    one- and three-plane fields and on odd lines, within ``rel`` of the
    output's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    reset_launch_counts()
    for i, shape in enumerate(VP_XZ_SHAPES):
        for name, kern, plain in _vp_xz_calls(shape, dtype, 80 + i):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == dtype
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= rel * scale, \
                (name, shape)
    n = len(VP_XZ_SHAPES)
    assert launch_counts() == _counts(K6=2 * n, K7x=n, K19=2 * n)


@pytest.mark.cuda
def test_vp_x_and_z_sweeps_take_no_field_sized_scratch_on_card():
    """K6, K7x and K19 solve each line on chip: one call raises the
    allocator's peak by its output alone, under two fields (their first
    versions took a c'/d' scratch field beside the output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    for _, kern, _ in _vp_xz_calls((128, 96, 160), torch.float32, 79):
        out = kern()                          # builds and loads the library
        torch.cuda.synchronize()
        del out
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = kern()
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - base
        field = out.numel() * out.element_size()
        assert field <= rise < 2 * field, (rise, field)
        del out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_unfused_varprop_step_equals_fused_on_card(dtype):
    """``adi_step_varprop_fused(fuse_theta=False)`` (K20 -> K7x -> K7 ->
    K19) equals the fused step (K6 -> K7 -> K19) bit for bit on an uneven
    field whose x lines span five 8-row chunks, with per-face film streams,
    radiation and a source."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch import (CartesianGrid,
                                              adi_step_varprop_fused,
                                              build_varprop_codes)
    from adi_thermal_fields_tpu_torch.bc.faces import FACES
    from adi_thermal_fields_tpu_torch.step.cartesian_varprop import (
        build_face_h_axes)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(47)
    grid = CartesianGrid(37, 45, 70, 5e-4)
    mask_np = rng.random(grid.shape) > 0.2
    mask = torch.from_numpy(mask_np).to(dev)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    T = cast(np.where(mask_np, 1300.0 + 300.0 * rng.random(grid.shape),
                      20.0))
    src = cast(rng.random(grid.shape) * 1e8 * mask_np)
    hf = {f: cast(10.0 + 10.0 * rng.random(grid.shape)) for f in FACES}
    h_axes = build_face_h_axes(mask, hf, dtype=dtype)
    codes = build_varprop_codes(mask)
    kw = dict(k_table=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
              cp_table=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0),
              dt=0.02, t_inf=20.0, h_axes=h_axes, emissivity=0.5,
              h_conv=None, source=src)
    mat = Material(7800.0, 490.0, 54.0)
    reset_launch_counts()
    fused = adi_step_varprop_fused(T, mask, codes, grid, mat, **kw)
    unfused = adi_step_varprop_fused(T, mask, codes, grid, mat,
                                     fuse_theta=False, **kw)
    assert launch_counts() == _counts(K5=2, K6=1, K20=1, K7x=1, K7=2,
                                      K19=2)
    assert torch.equal(fused, unfused)


def _flat(out):
    return [t for x in (out if isinstance(out, tuple) else (out,))
            for t in (x if isinstance(x, tuple) else (x,))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_varprop_kernels_match_plain_on_card(dtype, rel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    shape = (37, 45, 70)               # uneven: partial blocks and tiles
    mask_np = rng.random(shape) > 0.25
    mask = torch.from_numpy(mask_np).to(dev)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    T = cast(np.where(mask_np, 20.0 + 1580.0 * rng.random(shape), 20.0))
    T.view(-1)[::7] = 1420.0
    T.view(-1)[3::11] = 1470.0
    R = cast(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
    src = cast(rng.random(shape) * 1e6)
    kt = melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0)
    ct = apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0)
    m8 = mask.to(torch.uint8)
    rad = (0.5, 20.0, 30.0)
    fk = dict(k_spec=kt, cp_spec=ct, rho=7800.0)
    fc, w, h = varprop_fields_plain(T, m8, rad=rad, **fk)
    code0 = sweep_code(mask, None, 0)
    code1 = sweep_code(mask, None, 1).movedim(0, 1).contiguous()
    code2 = build_vp2_code(mask, 2, edge_exposed=True)
    # dt 0.035 s on 0.5 mm voxels: cw, 1/d^2, theta*dt/d^2, dt/d
    th = (T, code0, *fc, w, 0.0175, 4e6, 7e4, 70.0, TINF)
    yk = (R, code1, fc[1], w, 7e4, 70.0, TINF)
    zk = (R, T, code2, 2e6, 2e3, 2.2e5)
    zkw = dict(k_spec=kt, cp_spec=ct, h=15.0, t_inf=TINF, emissivity=0.5)

    reset_launch_counts()
    pairs = [
        (varprop_fields(T, m8, **fk), varprop_fields_plain(T, m8, **fk)),
        (varprop_fields(T, m8, rad=rad, **fk),
         varprop_fields_plain(T, m8, rad=rad, **fk)),
        (varprop_theta_sweep(*th, h=h), varprop_theta_sweep_plain(*th, h=h)),
        (varprop_theta_sweep(*th, rob_c=30.0, src=src, dt=DT),
         varprop_theta_sweep_plain(*th, rob_c=30.0, src=src, dt=DT)),
        (varprop_sweep_y(*yk, h=h), varprop_sweep_y_plain(*yk, h=h)),
        (varprop_sweep_y(*yk, rob_c=30.0),
         varprop_sweep_y_plain(*yk, rob_c=30.0)),
        (vp2_sweep_z(*zk, **zkw), vp2_sweep_z_plain(*zk, **zkw)),
        (vp2_sweep_z(*zk, **{**zkw, "emissivity": 0.0}),
         vp2_sweep_z_plain(*zk, **{**zkw, "emissivity": 0.0})),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        for a, b in zip(_flat(got), _flat(want)):
            assert a.is_cuda and a.dtype == dtype
            assert float((a - b).abs().max()) <= rel * float(b.abs().max())
    assert launch_counts() == _counts(K5=2, K6=2, K7=2, K8=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("r_inner,kind_bot", [(0.02, "dirichlet"),
                                              (0.0, "neumann0")],
                         ids=["annular-pins", "disk"])
def test_masked_kernels_match_plain_on_card(dtype, rel, r_inner, kind_bot):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    shape = (37, 45, 70)               # uneven: partial blocks and tiles
    grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=r_inner)
    act = torch.from_numpy(rng.random(shape) > 0.25).to(dev)
    plan = build_masked_robin_plan(
        grid, Material(7800.0, 490.0, 54.0), act,
        robin_outer=RobinBC(300.0, 20.0),
        zbc=ZFaceBC(kind_bot=kind_bot, T_bot=140.0, kind_top="robin",
                    h_top=400.0), robin_inner=RobinBC(150.0, 30.0),
        h_void=80.0, h_front=60.0, dtype=dtype)
    R = torch.from_numpy(20.0 + 1480.0 * rng.random(shape)).to(dev, dtype)
    fac = float(torch.tensor(0.05, dtype=dtype) * (54.0 / (7800.0 * 490.0)))
    reset_launch_counts()
    pairs = [
        (masked_sweep_strided(R, *plan.r, fac, 20.0),
         masked_sweep_strided_plain(R, *plan.r, fac, 20.0)),
        (masked_cyclic_phi(R, *plan.phi, fac, 20.0),
         masked_cyclic_phi_plain(R, *plan.phi, fac, 20.0)),
        (masked_sweep_z(R, *plan.z, fac, 20.0),
         masked_sweep_z_plain(R, *plan.z, fac, 20.0)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and got.dtype == dtype
        assert float((got - want).abs().max()) <= rel * float(
            want.abs().max())
    # K9's 37-row r lines: its march, bit for bit
    assert torch.equal(*pairs[0])
    assert launch_counts() == _counts(K9=1, K10=1, K11=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nphi,r_inner,kind_bot", [
    (45, 0.02, "neumann0"), (45, 0.0, "dirichlet"), (2, 0.0, "dirichlet")],
    ids=["annular-odd", "disk-odd-dirichlet", "disk-nphi2-dirichlet"])
def test_const_kernels_match_plain_on_card(dtype, rel, nphi, r_inner,
                                           kind_bot):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(29)
    grid = CylindricalGrid(37, nphi, 70, 5e-4, 5e-4, r_inner=r_inner)
    mat = Material(7800.0, 490.0, 54.0)
    rob = RobinBC(300.0, 20.0)
    zbc = ZFaceBC(kind_bot=kind_bot, T_bot=140.0, kind_top="robin",
                  h_top=400.0)
    R = torch.from_numpy(20.0 + 1480.0 * rng.random(grid.shape)).to(dev,
                                                                    dtype)
    r_vecs = pcyl._r_coefficients(grid, mat, rob, RobinBC(150.0, 30.0), DT,
                                  dtype, dev)
    z_vecs, _ = pcyl._z_coefficients(grid, mat, zbc, DT, dtype, dev)
    fac = pcyl._phi_fac(grid, mat, 1.0, DT, dtype, dev)
    reset_launch_counts()
    pairs = [(const_sweep_strided(R, *r_vecs),
              const_sweep_strided_plain(R, *r_vecs)),
             (cyclic_const_phi(R, fac), cyclic_const_phi_plain(R, fac)),
             (const_sweep_z(R, *z_vecs), const_sweep_z_plain(R, *z_vecs))]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and got.dtype == dtype
        assert float((got - want).abs().max()) <= rel * float(
            want.abs().max())
    # K12 and K13 each build their table in the call (K13t twice)
    assert launch_counts() == _counts(K12=1, K13=1, K14=1, K13t=2, K14t=1)


# K9's r lines: up to its march's rows (a thread a line: bit for bit), one
# row past them and 300 rows (the core's strided split kernel); float64
# marches lines of up to 64 rows
K9_MARCH = int(_source_constant("kK9MarchRows", "masked.cu"))
K9_SHAPES = ((2, 45, 70), (min(K9_MARCH, 64), 9, 33), (K9_MARCH, 6, 40),
             (K9_MARCH + 1, 6, 40), (300, 5, 21))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_masked_r_sweep_past_its_march_on_card(dtype, rel):
    """K9 against its plain version on r lines of 2 rows, of the march's
    rows (bit for bit) and past them (the strided split kernel: within
    ``rel`` of the output's scale), at the step's dt and ten times it
    (float32 blocks past kK10Stiff in Thomas order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    march = K9_MARCH if dtype == torch.float32 else min(K9_MARCH, 64)
    reset_launch_counts()
    calls = 0
    for i, shape in enumerate(K9_SHAPES):
        rng = np.random.default_rng(90 + i)
        grid = CylindricalGrid(*shape, 2.5e-4, 2.5e-4, r_inner=0.02)
        act = torch.from_numpy(rng.random(shape) > 0.2).to(dev)
        plan = build_masked_robin_plan(
            grid, Material(7800.0, 490.0, 54.0), act,
            robin_outer=RobinBC(300.0, 20.0),
            zbc=ZFaceBC(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                        h_top=400.0), robin_inner=RobinBC(150.0, 30.0),
            h_void=80.0, dtype=dtype)
        R = torch.from_numpy(20.0 + 1480.0 * rng.random(shape)).to(dev, dtype)
        for dt in (0.02, 0.2):
            fac = float(torch.tensor(dt, dtype=dtype)
                        * (54.0 / (7800.0 * 490.0)))
            got = masked_sweep_strided(R, *plan.r, fac, 20.0)
            want = masked_sweep_strided_plain(R, *plan.r, fac, 20.0)
            calls += 1
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == dtype
            assert bool(torch.isfinite(got).all())
            assert float((got - want).abs().max()) <= rel * float(
                want.abs().max()), (shape, dt)
            if shape[0] <= march:
                assert torch.equal(got, want), (shape, dt)
    assert launch_counts() == _counts(K9=calls)


# K13's z lines: 2, 3 and 131 rows (staged 4 or 8 bytes a copy), ragged
# line counts (partial tiles), 512 and 132 rows (16 bytes a copy; 132: a
# padded tile row) and 8192 rows (past the staging: rows read in each
# pass), each at the step's dt, and at a dt whose table passes kK13Stiff
# (Thomas order, bit for bit): (nr, nphi, nz)
K13_STIFF = _source_constant("kK13Stiff", "const_sweeps.cu")
K13_SHAPES = ((3, 5, 2), (2, 7, 3), (5, 9, 131), (4, 16, 512),
              (2, 33, 8192), (3, 7, 132))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_k13_on_short_long_and_stiff_lines_on_card(dtype, rel):
    """K13's table bit for bit its plain version's; K13 given the table
    and not (the table built in the call) alike, within ``rel`` of the
    output's scale of its plain version, and bit for bit where the table
    passes kK13Stiff."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    mat = Material(7800.0, 490.0, 54.0)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                  h_top=400.0)
    reset_launch_counts()
    calls = 0
    for i, shape in enumerate(K13_SHAPES):
        grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
        rng = np.random.default_rng(110 + i)
        R = torch.from_numpy(20.0 + 1480.0 * rng.random(shape)).to(dev,
                                                                   dtype)
        for dt in (0.02, 2000.0):
            vecs, _ = pcyl._z_coefficients(grid, mat, zbc, dt, dtype, dev)
            table = const_sweep_table(*vecs[:3])
            got = const_sweep_z(R, *vecs, table)
            alone = const_sweep_z(R, *vecs)
            want = const_sweep_z_plain(R, *vecs)
            calls += 1
            torch.cuda.synchronize()
            assert torch.equal(table, const_sweep_table_plain(*vecs[:3]))
            assert torch.equal(got, alone)
            assert got.is_cuda and got.dtype == dtype
            assert bool(torch.isfinite(got).all())
            stiff = float(table[-1]) > K13_STIFF
            # ratios of ~2.3 at the step's dt, 2.3e5 at 2000 s (n = 2:
            # 269, and stiff or not by kK13Stiff)
            assert stiff == (dt > 1.0) or shape[2] == 2, (shape, dt)
            assert float((got - want).abs().max()) <= rel * float(
                want.abs().max()), (shape, dt)
            if stiff:
                assert torch.equal(got, want), (shape, dt)
    assert launch_counts() == _counts(K13=2 * calls, K13t=2 * calls)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("nphi,r_inner,kind_bot", [
    (45, 0.02, "neumann0"), (45, 0.0, "dirichlet"), (2, 0.0, "dirichlet")],
    ids=["annular-odd", "disk-odd-dirichlet", "disk-nphi2-dirichlet"])
def test_cyl_varprop_kernels_match_plain_on_card(dtype, rel, nphi, r_inner,
                                                 kind_bot):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(31)
    grid = CylindricalGrid(37, nphi, 70, 5e-4, 5e-4, r_inner=r_inner)
    shape = grid.shape
    zbc = ZFaceBC(kind_bot=kind_bot, T_bot=1400.0, kind_top="robin",
                  h_top=400.0, T_inf_top=25.0)
    act = torch.from_numpy(rng.random(shape) > 0.25).to(dev)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    T = cast(1400.0 + 100.0 * rng.random(shape))
    T.view(-1)[::7] = 1420.0
    T.view(-1)[3::11] = 1470.0
    R = cast(20.0 + 1480.0 * rng.random(shape))
    code_r, code_p, code_z = build_cyl_vp2_plan(act, grid, zbc)
    cols = pcvp._vp2_columns(grid, zbc, dtype, dev)
    f = np.float32 if dtype == torch.float32 else np.float64
    inv = float(f(1.0) / f(f(0.02) / f(7800.0)))
    tabs = dict(k_spec=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
                cp_spec=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0))
    rk = dict(h_lo=80.0, h_hi=80.0, tinf_void=15.0, emissivity=0.5,
              edge0=(150.0, 1.9e3, 30.0), edge1=(300.0, 2.1e3, 20.0), **tabs)
    r_cols = (cols["glo_r"], cols["ghi_r"], cols["gsl_r"], cols["gsh_r"])
    pk = dict(h_void=80.0, tinf_void=15.0, emissivity=0.5, **tabs)
    zk = dict(ghi=cols["geo_z"], gsh=cols["gs_z"], h=80.0, h_hi=200.0,
              t_inf=15.0, emissivity=0.5, edge1=(400.0, 2e3, 25.0), **tabs)
    z_args = (R, T, code_z, cols["geo_z"], cols["gs_z"], inv)
    streams = [cast(a) for a in (
        20.0 + 1480.0 * rng.random(shape),
        54.0 * (1.0 + 3.0 * rng.random(shape)) * (rng.random(shape) > 0.2),
        2e-8 * (0.5 + rng.random(shape)), 3e3 * rng.random(shape),
        6e4 * rng.random(shape))]
    reset_launch_counts()
    pairs = [
        (vp2_sweep_strided(R, T, code_r, *r_cols, inv, **rk),
         vp2_sweep_strided_plain(R, T, code_r, *r_cols, inv, **rk)),
        (vp2_sweep_strided(None, T, code_r, *r_cols, inv, **rk),
         vp2_sweep_strided_plain(None, T, code_r, *r_cols, inv, **rk)),
        (vp2_cyclic_phi(R, T, code_p, cols["geo_p"], cols["gs_p"], inv,
                        **pk),
         vp2_cyclic_phi_plain(R, T, code_p, cols["geo_p"], cols["gs_p"], inv,
                              **pk)),
        (vp2_sweep_z(*z_args, **zk), vp2_sweep_z_plain(*z_args, **zk)),
        (vp_fields_sweep_strided(*streams, cols["glo_r"], cols["ghi_r"]),
         vp_fields_sweep_strided_plain(*streams, cols["glo_r"],
                                       cols["ghi_r"])),
        (vp_fields_sweep_z(*streams, cols["geo_z"], cols["geo_z"]),
         vp_fields_sweep_z_plain(*streams, cols["geo_z"], cols["geo_z"])),
        (vp_fields_cyclic_phi(*streams, cols["geo_p"]),
         vp_fields_cyclic_phi_plain(*streams, cols["geo_p"])),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and got.dtype == dtype
        assert float((got - want).abs().max()) <= rel * float(
            want.abs().max())
    assert launch_counts() == _counts(K8=1, K15=2, K16=1, K17=2, K18=1)


# K11's and K16's further lines (chip_smoke.py CYCLIC_SHAPES): (shape, dr,
# r_inner) of the spiral app's ring (720 rows: formed again in phase (c)),
# 4096-row lines on a 1 m annulus (the split solve, 16-row chunks, reduced
# rows in global memory) and on a 20 mm one (stiff rings: the Thomas-order
# replay), lines of 2 and 3 rows on full disks
CYCLIC_SHAPES = {"app-ring": ((32, 720, 200), 2.5e-4, 0.052),
                 "long-mild": ((2, 4096, 64), 5e-4, 1.0),
                 "long-stiff": ((2, 4096, 64), 5e-4, 0.02),
                 "n2-disk": ((8, 2, 96), 5e-4, 0.0),
                 "n3-disk": ((8, 3, 96), 5e-4, 0.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(CYCLIC_SHAPES))
def test_cyclic_phi_kernels_on_long_short_and_stiff_lines_on_card(case,
                                                                  dtype, rel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    shape, dr, r_inner = CYCLIC_SHAPES[case]
    rng = np.random.default_rng(41)
    grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
    act = torch.from_numpy(rng.random(shape) > 0.25).to(dev)
    zbc = ZFaceBC(kind_bot="dirichlet", T_bot=1400.0, kind_top="robin",
                  h_top=400.0)
    mat = Material(7800.0, 490.0, 54.0)
    plan = build_masked_robin_plan(grid, mat, act,
                                   robin_outer=RobinBC(300.0, 20.0), zbc=zbc,
                                   h_void=80.0, dtype=dtype)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    R = cast(20.0 + 1480.0 * rng.random(shape))
    T = cast(1400.0 + 100.0 * rng.random(shape))
    T.view(-1)[::7] = 1420.0
    T.view(-1)[3::11] = 1470.0
    fac = float(torch.tensor(0.05, dtype=dtype) * (54.0 / (7800.0 * 490.0)))
    code_p = build_cyl_vp2_plan(act, grid, zbc)[1]
    cols = pcvp._vp2_columns(grid, zbc, dtype, dev)
    f = np.float32 if dtype == torch.float32 else np.float64
    inv = float(f(1.0) / f(f(0.02) / f(7800.0)))
    pk = dict(k_spec=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
              cp_spec=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0),
              h_void=80.0, tinf_void=15.0, emissivity=0.5)
    phi = (R, T, code_p, cols["geo_p"], cols["gs_p"], inv)
    # K18's streams at the step's scale (dw*geo*flo as the tube's), and its
    # rows materialized for K22 (the fields tier's)
    flo = pcvp._face_phi(pk["k_spec"](T), act)
    dw = fac / 54.0 * (0.5 + cast(rng.random(shape)))
    sink = cast(3e3 * rng.random(shape) * (rng.random(shape) > 0.7))
    sp = (R, flo, dw, sink, sink * 20.0)
    g3 = cols["geo_p"][:, None, None]
    fhi = torch.roll(flo, -1, 1)
    ap = (-(dw * (g3 * flo)), 1.0 + dw * (g3 * (flo + fhi) + sink),
          -(dw * (g3 * fhi)), R + dw * (sink * 20.0))
    reset_launch_counts()
    pairs = [(masked_cyclic_phi(R, *plan.phi, fac, 20.0),
              masked_cyclic_phi_plain(R, *plan.phi, fac, 20.0)),
             (vp2_cyclic_phi(*phi, **pk), vp2_cyclic_phi_plain(*phi, **pk)),
             (vp_fields_cyclic_phi(*sp, cols["geo_p"]),
              vp_fields_cyclic_phi_plain(*sp, cols["geo_p"])),
             (cyclic_fields(*ap, 1), cyclic_fields_plain(*ap, 1))]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and got.dtype == dtype
        assert float((got - want).abs().max()) <= rel * float(
            want.abs().max())
    assert launch_counts() == _counts(K11=1, K16=1, K18=1, K22=1)


# K14's rings: the spiral app's 720-row ring (rows in registers at
# float32, read again in each pass at float64), 4096-row
# lines (rows read again in each pass) and a full disk, whose inner rings
# pass kK14Stiff (Thomas order): (shape, dr, r_inner)
K14_RINGS = {"app-ring": ((32, 720, 200), 2.5e-4, 0.052),
             "long": ((2, 4096, 64), 5e-4, 1.0),
             "disk": ((37, 203, 131), 5e-4, 0.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(K14_RINGS))
def test_k14_on_long_and_flagged_rings_on_card(case, dtype, rel):
    """K14's table bit for bit its plain version's, K14 on long lines
    within ``rel`` of the output's scale, and on the rings past kK14Stiff
    bit for bit its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    shape, dr, r_inner = K14_RINGS[case]
    grid = CylindricalGrid(*shape, dr, dr, r_inner=r_inner)
    mat = Material(7800.0, 490.0, 54.0)
    fac = pcyl._phi_fac(grid, mat, 1.0, 0.02, dtype, dev)
    rng = np.random.default_rng(43)
    R = torch.from_numpy(20.0 + 1480.0 * rng.random(shape)).to(dev, dtype)
    n = shape[1]
    reset_launch_counts()
    table = cyclic_const_phi_table(fac, n)
    got = cyclic_const_phi(R, fac, table)
    want = cyclic_const_phi_plain(R, fac)
    torch.cuda.synchronize()
    assert torch.equal(table, cyclic_const_phi_table_plain(fac, n))
    flag = 2.0 * fac > _source_constant("kK14Stiff", "const_sweeps.cu")
    assert bool(flag.any()) == (case == "disk")
    assert torch.equal(got[flag], want[flag])
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())
    assert launch_counts() == _counts(K14=1, K14t=1)


def _k15_calls(shape, dtype, seed, scale=1.0):
    """(name, kernel, plain) of K15 along axis 0 of ``shape`` (distinct
    per-row columns, h_lo != h_hi, both edge films; the rhs given and T
    itself) and of K15's y entry along axis 1 (constant columns); the
    couplings times ``scale`` (x10: float32 blocks past kK8Stiff, solved
    in Thomas order)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)
    act = torch.from_numpy(rng.random(shape) > 0.2).to(dev)
    cast = (lambda a: torch.from_numpy(np.asarray(a)).to(dev, dtype))
    T = cast(np.where(act.cpu().numpy(),
                      1350.0 + 200.0 * rng.random(shape), 20.0))
    T.view(-1)[::7] = 1420.0
    T.view(-1)[3::11] = 1470.0
    R = cast(20.0 + 1480.0 * rng.random(shape))
    f = np.float32 if dtype == torch.float32 else np.float64
    inv = float(f(1.0) / f(f(0.02) / f(7800.0)))
    tabs = dict(k_spec=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
                cp_spec=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0))
    n = shape[0]
    cols = [cast(base * (1.0 + 0.2 * rng.random(n)))
            for base in (4e6 * scale, 4e6 * scale, 2e3, 2e3)]
    code_r = build_vp2_code(act, 0)
    code_y = build_vp2_code(act, 1, edge_exposed=True)
    rk = dict(h_lo=80.0, h_hi=200.0, tinf_void=15.0, emissivity=0.5,
              edge0=(150.0, 1.9e3, 30.0), edge1=(300.0, 2.1e3, 20.0), **tabs)
    yk = dict(h=30.0, t_inf=15.0, emissivity=0.5, **tabs)
    glo = float(f(4e5 * scale))
    return [
        ("K15 rhs", lambda: vp2_sweep_strided(R, T, code_r, *cols, inv, **rk),
         lambda: vp2_sweep_strided_plain(R, T, code_r, *cols, inv, **rk)),
        ("K15 rhs is T",
         lambda: vp2_sweep_strided(None, T, code_r, *cols, inv, **rk),
         lambda: vp2_sweep_strided_plain(None, T, code_r, *cols, inv, **rk)),
        ("K15y", lambda: vp2_sweep_y(R, T, code_y, glo, 2e3, inv, **yk),
         lambda: vp2_sweep_y_plain(R, T, code_y, glo, 2e3, inv, **yk))]


# K15's and K15y's lines: odd, short (1-3 rows, ragged line counts) and
# up to K15_MARCH rows (the march of a thread a line), one row past it and
# long (300 rows: the strided split kernel with kept rows; 8192 rows: its
# reduced rows in global memory)
K15_MARCH = int(_source_constant("kK15MarchRows", "vp2_sweep.cu"))
K15_SHAPES = ((37, 45, 70), (64, 9, 33), (1, 5, 40), (2, 3, 7), (3, 2, 65),
              (300, 6, 40), (6, 300, 40), (8192, 4, 40), (5, 8192, 3),
              (K15_MARCH, 6, 40), (K15_MARCH + 1, 6, 40),
              (6, K15_MARCH + 1, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_vp2_strided_on_split_kernel_on_card(dtype, rel):
    """K15 and K15y against their plain versions on odd and short lines
    and lines of K15_MARCH rows (the march: bit for bit) and on lines one
    row longer, of 300 and of 8192 rows (the core's strided kernel),
    within ``rel`` of the output's scale; with the couplings x10 (float32
    blocks past kK8Stiff in Thomas order) too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    reset_launch_counts()
    runs = {"K15": 0, "K15y": 0}
    for i, shape in enumerate(K15_SHAPES):
        for scale in ((1.0, 10.0) if 37 in shape or 300 in shape
                      else (1.0,)):
            for name, kern, plain in _k15_calls(shape, dtype, 70 + i, scale):
                got, want = kern(), plain()
                torch.cuda.synchronize()
                runs[name.split()[0]] += 1
                assert got.is_cuda and got.dtype == dtype
                assert bool(torch.isfinite(got).all())
                scale_out = max(1.0, float(want.abs().max()))
                assert float((got - want).abs().max()) <= rel * scale_out, \
                    (name, shape, scale)
                n = shape[0] if name.startswith("K15 ") else shape[1]
                if n <= K15_MARCH:
                    assert torch.equal(got, want), (name, shape, scale)
    assert launch_counts() == _counts(**runs)


@pytest.mark.cuda
def test_k14_and_k15_take_no_field_sized_scratch_on_card():
    """K14 (given its table), K12 (given its table, marched and split) and
    K15 (the rhs given and T itself) raise the allocator's peak by their
    output alone (their first versions wrote y' or d' to a field-sized
    buffer beside it: K15 to a scratch field)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    grid = CylindricalGrid(64, 96, 160, 5e-4, 5e-4, r_inner=0.02)
    fac = pcyl._phi_fac(grid, Material(7800.0, 490.0, 54.0), 1.0, 0.02,
                        torch.float32, dev)
    R = torch.rand(grid.shape, device=dev) * 1000.0 + 20.0
    table = cyclic_const_phi_table(fac, grid.nphi)
    calls = [lambda: cyclic_const_phi(R, fac, table)]
    # K12 given its table: the march (64 rows) and the split kernel past
    # its registers (600 rows: d' through the output)
    for shape in (grid.shape, (600, 8, 40)):
        g = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
        key = (g, Material(7800.0, 490.0, 54.0), RobinBC(300.0, 20.0), None,
               0.02, torch.float32, dev)
        vecs = pcyl._r_coefficients(*key)
        Rk = R if shape == grid.shape else torch.rand(shape, device=dev)
        calls.append(lambda Rk=Rk, vecs=vecs, t=pcyl._r_table(*key):
                     const_sweep_strided(Rk, *vecs, t))
    calls += [kern for _, kern, _ in
              _k15_calls((64, 96, 160), torch.float32, 73)[:2]]
    for kern in calls:
        out = kern()                          # builds and loads the library
        torch.cuda.synchronize()
        del out
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = kern()
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - base
        field = out.numel() * out.element_size()
        assert field <= rise < 2 * field, (rise, field)
        del out


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,launches", [
    ("be", {"K8": 1, "K15": 1, "K16": 1}), ("douglas", {"K17": 2, "K18": 1})])
def test_cyl_varprop_step_on_card(scheme, launches):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(37)
    grid = CylindricalGrid(24, 45, 40, 5e-4, 5e-4, r_inner=0.0)
    act = torch.from_numpy(rng.random(grid.shape) > 0.2).to(dev)
    T = torch.from_numpy(1380.0 + 150.0 * rng.random(grid.shape)).to(dev)
    kw = dict(dt=0.02, robin_outer=RobinBC(300.0, 20.0),
              zbc=ZFaceBC(kind_bot="dirichlet", T_bot=1400.0,
                          kind_top="robin", h_top=400.0),
              k_table=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
              cp_table=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0),
              active=act, h_void=80.0, h_front=200.0, emissivity=0.5,
              scheme=scheme)
    mat = Material(7800.0, 490.0, 54.0)
    reset_launch_counts()
    got = adi_step_cyl_varprop(T, grid, mat, **kw)
    assert launch_counts() == _counts(**launches)
    want = adi_step_cyl_varprop(T, grid, mat, implementation="reference",
                                **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_general_route_kernels_match_plain_on_card(dtype):
    """K7's x entry, K19 and K20 (the corrected-BC route) and K21/K22 (the
    field solves) against their plain versions: K20 bitwise, K7x, K19, K21
    and K22 (lines split across threads) within 8 float32 ulp of the
    output's scale, 1e-12 of it at float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(41)
    shape = (37, 45, 70)               # uneven: partial blocks and tiles
    mask_np = rng.random(shape) > 0.25
    mask = torch.from_numpy(mask_np).to(dev)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    T = cast(np.where(mask_np, 20.0 + 1580.0 * rng.random(shape), 20.0))
    R = cast(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
    src = cast(rng.random(shape) * 1e6)
    m8 = mask.to(torch.uint8)
    fc, w, h = varprop_fields_plain(
        T, m8, k_spec=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
        cp_spec=apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0),
        rho=7800.0, rad=(0.5, 20.0, 30.0))
    code0 = sweep_code(mask, None, 0)
    code2 = sweep_code(mask, None, 2).movedim(0, 2).contiguous()
    a, c = -cast(rng.random(shape)), -cast(rng.random(shape))
    b = 1.0 + 2.0 * cast(rng.random(shape)) - a - c
    rows = (R, 7e4, 70.0, TINF)
    reset_launch_counts()
    # K7x, K19, K21 and K22 split each line (8 float32 ulp of the output's
    # scale, 1e-12 of it at float64)
    split = [
        (varprop_sweep_x(R, code0, fc[0], w, *rows[1:], h=h),
         varprop_sweep_x_plain(R, code0, fc[0], w, *rows[1:], h=h)),
        (varprop_sweep_z(R, code2, fc[2], w, *rows[1:], h=h),
         varprop_sweep_z_plain(R, code2, fc[2], w, *rows[1:], h=h)),
        (varprop_sweep_z(R, code2, fc[2], w, *rows[1:], rob_c=30.0),
         varprop_sweep_z_plain(R, code2, fc[2], w, *rows[1:], rob_c=30.0)),
        *((tridiag_fields(a, b, c, R, ax),
           tridiag_fields_plain(a, b, c, R, ax)) for ax in range(3)),
        (cyclic_fields(a, b, c, R, 1), cyclic_fields_plain(a, b, c, R, 1)),
    ]
    pairs = [
        (varprop_theta_rhs(T, *fc, w, m8, 0.0175, INV),
         varprop_theta_rhs_plain(T, *fc, w, m8, 0.0175, INV)),
        (varprop_theta_rhs(T, *fc, w, m8, 0.0175, INV, src=src, dt=DT),
         varprop_theta_rhs_plain(T, *fc, w, m8, 0.0175, INV, src=src,
                                 dt=DT)),
    ]
    torch.cuda.synchronize()
    rel = 1e-12 if dtype == torch.float64 else 8 * 2.0 ** -23
    for got, want in split:
        assert got.is_cuda and got.dtype == dtype
        assert float((got - want).abs().max()) <= \
            rel * float(want.abs().max())
    for got, want in pairs:
        assert got.is_cuda and got.dtype == dtype
        assert torch.equal(got, want)
    assert launch_counts() == _counts(K7x=1, K19=2, K20=2, K21=3, K22=1)


# K21 and K17 on lines past their staging and their kept rows (8192 rows
# along each axis), on odd lines and on lines of 1-3 rows
FIELD_SHAPES = ((8192, 3, 37), (3, 8192, 37), (2, 37, 8192), (700, 5, 33),
                (5, 33, 700), (3, 7, 5000), (1, 9, 40), (2, 9, 40),
                (3, 9, 3), (9, 40, 1), (9, 40, 2))


def _field_calls(shape, dtype, seed, fo=2.0):
    """(name, kernel, plain) of K21 along each axis (rows diagonally
    dominant) and of K17 along r and z (natural) on ``shape``: streams of
    the cylindrical varprop step whose coupling dw*glo*fhi is ~``fo``."""
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    a, c = -cast(rng.random(shape)), -cast(rng.random(shape))
    b = 1.0 + 2.0 * cast(rng.random(shape)) - a - c
    d = cast(20.0 + 1480.0 * rng.random(shape))
    fhi = cast(54.0 * (1.0 + 3.0 * rng.random(shape))
               * (rng.random(shape) > 0.1))
    dw = cast(fo / 216.0 / 4e6 * (0.5 + rng.random(shape)))
    sink = cast(3e3 * rng.random(shape) * (rng.random(shape) > 0.7))
    streams = (d, fhi, dw, sink, sink * 20.0)
    geo = (lambda n: cast(4e6 * (1.0 + 0.1 * rng.random(n))))
    gr, gz = (geo(shape[0]), geo(shape[0])), (geo(shape[2]), geo(shape[2]))
    return [*((f"K21 axis {ax}", lambda ax=ax: tridiag_fields(a, b, c, d, ax),
               lambda ax=ax: tridiag_fields_plain(a, b, c, d, ax))
              for ax in range(3)),
            ("K17 r", lambda: vp_fields_sweep_strided(*streams, *gr),
             lambda: vp_fields_sweep_strided_plain(*streams, *gr)),
            ("K17 z", lambda: vp_fields_sweep_z(*streams, *gz),
             lambda: vp_fields_sweep_z_plain(*streams, *gz))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_field_sweeps_on_long_and_short_lines_on_card(dtype, rel):
    """K21 (each axis) and K17 (r, natural z) against their plain versions
    on 8192-row lines, odd lines and lines of 1-3 rows, within ``rel`` of
    the output's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    reset_launch_counts()
    for i, shape in enumerate(FIELD_SHAPES):
        for name, kern, plain in _field_calls(shape, dtype, 90 + i):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == dtype
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= rel * scale, \
                (name, shape)
    n = len(FIELD_SHAPES)
    assert launch_counts() == _counts(K17=2 * n, K21=3 * n)


@pytest.mark.cuda
def test_field_sweeps_take_no_field_sized_scratch_on_card():
    """K21, K17, K22 and K18 solve each line on chip: one call raises the
    allocator's peak by its output alone, under two fields (their first
    versions took a c'/d' or c'/y/z scratch beside the output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    calls = _field_calls((128, 96, 160), torch.float32, 89)
    a, b, c, d = (torch.rand((128, 96, 160), device=dev) for _ in range(4))
    b = b + 2.0
    st = tuple(torch.rand((128, 96, 160), device=dev) for _ in range(5))
    geo = torch.rand(128, device=dev)
    calls += [("K22", lambda: cyclic_fields(a, b, c, d, 1), None),
              ("K18", lambda: vp_fields_cyclic_phi(*st, geo), None)]
    for _, kern, _ in calls:
        out = kern()                          # builds and loads the library
        torch.cuda.synchronize()
        del out
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = kern()
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - base
        field = out.numel() * out.element_size()
        assert field <= rise < 2 * field, (rise, field)
        del out


@pytest.mark.cuda
@pytest.mark.parametrize("route,launches", [
    ("h_axes", dict(K5=1, K6=1, K7=1, K19=1)),
    ("fuse_theta_false", dict(K5=1, K20=1, K7x=1, K7=1, K19=1)),
    ("neumann_dirichlet", dict(K21=3))])
def test_varprop_routes_on_card(route, launches):
    """The float64 Cartesian varprop routes of this slice through the
    engine on the card: launches per step, and kernels against reference
    within 1e-9 K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch import (CartesianGrid,
                                              adi_step_varprop_fused,
                                              build_varprop_codes)
    from adi_thermal_fields_tpu_torch.apps.engine import (
        make_cartesian_engine)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(43)
    grid = CartesianGrid(37, 45, 70, 5e-4)
    mask = torch.from_numpy(rng.random(grid.shape) > 0.2).to(dev)
    T = torch.from_numpy(1300.0 + 300.0 * rng.random(grid.shape)).to(dev)
    mat = Material(7800.0, 490.0, 54.0)
    tabs = dict(k_table=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
                cp_table=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0))
    faces = ("x-", "x+", "y-", "y+", "z-", "z+")
    if route == "fuse_theta_false":
        reset_launch_counts()
        got = adi_step_varprop_fused(T, mask, build_varprop_codes(mask),
                                     grid, mat, dt=0.02, robin_h=30.0,
                                     t_inf=20.0, fuse_theta=False, **tabs)
        assert launch_counts() == _counts(**launches)
        want = adi_step_varprop_fused(T.cpu(), mask.cpu(),
                                      build_varprop_codes(mask.cpu()), grid,
                                      mat, dt=0.02, robin_h=30.0, t_inf=20.0,
                                      **tabs)
    else:
        if route == "h_axes":
            bcs = dict(robin_h={f: torch.from_numpy(
                10.0 + 10.0 * rng.random(grid.shape)).to(dev)
                for f in faces}, emissivity=0.5,
                radiation_scale={f: torch.from_numpy(
                    0.7 + 0.6 * rng.random(grid.shape)).to(dev)
                    for f in faces})
        else:
            dirm = torch.zeros(grid.shape, dtype=torch.bool, device=dev)
            dirm[:, :, 0] = True
            bcs = dict(robin_h=200.0, neumann={"z+": 5e5},
                       dirichlet_mask=dirm, dirichlet_value=1350.0)
        res = {}
        for impl in ("kernels", "reference"):
            prep, adv = make_cartesian_engine(
                grid, mat, implementation=impl, device=dev,
                dtype=torch.float64, t_inf=20.0, **bcs, **tabs)
            p = prep(mask)
            reset_launch_counts()
            res[impl] = adv(T, p, 0.02, 1, 0.0)
            if impl == "kernels":
                assert launch_counts() == _counts(**launches)
        got, want = res["kernels"], res["reference"]
    torch.cuda.synchronize()
    assert float((got.cpu() - want.cpu()).abs().max()) <= 1e-9


def _bf16_ulps(got, want):
    """|got - want| in bfloat16 ulps at the larger of the two values."""
    got, want = got.double().cpu(), want.double().cpu()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    return ((got - want).abs() / torch.exp2(torch.floor(torch.log2(big))
                                            - 7)).max().item()


def _split_gate(got, want):
    """A split solve against its plain version: 8 float32 ulp of the
    output's scale (1e-12 of it at float64; at bfloat16 one ulp, and at
    most 0.1% of the cells apart, or 4: both round one float32 value under
    one key, so they part only next to a rounding boundary, where a wrong
    key parts at ~25-50% of them)."""
    scale = float(want.double().abs().max())
    err = float((got.double() - want.double()).abs().max())
    if want.dtype == torch.bfloat16:
        assert err <= 2.0 ** (np.floor(np.log2(scale)) - 7), err
        apart = int((got != want).sum())
        assert apart <= max(4, 1e-3 * want.numel()), apart
    else:
        rel = 1e-12 if want.dtype == torch.float64 else 8 * 2.0 ** -23
        assert err <= rel * scale, err / scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gstream_kernels_match_plain_on_card(dtype):
    """K23 (film modes const, stream and rad, with and without a source)
    against its plain version on the card: bitwise; K24 (with and without
    src_pre), K25 and K26 (split solves), with and without a rounding seed:
    within 8 float32 ulp of the output's scale at float32, one bfloat16
    ulp of it at bfloat16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch.solvers import (
        gstream_fields, gstream_fields_plain, gstream_sweep_y,
        gstream_sweep_y_plain, gstream_sweep_z, gstream_sweep_z_plain,
        gstream_theta_sweep, gstream_theta_sweep_plain)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(47)
    shape = (37, 45, 70)               # uneven: partial blocks and tiles
    mask_np = rng.random(shape) > 0.25
    m8 = torch.from_numpy(mask_np).to(dev, torch.uint8)
    cast = (lambda a: torch.from_numpy(a).to(dev, torch.float32).to(dtype))
    T = cast(np.where(mask_np, 20.0 + 1580.0 * rng.random(shape), 20.0))
    R = cast(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
    h = cast(50.0 + 100.0 * rng.random(shape))
    src = cast(rng.random(shape) * 1e8)
    tabs = dict(k_spec=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
                cp_spec=apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0),
                rho=7800.0)
    tg3, sk3 = (1.5e-3, 1.4e-3, 1.6e-3), (49.0, 51.0, 47.0)
    fkw = [dict(h_mode="const", hpar=30.0), dict(h_mode="stream", h=h),
           dict(h_mode="rad", hpar=0.5, h_conv=30.0, t_inf=20.0)]
    reset_launch_counts()
    pairs = []
    for i, kw in enumerate(fkw):
        s = src if i == 2 else None
        got = gstream_fields(T, m8, tg3, sk3, dt=0.02, src=s, **tabs, **kw)
        want = gstream_fields_plain(T, m8, tg3, sk3, dt=0.02, src=s, **tabs,
                                    **kw)
        pairs += list(zip([*got[0], *got[1], *got[2]],
                          [*want[0], *want[1], *want[2]]))
        if s is not None:
            pairs.append((got[3], want[3]))
    g_lo, g_hi, sw, sp = got
    split = []
    for seed in (None, 12):
        sr = dict(rng_seed=seed, rng_offset=1)
        for s in (None, sp):
            args = (T, g_lo[0], g_hi[0], g_lo[1], g_hi[1], g_lo[2], g_hi[2],
                    sw[0], 1.0, 20.0)
            split.append((gstream_theta_sweep(*args, src_pre=s, **sr),
                          gstream_theta_sweep_plain(*args, src_pre=s, **sr)))
        split.append((gstream_sweep_y(R, g_lo[1], g_hi[1], sw[1], 20.0, **sr),
                      gstream_sweep_y_plain(R, g_lo[1], g_hi[1], sw[1], 20.0,
                                            **sr)))
        split.append((gstream_sweep_z(R, g_lo[2], g_hi[2], sw[2], 20.0,
                                      **sr),
                      gstream_sweep_z_plain(R, g_lo[2], g_hi[2], sw[2], 20.0,
                                            **sr)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and got.dtype == dtype
        assert torch.equal(got, want)
    for got, want in split:
        assert got.is_cuda and got.dtype == dtype
        _split_gate(got, want)
    assert launch_counts() == _counts(K23=3, K24=4, K25=2, K26=2)


@pytest.mark.cuda
def test_bf16_entries_match_plain_on_card():
    """The bfloat16 entries of K1 (plan-lite x and y, the field plan with
    Neumann and Dirichlet folds, the permuted z), K2 (plan-lite, and the
    field plan's z with the same folds), K3 and K4 against
    their plain versions on the card, rounding to nearest and
    stochastically: within one bfloat16 ulp (the float32 solves round
    differently, FMA and reciprocals)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(53)
    shape = (37, 45, 70)
    mask_np = rng.random(shape) > 0.25
    mask = torch.from_numpy(mask_np).to(dev)
    bf = (lambda a: torch.from_numpy(a).to(dev, torch.float32)
          .to(torch.bfloat16))
    T = bf(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
    coeff = bf(np.where(mask_np & (rng.random(shape) > 0.5), 0.3, 0.0))
    q = bf(rng.random(shape) * 50.0 * mask_np)
    dval = bf(500.0 + 500.0 * rng.random(shape))
    dirm = torch.from_numpy(rng.random(shape) > 0.85).to(dev)

    def nat(axis, dm=None, **kw):
        return sweep_code(mask, dm, axis, **kw).movedim(0, axis).contiguous()

    zxy = (lambda t: t.permute(2, 0, 1).contiguous())
    Tz = zxy(T)
    cz = sweep_code(mask, dirm, 2)
    reset_launch_counts()
    pairs = []
    for seed in (None, 21):
        sr = dict(rng_seed=seed, rng_offset=2)
        calls = [
            (sweep_strided, sweep_strided_plain,
             (T, nat(0), TG, DT, TINF), dict(axis=0, rob_c=ROB)),
            (sweep_strided, sweep_strided_plain,
             (T, nat(1), TG, DT, TINF), dict(axis=1, rob_c=ROB)),
            (sweep_strided, sweep_strided_plain,
             (T, nat(0, dirm), TG, DT, TINF),
             dict(axis=0, coeff=coeff, qflux=q, dir_val=dval)),
            (sweep_strided, sweep_strided_plain,
             (Tz, cz, TG, DT, TINF),
             dict(axis=0, coeff=zxy(coeff), qflux=zxy(q),
                  dir_val=zxy(dval), zxy=True)),
            (sweep_z, sweep_z_plain, (T, nat(2), TG, DT, TINF, ROB), {}),
            (sweep_z, sweep_z_plain, (T, nat(2, dirm), TG, DT, TINF),
             dict(coeff=coeff, qflux=q, dir_val=dval)),
            (theta_rhs, theta_rhs_plain,
             (T, mask.to(torch.uint8), C_EXP, INV), {}),
            (fused_theta_sweep, fused_theta_sweep_plain,
             (T, nat(0, stencil_bits=True), C_EXP, INV, TG, DT, TINF, ROB),
             {}),
        ]
        pairs += [(k(*a, **kw, **sr), p(*a, **kw, **sr))
                  for k, p, a, kw in calls]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and got.dtype == torch.bfloat16
        assert _bf16_ulps(got, want) <= 1.0
    assert launch_counts() == _counts(K1b=8, K2b=4, K3b=2, K4b=2)


# The classic varprop tier's bfloat16 entries: odd shapes (z even: rows
# read in pairs; z odd: one row a load), lines of 1 and 2 rows along each
# axis, line counts that leave a partial warp, and 8192-row lines along x,
# y and z (K6b's and K7's reduced rows in global memory, K19b past its
# staging on the core's strided kernel).
BF16_VP_SHAPES = ((37, 45, 70), (37, 45, 71), (1, 45, 70), (2, 45, 71),
                  (37, 1, 70), (37, 2, 70), (37, 45, 1), (37, 45, 2),
                  (8192, 2, 64), (2, 8192, 64), (2, 64, 8192))


@pytest.mark.cuda
def test_bf16_varprop_entries_on_card():
    """K20b against its plain version bit for bit (one rounding per
    operation in the plain order, the same rounding bits); K5b (with and
    without the film; its tables contracted into FMAs), K6b (film stream
    and source), K7xb, K7b and K19b (film stream and rob_c; split solves)
    within one bfloat16 ulp of the output's scale; each rounding to nearest
    and seeded, on BF16_VP_SHAPES."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    kt = melt_pool_enhanced_k(54.0, 1416.0, 1472.0, 4.0)
    ct = apparent_cp(490.0, 520.0, 2.7e5, 1416.0, 1472.0)
    bf = torch.bfloat16
    reset_launch_counts()
    n_split = 0
    for i, shape in enumerate(BF16_VP_SHAPES):
        rng = np.random.default_rng(70 + i)
        mask_np = rng.random(shape) > 0.2
        mask = torch.from_numpy(mask_np).to(dev)
        m8 = mask.to(torch.uint8)
        cast = (lambda a: torch.from_numpy(a).to(dev, torch.float32).to(bf))
        T = cast(np.where(mask_np, 20.0 + 1580.0 * rng.random(shape), 20.0))
        T.view(-1)[::7] = 1416.0              # the solidus and liquidus
        T.view(-1)[3::11] = 1472.0
        R = cast(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
        src = cast(1e8 * rng.random(shape))
        tabs = dict(k_spec=kt, cp_spec=ct, rho=7800.0)
        for rad in (None, (0.5, TINF, 30.0)):
            got = varprop_fields(T, m8, rad=rad, **tabs)
            want = varprop_fields_plain(T, m8, rad=rad, **tabs)
            for g, w in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
                assert g.is_cuda and g.dtype == bf
                _split_gate(g, w)
        fc, w, h = want
        codes = [sweep_code(mask, None, ax).movedim(0, ax).contiguous()
                 for ax in range(3)]
        for seed in (None, 31):
            sr = dict(rng_seed=seed)
            rhs = (T, *fc, w, m8, 0.01, INV)
            got = varprop_theta_rhs(*rhs, src=src, dt=0.02, rng_offset=0,
                                    **sr)
            assert torch.equal(got, varprop_theta_rhs_plain(
                *rhs, src=src, dt=0.02, rng_offset=0, **sr)), shape
            th = (T, codes[0], *fc, w, 0.01, INV, 7e4, 70.0, TINF)
            split = [(varprop_theta_sweep, varprop_theta_sweep_plain, th,
                      dict(h=h, src=src, dt=0.02, rng_offset=1))]
            for ax, (kern, plain) in enumerate((
                    (varprop_sweep_x, varprop_sweep_x_plain),
                    (varprop_sweep_y, varprop_sweep_y_plain),
                    (varprop_sweep_z, varprop_sweep_z_plain))):
                args = (R, codes[ax], fc[ax], w, 7e4, 70.0, TINF)
                split += [(kern, plain, args, dict(h=h, rng_offset=ax + 1)),
                          (kern, plain, args,
                           dict(rob_c=30.0, rng_offset=ax + 1))]
            for kern, plain, args, kw in split:
                got = kern(*args, **kw, **sr)
                want_s = plain(*args, **kw, **sr)
                torch.cuda.synchronize()
                assert got.is_cuda and got.dtype == bf
                _split_gate(got, want_s)
            n_split += 1
    n = len(BF16_VP_SHAPES)
    assert launch_counts() == _counts(K5b=2 * n, K20b=2 * n, K6b=2 * n,
                                      K7xb=4 * n, K7b=4 * n, K19b=4 * n)
    assert n_split == 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("route,launches", [
    ("lite", dict(K4b=1, K1b=1, K2b=1)),
    ("field", dict(K3b=1, K1b=2, K2b=1)),
    ("gstreams", dict(K23=1, K24=1, K25=1, K26=1))])
def test_bf16_engine_routes_on_card(route, launches):
    """make_cartesian_engine(dtype=bfloat16, stochastic_rounding=True) on
    the card: launches per step, and the card's step against the CPU's
    (plain versions, the same rounding bits): within two bfloat16 ulps,
    the g-stream step within one (K23 repeats its plain version, K24-K26
    split their lines: a float32 rounding apart, which can move a cell's
    stochastic rounding by one ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch import CartesianGrid
    from adi_thermal_fields_tpu_torch.apps.engine import (
        make_cartesian_engine)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(59)
    grid = CartesianGrid(37, 45, 70, 5e-4)
    mask = torch.from_numpy(rng.random(grid.shape) > 0.2)
    T = torch.from_numpy(1300.0 + 300.0 * rng.random(grid.shape)) \
        .to(torch.float32).to(torch.bfloat16)
    mat = Material(7800.0, 490.0, 54.0)
    bcs = {"lite": dict(robin_h=30.0),
           "field": dict(robin_h={f: 30.0 for f in ("x-", "x+", "y-", "y+",
                                                    "z-", "z+")}),
           "gstreams": dict(robin_h=15.0, emissivity=0.5,
                            k_table=melt_pool_enhanced_k(54.0, 1420.0,
                                                         1470.0, 4.0),
                            cp_table=apparent_cp(490.0, 490.0, 2.7e5,
                                                 1420.0, 1470.0))}[route]
    res = {}
    for d in (dev, torch.device("cpu")):
        prep, adv = make_cartesian_engine(
            grid, mat, implementation="kernels", device=d,
            dtype=torch.bfloat16, t_inf=20.0, stochastic_rounding=True,
            **bcs)
        p = prep(mask.to(d))
        reset_launch_counts()
        res[d.type] = adv(T.to(d), p, 0.02, 1, 0.5)
        assert launch_counts() == _counts(**{
            k: v if d.type == "cuda" else 0 for k, v in launches.items()})
    torch.cuda.synchronize()
    got, want = res["cuda"].cpu(), res["cpu"]
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want) <= (1.0 if route == "gstreams" else 2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 2e-3)],
                         ids=["f64", "f32"])
def test_v1_and_vp2_y_entries_match_plain_on_card(dtype, tol):
    """K1's v1 entry (fused_sweep for every axis, with the Neumann and
    Dirichlet folds and with pinned codes but no dir_val; the axis-1 form
    at n = 45) and K15's y entry (scalar and radiative film, bitwise)
    against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(61)
    shape = (37, 45, 70)
    mask_np = rng.random(shape) > 0.25
    mask = torch.from_numpy(mask_np).to(dev)
    dirm = torch.from_numpy(rng.random(shape) > 0.85).to(dev)
    cast = (lambda a: torch.from_numpy(a).to(dev, dtype))
    T = cast(np.where(mask_np, 20.0 + 1480.0 * rng.random(shape), 20.0))
    coeff = cast(np.where(mask_np & (rng.random(shape) > 0.5), 0.3, 0.0))
    q = cast(rng.random(shape) * 50.0 * mask_np)
    dval = cast(500.0 + 500.0 * rng.random(shape))
    reset_launch_counts()
    pairs = []
    for kw in ({}, dict(qflux=q, dir_val=dval)):
        for axis in range(3):
            a = (T, sweep_code(mask, dirm, axis), coeff, TG, DT, TINF, axis)
            pairs.append((fused_sweep(*a, **kw), fused_sweep_plain(*a, **kw)))
        a = (T, sweep_code(mask, dirm, 1).movedim(0, 1).contiguous(), coeff,
             TG, DT, TINF)
        pairs.append((fused_sweep_axis1(*a, **kw),
                      fused_sweep_axis1_plain(*a, **kw)))
    code = build_vp2_code(mask, 1, edge_exposed=True)
    T2 = T.clone()
    T2.view(-1)[::7] = 1420.0
    tabs = dict(k_spec=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
                cp_spec=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0))
    bitwise = []
    for eps in (0.0, 0.5):
        a = (T, T2, code, 4.0e5, 2.0e3, 1.5e5)
        kw = dict(h=30.0, t_inf=TINF, emissivity=eps, **tabs)
        bitwise.append((vp2_sweep_y(*a, **kw), vp2_sweep_y_plain(*a, **kw)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.is_cuda and got.dtype == dtype
        assert float((got - want).abs().max()) <= tol
    for got, want in bitwise:
        assert torch.equal(got, want)
    assert launch_counts() == _counts(K1v1=8, K15y=2)


@pytest.mark.cuda
@pytest.mark.parametrize("flag,launches", [
    (False, dict(K5=1, K6=1, K7=1, K8=1)),
    (True, dict(K5=1, K6=1, K15y=1, K8=1))], ids=["off", "on"])
def test_vp2_y_switch_on_card(flag, launches, monkeypatch):
    """The float32 varprop step through the engine with VP2_Y_DEFAULT off
    and on: launches per step, the card's step against the CPU's (plain
    versions) within 2e-3 K, and the switched step within the JAX switch
    test's rtol 2e-5 / atol 5e-3 K of the switch-off step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import adi_thermal_fields_tpu_torch.step.cartesian_varprop as cv
    from adi_thermal_fields_tpu_torch import CartesianGrid
    from adi_thermal_fields_tpu_torch.apps.engine import (
        make_cartesian_engine)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(67)
    grid = CartesianGrid(37, 45, 70, 5e-4)
    mask = torch.from_numpy(rng.random(grid.shape) > 0.2)
    T = torch.from_numpy(1300.0 + 300.0 * rng.random(grid.shape)) \
        .to(torch.float32)
    bcs = dict(robin_h=30.0, emissivity=0.5,
               k_table=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
               cp_table=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0))
    res = {}
    for on, d in ((flag, dev), (flag, torch.device("cpu")),
                  (False, torch.device("cpu"))):
        monkeypatch.setattr(cv, "VP2_Y_DEFAULT", on)
        prep, adv = make_cartesian_engine(
            grid, Material(7800.0, 490.0, 54.0), implementation="kernels",
            device=d, dtype=torch.float32, t_inf=20.0, **bcs)
        p = prep(mask.to(d))
        reset_launch_counts()
        res[(on, d.type)] = adv(T.to(d), p, 0.02, 1, 0.0).cpu()
        assert launch_counts() == _counts(**(
            launches if d.type == "cuda" else {}))
    got = res[(flag, "cuda")]
    assert float((got - res[(flag, "cpu")]).abs().max()) <= 2e-3
    off = res[(False, "cpu")]
    assert bool(((got - off).abs() <= 5e-3 + 2e-5 * off.abs()).all())


# K8's general form on K8's split-line kernel: lines of 1-3 rows, several
# lines a warp (n <= 16 chunks), one and several chunks a lane, n no
# multiple of the chunk, 8192-row lines (the core's strided kernel), and
# films, edge films, Dirichlet rows and distinct or shared columns.
VP2_GENERAL_SHAPES = ((3, 5, 1), (4, 3, 2), (3, 7, 3), (5, 9, 70),
                      (3, 5, 256), (3, 5, 257), (3, 4, 700), (2, 3, 1024),
                      (2, 2, 1030), (1, 3, 5000), (2, 2, 8192))


def _vp2_general_calls(shape, dtype, seed, dt=0.02):
    """(name, kernel, plain) of K8's general form on ``shape``: shared
    columns with Dirichlet end rows (the cylindrical step's), distinct
    columns with both edge films, with and without radiation."""
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(seed)
    n = shape[2]
    act = torch.from_numpy(rng.random(shape) > 0.2).to(dev)
    cast = (lambda a: torch.from_numpy(np.asarray(a)).to(dev, dtype))
    T = cast(np.where(act.cpu().numpy(),
                      1350.0 + 200.0 * rng.random(shape), 20.0))
    T.view(-1)[::7] = 1420.0
    T.view(-1)[3::11] = 1470.0
    R = cast(20.0 + 1480.0 * rng.random(shape))
    f = np.float32 if dtype == torch.float32 else np.float64
    inv = float(f(1.0) / f(f(dt) / f(7800.0)))
    tabs = dict(k_spec=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
                cp_spec=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0))
    geo = np.full(n, 4e6)
    geo[[0, n - 1]] = 0.0                      # Dirichlet end rows
    code_d = build_vp2_code(act, 2, clear_rows=(0, n - 1))
    code = build_vp2_code(act, 2)
    glo, ghi = (cast(4e6 * (1.0 + 0.2 * rng.random(n))) for _ in range(2))
    gsl, gsh = (cast(2e3 * (1.0 + 0.2 * rng.random(n))) for _ in range(2))
    shared = (R, T, code_d, cast(geo), cast(np.full(n, 2e3)), inv)
    distinct = (R, T, code, glo, gsl, inv)
    kw_s = dict(ghi=shared[3], gsh=shared[4], h=80.0, h_hi=200.0, t_inf=20.0,
                **tabs)
    kw_d = dict(ghi=ghi, gsh=gsh, h=60.0, h_hi=150.0, t_inf=25.0,
                edge0=(300.0, 2.5e3, 30.0), edge1=(400.0, 2e3, 15.0), **tabs)
    calls = []
    for eps in (0.0, 0.5):
        for name, args, kw in (("shared", shared, kw_s),
                               ("distinct", distinct, kw_d)):
            calls.append((f"{name} eps={eps}",
                          lambda a=args, k=kw, e=eps: vp2_sweep_z(
                              *a, emissivity=e, **k),
                          lambda a=args, k=kw, e=eps: vp2_sweep_z_plain(
                              *a, emissivity=e, **k)))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_vp2_general_z_on_split_kernel_on_card(dtype, rel):
    """K8's general form on K8's split-line kernel against its plain
    version on odd, short and 8192-row lines, within ``rel`` of the
    output's scale; at 10x the step's dt (rows past the stiffness ratio,
    solved again in Thomas order at float32) too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    reset_launch_counts()
    calls = 0
    for i, shape in enumerate(VP2_GENERAL_SHAPES):
        for dt in ((0.02, 0.2) if shape[2] in (70, 1024) else (0.02,)):
            for name, kern, plain in _vp2_general_calls(shape, dtype, 90 + i,
                                                        dt):
                got, want = kern(), plain()
                torch.cuda.synchronize()
                calls += 1
                assert got.is_cuda and got.dtype == dtype
                assert bool(torch.isfinite(got).all())
                scale = max(1.0, float(want.abs().max()))
                assert float((got - want).abs().max()) <= rel * scale, \
                    (name, shape, dt)
    assert launch_counts() == _counts(K8=calls)


@pytest.mark.cuda
def test_vp2_general_z_takes_no_field_sized_scratch_on_card():
    """K8's general form solves each line on chip: one call raises the
    allocator's peak by its output (and a flag byte a line) alone, under
    two fields (its first version took a c'/d' scratch field)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    _, kern, _ = _vp2_general_calls((64, 96, 160), torch.float32, 73)[1]
    out = kern()                              # builds and loads the library
    torch.cuda.synchronize()
    del out
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = kern()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(dev) - base
    field = out.numel() * out.element_size()
    assert field <= rise < 2 * field, (rise, field)


# K23's plane march: tiles of 8 y rows x 128 z cells, ragged in y and z
# (nz no multiple of 4: no vector access), dimensions of 1, one plane,
# and x cut into segments.
GSTREAM_SHAPES = ((37, 45, 70), (5, 9, 131), (3, 17, 128), (1, 1, 1),
                  (7, 1, 5), (1, 13, 1), (2, 8, 256), (64, 3, 4),
                  (130, 10, 12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64],
                         ids=["f32", "bf16", "f64"])
def test_gstream_fields_on_ragged_tiles_on_card(dtype):
    """K23 against its plain version bit for bit on ragged tiles, in each
    film mode, with and without a source, on masks with voids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch.solvers import (gstream_fields,
                                                      gstream_fields_plain)
    dev = torch.device("cuda", torch.cuda.current_device())
    tabs = dict(k_spec=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
                cp_spec=apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0),
                rho=7800.0)
    tg3, sk3 = (1.5e-3, 1.4e-3, 1.6e-3), (49.0, 51.0, 47.0)
    reset_launch_counts()
    calls = 0
    for i, shape in enumerate(GSTREAM_SHAPES):
        rng = np.random.default_rng(80 + i)
        mask_np = rng.random(shape) > 0.3
        m8 = torch.from_numpy(mask_np).to(dev, torch.uint8)
        cast = (lambda a: torch.from_numpy(a).to(dev, torch.float64)
                .to(dtype))
        T = cast(np.where(mask_np, 20.0 + 1580.0 * rng.random(shape), 20.0))
        T.view(-1)[::7] = 1420.0
        h = cast(50.0 + 100.0 * rng.random(shape))
        src = cast(rng.random(shape) * 1e8)
        for kw in (dict(h_mode="const", hpar=30.0),
                   dict(h_mode="stream", h=h),
                   dict(h_mode="rad", hpar=0.5, h_conv=30.0, t_inf=20.0)):
            for s in (None, src):
                got = gstream_fields(T, m8, tg3, sk3, dt=0.02, src=s, **tabs,
                                     **kw)
                want = gstream_fields_plain(T, m8, tg3, sk3, dt=0.02, src=s,
                                            **tabs, **kw)
                calls += 1
                torch.cuda.synchronize()
                for a, b in zip([*got[0], *got[1], *got[2], got[3]],
                                [*want[0], *want[1], *want[2], want[3]]):
                    if b is None:
                        assert a is None
                        continue
                    assert a.is_cuda and a.dtype == dtype
                    assert torch.equal(a, b), (shape, kw["h_mode"])
    assert launch_counts() == _counts(K23=calls)


# K10's and K26's z lines: line counts that leave a group, a warp and a
# block part full (1024 rows: 32-row chunks; 131 and 200: 8-row chunks,
# one line a warp; 37 and 2: several lines a warp), lines of 1 and 2 rows
# and 8192-row lines past the staging (the core's strided kernel)
Z_PENCIL_SHAPES = ((5, 7, 1024), (3, 11, 131), (2, 9, 200), (4, 5, 37),
                   (3, 5, 2), (3, 3, 1), (1, 3, 8192))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_masked_z_on_split_kernel_on_card(dtype):
    """K10 on the staged split-line kernel against its plain version on
    ragged line counts, short lines and lines too long to stage, at the
    masked step's dt and ten times it (where float32 lines past
    kK10Stiff replay in Thomas order): within 8 float32 ulp of the
    output's scale, 1e-12 of it at float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    reset_launch_counts()
    calls = 0
    for i, shape in enumerate(Z_PENCIL_SHAPES):
        rng = np.random.default_rng(60 + i)
        grid = CylindricalGrid(*shape, 2.5e-4, 2.5e-4, r_inner=0.02)
        act = torch.from_numpy(rng.random(shape) > 0.2).to(dev)
        plan = build_masked_robin_plan(
            grid, Material(7800.0, 490.0, 54.0), act,
            robin_outer=RobinBC(300.0, 20.0),
            zbc=ZFaceBC(kind_bot="dirichlet", T_bot=140.0, kind_top="robin",
                        h_top=400.0), robin_inner=RobinBC(150.0, 30.0),
            h_void=80.0, dtype=dtype)
        R = torch.from_numpy(20.0 + 1480.0 * rng.random(shape)).to(dev, dtype)
        for dt in (0.02, 0.2):
            fac = float(torch.tensor(dt, dtype=dtype)
                        * (54.0 / (7800.0 * 490.0)))
            got = masked_sweep_z(R, *plan.z, fac, 20.0)
            want = masked_sweep_z_plain(R, *plan.z, fac, 20.0)
            calls += 1
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == dtype
            _split_gate(got, want)
    assert launch_counts() == _counts(K10=calls)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64],
                         ids=["f32", "bf16", "f64"])
def test_gstream_z_on_split_kernel_on_card(dtype):
    """K26 on the staged split-line kernel against its plain version on
    ragged line counts, short lines and lines too long to stage, to
    nearest and seeded: within 8 float32 ulp of the output's scale (1e-12
    of it at float64, one bfloat16 ulp at bfloat16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch.solvers import (gstream_sweep_z,
                                                      gstream_sweep_z_plain)
    dev = torch.device("cuda", torch.cuda.current_device())
    reset_launch_counts()
    calls = 0
    for i, shape in enumerate(Z_PENCIL_SHAPES):
        rng = np.random.default_rng(70 + i)
        live = rng.random(shape) > 0.2
        cast = (lambda a: torch.from_numpy(a).to(dev, torch.float64)
                .to(dtype))
        g_lo = cast(3.0 * rng.random(shape) * live)
        g_hi = cast(3.0 * rng.random(shape) * live)
        sw = cast(0.2 * rng.random(shape) * live)
        R = cast(20.0 + 1480.0 * rng.random(shape))
        for seed in (None, 12):
            got = gstream_sweep_z(R, g_lo, g_hi, sw, 20.0, rng_seed=seed,
                                  rng_offset=3)
            want = gstream_sweep_z_plain(R, g_lo, g_hi, sw, 20.0,
                                         rng_seed=seed, rng_offset=3)
            calls += 1
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == dtype
            _split_gate(got, want)
    assert launch_counts() == _counts(K26=calls)


# K24's x lines (nx, ny, nz) and, transposed to (ny, nx, nz), K25's y
# lines: 1 and 2 rows, ragged line counts, nz odd and even (bfloat16 rows
# read one or two at a time), and the strided kernel's every path at two
# blocks an SM (kept eliminated rows up to 256 rows, kept right-hand sides
# (K24) or rows formed again at 257-512, rows formed again to 1,024,
# 16-row chunks to 2,048, the reduced rows in global memory past it)
XY_LINE_SHAPES = ((1, 9, 37), (2, 5, 33), (37, 11, 45), (384, 3, 50),
                  (600, 3, 11), (1100, 2, 35), (2100, 1, 33), (8192, 1, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64],
                         ids=["f32", "bf16", "f64"])
def test_gstream_xy_on_split_kernel_on_card(dtype):
    """K24 and K25 on the strided split-line kernel against their plain
    versions on short, ragged and long lines, to nearest and seeded:
    within 8 float32 ulp of the output's scale (1e-12 of it at float64,
    one bfloat16 ulp at bfloat16); at float32 with every line of 37 rows
    or more past the replay ratio (couplings x100), bit for bit (the
    Thomas-order replay)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch.solvers import (
        gstream_sweep_y, gstream_sweep_y_plain, gstream_theta_sweep,
        gstream_theta_sweep_plain)
    dev = torch.device("cuda", torch.cuda.current_device())
    reset_launch_counts()
    k24 = k25 = 0
    for i, shape in enumerate(XY_LINE_SHAPES):
        rng = np.random.default_rng(90 + i)
        live = rng.random(shape) > 0.2
        cast = (lambda a: torch.from_numpy(a).to(dev, torch.float64)
                .to(dtype))
        # lines of 1 and 2 rows have no inner row past the ratio
        for stiff in ((False, True) if dtype == torch.float32
                      and shape[0] > 2 else (False,)):
            scale = 300.0 if stiff else 3.0
            g = [cast(scale * rng.random(shape) * live) for _ in range(6)]
            sw = cast(0.2 * rng.random(shape) * live)
            T = cast(20.0 + 1480.0 * rng.random(shape))
            src = cast(5.0 * rng.random(shape) * live)
            yt = (lambda t: t.transpose(0, 1).contiguous())
            for seed in (None, 12):
                sr = dict(rng_seed=seed)
                for s in (None, src):
                    got = gstream_theta_sweep(T, *g, sw, 1.0, 20.0,
                                              src_pre=s, rng_offset=1, **sr)
                    want = gstream_theta_sweep_plain(T, *g, sw, 1.0, 20.0,
                                                     src_pre=s, rng_offset=1,
                                                     **sr)
                    k24 += 1
                    torch.cuda.synchronize()
                    assert got.is_cuda and got.dtype == dtype
                    if stiff:
                        assert torch.equal(got, want)
                    _split_gate(got, want)
                ins = [yt(t) for t in (T, g[2], g[3], sw)]
                got = gstream_sweep_y(*ins, 20.0, rng_offset=2, **sr)
                want = gstream_sweep_y_plain(*ins, 20.0, rng_offset=2, **sr)
                k25 += 1
                torch.cuda.synchronize()
                assert got.is_cuda and got.dtype == dtype
                if stiff:
                    assert torch.equal(got, want)
                _split_gate(got, want)
    assert launch_counts() == _counts(K24=k24, K25=k25)


# K12's r lines: 2, 3 and 37 rows, the march's last rows at float64 and
# float32 (kK12MarchRows64, kK12MarchRows), one past them, 128 rows (the
# annulus), 300 and 8192 rows (the split kernel, past its registers at
# 8192), ragged line counts: (nr, nphi, nz)
K12_MARCH = int(_source_constant("kK12MarchRows", "const_sweeps.cu"))
K12_F64_MARCH = int(_source_constant("kK12MarchRows64", "const_sweeps.cu"))
K12_STIFF = _source_constant("kK12Stiff", "const_sweeps.cu")
K12_SHAPES = ((2, 45, 70), (3, 7, 33), (37, 9, 33), (K12_F64_MARCH, 5, 41),
              (K12_F64_MARCH + 1, 5, 41), (K12_MARCH, 6, 40),
              (K12_MARCH + 1, 6, 40), (128, 5, 21), (300, 5, 21),
              (8192, 2, 20))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 8 * 2.0 ** -23)],
                         ids=["f64", "f32"])
def test_k12_on_short_long_and_stiff_lines_on_card(dtype, rel):
    """K12 given the table and not (the table built in the call) alike,
    within ``rel`` of the output's scale of its plain version, bit for bit
    on lines it marches (up to kK12MarchRows rows, kK12MarchRows64 at
    float64) and on
    longer lines where the table passes kK12Stiff (Thomas order); at the
    step's dt and at 2000 s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda", torch.cuda.current_device())
    march = K12_MARCH if dtype == torch.float32 else K12_F64_MARCH
    mat = Material(7800.0, 490.0, 54.0)
    reset_launch_counts()
    calls = 0
    for i, shape in enumerate(K12_SHAPES):
        grid = CylindricalGrid(*shape, 5e-4, 5e-4, r_inner=0.02)
        rng = np.random.default_rng(120 + i)
        R = torch.from_numpy(20.0 + 1480.0 * rng.random(shape)).to(dev,
                                                                   dtype)
        for dt in (0.02, 2000.0):
            vecs = pcyl._r_coefficients(grid, mat, RobinBC(300.0, 20.0),
                                        RobinBC(150.0, 30.0), dt, dtype, dev)
            table = const_sweep_table(*vecs[:3])
            got = const_sweep_strided(R, *vecs, table)
            alone = const_sweep_strided(R, *vecs)
            want = const_sweep_strided_plain(R, *vecs)
            calls += 1
            torch.cuda.synchronize()
            assert torch.equal(table, const_sweep_table_plain(*vecs[:3]))
            assert torch.equal(got, alone)
            assert got.is_cuda and got.dtype == dtype
            assert bool(torch.isfinite(got).all())
            stiff = float(table[-1]) > K12_STIFF
            # ratios of ~2.3 at the step's dt, ~2e5 at 2000 s (n = 2: the
            # Robin rows alone, ~720)
            assert stiff == (dt > 1.0) or shape[0] == 2, (shape, dt)
            assert float((got - want).abs().max()) <= rel * float(
                want.abs().max()), (shape, dt)
            if shape[0] <= march or stiff:
                assert torch.equal(got, want), (shape, dt)
    assert launch_counts() == _counts(K12=2 * calls, K13t=2 * calls)


@pytest.mark.cuda
def test_history_and_resume_on_card(tmp_path):
    """The engine's thermal history on the card: on the plan-lite (K4, K1,
    K2), varprop (K5-K8) and bfloat16 (K1b-K4b, stochastic) routes, history
    on against off gives the same field bit for bit and the same launches,
    T_peak >= T and t_above in whole sub-steps; the spiral app interrupted
    and resumed equals its straight run bit for bit (the same card,
    kernels and sub-steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch import CartesianGrid
    from adi_thermal_fields_tpu_torch.apps import spiral_tube
    from adi_thermal_fields_tpu_torch.apps.engine import (
        make_cartesian_engine)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(67)
    grid = CartesianGrid(37, 45, 70, 5e-4)
    mask = torch.from_numpy(rng.random(grid.shape) > 0.2).to(dev)
    T0 = torch.from_numpy(300.0 + 1200.0 * rng.random(grid.shape)).to(dev)
    mat = Material(7800.0, 490.0, 54.0)
    tabs = dict(k_table=melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0),
                cp_table=apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0))
    routes = {"lite": (torch.float32, dict(robin_h=30.0)),
              "varprop": (torch.float32, dict(robin_h=30.0, emissivity=0.5,
                                              **tabs)),
              "bf16": (torch.bfloat16, dict(robin_h=30.0,
                                            stochastic_rounding=True))}
    for route, (dtype, kw) in routes.items():
        res = {}
        for hist in (None, (800.0, 500.0)):
            prep, adv = make_cartesian_engine(
                grid, mat, implementation="kernels", device=dev, dtype=dtype,
                t_inf=20.0, history_t_crit=hist, **kw)
            p = prep(mask)
            T = T0.to(dtype)
            reset_launch_counts()
            if hist is None:
                res["off"] = adv(T, p, 0.02, 4, 1.0)
            else:
                pk = T.clone()
                ta = torch.zeros((2,) + grid.shape, device=dev)
                res["on"], (pk, ta) = adv(T, p, 0.02, 4, 1.0, (pk, ta))
            res[f"launches {hist is None}"] = launch_counts()
        assert torch.equal(res["on"], res["off"]), route
        assert res["launches True"] == res["launches False"], route
        assert sum(res["launches True"].values()) > 0, route
        assert bool((pk >= res["on"]).all()) and ta.dtype == torch.float32
        steps = (ta / float(np.float32(0.02))).round()
        assert torch.equal(ta, steps * float(np.float32(0.02))), route
        assert bool((steps[1] >= steps[0]).all()) and steps.max() == 4
    argv = ["--R_out", "32", "--wall_thickness", "2", "--height", "8",
            "--z_back", "8", "--nr", "8", "--nphi", "96", "--dz", "0.5",
            "--pitch", "2", "--speed", "60", "--dt_fixed", "0.05",
            "--nframes", "2", "--out", "", "--history_t_crit", "800,500",
            "--history_out", "", "--device", "cuda"]
    ck = str(tmp_path / "ck.npz")
    run = (lambda *extra: spiral_tube.run(
        spiral_tube.build_argparser().parse_args(argv + list(extra))))
    run("--t_tot", "1", "--checkpoint", ck)
    resumed = run("--t_tot", "2", "--resume", ck)
    straight = run("--t_tot", "2")
    assert resumed["steps_run"] == 20
    assert torch.equal(resumed["T"], straight["T"])
    for k in ("peak", "t_above"):
        np.testing.assert_array_equal(resumed["history"][k],
                                      straight["history"][k])
    assert straight["history"]["t_above"].max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_function_backward_on_card_matches_plain(dtype):
    """The autograd Functions of solvers/differentiable.py on the card
    (the forward kernel, the pullback's transposed solves on K21/K22 and
    its stencil passes on K3) against the same Functions on the CPU (plain
    versions, plain thomas): each field cotangent within 32 float32 ulp of
    its scale (the forward kernel and the backward's solve, 8 ulp a pass,
    and their inputs' rounding), 1e-12 of it at float64; each scalar
    cotangent (a sum over every cell) within 1e-4 relative, 1e-9 at
    float64; the backward launches K21, K22 and K3 where it solves and
    pulls back the stencil."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from adi_thermal_fields_tpu_torch.solvers import differentiable as pd
    dev = torch.device("cuda")
    rng = np.random.default_rng(71)
    shape = (37, 45, 70)
    mask = rng.random(shape) > 0.25
    act = torch.from_numpy(rng.random(shape) > 0.3)
    f32 = dtype == torch.float32
    field_tol = (32 * torch.finfo(torch.float32).eps if f32 else 1e-12)
    scalar_tol = 1e-4 if f32 else 1e-9

    def fld(scale):
        return torch.from_numpy(scale * rng.random(shape)).to(dtype)

    def sc(v):
        return torch.tensor(v, dtype=dtype)

    mk = torch.from_numpy(mask)
    codes = [sweep_code(mk, torch.from_numpy(rng.random(shape) > 0.9),
                        ax).movedim(0, ax).contiguous() for ax in range(3)]
    lcodes = [sweep_code(mk, None, ax).movedim(0, ax).contiguous()
              for ax in range(3)]
    coeff = fld(0.3) * mk
    cols = {n: torch.from_numpy(1e5 + 1e6 * rng.random(n)).to(dtype)
            for n in set(shape)}
    kp = melt_pool_enhanced_k(54.0, 1420.0, 1470.0, 4.0)
    cpp = apparent_cp(490.0, 490.0, 2.7e5, 1420.0, 1470.0)
    spec = (kp, cpp, 50.0, 120.0, 20.0, 0.5, (300.0, 1e3, 25.0),
            (80.0, 2e3, 30.0))
    streams = (lambda: [fld(100.0), fld(40.0), fld(1e-5), fld(30.0),
                        fld(300.0)])
    inv = (1e6, 1.1e6, 0.9e6)
    cases = []
    for ax in range(3):
        cases.append((f"sweep_solve {ax}", lambda *a, ax=ax: pd.sweep_solve(
            a[0], a[7], *a[1:7], axis=ax),
            [fld(100.0), coeff, sc(0.37), sc(0.05), sc(20.0), fld(1.0) * mk,
             fld(500.0), codes[ax]], ("K21",)))
        cases.append((f"sweep_solve_lite {ax}",
                      lambda *a, ax=ax: pd.sweep_solve_lite(
                          a[0], a[5], *a[1:5], axis=ax),
                      [fld(100.0), sc(0.0031), sc(0.37), sc(0.05),
                       sc(20.0), lcodes[ax]], ("K21",)))
    mu8 = mk.to(torch.uint8)
    cases.append(("theta_rhs_diff", lambda T, c, m: pd.theta_rhs_diff(
        T, m, c, inv), [fld(1500.0), sc(1.3e-8), mu8], ("K3",)))
    code0 = sweep_code(mk, None, 0, stencil_bits=True)
    cases.append(("fused_theta_solve_lite",
                  lambda T, ce, rc, tg, dt, ti, c: pd.fused_theta_solve_lite(
                      T, c, ce, inv, rc, tg, dt, ti),
                  [fld(1500.0), sc(1.3e-8), sc(0.0031), sc(0.21), sc(0.05),
                   sc(20.0), code0], ("K21", "K3")))
    cases.append(("vp_sweep_solve r", lambda *s: pd.vp_sweep_solve(
        *s, axis=0), streams() + [cols[37], cols[37]], ("K21",)))
    cases.append(("vp_sweep_solve z", lambda *s: pd.vp_sweep_solve(
        *s, axis=2), streams() + [cols[70], cols[70]], ("K21",)))
    cases.append(("vp_cyclic_solve", pd.vp_cyclic_solve,
                  streams() + [cols[37]], ("K22",)))
    for ax, n in ((0, 37), (2, 70)):
        cases.append((f"vp2_sweep_solve {ax}",
                      lambda r, T, d, c, g, ax=ax: pd.vp2_sweep_solve(
                          r, T, c, g, g, g, g, d, spec=spec, axis=ax),
                      [fld(1500.0), fld(1500.0), sc(0.02 / 7800.0),
                       build_vp2_code(act, ax), cols[n]], ("K21",)))
    cases.append(("vp2_cyclic_solve", lambda r, T, d, c, g: pd.vp2_cyclic_solve(
        r, T, c, g, g, d, spec=(kp, cpp, 50.0, 20.0, 0.5)),
        [fld(1500.0), fld(1500.0), sc(0.02 / 7800.0),
         build_vp2_code(act, 1, periodic=True), cols[37]], ("K22",)))
    for name, fn, args, bwd in cases:
        w = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
        grads = {}
        for where in ("cpu", "cuda"):
            ins = [a.to(where).contiguous() for a in args]
            for a in ins:
                if a.is_floating_point() and a.dim() in (0, 3):
                    a.requires_grad_(True)
            req = [a for a in ins if a.requires_grad]
            out = fn(*ins)
            reset_launch_counts()
            grads[where] = torch.autograd.grad((w.to(where) * out).sum(),
                                               req)
            launched = launch_counts()
        assert all(launched[k] > 0 for k in bwd), (name, launched)
        for i, (g, p) in enumerate(zip(grads["cuda"], grads["cpu"])):
            g = g.cpu()
            scale = float(p.abs().max())
            err = float((g - p).abs().max())
            lim = (scalar_tol if p.dim() == 0 else field_tol) * scale
            assert err <= lim, (name, i, err, scale)
