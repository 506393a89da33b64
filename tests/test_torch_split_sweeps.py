"""The split-line solve of K1 and K2, and the natural-layout z solve of the
field plan, against the JAX package on the CPU.

* A plain torch model of the kernels' algorithm (csrc/sweeps.cu): each line
  cut into chunks; inside each chunk a downward and an upward elimination
  leave its first and last rows coupled only to the neighbouring chunks;
  those rows form a reduced system of 2 x chunks rows (Thomas, or PCR as
  the kernels solve it); each chunk back-substitutes.  It is held against
  the plain Thomas solve (``_solve_plain``) and JAX
  ``fused_sweep_axis0_v2`` (interpret mode) at float64 within 1e-10 K and
  at float32 within 8 float32 ulp of the output's scale, for 1, 2, 16
  and 32 chunks, with n not a multiple of the chunk and n below the chunk
  count, with void gaps and Dirichlet pins on chunk edges, and with the
  v1 pin rule.
* ``sweep_z_plain`` with coefficient, Neumann and Dirichlet fields against
  ``fused_sweep_axis0_v2`` on the (z, x, y) transpose (JAX's z solve), and
  its pin rule: ``fused_sweep_axis2_v2``'s on plan-lite inputs alone.
* ``adi_step_fused`` on the entry BCs and per-face coefficient fields
  against JAX ``adi_step_pallas(interpret=True)`` at float64 (1e-10 K).
* ``build_sweep_plan`` and ``plan_from_numpy`` give every z input in the
  natural layout.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu import CartesianGrid as JGrid
from adi_thermal_fields_tpu import Material as JMaterial
from adi_thermal_fields_tpu import build_coeff_packs as j_packs
from adi_thermal_fields_tpu.solvers import pallas_sweeps as jsw
from adi_thermal_fields_tpu.step.cartesian_pallas import (
    adi_step_pallas as j_adi_step_pallas)
from adi_thermal_fields_tpu.step.cartesian_pallas import (
    build_sweep_plan as j_build_plan)

from adi_thermal_fields_tpu_torch import (CartesianGrid, Material,
                                          adi_step_fused, build_coeff_packs,
                                          build_sweep_plan)
from adi_thermal_fields_tpu_torch.bc.faces import FACES
from adi_thermal_fields_tpu_torch.convert import plan_from_numpy
from adi_thermal_fields_tpu_torch.solvers.sweeps import (_rows_plain,
                                                         _solve_plain,
                                                         sweep_code,
                                                         sweep_z_plain)
from adi_thermal_fields_tpu_torch.solvers.thomas import thomas

torch.set_num_threads(1)

ATOL = 1e-10          # K, float64, fields up to 1500 C
ULP32 = 8             # float32 ulp of the output's scale
TG, DT, TINF, ROB = 0.21, 0.05, 20.0, 0.0031
RHO, CP, K = 7800.0, 490.0, 54.0


def _pcr(a, c, d):
    """Cyclic reduction of a unit-diagonal tridiagonal system along axis
    0, as the kernels' phase (b) runs it across threads."""
    rows = d.shape[0]
    s = 1
    while s < rows:
        def shift(t, k):
            out = torch.zeros_like(t)
            if k > 0:
                out[k:] = t[:rows - k]
            else:
                out[:rows + k] = t[-k:]
            return out
        am, cm, dm = shift(a, s), shift(c, s), shift(d, s)
        ap, cp, dp = shift(a, -s), shift(c, -s), shift(d, -s)
        inv = 1.0 / (1.0 - a * cm - c * ap)
        a, c, d = -(a * am) * inv, -(c * cp) * inv, (d - a * dm - c * dp) * inv
        s *= 2
    return d


def split_solve(a, b, c, d, chunks, reduced="thomas"):
    """The kernels' split-line solve along axis 0 (trailing axes: batch).

    The line is padded with identity rows to ``chunks`` chunks of
    ``m = max(2, ceil(n / chunks))`` rows; ``a[0]`` and ``c[n-1]`` are
    dropped, as the Thomas solve drops them.  ``reduced``: the reduced
    system by Thomas or by PCR."""
    n = d.shape[0]
    m = max(2, -(-n // chunks))
    pad = chunks * m - n
    batch = d.shape[1:]

    def padded(t, fill):
        t = torch.cat([t, torch.full((pad, *batch), fill, dtype=d.dtype)])
        return list(t.reshape(chunks, m, *batch).unbind(1))

    a, c = a.clone(), c.clone()
    a[0] = 0.0
    c[n - 1] = 0.0
    a, b, c, d = padded(a, 0.0), padded(b, 1.0), padded(c, 0.0), \
        padded(d, 0.0)
    # (a) downward: row k >= 1 -> a_k x_first + x_k + c_k x_{k+1} = d_k
    for k in range(2):
        r = 1.0 / b[k]
        a[k], c[k], d[k] = a[k] * r, c[k] * r, d[k] * r
    for k in range(2, m):
        r = 1.0 / (b[k] - a[k] * c[k - 1])
        d[k] = r * (d[k] - a[k] * d[k - 1])
        a[k] = -r * (a[k] * a[k - 1])
        c[k] = r * c[k]
    # upward: rows 1..m-2 couple to x_first and x_last; row 0 to the last
    # unknown of the chunk before and x_last
    for k in range(m - 3, 0, -1):
        d[k] = d[k] - c[k] * d[k + 1]
        a[k] = a[k] - c[k] * a[k + 1]
        c[k] = -c[k] * c[k + 1]
    if m >= 3:
        r = 1.0 / (1.0 - c[0] * a[1])
        d[0] = r * (d[0] - c[0] * d[1])
        a[0] = r * a[0]
        c[0] = -r * (c[0] * c[1])
    # (b) the reduced system: rows (first, last) of each chunk, unit diagonal
    two = (lambda f: torch.stack([f[0], f[m - 1]], 1)
           .reshape(2 * chunks, *batch))
    if reduced == "pcr":
        u = _pcr(two(a), two(c), two(d))
    else:
        u = thomas(two(a), torch.ones_like(two(d)), two(c), two(d),
                   reciprocal=True)
    u = u.reshape(chunks, 2, *batch)
    x0, xl = u[:, 0], u[:, 1]
    # (c) back substitution inside each chunk
    xs = [x0] + [d[k] - a[k] * x0 - c[k] * xl for k in range(1, m - 1)] \
        + [xl]
    return torch.stack(xs, 1).reshape(chunks * m, *batch)[:n]


def _case(n, batch, seed, dtype=torch.float64, dirichlet=True):
    rng = np.random.default_rng(seed)
    shape = (n, *batch)
    mask = rng.random(shape) > 0.25
    dirm = (rng.random(shape) > 0.85) if dirichlet else None
    T = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    coeff = np.where(mask & (rng.random(shape) > 0.5), 0.3, 0.0)
    q = rng.random(shape) * 50.0 * mask
    dval = 500.0 + 500.0 * rng.random(shape)
    return mask, dirm, T, coeff, q, dval


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _system(mask, dirm, T, coeff, q, dval, dtype, *, lite=False,
            pin_from_code=False):
    """The row system of one axis-0 sweep, as the plain K1 builds it."""
    code = sweep_code(torch.from_numpy(mask),
                      None if dirm is None else torch.from_numpy(dirm), 0)
    rhs = _t(T, dtype)
    pin = (code & 4) != 0
    if not pin_from_code and dirm is not None:
        rhs = torch.where(pin, _t(dval, dtype), rhs + DT * _t(q, dtype))
    rows = _rows_plain(rhs, code, TG, DT, TINF,
                       None if lite else _t(coeff, dtype),
                       ROB if lite else None,
                       None if pin_from_code or dirm is None else pin,
                       pin if pin_from_code else
                       (None if dirm is None else pin))
    return code, rows


def _jcode(code):
    """A port code as the JAX package's int8 code."""
    return jnp.asarray(code.numpy().view(np.int8))


def _within(got, want, dtype):
    err = float((got - want).abs().max())
    if dtype == torch.float64:
        assert err <= ATOL, err
    else:
        scale = max(1.0, float(want.abs().max()))
        assert err <= ULP32 * torch.finfo(torch.float32).eps * scale, err


@pytest.mark.parametrize("reduced", ["thomas", "pcr"])
@pytest.mark.parametrize("chunks", [1, 2, 16, 32])
@pytest.mark.parametrize("n", [27, 13, 40], ids=["n27", "n13", "n40"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_split_model_matches_thomas_and_jax(chunks, n, dtype, reduced):
    """n = 27 and 13 are no multiple of the chunk and, at 16 and 32 chunks,
    below the chunk count (chunks of identity rows)."""
    mask, dirm, T, coeff, q, dval = _case(n, (3, 5), seed=n + chunks)
    code, (a, b, c, d) = _system(mask, dirm, T, coeff, q, dval, dtype)
    got = split_solve(a, b, c, d, chunks, reduced)
    want = thomas(a, b, c, d, reciprocal=True)
    _within(got, want, dtype)
    if dtype == torch.float64:
        ref = jsw.fused_sweep_axis0_v2(
            jnp.asarray(T), _jcode(code), jnp.asarray(coeff),
            TG, DT, TINF, qflux=jnp.asarray(q), dir_val=jnp.asarray(dval),
            interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_split_model_void_gaps_and_pins_on_chunk_edges(dtype):
    """32 rows in 4 chunks of 8: void cells and Dirichlet pins exactly on
    the first and last rows of chunks, plan-lite and field."""
    n, m = 32, 8
    mask, _, T, coeff, q, dval = _case(n, (4, 6), seed=41)
    mask[:] = True
    for edge in (m - 1, m, 3 * m - 1):              # void gap on an edge
        mask[edge, :2] = False
    dirm = np.zeros_like(mask)
    for row in (0, 2 * m, 2 * m + m - 1, 3 * m, n - 1):
        dirm[row, 1:4] = True                        # pins on edges
    for lite in (True, False):
        code, (a, b, c, d) = _system(mask, dirm, T, coeff, q, dval, dtype,
                                     lite=lite)
        got = split_solve(a, b, c, d, 4, "pcr")
        _within(got, thomas(a, b, c, d, reciprocal=True), dtype)
        pin = (code & 4) != 0
        want = _solve_plain(
            torch.where(pin, _t(dval, dtype), _t(T, dtype) + DT * _t(q,
                                                                     dtype)),
            code, 0, TG, DT, TINF, None if lite else _t(coeff, dtype),
            ROB if lite else None, pin)
        _within(got, want, dtype)
        if dtype == torch.float64:
            ref = jsw.fused_sweep_axis0_v2(
                jnp.asarray(T), _jcode(code),
                None if lite else jnp.asarray(coeff), TG, DT, TINF,
                qflux=jnp.asarray(q), dir_val=jnp.asarray(dval),
                rob_c=ROB if lite else None, interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("chunks", [2, 16])
def test_split_model_pin_from_code(chunks):
    """The v1 pin rule (every bit-4 row an identity row, the rhs kept
    without dir_val) against JAX ``fused_sweep_axis0``."""
    mask, dirm, T, coeff, q, dval = _case(21, (4, 3), seed=chunks)
    code, (a, b, c, d) = _system(mask, dirm, T, coeff, q, dval,
                                 torch.float64, pin_from_code=True)
    got = split_solve(a, b, c, d, chunks)
    ref = jsw.fused_sweep_axis0(jnp.asarray(T), _jcode(code),
                                jnp.asarray(coeff), TG, DT, TINF,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("fields", ["coeff", "coeff+neumann+dirichlet",
                                    "lite+neumann"])
def test_sweep_z_plain_fields_match_jax_transpose(fields):
    """K2's plain version with K1's inputs, natural layout, against JAX's
    field-plan z solve: fused_sweep_axis0_v2 on the (z, x, y) transpose."""
    shape = (7, 6, 11)
    rng = np.random.default_rng(23)
    mask = rng.random(shape) > 0.25
    dirm = (rng.random(shape) > 0.85) if "dirichlet" in fields else None
    T = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    coeff = np.where(mask & (rng.random(shape) > 0.5), 0.3, 0.0)
    q = rng.random(shape) * 50.0 * mask
    dval = 500.0 + 500.0 * rng.random(shape)
    lite = fields.startswith("lite")
    kw = {} if lite else dict(coeff=_t(coeff))
    jkw = {}
    if "neumann" in fields:
        kw["qflux"] = _t(q)
        jkw["qflux"] = jnp.asarray(q.transpose(2, 0, 1))
    if dirm is not None:
        kw["dir_val"] = _t(dval)
        jkw["dir_val"] = jnp.asarray(dval.transpose(2, 0, 1))
    code = sweep_code(torch.from_numpy(mask),
                      None if dirm is None else torch.from_numpy(dirm), 2)
    got = sweep_z_plain(_t(T), code.movedim(0, 2).contiguous(), TG, DT, TINF,
                        ROB if lite else None, **kw)
    ref = jsw.fused_sweep_axis0_v2(
        jnp.asarray(T.transpose(2, 0, 1)), _jcode(code),
        None if lite else jnp.asarray(coeff.transpose(2, 0, 1)), TG, DT,
        TINF, rob_c=ROB if lite else None, interpret=True, **jkw)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(1, 2, 0), rtol=0,
                               atol=ATOL)


def _pinned_codes(mask, seed):
    """Axis-2 codes (natural layout) with bit 4 set on random rows that
    keep their coupling and in-mask bits: the rows on which the two JAX
    pin rules differ."""
    code = sweep_code(torch.from_numpy(mask), None, 2).movedim(0, 2)
    rng = np.random.default_rng(seed)
    extra = torch.from_numpy(rng.random(mask.shape) > 0.8)
    return code | (extra.to(torch.uint8) * 4), code.contiguous()


@pytest.mark.parametrize("inputs", ["lite", "lite+neumann"])
def test_sweep_z_plain_pin_rule_matches_jax(inputs):
    """K2's pin rule on codes whose bit-4 rows keep their other bits: given
    plan-lite inputs alone it pins every bit-4 row, as JAX
    ``fused_sweep_axis2_v2`` (has_pin=True); with a field (here Neumann)
    it pins only with ``dir_val``, as ``fused_sweep_axis0_v2`` on the
    (z, x, y) transpose."""
    shape = (6, 5, 13)
    rng = np.random.default_rng(41)
    mask = rng.random(shape) > 0.2
    T = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    q = rng.random(shape) * 50.0 * mask
    code, plain_code = _pinned_codes(mask, 43)
    code = code.contiguous()
    jcode = _jcode(code.permute(2, 0, 1).contiguous())
    if inputs == "lite":
        got = sweep_z_plain(_t(T), code, TG, DT, TINF, ROB)
        ref = jsw.fused_sweep_axis2_v2(jnp.asarray(T), jcode, TG, DT, TINF,
                                       ROB, interpret=True)
        ref = np.asarray(ref)
        # the rule changes the answer here
        assert not np.allclose(
            ref, sweep_z_plain(_t(T), plain_code, TG, DT, TINF, ROB).numpy())
    else:
        got = sweep_z_plain(_t(T), code, TG, DT, TINF, ROB, qflux=_t(q))
        ref = jsw.fused_sweep_axis0_v2(
            jnp.asarray(T.transpose(2, 0, 1)), jcode, None, TG, DT, TINF,
            rob_c=ROB, qflux=jnp.asarray(q.transpose(2, 0, 1)),
            interpret=True)
        ref = np.asarray(ref).transpose(1, 2, 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def _entry_mask(n):
    """A plate, void above, and a deposited block on it (__graft_entry__'s
    configuration cut to n^3)."""
    mask = np.ones((n, n, n), bool)
    top = 3 * n // 4
    mask[:, :, top:] = False
    mask[n // 3:2 * n // 3, n // 3:2 * n // 3, top:top + 2] = True
    return mask


BCS = {
    "entry": dict(robin_h=200.0, neumann={"z+": 5e5}),
    "per_face": dict(robin_h={f: 50.0 + 30.0 * i for i, f in
                              enumerate(FACES)}, neumann={"z+": 5e5}),
}


def _plans(bcs, mask, shape, dz=None):
    jg = JGrid(*shape, 1e-3, dz=dz)
    pg = CartesianGrid(*shape, 1e-3, dz=dz)
    jp = j_packs(jnp.asarray(mask), jg, JMaterial(RHO, CP, K),
                 dtype=jnp.float64, **BCS[bcs])
    pp = build_coeff_packs(torch.from_numpy(mask), pg, Material(RHO, CP, K),
                           dtype=torch.float64, **BCS[bcs])
    return (jg, j_build_plan(jnp.asarray(mask), jp)), \
        (pg, build_sweep_plan(torch.from_numpy(mask), pp))


@pytest.mark.parametrize("bcs", ["entry", "per_face"])
def test_field_plan_natural_z_matches_jax_step(bcs):
    """The field and entry plans end on K2 in the natural layout (no
    permuted state); JAX solves z on the (z, x, y) transpose."""
    n = 14
    mask = _entry_mask(n)
    rng = np.random.default_rng(31)
    T = np.where(mask, 20.0 + 1480.0 * rng.random(mask.shape), 20.0)
    (jg, jplan), (pg, pplan) = _plans(bcs, mask, mask.shape, dz=0.8e-3)
    ref = np.asarray(jnp.asarray(T))
    got = torch.from_numpy(T)
    for _ in range(2):
        ref = j_adi_step_pallas(jnp.asarray(ref), jplan, jg,
                                JMaterial(RHO, CP, K), dt=0.05, theta=0.5,
                                t_inf=20.0, interpret=True)
        got = adi_step_fused(got, pplan, pg, Material(RHO, CP, K), dt=0.05,
                             theta=0.5, t_inf=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("bcs", ["entry", "per_face"])
def test_plans_hold_every_z_input_natural(bcs):
    """build_sweep_plan and plan_from_numpy (from JAX's (z, x, y) z
    inputs) agree bit for bit, every input in the natural layout."""
    mask = _entry_mask(10)[:, :9, :8].copy()          # three extents
    (_, jplan), (_, native) = _plans(bcs, mask, mask.shape)
    conv = plan_from_numpy(
        np.asarray(jplan.mask), [np.asarray(c) for c in jplan.codes],
        [np.asarray(c) for c in jplan.coeffs],
        [np.asarray(c) for c in jplan.qfluxes], None, None, device="cpu")
    for plan in (native, conv):
        for t in (*plan.codes, *plan.coeffs, *plan.qfluxes):
            assert tuple(t.shape) == mask.shape and t.is_contiguous()
    for a, b in zip(conv.codes, native.codes):
        assert torch.equal(a, b)
    for name in ("coeffs", "qfluxes"):
        for a, b in zip(getattr(conv, name), getattr(native, name)):
            assert torch.equal(a, b)
    assert native.codes[2].equal(
        sweep_code(torch.from_numpy(mask), None, 2).movedim(0, 2))
