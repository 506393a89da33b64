"""The periodic split solve of K11 and K16 on their own rows, against the
JAX package on the CPU.

K11 (the masked-Robin phi sweep) and K16 (the tier-2 variable-property phi
sweep) run on the periodic split-line kernel of csrc/split_cyclic.cuh:
each line cut into chunks of m rows; the wrap taken out by Sherman-Morrison
in ``cyclic_thomas``'s gauge (gamma = -b_0, beta = a_0, alpha = c_{n-1});
the second right-hand side u = gamma e_0 + alpha e_{n-1} entering only the
reduced system, as couplings to two virtual unknowns that are 0 in the
solve for y and 1 in that for z (row 0's a = -gamma, row n-1's c =
-alpha, the rows past n-1 of its chunk passing the last unknown on); the
chunks' first and last rows solved for both columns by cyclic reduction;
each chunk back-substituted, z with a zero right-hand side inside it;
x = y - fact z; divisions, not reciprocal multiplies.  A block (one b1, 32
adjacent b2) with a row past |a| + |c| > ratio (b - |a| - |c|) (each row
former's ratio, ``kK11Stiff`` and ``kK16Stiff`` in its source) is solved in
Thomas order instead:
``cyclic_thomas`` bit for bit.
``cyclic_split_solve`` models that with one tensor op per operation, fed
with the rows as the kernels form them:

* K11: ``masked_cyclic_phi_plain``'s rows (no state from row to row);
* ``k16_rows``: k(T) once a row, a chunk's k at rows row0 - 1 and row0 + m
  taken mod n (the wrap faces harm(k_{n-1}, k_0)), each face harm(k_{i-1},
  k_i) in that order whichever row forms it: the plain version's rows bit
  for bit.

The model is held against JAX ``fused_masked_cyclic_axis1`` and
``fused_vp2_cyclic_axis1`` in interpret mode (the JAX vp2 kernel takes
float32 only; at float64 the JAX streams ``vp2_cyclic_streams_xla`` +
``fused_vp_fields_cyclic_axis1``) and against the plain versions: within
1e-10 K at float64 and 8 float32 ulp of the output's scale at float32.
1, 2, 4, 16 and 32 chunks; n = 2, 3, n no multiple of the chunk and below
the chunk count; void breaks on chunk edges and at the wrap (rows 0 and
n-1 void or uncoupled); a code-0 ring (its rhs passes through bit for
bit); radiation on and off; and a full disk's stiff second ring (fac*geo
~ 520 at float32), where the split solve alone parts from the Thomas
order by more than the gate and the replay holds it to the plain version
bit for bit.  There the JAX float32 kernels, which round their rows in
another order (b = 1 + fac*(al + ch + sink), reciprocal multiplies), part
from the port's plain versions too: the stiff case is held to the plain
version at float32 and to JAX at float64 (~50 s on one worker).
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers import pallas_vp2 as jvp2
from adi_thermal_fields_tpu.solvers.pallas_fields import (
    fused_masked_cyclic_axis1)
from adi_thermal_fields_tpu.solvers.pallas_vpfields import (
    fused_vp_fields_cyclic_axis1)
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

import adi_thermal_fields_tpu_torch
from adi_thermal_fields_tpu_torch.convert import property_table_from_jax
from adi_thermal_fields_tpu_torch.solvers import (cyclic_thomas,
                                                  masked_cyclic_phi_plain,
                                                  vp2_cyclic_phi_plain)
from adi_thermal_fields_tpu_torch.solvers.varprop import eval_spec, harm
from adi_thermal_fields_tpu_torch.solvers.vp2 import _rad, _scaled_rows

torch.set_num_threads(1)

ATOL = 1e-10          # K, float64
ULP32 = 8             # float32 ulp of the output's scale
FAC, AMB = 0.37, 20.0                      # K11's scalars
RHO, TINF, HVOID = 7800.0, 20.0, 80.0      # K16's
JK = jcv.melt_pool_enhanced_k(54.0, 1420.0, 1470.0, enhancement=4.0)
JCP = jcv.apparent_cp(490.0, 520.0, 2.7e5, 1420.0, 1470.0)
PK, PCP = property_table_from_jax(JK), property_table_from_jax(JCP)
SPEC = dict(k_spec=(tuple(JK.points), tuple(JK.values)),
            cp_spec=(tuple(JCP.points), tuple(JCP.values)))
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])
# 1/(r dphi)^2 of rings 0-3 of a full disk, 0.5 mm cells, 203 in phi: the
# stiff cases' metric (on shorter lines)
DISK_GEO = 1.0 / ((np.arange(4) + 0.5) * 5e-4 * 2 * np.pi / 203) ** 2


def _kernel_ratio(source, name):
    """A stiffness ratio as the kernels' source sets it (``constexpr double
    name = ...;`` in csrc/``source``)."""
    path = Path(adi_thermal_fields_tpu_torch.__file__).parent / "csrc" / source
    hit = re.search(rf"constexpr double {name} = ([^;]+);", path.read_text())
    return float(hit.group(1))


K11_STIFF = _kernel_ratio("masked.cu", "kK11Stiff")
K16_STIFF = _kernel_ratio("vp2_cyl.cu", "kK16Stiff")


# ---------------------------------------------------------------------------
# the periodic split solve
# ---------------------------------------------------------------------------

def _pcr(a, c, ds):
    """Cyclic reduction of a unit-diagonal tridiagonal system along axis 0
    for several right-hand sides, dividing (the kernels' kDiv)."""
    rows = a.shape[0]

    def shift(t, k):
        out = torch.zeros_like(t)
        if k > 0:
            out[k:] = t[:rows - k]
        else:
            out[:rows + k] = t[-k:]
        return out

    s = 1
    while s < rows:
        am, cm, ap, cp = shift(a, s), shift(c, s), shift(a, -s), shift(c, -s)
        den = 1.0 - a * cm - c * ap
        ds = [(d - a * shift(d, s) - c * shift(d, -s)) / den for d in ds]
        a, c = -(a * am) / den, -(c * cp) / den
        s *= 2
    return ds


def split_cyclic(a, b, c, d, m):
    """The split solve of periodic rows along axis 0 (trailing axes:
    batch) in chunks of ``m`` rows: row 0's ``a`` couples to x[n-1] and
    row n-1's ``c`` to x[0]."""
    n = d.shape[0]
    batch = d.shape[1:]
    beta, alpha, gamma = a[0], c[n - 1], -b[0]
    a, b, c = a.clone(), b.clone(), c.clone()
    b[0] = b[0] - gamma
    b[n - 1] = b[n - 1] - alpha * beta / gamma
    a[0] = -gamma                    # couplings to the virtual unknowns
    c[n - 1] = -alpha
    chunks = -(-n // m)
    pad = chunks * m - n

    def padded(t, fill):
        t = torch.cat([t, torch.full((pad, *batch), fill, dtype=d.dtype)])
        return list(t.reshape(chunks, m, *batch).unbind(1))

    # rows past n-1 pass the chunk's last unknown on: x_k - x_{k+1} = 0
    a, b, c, d = padded(a, 0.0), padded(b, 1.0), padded(c, -1.0), \
        padded(d, 0.0)
    # (a) downward: row k >= 1 -> a_k x_first + x_k + c_k x_{k+1} = d_k
    for k in range(min(2, m)):
        a[k], c[k], d[k] = a[k] / b[k], c[k] / b[k], d[k] / b[k]
    for k in range(2, m):
        den = b[k] - a[k] * c[k - 1]
        d[k] = (d[k] - a[k] * d[k - 1]) / den
        a[k] = -(a[k] * a[k - 1]) / den
        c[k] = c[k] / den
    # upward: rows 1..m-2 couple to x_first and x_last; row 0 to the last
    # unknown of the chunk before and x_last
    for k in range(m - 3, 0, -1):
        d[k] = d[k] - c[k] * d[k + 1]
        a[k] = a[k] - c[k] * a[k + 1]
        c[k] = -c[k] * c[k + 1]
    if m >= 3:
        den = 1.0 - c[0] * a[1]
        d[0] = (d[0] - c[0] * d[1]) / den
        a[0] = a[0] / den
        c[0] = -(c[0] * c[1]) / den
    # (b) the reduced system, z's right-hand side from the virtual couplings
    two = (lambda f: torch.stack([f[0], f[m - 1]], 1)
           .reshape(2 * chunks, *batch))
    A, C, D = two(a), two(c), two(d)
    Dz = torch.zeros_like(D)
    Dz[0], A[0] = -A[0], 0.0
    last = 2 * chunks - 1
    Dz[last], C[last] = -C[last], 0.0
    Y, Z = (u.reshape(chunks, 2, *batch) for u in _pcr(A, C, [D, Dz]))
    # (c) back substitution: y from d, z with a zero right-hand side
    inner = range(1, m - 1)
    y = torch.stack([Y[:, 0]] + [d[k] - a[k] * Y[:, 0] - c[k] * Y[:, 1]
                                 for k in inner] + [Y[:, 1]], 1)
    z = torch.stack([Z[:, 0]] + [-a[k] * Z[:, 0] - c[k] * Z[:, 1]
                                 for k in inner] + [Z[:, 1]], 1)
    y = y.reshape(chunks * m, *batch)[:n]
    z = z.reshape(chunks * m, *batch)[:n]
    fact = ((y[0] + beta * y[n - 1] / gamma)
            / (1.0 + z[0] + beta * z[n - 1] / gamma))
    return y - fact[None] * z


def stiff_blocks(a, b, c, stiff):
    """(B1, B2): the lines whose block (one b1, 32 adjacent b2) has a row
    past the stiffness ratio ``stiff``."""
    off = a.abs() + c.abs()
    line = (off > stiff * (b - off)).any(0)
    B1, B2 = line.shape
    groups = -(-B2 // 32)
    blk = torch.nn.functional.pad(line, (0, groups * 32 - B2))
    blk = blk.reshape(B1, groups, 32).any(2, keepdim=True)
    return blk.expand(B1, groups, 32).reshape(B1, groups * 32)[:, :B2]


def cyclic_split_solve(a, b, c, d, m, stiff):
    """The kernels' solve along axis 0 of (n, B1, B2) rows: the split
    solve, or ``cyclic_thomas`` for the blocks past the stiffness ratio."""
    return torch.where(stiff_blocks(a, b, c, stiff)[None],
                       cyclic_thomas(a, b, c, d), split_cyclic(a, b, c, d, m))


def _chunk(n, chunks):
    """Rows a chunk when a line of n rows is cut into ``chunks`` (at least
    2: the kernels' chunks have a first and a last row)."""
    return max(2, -(-n // chunks))


def _within(got, want, dtype, what):
    err = float((got - want).abs().max())
    if dtype == torch.float64:
        assert err <= ATOL, (what, err)
    else:
        scale = max(1.0, float(want.abs().max()))
        ulps = err / (torch.finfo(torch.float32).eps * scale)
        assert ulps <= ULP32, (what, err, ulps)


def _stiff_ring(a, b, c, d, chunks, got, plain, dtype, stiff):
    """The stiff case: ring 1 is replayed in Thomas order (bit for bit the
    plain version) where the split solve alone parts from it by more than
    the float32 gate."""
    n = d.shape[0]
    assert bool(stiff_blocks(a, b, c, stiff)[1].all())
    assert torch.equal(got[1], plain[1])
    if dtype == torch.float32:
        split = split_cyclic(a, b, c, d, _chunk(n, chunks)).movedim(0, 1)
        err = float((split - plain).abs().max())
        assert err > ULP32 * torch.finfo(dtype).eps * float(plain.abs().max())


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def test_harm_is_symmetric_bit_for_bit():
    """A face's harm(k_{i-1}, k_i) has the same bits whichever of its two
    rows forms it, and with its arguments swapped (2ab and a + b round
    alike either way)."""
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.float64):
        ka = _t(54.0 * (0.5 + 4.0 * rng.random(4096)), dtype)
        kb = _t(54.0 * (0.5 + 4.0 * rng.random(4096)), dtype)
        ka[:8] = 0.0
        assert torch.equal(harm(ka, kb), harm(kb, ka))


def test_split_model_stiff_switch():
    """The stiffness switch: a ring with a row past the ratio takes the
    Thomas order (bit for bit cyclic_thomas), a mild ring the split
    solve; the switch is per block of 32 lines."""
    rng = np.random.default_rng(5)
    n, shape = 24, (24, 2, 40)
    f = np.ones(shape)
    stiff = 16.0
    f[:, 0, :] = 0.2 * stiff              # mild: 2F = 0.4 stiff
    f[5, 1, 33] = stiff                   # one stiff row, second block
    a, c = _t(-f), _t(-f)
    b = 1.0 - (a + c)
    d = _t(1000.0 * rng.random(shape))
    blk = stiff_blocks(a, b, c, stiff)
    assert not bool(blk[0].any()) and not bool(blk[1, :32].any())
    assert bool(blk[1, 32:].all())
    got = cyclic_split_solve(a, b, c, d, 8, stiff)
    assert torch.equal(got[:, 1, 32:], cyclic_thomas(a, b, c, d)[:, 1, 32:])
    _within(got, cyclic_thomas(a, b, c, d), torch.float64, "switch")
    assert n == got.shape[0]


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

def k11_case(name):
    """(rhs, code, sink, srhs, geo) of a masked phi sweep on (B1, n, B2)
    and its fac: random voids and pins (identity rows; couplings across
    live neighbours, the wrap included), or breaks on the edges of 8-row
    chunks and at the wrap, or a disk whose second ring is stiff."""
    n, edges, stiff = K11_CASES[name]
    rng = np.random.default_rng(n + 7 * edges)
    shape = (4, n, 6)
    active = rng.random(shape) > 0.25
    pin = (rng.random(shape) > 0.93) & active
    if edges:
        active[:, :, :] = True
        pin[:] = False
        for row in (7, 8, 23, 24):             # breaks on chunk edges
            active[0:2, row, 0:3] = False
        active[1, 0, :] = False                # the wrap: row 0 void
        active[2, n - 1, :] = False            # row n-1 void
    live = active & ~pin
    lowm = live & np.roll(live, 1, 1)
    highm = live & np.roll(live, -1, 1)
    if edges:                                  # the wrap uncoupled
        lowm[3, 0, :3] = False
        highm[3, n - 1, :3] = False
    code = (lowm.astype(np.uint8) | (highm.astype(np.uint8) << 1)
            | (pin.astype(np.uint8) << 2) | (active.astype(np.uint8) << 3))
    sink = np.where(live & (rng.random(shape) > 0.5), rng.random(shape), 0.0)
    srhs = np.where(pin, 77.0, np.where(live, sink * 20.0, 0.0))
    rhs = 20.0 + 1480.0 * rng.random(shape)
    geo = 0.5 + rng.random((shape[0], shape[2]))
    fac = FAC
    if stiff:                   # rings 0-3 of a 203-cell disk, 0.5 mm
        geo = np.broadcast_to(DISK_GEO, (shape[2], shape[0])).T.copy()
        geo[0] = 0.0                           # the axis ring
        fac = 0.02 * 54.0 / (7800.0 * 490.0)   # fac*geo ~ 520 on ring 1
    return (rhs, code, sink, srhs, geo), fac


# (rows, breaks on 8-row chunk edges and at the wrap, stiff disk)
K11_CASES = {"n2": (2, False, False), "n3": (3, False, False),
             "n27": (27, False, False), "edges32": (32, True, False),
             "stiff-disk": (64, False, True)}


@functools.lru_cache(maxsize=None)
def _k11_ref(name, dtype):
    """A K11 case at ``dtype`` and its JAX solution (one interpret-mode
    call for every chunk count, made when first asked for)."""
    (rhs, code, sink, srhs, geo), fac = k11_case(name)
    f = np.float64 if dtype == torch.float64 else np.float32
    fac = float(f(fac))

    @functools.cache
    def ref():
        return _t(np.asarray(fused_masked_cyclic_axis1(
            jnp.asarray(rhs.astype(f)), jnp.asarray(code.view(np.int8)),
            jnp.asarray(sink.astype(f)), jnp.asarray(srhs.astype(f)),
            jnp.asarray(geo.astype(f)), fac, AMB, interpret=True)))

    ins = tuple(_t(v, dtype) for v in (rhs, sink, srhs, geo))
    return ins, _t(code), fac, ref


@DTYPES
@pytest.mark.parametrize("name", list(K11_CASES))
@CHUNKS
def test_k11_split_model_matches_jax(chunks, name, dtype):
    """K11's rows, the periodic split solve (the Thomas order on stiff
    blocks), against JAX fused_masked_cyclic_axis1 and the plain version;
    the stiff disk at float32 against the plain version bit for bit."""
    (rhs, sink, srhs, geo), code, fac, ref = _k11_ref(name, dtype)
    n = rhs.shape[1]
    g3 = geo[:, None, :]
    a = torch.where((code & 1) != 0, -fac * g3, 0.0)
    c = torch.where((code & 2) != 0, -fac * g3, 0.0)
    b = 1.0 - (a + c) + fac * sink
    d = torch.where((code & 4) != 0, srhs,
                    torch.where((code & 8) != 0, rhs + fac * srhs, AMB))
    mv = (lambda t: t.movedim(1, 0))
    got = cyclic_split_solve(mv(a), mv(b), mv(c), mv(d), _chunk(n, chunks),
                             K11_STIFF).movedim(0, 1)
    plain = masked_cyclic_phi_plain(rhs, code, sink, srhs, geo, fac, AMB)
    _within(got, plain, dtype, "plain")
    if name == "stiff-disk":
        _stiff_ring(mv(a), mv(b), mv(c), mv(d), chunks, got, plain, dtype,
                    K11_STIFF)
        if dtype == torch.float32:
            return
    _within(got, ref(), dtype, "jax")


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------

def k16_rows(rhs, T, code, geo, gs, inv_dtor, eps, m):
    """K16's rows along axis 0 of (n, B1, B2) as ``Vp2CyclicRows::each``
    forms them chunk by chunk: k(T) once a row, the chunk's first face
    harm(k(T[row0 - 1 mod n]), k(T[row0])), each row's hi face
    harm(k_i, k(T[i + 1 mod n])) carried on as the next row's lo face."""
    n = T.shape[0]
    kv = (lambda t: eval_spec(PK, t))
    bit = (lambda cd, b: ((cd & b) != 0).to(T.dtype))
    g, s = geo[:, None], gs[:, None]
    a, b, c, d = (torch.empty_like(T) for _ in range(4))
    for row0 in range(0, n, m):
        k_cur = kv(T[row0])
        h_lo = harm(kv(T[(row0 - 1) % n]), k_cur)
        for i in range(row0, min(row0 + m, n)):
            k_nxt = kv(T[(i + 1) % n])
            h_hi = harm(k_cur, k_nxt)
            cd = code[i]
            f_lo = torch.where((cd & 16) != 0, h_lo, 0.0)
            f_hi = torch.where((cd & 1) != 0, h_hi, 0.0)
            hr = _rad(T[i], eps, TINF) if eps > 0.0 else 0.0
            sink = (bit(cd, 2) + bit(cd, 4)) * s * (HVOID + hr)
            al, ch = g * f_lo, g * f_hi
            coup = al + ch + sink
            w = torch.where(coup > 0.0, eval_spec(PCP, T[i]) * inv_dtor, 1.0)
            a[i], b[i], c[i] = -al, w + coup, -ch
            d[i] = rhs[i] * w + sink * TINF
            k_cur, h_lo = k_nxt, h_hi
    return a, b, c, d


def k16_case(name):
    """(T, rhs, mask, geo, gs, eps) on (B1, n, B2): T across 1000-1600 C
    with cells on the solidus and liquidus, a ring with no void, voids on
    8-row chunk edges and at the wrap, or a disk whose second ring is
    stiff (T below the liquidus there: g k / (cp rho / dt) ~ 530)."""
    n, eps, edges, stiff = K16_CASES[name]
    rng = np.random.default_rng(11 + n)
    shape = (4, n, 6)
    T = 1000.0 + (420.0 if stiff else 600.0) * rng.random(shape)
    T.reshape(-1)[::7] = 1420.0
    if not stiff:
        T.reshape(-1)[3::11] = 1470.0
    rhs = 1000.0 + 600.0 * rng.random(shape)
    mask = rng.random(shape) > 0.2
    mask[1] = True
    if edges:
        mask[2:] = True
        for row in (7, 8, 23, 24):
            mask[2, row, :3] = False
        mask[3, 0, :2] = False
        mask[3, n - 1, 2:4] = False
    geo = (0.5 + rng.random(shape[0])) * 3e5
    gs = (0.1 + rng.random(shape[0])) * 2e3
    if stiff:                   # rings 0-3 of a 203-cell disk, 0.5 mm
        geo, gs = DISK_GEO, np.sqrt(DISK_GEO)
    return T, rhs, mask, geo, gs, eps


K16_CASES = {"n2-rad": (2, 0.5, False, False),
             "n3-conv": (3, 0.0, False, False),
             "n27-rad": (27, 0.5, False, False),
             "edges32-conv": (32, 0.0, True, False),
             "stiff-disk-rad": (64, 0.5, False, True)}


@functools.lru_cache(maxsize=None)
def _k16_ref(name, dtype):
    """A K16 case's inputs at ``dtype`` and its JAX solution (made when
    first asked for)."""
    T, rhs, mask, geo, gs, eps = k16_case(name)
    f = np.float32 if dtype == torch.float32 else np.float64
    dtor = f(f(0.02) / f(RHO))
    jcode = jvp2.build_vp2_code(jnp.asarray(mask), 1, periodic=True)
    jcode = jcode.at[0].set(jnp.int8(0))       # a code-0 ring
    b2 = (lambda v: jnp.asarray(np.broadcast_to(
        v.astype(f)[:, None], (T.shape[0], T.shape[2]))))
    kw = dict(h_void=HVOID, tinf_void=TINF, emissivity=eps)

    @functools.cache
    def ref():
        if dtype == torch.float32:
            out = jvp2.fused_vp2_cyclic_axis1(
                jnp.asarray(rhs.astype(f)), jnp.asarray(T.astype(f)), jcode,
                b2(geo), b2(gs), jnp.float32(dtor), interpret=True, **SPEC,
                **kw)
        else:
            flo, dw, sink, srhs = jvp2.vp2_cyclic_streams_xla(
                jnp.asarray(T), jcode, b2(gs), dtor, **SPEC, **kw)
            out = fused_vp_fields_cyclic_axis1(jnp.asarray(rhs), flo, None,
                                               dw, sink, srhs, b2(geo),
                                               interpret=True)
        return _t(np.asarray(out))

    inv = float(f(1.0) / dtor) if dtype == torch.float32 else 1.0 / dtor
    code = _t(np.asarray(jcode).view(np.uint8))
    return ((_t(rhs, dtype), _t(T, dtype), code, _t(geo, dtype),
             _t(gs, dtype), inv, eps), ref)


@DTYPES
@pytest.mark.parametrize("name", list(K16_CASES))
@CHUNKS
def test_k16_split_model_matches_jax(chunks, name, dtype):
    """K16's rows chunk by chunk (the k of rows row0 - 1 and row0 + m mod
    n; bit for bit the plain version's rows), the periodic split solve (the
    Thomas order on stiff blocks), against JAX fused_vp2_cyclic_axis1 and
    the plain version; the code-0 ring passes its rhs through bit for bit;
    the stiff disk at float32 against the plain version bit for bit."""
    (rhs, T, code, geo, gs, inv, eps), ref = _k16_ref(name, dtype)
    n = T.shape[1]
    m = _chunk(n, chunks)
    mv = (lambda t: t.movedim(1, 0))
    rows = k16_rows(mv(rhs), mv(T), mv(code), geo, gs, inv, eps, m)
    # the plain version's rows (solvers/vp2.py vp2_cyclic_phi_plain)
    bit = (lambda b: ((code & b) != 0).to(T.dtype))
    g3, s3 = geo[:, None, None], gs[:, None, None]
    k = eval_spec(PK, T)
    flo = harm(torch.roll(k, 1, 1), k) * bit(16)
    fhi = harm(k, torch.roll(k, -1, 1)) * bit(1)
    hr = _rad(T, eps, TINF) if eps > 0.0 else 0.0
    sink = (bit(2) + bit(4)) * s3 * (HVOID + hr)
    want_rows = _scaled_rows(rhs, T, PCP, inv, g3 * flo, g3 * fhi, sink,
                             sink * TINF)
    for got_r, want_r in zip(rows, want_rows):
        assert torch.equal(got_r, mv(want_r))
    got = cyclic_split_solve(*rows, m, K16_STIFF).movedim(0, 1)
    plain = vp2_cyclic_phi_plain(rhs, T, code, geo, gs, inv, k_spec=PK,
                                 cp_spec=PCP, h_void=HVOID, tinf_void=TINF,
                                 emissivity=eps)
    assert torch.equal(got[0], rhs[0])          # the code-0 ring
    _within(got, plain, dtype, "plain")
    if name.startswith("stiff"):
        _stiff_ring(*rows, chunks, got, plain, dtype, K16_STIFF)
        if dtype == torch.float32:
            return
    _within(got, ref(), dtype, "jax")
