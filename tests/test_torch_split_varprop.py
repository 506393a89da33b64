"""The split-line solve of K7 and K8 on their own rows, against the JAX
package on the CPU.

K7 (the varprop y sweep) and K8 (the tier-2 z sweep) run on the split-line
core of csrc/split_line.cuh: each line cut into chunks of m rows, each
chunk's rows formed and eliminated in registers (a downward and an upward
pass), the chunks' first and last rows solved as a reduced system by
cyclic reduction, then each chunk back-substituted.  A plain torch model of
that solve (``split_solve``: generic a, b, c, d rows, the reduced system by
PCR) is fed with the rows as the kernels form them, chunk by chunk:

* ``k7_rows``: ``atf::vp_row_coeffs`` with f_lo = fc[row0] read once a
  chunk and f_hi = fc[i+1] carried on to the next row;
* ``k8_rows``: ``vp2_chunk``, k(T) evaluated once a row and a chunk's k at
  rows row0 - 1 and row0 + m taken from the neighbouring chunks (the
  kernel's lane shuffles); these rows equal the plain version's bit for
  bit.

The model is held against JAX ``fused_varprop_sweep_axis1`` (interpret
mode) for K7, and for K8 against ``fused_vp2_sweep(nat_rhs_out=True)``
(interpret mode; the JAX kernel takes float32 only) at float32 and the JAX
streams ``vp2_streams_xla`` with the JAX ``thomas`` at float64: within
1e-10 K at float64, and at float32 within 8 float32 ulp of the output's
scale (the kernels' gate in chip_smoke.py) of the JAX kernel and of the
port's plain version.  1, 2, 4, 16 and 32 chunks; n no multiple of the
chunk and n below the chunk count (chunks of identity rows); void gaps,
identity rows and temperatures on the solidus and liquidus on chunk
edges; radiation on and off; the h stream and rob_c.  Each case's JAX
solution is computed once for every chunk count (~35 s on one worker).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers import pallas_varprop as jpv
from adi_thermal_fields_tpu.solvers import pallas_vp2 as jvp2
from adi_thermal_fields_tpu.solvers.pallas_sweeps import (
    sweep_code as j_sweep_code)
from adi_thermal_fields_tpu.solvers.thomas import thomas as j_thomas
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

from adi_thermal_fields_tpu_torch import apparent_cp, melt_pool_enhanced_k
from adi_thermal_fields_tpu_torch.bc.faces import shift_in
from adi_thermal_fields_tpu_torch.solvers import (build_vp2_code, sweep_code,
                                                  varprop_sweep_y_plain,
                                                  vp2_sweep_z_plain)
from adi_thermal_fields_tpu_torch.solvers.varprop import eval_spec, harm
from adi_thermal_fields_tpu_torch.solvers.vp2 import (_faces_hi, _open_films,
                                                      _rad, _scaled_rows)

torch.set_num_threads(1)

ATOL = 1e-10          # K, float64
ULP32 = 8             # float32 ulp of the output's scale
SOLIDUS, LIQUIDUS = 1420.0, 1470.0
RHO, CP, K = 7800.0, 490.0, 54.0
TG, SK, TINF, ROB = 0.37, 0.01, 20.0, 15.0          # K7's scalars
DT, THETA, DZ, H = 0.05, 0.5, 0.8e-3, 30.0          # K8's
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])


# ---------------------------------------------------------------------------
# the split solve
# ---------------------------------------------------------------------------

def _pcr(a, c, d):
    """Cyclic reduction of a unit-diagonal tridiagonal system along axis 0,
    as the kernels' phase (b) runs it across lanes."""
    rows = d.shape[0]

    def shift(t, k):
        out = torch.zeros_like(t)
        if k > 0:
            out[k:] = t[:rows - k]
        else:
            out[:rows + k] = t[-k:]
        return out

    s = 1
    while s < rows:
        am, cm, dm = shift(a, s), shift(c, s), shift(d, s)
        ap, cp, dp = shift(a, -s), shift(c, -s), shift(d, -s)
        inv = 1.0 / (1.0 - a * cm - c * ap)
        a, c, d = -(a * am) * inv, -(c * cp) * inv, (d - a * dm - c * dp) * inv
        s *= 2
    return d


def split_solve(a, b, c, d, m):
    """The split-line solve along axis 0 (trailing axes: batch) in chunks
    of ``m`` rows, the line padded with identity rows to whole chunks;
    ``a[0]`` and ``c[n-1]`` are dropped, as ``Chunk::load_rows`` drops
    them."""
    n = d.shape[0]
    chunks = -(-n // m)
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
    # (b) the reduced system: rows (first, last) of each chunk, by PCR
    two = (lambda f: torch.stack([f[0], f[m - 1]], 1)
           .reshape(2 * chunks, *batch))
    u = _pcr(two(a), two(c), two(d)).reshape(chunks, 2, *batch)
    x0, xl = u[:, 0], u[:, 1]
    # (c) back substitution inside each chunk
    xs = [x0] + [d[k] - a[k] * x0 - c[k] * xl for k in range(1, m - 1)] \
        + [xl]
    return torch.stack(xs, 1).reshape(chunks * m, *batch)[:n]


def _chunk(n, chunks):
    """Rows a chunk when a line of n rows is cut into ``chunks`` (at least
    2: the kernels' chunks have a first and a last row)."""
    return max(2, -(-n // chunks))


# ---------------------------------------------------------------------------
# the kernels' rows, chunk by chunk
# ---------------------------------------------------------------------------

def k7_rows(rhs, code, fc, w, h, rob_c, m):
    """K7's rows along axis 0 as ``VpRows::load`` forms them: per chunk
    f_lo = fc[row0] read once, each row reads f_hi = fc[i+1] (zero at the
    last row) and carries it on as the next row's f_lo; one tensor op per
    operation of ``atf::vp_row_coeffs``."""
    dtype, n = rhs.dtype, rhs.shape[0]
    bit = (lambda c, b: ((c & b) != 0).to(dtype))
    sk = torch.tensor(SK, dtype=dtype)
    hs = torch.tensor(rob_c, dtype=dtype)
    a, b, c, d = (torch.empty_like(rhs) for _ in range(4))
    for row0 in range(0, n, m):
        f_lo = fc[row0]
        for i in range(row0, min(row0 + m, n)):
            f_hi = fc[i + 1] if i + 1 < n else torch.zeros_like(f_lo)
            cd = code[i]
            sink = (sk * (hs if h is None else h[i])) \
                * ((2.0 - bit(cd, 1) - bit(cd, 2)) * bit(cd, 8))
            tw = TG * w[i]
            sw = sink * w[i]
            a[i], c[i] = -tw * f_lo, -tw * f_hi
            b[i] = 1.0 + tw * (f_lo + f_hi) + sw
            d[i] = rhs[i] + sw * TINF
            f_lo = f_hi
    return a, b, c, d


def k8_rows(rhs, T, code, glo, gs, inv_dtor, k_spec, cp_spec, eps, m):
    """K8's rows along axis 0 as ``vp2_chunk`` forms them: k(T) once a
    row; a chunk's k at rows row0 - 1 and row0 + m come from the
    neighbouring chunks' last and first rows (the kernel's shuffles); the
    first row's f_lo is harm(k_prev, k_first) where the previous row's
    bit 1 is set, and each f_hi is carried on as the next row's f_lo."""
    n = T.shape[0]
    kv = (lambda t: eval_spec(k_spec, t))
    bit = (lambda c, b: ((c & b) != 0).to(T.dtype))
    starts = range(0, n, m)
    kf = [kv(T[r]) for r in starts]
    kl = [kv(T[r + m - 1]) if r + m - 1 < n else None for r in starts]
    a, b, c, d = (torch.empty_like(T) for _ in range(4))
    for j, row0 in enumerate(starts):
        k_cur = kf[j]
        f_lo = (torch.where((code[row0 - 1] & 1) != 0,
                            harm(kl[j - 1], kf[j]), 0.0)
                if row0 > 0 else torch.zeros_like(k_cur))
        for k in range(min(m, n - row0)):
            i = row0 + k
            if i == n - 1:
                k_nxt = k_cur
            elif k == m - 1:
                k_nxt = kf[j + 1]
            elif k == m - 2:
                k_nxt = kl[j]
            else:
                k_nxt = kv(T[i + 1])
            f_hi = torch.where((code[i] & 1) != 0, harm(k_cur, k_nxt), 0.0)
            hh = H + (_rad(T[i], eps, TINF) if eps > 0.0 else 0.0)
            sink = bit(code[i], 2) * gs * hh + bit(code[i], 4) * gs * hh
            al, ch = glo * f_lo, glo * f_hi
            coup = al + ch + sink
            wr = torch.where(coup > 0.0, eval_spec(cp_spec, T[i]) * inv_dtor,
                             1.0)
            a[i], b[i], c[i] = -al, wr + coup, -ch
            d[i] = rhs[i] * wr + sink * TINF
            f_lo, k_cur = f_hi, k_nxt
    return a, b, c, d


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _field(rng, mask):
    """T over 20-1600 C in the mask (20 outside), with cells exactly on the
    solidus and the liquidus and inside the mushy interval."""
    T = np.where(mask, 20.0 + 1580.0 * rng.random(mask.shape), 20.0)
    flat = T.reshape(-1)
    flat[::7] = SOLIDUS
    flat[3::11] = LIQUIDUS
    flat[5::13] = 1445.0
    return T


def _edges(mask, T, axis, m):
    """Void gaps and breakpoint temperatures on chunk edges along ``axis``
    (rows m-1, m, 3m-1 void in the first pencils; the solidus and the
    liquidus on rows 0, m-1, m, 2m-1, 2m)."""
    ix = [slice(None)] * 3
    for row in (m - 1, m, 3 * m - 1):
        ix[axis] = row
        sel = tuple(ix)
        mask[sel][:2] = False
        T[sel][:2] = 20.0
    for row, val in ((0, SOLIDUS), (m - 1, LIQUIDUS), (m, SOLIDUS),
                     (2 * m - 1, SOLIDUS), (2 * m, LIQUIDUS)):
        ix[axis] = row
        T[tuple(ix)][2:] = np.where(mask[tuple(ix)][2:], val, 20.0)


def k7_case(n, seed, edges_m=None):
    """(mask, rhs, fc, w, h) of a y sweep on a (3, n, 5) field."""
    rng = np.random.default_rng(seed)
    shape = (3, n, 5)
    mask = rng.random(shape) > 0.2
    rhs = _field(rng, mask)
    if edges_m:
        _edges(mask, rhs, 1, edges_m)
    kf = rng.random(shape) * 40.0 + 10.0
    fc = np.asarray(jcv._face_g(jnp.asarray(kf), 1, -1, jnp.asarray(mask)))
    w = rng.random(shape) * 1e-7 + 2e-7
    h = rng.random(shape) * 40.0 + 5.0
    return mask, rhs, fc, w, h


def k8_case(n, seed, edges_m=None):
    """(mask, T, rhs) of a z sweep on a (3, 5, n) field."""
    rng = np.random.default_rng(seed)
    shape = (3, 5, n)
    mask = rng.random(shape) > 0.2
    T = _field(rng, mask)
    if edges_m:
        _edges(mask, T, 2, edges_m)
    rhs = np.where(mask, 20.0 + 1580.0 * rng.random(shape), 20.0)
    return mask, T, rhs


def _tables():
    """(JAX k, JAX cp, port k, port cp): melt-pool k x4, apparent cp."""
    return (jcv.melt_pool_enhanced_k(K, SOLIDUS, LIQUIDUS, enhancement=4.0),
            jcv.apparent_cp(CP, CP, 2.7e5, SOLIDUS, LIQUIDUS),
            melt_pool_enhanced_k(K, SOLIDUS, LIQUIDUS, 4.0),
            apparent_cp(CP, CP, 2.7e5, SOLIDUS, LIQUIDUS))


def _spec(tab):
    return (tuple(tab.points), tuple(tab.values))


def _k8_scalars(dtype):
    f = np.float32 if dtype == torch.float32 else np.float64
    dtor = f(f(DT) / f(RHO))
    return (float(f(THETA / DZ ** 2)), float(f(1.0 / DZ)), dtor,
            float(f(1.0) / dtor))


def _within(got, want, dtype):
    err = float((got - want).abs().max())
    if dtype == torch.float64:
        assert err <= ATOL, err
    else:
        scale = max(1.0, float(want.abs().max()))
        assert err <= ULP32 * torch.finfo(torch.float32).eps * scale, \
            (err, err / (torch.finfo(torch.float32).eps * scale))


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _k7_jax(mask, rhs, fc, w, h, dtype, film):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    jcode = jnp.moveaxis(j_sweep_code(jnp.asarray(mask), None, 1), 0, 1)
    return np.asarray(jpv.fused_varprop_sweep_axis1(
        jnp.asarray(rhs, jd), jcode, jnp.asarray(fc, jd),
        jnp.asarray(w, jd), TG, SK, TINF,
        h=jnp.asarray(h, jd) if film == "h_stream" else None, rob_c=ROB,
        interpret=True))


# the line cases: (rows, film or emissivity, void gaps and breakpoints on
# the edges of 8-row chunks); 27 and 13 rows are no multiple of the chunk
# and, at 16 and 32 chunks, below the chunk count
K7_CASES = {"n27-h_stream": (27, "h_stream", None),
            "n13-rob_c": (13, "rob_c", None),
            "edges32-rob_c": (32, "rob_c", 8)}
K8_CASES = {"n27-rad": (27, 0.5, None), "n13-conv": (13, 0.0, None),
            "edges32-rad": (32, 0.5, 8)}
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])


@functools.lru_cache(maxsize=None)
def _k7_ref(name, dtype):
    """A K7 case and its JAX solution (one interpret-mode call for every
    chunk count)."""
    n, film, edges = K7_CASES[name]
    case = k7_case(n, seed=n, edges_m=edges)
    return case, film, _k7_jax(*case, dtype, film)


def _k7_model(mask, rhs, fc, w, h, dtype, film, chunks):
    """The split solve on K7's rows, and the plain version, in the
    natural (B1, n, B2) layout."""
    code = sweep_code(torch.from_numpy(mask), None, 1).movedim(0, 1) \
        .contiguous()
    ys = (lambda a: _t(a, dtype).movedim(1, 0))
    hv = ys(h) if film == "h_stream" else None
    n = rhs.shape[1]
    rows = k7_rows(ys(rhs), code.movedim(1, 0), ys(fc), ys(w), hv, ROB,
                   _chunk(n, chunks))
    got = split_solve(*rows, _chunk(n, chunks)).movedim(0, 1)
    plain = varprop_sweep_y_plain(
        _t(rhs, dtype), code, _t(fc, dtype), _t(w, dtype), TG, SK, TINF,
        h=_t(h, dtype) if film == "h_stream" else None, rob_c=ROB)
    return got, plain


@DTYPES
@pytest.mark.parametrize("name", list(K7_CASES))
@CHUNKS
def test_k7_split_model_matches_jax(chunks, name, dtype):
    """K7's rows chunk by chunk, the split solve, against JAX and the
    plain version; "edges32": void cells (identity rows) and values on the
    solidus and the liquidus on the edges of 8-row chunks."""
    case, film, ref = _k7_ref(name, dtype)
    got, plain = _k7_model(*case, dtype, film, chunks)
    _within(got, torch.from_numpy(ref), dtype)
    _within(got, plain, dtype)


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def _k8_jax(mask, T, rhs, dtype, eps):
    """JAX's K8: fused_vp2_sweep(nat_rhs_out=True) at float32; at float64
    (the JAX kernel takes float32 only) its streams and scaled rows
    (pallas_vp2.py:335-349) solved by the JAX thomas."""
    jk, jc, _, _ = _tables()
    glo, gs, dtor, _ = _k8_scalars(dtype)
    n = mask.shape[2]
    jcode = jnp.moveaxis(jvp2.build_vp2_code(jnp.asarray(mask), 2,
                                             edge_exposed=True), 2, 0)
    kw = dict(k_spec=_spec(jk), cp_spec=_spec(jc))
    if dtype == torch.float32:
        g = jnp.full((n,), glo, jnp.float32)
        s = jnp.full((n,), gs, jnp.float32)
        return np.asarray(jvp2.fused_vp2_sweep(
            jnp.asarray(rhs, jnp.float32), jnp.asarray(T, jnp.float32),
            jcode, g, g, s, s, jnp.float32(dtor), h_lo=H, h_hi=H,
            tinf_void=TINF, emissivity=eps, nat_rhs_out=True,
            interpret=True, **kw))
    zl = (lambda a: jnp.moveaxis(jnp.asarray(a), 2, 0))
    col = jnp.full((n,), gs)
    fhi, dw, sink, srhs = jvp2.vp2_streams_xla(
        zl(T), jcode, col, col, dtor, h_lo=H, h_hi=H, tinf_void=TINF,
        emissivity=eps, **kw)
    al = glo * jnp.concatenate([jnp.zeros_like(fhi[:1]), fhi[:-1]], axis=0)
    ch = glo * fhi
    coup = al + ch + sink
    w_r = jnp.where(coup > 0.0, 1.0 / dw, 1.0)
    x = j_thomas(-al, w_r + coup, -ch, zl(rhs) * w_r + srhs)
    return np.asarray(jnp.moveaxis(x, 0, 2))


@functools.lru_cache(maxsize=None)
def _k8_ref(name, dtype):
    n, eps, edges = K8_CASES[name]
    case = k8_case(n, seed=100 + n, edges_m=edges)
    return case, eps, _k8_jax(*case, dtype, eps)


def _k8_model(mask, T, rhs, dtype, eps, chunks):
    """The split solve on K8's rows (checked equal to the plain version's
    rows bit for bit), and the plain version, natural layout."""
    _, _, pk, pc = _tables()
    glo, gs, _, inv_dtor = _k8_scalars(dtype)
    code = build_vp2_code(torch.from_numpy(mask), 2, edge_exposed=True)
    Tt, Rt = _t(T, dtype), _t(rhs, dtype)
    zf = (lambda t: t.movedim(2, 0))
    m = _chunk(mask.shape[2], chunks)
    rows = k8_rows(zf(Rt), zf(Tt), zf(code), glo, gs, inv_dtor, pk, pc, eps,
                   m)
    # the plain version's rows (solvers/vp2.py _open_plain)
    fhi = _faces_hi(Tt, code, pk, 2)
    sink, srhs = _open_films(Tt, code, gs, gs, 2, H, H, TINF, eps, None,
                             None)
    want_rows = _scaled_rows(Rt, Tt, pc, inv_dtor,
                             glo * shift_in(fhi, 2, -1, fill=0.0), glo * fhi,
                             sink, srhs)
    for got_r, want_r in zip(rows, want_rows):
        assert torch.equal(got_r, zf(want_r))
    got = split_solve(*rows, m).movedim(0, 2)
    plain = vp2_sweep_z_plain(Rt, Tt, code, glo, gs, inv_dtor, k_spec=pk,
                              cp_spec=pc, h=H, t_inf=TINF, emissivity=eps)
    return got, plain


@DTYPES
@pytest.mark.parametrize("name", list(K8_CASES))
@CHUNKS
def test_k8_split_model_matches_jax(chunks, name, dtype):
    """K8's rows chunk by chunk (the k at chunk seams from the neighbouring
    chunk), the split solve, against JAX and the plain version; "edges32":
    void gaps (identity rows, no face across the seam) and k and cp
    breakpoints (the solidus, the liquidus) on the edges of 8-row
    chunks."""
    case, eps, ref = _k8_ref(name, dtype)
    got, plain = _k8_model(*case, dtype, eps, chunks)
    _within(got, torch.from_numpy(ref), dtype)
    _within(got, plain, dtype)
