"""K8's general form on K8's split-line kernel, and K23's plane march, as
torch models against the JAX package on the CPU.

K8's general form (the cylindrical tier-2 z sweep: per-row columns glo,
ghi, gsl and gsh, a lo-face film h_lo that differs from the hi-face film
h_hi, the domain-edge films at rows 0 and n-1, Dirichlet rows) runs on K8's
split-line kernel (csrc/vp2_sweep.cu): each line cut into chunks of m rows,
each chunk's rows formed in registers (``gen_row``) with k(T) once a row and
a chunk's k at rows row0 - 1 and row0 + m taken from the neighbouring
chunks, eliminated, the chunks' end rows solved as a reduced system, then
each chunk back-substituted.  ``k8_general_rows`` forms the rows as the
kernel does, chunk by chunk; they equal the plain version's rows bit for
bit, and ``split_solve`` (tests/test_torch_split_varprop.py) solves them.
At float32 a line with a row past the kernel's stiffness ratio (kK8Stiff =
12: |a| + |c| > 12/13 b) is solved again in Thomas order, bit for bit the
plain version (``k8_general_model``).  Held against JAX
``fused_vp2_sweep(nat_rhs_out=True)`` in interpret mode at float32 (the
JAX kernel takes float32 only) and against the JAX streams
``vp2_streams_xla`` with the JAX ``thomas`` at float64: within 1e-10 K at
float64 and 8 float32 ulp of the output's scale at float32, as is the
plain version.  1, 2, 4, 16 and 32 chunks; n no multiple of the chunk and
below the chunk count; void gaps and breakpoint temperatures on chunk
edges; radiation on and off; distinct and shared columns.

K23 (the g-stream fields pass) marches a tile of (y, z) columns along x,
evaluating k(T) once a cell and each face's harm once (``k23_model``: one
harm a face of each axis, given to the cell below the face as its g_hi and
to the cell above as its g_lo).  It is ``torch.equal`` to the plain version
at float32 and bfloat16 in each film mode, with and without a source, on
masks with voids, on domain edges and on dimensions of 1, and within JAX
``gstream_fields``' tolerance of it (relative 2e-6, as
tests/test_torch_bf16.py).  ~40 s on one worker.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers import pallas_vp2 as jvp2
from adi_thermal_fields_tpu.solvers.pallas_gstreams import (
    gstream_fields as j_gstream_fields)
from adi_thermal_fields_tpu.solvers.thomas import thomas as j_thomas
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

from adi_thermal_fields_tpu_torch import PropertyTable, apparent_cp
from adi_thermal_fields_tpu_torch.bc.faces import shift_in
from adi_thermal_fields_tpu_torch.solvers import (build_vp2_code,
                                                  gstream_fields,
                                                  gstream_fields_plain,
                                                  vp2_sweep_z_plain)
from adi_thermal_fields_tpu_torch.solvers.gstreams import _gstream_scalars
from adi_thermal_fields_tpu_torch.solvers.rounding import to_state, widen
from adi_thermal_fields_tpu_torch.solvers.thomas import thomas
from adi_thermal_fields_tpu_torch.solvers.varprop import eval_spec, harm
from adi_thermal_fields_tpu_torch.solvers.vp2 import (_faces_hi, _open_films,
                                                      _rad, _scaled_rows)
from test_torch_split_varprop import (_chunk, _edges, _field, _spec, _t,
                                      _tables, _within, split_solve)

torch.set_num_threads(1)

DT, RHO = 0.05, 7800.0
K8_STIFF = 12.0                    # csrc/vp2_sweep.cu kK8Stiff
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])


# ---------------------------------------------------------------------------
# K8's general form
# ---------------------------------------------------------------------------

def k8_general_rows(rhs, T, code, cols, inv_dtor, k_spec, cp_spec, films,
                    m):
    """K8's general rows along axis 0 as ``vp2_chunk`` forms them with
    ``gen_row``: k(T) once a row, a chunk's k at rows row0 - 1 and row0 + m
    from the neighbouring chunks, each f_hi carried on as the next row's
    f_lo; the films of ``open_films`` (csrc/vp2_films.cuh) and the scaled
    row, one tensor op per operation."""
    glo, ghi, gsl, gsh = cols
    h_lo, h_hi, tinf, eps, edge0, edge1 = films
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
            hr = _rad(T[i], eps, tinf) if eps > 0.0 else 0.0
            sink = (bit(code[i], 2) * gsl[i] * (h_lo + hr)
                    + bit(code[i], 4) * gsh[i] * (h_hi + hr))
            srhs = sink * tinf
            for idx, edge in ((0, edge0), (n - 1, edge1)):
                if edge is not None and i == idx:
                    h_e, g_e, t_e = edge
                    hr_e = _rad(T[i], eps, t_e) if eps > 0.0 else 0.0
                    s_e = bit(code[i], 8) * g_e * (h_e + hr_e)
                    sink = sink + s_e
                    srhs = srhs + s_e * t_e
            al, ch = glo[i] * f_lo, ghi[i] * f_hi
            coup = al + ch + sink
            w = torch.where(coup > 0.0, eval_spec(cp_spec, T[i]) * inv_dtor,
                            1.0)
            a[i], b[i], c[i] = -al, w + coup, -ch
            d[i] = rhs[i] * w + srhs
            f_lo, k_cur = f_hi, k_nxt
    return a, b, c, d


def stiff_lines(a, b, c):
    """The lines (trailing axes) with a row past kK8Stiff as the kernel's
    float32 test takes it: |a| + |c| > q b, q = float32(12/13), a[0] and
    c[n-1] dropped."""
    a, c = a.clone(), c.clone()
    a[0] = 0.0
    c[-1] = 0.0
    q = torch.tensor(K8_STIFF / (1.0 + K8_STIFF), dtype=torch.float32)
    f = (lambda t: t.to(torch.float32))
    return ((f(a).abs() + f(c).abs()) > q * f(b)).any(0)


def k8_general_model(rows, m, dtype):
    """The kernel's solve of ``rows`` along axis 0: split, and at float32
    the lines with a row past kK8Stiff in Thomas order (bit for bit the
    plain version's ``thomas``)."""
    got = split_solve(*rows, m)
    if dtype == torch.float32:
        stiff = stiff_lines(*rows[:3])
        got = torch.where(stiff, thomas(*rows), got)
    return got


def k8_general_case(n, seed, *, eps, shared, edges_m=None):
    """(mask, T, rhs, cols, films, clear) of a general z sweep on a (3, 5,
    n) field: ``shared``: the cylindrical step's columns (ghi = glo with
    Dirichlet rows 0 and n-1 zero, gsh = gsl), a Robin top edge film;
    else distinct columns and both edge films."""
    rng = np.random.default_rng(seed)
    shape = (3, 5, n)
    mask = rng.random(shape) > 0.2
    T = _field(rng, mask)
    if edges_m:
        _edges(mask, T, 2, edges_m)
    rhs = np.where(mask, 20.0 + 1580.0 * rng.random(shape), 20.0)
    if shared:
        geo = np.full(n, 1.0 / 0.8e-3 ** 2)
        geo[[0, n - 1]] = 0.0
        gs = np.full(n, 1.0 / 0.8e-3)
        cols = (geo, geo, gs, gs)
        films = (80.0, 200.0, 20.0, eps, None, (400.0, 1.0 / 0.8e-3, 25.0))
        clear = (0, n - 1)
    else:
        cols = tuple(base * (1.0 + 0.3 * rng.random(n))
                     for base in (1.5e6, 1.5e6, 1.2e3, 1.2e3))
        films = (60.0, 150.0, 25.0, eps, (300.0, 1.1e3, 30.0),
                 (400.0, 1.3e3, 15.0))
        clear = ()
    return mask, T, rhs, cols, films, clear


# (rows, emissivity, shared columns, breakpoints and voids on the edges of
# 8-row chunks); 27 and 13 rows are no multiple of the chunk and, at 16
# and 32 chunks, below the chunk count
K8G_CASES = {"n27-rad-distinct": (27, 0.5, False, None),
             "n13-conv-dirichlet": (13, 0.0, True, None),
             "edges32-rad-dirichlet": (32, 0.5, True, 8)}


def _scalars(dtype, dt=DT):
    f = np.float32 if dtype == torch.float32 else np.float64
    dtor = f(f(dt) / f(RHO))
    return dtor, float(f(1.0) / dtor)


def _k8g_jax(mask, T, rhs, cols, films, clear, dtype, dt=DT):
    """JAX's general K8: fused_vp2_sweep(nat_rhs_out=True) at float32; at
    float64 its streams and scaled rows solved by the JAX thomas."""
    jk, jc, _, _ = _tables()
    dtor, _ = _scalars(dtype, dt)
    h_lo, h_hi, tinf, eps, edge0, edge1 = films
    code = build_vp2_code(torch.from_numpy(mask), 2, clear_rows=clear)
    jcode = jnp.moveaxis(jnp.asarray(code.numpy().astype(np.int8)), 2, 0)
    kw = dict(k_spec=_spec(jk), cp_spec=_spec(jc), h_lo=h_lo, h_hi=h_hi,
              tinf_void=tinf, emissivity=eps, edge0=edge0, edge1=edge1)
    if dtype == torch.float32:
        c32 = [jnp.asarray(v, jnp.float32) for v in cols]
        return np.asarray(jvp2.fused_vp2_sweep(
            jnp.asarray(rhs, jnp.float32), jnp.asarray(T, jnp.float32),
            jcode, *c32, jnp.float32(dtor), nat_rhs_out=True,
            interpret=True, **kw))
    zl = (lambda a: jnp.moveaxis(jnp.asarray(a), 2, 0))
    glo, ghi, gsl, gsh = (jnp.asarray(v)[:, None, None] for v in cols)
    fhi, dw, sink, srhs = jvp2.vp2_streams_xla(
        zl(T), jcode, jnp.asarray(cols[2]), jnp.asarray(cols[3]), dtor, **kw)
    al = glo * jnp.concatenate([jnp.zeros_like(fhi[:1]), fhi[:-1]], axis=0)
    ch = ghi * fhi
    coup = al + ch + sink
    w_r = jnp.where(coup > 0.0, 1.0 / dw, 1.0)
    x = j_thomas(-al, w_r + coup, -ch, zl(rhs) * w_r + srhs)
    return np.asarray(jnp.moveaxis(x, 0, 2))


@functools.lru_cache(maxsize=None)
def _k8g_ref(name, dtype):
    n, eps, shared, edges = K8G_CASES[name]
    case = k8_general_case(n, seed=200 + n, eps=eps, shared=shared,
                           edges_m=edges)
    return case, _k8g_jax(*case, dtype)


def _k8g_model(mask, T, rhs, cols, films, clear, dtype, chunks, dt=DT):
    """The kernel's solve on the general rows (checked equal to the plain
    version's rows bit for bit), and the plain version, natural layout."""
    _, _, pk, pc = _tables()
    _, inv_dtor = _scalars(dtype, dt)
    h_lo, h_hi, tinf, eps, edge0, edge1 = films
    code = build_vp2_code(torch.from_numpy(mask), 2, clear_rows=clear)
    Tt, Rt = _t(T, dtype), _t(rhs, dtype)
    glo, ghi, gsl, gsh = (_t(v, dtype) for v in cols)
    zf = (lambda t: t.movedim(2, 0))
    m = _chunk(mask.shape[2], chunks)
    rows = k8_general_rows(zf(Rt), zf(Tt), zf(code), (glo, ghi, gsl, gsh),
                           inv_dtor, pk, pc, films, m)
    # the plain version's rows (solvers/vp2.py _open_plain)
    fhi = _faces_hi(Tt, code, pk, 2)
    sink, srhs = _open_films(Tt, code, gsl, gsh, 2, h_lo, h_hi, tinf, eps,
                             edge0, edge1)
    want_rows = _scaled_rows(Rt, Tt, pc, inv_dtor,
                             glo * shift_in(fhi, 2, -1, fill=0.0), ghi * fhi,
                             sink, srhs)
    for got_r, want_r in zip(rows, want_rows):
        assert torch.equal(got_r, zf(want_r))
    got = k8_general_model(rows, m, dtype).movedim(0, 2)
    plain = vp2_sweep_z_plain(Rt, Tt, code, glo, gsl, inv_dtor, k_spec=pk,
                              cp_spec=pc, h=h_lo, h_hi=h_hi, ghi=ghi,
                              gsh=gsh, t_inf=tinf, emissivity=eps,
                              edge0=edge0, edge1=edge1)
    return got, plain, rows


@DTYPES
@pytest.mark.parametrize("name", list(K8G_CASES))
@CHUNKS
def test_k8_general_split_model_matches_jax(chunks, name, dtype):
    """K8's general rows chunk by chunk (per-row columns, h_lo != h_hi,
    edge films at rows 0 and n-1, Dirichlet rows), the split solve,
    against JAX and the plain version; "edges32": void gaps (identity
    rows, no face across the seam) and the solidus and the liquidus on
    the edges of 8-row chunks."""
    case, ref = _k8g_ref(name, dtype)
    got, plain, _ = _k8g_model(*case, dtype, chunks)
    _within(got, torch.from_numpy(np.array(ref)), dtype)
    _within(got, plain, dtype)


@pytest.mark.parametrize("chunks", [2, 16])
def test_k8_general_stiff_lines_replay_bit_for_bit(chunks):
    """At 5x the dt a line through the melt (k x4) has rows past kK8Stiff
    and a solid line none: the kernel's model solves the first in Thomas
    order, bit for bit the plain version, and splits the second, within 8
    float32 ulp of its scale."""
    dtype = torch.float32
    case = k8_general_case(40, seed=77, eps=0.5, shared=True)
    mask, T = case[:2]
    T[0, :2] = np.where(mask[0, :2], 800.0, 20.0)          # solid lines
    got, plain, rows = _k8g_model(*case, dtype, chunks, dt=5.0 * DT)
    stiff = stiff_lines(*rows[:3])                 # (3, 5) lines
    assert bool(stiff.any()) and not bool(stiff.all())
    sel = stiff[..., None].expand_as(got)
    assert torch.equal(got[sel], plain[sel])
    _within(got, plain, dtype)


# ---------------------------------------------------------------------------
# K23
# ---------------------------------------------------------------------------

def k23_model(T, mask_u8, tg3, sk3, *, k_spec, cp_spec, rho, h_mode="const",
              hpar=0.0, t_inf=0.0, h_conv=0.0, dt=0.0, h=None, src=None):
    """K23's sharing order: k(T) once a cell, one harm a face of each axis
    between in-mask neighbours (harm(k at the lower index, k at the upper
    one)), given to the cell below the face as its g_hi and to the cell
    above as its g_lo; an uncoupled face is 0 without a harm.  Returns the
    streams as ``gstream_fields_plain`` does."""
    state = T.dtype
    Tc = widen(T)
    cdt = Tc.dtype
    mb = mask_u8 != 0
    k = eval_spec(k_spec, Tc)                            # once a cell
    w = 1.0 / (rho * eval_spec(cp_spec, Tc))
    hpar, tik, tik2 = _gstream_scalars(state, h_mode, hpar, t_inf, h_conv)
    if h_mode == "rad":
        tk = Tc + 273.15
        hloc = hpar * (tk + tik) * (tk * tk + tik2) + h_conv
    elif h_mode == "stream":
        hloc = widen(h)
    else:
        hloc = hpar
    wm = w * mb.to(cdt)
    hw = hloc * wm
    g_lo, g_hi, sw = [], [], []
    for ax in range(3):
        n = T.shape[ax]
        lo = (lambda t: t.narrow(ax, 0, n - 1))
        up = (lambda t: t.narrow(ax, 1, n - 1))
        on = lo(mb) & up(mb)                             # the coupled faces
        face = torch.zeros_like(lo(k))
        face[on] = harm(lo(k)[on], up(k)[on])            # one harm a face
        pad = (lambda t, first: torch.cat(
            [torch.zeros_like(k.narrow(ax, 0, 1), dtype=t.dtype), t]
            if first else
            [t, torch.zeros_like(k.narrow(ax, 0, 1), dtype=t.dtype)], ax))
        f_lo, f_hi = pad(face, True), pad(face, False)
        c_lo, c_hi = pad(on, True), pad(on, False)
        tw = tg3[ax] * w
        g_lo.append(torch.where(c_lo, tw * f_lo, 0.0))
        g_hi.append(torch.where(c_hi, tw * f_hi, 0.0))
        sw.append((sk3[ax] * hw) * (2.0 - c_lo.to(cdt) - c_hi.to(cdt)))
    out = tuple(tuple(to_state(t, state) for t in group)
                for group in (g_lo, g_hi, sw))
    src_pre = (None if src is None else
               to_state((dt * wm) * widen(src), state))
    return (*out, src_pre)


KT = ((0.0, 500.0, 1200.0), (54.0, 40.0, 30.0))
CT = (490.0, 620.0, 2.5e5, 900.0, 1000.0)          # apparent_cp arguments
SPACING = (1e-3, 1.3e-3, 0.8e-3)


def k23_case(shape, seed, on_breakpoint=True):
    """A mask with voids (a notch, a column, random holes), T, src and h;
    ``on_breakpoint``: every fifth cell on the latent interval's lower
    end, where the table steps by 2565 within 1e-7 K (float32 takes the
    lower value; JAX's interpret mode under x64 the upper)."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.15
    mask[shape[0] // 2:, : max(1, shape[1] // 3), : max(1, shape[2] // 2)] \
        = False
    mask[0, :, -1] = False
    T = (800.0 + 200.0 * rng.random(shape)).astype(np.float32)
    if on_breakpoint:
        T.reshape(-1)[::5] = 900.0
    src = (2e7 * rng.random(shape)).astype(np.float32)
    h = (50.0 + 100.0 * rng.random(shape)).astype(np.float32)
    return mask, T, src, h


def _k23_args(h_mode, dt=DT):
    dt32 = np.float32(dt)
    tg3 = [float(np.float32(0.5) * dt32 / np.float32(d) ** 2)
           for d in SPACING]
    sk3 = [float(dt32 / np.float32(d)) for d in SPACING]
    hpar, h_conv = {"const": (140.0, 0.0), "stream": (0.0, 0.0),
                    "rad": (0.6, 12.0)}[h_mode]
    return tg3, sk3, dict(k_spec=PropertyTable(*KT),
                          cp_spec=apparent_cp(*CT), rho=RHO, h_mode=h_mode,
                          hpar=hpar, t_inf=20.0, h_conv=h_conv,
                          dt=float(dt32))


def _flat(out):
    return [*out[0], *out[1], *out[2], out[3]]


K23_SHAPES = {"12x10x14": (12, 10, 14), "1x5x7": (1, 5, 7),
              "4x1x6": (4, 1, 6), "3x5x1": (3, 5, 1), "1x1x1": (1, 1, 1)}
# every film mode with and without a source on the voids case; two on the
# fields with a dimension of 1
K23_CASES = ([("12x10x14", mode, s) for mode in ("const", "stream", "rad")
              for s in (False, True)]
             + [(shape, mode, s) for shape in list(K23_SHAPES)[1:]
                for mode, s in (("rad", True), ("stream", False))])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,h_mode,with_src", K23_CASES,
    ids=[f"{a}-{b}{'-src' if c else ''}" for a, b, c in K23_CASES])
def test_k23_sharing_model_equals_plain(shape, h_mode, with_src, dtype):
    """k once a cell and one harm a face give the plain version's streams
    bit for bit: voids, domain edges, dimensions of 1."""
    mask, T, src, h = k23_case(K23_SHAPES[shape], seed=5)
    tg3, sk3, kw = _k23_args(h_mode)
    ins = dict(h=_t(h, dtype) if h_mode == "stream" else None,
               src=_t(src, dtype) if with_src else None)
    args = (_t(T, dtype), _t(mask).to(torch.uint8), tg3, sk3)
    got = k23_model(*args, **kw, **ins)
    want = gstream_fields_plain(*args, **kw, **ins)
    # the wrapper on CPU tensors is the plain version
    via = gstream_fields(*args, **kw, **ins)
    for g, w, v in zip(_flat(got), _flat(want), _flat(via)):
        if w is None:
            assert g is None and v is None
            continue
        assert g.dtype == dtype
        assert torch.equal(g, w)
        assert torch.equal(v, w)


@pytest.mark.parametrize("h_mode", ["const", "stream", "rad"])
def test_k23_sharing_model_matches_jax(h_mode):
    """The sharing model against JAX ``gstream_fields`` (interpret mode)
    at float32: relative 2e-6, tests/test_torch_bf16.py's tolerance."""
    mask, T, src, h = k23_case((12, 10, 14), seed=9, on_breakpoint=False)
    tg3, sk3, kw = _k23_args(h_mode)
    want = j_gstream_fields(
        jnp.asarray(T), jnp.asarray(mask).astype(jnp.int8),
        jnp.asarray(tg3, jnp.float32), jnp.asarray(sk3, jnp.float32),
        kw["hpar"], 20.0, kw["h_conv"], jnp.float32(DT),
        h=jnp.asarray(h) if h_mode == "stream" else None,
        src=jnp.asarray(src),
        k_spec=jcv._table_spec(jcv.PropertyTable(*KT), 54.0),
        cp_spec=jcv._table_spec(jcv.apparent_cp(*CT), 490.0), rho=RHO,
        h_mode=h_mode, interpret=True)
    got = k23_model(_t(T), _t(mask).to(torch.uint8), tg3, sk3, **kw,
                    h=_t(h) if h_mode == "stream" else None, src=_t(src))
    for g, w in zip(_flat(got), [*want[0], *want[1], *want[2], want[3]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6,
                                   atol=1e-12)
