"""K6's and K19's split-line designs (csrc/varprop_sweeps.cu,
csrc/varprop_z.cu) against the JAX package on the CPU.

K6 (the varprop theta pass fused into the x sweep) and K19 (the
stream-reading varprop sweep along contiguous z) run on the split-line core
of csrc/split_line.cuh, like K7.  Plain torch models of their algorithms,
fed to ``split_solve`` of tests/test_torch_split_varprop.py (chunk
elimination, the reduced system by PCR, back substitution):

* K6: each x line cut into chunks of m rows; a chunk forms its rows'
  right-hand sides from the stencil (``k6_rhs``) with T at its rows and one
  halo row each side, the x faces at its rows and one more, the y
  neighbours from the plane, and the z neighbours (T and the upper z face)
  as the kernel's lanes take them, from the neighbouring pencil of the
  flattened (y, z) plane, selected by k > 0 and k + 1 < nz (the code has
  no stencil bits); then K7's rows (``k7_rows``) on them.  These
  right-hand sides equal ``varprop_theta_rhs_plain`` (K20's) bit for bit:
  the precondition of the step's fuse_theta=False being equal to its fused
  form.
* K19: K7's rows along the natural z line as the kernel forms them from
  its staged tiles (``k19_rows``): each chunk padded by one slot, row i's
  upper face in the next slot, the next chunk's first past the chunk's
  last row (a pad slot holds NaN here, so a row that read one would show).

Held against JAX ``fused_varprop_theta_sweep`` and ``fused_varprop_sweep``
(natural-z form, nat_rhs_out=True), both in interpret mode, and against
the port's plain versions: at float64 within 1e-10 K, at float32 within 8
float32 ulp of the output's scale.  1, 2, 4, 16 and 32 chunks; lines of 27
and 13 rows (no multiple of the chunk; at 16 and 32 chunks, below the
chunk count); void gaps and isolated cells (rows coupled to nothing) on
the edges of 8-row chunks; the h stream, rob_c, and rob_c with a source.
Each case's JAX solution is computed once for every chunk count (~30 s on
one worker).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adi_thermal_fields_tpu.solvers import pallas_varprop as jpv
from adi_thermal_fields_tpu.solvers.pallas_sweeps import (
    sweep_code as j_sweep_code)
from adi_thermal_fields_tpu.step import cartesian_varprop as jcv

from adi_thermal_fields_tpu_torch.solvers import (sweep_code,
                                                  varprop_sweep_z,
                                                  varprop_sweep_z_plain,
                                                  varprop_theta_rhs_plain,
                                                  varprop_theta_sweep,
                                                  varprop_theta_sweep_plain)
from test_torch_split_varprop import (ROB, SK, TG, TINF, _chunk, _t,
                                      _within, k7_rows, split_solve)

torch.set_num_threads(1)

DT, CW = 0.02, 0.01                       # dt, (1 - theta) dt
INV_D2 = (1.0e6, 0.25e6, 1.0 / 9e-6)      # per-axis 1/d^2
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])
CHUNKS = pytest.mark.parametrize("chunks", [1, 2, 4, 16, 32])


# ---------------------------------------------------------------------------
# the kernels' algorithms
# ---------------------------------------------------------------------------

def _face(f_lo, f_hi, t_lo, t_hi, t, iv):
    """``atf::vp_face_term``: iv*(f_lo*(t_lo - t) + f_hi*(t_hi - t))."""
    return (f_lo * (t_lo - t) + f_hi * (t_hi - t)) * iv


def _lanes(t):
    """The previous and next pencil of the flattened (y, z) plane of ``t``
    (lanes b2 -+ 1; lanes 0 and 31 load the same cells from memory), zero
    past the plane."""
    flat = t.reshape(-1)
    lo, hi = torch.zeros_like(flat), torch.zeros_like(flat)
    lo[1:] = flat[:-1]
    hi[:-1] = flat[1:]
    return lo.reshape(t.shape), hi.reshape(t.shape)


def _y(t, step):
    """``t`` (a (y, z) plane) at y + step, zero past the plane."""
    out = torch.zeros_like(t)
    if step > 0:
        out[:-step] = t[step:]
    else:
        out[-step:] = t[:step]
    return out


def k6_rhs(T, code, fx, fy, fz, w, src, m):
    """Phase (a)'s right-hand sides of K6, chunk by chunk: T carried from
    row to row from the halo row before the chunk, the x faces from the
    chunk's first, the y neighbours from the plane, the z neighbours from
    the lanes, each neighbour zero past the domain edge (selected, never
    multiplied by a 0/1 factor); the faces x, then y, then z."""
    nx, ny, nz = T.shape
    zero = torch.zeros_like(T[0])
    j = torch.arange(ny).view(ny, 1).expand(ny, nz)
    k = torch.arange(nz).view(1, nz).expand(ny, nz)
    ylo, yhi, zlo, zhi = j > 0, j + 1 < ny, k > 0, k + 1 < nz
    sel = (lambda cond, v: torch.where(cond, v, zero))
    ivx, ivy, ivz = INV_D2
    rows = []
    for row0 in range(0, nx, m):
        t_lo = T[row0 - 1] if row0 > 0 else zero
        t_c, f_lo = T[row0], fx[row0]
        for i in range(row0, min(row0 + m, nx)):
            t_hi = T[i + 1] if i + 1 < nx else zero
            f_hi = fx[i + 1] if i + 1 < nx else zero
            tz_lo, tz_hi = _lanes(t_c)
            _, fz_hi = _lanes(fz[i])
            gain = w[i] * ((code[i] & 8) != 0).to(T.dtype)
            acc = _face(f_lo, f_hi, t_lo, t_hi, t_c, ivx)
            acc = acc + _face(fy[i], sel(yhi, _y(fy[i], 1)),
                              sel(ylo, _y(T[i], -1)), sel(yhi, _y(T[i], 1)),
                              t_c, ivy)
            acc = acc + _face(fz[i], sel(zhi, fz_hi), sel(zlo, tz_lo),
                              sel(zhi, tz_hi), t_c, ivz)
            d = t_c + CW * gain * acc
            if src is not None:
                d = d + DT * gain * src[i]
            rows.append(d)
            t_lo, t_c, f_lo = t_c, t_hi, f_hi
    return torch.stack(rows)


def k6_split(T, code, fx, fy, fz, w, h, src, chunks):
    """K6's algorithm: the stencil chunk by chunk, K7's rows, the split
    solve; also returns the right-hand sides."""
    m = _chunk(T.shape[0], chunks)
    d = k6_rhs(T, code, fx, fy, fz, w, src, m)
    return split_solve(*k7_rows(d, code, fx, w, h, ROB, m), m), d


def k19_rows(rhs, code, fc, w, h, rob_c, m):
    """K19's rows along axis 0 from its staged tiles: chunks of m rows
    padded by one slot (NaN), f_lo = the chunk's first slot, row i's f_hi
    the next slot (zero at the last row), carried on as the next row's
    f_lo; one tensor op per operation of ``atf::vp_row_coeffs``."""
    dtype, n = rhs.dtype, rhs.shape[0]
    chunks = -(-n // m)
    staged = torch.full((chunks * (m + 1), *rhs.shape[1:]), float("nan"),
                        dtype=dtype)
    for i in range(n):
        staged[i // m * (m + 1) + i % m] = fc[i]
    bit = (lambda c, b: ((c & b) != 0).to(dtype))
    sk = torch.tensor(SK, dtype=dtype)
    hs = torch.tensor(rob_c, dtype=dtype)
    a, b, c, d = (torch.empty_like(rhs) for _ in range(4))
    for j, row0 in enumerate(range(0, n, m)):
        s0 = j * (m + 1)
        f_lo = staged[s0]
        for kk in range(min(m, n - row0)):
            i, s = row0 + kk, s0 + kk
            f_hi = (staged[s + 1 if kk < m - 1 else s + 2] if i + 1 < n
                    else torch.zeros_like(f_lo))
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


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def _case(shape, axis, seed, edges_m=None):
    """(mask, T, fx, fy, fz, w, h, src, rhs) on ``shape``; with ``edges_m``
    void gaps (rows m-1, m, 3m-1) and isolated in-mask cells (row 2m-1,
    rows 2m-2 and 2m void) along ``axis`` in the first pencils."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) > 0.2
    if edges_m:
        ix = [slice(None)] * 3
        for row, val in ((edges_m - 1, False), (edges_m, False),
                         (3 * edges_m - 1, False), (2 * edges_m - 2, False),
                         (2 * edges_m - 1, True), (2 * edges_m, False)):
            ix[axis] = row
            mask[tuple(ix)][:2] = val
    T = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    kf = rng.random(shape) * 40.0 + 10.0
    jm = jnp.asarray(mask)
    fcs = [np.asarray(jcv._face_g(jnp.asarray(kf), ax, -1, jm))
           for ax in range(3)]
    w = rng.random(shape) * 1e-7 + 2e-7
    h = rng.random(shape) * 40.0 + 5.0
    src = rng.random(shape) * 1e6
    rhs = np.where(mask, 20.0 + 1480.0 * rng.random(shape), 20.0)
    return mask, T, *fcs, w, h, src, rhs


# (rows, film, chunk edges): 27 and 13 rows are no multiple of the chunk
# and, at 16 and 32 chunks, below the chunk count; "edges32" puts void gaps
# and isolated cells on the edges of 8-row chunks
K6_CASES = {"n27-h_stream": (27, "h_stream", None),
            "n13-rob_c_src": (13, "rob_c_src", None),
            "edges32-rob_c": (32, "rob_c", 8)}
K19_CASES = {"n27-h_stream": (27, "h_stream", None),
             "n13-rob_c": (13, "rob_c", None),
             "edges32-h_stream": (32, "h_stream", 8)}


def _jd(dtype):
    return jnp.float64 if dtype == torch.float64 else jnp.float32


@functools.lru_cache(maxsize=None)
def _k6_ref(name, dtype):
    """A K6 case on an (n, 5, 7) field (35 pencils: a group of 32 lanes
    and a partial one) and its JAX solution."""
    n, film, edges = K6_CASES[name]
    case = _case((n, 5, 7), 0, seed=n, edges_m=edges)
    mask, T, fx, fy, fz, w, h, src, _ = case
    jd = _jd(dtype)
    kw = (dict(h=jnp.asarray(h, jd)) if film == "h_stream" else
          dict(src=jnp.asarray(src, jd), dt=DT) if film == "rob_c_src"
          else {})
    ref = jpv.fused_varprop_theta_sweep(
        jnp.asarray(T, jd), j_sweep_code(jnp.asarray(mask), None, 0),
        *(jnp.asarray(a, jd) for a in (fx, fy, fz, w)), CW, INV_D2, TG, SK,
        TINF, rob_c=ROB, interpret=True, **kw)
    return case, film, np.asarray(ref)


def _k6_inputs(case, film, dtype):
    mask, T, fx, fy, fz, w, h, src, _ = case
    code = sweep_code(torch.from_numpy(mask), None, 0)
    t = (lambda a: _t(a, dtype))
    hv = t(h) if film == "h_stream" else None
    sv = t(src) if film == "rob_c_src" else None
    return mask, code, t(T), t(fx), t(fy), t(fz), t(w), hv, sv


@DTYPES
@pytest.mark.parametrize("name", list(K6_CASES))
@CHUNKS
def test_k6_split_model_matches_jax(chunks, name, dtype):
    """K6's right-hand sides chunk by chunk, K7's rows, the split solve,
    against JAX ``fused_varprop_theta_sweep`` (interpret mode) and the
    plain version; "edges32": void gaps and isolated cells on the edges of
    8-row chunks (halo rows across them)."""
    case, film, ref = _k6_ref(name, dtype)
    _, code, T, fx, fy, fz, w, h, src = _k6_inputs(case, film, dtype)
    got, _ = k6_split(T, code, fx, fy, fz, w, h, src, chunks)
    plain = varprop_theta_sweep_plain(
        T, code, fx, fy, fz, w, CW, INV_D2, TG, SK, TINF, h=h, rob_c=ROB,
        src=src, dt=DT if src is not None else None)
    _within(got, torch.from_numpy(ref), dtype)
    _within(got, plain, dtype)


@DTYPES
@pytest.mark.parametrize("name", list(K6_CASES))
def test_k6_rhs_is_k20_bitwise(name, dtype):
    """K6's right-hand sides, formed chunk by chunk with the lanes' z
    neighbours, equal K20's plain version (the unfused step's R0) bit for
    bit, for every chunk length: K20 -> K7x then repeats K6 exactly."""
    case, film, _ = _k6_ref(name, dtype)
    mask, code, T, fx, fy, fz, w, _, src = _k6_inputs(case, film, dtype)
    want = varprop_theta_rhs_plain(
        T, fx, fy, fz, w, torch.from_numpy(mask).to(torch.uint8), CW,
        INV_D2, src=src, dt=DT if src is not None else None)
    for chunks in (1, 4, 32):
        got = k6_rhs(T, code, fx, fy, fz, w, src,
                     _chunk(T.shape[0], chunks))
        assert torch.equal(got, want), chunks


@pytest.mark.parametrize("nz", [1, 5, 32, 33])
def test_lane_z_neighbours_selected_by_the_domain_edge(nz):
    """The flattened plane's neighbouring pencil, selected by k > 0 and
    k + 1 < nz, is the z neighbour (T and the upper z face) also where a
    group of 32 lanes ends inside a y row or a y row inside a group: K6's
    code has no stencil bits, and needs none."""
    mask, T, _, _, fz, *_ = _case((2, 6, nz), 2, seed=nz)
    Tt, fzt = torch.from_numpy(T[0]), torch.from_numpy(fz[0])
    k = torch.arange(nz).view(1, nz).expand(6, nz)
    lo, hi = _lanes(Tt)
    _, fhi = _lanes(fzt)
    zero = torch.zeros_like(Tt)
    want_lo = torch.zeros_like(Tt)
    want_lo[:, 1:] = Tt[:, :-1]
    want_hi, want_fhi = torch.zeros_like(Tt), torch.zeros_like(Tt)
    want_hi[:, :-1] = Tt[:, 1:]
    want_fhi[:, :-1] = fzt[:, 1:]
    assert torch.equal(torch.where(k > 0, lo, zero), want_lo)
    assert torch.equal(torch.where(k + 1 < nz, hi, zero), want_hi)
    assert torch.equal(torch.where(k + 1 < nz, fhi, zero), want_fhi)


def _zl(a, dtype):
    """A natural array moved z-leading, (z, x, y), as the JAX kernel takes
    its streams."""
    return jnp.moveaxis(jnp.asarray(a, _jd(dtype)), 2, 0)


@functools.lru_cache(maxsize=None)
def _k19_ref(name, dtype):
    """A K19 case on a (3, 5, n) field and its JAX solution."""
    n, film, edges = K19_CASES[name]
    case = _case((3, 5, n), 2, seed=50 + n, edges_m=edges)
    mask, _, _, _, fz, w, h, _, rhs = case
    ref = jpv.fused_varprop_sweep(
        jnp.asarray(rhs, _jd(dtype)), j_sweep_code(jnp.asarray(mask), None, 2),
        _zl(fz, dtype), _zl(w, dtype), TG, SK, TINF,
        h=_zl(h, dtype) if film == "h_stream" else None, rob_c=ROB,
        interpret=True, nat_rhs_out=True)
    return case, film, np.asarray(ref)


@DTYPES
@pytest.mark.parametrize("name", list(K19_CASES))
@CHUNKS
def test_k19_split_model_matches_jax(chunks, name, dtype):
    """K19's rows from the staged tiles chunk by chunk (the upper face in
    the next slot), the split solve, against JAX ``fused_varprop_sweep``
    in its natural-z form (interpret mode) and the plain version;
    "edges32": void gaps and isolated cells on the edges of 8-row
    chunks."""
    case, film, ref = _k19_ref(name, dtype)
    mask, _, _, _, fz, w, h, _, rhs = case
    code = sweep_code(torch.from_numpy(mask), None, 2).movedim(0, 2) \
        .contiguous()
    t = (lambda a: _t(a, dtype))
    hv = t(h) if film == "h_stream" else None
    zf = (lambda x: x.movedim(2, 0))
    m = _chunk(mask.shape[2], chunks)
    rows = k19_rows(zf(t(rhs)), zf(code), zf(t(fz)), zf(t(w)),
                    None if hv is None else zf(hv), ROB, m)
    assert all(bool(torch.isfinite(r).all()) for r in rows)
    got = split_solve(*rows, m).movedim(0, 2)
    plain = varprop_sweep_z_plain(t(rhs), code, t(fz), t(w), TG, SK, TINF,
                                  h=hv, rob_c=ROB)
    _within(got, torch.from_numpy(ref), dtype)
    _within(got, plain, dtype)


def test_k6_and_k19_wrappers_on_cpu_take_the_plain_versions():
    """On CPU tensors the wrappers are their plain versions (the kernels
    have no CPU form) and launch nothing."""
    case, film, _ = _k6_ref("n27-h_stream", torch.float64)
    _, code, T, fx, fy, fz, w, h, _ = _k6_inputs(case, film, torch.float64)
    args = (T, code, fx, fy, fz, w, CW, INV_D2, TG, SK, TINF)
    before = (varprop_theta_sweep.launches, varprop_sweep_z.launches)
    assert torch.equal(varprop_theta_sweep(*args, h=h),
                       varprop_theta_sweep_plain(*args, h=h))
    code2 = sweep_code(torch.from_numpy(case[0]), None, 2).movedim(0, 2) \
        .contiguous()
    zargs = (T, code2, fz, w, TG, SK, TINF)
    assert torch.equal(varprop_sweep_z(*zargs, h=h),
                       varprop_sweep_z_plain(*zargs, h=h))
    assert (varprop_theta_sweep.launches,
            varprop_sweep_z.launches) == before
