"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` compiles every source in ``csrc/`` to an object, one nvcc per
source, all started together; ``nvcc -shared`` links them into ONE shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers: the build takes seconds).  The library lands in
``build/torch_kernels/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  A missing ``nvcc`` or a failed compile raises with the compiler's
output; nothing falls back.

Nothing here runs at import: the CPU test suite imports every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "build_library",
           "load_library"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_double
_DP = ctypes.POINTER(ctypes.c_double)     # a property table's host buffer

# C entry points: (argtypes, restype)
_SIGNATURES = {
    "atf_varprop_fields": ([_I, _I, *[_P] * 7, _I64, _I64, _I64, _DP, _I,
                            _DP, _I, *[_D] * 5, _P], _I),
    "atf_varprop_theta_sweep": ([_I, _I, *[_P] * 9, _I64, _I64, _I64,
                                 *[_D] * 9, _I64, _P], _I),
    "atf_varprop_sweep_strided": ([_I, _I, *[_P] * 6, _I64, _I64, _I64,
                                   *[_D] * 4, _I64, _P], _I),
    "atf_varprop_theta_rhs": ([_I, _I, *[_P] * 8, _I64, _I64, _I64,
                               *[_D] * 5, _I64, _P], _I),
    "atf_varprop_sweep_z": ([_I, _I, *[_P] * 6, _I64, _I64, *[_D] * 4,
                             _I64, _P], _I),
    "atf_tridiag_fields_strided": ([_I, _I, *[_P] * 5, _I64, _I64, _I64, _P],
                                   _I),
    "atf_tridiag_fields_z": ([_I, _I, *[_P] * 6, _I64, _I64, _P], _I),
    "atf_cyclic_fields": ([_I, _I, *[_P] * 5, _I64, _I64, _I64, _P], _I),
    "atf_vp2_sweep_z": ([_I, _I, *[_P] * 4, _I64, _I64, _DP, _I, _DP, _I,
                         *[_D] * 8, _I, _P], _I),
    "atf_sweep_strided": ([_I, _I, *[_P] * 6, _I64, _I64, _I64, *[_D] * 4,
                           _I64, _I, _I, _P], _I),
    "atf_sweep_z": ([_I, _I, *[_P] * 6, _I64, _I64, *[_D] * 4, _I64, _P],
                    _I),
    "atf_theta_rhs": ([_I, _I, _P, _P, _P, _I64, _I64, _I64, *[_D] * 4,
                       _I64, _P], _I),
    "atf_theta_sweep": ([_I, _I, *[_P] * 3, _I64, _I64, _I64, *[_D] * 8,
                         _I64, _P], _I),
    "atf_gstream_fields": ([_I, _I, *[_P] * 14, _I64, _I64, _I64, _DP, _I,
                            _DP, _I, *[_D] * 12, _I, _P], _I),
    "atf_gstream_theta_sweep": ([_I, _I, *[_P] * 10, _I64, _I64, _I64, _D,
                                 _D, _I64, _P], _I),
    "atf_gstream_sweep_strided": ([_I, _I, *[_P] * 5, _I64, _I64, _I64, _D,
                                   _I64, _P], _I),
    "atf_gstream_sweep_z": ([_I, _I, *[_P] * 6, _I64, _I64, _D, _I64, _P],
                            _I),
    "atf_masked_sweep_strided": ([_I, _I, *[_P] * 7, _I64, _I64, _D, _D,
                                  _P], _I),
    "atf_masked_sweep_z": ([_I, _I, *[_P] * 8, _I64, _I64, _D, _D, _P], _I),
    "atf_masked_cyclic_phi": ([_I, _I, *[_P] * 6, _I64, _I64, _I64, _D, _D,
                               _P], _I),
    "atf_const_sweep_strided": ([_I, _I, *[_P] * 5, _I64, _I64, _P], _I),
    "atf_const_sweep_z": ([_I, _I, *[_P] * 5, _I64, _I64, _P], _I),
    "atf_const_sweep_table": ([_I, _I, *[_P] * 4, _I64, _P], _I),
    "atf_cyclic_const_phi": ([_I, _I, *[_P] * 4, _I64, _I64, _I64, _P], _I),
    "atf_cyclic_const_table": ([_I, _I, _P, _P, _I64, _I64, _P], _I),
    "atf_vp2_sweep_strided": ([_I, _I, *[_P] * 8, _I64, _I64, _I64, _DP, _I,
                               _DP, _I, *[_D] * 7, _I, _DP, _P], _I),
    "atf_vp2_sweep_z_general": ([_I, _I, *[_P] * 9, _I64, _I64, _DP, _I,
                                 _DP, _I, *[_D] * 7, _I, _DP, _P], _I),
    "atf_vp2_cyclic_phi": ([_I, _I, *[_P] * 6, _I64, _I64, _I64, _DP, _I,
                            _DP, _I, *[_D] * 6, _I, _P], _I),
    "atf_vp_fields_sweep_strided": ([_I, _I, *[_P] * 8, _I64, _I64, _I64,
                                     _P], _I),
    "atf_vp_fields_sweep_z": ([_I, _I, *[_P] * 9, _I64, _I64, _P], _I),
    "atf_vp_fields_cyclic_phi": ([_I, _I, *[_P] * 7, _I64, _I64, _I64, _P],
                                 _I),
    "atf_error_string": ([_I], ctypes.c_char_p),
}


def build_dir() -> Path:
    """``build/torch_kernels/`` beside the package (listed in .gitignore)."""
    return _PKG.parent / "build" / "torch_kernels"


def _sources() -> list[Path]:
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def build_library(*, verbose: bool = False) -> tuple[Path, float]:
    """Compile csrc/*.cu into the hashed library unless it exists.
    Returns (path, build seconds; 0.0 when reused).  ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler output (registers, spills)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libatf_kernels_{_digest()}.so"
    if lib.exists() and not verbose:
        return lib, 0.0
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        # one nvcc per source, all running at once
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(work, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS,
                   *(["-Xptxas", "-v"] if verbose else []), "-I",
                   str(_CSRC), "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report = [_finish(cmd, *proc.communicate(), proc.returncode)
                  for cmd, _, proc in jobs]
        tmp = os.path.join(work, "lib.so")
        link = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        _finish(link, proc.stdout, proc.stderr, proc.returncode)
        if verbose:
            print("".join(report), flush=True)
        os.replace(tmp, lib)   # atomic: a concurrent build sees no partial
    return lib, time.perf_counter() - t0


def _finish(cmd: list, out: str, err: str, rc: int) -> str:
    """The output of one nvcc run; raises with it when the run failed."""
    if rc != 0:
        raise RuntimeError(f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n"
                           f"{out}\n{err}")
    return out + err


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with every entry point's
    argument and result types declared."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
