"""Kernel build and the dispatch rule shared by every kernel wrapper.

The rule: a CPU tensor goes to the kernel's plain PyTorch version; a CUDA
tensor goes to the hand-written kernel, or the wrapper raises.  No wrapper
falls back from a failed build or launch to the plain version.  The
wrappers themselves are forward only: called under grad mode with an input
that requires grad, a wrapper raises, so autograd never stops unseen at a
kernel.  Gradients go through the autograd Functions of
``solvers/differentiable.py``, whose forward calls the wrappers with grad
mode off and whose backward is the hand-derived pullback (transposed
solves on K21 and K22, the stencil on K3).
"""
from __future__ import annotations

import torch

from .build import build_library, load_library

__all__ = ["use_kernel", "check_kernel_inputs", "check_vectors", "dtype_code",
           "raise_on_error", "ptr", "stream_ptr", "build_library",
           "load_library", "FLOAT_DTYPES", "STATE_DTYPES", "compute_dtype"]

# field types of the kernels: every kernel takes float32 and float64; the
# kernels with a bfloat16 entry (K1-K7, K19, K20, K23-K26) also take
# bfloat16 states, solved at float32 (csrc/common.cuh ATF_DISPATCH_STATE)
FLOAT_DTYPES = (torch.float32, torch.float64)
STATE_DTYPES = FLOAT_DTYPES + (torch.bfloat16,)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The solve's type for a field type: float32 for bfloat16."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def use_kernel(*tensors: torch.Tensor | None) -> bool:
    """True when the inputs lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (run the plain version).  Raises for inputs on
    different devices, on any other device type, or requiring grad while
    grad mode is on (inside an autograd Function's forward it is off)."""
    ts = [t for t in tensors if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "the kernel wrappers are forward only: an input requires grad, "
            "and autograd would stop silently at the kernel (differentiate "
            "through solvers/differentiable.py)")
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev}")


def check_kernel_inputs(name: str, ref: torch.Tensor,
                        code: torch.Tensor | None,
                        *fields: torch.Tensor | None,
                        dtypes: tuple = FLOAT_DTYPES) -> None:
    """Validate what the CUDA kernels take: a contiguous ``ref`` of one of
    ``dtypes``, a contiguous uint8 ``code`` of its shape (None for a kernel
    without one), and optional fields of its dtype and shape."""
    if ref.dtype not in dtypes:
        raise TypeError(f"{name}: field dtype {ref.dtype} is not supported "
                        f"({', '.join(str(d) for d in dtypes)})")
    if code is not None and code.dtype != torch.uint8:
        raise TypeError(f"{name}: code must be uint8, got {code.dtype}")
    for label, t, dtype in (("field", ref, ref.dtype),
                            *((("code", code, torch.uint8),)
                              if code is not None else ()),
                            *(("input", f, ref.dtype) for f in fields
                              if f is not None)):
        if t.shape != ref.shape:
            raise ValueError(f"{name}: {label} shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} dtype {t.dtype} != {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def check_vectors(name: str, ref: torch.Tensor, n: int,
                  *vecs: torch.Tensor) -> None:
    """Validate per-row vectors: contiguous, shape (n,), ``ref``'s dtype."""
    for v in vecs:
        if v.shape != (n,) or v.dtype != ref.dtype or not v.is_contiguous():
            raise ValueError(f"{name}: per-row vectors must be contiguous "
                             f"({n},) {ref.dtype}, got {tuple(v.shape)} "
                             f"{v.dtype}")


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' field-type code."""
    return {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}[dtype]


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, for the C entry points."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error for its launch."""
    if err != 0:
        msg = load_library().atf_error_string(err)
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{msg.decode() if msg else '?'}")
