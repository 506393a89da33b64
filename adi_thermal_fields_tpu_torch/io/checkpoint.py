"""Checkpoint / resume for simulation runs: one compressed npz.

Counterpart: ``adi_thermal_fields_tpu/io/checkpoint.py`` — ``RunState``
(:21), ``save_checkpoint`` (:32) and ``load_checkpoint`` (:42), the npz
path, with the same keys (``T``, ``active``, ``t`` and ``meta_<name>`` per
meta entry).  A file written by either package loads in the other: the
format is how a run's state crosses between them.  The fields are numpy
arrays; a tensor is copied to the host first (bfloat16, which numpy lacks,
at float32).  The orbax variant of the JAX module (:49-66, sharded
multi-device state) waits for the port's multi-device layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["RunState", "save_checkpoint", "load_checkpoint", "to_numpy"]


def to_numpy(x) -> np.ndarray:
    """A tensor (any device; bfloat16 at float32) or array-like as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class RunState:
    """Resume is by simulation time: ``EventLoop.run(start_t=t)`` replays
    the schedule from ``t`` (births before it are already in ``active``),
    so no event cursor is stored."""

    T: Any                   # (nx, ny, nz) temperature field
    active: Any              # activation state (bool field or times array)
    t: float                 # simulation time [s]
    meta: dict | None = None


def save_checkpoint(path: str, state: RunState) -> None:
    np.savez_compressed(
        path,
        T=to_numpy(state.T),
        active=to_numpy(state.active),
        t=np.float64(state.t),
        **{f"meta_{k}": to_numpy(v) for k, v in (state.meta or {}).items()},
    )


def load_checkpoint(path: str) -> RunState:
    with np.load(path) as z:
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
        return RunState(T=z["T"], active=z["active"], t=float(z["t"]),
                        meta=meta or None)
