"""Profiling hooks: torch.profiler traces and per-step timing.

Counterpart: ``adi_thermal_fields_tpu/io/profiling.py`` — ``trace`` (a
``jax.profiler`` trace) and ``StepTimer`` (:31).  Here ``trace`` wraps
``torch.profiler.profile`` with the CPU and CUDA activities and writes a
Chrome trace (viewable in Perfetto or chrome://tracing), and ``StepTimer``
synchronizes with ``torch.cuda.synchronize`` on the card and with nothing
on the CPU, where every op has completed when it returns.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str, *, name: str = "trace.json"):
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU ops,
    and CUDA kernels when a card is present) and write it as the Chrome
    trace ``logdir/name``.  Yields the profiler, whose ``key_averages()``
    tabulates the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, name))


class StepTimer:
    """Measure the steady-state per-step wall time of a step function."""

    def sync(self, x: torch.Tensor) -> None:
        """Wait for everything queued on ``x``'s device (a CUDA tensor:
        ``torch.cuda.synchronize``; a CPU tensor has completed)."""
        if torch.is_tensor(x) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    def time_steps(self, step_fn, x0, n_steps: int = 20, warmup: int = 1):
        """Returns (seconds_per_step, final_state).

        Measured as the SLOPE between a short (n/4) and a full (n) loop,
        as the JAX timer does: a fixed cost per synchronized timing (the
        launch queue's drain, a remote round trip) cancels exactly."""
        x = x0
        for _ in range(warmup):
            x = step_fn(x)
        self.sync(x)
        k_small = max(1, n_steps // 4)
        t0 = time.perf_counter()
        for _ in range(k_small):
            x = step_fn(x)
        self.sync(x)
        t_small = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_steps):
            x = step_fn(x)
        self.sync(x)
        t_big = time.perf_counter() - t0
        return (t_big - t_small) / (n_steps - k_small), x
