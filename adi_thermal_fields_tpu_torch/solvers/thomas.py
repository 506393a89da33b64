"""Batched tridiagonal (Thomas) solve: the plain solve under every kernel.

Counterpart: ``adi_thermal_fields_tpu/solvers/thomas.py::thomas`` (a
``lax.scan``).  Here a Python loop runs over the line and each iteration is
a few tensor ops vectorized over the batch — on any device.  It is the
solve inside the plain version of every sweep kernel and inside the
reference step (step/cartesian.py).

Conventions: for systems ``a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]``
along axis 0, ``a[0]`` and ``c[n-1]`` are ignored (treated as zero).
"""
from __future__ import annotations

import torch

__all__ = ["thomas"]


def thomas(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           d: torch.Tensor) -> torch.Tensor:
    """Solve tridiagonal systems along axis 0; trailing axes are batch.

    ``cp[i] = c[i]/(b[i]-a[i]*cp[i-1])``,
    ``dp[i] = (d[i]-a[i]*dp[i-1])/(b[i]-a[i]*cp[i-1])``, then
    ``x[i] = dp[i] - cp[i]*x[i+1]``."""
    n = d.shape[0]
    cp = torch.empty_like(d)
    dp = torch.empty_like(d)
    cp_prev = torch.zeros_like(d[0])
    dp_prev = torch.zeros_like(d[0])
    for i in range(n):
        denom = b[i] - a[i] * cp_prev
        torch.div(c[i], denom, out=cp[i])
        torch.div(d[i] - a[i] * dp_prev, denom, out=dp[i])
        cp_prev, dp_prev = cp[i], dp[i]
    x = torch.empty_like(d)
    x_next = torch.zeros_like(d[0])
    for i in range(n - 1, -1, -1):
        torch.sub(dp[i], cp[i] * x_next, out=x[i])
        x_next = x[i]
    return x
