"""Batched tridiagonal (Thomas) solves: the plain solves under every kernel.

Counterpart: ``adi_thermal_fields_tpu/solvers/thomas.py`` — ``thomas`` (a
``lax.scan``), ``thomas_along_axis`` (:58) and ``cyclic_thomas`` (:67, the
periodic solve).  Here a Python loop runs over the line and each
iteration is a few tensor ops vectorized over the batch — on any device.
It is the solve inside the plain version of every sweep kernel and inside
the reference step (step/cartesian.py).

Conventions: for systems ``a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]``
along axis 0, ``a[0]`` and ``c[n-1]`` are ignored (treated as zero).
"""
from __future__ import annotations

import torch

__all__ = ["thomas", "thomas_along_axis", "cyclic_thomas"]


def thomas(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           d: torch.Tensor, *, reciprocal: bool = False) -> torch.Tensor:
    """Solve tridiagonal systems along axis 0; trailing axes are batch.

    ``cp[i] = c[i]/(b[i]-a[i]*cp[i-1])``,
    ``dp[i] = (d[i]-a[i]*dp[i-1])/(b[i]-a[i]*cp[i-1])``, then
    ``x[i] = dp[i] - cp[i]*x[i+1]``.  ``reciprocal``: divide once per row,
    ``inv = 1/(b[i]-a[i]*cp[i-1])``, and multiply ``c[i]`` and
    ``d[i]-a[i]*dp[i-1]`` by it (the order of the JAX varprop kernels).
    The rows are gathered in lists and stacked once, so autograd runs
    through the solve (the JAX scan is differentiable too)."""
    n = d.shape[0]
    cp, dp = [], []
    cp_prev = torch.zeros_like(d[0])
    dp_prev = torch.zeros_like(d[0])
    for i in range(n):
        denom = b[i] - a[i] * cp_prev
        if reciprocal:
            inv = torch.reciprocal(denom)
            cp_prev = c[i] * inv
            dp_prev = (d[i] - a[i] * dp_prev) * inv
        else:
            cp_prev = c[i] / denom
            dp_prev = (d[i] - a[i] * dp_prev) / denom
        cp.append(cp_prev)
        dp.append(dp_prev)
    x = [None] * n
    x_next = torch.zeros_like(d[0])
    for i in range(n - 1, -1, -1):
        x_next = dp[i] - cp[i] * x_next
        x[i] = x_next
    return torch.stack(x)


def thomas_along_axis(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      d: torch.Tensor, axis: int) -> torch.Tensor:
    """Solve tridiagonal systems along an arbitrary axis of nd tensors."""
    if axis == 0:
        return thomas(a, b, c, d)
    mv = (lambda t: t.movedim(axis, 0))
    return thomas(mv(a), mv(b), mv(c), mv(d)).movedim(0, axis)


def cyclic_thomas(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  d: torch.Tensor) -> torch.Tensor:
    """Solve batched cyclic (periodic) tridiagonal systems along axis 0.

    Row 0 couples to x[n-1] by ``beta = a[0]`` and row n-1 to x[0] by
    ``alpha = c[n-1]`` (both zeroed inside the solve).  Sherman-Morrison
    with gauge ``g = -b[0]``: solve ``B y = d`` and ``B z = u`` with
    ``B = A - u v^T``, ``u = (g, 0, ..., alpha)``, ``v = (1, 0, ...,
    beta/g)``, then ``x = y - z (v^T y)/(1 + v^T z)``.  y and z come
    from one ``thomas`` call with the two right-hand sides side by side
    (the same operations per element, half the launches)."""
    n = d.shape[0]
    beta, alpha = a[0], c[n - 1]
    a = a.clone()
    c = c.clone()
    a[0] = 0.0
    c[n - 1] = 0.0
    gamma = -b[0]
    b_mod = b.clone()
    b_mod[0] = b[0] - gamma
    b_mod[n - 1] = b[n - 1] - alpha * beta / gamma
    u = torch.zeros_like(d)
    u[0] = gamma
    u[n - 1] = alpha
    yz = thomas(a[:, None], b_mod[:, None], c[:, None],
                torch.stack([d, u], 1))
    y, z = yz[:, 0], yz[:, 1]
    fact = ((y[0] + beta * y[n - 1] / gamma)
            / (1.0 + z[0] + beta * z[n - 1] / gamma))
    return y - fact[None] * z
