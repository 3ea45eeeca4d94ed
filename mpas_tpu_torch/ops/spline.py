"""Cubic spline interpolation of vertical columns (port of
mpas_tpu/ops/spline.py).

ref: src/operators/mpas_spline_interpolation.F (mpas_cubic_spline_coefficients
:112, mpas_interpolate_cubic_spline :271). Natural cubic splines; the
tridiagonal solve is a Python loop over the node count, vectorized over
leading batch dims, so whole fields of columns interpolate at once.
"""

from __future__ import annotations

import torch


def cubic_spline_coefficients(x, y):
    """Second derivatives y2 at nodes for natural cubic splines.

    x: (n,) strictly increasing nodes (may be batched: (..., n));
    y: (..., n). ref: mpas_cubic_spline_coefficients :112."""
    n = x.shape[-1]
    h = x[..., 1:] - x[..., :-1]
    # tridiagonal system for y2[1..n-2]; natural BCs y2[0]=y2[n-1]=0
    a = h[..., :-1] / 6.0
    b = (h[..., :-1] + h[..., 1:]) / 3.0
    c = h[..., 1:] / 6.0
    d = (y[..., 2:] - y[..., 1:-1]) / h[..., 1:] \
        - (y[..., 1:-1] - y[..., :-2]) / h[..., :-1]
    m = n - 2
    # Thomas algorithm
    cp = [None] * m
    dp = [None] * m
    cp[0] = c[..., 0] / b[..., 0]
    dp[0] = d[..., 0] / b[..., 0]
    for i in range(1, m):
        den = b[..., i] - a[..., i] * cp[i - 1]
        cp[i] = c[..., i] / den
        dp[i] = (d[..., i] - a[..., i] * dp[i - 1]) / den
    sol = [None] * m
    sol[m - 1] = dp[m - 1]
    for i in range(m - 2, -1, -1):
        sol[i] = dp[i] - cp[i] * sol[i + 1]
    zero = torch.zeros_like(y[..., :1])
    return torch.cat([zero] + [s[..., None] for s in sol] + [zero], dim=-1)


def interpolate_cubic_spline(x, y, y2, x_eval):
    """Evaluate the spline at x_eval (..., k); x: (n,) nodes.
    ref: mpas_interpolate_cubic_spline :271."""
    n = x.shape[-1]
    idx = (torch.searchsorted(x, x_eval, right=True) - 1).clamp(0, n - 2)
    x0 = x[idx]
    x1 = x[idx + 1]
    h = x1 - x0
    a = (x1 - x_eval) / h
    b = (x_eval - x0) / h
    y0 = y[..., idx]
    y1 = y[..., idx + 1]
    s0 = y2[..., idx]
    s1 = y2[..., idx + 1]
    return (a * y0 + b * y1
            + ((a ** 3 - a) * s0 + (b ** 3 - b) * s1) * (h * h) / 6.0)


def interpolate_linear(x, y, x_eval):
    """Piecewise-linear interpolation, constant beyond the ends (ref:
    mpas_linear_interp :438; jnp.interp's arithmetic)."""
    n = x.shape[-1]
    i = torch.searchsorted(x, x_eval, right=True).clamp(1, n - 1)
    f = y[i - 1] + ((x_eval - x[i - 1]) / (x[i] - x[i - 1])) \
        * (y[i] - y[i - 1])
    f = torch.where(x_eval < x[0], y[0], f)
    return torch.where(x_eval > x[-1], y[-1], f)
