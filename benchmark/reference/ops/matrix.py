# Frozen copy of mpas_tpu_torch/ops/matrix.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Small-matrix utilities (port of mpas_tpu/ops/matrix.py).

ref: src/operators/mpas_matrix_operations.F (rotations, Gaussian
elimination mpas_migs/mpas_elgs :456,501). The tridiagonal solve is the
Thomas algorithm over the last axis, one Python step per level,
vectorized over the leading (column) axes. Its boundary rows are general,
unlike the interior-row solves of ops/vscan.py.
"""

from __future__ import annotations

import torch


def rotation_matrix_2d(theta):
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def rotation_about_axis_3d(axis, theta):
    """Rodrigues rotation matrix about a unit axis."""
    axis = axis / torch.linalg.norm(axis)
    x, y, z = axis[0], axis[1], axis[2]
    theta = torch.as_tensor(theta, dtype=axis.dtype, device=axis.device)
    c, s = torch.cos(theta), torch.sin(theta)
    C = 1.0 - c
    rows = [[c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C]]
    return torch.stack([torch.stack(r) for r in rows])


def solve_linear(A, b):
    """Dense solve (mpas_migs equivalent); batched over leading dims."""
    return torch.linalg.solve(A, b)


def tridiagonal_solve(a, b, c, d):
    """Thomas algorithm over the last axis, batched.
    a: sub-diagonal (first entry unused), b: diagonal, c: super-diagonal
    (last entry unused), d: rhs."""
    n = d.shape[-1]
    cp = [None] * n
    dp = [None] * n
    cp[0] = c[..., 0] / b[..., 0]
    dp[0] = d[..., 0] / b[..., 0]
    for i in range(1, n):
        den = b[..., i] - a[..., i] * cp[i - 1]
        # the last row has no super-diagonal: its cp is never read
        cp[i] = c[..., i] / den if i < n - 1 else None
        dp[i] = (d[..., i] - a[..., i] * dp[i - 1]) / den
    out = [None] * n
    out[n - 1] = dp[n - 1]
    for i in range(n - 2, -1, -1):
        out[i] = dp[i] - cp[i] * out[i + 1]
    return torch.stack(out, dim=-1)
