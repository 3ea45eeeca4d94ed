# Frozen copy of mpas_tpu_torch/ops/vscan.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Per-column tridiagonal recurrences (port of mpas_tpu/ops/vscan.py).

The reference package runs these as O(log nz) associative scans only
because its levels sit in TPU vector lanes. Here they are the plain
sequential sweeps of the Fortran (ref: atm_compute_vert_imp_coefs_work,
mpas_atm_time_integration.F:2092-2121; atm_advance_acoustic_step_work
:2596-2604), vectorized over columns and looping over the last (level) axis.
"""

from __future__ import annotations

import torch


def thomas_prefactor(a_mid, b_mid, c_mid):
    """LU prefactor of a tridiagonal system (interior rows only):
      alpha[i] = 1 / (b[i] - a[i] * gamma[i-1]),  gamma[-1] = 0
      gamma[i] = c[i] * alpha[i]
    Returns (alpha, gamma)."""
    alpha = torch.empty_like(a_mid)
    gamma = torch.empty_like(a_mid)
    g = torch.zeros_like(a_mid[..., 0])
    for i in range(a_mid.shape[-1]):
        al = 1.0 / (b_mid[..., i] - a_mid[..., i] * g)
        g = c_mid[..., i] * al
        alpha[..., i] = al
        gamma[..., i] = g
    return alpha, gamma


def thomas_solve(rhs_mid, a_mid, alpha_mid, gamma_mid):
    """Pre-factored tridiagonal solve on interior rows (boundary rows are
    identity with zero RHS, as in the acoustic w-solve):
      forward:  y[i] = (-a[i] * alpha[i]) * y[i-1] + rhs[i] * alpha[i]
      backward: x[i] = -gamma[i] * x[i+1] + y[i]"""
    n = rhs_mid.shape[-1]
    fa = -a_mid * alpha_mid
    fb = rhs_mid * alpha_mid
    x = torch.empty_like(rhs_mid)
    y = torch.zeros_like(rhs_mid[..., 0])
    for i in range(n):
        y = fa[..., i] * y + fb[..., i]
        x[..., i] = y
    s = torch.zeros_like(y)
    for i in reversed(range(n)):
        s = -gamma_mid[..., i] * s + x[..., i]
        x[..., i] = s
    return x
