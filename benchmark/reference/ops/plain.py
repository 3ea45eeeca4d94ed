"""The two hand kernels of the port in plain PyTorch: K2's per-cell
contraction as an einsum and K1's acoustic column update with a plain
Thomas solve (frozen copies of the port's plain versions).

`tinydot` takes the precision of the control run: inside `round_tf32`,
both operands are rounded to TF32 (10 mantissa bits, round to nearest
even) before an f32 accumulation, what a tensor-core TF32 contraction
computes, and cuBLAS may use TF32 for the other float32 products.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference.ops.vscan import thomas_solve

_TF32 = {"on": False}


def to_tf32(x):
    """x (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def round_tf32():
    """Inside the block, K2 contractions computed as TF32, and cuBLAS
    allowed TF32 for every other float32 matrix product."""
    saved = torch.backends.cuda.matmul.allow_tf32
    _TF32["on"] = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        _TF32["on"] = False
        torch.backends.cuda.matmul.allow_tf32 = saved


def tinydot(w, x):
    """out[c, p, :] = sum_i w[c, p, i] * x[c, i, :]."""
    if _TF32["on"] and w.dtype == torch.float32:
        w, x = to_tf32(w), to_tf32(x)
    return torch.einsum("cpi,cik->cpk", w, x)


def acoustic_cell_update(nz: int, epssm: float, dts, rs_pre, ts_pre,
                         rw_p0, wwavg0, tend_rw, rho_pp0, rtheta_pp0,
                         cofwz, cofwr, cofwt, coftz, cofrz, rdzw,
                         a_tri, alpha_tri, gamma_tri, zz, dss_int,
                         dw_term, wdamp):
    """The vertically implicit acoustic column update."""
    resm = (1.0 - epssm) / (1.0 + epssm)
    rs = rs_pre - cofrz * resm * (rw_p0[:, 1:] - rw_p0[:, :-1])
    ts = ts_pre - resm * rdzw * (coftz[:, 1:] * rw_p0[:, 1:]
                                 - coftz[:, :-1] * rw_p0[:, :-1])
    wwavg = wwavg0 + F.pad(0.5 * (1.0 - epssm) * rw_p0[:, 1:nz], (1, 1))

    zz_ts = zz * ts
    zz_rt = zz * rtheta_pp0
    rhs_mid = rw_p0[:, 1:nz] + dts * tend_rw[:, 1:nz] \
        - cofwz[:, 1:nz] * ((zz_ts[:, 1:] - zz_ts[:, :-1])
                            + resm * (zz_rt[:, 1:] - zz_rt[:, :-1])) \
        - cofwr[:, 1:nz] * ((rs[:, 1:] + rs[:, :-1])
                            + resm * (rho_pp0[:, 1:] + rho_pp0[:, :-1])) \
        + cofwt[:, 1:] * (ts[:, 1:] + resm * rtheta_pp0[:, 1:]) \
        + cofwt[:, :-1] * (ts[:, :-1] + resm * rtheta_pp0[:, :-1])
    sol = thomas_solve(rhs_mid, a_tri[:, 1:nz], alpha_tri[:, 1:nz],
                       gamma_tri[:, 1:nz])

    dss = dss_int[:, 1:nz]
    dw = dw_term[:, 1:nz]
    rw_mid = ((sol + dw - dts * dss * wdamp[:, 1:nz]) / (1.0 + dts * dss)) \
        - dw
    rw_p = F.pad(rw_mid, (1, 1))
    wwavg = wwavg + F.pad(0.5 * (1.0 + epssm) * rw_mid, (1, 1))
    rho_pp = rs - cofrz * (rw_p[:, 1:] - rw_p[:, :-1])
    rtheta_pp = ts - rdzw * (coftz[:, 1:] * rw_p[:, 1:]
                             - coftz[:, :-1] * rw_p[:, :-1])
    return rw_p, rho_pp, rtheta_pp, wwavg
