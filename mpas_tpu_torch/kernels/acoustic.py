"""K1: acoustic-substep column update (CUDA source: csrc/acoustic.cu).

Replaces the Pallas kernel mpas_tpu/kernels/acoustic.py:acoustic_cell_update
with the same signature: the cell-local half of one forward-backward
acoustic substep (rs/ts corrections, implicit-w right-hand side, Thomas
solve, Rayleigh w-damping, rho_pp/rtheta_pp back-substitution, wwAvg).

All cell arrays are (nC, nz) or (nC, nz+1); cofrz/rdzw are (nz,).
rs_pre/ts_pre already hold rho_pp0 + dts*tend + flux; wdamp holds
zz_int * rho_int * w. Returns (rw_p, rho_pp, rtheta_pp, wwAvg).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels.build import check_launch, load_library
from mpas_tpu_torch.ops.vscan import thomas_solve

_LEVEL = ("rs_pre", "ts_pre", "rho_pp0", "rtheta_pp0", "cofwt", "zz")
_INTERFACE = ("rw_p0", "wwavg0", "tend_rw", "cofwz", "cofwr", "coftz",
              "a_tri", "alpha_tri", "gamma_tri", "dss_int", "dw_term",
              "wdamp")
_COLUMN = ("cofrz", "rdzw")
# the order of the C entry point's input pointers
_ORDER = ("rs_pre", "ts_pre", "rw_p0", "wwavg0", "tend_rw", "rho_pp0",
          "rtheta_pp0", "cofwz", "cofwr", "cofwt", "coftz", "cofrz", "rdzw",
          "a_tri", "alpha_tri", "gamma_tri", "zz", "dss_int", "dw_term",
          "wdamp")


def example_args(nc: int, nz: int, seed: int = 0):
    """Seeded K1 arguments (numpy float64) for checks of the kernel against
    its plain version: a diagonally dominant tridiagonal factor with the
    zero boundary rows of the real coefficients."""
    rng = np.random.default_rng(seed)
    lev, itf = (nc, nz), (nc, nz + 1)
    u = rng.uniform
    args = dict(rs_pre=u(-1, 1, lev), ts_pre=u(-1, 1, lev),
                rw_p0=u(-1, 1, itf), wwavg0=u(-1, 1, itf),
                tend_rw=u(-1, 1, itf), rho_pp0=u(-1, 1, lev),
                rtheta_pp0=u(-1, 1, lev), cofwz=u(-1, 1, itf),
                cofwr=u(-1, 1, itf), cofwt=u(-1, 1, lev),
                coftz=u(-1, 1, itf), cofrz=u(-1, 1, nz), rdzw=u(-1, 1, nz),
                a_tri=u(-0.2, 0.2, itf), alpha_tri=u(0.8, 1.2, itf),
                gamma_tri=u(-0.2, 0.2, itf), zz=u(0.5, 1.5, lev),
                dss_int=u(0, 1, itf), dw_term=u(-1, 1, itf),
                wdamp=u(-1, 1, itf))
    for k in ("a_tri", "alpha_tri", "gamma_tri"):
        args[k][:, 0] = args[k][:, nz] = 0.0
    return args


def acoustic_cell_update_plain(nz: int, epssm: float, dts, rs_pre, ts_pre,
                               rw_p0, wwavg0, tend_rw, rho_pp0, rtheta_pp0,
                               cofwz, cofwr, cofwt, coftz, cofrz, rdzw,
                               a_tri, alpha_tri, gamma_tri, zz, dss_int,
                               dw_term, wdamp):
    """Plain PyTorch version: the math of the reference's jnp branch
    (mpas_tpu/cores/atmosphere/nhyd.py:986-1040) on the kernel's arguments."""
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


def acoustic_cell_update(nz: int, epssm: float, dts, rs_pre, ts_pre, rw_p0,
                         wwavg0, tend_rw, rho_pp0, rtheta_pp0, cofwz, cofwr,
                         cofwt, coftz, cofrz, rdzw, a_tri, alpha_tri,
                         gamma_tri, zz, dss_int, dw_term, wdamp):
    """K1 for CUDA tensors; the plain version for CPU tensors."""
    args = dict(rs_pre=rs_pre, ts_pre=ts_pre, rw_p0=rw_p0, wwavg0=wwavg0,
                tend_rw=tend_rw, rho_pp0=rho_pp0, rtheta_pp0=rtheta_pp0,
                cofwz=cofwz, cofwr=cofwr, cofwt=cofwt, coftz=coftz,
                cofrz=cofrz, rdzw=rdzw, a_tri=a_tri, alpha_tri=alpha_tri,
                gamma_tri=gamma_tri, zz=zz, dss_int=dss_int,
                dw_term=dw_term, wdamp=wdamp)
    if rs_pre.device.type == "cpu":
        return acoustic_cell_update_plain(nz, epssm, dts, **args)
    if rs_pre.device.type != "cuda":
        raise ValueError(f"acoustic_cell_update: no kernel for device "
                         f"{rs_pre.device}")
    if nz < 2:
        raise ValueError(f"acoustic_cell_update: nz={nz} < 2")
    nc = rs_pre.shape[0]
    dtype = rs_pre.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"acoustic_cell_update: unsupported dtype {dtype}")
    shapes = {**{n: (nc, nz) for n in _LEVEL},
              **{n: (nc, nz + 1) for n in _INTERFACE},
              **{n: (nz,) for n in _COLUMN}}
    for name, t in args.items():
        if t.device != rs_pre.device or t.dtype != dtype:
            raise ValueError(f"acoustic_cell_update: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on "
                             f"{rs_pre.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"acoustic_cell_update: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"acoustic_cell_update: {name} is not "
                             "contiguous")

    outs = (torch.empty((nc, nz + 1), dtype=dtype, device=rs_pre.device),
            torch.empty((nc, nz), dtype=dtype, device=rs_pre.device),
            torch.empty((nc, nz), dtype=dtype, device=rs_pre.device),
            torch.empty((nc, nz + 1), dtype=dtype, device=rs_pre.device))
    ins = (ctypes.c_void_p * len(_ORDER))(
        *[args[n].data_ptr() for n in _ORDER])
    ptr_out = (ctypes.c_void_p * 4)(*[o.data_ptr() for o in outs])
    lib = load_library().lib
    fn = (lib.mpas_acoustic_cell_update_f32 if dtype == torch.float32
          else lib.mpas_acoustic_cell_update_f64)
    stream = torch.cuda.current_stream(rs_pre.device).cuda_stream
    check_launch(fn(rs_pre.device.index, nc, nz, float(epssm), float(dts),
                    ins, ptr_out, stream), "acoustic_cell_update")
    kernels.launch_counts["acoustic_cell_update"] += 1
    return outs
