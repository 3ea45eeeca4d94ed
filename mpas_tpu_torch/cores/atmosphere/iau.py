"""Incremental analysis update, IAU (port of
mpas_tpu/cores/atmosphere/iau.py).

ref: src/core_atmosphere/dynamics/mpas_atm_iau.F (220 LoC):
atm_add_tend_anal_incr — spreads an analysis increment over the IAU window
as a constant tendency: tend_X += rho * dX_incr / T_window (for theta/u/qv;
rho-coupled for the flux variables). Active while the model time is inside
[start, start + config_IAU_window_length_s]. Like the reference, the time
integration does not call it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mpas_tpu_torch.containers import to_device


@dataclasses.dataclass(frozen=True)
class IAUConfig:
    # ref: config_IAU_option ('off'|'on') + config_IAU_window_length_s
    config_IAU_option: str = "off"
    config_IAU_window_length_s: float = 21600.0


@dataclasses.dataclass(frozen=True)
class IAUIncrements:
    """Analysis increments (analysis minus background) on model levels.
    ref: the lbc/iau input stream variables theta_amb/rho_amb/u_amb ..."""
    theta_incr: Any     # (nCells, nz)
    rho_incr: Any       # (nCells, nz)
    u_incr: Any         # (nEdges, nz)
    qv_incr: Any        # (nCells, nz) or None

    def to(self, device, dtype) -> "IAUIncrements":
        return to_device(self, device, dtype)


def iau_tendencies(cfg: IAUConfig, inc: IAUIncrements, rho_zz, elapsed_s):
    """Constant-in-window tendencies (ref: atm_add_tend_anal_incr).

    elapsed_s: a number or a 0-d tensor (compared on its device, with no
    read back to the host). Returns (tend_theta_flux, tend_rho, tend_u,
    tend_qv) — the theta tendency is rho-coupled like the reference's
    tend_rtheta contribution. All are zero outside the window."""
    w = cfg.config_IAU_window_length_s
    elapsed = torch.as_tensor(elapsed_s, device=rho_zz.device)
    inv = torch.full((), 1.0 / w, dtype=rho_zz.dtype, device=rho_zz.device)
    scale = torch.where(elapsed < w, inv, torch.zeros_like(inv))
    tend_rt = rho_zz * inc.theta_incr * scale
    tend_rho = inc.rho_incr * scale
    tend_u = inc.u_incr * scale
    tend_qv = None if inc.qv_incr is None else inc.qv_incr * scale
    return tend_rt, tend_rho, tend_u, tend_qv
