"""Dome / Halfar test cases for the land-ice core (port of
mpas_tpu/cores/landice/init_dome.py).

ref: the MPAS land-ice compass `dome` test configuration and the Halfar
(1983) similarity solution used by the reference for SIA verification
(landice test suite; mpas_li_sia.F comments reference Halfar error stats).

halfar_thickness gives the exact SIA evolution of a parabolic-ish dome on a
flat bed with no accumulation for Glen exponent n=3:

  H(r,t) = H0 (t0/t)^(1/9) [1 - ((t0/t)^(1/18) r/R0)^(4/3)]^(3/7)
  t0 = (1/(18 Gamma)) (7/4)^3 R0^4 / H0^7,   Gamma = 2 A (rho g)^3 / 5
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.containers import resolve_device, to_host
from mpas_tpu_torch.cores.landice.config import LiConfig
from mpas_tpu_torch.cores.landice.core import make_grid, zero_state
from mpas_tpu_torch.mesh.mesh import Mesh


def halfar_t0(cfg: LiConfig, h0: float, r0: float) -> float:
    gamma = 2.0 * cfg.config_default_flowParamA \
        * (cfg.rho_ice * cfg.gravity) ** 3 / 5.0
    return (1.0 / (18.0 * gamma)) * (7.0 / 4.0) ** 3 * r0 ** 4 / h0 ** 7


def halfar_thickness(cfg: LiConfig, r, t: float, h0: float, r0: float):
    """Exact Halfar dome thickness at radius r and time t (t measured from
    the similarity origin; the initial condition is t = t0). Host numpy."""
    t0 = halfar_t0(cfg, h0, r0)
    tt = (t0 / t)
    inner = 1.0 - (tt ** (1.0 / 18.0) * (r / r0)) ** (4.0 / 3.0)
    return h0 * tt ** (1.0 / 9.0) * np.maximum(inner, 0.0) ** (3.0 / 7.0)


def init_halfar(mesh: Mesh, cfg: LiConfig, h0: float = 2000.0,
                r0: float = 60000.0, dtype=torch.float64, device=None):
    """Halfar dome centered on the domain; flat bed. Returns (grid, state,
    t0) on `device` (cuda:0 when None) in `dtype`; the thickness is
    computed in host numpy float64, as the reference computes it."""
    device = resolve_device(device)
    grid = make_grid(mesh, cfg).to(device, dtype)
    state = zero_state(mesh, cfg, dtype=dtype, device=device)
    x = to_host(mesh.xCell)
    y = to_host(mesh.yCell)
    xc, yc = 0.5 * (x.min() + x.max()), 0.5 * (y.min() + y.max())
    r = np.sqrt((x - xc) ** 2 + (y - yc) ** 2)
    t0 = halfar_t0(cfg, h0, r0)
    h = halfar_thickness(cfg, r, t0, h0, r0)
    thickness = torch.as_tensor(h, dtype=dtype, device=device)
    return grid, dataclasses.replace(state, thickness=thickness), t0
