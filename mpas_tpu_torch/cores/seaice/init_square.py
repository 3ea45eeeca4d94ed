"""Idealized square-domain sea-ice test case (port of
mpas_tpu/cores/seaice/init_square.py).

ref capability: the MPAS-seaice testing configurations
(testing_and_setup/seaice) run idealized square domains with prescribed
anticyclonic winds and ocean currents: the CICE "box" experiment of the
EVP rheology and the transport. A slab of ice of linearly varying
thickness, no initial motion, a rotating wind field, a slowly circulating
ocean. The host numpy is the reference's, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.containers import resolve_device, to_host
from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.state import (SeaiceForcing, make_grid,
                                               zero_state)
from mpas_tpu_torch.mesh.mesh import Mesh


def init_square(mesh: Mesh, cfg: SeaiceConfig, dtype=torch.float64,
                device=None):
    """(grid, state, forcing) of the box in `dtype` on `device` (cuda:0
    when None); the grid has the weak scheme's geometry only (make_grid
    with variational=True adds the variational tensors)."""
    device = resolve_device(device)
    grid = make_grid(mesh).to(device, dtype)
    n_cat = cfg.config_n_categories
    state = zero_state(mesh, n_cat, dtype=dtype, device=device)

    x = to_host(mesh.xCell)
    y = to_host(mesh.yCell)
    lx = float(x.max() - x.min()) + 1e-30
    ly = float(y.max() - y.min()) + 1e-30
    xs = (x - x.min()) / lx
    ys = (y - y.min()) / ly

    # ice cover: full concentration, thickness ramp 0.5m..2.5m across x
    h = 0.5 + 2.0 * xs
    a_tot = np.where(xs < 0.95, 1.0, 0.0)   # open water strip at east edge
    bounds = np.asarray(cfg.config_itd_bounds)
    cat = np.clip(np.searchsorted(bounds[1:-1], h), 0, n_cat - 1)
    a = np.zeros((mesh.nCells, n_cat))
    v = np.zeros((mesh.nCells, n_cat))
    a[np.arange(mesh.nCells), cat] = a_tot
    v[np.arange(mesh.nCells), cat] = a_tot * h
    snow = 0.1 * a

    def t(arr):
        return torch.as_tensor(arr, dtype=dtype, device=device)

    state = dataclasses.replace(
        state, iceAreaCategory=t(a), iceVolumeCategory=t(v),
        snowVolumeCategory=t(snow), surfaceTemperature=t(-5.0 * a))

    # anticyclonic wind (CICE box forcing), static here
    ua = 5.0 + 3.0 * np.sin(2.0 * np.pi * xs) * np.sin(np.pi * ys)
    va = 5.0 + 3.0 * np.sin(2.0 * np.pi * ys) * np.sin(np.pi * xs)
    # quiescent, slightly circulating ocean
    uo = 0.1 * (2.0 * ys - 1.0)
    vo = -0.1 * (2.0 * xs - 1.0)

    zc = np.zeros(mesh.nCells)
    zv = np.zeros(mesh.nVertices)
    forcing = SeaiceForcing(
        uAirVelocity=t(ua), vAirVelocity=t(va),
        airTemperature=t(zc - 10.0), shortwaveDown=t(zc + 50.0),
        longwaveDown=t(zc + 250.0), uOceanVelocity=t(uo),
        vOceanVelocity=t(vo),
        seaSurfaceTemperature=t(zc + cfg.freezing_point),
        oceanHeatFlux=t(zc + cfg.config_ocean_heat_flux),
        sshGradientU=t(zv), sshGradientV=t(zv))
    return grid, state, forcing
