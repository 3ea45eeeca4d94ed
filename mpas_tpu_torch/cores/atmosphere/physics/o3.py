"""Ozone climatology for radiation (port of
mpas_tpu/cores/atmosphere/physics/o3.py).

ref capability: src/core_atmosphere/physics/mpas_atmphys_o3climatology.F
(the CAM monthly zonal-mean ozone climatology, interpolated in time to the
model date and vertically to model levels). The reference's data files are
not shipped; this is the same surface, o3_climatology(lat, p, julian_day)
-> ozone volume mixing ratio, from a compact analytic zonal-mean model:

  * a Chapman-layer vertical profile with latitude-dependent peak
    pressure (~10 hPa at the equator to ~30 hPa at the poles) and column
    amount (~260 DU at the equator, spring-hemisphere maxima ~380 DU)
  * an annual cycle: high-latitude spring maximum, opposite phase between
    the hemispheres

The vmr feeds rrtmg's ozone path (o3_path).
"""

from __future__ import annotations

import math

import torch


def o3_column_du(lat, julian_day):
    """Total-column ozone (Dobson units) zonal-mean climatology.
    lat in radians."""
    sinl = torch.sin(lat)
    # annual cycle peaks in local spring at high latitudes
    phase_nh = math.cos(2.0 * math.pi * (julian_day - 105.0) / 365.0)
    phase_sh = math.cos(2.0 * math.pi * (julian_day - 288.0) / 365.0)
    seasonal = torch.where(lat >= 0.0, phase_nh,
                           torch.full_like(lat, phase_sh))
    return 260.0 + 90.0 * sinl ** 2 + 40.0 * sinl ** 2 * seasonal


def o3_peak_pressure(lat):
    """Pressure (Pa) of the ozone mixing-ratio peak: ~1000 Pa in the
    tropics rising to ~3000 Pa at the poles."""
    return 1000.0 + 2000.0 * torch.sin(lat) ** 2


def o3_climatology(lat, p, julian_day=172.0):
    """Ozone volume mixing ratio on model levels.

    lat: (nCells,) radians; p: (nCells, nz) Pa; returns (nCells, nz) vmr.
    The vertical shape is a Chapman layer in log-pressure,
    vmr ~ exp(1 - x - exp(-x)), x = ln(p/p_peak)/w, normalized so that the
    column integral matches the climatological Dobson amount."""
    du = o3_column_du(lat, julian_day)[:, None]
    p_pk = o3_peak_pressure(lat)[:, None]
    w = 1.1                                    # layer width in ln(p)
    x = torch.log(torch.clamp(p, min=1.0) / p_pk) / w
    shape = torch.exp(1.0 - x - torch.exp(-x))  # peaks at x=0
    # column of the shape in vmr*dp/g: 1 DU = 2.1415e-5 kg(O3)/m2;
    # vmr*dp/g * (48/28.97) integrates the mass
    g = 9.80616
    dp = torch.abs(torch.gradient(p, dim=1)[0])
    col_shape = torch.sum(shape * dp, dim=1, keepdim=True) / g \
        * (48.0 / 28.97)
    target_mass = du * 2.1415e-5               # kg/m2
    vmr = shape * target_mass / torch.clamp(col_shape, min=1e-12)
    return torch.clamp(vmr, 0.0, 2.0e-5)


def o3_path(rho, dz, vmr):
    """Ozone mass path per layer (kg/m2) for the radiation schemes."""
    return rho * dz * vmr * (48.0 / 28.97)
