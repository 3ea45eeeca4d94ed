"""Radar reflectivity diagnostic from microphysics hydrometeors (port of
mpas_tpu/cores/atmosphere/physics/radar.py).

ref: physics_wrf/module_mp_radar.F, the 10-cm (S-band) equivalent
reflectivity shared by WSM6/Thompson: Rayleigh scattering from exponential
size distributions of rain, (dry/wet) snow and graupel, with the ice-phase
dielectric factor and density scaling (Smith 1984). refl_10cm in dBZ.

For an exponential PSD N(D) = N0 exp(-lambda D) of a species with bulk
density rho_x and mixing ratio q (lambda = (pi rho_x N0 / (rho q))^(1/4)):
    Z = 720 N0 / lambda^7            [m^6/m^3 -> x1e18 for mm^6/m^3]
Ice species are scaled by the Smith (1984) melted-equivalent factor
0.224 (rho_x/rho_w)^2.
"""

from __future__ import annotations

import math

import torch

# PSD intercepts (m^-4) and bulk densities (kg/m3): WSM6/Thompson defaults
N0_RAIN = 8.0e6
N0_SNOW = 2.0e6
N0_GRAUPEL = 4.0e6
RHO_WATER = 1000.0
RHO_SNOW = 100.0
RHO_GRAUPEL = 500.0
_ICE_FACTOR = 0.224          # |K_ice|^2 / |K_water|^2 melted-equivalent


def _z_exponential(q, rho_air, n0, rho_x, ice: bool):
    """Rayleigh reflectivity (mm^6/m^3) of one exponential-PSD species."""
    q = torch.clamp(q, min=0.0)
    content = rho_air * q                       # kg/m3
    lam4 = math.pi * rho_x * n0 / torch.clamp(content, min=1e-12)
    lam = lam4 ** 0.25
    z = 720.0 * n0 / lam ** 7                   # m^6/m^3
    if ice:
        z = z * _ICE_FACTOR * (rho_x / RHO_WATER) ** 2
    return torch.where(content > 1e-9, z * 1.0e18, 0.0)   # mm^6/m^3


def refl_10cm(rho_air, qr, qs=None, qg=None, t=None,
              n0_rain=N0_RAIN, n0_snow=N0_SNOW, n0_graupel=N0_GRAUPEL):
    """Equivalent radar reflectivity (dBZ) from rain/snow/graupel mixing
    ratios (ref: the refl10cm_* entry points of module_mp_radar.F).

    t (optional, K): above freezing, snow/graupel scatter as water-coated
    (wet) particles, approximated by dropping the ice dielectric factor
    (ref: the melting-layer branch).
    """
    z = _z_exponential(qr, rho_air, n0_rain, RHO_WATER, ice=False)
    for q, n0, rho_x in ((qs, n0_snow, RHO_SNOW),
                         (qg, n0_graupel, RHO_GRAUPEL)):
        if q is None:
            continue
        z_dry = _z_exponential(q, rho_air, n0, rho_x, ice=True)
        if t is not None:
            z_wet = z_dry / _ICE_FACTOR
            z = z + torch.where(t > 273.15, z_wet, z_dry)
        else:
            z = z + z_dry
    return 10.0 * torch.log10(torch.clamp(z, min=1e-3))   # >= -30 dBZ floor


def composite_reflectivity(dbz):
    """Column-maximum reflectivity (the standard composite product)."""
    return torch.amax(dbz, dim=-1)
