"""1-D ocean mixed layer + cloudiness diagnostics (port of
mpas_tpu/cores/atmosphere/physics/oml.py).

ref:
  OML        - src/core_atmosphere/physics/mpas_atmphys_driver_oml.F +
               physics_wrf/module_sf_oml.F (Pollard-Rhines-Thompson slab:
               mixed-layer temperature responds to the surface heat flux,
               deepening by wind stirring, over water points)
  cloudiness - mpas_atmphys_driver_cloudiness.F (fractional cloudiness
               from relative humidity and hydrometeors; the RH-based
               'cld_fraction' scheme)
"""

from __future__ import annotations

import torch

_CP_W = 4190.0
_RHO_W = 1000.0
_T0 = 273.15


def oml_step(tml, h_ml, hfx, lh, gsw, glw, ust, dt,
             t_deep=288.0, h_min=5.0, h_max=500.0, emiss=0.985,
             gamma=0.14):
    """Slab ocean mixed layer update (ref: module_sf_oml.F oml1d):
      rho_w cp_w h dT/dt = net surface heat flux
      dh/dt from wind stirring against buoyancy (Kraus-Turner-like; the
      reference uses PRT with a lapse gamma below the layer).
    Returns (tml_new, h_ml_new)."""
    sb = 5.67e-8
    net = gsw + emiss * glw - emiss * sb * tml ** 4 - hfx - lh
    tml_new = tml + dt * net / (_RHO_W * _CP_W * torch.clamp(h_ml,
                                                             min=h_min))
    # entrainment deepening by wind stirring
    we = 2.5 * ust ** 3 / (9.81 * 2.0e-4
                           * torch.clamp(h_ml, min=h_min)
                           * max(gamma, 1e-6))
    h_new = torch.clamp(h_ml + dt * we, h_min, h_max)
    # deepening entrains colder water (lapse gamma K/m below the layer)
    dh = h_new - h_ml
    tml_new = tml_new - gamma * dh * dh / torch.clamp(h_new, min=h_min)
    return tml_new, h_new


def cloud_fraction_rh(qv, qc, qi, p, t):
    """Fractional cloudiness (ref: mpas_atmphys_driver_cloudiness.F
    'cld_fraction': RH-based Sundqvist form, overcast where hydrometeors
    are present)."""
    es = 611.2 * torch.exp(17.67 * (t - _T0) / (t - 29.65))
    qs = 0.622 * es / torch.clamp(p - es, min=100.0)
    rh = torch.clamp(qv / torch.clamp(qs, min=1e-10), 0.0, 1.0)
    rhc = 0.80                     # critical RH
    frac = torch.clamp(1.0 - torch.sqrt((1.0 - rh) / (1.0 - rhc + 1e-9)),
                       0.0, 1.0)
    cloudy = (qc + qi) > 1.0e-6
    return torch.where(cloudy, 1.0, frac)
