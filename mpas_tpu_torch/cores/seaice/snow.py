"""Snow physics on sea ice: metamorphism, wind effects, snow-ice (port of
mpas_tpu/cores/seaice/snow.py).

ref capability: the snow package coupled through
src/core_seaice/shared/mpas_seaice_column.F (snow grain radius and
effective density tracers for the delta-Eddington optics) plus the
snow-to-ice conversion of ice_therm_itd.F90 (freeboard adjustment):
  * dry (temperature-gradient) metamorphism: the grain radius grows
    toward r_max on a timescale shortened by the temperature gradient
  * wet metamorphism: liquid water present (surface at melt) -> fast
    growth (Brun 1989 r^3 law)
  * fresh snowfall resets the surface grain radius toward r_fresh
  * wind compaction: drifting snow (wind > 5 m/s) raises the effective
    density toward rho_wind
  * snow-ice formation: a negative freeboard floods the snow base and
    refreezes it as ice (ice_therm_itd.F90's freeboard rule).
"""

from __future__ import annotations

import torch

R_FRESH = 54.526e-6      # m, fresh-snow grain radius (SNICAR)
R_MAX = 1500.0e-6        # m
RHO_WIND = 400.0         # kg/m3 wind-slab density
TAU_DRY = 2.0e6          # s, dry metamorphism timescale at 10 K/m gradient
TAU_WET = 2.0e5          # s, wet metamorphism timescale


def snow_metamorphism(r_snow, t_sfc, t_bot, h_snow, snowfall, wind,
                      rho_eff, dt, puny=1.0e-11):
    """Evolve the grain radius and effective density (bulk, one layer).

    r_snow: grain radius in m; rho_eff: effective density kg/m3;
    snowfall: m/s of new snow depth; wind: m/s 10-m wind speed."""
    has = h_snow > puny
    grad = (t_sfc - t_bot).abs() / h_snow.clamp(min=0.05)
    wet = t_sfc >= -0.01
    # exponential relaxation toward r_max (stable at any dt)
    inv_tau = torch.where(wet, torch.full_like(grad, 1.0 / TAU_WET),
                          (grad / 10.0).clamp(0.0, 5.0) / TAU_DRY)
    r_new = R_MAX - (R_MAX - r_snow) * torch.exp(-dt * inv_tau)
    # snowfall dilution of the (bulk) grain radius
    f_new = (snowfall * dt / h_snow.clamp(min=puny)).clamp(0.0, 1.0)
    r_new = ((1.0 - f_new) * r_new + f_new * R_FRESH).clamp(R_FRESH, R_MAX)

    # wind compaction (drifting threshold 5 m/s)
    drift = ((wind - 5.0) / 10.0).clamp(0.0, 1.0)
    rho_new = rho_eff + dt / 8.64e4 * drift * (RHO_WIND - rho_eff)
    rho_new = (1.0 - f_new) * rho_new + f_new * 100.0   # fresh snow light

    return (torch.where(has, r_new, R_FRESH),
            torch.where(has, rho_new.clamp(100.0, RHO_WIND), 330.0))


def snow_ice_formation(h_ice, h_snow, rho_ice, rho_snow, rho_sea,
                       puny=1.0e-11):
    """Convert flooded snow to ice where the freeboard is negative
    (ref ice_therm_itd.F90 freeboard): the new surface sits at sea level.

    freeboard = h_i(1 - rho_i/rho_w) - h_s rho_s/rho_w < 0  -> flood, by
    dh = -fb rho_w / (rho_w - rho_i + rho_s), at most the snow.
    Returns (h_ice_new, h_snow_new, dh_snowice)."""
    freeboard = h_ice * (1.0 - rho_ice / rho_sea) \
        - h_snow * rho_snow / rho_sea
    dh = (-freeboard).clamp(min=0.0) * rho_sea \
        / (rho_sea - rho_ice + rho_snow)
    dh = torch.minimum(dh, h_snow)
    # the flooded snow layer becomes ice of the same thickness (seawater
    # fills the pore space and refreezes)
    return h_ice + dh, h_snow - dh, dh
