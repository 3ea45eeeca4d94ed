"""Area/volume ice tracers: age, first-year area, level ice, aerosols
(port of mpas_tpu/cores/seaice/tracers.py).

ref capability: src/core_seaice/column/ice_age.F90 (increment_age),
ice_firstyear.F90 (update_FYarea), ice_colpkg_tracers.F90 (alvl/vlvl
level-ice tracers fed by ridging), ice_aerosol.F90 (update_aerosol:
deposition into the snow surface layer, meltwater scavenging between the
snow/ice surface and interior layers, loss to the ocean).

Every tracer is per cell per category; the updates are elementwise.
"""

from __future__ import annotations

import torch


def increment_age(age, a, dt, puny=1.0e-11):
    """Ice age in seconds (ref ice_age.F90:increment_age: iage = iage + dt
    on every cell that carries ice)."""
    return torch.where(a > puny, age + dt, 0.0)


def update_first_year_area(fy_area, a, frozen_season, puny=1.0e-11):
    """First-year ice area fraction (ref ice_firstyear.F90 update_FYarea):
    reset to the full category area at the start of the freezing season
    (the caller passes the season flag), shrinking with the ice
    otherwise."""
    fy = torch.where(frozen_season, a.clamp(0.0, 1.0),
                     torch.minimum(fy_area, a))
    return torch.where(a > puny, fy, 0.0)


def ridging_level_ice_update(alvl, vlvl, a, v, a_new, v_new,
                             puny=1.0e-11):
    """Level-ice tracers after ridging: ridging converts level ice to
    deformed ice, so the level fraction only shrinks when area is lost to
    ridging (ref ice_colpkg_tracers: alvl participates via ardg/vrdg); all
    net area/volume loss of a category is attributed to ridging of its
    level ice."""
    lvl_area_new = (alvl * a - (a - a_new).clamp(min=0.0)).clamp(min=0.0)
    alvl2 = torch.where(a_new > puny,
                        (lvl_area_new / a_new.clamp(min=puny)).clamp(0.0,
                                                                    1.0),
                        0.0)
    lvl_vol_new = (vlvl * v - (v - v_new).clamp(min=0.0)).clamp(min=0.0)
    vlvl2 = torch.where(v_new > puny,
                        (lvl_vol_new / v_new.clamp(min=puny)).clamp(0.0,
                                                                   1.0),
                        0.0)
    return alvl2, vlvl2


def update_aerosol(aero_snow_ssl, aero_snow_int, aero_ice_ssl,
                   aero_ice_int, a, h_snow, h_ice,
                   flux_deposit, melt_s, melt_i, growth_b, dt,
                   hs_ssl=0.04, hi_ssl=0.05, kscav=(1.0, 1.0, 0.03, 0.03),
                   puny=1.0e-11):
    """Aerosol-in-ice transport (ref ice_aerosol.F90 update_aerosol).

    Four reservoirs per species (kg/m2 of category area): snow surface
    layer (ssl), snow interior, ice ssl, ice interior.
      * atmospheric deposition enters the snow ssl (ice ssl if snowless)
      * surface snow melt scavenges ssl mass to the ocean with efficiency
        kscav and pushes the ssl/interior boundary down
      * snow gone -> the snow reservoirs merge into the ice ssl
      * surface ice melt scavenges the ice ssl
    Shapes: all (..., nSpecies) with broadcastable leading dims."""
    has_snow = h_snow[..., None] > puny
    has_ice = h_ice[..., None] > puny

    dep = flux_deposit * dt
    aero_snow_ssl = aero_snow_ssl + torch.where(has_snow, dep, 0.0)
    aero_ice_ssl = aero_ice_ssl + torch.where(~has_snow & has_ice, dep, 0.0)

    # snow melt: fraction of the ssl removed this step
    f_melt_s = (melt_s * dt / h_snow.clamp(min=puny)).clamp(0.0,
                                                           1.0)[..., None]
    lost_s = aero_snow_ssl * f_melt_s * kscav[0]
    # the melted ssl's unscavenged mass stays, exposing interior mass:
    # a matching fraction of the interior moves into the ssl
    promote_s = aero_snow_int * f_melt_s
    aero_snow_ssl = aero_snow_ssl - lost_s + promote_s
    aero_snow_int = aero_snow_int - promote_s

    # snow fully melted -> the snow reservoirs go into the ice ssl
    snow_gone = ~has_snow
    aero_ice_ssl = aero_ice_ssl + torch.where(
        snow_gone, aero_snow_ssl + aero_snow_int, 0.0)
    aero_snow_ssl = torch.where(snow_gone, 0.0, aero_snow_ssl)
    aero_snow_int = torch.where(snow_gone, 0.0, aero_snow_int)

    # ice surface melt
    f_melt_i = (melt_i * dt / h_ice.clamp(min=puny)).clamp(0.0,
                                                          1.0)[..., None]
    lost_i = aero_ice_ssl * f_melt_i * kscav[2]
    promote_i = aero_ice_int * f_melt_i
    aero_ice_ssl = aero_ice_ssl - lost_i + promote_i
    aero_ice_int = aero_ice_int - promote_i

    # everything zero where there is no ice
    z = ~has_ice
    flux_ocean = (lost_s + lost_i) / dt + torch.where(
        z, (aero_snow_ssl + aero_snow_int + aero_ice_ssl + aero_ice_int)
        / dt, 0.0)
    return (torch.where(z, 0.0, aero_snow_ssl),
            torch.where(z, 0.0, aero_snow_int),
            torch.where(z, 0.0, aero_ice_ssl),
            torch.where(z, 0.0, aero_ice_int), flux_ocean)
