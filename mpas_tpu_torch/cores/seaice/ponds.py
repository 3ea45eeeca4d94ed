"""Melt-pond parameterizations: CESM, level-ice and topographic (port of
mpas_tpu/cores/seaice/ponds.py).

ref capability: src/core_seaice/column/ice_meltpond_cesm.F90,
ice_meltpond_lvl.F90 (compute_ponds_lvl / brine_permeability),
ice_meltpond_topo.F90. All three track per-category pond tracers (apnd =
pond fraction of category area, hpnd = pond depth, ipnd = refrozen lid
thickness for the lvl scheme) and are per-column maps over (nCells, nCat).

  cesm: melt-water + rain collection with retained fraction
        rfrac = rfracmin + (rfracmax-rfracmin)*aice, pond aspect
        hpnd = pndaspect*apnd, exponential refreeze decay when the surface
        is below the pond freezing reference (Tp = -2 C).
  lvl:  the same collection scaled to the level-ice fraction (ponds live
        only on level ice), Darcy drainage through the ice with a
        brine-porosity^3 permeability (min liquid fraction cubed, x 3e-8),
        and a refrozen lid ipnd that grows by a Stefan rule when the
        surface temperature drops.
  topo: hydrostatic fill: pond water fills to the hydraulic head set by
        sea level (draft), the excess drains; refreeze as in cesm.
"""

from __future__ import annotations

import torch

RHO_FRESH = 1000.0
VISCOSITY_DYN = 1.79e-3     # Pa s
GRAV = 9.80616
TP = -2.0                   # pond reference freezing temperature (deg C)
PNDASPECT = 0.8             # ref: pndaspect namelist default
RFRACMIN, RFRACMAX = 0.15, 0.85
DPSCALE = 1.0e-3            # ref: dpscale default (flushing e-fold scale)
APND_MAX = 0.85


def _retained_volume(rfrac, melt_s, melt_i, rain, dt, rho_i, rho_s):
    """Pond water volume gained this step per unit category area (m).
    ref: ice_meltpond_lvl.F90:154 dvn = rfrac/rhofresh*(meltt*rhoi + ...)"""
    return rfrac / RHO_FRESH * (melt_i * rho_i + melt_s * rho_s
                                + rain * dt)


def _refreeze_decay(apnd, hpnd, t_sfc, dt):
    """Pond decay by exp(-dt/1 day) where the surface is colder than Tp.
    ref: ice_meltpond_cesm.F90 (apondn,hpondn *= exp(rexp))."""
    shrink = torch.exp(torch.where(t_sfc < TP,
                                   torch.full_like(t_sfc, -dt / 86400.0),
                                   0.0))
    return apnd * shrink, hpnd * shrink


def ponds_cesm(cfg, a, h_ice, t_sfc, apnd, hpnd,
               melt_i, melt_s, rain, dt):
    """CESM pond scheme (ref ice_meltpond_cesm.F90 compute_ponds_cesm)."""
    has = (a > cfg.puny) & (h_ice > 0.01)
    volp = apnd * hpnd                              # per unit category area
    rfrac = RFRACMIN + (RFRACMAX - RFRACMIN) * a.clamp(0.0, 1.0)
    volp = volp + _retained_volume(rfrac, melt_s, melt_i, rain, dt,
                                   cfg.rho_ice, cfg.rho_snow)
    # aspect closure: hpnd = pndaspect * apnd => apnd = sqrt(volp/aspect)
    apnd2 = torch.sqrt(volp.clamp(min=0.0) / PNDASPECT).clamp(max=APND_MAX)
    hpnd2 = PNDASPECT * apnd2
    apnd2, hpnd2 = _refreeze_decay(apnd2, hpnd2, t_sfc, dt)
    # ponds deeper than the ice drain entirely
    keep = has & ~(hpnd2 > 0.9 * h_ice)
    return torch.where(keep, apnd2, 0.0), torch.where(keep, hpnd2, 0.0)


def brine_permeability(t_ice, s_ice):
    """Darcy permeability from the minimum brine liquid fraction over the
    column (ref ice_meltpond_lvl.F90:277 brine_permeability:
    perm = 3e-8 * min(phi)^3, phi = -mu*S/T)."""
    phi = (-0.054 * s_ice / t_ice.clamp(max=-1.0e-3)).clamp(0.0, 1.0)
    return 3.0e-8 * phi.amin(-1) ** 3


def ponds_lvl(cfg, a, h_ice, t_sfc, apnd, hpnd, ipnd, alvl,
              melt_i, melt_s, rain, dt, t_ice=None, s_ice=5.0):
    """Level-ice pond scheme (ref ice_meltpond_lvl.F90 compute_ponds_lvl).

    apnd/hpnd are relative to the LEVEL ice area (alvl*a); ipnd is the
    refrozen-lid thickness. t_ice: (..., nIce) layer temperatures for the
    permeability; None: the surface temperature broadcast."""
    has = (a > cfg.puny) & (h_ice > 0.01) & (alvl > cfg.puny)
    alvl_a = alvl * a
    volp = apnd * hpnd * alvl_a                      # per unit CELL area
    rfrac = RFRACMIN + (RFRACMAX - RFRACMIN) * alvl.clamp(0.0, 1.0)
    dvn = _retained_volume(rfrac, melt_s, melt_i, rain, dt,
                           cfg.rho_ice, cfg.rho_snow) * a
    volp = volp + dvn

    # refrozen lid: Stefan growth when the surface is below Tp, melts
    # otherwise (ref frzpnd='hlid' branch)
    dhlid = torch.where(
        t_sfc < TP,
        torch.sqrt((ipnd ** 2 + 2.0 * cfg.ice_conductivity * (TP - t_sfc)
                    * dt / (cfg.rho_ice * cfg.latent_heat_fusion)).clamp(
                        min=0.0)) - ipnd,
        -torch.minimum(ipnd, dt * melt_i.clamp(min=0.0)))
    ipnd2 = (ipnd + dhlid).clamp(min=0.0)
    # lid growth consumes pond water
    volp = (volp - dhlid.clamp(min=0.0) * apnd * alvl_a
            * cfg.rho_ice / RHO_FRESH).clamp(min=0.0)

    # Darcy drainage through the ice (ref :237-249)
    if t_ice is None:
        t_ice = t_sfc.clamp(max=-0.2)[..., None]
    perm = brine_permeability(t_ice, s_ice)
    pressure_head = GRAV * RHO_FRESH * hpnd.clamp(min=0.0)
    drain = perm * pressure_head * dt \
        / (VISCOSITY_DYN * h_ice.clamp(min=0.01)) * DPSCALE
    volp = (volp - drain * apnd * alvl_a).clamp(min=0.0)

    # aspect closure on the level-ice area
    apnd2 = torch.sqrt(volp.clamp(min=0.0)
                       / (PNDASPECT * alvl_a.clamp(min=cfg.puny))).clamp(
                           max=1.0)
    hpnd2 = PNDASPECT * apnd2
    return (torch.where(has, apnd2, 0.0), torch.where(has, hpnd2, 0.0),
            torch.where(has, ipnd2, 0.0))


def ponds_topo(cfg, a, h_ice, h_snow, t_sfc, apnd, hpnd,
               melt_i, melt_s, rain, dt):
    """Topographic pond scheme (ref ice_meltpond_topo.F90 capability):
    meltwater fills up to the hydraulic head set by sea level; water above
    sea level drains through cracks; refreeze as cesm."""
    has = (a > cfg.puny) & (h_ice > 0.01)
    volp = apnd * hpnd
    volp = volp + _retained_volume(1.0, melt_s, melt_i, rain, dt,
                                   cfg.rho_ice, cfg.rho_snow)
    # hydrostatic draft: the ice surface sits (1 - rho_i/rho_w)h above sea
    # level; ponds can only be as deep as the freeboard allows
    freeboard = (h_ice * (1.0 - cfg.rho_ice / cfg.rho_seawater)
                 - h_snow * cfg.rho_snow / cfg.rho_seawater).clamp(min=0.0)
    apnd2 = torch.sqrt(volp.clamp(min=0.0) / PNDASPECT).clamp(max=APND_MAX)
    hpnd2 = torch.minimum(PNDASPECT * apnd2, freeboard)
    apnd2 = torch.where(hpnd2 > 0.0,
                        (volp / hpnd2.clamp(min=cfg.puny)).clamp(
                            max=APND_MAX), 0.0)
    apnd2, hpnd2 = _refreeze_decay(apnd2, hpnd2, t_sfc, dt)
    return torch.where(has, apnd2, 0.0), torch.where(has, hpnd2, 0.0)


def pond_albedo_reduction(apnd, hpnd):
    """Broadband albedo reduction from ponds (deep ponds -> dark water
    albedo ~0.15); used by the shortwave coupling."""
    pond_alb = 0.36 - 0.21 * torch.tanh(hpnd / 0.05)
    return apnd * pond_alb, apnd
