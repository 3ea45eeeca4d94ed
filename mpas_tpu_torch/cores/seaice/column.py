"""Column physics: thermodynamic growth/melt, ITD remapping, ridging, and
the tracer packages (port of mpas_tpu/cores/seaice/column.py).

ref: src/core_seaice/column/ (Icepack-equivalent) wrapped by
shared/mpas_seaice_column.F:

  * zero-layer (Semtner 0) thermodynamics per category: surface energy
    balance with Newton iterations for the surface temperature,
    conductive flux through the slab, basal growth/melt against the ocean
    heat flux, surface melt, frazil ice in open water; or the multilayer
    BL99/mushy scheme of thermo_vertical.py (+ delta-Eddington shortwave)
  * ITD category remapping: a one-shot conservative rebin, or the linear
    remap of itd.py
  * mechanical ridging (ridging.py) when dynamics compresses the total
    area above 1
  * ponds, age, brine, zsalinity/mushy brine dynamics, algae and snow
    after the thermodynamics.

Everything is elementwise per column over (nCells, nCat): no
communication.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from mpas_tpu_torch.cores.seaice import mushy as mushy_mod
from mpas_tpu_torch.cores.seaice import ponds
from mpas_tpu_torch.cores.seaice.bgc import algae_step, brine_height_update
from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.itd import linear_remap
from mpas_tpu_torch.cores.seaice.ridging import ridge_step
from mpas_tpu_torch.cores.seaice.shortwave_dedd import dedd_shortwave
from mpas_tpu_torch.cores.seaice.snow import snow_metamorphism
from mpas_tpu_torch.cores.seaice.state import (SeaiceForcing, SeaiceState,
                                               const_tensor)
from mpas_tpu_torch.cores.seaice.thermo_vertical import (enthalpy_fn,
                                                         temperature_mush,
                                                         thermo_multilayer)
from mpas_tpu_torch.cores.seaice.tracers import (increment_age,
                                                 ridging_level_ice_update)
from mpas_tpu_torch.cores.seaice.zsalinity import zsalinity_step

_T0 = 273.15
# the area tracers the linear ITD remap carries, where present
_ITD_AREA_TRACERS = ("pondArea", "pondDepth", "pondLid", "levelIceArea",
                     "iceAge", "firstYearArea", "brineHeight", "algaeIce",
                     "nitrateIce", "silicateIce")


def surface_temperature_solve(cfg: SeaiceConfig, t_s, h_ice, h_snow,
                              sw_abs, lw_down, t_air, t_bot):
    """Newton solve of the surface energy balance for slab ice.

    F(Ts) = sw_abs + lw_down - eps*sigma*Ts^4 - F_sens(Ts) + k_eff*(Tb-Ts)/h
    with a bulk sensible flux ~ c_t*(Ts - Ta); 4 Newton iterations."""
    k_eff = 1.0 / (h_ice.clamp(min=0.01) / cfg.ice_conductivity
                   + h_snow.clamp(min=0.0) / cfg.snow_conductivity)
    c_sens = 10.0  # bulk transfer W/m2/K
    eps_sigma = cfg.emissivity * cfg.stefan_boltzmann

    t = t_s
    for _ in range(4):
        tk = t + _T0
        f = (sw_abs + lw_down - eps_sigma * tk ** 4
             - c_sens * (t - t_air) + k_eff * (t_bot - t))
        dfdt = -4.0 * eps_sigma * tk ** 3 - c_sens - k_eff
        t = t - f / dfdt
    t_s = t.clamp(max=0.0)               # melting cap
    f_cond = k_eff * (t_bot - t_s)       # conductive flux up through slab
    tk = t_s + _T0
    f_net_surf = (sw_abs + lw_down - eps_sigma * tk ** 4
                  - c_sens * (t_s - t_air))
    return t_s, f_cond, f_net_surf


def _add_frazil(cfg, forcing, a, vi, dt, h_frazil=0.05):
    """Open-water ocean heat loss forms new ice in category 0
    (ref capability: ice_therm_itd frazil)."""
    rhoL = cfg.rho_ice * cfg.latent_heat_fusion
    open_frac = (1.0 - a.sum(-1)).clamp(0.0, 1.0)
    freeze = (-forcing.oceanHeatFlux).clamp(min=0.0) * open_frac
    dv_frazil = dt * freeze / rhoL
    vi = torch.cat([(vi[:, 0] + dv_frazil)[:, None], vi[:, 1:]], 1)
    a = torch.cat([(a[:, 0] + dv_frazil / h_frazil)[:, None], a[:, 1:]], 1)
    return a, vi


def thermodynamics(cfg: SeaiceConfig, state: SeaiceState,
                   forcing: SeaiceForcing, dt) -> SeaiceState:
    """Zero-layer vertical thermodynamics for every cell x category."""
    a = state.iceAreaCategory
    vi = state.iceVolumeCategory
    vs = state.snowVolumeCategory
    t_s = state.surfaceTemperature
    rhoL = cfg.rho_ice * cfg.latent_heat_fusion

    has_ice = a > cfg.puny
    h_i = torch.where(has_ice, vi / a.clamp(min=cfg.puny), 0.0)
    h_s = torch.where(has_ice, vs / a.clamp(min=cfg.puny), 0.0)

    alb = torch.where(h_s > 0.01, torch.full_like(h_s, 0.80), 0.60)
    sw_abs = (1.0 - alb) * forcing.shortwaveDown[:, None]
    lw_down = forcing.longwaveDown[:, None]
    t_air = forcing.airTemperature[:, None]
    t_bot = torch.full_like(h_i, cfg.freezing_point)

    t_s_new, f_cond, f_net_surf = surface_temperature_solve(
        cfg, t_s, h_i, h_s, sw_abs, lw_down, t_air, t_bot)

    # basal growth (+) / melt (-): conductive heat out vs ocean heat in
    dh_bot = dt * (f_cond - forcing.oceanHeatFlux[:, None]) / rhoL

    # surface melt when the balance at Ts=0 is positive
    melt_flux = (f_net_surf - f_cond).clamp(min=0.0) * (t_s_new >= 0.0)
    dh_surf_snow = -torch.minimum(
        dt * melt_flux / (cfg.rho_snow * cfg.latent_heat_fusion), h_s)
    used = -dh_surf_snow * cfg.rho_snow * cfg.latent_heat_fusion / dt
    dh_surf_ice = -dt * (melt_flux - used).clamp(min=0.0) / rhoL

    h_i_new = (h_i + dh_bot + dh_surf_ice).clamp(min=0.0)
    h_s_new = (h_s + dh_surf_snow).clamp(min=0.0)

    gone = h_i_new <= cfg.puny
    a_new = torch.where(gone, 0.0, a)
    vi_new = a_new * h_i_new
    vs_new = torch.where(gone, 0.0, a_new * h_s_new)
    t_s_new = torch.where(has_ice, t_s_new, 0.0)

    a_new, vi_new = _add_frazil(cfg, forcing, a_new, vi_new, dt)
    return dataclasses.replace(state, iceAreaCategory=a_new,
                               iceVolumeCategory=vi_new,
                               snowVolumeCategory=vs_new,
                               surfaceTemperature=t_s_new)


def itd_remap(cfg: SeaiceConfig, state: SeaiceState) -> SeaiceState:
    """Rebin every category into the fixed thickness bounds
    (conservative). ref capability: column/ice_itd.F90 (linear remapping
    between category boundaries; here a one-shot conservative rebin of
    (a, v, vs, a*T))."""
    n_cat = cfg.config_n_categories
    a, vi, vs = (state.iceAreaCategory, state.iceVolumeCategory,
                 state.snowVolumeCategory)
    bounds = const_tensor(tuple(cfg.config_itd_bounds), a.device, a.dtype)
    aT = a * state.surfaceTemperature
    h = torch.where(a > cfg.puny, vi / a.clamp(min=cfg.puny), 0.0)
    # destination category of each source category (fixed bounds)
    dest = (h[..., None] >= bounds[1:-1]).sum(-1).clamp(max=n_cat - 1)
    onehot = F.one_hot(dest, n_cat).to(a.dtype)      # (nC, nCat, nCat)

    def rebin(x):
        return torch.einsum("ck,ckn->cn", x, onehot)

    a2, vi2, vs2, aT2 = rebin(a), rebin(vi), rebin(vs), rebin(aT)
    T2 = torch.where(a2 > cfg.puny, aT2 / a2.clamp(min=cfg.puny), 0.0)
    out = dataclasses.replace(state, iceAreaCategory=a2,
                              iceVolumeCategory=vi2, snowVolumeCategory=vs2,
                              surfaceTemperature=T2)
    # enthalpy tracers ride on volume (conserved quantity = q * v / nlyr)
    if state.iceEnthalpy is not None:
        def rebin_q(q, v, v2):
            qv = torch.einsum("ckl,ckn->cnl", q * v[..., None], onehot)
            return torch.where(v2[..., None] > cfg.puny,
                               qv / v2[..., None].clamp(min=cfg.puny), q)
        out = dataclasses.replace(
            out, iceEnthalpy=rebin_q(state.iceEnthalpy, vi, vi2),
            snowEnthalpy=rebin_q(state.snowEnthalpy, vs, vs2))
    return out


def ridge(cfg: SeaiceConfig, state: SeaiceState, dt: float = 3600.0,
          closing_rate=None) -> SeaiceState:
    """Mechanical redistribution (ref: column/ice_mechred.F90): the
    Thorndike participation / exponential redistribution scheme of
    ridging.ridge_step: thin ice participating in closing piles into
    ridges 2-25x its thickness, conserving ice volume and enthalpy while
    shedding area (and (1-fsnowrdg) of the ridged snow to the ocean)."""
    a, v, vs, ts, qi, qs, _ = ridge_step(
        cfg, state.iceAreaCategory, state.iceVolumeCategory,
        state.snowVolumeCategory, state.surfaceTemperature, dt,
        q_ice=state.iceEnthalpy, q_snow=state.snowEnthalpy,
        closing_rate=closing_rate)
    return dataclasses.replace(state, iceAreaCategory=a, iceVolumeCategory=v,
                               snowVolumeCategory=vs, surfaceTemperature=ts,
                               iceEnthalpy=qi, snowEnthalpy=qs)


def thermodynamics_multilayer(cfg: SeaiceConfig, state: SeaiceState,
                              forcing: SeaiceForcing, dt) -> SeaiceState:
    """BL99/mushy multilayer vertical thermodynamics (+ optional
    delta-Eddington shortwave); ref ice_therm_{bl99,mushy}.F90 via
    mpas_seaice_column.F column_vertical_thermodynamics."""
    a = state.iceAreaCategory
    has_ice = a > cfg.puny
    a_safe = a.clamp(min=cfg.puny)
    h_i = torch.where(has_ice, state.iceVolumeCategory / a_safe, 0.0)
    h_s = torch.where(has_ice, state.snowVolumeCategory / a_safe, 0.0)

    sw_abs_lyr = albedo = sw_through = None
    if cfg.config_shortwave_type == "dedd":
        sw = forcing.shortwaveDown[:, None]
        albedo, frac_abs, frac_thru = dedd_shortwave(
            cfg, h_i, h_s, state.iceEnthalpy.shape[-1])
        sw_abs_lyr = frac_abs * sw[..., None]
        sw_through = frac_thru * sw

    a2, vi2, vs2, ts2, qi2, qs2, _ = thermo_multilayer(
        cfg, a, state.iceVolumeCategory, state.snowVolumeCategory,
        state.surfaceTemperature, state.iceEnthalpy, state.snowEnthalpy,
        forcing.shortwaveDown[:, None], forcing.longwaveDown[:, None],
        forcing.airTemperature[:, None], forcing.oceanHeatFlux[:, None],
        dt, sw_abs_lyr=sw_abs_lyr, albedo=albedo, sw_through=sw_through,
        salinity=(state.iceSalinity if cfg.config_use_zsalinity
                  else None))
    # frazil in open water (as on the zero-layer path)
    a2, vi2 = _add_frazil(cfg, forcing, a2, vi2, dt)
    return dataclasses.replace(state, iceAreaCategory=a2,
                               iceVolumeCategory=vi2, snowVolumeCategory=vs2,
                               surfaceTemperature=ts2, iceEnthalpy=qi2,
                               snowEnthalpy=qs2)


def _mean_thickness(cfg, a, v):
    return torch.where(a > cfg.puny, v / a.clamp(min=cfg.puny), 0.0)


def _tracer_packages_step(cfg: SeaiceConfig, state: SeaiceState,
                          forcing: SeaiceForcing, pre: SeaiceState,
                          dt) -> SeaiceState:
    """Pond / age / brine / salinity / algae / snow tracer updates after
    the vertical thermodynamics, driven by the melt/growth diagnostics of
    the category thickness before (pre) and after (state) it.
    ref ordering: mpas_seaice_column.F column_*_tracers after
    seaice_column_vertical_thermodynamics."""
    a = state.iceAreaCategory
    h_i = _mean_thickness(cfg, a, state.iceVolumeCategory)
    h_s = _mean_thickness(cfg, a, state.snowVolumeCategory)
    h_i0 = _mean_thickness(cfg, pre.iceAreaCategory, pre.iceVolumeCategory)
    h_s0 = _mean_thickness(cfg, pre.iceAreaCategory,
                           pre.snowVolumeCategory)
    melt_i = (h_i0 - h_i).clamp(min=0.0)       # m of ice melted this step
    melt_s = (h_s0 - h_s).clamp(min=0.0)
    growth_b = (h_i - h_i0).clamp(min=0.0) / dt
    melt_b = melt_i / dt
    t_s = state.surfaceTemperature
    rain = (forcing.rainfallRate[:, None] / 1000.0
            if forcing.rainfallRate is not None else torch.zeros_like(a))
    snowfall = (forcing.snowfallRate[:, None]
                if forcing.snowfallRate is not None
                else torch.zeros_like(a))
    wind = torch.sqrt(forcing.uAirVelocity ** 2
                      + forcing.vAirVelocity ** 2)[:, None]

    upd = {}
    if cfg.config_pond_scheme != "off" and state.pondArea is not None:
        if cfg.config_pond_scheme == "cesm":
            ap, hp = ponds.ponds_cesm(cfg, a, h_i, t_s, state.pondArea,
                                      state.pondDepth, melt_i, melt_s,
                                      rain, dt)
            upd.update(pondArea=ap, pondDepth=hp)
        elif cfg.config_pond_scheme == "lvl":
            alvl = (state.levelIceArea if state.levelIceArea is not None
                    else torch.ones_like(a))
            ap, hp, ip = ponds.ponds_lvl(
                cfg, a, h_i, t_s, state.pondArea, state.pondDepth,
                state.pondLid if state.pondLid is not None
                else torch.zeros_like(a), alvl, melt_i, melt_s, rain, dt)
            upd.update(pondArea=ap, pondDepth=hp, pondLid=ip)
        else:  # topo
            ap, hp = ponds.ponds_topo(cfg, a, h_i, h_s, t_s,
                                      state.pondArea, state.pondDepth,
                                      melt_i, melt_s, rain, dt)
            upd.update(pondArea=ap, pondDepth=hp)
    if cfg.config_use_ice_age and state.iceAge is not None:
        upd["iceAge"] = increment_age(state.iceAge, a, dt, cfg.puny)
    if cfg.config_use_brine and state.brineHeight is not None:
        upd["brineHeight"] = brine_height_update(
            state.brineHeight, h_i, h_s, cfg.rho_ice, cfg.rho_snow,
            cfg.rho_seawater, dt, puny=cfg.puny)
    if cfg.config_use_zsalinity and state.iceSalinity is not None:
        sss = (forcing.seaSurfaceSalinity
               if getattr(forcing, "seaSurfaceSalinity", None) is not None
               else torch.full((a.shape[0],), 34.0, dtype=a.dtype,
                               device=a.device))
        if cfg.config_thermo_type == "mushy" \
                and state.iceEnthalpy is not None:
            # Turner-2013 mushy brine dynamics: two-mode gravity drainage
            # + pond flushing, coupled to temperature through the
            # enthalpy (ref ice_therm_mushy.F90 picard machinery)
            S_now = state.iceSalinity
            T_lyr = temperature_mush(cfg, state.iceEnthalpy, S_now)
            Tbot = mushy_mod.liquidus_temperature(sss)[:, None]
            ap_now = upd.get("pondArea", state.pondArea)
            hp_now = upd.get("pondDepth", state.pondDepth)
            if ap_now is None:
                ap_now = torch.zeros_like(h_i)
                hp_now = torch.zeros_like(h_i)
            qocn = mushy_mod.enthalpy_brine(Tbot)
            T2, S2, _fzsal, _fadv = mushy_mod.mushy_coupled_step(
                T_lyr, S_now, t_s, Tbot * torch.ones_like(t_s), h_i, h_s,
                hp_now, ap_now, sss[:, None], qocn, dt, n_picard=2)
            upd["iceSalinity"] = S2
            upd["iceEnthalpy"] = torch.where(
                (h_i > cfg.puny)[..., None], enthalpy_fn(cfg, True)(T2, S2),
                state.iceEnthalpy)
        else:
            S2, _fzsal = zsalinity_step(cfg, state.iceSalinity, h_i,
                                        growth_b, melt_s + melt_i, sss, dt)
            upd["iceSalinity"] = S2
    if cfg.config_use_algae and state.algaeIce is not None:
        sw_thru = forcing.shortwaveDown[:, None] * torch.exp(
            -1.5 * h_i.clamp(min=0.0) - 20.0 * h_s.clamp(min=0.0))
        alg, no3, sio3, _ = algae_step(
            state.algaeIce, state.nitrateIce, state.silicateIce, h_i,
            sw_thru, torch.full_like(h_i, cfg.freezing_point),
            cfg.config_ocean_nitrate, cfg.config_ocean_silicate,
            growth_b, melt_b, dt, puny=cfg.puny)
        upd.update(algaeIce=alg, nitrateIce=no3, silicateIce=sio3)
    if cfg.config_use_snow_metamorphism \
            and state.snowGrainRadius is not None:
        r, rho = snow_metamorphism(
            state.snowGrainRadius, t_s,
            torch.full_like(t_s, cfg.freezing_point), h_s, snowfall, wind,
            state.snowDensity if state.snowDensity is not None
            else torch.full_like(t_s, cfg.rho_snow), dt, puny=cfg.puny)
        upd.update(snowGrainRadius=r, snowDensity=rho)
    return dataclasses.replace(state, **upd) if upd else state


def column_physics_step(cfg: SeaiceConfig, state: SeaiceState,
                        forcing: SeaiceForcing, dt) -> SeaiceState:
    """ref ordering: seaice_column_* called after dynamics/advection
    (mpas_seaice_time_integration.F:42-174): ridging (and the level-ice
    tracers it feeds), thermodynamics, the tracer packages, the ITD
    remap."""
    pre_ridge = state
    state = ridge(cfg, state, dt)
    if state.levelIceArea is not None:
        alvl, vlvl = ridging_level_ice_update(
            pre_ridge.levelIceArea,
            pre_ridge.levelIceVolume
            if pre_ridge.levelIceVolume is not None
            else pre_ridge.levelIceArea,
            pre_ridge.iceAreaCategory, pre_ridge.iceVolumeCategory,
            state.iceAreaCategory, state.iceVolumeCategory, cfg.puny)
        state = dataclasses.replace(state, levelIceArea=alvl,
                                    levelIceVolume=vlvl)
    pre = state
    if cfg.config_thermo_type in ("bl99", "mushy"):
        state = thermodynamics_multilayer(cfg, state, forcing, dt)
    else:
        state = thermodynamics(cfg, state, forcing, dt)
    state = _tracer_packages_step(cfg, state, forcing, pre, dt)
    if cfg.config_itd_remap_type == "linear":
        at_names = [n for n in _ITD_AREA_TRACERS
                    if getattr(state, n) is not None]
        a2, vi2, vs2, ts2, qi2, qs2, at2, _ = linear_remap(
            cfg, state.iceAreaCategory, state.iceVolumeCategory,
            state.snowVolumeCategory, state.surfaceTemperature,
            q_ice=state.iceEnthalpy, q_snow=state.snowEnthalpy,
            area_tracers=tuple(getattr(state, n) for n in at_names))
        state = dataclasses.replace(
            state, iceAreaCategory=a2, iceVolumeCategory=vi2,
            snowVolumeCategory=vs2, surfaceTemperature=ts2,
            iceEnthalpy=qi2, snowEnthalpy=qs2, **dict(zip(at_names, at2)))
    else:
        state = itd_remap(cfg, state)
    return state
