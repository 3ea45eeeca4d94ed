"""Sea-ice biogeochemistry: brine height dynamics + bottom-ice algae
(port of mpas_tpu/cores/seaice/bgc.py).

ref capability: src/core_seaice/column/ice_brine.F90 (the brine-height
tracer hbrine tracking the brine surface relative to the ice bottom,
relaxing toward hydrostatic sea level through Darcy flow) and
ice_algae.F90 (skeletal-layer algal model: nitrate + silicate limited
growth in the bottom ice layer, light limitation from transmitted
shortwave, linear mortality, entrainment of ocean nutrients into growing
ice and release on melt; the three-group algal_dyn).

State per cell per category:
  brineHeight  hbrine (m, measured from the ice bottom)
  algaeIce     bottom-layer algal N concentration (mmol N/m2)
  nitrateIce   bottom-layer NO3 (mmol N/m2)
  silicateIce  bottom-layer SiO3 (mmol Si/m2)
"""

from __future__ import annotations

import math

import torch

from mpas_tpu_torch.cores.seaice.state import const_tensor

# algal parameters (skeletal-layer model defaults, ice_algae.F90)
MU_MAX = 1.44 / 86400.0      # 1/s max specific growth (1.44/day)
MORT = 0.03 / 86400.0        # 1/s linear mortality
K_NO3 = 1.0                  # mmol/m3 half-saturation
K_SIO3 = 4.0
ALPHA_LIGHT = 0.8            # light-limitation scale (W/m2)^-1
SK_DEPTH = 0.03              # m, skeletal layer thickness
R_SI_N = 1.8                 # Si:N uptake ratio
EXCH_RATE = 0.5 / 86400.0    # 1/s nutrient exchange with the mixed layer


def brine_height_update(hbrine, h_ice, h_snow, rho_ice, rho_snow,
                        rho_sea, dt, darcy_tau=8.64e4, puny=1.0e-11):
    """Relax the brine surface toward hydrostatic sea level through Darcy
    flow (ref ice_brine.F90 update_hbrine).

    Sea level from the ice bottom: h_sl = draft =
    (rho_i h_i + rho_s h_s)/rho_w; hbrine -> h_sl with timescale
    darcy_tau, kept inside [0, h_i]."""
    has = h_ice > puny
    h_sl = (rho_ice * h_ice + rho_snow * h_snow) / rho_sea
    f = 1.0 - math.exp(-dt / darcy_tau)
    hb = torch.minimum((hbrine + f * (h_sl - hbrine)).clamp(min=0.0), h_ice)
    # fresh ice starts the brine surface at sea level
    hb = torch.where(has & (hbrine <= puny), torch.minimum(h_sl, h_ice), hb)
    return torch.where(has, hb, 0.0)


def algae_step(algae, no3, sio3, h_ice, sw_through, t_bot,
               ocean_no3, ocean_sio3, growth_bot, melt_bot, dt,
               puny=1.0e-11):
    """Skeletal-layer algal growth (ref ice_algae.F90 algal_dyn).

    algae/no3/sio3: areal concentrations in the bottom skeletal layer
    (mmol/m2); sw_through: W/m2 PAR reaching the ice bottom;
    growth_bot/melt_bot: m/s basal congelation growth and melt rates;
    ocean_*: mixed-layer nutrient concentrations (mmol/m3).
    Returns (algae, no3, sio3, flux_algae_to_ocean)."""
    has = h_ice > puny
    # volumetric concentrations in the skeletal layer
    no3_c = no3 / SK_DEPTH
    sio3_c = sio3 / SK_DEPTH

    lim_no3 = no3_c / (K_NO3 + no3_c.clamp(min=0.0))
    lim_sio3 = sio3_c / (K_SIO3 + sio3_c.clamp(min=0.0))
    lim_light = 1.0 - torch.exp(-ALPHA_LIGHT * sw_through.clamp(min=0.0))
    # temperature response (Eppley-like, t_bot in deg C near freezing)
    f_t = torch.exp(0.0633 * t_bot.clamp(max=0.0))
    mu = MU_MAX * f_t * lim_light * torch.minimum(lim_no3, lim_sio3)

    growth = torch.minimum(mu * algae * dt, 0.9 * no3)   # no overdraw
    death = MORT * algae * dt
    algae2 = (algae + growth - death).clamp(min=0.0)
    no3_2 = (no3 - growth + 0.5 * death).clamp(min=0.0)   # half remin.
    sio3_2 = (sio3 - R_SI_N * growth).clamp(min=0.0)

    # nutrient exchange with the ocean: entrainment with congelation
    # growth, relaxation toward the mixed layer otherwise
    entrain = growth_bot.clamp(min=0.0) * dt
    no3_2 = no3_2 + entrain * ocean_no3 \
        + EXCH_RATE * dt * (ocean_no3 * SK_DEPTH - no3_2)
    sio3_2 = sio3_2 + entrain * ocean_sio3 \
        + EXCH_RATE * dt * (ocean_sio3 * SK_DEPTH - sio3_2)

    # basal melt releases a matching fraction of the skeletal layer
    f_melt = (melt_bot.clamp(min=0.0) * dt / SK_DEPTH).clamp(0.0, 1.0)
    flux_out = f_melt * algae2 / max(dt, 1.0)
    algae2 = algae2 * (1.0 - f_melt)

    return (torch.where(has, algae2, 0.0),
            torch.where(has, no3_2.clamp(min=0.0), 0.0),
            torch.where(has, sio3_2.clamp(min=0.0), 0.0),
            torch.where(has, flux_out, algae / max(dt, 1.0)))


# ---------------------------------------------------------------------------
# Multi-group algal dynamics (ref ice_algae.F90 algal_dyn :1425-1900)
# ---------------------------------------------------------------------------
# per-group parameters (diatoms, small plankton, Phaeocystis): the
# reference Registry defaults (Registry.xml config_* bgc block)
MU_MAX_G = (1.44 / 86400.0, 0.41 / 86400.0, 0.63 / 86400.0)   # 1/s
MORT_G = (0.007 / 86400.0,) * 3                                # 1/s
GRAZED_G = (0.0, 0.7, 0.7)          # grazed fraction of growth
K_NO3_G = (1.0, 1.0, 1.0)           # mmol/m3
K_NH4_G = (0.3, 0.3, 0.3)
K_SIO3_G = (4.0, 0.0, 0.0)          # 0 = no Si requirement
ALPHA_G = (0.3, 0.2, 0.17)          # light limitation 1/(W/m2)
BETA_G = (0.001, 0.001, 0.04)       # light inhibition 1/(W/m2)
TDEP_G = (0.06, 0.06, 0.06)         # 1/degC growth T-dependence
FR_RESP = 0.05                      # respiration fraction of growth
FR_DON = 0.6                        # mortality fraction spilled to DON
K_DON = 0.03 / 86400.0              # 1/s DON degradation -> NH4
K_NITRIF = 0.0                      # 1/s nitrification (Registry default)
R_SI_N_DIAT = 1.8


def algal_dyn(algae3, no3, nh4, sio3, don, sw_par, t_bot, dt):
    """Three-group algal source/sink dynamics in a brine layer
    (ref ice_algae.F90 algal_dyn :1425-1900 with the Registry default
    parameter set): per-group light limitation with photoinhibition
    (1 - exp(-alpha I)) exp(-beta I), Michaelis-Menten NO3/NH4/SiO3
    uptake with NH4 preference, Eppley temperature dependence,
    respiration, mortality split to DON and NH4, grazing removal, DON
    degradation to NH4, optional nitrification.

    algae3: (..., 3) algal N [mmol/m3]; nutrient pools (...,) [mmol/m3].
    Returns (algae3, no3, nh4, sio3, don, grow_net (..., 3))."""
    dev, dt_ = algae3.device, algae3.dtype

    def g(values):
        return const_tensor(values, dev, dt_)
    f_t = torch.exp(TDEP_G[0] * t_bot.clamp(max=0.0))[..., None]
    I = sw_par.clamp(min=0.0)[..., None]
    lim_light = (1.0 - torch.exp(-g(ALPHA_G) * I)) \
        * torch.exp(-g(BETA_G) * I)

    no3e = no3.clamp(min=0.0)[..., None]
    nh4e = nh4.clamp(min=0.0)[..., None]
    sio3e = sio3.clamp(min=0.0)[..., None]
    k_si = g(K_SIO3_G)
    lim_no3 = no3e / (g(K_NO3_G) + no3e)
    lim_nh4 = nh4e / (g(K_NH4_G) + nh4e)
    # NH4 preference: N limitation is the combined saturation, NH4 first
    lim_n = (lim_no3 + lim_nh4).clamp(max=1.0)
    lim_si = torch.where(k_si > 0.0, sio3e / (k_si + sio3e), 1.0)
    mu = g(MU_MAX_G) * f_t * lim_light * torch.minimum(lim_n, lim_si)

    grow = mu * algae3.clamp(min=0.0) * dt        # gross, mmol N/m3
    # nutrient-availability cap across groups (no overdraw)
    need_n = grow.sum(-1)
    avail_n = 0.9 * (no3e[..., 0] + nh4e[..., 0])
    scale_n = (avail_n / need_n.clamp(min=1e-30)).clamp(max=1.0)
    grow = grow * scale_n[..., None]
    need_si = R_SI_N_DIAT * grow[..., 0]
    scale_si = (0.9 * sio3e[..., 0] / need_si.clamp(min=1e-30)).clamp(
        max=1.0)
    grow = torch.cat([(grow[..., 0] * scale_si)[..., None], grow[..., 1:]],
                     -1)

    # uptake split: NH4 first by preference ratio
    pref_nh4 = lim_nh4 / (lim_no3 + lim_nh4).clamp(min=1e-10)
    up_nh4 = torch.minimum((grow * pref_nh4).sum(-1), 0.9 * nh4e[..., 0])
    up_no3 = (grow.sum(-1) - up_nh4).clamp(min=0.0)

    resp = FR_RESP * grow
    grazed = g(GRAZED_G) * grow
    mort = g(MORT_G) * algae3.clamp(min=0.0) * dt
    algae_new = (algae3 + (grow - resp - grazed - mort)).clamp(min=0.0)

    mort_tot = (mort + resp).sum(-1)
    don_new = (don + FR_DON * mort_tot
               - K_DON * dt * don.clamp(min=0.0)).clamp(min=0.0)
    nh4_new = (nh4 - up_nh4 + (1.0 - FR_DON) * mort_tot
               + K_DON * dt * don.clamp(min=0.0)
               - K_NITRIF * dt * nh4.clamp(min=0.0)).clamp(min=0.0)
    no3_new = (no3 - up_no3
               + K_NITRIF * dt * nh4.clamp(min=0.0)).clamp(min=0.0)
    sio3_new = (sio3 - R_SI_N_DIAT * grow[..., 0]).clamp(min=0.0)
    return algae_new, no3_new, nh4_new, sio3_new, don_new, grow
