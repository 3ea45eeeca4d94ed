"""Noah-class 4-layer land-surface model, with its sea-ice and glacial
variants (port of mpas_tpu/cores/atmosphere/physics/noah.py).

ref capability: src/core_atmosphere/physics/mpas_atmphys_driver_lsm.F +
physics_wrf/module_sf_noahdrv.F / module_sf_noahlsm.F (Noah: 4 soil
layers of 0.10/0.30/0.60/1.00 m, prognostic soil temperature and moisture,
snowpack, beta-method evapotranspiration, skin temperature from the
linearized surface energy balance). Every column is independent; the soil
heat diffusion is a batched tridiagonal solve over the 4 layers; the soil
moisture moves by diffusion and gravity drainage; snow is one bulk layer
(SWE) with melt closure.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.ops.matrix import tridiagonal_solve

_SB = 5.67e-8
_LV = 2.5e6
_LF = 3.34e5
_T0 = 273.15

# soil layer thicknesses (m), Noah standard
DZS = (0.10, 0.30, 0.60, 1.00)
# loam-like soil hydraulic/thermal parameters (Noah SOILPARM genre)
SMCMAX = 0.439        # porosity
SMCREF = 0.329        # field capacity (transpiration reference)
SMCWLT = 0.066        # wilting point
DKSAT = 3.38e-6       # saturated hydraulic conductivity m/s
BEXP = 5.25           # Clapp-Hornberger b
QUARTZ = 0.35
CSOIL = 2.0e6         # soil heat capacity J/m3/K


def _qsat(t, p):
    es = 611.2 * torch.exp(17.67 * (t - _T0) / (t - 29.65))
    return 0.622 * es / torch.clamp(p - es, min=100.0)


def _layers(dzs, like):
    """The layer thicknesses as a tensor like `like`: built on the device
    from constants, no host copy."""
    return torch.stack([torch.full_like(like[0, 0], d) for d in dzs])


def soil_conductivity(smois):
    """Johansen-style thermal conductivity as a function of wetness
    (ref: module_sf_noahlsm TDFCND)."""
    sr = torch.clamp(smois / SMCMAX, 0.05, 1.0)
    k_dry = 0.25
    k_sat = 2.0
    kersten = torch.clamp(torch.log10(sr) + 1.0, min=0.0)
    return k_dry + (k_sat - k_dry) * kersten


def noah_lsm(tsk, tslb, smois, swe, gsw, glw, hfx, lh, precip_rate, dt,
             emiss=0.985, veg_frac=0.5, isltyp=None, ivgtyp=None):
    """One LSM step for every column.

    tsk: (nC,) skin temperature; tslb: (nC, 4) soil temperature; smois:
    (nC, 4) volumetric soil moisture; swe: (nC,) snow water equivalent
    (m); gsw/glw: surface radiation (W/m2); hfx/lh: sensible / latent heat
    flux from the surface layer (W/m2, positive up); precip_rate: liquid
    precipitation reaching the ground (m/s). isltyp/ivgtyp: optional
    per-cell STATSGO soil (1-19) and USGS vegetation (1-24) classes, which
    switch to the SOILPARM/VEGPARM tables of noah_tables.py; without them
    the loam defaults and veg_frac apply.

    Returns dict(tsk, tslb, smois, swe, beta, g_flux, snow_melt) (ref:
    SFLX -> SHFLX / SMFLX / SNOPAC-SNOWPACK)."""
    dzs = _layers(DZS, tslb)
    if isltyp is not None:
        from mpas_tpu_torch.cores.atmosphere.physics.noah_tables import \
            soil_params
        sp = soil_params(isltyp, tslb.dtype)
        smcmax = sp["smcmax"][:, None]
        smcref = sp["smcref"]
        smcwlt = sp["smcwlt"]
        bexp = sp["bb"][:, None]
        dksat = sp["satdk"][:, None]
        # Johansen-genre conductivity: quartz-rich soils conduct more
        k_dry = 0.15 + 0.25 * sp["qtz"][:, None]
    else:
        smcmax, smcref, smcwlt = SMCMAX, SMCREF, SMCWLT
        bexp, dksat = BEXP, DKSAT
        k_dry = None
    if ivgtyp is not None:
        from mpas_tpu_torch.cores.atmosphere.physics.noah_tables import \
            veg_params
        vp = veg_params(ivgtyp, tslb.dtype)
        # stomatal limitation: transpiration efficiency ~ LAI/(LAI+rsmin/50)
        stoma = vp["lai"] / (vp["lai"] + vp["rsmin"] / 50.0 + 1e-6)
        veg_frac = vp["shdfac"] * torch.clamp(stoma * 2.0, 0.2, 1.0)
    kt = soil_conductivity(smois)                            # (nC, 4)
    if k_dry is not None:
        sr_k = torch.clamp(smois / smcmax, 0.05, 1.0)
        kt = k_dry + (2.0 - k_dry) * sr_k     # quartz-aware Johansen form

    # --- skin temperature: linearized energy balance --------------------
    # Rnet - H - LE - G = 0, G = k1 (tsk - T1) / (dz1/2)
    snow_cover = torch.clamp(swe / 0.02, 0.0, 1.0)
    emiss_eff = emiss * (1.0 - 0.02 * snow_cover)
    kg = kt[:, 0] / (0.5 * dzs[0])
    f = (gsw + emiss_eff * glw - emiss_eff * _SB * tsk ** 4
         - hfx - lh - kg * (tsk - tslb[:, 0]))
    dfdt = -4.0 * emiss_eff * _SB * tsk ** 3 - kg
    tsk_new = tsk - f / dfdt
    # snow caps the skin at freezing; the residual energy melts snow
    has_snow = swe > 1e-6
    tsk_capped = torch.where(has_snow, torch.clamp(tsk_new, max=_T0),
                             tsk_new)
    melt_energy = torch.where(
        has_snow & (tsk_new > _T0),
        torch.clamp(gsw + emiss_eff * glw - emiss_eff * _SB * _T0 ** 4
                    - hfx - lh - kg * (_T0 - tslb[:, 0]), min=0.0), 0.0)
    snow_melt = torch.minimum(dt * melt_energy / (_LF * 1000.0), swe)
    g_flux = kg * (tsk_capped - tslb[:, 0])

    # --- soil heat diffusion (implicit tridiagonal over 4 layers) -------
    # interface conductance between layer i and i+1
    kh = 2.0 * kt[:, :-1] * kt[:, 1:] / torch.clamp(
        kt[:, :-1] * dzs[1:] + kt[:, 1:] * dzs[:-1], min=1e-9)  # (nC, 3)
    eta = dt / (CSOIL * dzs)[None, :]
    zero = torch.zeros_like(kh[:, :1])
    a = -eta * torch.cat([zero, kh], dim=1)
    c = -eta * torch.cat([kh, zero], dim=1)
    b = 1.0 - a - c
    d = tslb + eta * torch.cat([g_flux[:, None], torch.zeros_like(kh)],
                               dim=1)
    # bottom boundary: zero flux (deep climate handled by layer 4 inertia)
    tslb_new = tridiagonal_solve(a, b, c, d)

    # --- soil moisture -------------------------------------------------
    infiltration = precip_rate + snow_melt / max(dt, 1e-9)
    # beta-method evapotranspiration from the root zone (layers 1-3)
    root_sm = (smois[:, 0] * dzs[0] + smois[:, 1] * dzs[1]
               + smois[:, 2] * dzs[2]) / (dzs[0] + dzs[1] + dzs[2])
    beta = torch.clamp((root_sm - smcwlt) / (smcref - smcwlt + 1e-9),
                       0.0, 1.0)
    et_rate = torch.clamp(lh, min=0.0) / (_LV * 1000.0)     # m/s of water
    # diffusion between layers (soil water diffusivity from C-H relations)
    sr = torch.clamp(smois / smcmax, 0.05, 1.0)
    dwdif = dksat * bexp * sr ** (bexp + 2.0) * 0.5          # m2/s scaled
    flux_int = dwdif[:, :-1] * (smois[:, :-1] - smois[:, 1:]) \
        / (0.5 * (dzs[:-1] + dzs[1:]))[None, :]              # (nC,3) down +
    if isinstance(dksat, torch.Tensor):                      # bottom drain
        drain = (dksat * sr ** (2.0 * bexp + 3.0))[:, -1]
    else:
        drain = DKSAT * sr[:, -1] ** (2.0 * BEXP + 3.0)
    dsm = torch.stack([
        (infiltration - et_rate * veg_frac - flux_int[:, 0]) / dzs[0],
        (flux_int[:, 0] - flux_int[:, 1]) / dzs[1],
        (flux_int[:, 1] - flux_int[:, 2]) / dzs[2],
        (flux_int[:, 2] - drain) / dzs[3]], dim=1)
    smois_new = torch.clamp(smois + dt * dsm, min=0.02)
    smois_new = torch.minimum(smois_new, smcmax) \
        if isinstance(smcmax, torch.Tensor) \
        else torch.clamp(smois_new, max=smcmax)

    swe_new = torch.clamp(swe - snow_melt, min=0.0)

    return {
        "tsk": tsk_capped, "tslb": tslb_new, "smois": smois_new,
        "swe": swe_new, "beta": beta, "g_flux": g_flux,
        "snow_melt": snow_melt,
    }


def noah_surface_moisture(tsk, p_sfc, beta):
    """qsfc for the surface-layer scheme: beta-scaled saturation
    (ref: Noah beta-method evaporation)."""
    return beta * _qsat(tsk, p_sfc)


# sea-ice slab properties (module_sf_noah_seaice.F genre)
DZI = (0.10, 0.30, 0.60, 1.00)     # ice "soil" layers
K_ICE = 2.2                        # W/m/K
C_ICE = 1.88e6                     # J/m3/K
T_SEAWATER = 271.36                # K, bottom boundary (-1.79 C)


def _slab_column_step(tsk, tlayers, swe, gsw, glw, hfx, lh, dt,
                      k_cond, c_heat, t_bottom=None, emiss=0.98):
    """Shared 4-layer slab (ice/firn) heat column: linearized skin energy
    balance, implicit tridiagonal interior diffusion, snow melt capping.
    t_bottom: fixed Dirichlet bottom temperature (None = zero flux)."""
    dzs = _layers(DZI, tlayers)
    kg = k_cond / (0.5 * dzs[0])
    f = (gsw + emiss * glw - emiss * _SB * tsk ** 4
         - hfx - lh - kg * (tsk - tlayers[:, 0]))
    dfdt = -4.0 * emiss * _SB * tsk ** 3 - kg
    tsk_new = tsk - f / dfdt
    # ice/snow surfaces melt at 0 C; residual energy melts snow then ice
    tsk_capped = torch.clamp(tsk_new, max=_T0)
    melt_energy = torch.where(
        tsk_new > _T0,
        torch.clamp(gsw + emiss * glw - emiss * _SB * _T0 ** 4
                    - hfx - lh - kg * (_T0 - tlayers[:, 0]), min=0.0), 0.0)
    snow_melt = torch.minimum(dt * melt_energy / (_LF * 1000.0), swe)
    g_flux = kg * (tsk_capped - tlayers[:, 0])

    kh_val = k_cond / (0.5 * (dzs[:-1] + dzs[1:]))           # (3,)
    kh = kh_val[None, :].expand(tlayers.shape[0], 3)
    eta = dt / (c_heat * dzs)[None, :]
    zero = torch.zeros_like(kh[:, :1])
    a = -eta * torch.cat([zero, kh], dim=1)
    c = -eta * torch.cat([kh, zero], dim=1)
    b = 1.0 - a - c
    d = torch.cat([tlayers[:, :1] + (eta[:, 0] * g_flux)[:, None],
                   tlayers[:, 1:]], dim=1)
    if t_bottom is not None:
        # Dirichlet bottom: conductive coupling to fixed seawater temp
        kb = k_cond / (0.5 * dzs[-1])
        b = torch.cat([b[:, :-1], b[:, -1:] + eta[:, -1:] * kb], dim=1)
        d = torch.cat([d[:, :-1], d[:, -1:] + eta[:, -1:] * kb * t_bottom],
                      dim=1)
    t_new = tridiagonal_solve(a, b, c, d)
    return tsk_capped, t_new, torch.clamp(swe - snow_melt, min=0.0), \
        g_flux, snow_melt


def noah_seaice(tsk, tslb, swe, gsw, glw, hfx, lh, dt):
    """Noah sea-ice surface (ref: module_sf_noah_seaice.F SFLX_SEAICE): a
    4-layer ice slab with fixed seawater temperature at the base,
    snow-on-ice melt, skin capped at freezing. Returns dict(tsk, tslb,
    swe, g_flux, snow_melt, basal_flux)."""
    tsk2, t2, swe2, g, melt = _slab_column_step(
        tsk, tslb, swe, gsw, glw, hfx, lh, dt, K_ICE, C_ICE,
        t_bottom=T_SEAWATER)
    basal = K_ICE / (0.5 * DZI[-1]) * (T_SEAWATER - t2[:, -1])
    return {"tsk": tsk2, "tslb": t2, "swe": swe2, "g_flux": g,
            "snow_melt": melt, "basal_flux": basal}


def noah_glacial(tsk, tslb, swe, gsw, glw, hfx, lh, dt):
    """Noah glacial-land surface (ref: the glacial branches of
    module_sf_noahdrv.F SFLX over permanent land ice): a firn column
    (reduced conductivity and heat capacity), zero-flux base, melt water
    runs off (no soil moisture). Returns dict(tsk, tslb, swe, g_flux,
    snow_melt, runoff)."""
    k_firn, c_firn = 1.0, 1.5e6
    tsk2, t2, swe2, g, melt = _slab_column_step(
        tsk, tslb, swe, gsw, glw, hfx, lh, dt, k_firn, c_firn,
        t_bottom=None)
    return {"tsk": tsk2, "tslb": t2, "swe": swe2, "g_flux": g,
            "snow_melt": melt, "runoff": melt}
