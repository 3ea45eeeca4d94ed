"""WSM6 six-class microphysics (port of
mpas_tpu/cores/atmosphere/physics/wsm6.py).

ref: src/core_atmosphere/physics/physics_wrf/module_mp_wsm6.F — the WRF
Single-Moment 6-class scheme (Hong & Lim 2006): Marshall-Palmer rain, snow
and graupel with slope-parameter process rates, a temperature-dependent
snow intercept, ventilated evaporation/deposition/melting, Biggs freezing,
Fletcher ice nuclei and slope-based mass-weighted sedimentation. Constants
follow the reference parameter block (module_mp_wsm6.F:13-34, wsm6init
:1575-1583, hail_opt=0).

Every process is elementwise over (nCells, nz) columns; rates are clamped
to the mass available and applied in the reference's order (warm -> ice ->
melt/freeze -> saturation adjustment -> sedimentation). Sedimentation takes
a fixed three sub-steps, so a call reads nothing back from the device.
"""

from __future__ import annotations

import math

import torch

from mpas_tpu_torch.constants import cp, rgas

_T0 = 273.15
_RV = 461.6
_LV = 2.5e6          # vaporization J/kg
_LS = 2.85e6         # sublimation
_LF = _LS - _LV      # fusion
_EP2 = rgas / _RV

# --- reference parameter block (module_mp_wsm6.F:13-34) -------------------
N0R = 8.0e6          # rain intercept (m^-4)
N0S0 = 2.0e6         # snow intercept at T0
N0S_ALPHA = 0.12     # exp factor for n0s(T)
N0SMAX = 1.0e11
N0G = 4.0e6          # graupel intercept (hail_opt=0, wsm6init :1581)
DENR = 1000.0        # rain density
DENS = 100.0         # snow density
DENG = 500.0         # graupel density (hail_opt=0)
AVTR, BVTR = 841.9, 0.8
AVTS, BVTS = 11.72, 0.41
AVTG, BVTG = 330.0, 0.8
R0 = 0.8e-5          # 8 um autoconversion radius
PEAUT = 0.55         # autoconversion collection efficiency
XNCR = 3.0e8         # cloud droplet number (maritime)
XMYU = 1.718e-5      # dynamic viscosity
DICON = 11.9         # cloud-ice diameter constant
DIMAX = 500.0e-6
QS0 = 6.0e-4         # snow->graupel threshold
PFRZ1, PFRZ2 = 100.0, 0.66   # Biggs freezing
QCRMIN = 1.0e-9
LAMDARMAX, LAMDASMAX, LAMDAGMAX = 8.0e4, 1.0e5, 6.0e4
DEN0 = 1.28          # reference air density
KA = 2.4e-2          # thermal conductivity of air
DVAP = 2.26e-5       # vapor diffusivity
SC13 = 0.60 ** (1.0 / 3.0)   # Schmidt^(1/3)

_G = math.gamma
PI = math.pi
# precomputed gamma-function factors (the wsm6init block)
PVTR = AVTR * _G(4.0 + BVTR) / 6.0
PVTS = AVTS * _G(4.0 + BVTS) / 6.0
PVTG = AVTG * _G(4.0 + BVTG) / 6.0
PACRR = PI * N0R * AVTR * _G(3.0 + BVTR) / 4.0
PACRS = PI * AVTS * _G(3.0 + BVTS) / 4.0       # * n0s(T) at use
PACRG = PI * N0G * AVTG * _G(3.0 + BVTG) / 4.0
PRECR1 = 2.0 * PI * N0R * 0.78
PRECR2 = 2.0 * PI * N0R * 0.31 * SC13 * _G((5.0 + BVTR) / 2.0) \
    * math.sqrt(AVTR / XMYU * 1.2)
PRECS1 = 2.0 * PI * 0.78                       # * n0s(T)
PRECS2 = 2.0 * PI * 0.31 * SC13 * _G((5.0 + BVTS) / 2.0) \
    * math.sqrt(AVTS / XMYU * 1.2)
PRECG1 = 2.0 * PI * N0G * 0.78
PRECG2 = 2.0 * PI * N0G * 0.31 * SC13 * _G((5.0 + BVTG) / 2.0) \
    * math.sqrt(AVTG / XMYU * 1.2)
PIDN0R = PI * DENR * N0R
PIDN0S = PI * DENS * N0S0
PIDN0G = PI * DENG * N0G
# Tripoli-Cotton autoconversion coefficient (wsm6init qck1)
QCK1 = 0.104 * 9.8 * PEAUT / ((XNCR * DENR) ** (1.0 / 3.0)) / XMYU \
    * DEN0 ** (4.0 / 3.0)
ROQIMAX = 2.08e22 * DIMAX ** 8


def _qsat_liq(t, p):
    es = 611.2 * torch.exp(17.67 * (t - _T0) / (t - 29.65))
    return _EP2 * es / torch.clamp(p - es, min=1.0)


def _qsat_ice(t, p):
    es = 611.2 * torch.exp(21.8745584 * (t - _T0) / (t - 7.66))
    return _EP2 * es / torch.clamp(p - es, min=1.0)


def _slope(q, rho, pidn0, lmax):
    """Marshall-Palmer slope lambda = (pi rho_x n0 / (rho q))^0.25."""
    lam = (pidn0 / (rho * torch.clamp(q, min=QCRMIN))) ** 0.25
    return torch.clamp(lam, max=lmax)


def _sediment(q, rho, dz, vfall, dt, nsub: int = 3):
    """Upstream flux-form sedimentation in `nsub` sub-steps; level 0 is the
    lowest. Returns (q, surface fallout in kg/m2)."""
    sfc = torch.zeros_like(q[:, 0])
    dts = dt / nsub
    zero_top = torch.zeros_like(q[:, :1])
    for _ in range(nsub):
        cfl = torch.clamp(dts * vfall / dz, max=0.95)
        out = q * cfl
        outm = out * rho * dz
        # inflow from the level above
        inflow = torch.cat([outm[:, 1:], zero_top], dim=-1)
        q = q - out + inflow / (rho * dz)
        sfc = sfc + outm[:, 0]
    return q, sfc


def _take(dt, src_q, *rates):
    """Scale a set of sink rates so that their sum cannot overdraw src."""
    total = sum(rates)
    avail = torch.clamp(src_q, min=0.0) / dt
    fac = torch.where(total > avail,
                      avail / torch.clamp(total, min=1e-30), 1.0)
    return [r * fac for r in rates]


def wsm6(th, qv, qc, qr, qi, qs, qg, rho, exner, p, dz, dt):
    """One WSM6 step on (nCells, nz) columns (level 0 lowest). Returns
    (th, qv, qc, qr, qi, qs, qg, surface precipitation [m liquid])."""
    t = th * exner
    sqrho = torch.sqrt(DEN0 / rho)

    qsl = _qsat_liq(t, p)
    qsi = _qsat_ice(t, p)
    cold = t < _T0
    supcold = t < _T0 - 40.0
    warm = ~cold

    # thermodynamic denominators for ventilated vapor exchange
    ab_liq = _LV ** 2 / (KA * _RV * t * t) + 1.0 / (rho * qsl * DVAP)
    ab_ice = _LS ** 2 / (KA * _RV * t * t) + 1.0 / (rho * qsi * DVAP)

    lam_r = _slope(qr, rho, PIDN0R, LAMDARMAX)
    n0s_t = torch.clamp(N0S0 * torch.exp(N0S_ALPHA * (_T0 - t)), max=N0SMAX)
    lam_s = _slope(qs, rho, PI * DENS * 1.0, LAMDASMAX) \
        * (n0s_t / 1.0) ** 0.25
    lam_g = _slope(qg, rho, PIDN0G, LAMDAGMAX)

    sat_l = qv / qsl - 1.0
    sat_i = qv / qsi - 1.0
    has_r, has_s, has_g = qr > QCRMIN, qs > QCRMIN, qg > QCRMIN

    # --- warm-rain processes (ref :praut/pracw/prevp loops) ---------------
    qc0 = 4.0 * PI / 3.0 * DENR * R0 ** 3 * XNCR / rho
    praut = torch.where(qc > qc0, QCK1 * qc ** (7.0 / 3.0), 0.0)
    pracw = PACRR * lam_r ** (-(3.0 + BVTR)) * qc * sqrho * has_r
    prevp_rate = (PRECR1 * lam_r ** -2.0
                  + PRECR2 * sqrho ** 0.5
                  * lam_r ** (-(5.0 + BVTR) / 2.0)) \
        * sat_l / (rho * ab_liq)
    prevp = torch.where((sat_l < 0.0) & has_r,
                        torch.maximum(prevp_rate, -qr / dt), 0.0)

    # --- ice-phase processes ----------------------------------------------
    # Fletcher ice nuclei + WSM ice number/diameter
    xni = torch.clamp(5.38e7 * (rho * torch.clamp(qi, min=1e-12)) ** 0.75,
                      1.0e3, 1.0e6 * 1.0e3)
    mi = rho * torch.clamp(qi, min=0.0) / xni
    di = torch.clamp(DICON * torch.sqrt(torch.clamp(mi, min=0.0)), max=DIMAX)
    # ice initiation (pigen; Fletcher 1962 nuclei)
    xni0 = 1.0e3 * torch.exp(0.1 * (_T0 - t))
    qi_crit = 4.92e-11 * xni0 ** 1.33 / rho
    pigen = torch.where(cold & (sat_i > 0.0),
                        torch.clamp(torch.minimum(qi_crit - qi, qv - qsi),
                                    min=0.0) / dt, 0.0)
    # ice deposition/sublimation (pisd)
    pisd = 4.0 * di * xni * sat_i / (rho * ab_ice)
    pisd = torch.where(cold, torch.clamp(pisd, -qi / dt,
                                         (qv - qsi) / dt / 2.0), 0.0)
    # ice -> snow autoconversion (psaut; roqimax cap)
    qimax = ROQIMAX / rho
    psaut = torch.where(cold, torch.clamp(qi - qimax, min=0.0) / dt, 0.0)
    # snow collecting ice / cloud (psaci, psacw)
    eacrs = torch.exp(0.07 * (t - _T0))          # ice-snow efficiency
    acr_s = PACRS * n0s_t * lam_s ** (-(3.0 + BVTS)) * sqrho
    psaci = torch.where(cold, acr_s * eacrs * qi * has_s, 0.0)
    psacw = acr_s * qc * has_s                   # ->snow cold, ->rain warm
    # graupel collecting cloud / ice
    acr_g = PACRG * lam_g ** (-(3.0 + BVTG)) * sqrho
    pgacw = acr_g * qc * has_g
    pgaci = torch.where(cold, acr_g * 0.1 * qi * has_g, 0.0)
    # snow deposition/sublimation with ventilation (psdep/psevp)
    vent_s = (PRECS1 * n0s_t * lam_s ** -2.0
              + PRECS2 * n0s_t * sqrho ** 0.5
              * lam_s ** (-(5.0 + BVTS) / 2.0))
    dep_cap = torch.clamp(qv - qsi, min=0.0) / dt / 2.0
    psdep_rate = vent_s * sat_i / (rho * ab_ice)
    psdep = torch.where(cold & has_s,
                        torch.clamp(psdep_rate, -qs / dt, dep_cap), 0.0)
    # graupel deposition/sublimation
    vent_g = (PRECG1 * lam_g ** -2.0
              + PRECG2 * sqrho ** 0.5 * lam_g ** (-(5.0 + BVTG) / 2.0))
    pgdep_rate = vent_g * sat_i / (rho * ab_ice)
    pgdep = torch.where(cold & has_g,
                        torch.clamp(pgdep_rate, -qg / dt, dep_cap), 0.0)
    # snow -> graupel autoconversion (pgaut)
    pgaut = torch.where(cold & (qs > QS0),
                        1.0e-3 * torch.exp(0.09 * (t - _T0)) * (qs - QS0),
                        0.0)
    # Biggs freezing of rain -> graupel (pgfrz)
    pgfrz = torch.where(t < _T0 - 4.0,
                        20.0 * PI ** 2 * PFRZ1 * N0R * DENR / rho
                        * (torch.exp(PFRZ2 * (_T0 - t)) - 1.0)
                        * lam_r ** -7.0, 0.0)
    # melting with ventilation (psmlt/pgmlt; heat balance
    # m = Ka (T - T0) * VENT / (rho Lf), ref :psmlt/pgmlt loops)
    melt_s = torch.where(warm & has_s,
                         KA * (t - _T0) * vent_s / (rho * _LF), 0.0)
    melt_g = torch.where(warm & has_g,
                         KA * (t - _T0) * vent_g / (rho * _LF), 0.0)
    pimlt = torch.where(warm, qi / dt, 0.0)      # instantaneous ice melt
    pihmf = torch.where(supcold, qc / dt, 0.0)   # homogeneous freezing

    # --- clamp and apply (reference order; all rates kg/kg/s >= 0) --------
    # cloud-water sinks
    praut, pracw, psacw, pgacw, pihmf = _take(dt, qc, praut, pracw, psacw,
                                              pgacw, pihmf)
    # cloud-ice sinks (sublimation = negative pisd)
    pisub = torch.clamp(-pisd, min=0.0)
    pidep = torch.clamp(pisd, min=0.0)
    psaut, psaci, pgaci, pisub, pimlt = _take(dt, qi, psaut, psaci, pgaci,
                                              pisub, pimlt)
    # rain sinks
    prevap = torch.clamp(-prevp, min=0.0)
    prevap, pgfrz = _take(dt, qr, prevap, pgfrz)
    # snow sinks
    pssub = torch.clamp(-psdep, min=0.0)
    psdep_pos = torch.clamp(psdep, min=0.0)
    pgaut, pssub, psmlt = _take(dt, qs, pgaut, pssub, melt_s)
    # graupel sinks
    pgsub = torch.clamp(-pgdep, min=0.0)
    pgdep_pos = torch.clamp(pgdep, min=0.0)
    pgsub, pgmlt = _take(dt, qg, pgsub, melt_g)
    # vapor-limited deposition/initiation sources
    dep_tot = pigen + pidep + psdep_pos + pgdep_pos
    sup_av = torch.clamp(qv - qsi, min=0.0) / dt
    dfac = torch.where(dep_tot > sup_av,
                       sup_av / torch.clamp(dep_tot, min=1e-30), 1.0)
    pigen, pidep = pigen * dfac, pidep * dfac
    psdep_pos, pgdep_pos = psdep_pos * dfac, pgdep_pos * dfac

    psacw_cold = torch.where(cold, psacw, 0.0)
    psacw_warm = psacw - psacw_cold
    pgacw_cold = torch.where(cold, pgacw, 0.0)
    pgacw_warm = pgacw - pgacw_cold

    dqv = (-(pigen + pidep + psdep_pos + pgdep_pos)
           + prevap + pisub + pssub + pgsub) * dt
    dqc = (-(praut + pracw + psacw + pgacw + pihmf) + pimlt) * dt
    dqr = (praut + pracw + psacw_warm + pgacw_warm - prevap - pgfrz
           + psmlt + pgmlt) * dt
    dqi = (pigen + pidep + pihmf
           - psaut - psaci - pgaci - pisub - pimlt) * dt
    dqs = (psaut + psaci + psacw_cold + psdep_pos
           - pssub - pgaut - psmlt) * dt
    dqg = (pgaut + pgfrz + pgaci + pgacw_cold + pgdep_pos
           - pgsub - pgmlt) * dt

    # latent heating: vapor<->ice Ls, vapor<->liquid Lv, liquid<->ice Lf
    dheat = (_LS * (pigen + pidep + psdep_pos + pgdep_pos
                    - pisub - pssub - pgsub)
             - _LV * prevap
             + _LF * (pihmf + pgfrz + psacw_cold + pgacw_cold
                      - psmlt - pgmlt - pimlt)) * dt / cp

    qv = qv + dqv
    qc = torch.clamp(qc + dqc, min=0.0)
    qr = torch.clamp(qr + dqr, min=0.0)
    qi = torch.clamp(qi + dqi, min=0.0)
    qs = torch.clamp(qs + dqs, min=0.0)
    qg = torch.clamp(qg + dqg, min=0.0)
    t = t + dheat

    # --- saturation adjustment (pcond; liquid above -40C) -----------------
    qsl = _qsat_liq(t, p)
    cond = (qv - qsl) / (1.0 + _LV ** 2 * qsl / (cp * _RV * t * t))
    cond = torch.maximum(cond, -qc)
    cond = torch.where(t > _T0 - 40.0, cond, 0.0)
    qv = qv - cond
    qc = qc + cond
    t = t + _LV / cp * cond

    # --- sedimentation (slope-based mass-weighted fall speeds) ------------
    lam_r = _slope(qr, rho, PIDN0R, LAMDARMAX)
    lam_s = _slope(qs, rho, PI * DENS * 1.0, LAMDASMAX) \
        * (torch.clamp(N0S0 * torch.exp(N0S_ALPHA * (_T0 - t)), max=N0SMAX)
           / 1.0) ** 0.25
    lam_g = _slope(qg, rho, PIDN0G, LAMDAGMAX)
    vr = torch.clamp(PVTR * lam_r ** -BVTR * sqrho, max=12.0) \
        * (qr > QCRMIN)
    vs = torch.clamp(PVTS * lam_s ** -BVTS * sqrho, max=6.0) * (qs > QCRMIN)
    vg = torch.clamp(PVTG * lam_g ** -BVTG * sqrho, max=12.0) \
        * (qg > QCRMIN)
    vi = torch.clamp(1.49e4 * di ** 1.31, max=1.5) * (qi > QCRMIN)
    qr, rain = _sediment(qr, rho, dz, vr, dt)
    qs, snow = _sediment(qs, rho, dz, vs, dt)
    qg, graup = _sediment(qg, rho, dz, vg, dt)
    qi, _ = _sediment(qi, rho, dz, vi, dt)

    th_new = t / exner
    rain_total = (rain + snow + graup) / 1000.0    # m liquid equivalent
    return (th_new, torch.clamp(qv, min=0.0), qc, qr, qi, qs, qg, rain_total)
