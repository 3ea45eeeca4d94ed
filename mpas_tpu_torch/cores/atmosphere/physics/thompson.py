"""Thompson-class partially two-moment microphysics (port of
mpas_tpu/cores/atmosphere/physics/thompson.py).

ref capability: src/core_atmosphere/physics/physics_wrf/
module_mp_thompson.F (Thompson et al. 2008): six hydrometeor classes
(qv, qc, qr, qi, qs, qg) with prognostic number concentrations for rain
(nr) and cloud ice (ni). WSM6's process graph with two-moment rain and
ice closures: gamma-distribution mean sizes, separate mass and number fall
speeds, number sources and sinks for each process.

The size-distribution integrals (mass- and number-weighted fall speeds,
evaporation ventilation, the cloud accretion kernel, Bigg freezing) come
from the lookup tables of data/thompson_k.npz (the port's byte-for-byte
copy; ref: mpas_atmphys_build_tables_thompson.F:1-145), interpolated on
the log mean-volume-diameter grid. The tables go to the device once per
(device, dtype); a call reads nothing back from the device.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from mpas_tpu_torch.constants import cp
from mpas_tpu_torch.cores.atmosphere.physics.wsm6 import (_qsat_ice, _qsat_liq,
                                                          _sediment)

_LV = 2.5e6
_LF = 3.34e5
_LS = _LV + _LF
_RV = 461.5
_T0 = 273.15
RHO_W = 1000.0
RHO_I = 890.0
# number-concentration bounds (1/kg)
NR_MIN, NR_MAX = 1.0e-2, 1.0e8
NI_MIN, NI_MAX = 1.0e-2, 1.0e8
N0_RAIN_DEFAULT = 8.0e6      # Marshall-Palmer intercept fallback
NC_CLOUD = 1.0e8             # prescribed droplet number (1/kg)

# (table name, its abscissa, whether the abscissa is log-spaced)
_CURVES = {"acc_rain": ("d_rain", True), "vent_rain": ("d_rain", True),
           "vr_mass": ("d_rain", True), "vr_num": ("d_rain", True),
           "vi_mass": ("d_ice", True), "vi_num": ("d_ice", True),
           "bigg_rate": ("dT_freeze", False)}


@functools.cache
def _tables_np():
    path = os.path.join(os.path.dirname(__file__), "data", "thompson_k.npz")
    raw = {k: np.asarray(v) for k, v in np.load(path).items()}
    for name in ("d_rain", "d_ice", "dT_freeze"):
        assert (np.diff(raw[name]) > 0.0).all(), name
    return raw


@functools.cache
def _tables(device, dtype):
    """Each curve as (x grid, y, x range) tensors on (device, dtype): the x
    grid is log(d) on the diameter tables (np.log on the host, as the
    reference's). Copied there once, so that a call makes no host-to-device
    copy."""
    raw = _tables_np()
    out = {}
    for name, (xname, log) in _CURVES.items():
        xg = raw[xname]
        out[name] = (torch.as_tensor(np.log(xg) if log else xg,
                                     device=device, dtype=dtype),
                     torch.as_tensor(raw[name], device=device, dtype=dtype),
                     (float(xg[0]), float(xg[-1])))
    return out


def _interp(x, xp, fp):
    """jnp.interp(x, xp, fp) for a strictly increasing 1-D xp: linear
    between the nodes, fp[0] below xp[0] and fp[-1] above xp[-1]."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    f = f0 + ((x - x0) / (xp[i] - x0)) * (fp[i] - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _curve(tab, name, x):
    """The tabulated curve `name` at x: on the diameter tables x is clipped
    to the grid and interpolated in log(x) (the reference's _interp_log),
    on the freezing table in x itself."""
    xp, fp, (lo, hi) = tab[name]
    if _CURVES[name][1]:
        x = torch.log(torch.clamp(x, lo, hi))
    return _interp(x, xp, fp)


def _rain_diameter(qr, nr, rho):
    """Mass-mean rain diameter from (q, n) (exponential distribution)."""
    m = rho * torch.clamp(qr, min=1e-12)
    n = rho * torch.clamp(nr, NR_MIN, NR_MAX)
    d = (6.0 * m / (math.pi * RHO_W * torch.clamp(n, min=1.0))) \
        ** (1.0 / 3.0)
    return torch.clamp(d, 20.0e-6, 6.0e-3)


def _ice_diameter(qi, ni, rho):
    m = rho * torch.clamp(qi, min=1e-12)
    n = rho * torch.clamp(ni, NI_MIN, NI_MAX)
    d = (6.0 * m / (math.pi * RHO_I * torch.clamp(n, min=1.0))) \
        ** (1.0 / 3.0)
    return torch.clamp(d, 5.0e-6, 1.0e-3)


def thompson(th, qv, qc, qr, qi, qs, qg, nr, ni, rho, exner, p, dz, dt):
    """One Thompson step on (nCells, nz) columns (level 0 lowest).
    Returns (th, qv, qc, qr, qi, qs, qg, nr, ni, rain_total_m)."""
    tab = _tables(th.device, th.dtype)
    t = th * exner

    # --- saturation adjustment (as WSM6; activation sets cloud number) ---
    qsl = _qsat_liq(t, p)
    cond = (qv - qsl) / (1.0 + _LV ** 2 * qsl / (cp * _RV * t * t))
    cond = torch.maximum(cond, -qc)
    cond = torch.where(t > _T0 - 40.0, cond, 0.0)
    qv = qv - cond
    qc = qc + cond
    t = t + _LV / cp * cond

    qsi = _qsat_ice(t, p)
    cold = t < _T0
    dep = (qv - qsi) / (1.0 + _LS ** 2 * qsi / (cp * _RV * t * t))
    dep = torch.where(cold, torch.maximum(dep, -qi), 0.0)
    dep = torch.where(t < _T0 - 40.0, torch.clamp(dep, min=0.0), dep * 0.5)
    # ice nucleation number source (Cooper 1986 activation)
    n_nuc = torch.where((dep > 0.0) & cold,
                        torch.clamp(5.0 * torch.exp(0.304 * (_T0 - t)),
                                    max=1e5) / torch.clamp(rho, min=0.1),
                        0.0)
    ni = torch.where(dep > 0.0, torch.maximum(ni, n_nuc), ni)
    qv = qv - dep
    qi = qi + dep
    t = t + _LS / cp * dep

    # --- warm rain, two-moment (Berry-Reinhardt-style autoconversion) ---
    # the autoconversion rate grows with the droplet size (qc/Nc)
    rc = (3.0 * rho * torch.clamp(qc, min=0.0)
          / (4.0 * math.pi * RHO_W * NC_CLOUD * rho + 1e-6)) ** (1.0 / 3.0)
    auto_on = (rc > 6.0e-6).to(qc.dtype)
    praut = auto_on * torch.minimum(
        dt * 1.0e-3 * torch.clamp(qc - 2.0e-4, min=0.0), qc)
    # autoconversion creates drops of ~50 micron
    m_drop50 = math.pi / 6.0 * RHO_W * (50.0e-6) ** 3
    nraut = praut * rho / m_drop50 / rho

    d_r = _rain_diameter(qr, nr, rho)
    # cloud accretion by rain: number-normalized swept-volume kernel from
    # the DSD integral table x rain number (ref: the qr_acr_qc moment of
    # module_mp_thompson.F; table acc_rain)
    acc_k = _curve(tab, "acc_rain", d_r)               # m3/s per drop
    pracw = torch.minimum(dt * acc_k * rho * torch.clamp(nr, NR_MIN, NR_MAX)
                          * qc, torch.clamp(qc - praut, min=0.0))
    pracw = torch.clamp(pracw, min=0.0)
    qc = qc - praut - pracw
    qr = qr + praut + pracw
    nr = nr + nraut

    # rain evaporation: ventilation DSD integral from the table (the
    # reference's tpi ventilation moments)
    qsl = _qsat_liq(t, p)
    sub = torch.clamp(1.0 - qv / torch.clamp(qsl, min=1e-12), min=0.0)
    vent = _curve(tab, "vent_rain", d_r) / torch.clamp(d_r, min=1e-6)
    prevp = torch.minimum(dt * 1.0e-3 * sub * vent * 2.0e-3
                          * (rho * torch.clamp(qr, min=0.0)) ** 0.65, qr)
    qr = qr - prevp
    qv = qv + prevp
    t = t - _LV / cp * prevp
    # number reduction proportional to the mass evaporated
    nr = nr * (1.0 - 0.8 * prevp / torch.clamp(qr + prevp, min=1e-12))

    # --- ice phase (WSM6 graph + number bookkeeping) ---------------------
    d_i = _ice_diameter(qi, ni, rho)
    psaut = torch.where(cold & (d_i > 100.0e-6),
                        torch.clamp(qi - 1.0e-4, min=0.0)
                        * (1.0 - math.exp(-dt / 1000.0)), 0.0)
    ni = ni * (1.0 - psaut / torch.clamp(qi, min=1e-12))
    qi = qi - psaut
    qs = qs + psaut

    psacw = torch.where(cold, torch.minimum(
        dt * 1.5 * qc * (rho * torch.clamp(qs, min=0.0)) ** 0.75, qc), 0.0)
    to_g = 0.5 * psacw * (qs > 1.0e-4)
    qc = qc - psacw
    qs = qs + psacw - to_g
    qg = qg + to_g
    t = t + _LF / cp * psacw

    # Bigg immersion freezing from the tabulated supercooling integral
    # (ref: the freezeH2O table build, module_mp_thompson.F)
    bigg = _curve(tab, "bigg_rate", torch.clamp(_T0 - t, 0.0, 40.0))
    d_r3 = d_r ** 3
    pgfrz = torch.where(t < _T0, torch.minimum(dt * bigg * d_r3
                                               * rho * qr * 1.0e6, qr), 0.0)
    nr = nr * (1.0 - pgfrz / torch.clamp(qr, min=1e-12))
    qr = qr - pgfrz
    qg = qg + pgfrz
    t = t + _LF / cp * pgfrz

    melt_rate = torch.where(t > _T0, (t - _T0) * 2.0e-4, 0.0)
    psmlt = torch.minimum(dt * melt_rate * 5.0, qs)
    pgmlt = torch.minimum(dt * melt_rate, qg)
    qs = qs - psmlt
    qg = qg - pgmlt
    qr = qr + psmlt + pgmlt
    # melting snow and graupel add large drops (1 mm)
    m_drop1mm = math.pi / 6.0 * RHO_W * (1.0e-3) ** 3
    nr = nr + (psmlt + pgmlt) / m_drop1mm * 1.0e-3
    t = t - _LF / cp * (psmlt + pgmlt)

    warm = t > _T0
    pimlt = torch.where(warm, qi, 0.0)
    ni = torch.where(warm, NI_MIN, ni)
    qi = qi - pimlt
    qc = qc + pimlt
    t = t - _LF / cp * pimlt

    # --- sedimentation: mass- and number-weighted DSD fall speeds from the
    # tables (ref: the sedimentation moments of module_mp_thompson.F)
    d_r = _rain_diameter(qr, nr, rho)
    vr_m = _curve(tab, "vr_mass", d_r)
    vr_n = _curve(tab, "vr_num", d_r)
    d_i = _ice_diameter(qi, ni, rho)
    vi_m = _curve(tab, "vi_mass", d_i)
    vs = torch.clamp(11.72 * (rho * torch.clamp(qs, min=0.0)) ** 0.25 * 0.1,
                     max=2.5)
    vg = torch.clamp(19.3 * (rho * torch.clamp(qg, min=0.0)) ** 0.37 * 0.1,
                     max=5.0)
    vi_n = _curve(tab, "vi_num", d_i)
    qr, rain = _sediment(qr, rho, dz, vr_m, dt)
    nr, _ = _sediment(nr, rho, dz, vr_n, dt)
    qi, ice_sfc = _sediment(qi, rho, dz, vi_m, dt)
    ni, _ = _sediment(ni, rho, dz, vi_n, dt)
    qs, snow = _sediment(qs, rho, dz, vs, dt)
    qg, graup = _sediment(qg, rho, dz, vg, dt)

    th_new = t / exner
    rain_total = (rain + snow + graup + ice_sfc) / 1000.0
    return (th_new, torch.clamp(qv, min=0.0), torch.clamp(qc, min=0.0),
            torch.clamp(qr, min=0.0), torch.clamp(qi, min=0.0),
            torch.clamp(qs, min=0.0), torch.clamp(qg, min=0.0),
            torch.clamp(nr, NR_MIN, NR_MAX), torch.clamp(ni, NI_MIN, NI_MAX),
            rain_total)
