"""Orbital/solar geometry: cosine solar zenith angle (port of
mpas_tpu/cores/seaice/orbital.py).

ref: src/core_seaice/column/ice_orbital.F90:35-96 (compute_coszen with
the shr_orb_decl solar declination): coszen drives the delta-Eddington
shortwave's diurnal cycle. The declination is the Berger low-order
solution the CESM share code evaluates: the true solar longitude from the
mean longitude via the eccentricity expansion, then
decl = arcsin(sin(obliq) sin(lambda)).
"""

from __future__ import annotations

import math

import torch

# present-day orbital parameters (ref: ice_constants_colpkg eccen etc.)
ECCEN = 0.0167
OBLIQ = math.radians(23.4441)
# mean longitude of perihelion + 180 (mvelpp analogue), radians
MVELPP = math.radians(102.93 + 180.0)
LAMBM0 = -0.032437                     # mean long. of vernal equinox ref
SECDAY = 86400.0


def solar_declination(yday):
    """Solar declination (radians) for day-of-year yday, a tensor (ref:
    shr_orb_decl as called by compute_coszen)."""
    ve = 80.5                         # vernal equinox day (Mar 21.5)
    lambm = LAMBM0 + (yday - ve) * 2.0 * math.pi / 365.0
    lmm = lambm - MVELPP
    # eccentricity expansion of the equation of centre
    lamb = lambm + ECCEN * (2.0 * torch.sin(lmm)
                            + ECCEN * 1.25 * torch.sin(2.0 * lmm))
    return torch.arcsin(math.sin(OBLIQ) * torch.sin(lamb))


def compute_coszen(lat, lon, yday, sec, dt=0.0):
    """Cosine of the solar zenith angle at (lat, lon) radians for
    day-of-year yday at sec elapsed seconds UTC; negative = the sun below
    the horizon (ref: compute_coszen, ice_orbital.F90:35-96: the
    ydayp1 = yday + sec/secday convention and the
    cos((sec/secday - 0.5) 2 pi + lon) hour angle)."""
    t = torch.as_tensor((sec + 0.5 * dt) / SECDAY, dtype=lat.dtype,
                        device=lat.device)
    decl = solar_declination(yday + t)
    hour_angle = (t - 0.5) * 2.0 * math.pi + lon
    return (torch.sin(lat) * torch.sin(decl)
            + torch.cos(lat) * torch.cos(decl) * torch.cos(hour_angle))


def diurnal_shortwave(sw_daily_mean, lat, lon, yday, sec, dt=0.0):
    """Scale a daily-mean downward shortwave onto the instantaneous
    diurnal cycle: sw = sw_mean * max(coszen, 0) / daily_mean(coszen)."""
    cz = compute_coszen(lat, lon, yday, sec, dt).clamp(min=0.0)
    # daily mean of max(coszen, 0) by 24-point quadrature
    secs = torch.arange(24, dtype=lat.dtype, device=lat.device) * 3600.0
    cz_all = compute_coszen(lat[..., None], lon[..., None], yday,
                            secs).clamp(min=0.0)
    return sw_daily_mean * cz / cz_all.mean(-1).clamp(min=1e-6)
