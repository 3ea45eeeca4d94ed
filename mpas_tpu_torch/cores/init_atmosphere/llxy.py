"""Map projections: lat/lon <-> projected grid (i, j).

Port of mpas_tpu/cores/init_atmosphere/llxy.py: numpy only, the same
arithmetic; the port keeps its own copy so that it imports nothing of the
JAX package.

ref: src/core_init_atmosphere/mpas_init_atm_llxy.F (2,236 LoC, the WPS
projection module): cylindrical equidistant, Mercator, Lambert conformal
(1/2 standard parallels), polar stereographic. Same conventions: grid
indices are 1-based at the projection's known point (knowni, knownj),
dx in meters, truelat/stdlon in degrees, spherical earth.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EARTH_RADIUS_M = 6370000.0   # ref: WPS/MPAS earth radius
_D2R = np.pi / 180.0


@dataclasses.dataclass(frozen=True)
class ProjInfo:
    code: str                 # 'latlon' | 'merc' | 'lc' | 'ps'
    lat1: float               # latitude of the known point (deg)
    lon1: float               # longitude of the known point (deg)
    knowni: float = 1.0
    knownj: float = 1.0
    dx: float = 10000.0       # m (for latlon: deltalon in deg)
    dy: float = 10000.0       # (for latlon: deltalat in deg)
    stdlon: float = 0.0
    truelat1: float = 60.0
    truelat2: float = 60.0


def _lc_cone(tl1, tl2):
    if abs(tl1 - tl2) > 0.01:
        return (np.log(np.cos(tl1 * _D2R)) - np.log(np.cos(tl2 * _D2R))) / \
            (np.log(np.tan((45.0 - abs(tl1) / 2.0) * _D2R))
             - np.log(np.tan((45.0 - abs(tl2) / 2.0) * _D2R)))
    return np.sin(abs(tl1) * _D2R)


def llij(proj: ProjInfo, lat, lon):
    """lat/lon (deg) -> fractional grid (i, j). Vectorized (numpy)."""
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    if proj.code == "latlon":
        dlon = np.mod(lon - proj.lon1 + 180.0, 360.0) - 180.0
        i = proj.knowni + dlon / proj.dx
        j = proj.knownj + (lat - proj.lat1) / proj.dy
        return i, j
    if proj.code == "merc":
        clain = np.cos(proj.truelat1 * _D2R)
        dlon = proj.dx / (EARTH_RADIUS_M * clain)
        rsw = np.log(np.tan(0.5 * ((proj.lat1 + 90.0) * _D2R))) / dlon
        dlon_pt = np.mod(lon - proj.lon1 + 180.0, 360.0) - 180.0
        i = proj.knowni + dlon_pt * _D2R / dlon
        j = proj.knownj + \
            (np.log(np.tan(0.5 * ((lat + 90.0) * _D2R)))) / dlon - rsw
        return i, j
    if proj.code == "ps":
        h = np.sign(proj.truelat1) or 1.0
        reflon = proj.stdlon + 90.0
        scale = (1.0 + h * np.sin(proj.truelat1 * _D2R)) / 2.0
        rebydx = EARTH_RADIUS_M / proj.dx
        ala1 = proj.lat1 * _D2R
        rm = rebydx * np.cos(ala1) * scale / (1.0 + h * np.sin(ala1))
        polei = proj.knowni - rm * np.cos((proj.lon1 - reflon) * _D2R)
        polej = proj.knownj - h * rm * np.sin((proj.lon1 - reflon) * _D2R)
        ala = lat * _D2R
        rm = rebydx * np.cos(ala) * scale / (1.0 + h * np.sin(ala))
        alo = (lon - reflon) * _D2R
        i = polei + rm * np.cos(alo)
        j = polej + h * rm * np.sin(alo)
        return i, j
    if proj.code == "lc":
        if proj.truelat1 < 0.0:
            # mirror the southern hemisphere through the equator
            m = dataclasses.replace(proj, lat1=-proj.lat1,
                                    truelat1=-proj.truelat1,
                                    truelat2=-proj.truelat2)
            i, j = llij(m, -lat, lon)
            return i, 2.0 * proj.knownj - j
        cone = _lc_cone(proj.truelat1, proj.truelat2)
        ctl1r = np.cos(proj.truelat1 * _D2R)
        rebydx = EARTH_RADIUS_M / proj.dx
        tref = np.tan((90.0 - proj.truelat1) * _D2R / 2.0)

        def rho(la):
            return rebydx * ctl1r / cone \
                * (np.tan((90.0 - la) * _D2R / 2.0) / tref) ** cone

        def wrap(dl):
            return (np.mod(dl + 180.0, 360.0) - 180.0) * _D2R

        # pole position from the known point: i = ip + rho sin(theta),
        # j = jp - rho cos(theta), theta = cone * (lon - stdlon)
        th1 = cone * wrap(proj.lon1 - proj.stdlon)
        r1 = rho(proj.lat1)
        polei = proj.knowni - r1 * np.sin(th1)
        polej = proj.knownj + r1 * np.cos(th1)
        th = cone * wrap(lon - proj.stdlon)
        rm = rho(lat)
        return polei + rm * np.sin(th), polej - rm * np.cos(th)
    raise ValueError(f"unknown projection {proj.code!r}")


def ijll(proj: ProjInfo, i, j):
    """fractional grid (i, j) -> lat/lon (deg). Vectorized (numpy)."""
    i = np.asarray(i, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64)
    if proj.code == "latlon":
        lat = proj.lat1 + (j - proj.knownj) * proj.dy
        lon = proj.lon1 + (i - proj.knowni) * proj.dx
        return lat, np.mod(lon + 180.0, 360.0) - 180.0
    if proj.code == "merc":
        clain = np.cos(proj.truelat1 * _D2R)
        dlon = proj.dx / (EARTH_RADIUS_M * clain)
        rsw = np.log(np.tan(0.5 * ((proj.lat1 + 90.0) * _D2R))) / dlon
        lat = 2.0 * np.arctan(np.exp(dlon * (rsw + j - proj.knownj))) \
            / _D2R - 90.0
        lon = (i - proj.knowni) * dlon / _D2R + proj.lon1
        return lat, np.mod(lon + 180.0, 360.0) - 180.0
    if proj.code == "ps":
        h = np.sign(proj.truelat1) or 1.0
        reflon = proj.stdlon + 90.0
        scale = (1.0 + h * np.sin(proj.truelat1 * _D2R)) / 2.0
        rebydx = EARTH_RADIUS_M / proj.dx
        ala1 = proj.lat1 * _D2R
        rm0 = rebydx * np.cos(ala1) * scale / (1.0 + h * np.sin(ala1))
        polei = proj.knowni - rm0 * np.cos((proj.lon1 - reflon) * _D2R)
        polej = proj.knownj - h * rm0 * np.sin((proj.lon1 - reflon) * _D2R)
        xx = i - polei
        yy = (j - polej) * h
        r2 = xx ** 2 + yy ** 2
        # rm = A tan(theta/2) with A = rebydx*scale and theta = colatitude:
        # sin(lat) = (A^2 - r^2)/(A^2 + r^2)
        a2 = (rebydx * scale) ** 2
        lat = h * np.arcsin((a2 - r2) / (a2 + r2)) / _D2R
        lon = np.where(r2 > 0.0,
                       reflon + np.arctan2(yy, xx) / _D2R, proj.lon1)
        return lat, np.mod(lon + 180.0, 360.0) - 180.0
    if proj.code == "lc":
        if proj.truelat1 < 0.0:
            m = dataclasses.replace(proj, lat1=-proj.lat1,
                                    truelat1=-proj.truelat1,
                                    truelat2=-proj.truelat2)
            lat, lon = ijll(m, i, 2.0 * proj.knownj - j)
            return -lat, lon
        cone = _lc_cone(proj.truelat1, proj.truelat2)
        ctl1r = np.cos(proj.truelat1 * _D2R)
        rebydx = EARTH_RADIUS_M / proj.dx
        tref = np.tan((90.0 - proj.truelat1) * _D2R / 2.0)
        th1 = cone * ((np.mod(proj.lon1 - proj.stdlon + 180.0, 360.0)
                       - 180.0) * _D2R)
        r1 = rebydx * ctl1r / cone \
            * (np.tan((90.0 - proj.lat1) * _D2R / 2.0) / tref) ** cone
        polei = proj.knowni - r1 * np.sin(th1)
        polej = proj.knownj + r1 * np.cos(th1)
        xx = i - polei
        yy = polej - j
        rm = np.sqrt(xx ** 2 + yy ** 2)
        lon = proj.stdlon + np.arctan2(xx, yy) / cone / _D2R
        lat = 90.0 - 2.0 * np.arctan(
            tref * (rm * cone / (rebydx * ctl1r)) ** (1.0 / cone)) / _D2R
        lat = np.where(rm == 0.0, 90.0, lat)
        return lat, np.mod(lon + 180.0, 360.0) - 180.0
    raise ValueError(f"unknown projection {proj.code!r}")
