"""Broadband two-stream radiation, LW and SW, and the solar zenith angle
(port of mpas_tpu/cores/atmosphere/physics/radiation.py).

ref capability: src/core_atmosphere/physics/mpas_atmphys_driver_radiation_
{lw,sw}.F. A broadband emissivity LW scheme and a Beer-Lambert +
cloud-albedo SW scheme behind the same interface as the k-distribution
schemes of rrtmg.py: theta tendencies plus the surface SW/LW fluxes. Level
0 is the lowest; the LW passes walk the levels one at a time.
"""

from __future__ import annotations

import math

import torch

from mpas_tpu_torch.constants import cp

_SB = 5.67e-8
_S0 = 1361.0
# broadband mass absorption coefficients (m2/kg)
_K_LW_VAP = 0.1
_K_LW_CLD = 120.0
_K_SW_VAP = 0.002
_K_SW_CLD = 80.0


def cos_zenith(lat, lon, gmt_hours, julian_day):
    """Solar zenith cosine (ref: mpas_atmphys_manager.F zenith geometry);
    lat/lon tensors in radians, gmt_hours and julian_day numbers."""
    decl = 0.409 * math.cos(2.0 * math.pi * (julian_day - 173.0) / 365.25)
    hour_angle = 2.0 * math.pi * (gmt_hours / 24.0) + lon - math.pi
    mu = (torch.sin(lat) * math.sin(decl)
          + torch.cos(lat) * math.cos(decl) * torch.cos(hour_angle))
    return torch.clamp(mu, min=0.0)


def radiation_lw(t, qv, qc, rho, dz, tsk, emiss_sfc=0.985):
    """Two-stream broadband longwave. Returns (dT/dt [K/s], downward LW at
    the surface GLW [W/m2], outgoing OLR [W/m2])."""
    path = rho * dz
    emis = 1.0 - torch.exp(-(_K_LW_VAP * qv + _K_LW_CLD * qc) * path)
    b = _SB * t ** 4
    nz = t.shape[1]

    # downward flux at the layer tops, from the top of the model down
    fd = torch.zeros_like(t[:, 0])
    fds = []
    for k in range(nz - 1, -1, -1):
        fds.append(fd)
        fd = fd * (1.0 - emis[:, k]) + emis[:, k] * b[:, k]
    fds.append(fd)                             # at the surface
    f_down = torch.stack(fds[::-1], dim=1)     # (nC, nz+1), 0 = surface
    glw = f_down[:, 0]

    fu = emiss_sfc * _SB * tsk ** 4 + (1.0 - emiss_sfc) * glw
    fus = [fu]
    for k in range(nz):
        fu = fu * (1.0 - emis[:, k]) + emis[:, k] * b[:, k]
        fus.append(fu)
    f_up = torch.stack(fus, dim=1)
    olr = f_up[:, -1]

    net = f_up - f_down                        # positive upward
    dtdt = -(net[:, 1:] - net[:, :-1]) / (rho * dz * cp)
    return dtdt, glw, olr


def radiation_sw(qv, qc, rho, dz, mu, albedo=0.2):
    """Beer-Lambert shortwave with a bulk cloud albedo. Returns (dT/dt
    [K/s], surface downward SW GSW [W/m2])."""
    path = rho * dz / torch.clamp(mu, min=0.05)[:, None]
    tau = _K_SW_VAP * qv * path
    # cloud reflection from the liquid water path (Stephens 1978-style)
    lwp = torch.sum(qc * rho * dz, dim=1)
    cld_alb = lwp / (lwp + 0.02)
    toa = _S0 * mu * (1.0 - cld_alb)

    trans = torch.exp(-tau)
    # cumulative transmission from the top down to each layer bottom
    cum_above = torch.flip(torch.cumprod(torch.flip(trans, [1]), dim=1), [1])
    f_bot = toa[:, None] * cum_above
    f_top = torch.cat([f_bot[:, 1:], toa[:, None]], dim=1)
    absorbed = f_top - f_bot
    dtdt = absorbed / (rho * dz * cp)
    gsw = f_bot[:, 0] * (1.0 - albedo)
    return dtdt, gsw
