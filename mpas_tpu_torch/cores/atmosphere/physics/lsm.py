"""Slab land-surface model and the simple orographic drag (port of
mpas_tpu/cores/atmosphere/physics/lsm.py).

ref capability:
  LSM  — src/core_atmosphere/physics/mpas_atmphys_driver_lsm.F: a
         force-restore slab (surface energy balance for the skin
         temperature with a ground heat flux to a deep reservoir) and a
         moisture-availability beta for evaporation; noah.py holds the
         4-layer Noah column.
  GWDO — mpas_atmphys_driver_gwdo.F + physics_wrf/module_bl_gwdo.F (Kim &
         Arakawa): surface stress from subgrid orography variance,
         deposited over the lowest levels (gwdo.py holds the full scheme).
"""

from __future__ import annotations

import torch

_SB = 5.67e-8
_T0 = 273.15


def _qsat(t, p):
    es = 611.2 * torch.exp(17.67 * (t - _T0) / (t - 29.65))
    return 0.622 * es / torch.clamp(p - es, min=100.0)


def slab_lsm(tsk, t_deep, gsw, glw, hfx, lh, dt,
             c_slab=8.0e4, tau_deep=86400.0, emiss=0.985):
    """Advance the skin temperature: C dT/dt = SW + LW_dn - eps sig T^4 -
    H - LE - G, with force-restore G = C/tau (tsk - t_deep). Returns
    (tsk_new, ground heat flux)."""
    lw_up = emiss * _SB * tsk ** 4
    g_flux = c_slab / tau_deep * (tsk - t_deep)
    net = gsw + emiss * glw - lw_up - hfx - lh - g_flux
    tsk_new = tsk + dt * net / c_slab
    return tsk_new, g_flux


def surface_moisture(tsk, p_sfc, beta=0.3):
    """Surface saturation mixing ratio scaled by the moisture availability
    (ref: Noah's beta-method branch)."""
    return beta * _qsat(tsk, p_sfc)


def gwdo(u, v, rho, dz, n_bv, var2d, dt, kmax_frac=0.25):
    """Orographic gravity-wave drag on the lowest kmax levels: surface wave
    stress tau = E rho U N h'^2 deposited over the lowest quarter of the
    column with a linear profile (ref: module_bl_gwdo.F, Kim & Arakawa
    1995). Returns (u_new, v_new)."""
    spd = torch.sqrt(u[:, 0] ** 2 + v[:, 0] ** 2)
    tau_s = 5.0e-6 * rho[:, 0] * spd * n_bv * var2d       # N/m2
    nz = u.shape[1]
    kmax = max(int(nz * kmax_frac), 1)
    w = torch.zeros(nz, dtype=u.dtype, device=u.device)
    w[:kmax] = 1.0 - torch.arange(kmax, dtype=u.dtype, device=u.device) \
        / kmax
    w = w / torch.clamp(torch.sum(w), min=1e-9)
    accel = tau_s[:, None] * w[None, :] / (rho * dz)
    frac_u = u / torch.clamp(spd, min=0.1)[:, None]
    frac_v = v / torch.clamp(spd, min=0.1)[:, None]
    return u - dt * accel * frac_u, v - dt * accel * frac_v
