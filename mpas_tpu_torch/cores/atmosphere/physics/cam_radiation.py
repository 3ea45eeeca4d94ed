"""CAM radiation: driver-facing adapters over the CAM3 engine (port of
mpas_tpu/cores/atmosphere/physics/cam_radiation.py).

ref capability: physics_wrf/module_ra_cam.F + module_ra_cam_support.F, the
CAM3 radiation package the reference selects with
config_radt_{lw,sw}_scheme = 'cam_{lw,sw}'
(mpas_atmphys_driver_radiation_{lw,sw}.F); the engine is cam3.py.

The adapters keep the (t, qv, qc, rho, dz, ...) call shape of the physics
manager: they build hydrostatic interface pressures from rho*dz, diagnose
cloud fraction, water paths and effective radii from qc and t
(reltab/reitab), supply a climatological ozone profile, and flip between
the dycore's bottom-up layout and the engine's top-down internals
(torch.flip along the levels).
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.cores.atmosphere.physics import cam3

_SB = 5.670374e-8
CP = cam3.CP
G = cam3.GRAV_SI
CO2_PPV = 3.79e-4


def _delta_eddington(tau, w0, g_asym, mu0):
    """Delta-Eddington layer properties (legacy entry): the raddedmx
    statement-function forms with f = g**2 (pure forward peak)."""
    return cam3._sw_layer_props(tau, w0, g_asym, g_asym ** 2, mu0)


def _o3_profile(p_mid_pa):
    """Climatological ozone mass mixing ratio vs pressure: a two-lobe fit
    to the midlatitude profile (peak ~10 ppmv near 10 hPa, ~0.03 ppmv in
    the lower troposphere); stands in for the reference's oznint monthly
    climatology ingest (module_ra_cam.F:973, radozn)."""
    p_hpa = p_mid_pa / 100.0
    strat = 10.0e-6 * torch.exp(
        -0.5 * (torch.log(torch.clamp(p_hpa, min=1e-3) / 12.0) / 1.0) ** 2)
    trop = 0.04e-6 * torch.ones_like(p_hpa)
    vmr = strat + trop
    return vmr * 48.0 / 28.9644


def _columns_from_rho_dz(t, qv, qc, rho, dz):
    """Hydrostatic interface/mid pressures (TOP-DOWN) + cloud fields from
    the bottom-up (t, qv, qc, rho, dz) description."""
    nC = t.shape[0]
    dp = rho * dz * G                                   # (nC, nz) bottom-up
    dp_td = torch.flip(dp, [1])
    ptop = torch.clamp(0.25 * dp_td[:, :1], min=100.0)
    pint = torch.cat([ptop, ptop + torch.cumsum(dp_td, -1)], -1)
    pmid = 0.5 * (pint[:, 1:] + pint[:, :-1])
    t_td = torch.flip(t, [1])
    qv_td = torch.clamp(torch.flip(qv, [1]), min=1e-9)
    qc_td = torch.clamp(torch.flip(qc, [1]), min=0.0)
    rho_td = torch.flip(rho, [1])
    dz_td = torch.flip(dz, [1])

    cld = torch.where(qc_td > 1e-8, 0.99, torch.zeros_like(qc_td))
    gwp = qc_td * rho_td * dz_td * 1000.0               # g/m2 grid-mean
    incwp = gwp / torch.clamp(cld, min=0.01)
    fice = torch.clamp((263.16 - t_td) / 20.0, 0.0, 1.0)
    cliqwp = incwp * (1.0 - fice)
    cicewp = incwp * fice
    rel = cam3.reltab(t_td, landfrac=torch.zeros(nC, dtype=t.dtype,
                                                 device=t.device))
    rei = cam3.reitab(t_td)
    o3 = _o3_profile(pmid)
    return pint, pmid, t_td, qv_td, o3, cld, cliqwp, cicewp, fice, rel, rei


def cam_lw(t, qv, qc, rho, dz, tsk, emiss_sfc=0.985, co2_ppv=CO2_PPV):
    """CAM longwave (ref: radclwmx). Bottom-up arrays; returns
    (tend (nC, nz) K/s, glw surface downward (nC,), olr (nC,))."""
    (pint, pmid, t_td, qv_td, o3, cld, cliqwp, cicewp, fice,
     rel, rei) = _columns_from_rho_dz(t, qv, qc, rho, dz)
    cwp = cliqwp + cicewp
    lwups = emiss_sfc * _SB * tsk ** 4
    out = cam3.radclwmx(pint, pmid, t_td, qv_td, o3, cld, cwp, fice, rei,
                        lwups, co2vmr=co2_ppv)
    tend = torch.flip(out["qrl"], [1])
    return tend, out["flwds"], out["flut"]


def cam_sw(qv, qc, rho, dz, mu0, albedo=0.2, t=None, solcon=1361.0,
           co2_ppv=CO2_PPV):
    """CAM shortwave (ref: radcswmx). Bottom-up arrays; returns
    (tend (nC, nz) K/s, gsw net absorbed at surface (nC,))."""
    if t is None:
        # the call shape without temperature: a dry-adiabatic-like profile
        # from the hydrostatic pressure (only the effective radii and the
        # ice fraction depend on it)
        p_proxy = torch.flip(torch.cumsum(torch.flip(rho * dz * G, [1]), -1),
                             [1])
        t = torch.clamp(288.0 * (torch.clamp(p_proxy, min=1e2)
                                 / torch.clamp(p_proxy[:, :1], min=1e2))
                        ** 0.19, min=180.0)
    (pint, pmid, t_td, qv_td, o3, cld, cliqwp, cicewp, fice,
     rel, rei) = _columns_from_rho_dz(t, qv, qc, rho, dz)
    alb = torch.full((qv.shape[0],), albedo, dtype=qv.dtype,
                     device=qv.device)
    out = cam3.radcswmx(pint, pmid, t_td, qv_td, o3, cld, cliqwp, cicewp,
                        rel, rei, mu0, alb, alb, alb, alb,
                        solcon=solcon, co2vmr=co2_ppv)
    tend = torch.flip(out["qrs"], [1])
    return tend, out["fsns"]
