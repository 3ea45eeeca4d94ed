"""Kessler warm-rain microphysics (port of
mpas_tpu/cores/atmosphere/physics/kessler.py).

Behavioural spec: ref src/core_atmosphere/physics/physics_wrf/
module_mp_kessler.F:8-240: rain sedimentation with upstream fluxes and
Courant-limited time splitting, autoconversion and accretion of cloud to
rain, saturation adjustment with latent heating. Columns are (nCells, nz)
tensors, level 0 at the surface.

Sedimentation sub-steps while any column has time left: each column takes
its own Courant-limited dtfall, and a column that has used up dt takes
dtfall = 0. The loop test reads one boolean back from the device per
sub-step; `stats` counts the sub-steps and calls.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import cp as CP

# Scheme constants (ref: module_mp_kessler.F:24-29 and the values passed from
# mpas_atmphys_constants.F:44-65 via mpas_atmphys_driver_microphysics.F:326).
C1 = 0.001          # autoconversion rate [s-1]
C2 = 0.001          # autoconversion threshold [kg kg-1]
C3 = 2.2            # accretion rate coefficient
C4 = 0.875          # accretion exponent
XLV = 2.50e6        # latent heat of vaporization [J kg-1]
EP2 = 287.0 / 461.6  # R_d / R_v
SVP1, SVP2, SVP3, SVPT0 = 0.6112, 17.67, 29.65, 273.15
RHOWATER = 1000.0
MAX_CR_SED = 0.75   # sedimentation Courant limit (:78)

# sedimentation sub-steps and sediment_rain calls since the last reset
stats = {"sediment_iterations": 0, "sediment_calls": 0}


def reset_stats():
    for name in stats:
        stats[name] = 0


def _terminal_velocity(qr, rho, vtden):
    """vt = 36.34 (rho qr in g/m3)^0.1364 * sqrt(rho_sfc/rho)  (:113-117)."""
    qrr = torch.clamp(qr * 0.001 * rho, min=0.0)
    return 36.34 * qrr ** 0.1364 * vtden


def sediment_rain(qr, rho, dz, dt):
    """Courant-split upstream sedimentation of rain (ref :135-196).

    qr, rho, dz: (nCells, nz), level 0 = surface. Returns (qr_new, rain_m)
    with rain_m (nCells,) the surface rain depth [m] accumulated over dt."""
    nz = qr.shape[-1]
    vtden = torch.sqrt(rho[:, :1] / rho)
    # 1/dz per layer, with the reference's top-layer quirk of reusing the
    # thickness of the layer below (:120-123)
    rdzk = torch.cat([1.0 / dz[:, :nz - 1], 1.0 / dz[:, nz - 2:nz - 1]],
                     dim=-1)
    rain = torch.zeros_like(qr[:, 0])
    t_left = torch.full_like(qr[:, 0], dt)
    stats["sediment_calls"] += 1
    while bool((t_left > 1e-12).any()):
        vt = _terminal_velocity(qr, rho, vtden)
        # per-column Courant limit; a non-finite rate (rho = 0) counts as 0
        crk = vt * rdzk
        cr = torch.where(torch.isfinite(crk), crk, 0.0).amax(-1)
        dtfall = torch.minimum(t_left,
                               MAX_CR_SED / torch.clamp(cr, min=1e-12))
        # surface rain out of the bottom layer (:142-147), in metres
        rain = rain + rho[:, 0] * qr[:, 0] * vt[:, 0] * dtfall / RHOWATER
        flux = rho * qr * vt                         # downward rho*qr*vt
        flux_above = torch.cat([flux[:, 1:], torch.zeros_like(flux[:, :1])],
                               dim=-1)
        qr = qr - dtfall[:, None] * rdzk / rho * (flux - flux_above)
        t_left = t_left - dtfall
        stats["sediment_iterations"] += 1
    return qr, rain


def kessler(theta, qv, qc, qr, rho, pii, dz, dt):
    """One Kessler step on (nCells, nz) columns.

    theta: dry potential temperature; qv/qc/qr: mixing ratios; rho: dry air
    density [kg m-3]; pii: Exner function; dz: layer thickness. Returns
    (theta, qv, qc, qr, rain_m)."""
    qr_sed, rain = sediment_rain(qr, rho, dz, dt)

    # autoconversion + accretion (:202-209); factorn uses the rain before
    # sedimentation, as the reference does
    factorn = 1.0 / (1.0 + C3 * dt * torch.clamp(qr, min=0.0) ** C4)
    qrprod = qc * (1.0 - factorn) \
        + factorn * C1 * dt * torch.clamp(qc - C2, min=0.0)
    qc = torch.clamp(qc - qrprod, min=0.0)
    qr = torch.clamp(qr_sed + qrprod, min=0.0)

    # saturation adjustment (:211-236); the 1004/287 constants are the
    # scheme's own (:220-222), not the model-wide cp
    temp = pii * theta
    pressure = 1.0e5 * pii ** (1004.0 / 287.0)
    gam = XLV / (1004.0 * pii)
    f5 = SVP2 * (SVPT0 - SVP3) * XLV / CP
    es = 1000.0 * SVP1 * torch.exp(SVP2 * (temp - SVPT0) / (temp - SVP3))
    qvs = EP2 * es / (pressure - es)
    prod = (qv - qvs) / (1.0 + pressure / (pressure - es) * qvs * f5
                         / (temp - SVP3) ** 2)
    rcgs = 0.001 * rho
    ern = torch.minimum(
        dt * (((1.6 + 124.9 * (rcgs * qr) ** 0.2046)
               * (rcgs * qr) ** 0.525)
              / (2.55e8 / (pressure * qvs) + 5.4e5))
        * (torch.clamp(qvs - qv, min=0.0) / (rcgs * qvs)),
        torch.minimum(torch.clamp(-prod - qc, min=0.0), qr))

    product = torch.maximum(prod, -qc)
    theta = theta + gam * (product - ern)
    qv = torch.clamp(qv - product + ern, min=0.0)
    qc = qc + product
    qr = qr - ern
    return theta, qv, qc, qr, rain
