"""Mass-flux cumulus parameterization dispatch, the Kain-Fritsch entry
(port of mpas_tpu/cores/atmosphere/physics/convection.py).

ref capability: src/core_atmosphere/physics/mpas_atmphys_driver_convection.F
dispatching to Kain-Fritsch (module_cu_kfeta.F); kf_convection_full runs
the full KF-eta scheme of physics/kfeta.py. kf_convection keeps the
reference's four-output entry, so that code written against the
reference's API runs on the port; the manager calls kf_convection_full.
parcel_cape is the simple entraining-parcel CAPE of the convective
diagnostics (diagnostics/convective.py), independent of the scheme.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import cp, gravity
from mpas_tpu_torch.cores.atmosphere.physics.kfeta import kf_eta

_LV = 2.5e6
_T0 = 273.15


def _qsat(t, p):
    es = 611.2 * torch.exp(17.67 * (t - _T0) / (t - 29.65))
    return 0.622 * es / torch.clamp(p - es, min=100.0)


def parcel_cape(t, qv, p, z):
    """Pseudo-adiabatic parcel CAPE from a mixed near-surface parcel.
    Returns (cape, parcel buoyancy profile). (nCells, nz) inputs."""
    tp = t[:, 0] + 0.5                       # slightly buoyant start
    qp = qv[:, 0]
    nz = t.shape[1]
    tv_env = t * (1.0 + 0.61 * qv)
    buoy = []
    ent = 1.0e-4                             # entrainment rate (1/m)
    for k in range(nz):
        if k > 0:
            dz = z[:, k] - z[:, k - 1]
            # dry ascent then condense to saturation
            tp = tp - gravity / cp * dz
            # entrainment relaxes the parcel to the environment
            f = torch.exp(-ent * dz)
            tp = f * tp + (1.0 - f) * t[:, k]
            qp = f * qp + (1.0 - f) * qv[:, k]
            qs = _qsat(tp, p[:, k])
            cond = torch.clamp(qp - qs, min=0.0) / (
                1.0 + _LV ** 2 * qs / (cp * 461.5 * tp * tp))
            qp = qp - cond
            tp = tp + _LV / cp * cond
        tvp = tp * (1.0 + 0.61 * qp)
        buoy.append(gravity * (tvp - tv_env[:, k]) / tv_env[:, k])
    buoy = torch.stack(buoy, dim=1)          # (nCells, nz)
    dz_l = torch.diff(z, dim=1, prepend=z[:, :1] * 0.0)
    cape = torch.sum(torch.clamp(buoy, min=0.0) * dz_l, dim=1)
    return cape, buoy


def kf_convection(th, qv, p, rho, z_mid, dz, exner, dt,
                  w0avg=None, u=None, v=None, dx=25.0e3):
    """One convection call of the full KF-eta scheme. Returns (th, qv,
    conv_rain_m, cape); kf_convection_full has the detrained condensate
    and the diagnostics."""
    out = kf_convection_full(th, qv, p, rho, z_mid, dz, exner, dt,
                             w0avg=w0avg, u=u, v=v, dx=dx)
    return out["th"], out["qv"], out["raincv_m"], out["cape"]


def kf_convection_full(th, qv, p, rho, z_mid, dz, exner, dt,
                       w0avg=None, u=None, v=None, dx=25.0e3):
    """Full KF-eta step: the kf_eta output dict (th, qv, qc_detr, qi_detr,
    raincv_m, cape, timec, ainc, ishall, peff, ltop, klcl)."""
    return kf_eta(th, qv, p, rho, z_mid, dz, exner, dt,
                  w0avg=w0avg, u=u, v=v, dx=dx)
