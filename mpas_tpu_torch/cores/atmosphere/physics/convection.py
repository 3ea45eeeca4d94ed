"""Mass-flux cumulus parameterization dispatch, the Kain-Fritsch entry
(port of mpas_tpu/cores/atmosphere/physics/convection.py).

ref capability: src/core_atmosphere/physics/mpas_atmphys_driver_convection.F
dispatching to Kain-Fritsch (module_cu_kfeta.F); kf_convection_full runs
the full KF-eta scheme of physics/kfeta.py. kf_convection keeps the
reference's four-output entry, so that code written against the
reference's API runs on the port; the manager calls kf_convection_full.
The reference's parcel_cape serves its convective diagnostics, which are
not ported yet, and comes with them.
"""

from __future__ import annotations

from mpas_tpu_torch.cores.atmosphere.physics.kfeta import kf_eta


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
