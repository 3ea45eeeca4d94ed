"""Microphysics coupling driver: dycore variables <-> column scheme (port of
mpas_tpu/cores/atmosphere/physics/driver.py: Kessler, WSM6 and Thompson).

ref: src/core_atmosphere/physics/mpas_atmphys_driver_microphysics.F
(driver_microphysics, called inside atm_srk3 after scalar transport) and
mpas_atmphys_interface.F:536-560 (microphysics_from_MPAS) / :695-717
(microphysics_to_MPAS). State tensors are already (nCells, nz).

Scalar layout (ref: Registry.xml index_qv/index_qc/index_qr/...):
scalars[..., 0] = qv, [..., 1] = qc, [..., 2] = qr, and for the
six-class schemes [..., 3] = qi, [..., 4] = qs, [..., 5] = qg; Thompson
adds the rain and ice numbers [..., 6] = nr, [..., 7] = ni.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import cp, p0, rgas, rvord
from mpas_tpu_torch.cores.atmosphere.physics.kessler import kessler
from mpas_tpu_torch.cores.atmosphere.physics.thompson import thompson
from mpas_tpu_torch.cores.atmosphere.physics.wsm6 import wsm6

IDX_QV, IDX_QC, IDX_QR = 0, 1, 2
IDX_QI, IDX_QS, IDX_QG = 3, 4, 5
IDX_NR, IDX_NI = 6, 7        # Thompson number concentrations
RCV = rgas / (cp - rgas)


def microphysics_step(grid, theta_m, rho_zz, scalars, exner, dt):
    """Apply Kessler microphysics to one model state.

    Returns (theta_m, scalars, rtheta_p, exner, pressure_p,
    rt_diabatic_tend, rain_m); all are new tensors, the inputs are not
    written.

    As microphysics_from_MPAS / microphysics_to_MPAS: the scheme sees dry
    density rho = zz*rho_zz (interface.F:548), dry potential temperature
    th = theta_m/(1+Rv/Rd qv) (:549) and the Exner function; afterwards
    theta_m, rtheta_p, exner and pressure_p are rebuilt (:704-717) and the
    diabatic theta_m tendency is returned for the next step's
    rt_diabatic_tend coupling (:703-706)."""
    qv = torch.clamp(scalars[..., IDX_QV], min=0.0)
    qc = torch.clamp(scalars[..., IDX_QC], min=0.0)
    qr = torch.clamp(scalars[..., IDX_QR], min=0.0)
    rho_dry = grid.zz * rho_zz
    th = theta_m / (1.0 + rvord * qv)
    dz = grid.zgrid[:, 1:] - grid.zgrid[:, :-1]

    th, qv, qc, qr, rain = kessler(th, qv, qc, qr, rho_dry, exner, dz, dt)

    return _to_mpas(grid, theta_m, rho_zz, scalars, th, (qv, qc, qr), rain,
                    dt)


def microphysics_step_wsm6(grid, theta_m, rho_zz, scalars, exner, dt):
    """Apply WSM6 six-class microphysics (same contract as
    microphysics_step; ref: driver_microphysics dispatch on
    config_microp_scheme='mp_wsm6', mpas_atmphys_driver_microphysics.F).
    Requires scalars (qv, qc, qr, qi, qs, qg)."""
    q = [torch.clamp(scalars[..., i], min=0.0)
         for i in (IDX_QV, IDX_QC, IDX_QR, IDX_QI, IDX_QS, IDX_QG)]
    rho_dry = grid.zz * rho_zz
    th = theta_m / (1.0 + rvord * q[0])
    dz = grid.zgrid[:, 1:] - grid.zgrid[:, :-1]
    p = p0 * exner ** (cp / rgas)

    th, *q, rain = wsm6(th, *q, rho_dry, exner, p, dz, dt)
    return _to_mpas(grid, theta_m, rho_zz, scalars, th, q, rain, dt)


def microphysics_step_thompson(grid, theta_m, rho_zz, scalars, exner, dt):
    """Apply Thompson partially two-moment microphysics (same contract as
    microphysics_step; ref: driver_microphysics dispatch on
    config_microp_scheme='mp_thompson'). Requires scalars
    (qv, qc, qr, qi, qs, qg, nr, ni); the numbers enter unclamped."""
    q = [torch.clamp(scalars[..., i], min=0.0)
         for i in (IDX_QV, IDX_QC, IDX_QR, IDX_QI, IDX_QS, IDX_QG)]
    n = [scalars[..., IDX_NR], scalars[..., IDX_NI]]
    rho_dry = grid.zz * rho_zz
    th = theta_m / (1.0 + rvord * q[0])
    dz = grid.zgrid[:, 1:] - grid.zgrid[:, :-1]
    p = p0 * exner ** (cp / rgas)

    th, *q, rain = thompson(th, *q, *n, rho_dry, exner, p, dz, dt)
    return _to_mpas(grid, theta_m, rho_zz, scalars, th, q, rain, dt)


def _to_mpas(grid, theta_m, rho_zz, scalars, th, species, rain, dt):
    """microphysics_to_MPAS (:695-717): theta_m, the updated leading
    species of `scalars`, rtheta_p, exner and pressure_p rebuilt from the
    scheme's dry theta and mixing ratios, and the diabatic tendency."""
    qv = species[0]
    theta_m_new = th * (1.0 + rvord * qv)
    rt_diabatic_tend = (theta_m_new - theta_m) / dt
    scalars = torch.cat([torch.stack(species, dim=-1),
                         scalars[..., len(species):]], dim=-1)

    rtheta_p = rho_zz * theta_m_new - grid.rtheta_base
    exner_new = (grid.zz * (rgas / p0)
                 * (rtheta_p + grid.rtheta_base)) ** RCV
    pressure_p = grid.zz * rgas * (exner_new * rtheta_p
                                   + (exner_new - grid.exner_base)
                                   * grid.rtheta_base)
    return (theta_m_new, scalars, rtheta_p, exner_new, pressure_p,
            rt_diabatic_tend, rain)
