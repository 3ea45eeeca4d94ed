"""Convective diagnostics: CAPE, CIN, LCL, SRH, updraft helicity (port of
mpas_tpu/cores/atmosphere/diagnostics/convective.py).

ref: src/core_atmosphere/diagnostics/convective_diagnostics.F:
surface-based CAPE/CIN, lifting condensation level, 0-1/0-3 km
storm-relative helicity, 2-5 km updraft helicity.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import cp, p0, rgas
from mpas_tpu_torch.cores.atmosphere.physics.convection import parcel_cape


def cape_cin(t, qv, p, z):
    """Surface-based CAPE and CIN (J/kg)."""
    cape, buoy = parcel_cape(t, qv, p, z)
    dz = torch.diff(z, dim=1, prepend=z[:, :1] * 0.0)
    # CIN: negative buoyancy below the level of maximum integrated buoyancy
    cum = torch.cumsum(torch.clamp(buoy, min=0.0) * dz, dim=1)
    below_lfc = cum <= 0.0
    cin = torch.sum(torch.where(below_lfc, torch.clamp(buoy, max=0.0), 0.0)
                    * dz, dim=1)
    return cape, cin


def lcl_height(t1, qv1, p1):
    """Lifting condensation level above ground (m), Bolton (1980)-style."""
    e = qv1 * p1 / (0.622 + qv1)
    td = 243.5 / (17.67 / torch.log(torch.clamp(e, min=1.0) / 611.2)
                  - 1.0) + 273.15
    td = torch.minimum(td, t1)
    return torch.clamp(125.0 * (t1 - td), min=0.0)


def storm_relative_helicity(u, v, z, depth=3000.0):
    """0-depth SRH with the Bunkers-style storm motion ~ 75% of the mean
    0-6km wind (ref: convective_diagnostics.F srh computation)."""
    in6 = z <= 6000.0
    wsum = torch.clamp(torch.sum(in6, dim=1), min=1)
    cu = torch.sum(torch.where(in6, u, 0.0), dim=1) / wsum
    cv = torch.sum(torch.where(in6, v, 0.0), dim=1) / wsum
    cu, cv = 0.75 * cu, 0.75 * cv

    du = torch.diff(u, dim=1)
    dv = torch.diff(v, dim=1)
    um = 0.5 * (u[:, 1:] + u[:, :-1]) - cu[:, None]
    vm = 0.5 * (v[:, 1:] + v[:, :-1]) - cv[:, None]
    zm = 0.5 * (z[:, 1:] + z[:, :-1])
    seg = um * dv - vm * du
    return torch.sum(torch.where(zm <= depth, seg, 0.0), dim=1)


def updraft_helicity(w_mid, vort_cell, z, zbot=2000.0, ztop=5000.0):
    """2-5 km integrated w*zeta (ref: convective_diagnostics.F uh)."""
    dz = torch.diff(z, dim=1, prepend=z[:, :1] * 0.0)
    layer = (z >= zbot) & (z <= ztop)
    return torch.sum(torch.where(layer, torch.clamp(w_mid, min=0.0)
                                 * vort_cell * dz, 0.0), dim=1)


def compute_convective(grid, state, diag, vort_cell=None):
    qv = torch.clamp(state.scalars[..., 0], min=0.0) \
        if state.scalars.shape[-1] > 0 else torch.zeros_like(state.theta_m)
    th = state.theta_m / (1.0 + 1.608 * qv)
    t = th * diag.exner
    p = p0 * diag.exner ** (cp / rgas)
    z_mid = 0.5 * (grid.zgrid[:, 1:] + grid.zgrid[:, :-1]) \
        - grid.zgrid[:, :1]
    cape, cin = cape_cin(t, qv, p, z_mid)
    return {"cape": cape, "cin": cin,
            "lcl": lcl_height(t[:, 0], qv[:, 0], p[:, 0])}
