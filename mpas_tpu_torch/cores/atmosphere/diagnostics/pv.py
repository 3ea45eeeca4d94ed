"""Potential-vorticity diagnostics (port of
mpas_tpu/cores/atmosphere/diagnostics/pv.py).

ref: src/core_atmosphere/diagnostics/pv_diagnostics.F: Ertel PV on model
levels, interpolation of theta/u/v to the dynamic-tropopause (2-PVU)
surface.

Here: the hydrostatic Ertel PV approximation PV = -g (f + zeta) dtheta/dp
(the reference's full 3D form includes the horizontal vorticity tilting
terms; the vertical term dominates at synoptic scale), plus the 2-PVU
interpolation.
"""

from __future__ import annotations

import math

import torch

from mpas_tpu_torch.constants import cp, gravity, p0, rgas
from mpas_tpu_torch.ops.stencils import vertex_to_cell_kite


def ertel_pv(grid, mesh, state, diag):
    """PV on model levels at cells, in PVU (1e-6 K m2 kg-1 s-1)."""
    qv = torch.clamp(state.scalars[..., 0], min=0.0) \
        if state.scalars.shape[-1] > 0 else torch.zeros_like(state.theta_m)
    th = state.theta_m / (1.0 + 1.608 * qv)
    p = p0 * diag.exner ** (cp / rgas)

    # relative vorticity at cells from the edge winds
    vort_v = torch.sum(mesh.curlW[..., None]
                       * state.u[mesh.edgesOnVertex], dim=1) \
        * mesh.invAreaTriangle[:, None]
    vort = vertex_to_cell_kite(mesh, vort_v)

    # dtheta/dp centered in the column
    dth = th[:, 2:] - th[:, :-2]
    dp = p[:, 2:] - p[:, :-2]
    dthdp_mid = dth / torch.where(torch.abs(dp) > 1.0, dp, -1.0)
    dthdp = torch.cat([dthdp_mid[:, :1], dthdp_mid, dthdp_mid[:, -1:]],
                      dim=1)

    f = mesh.fCell[:, None]
    pv = -gravity * (f + vort) * dthdp
    return pv * 1.0e6                       # PVU


def theta_on_pv_surface(pv_pvu, th, target=2.0):
    """theta on the 2-PVU surface, searching upward per column
    (ref: pv_diagnostics.F theta_pv); NaN where no level reaches it."""
    above = torch.abs(pv_pvu) >= target
    nz = pv_pvu.shape[1]
    # CUDA's argmax takes no bool: both libraries give the first maximum
    k = torch.argmax(above.to(torch.int32), dim=1)
    found = torch.any(above, dim=1)
    k = torch.where(found, torch.clamp(k, 1, nz - 1), nz - 1)[:, None]
    p1 = torch.abs(torch.gather(pv_pvu, 1, k - 1))[:, 0]
    p2 = torch.abs(torch.gather(pv_pvu, 1, k))[:, 0]
    w = torch.clamp((target - p1) / torch.where(torch.abs(p2 - p1) > 1e-9,
                                                p2 - p1, 1e-9), 0.0, 1.0)
    th_pv = (1.0 - w) * torch.gather(th, 1, k - 1)[:, 0] \
        + w * torch.gather(th, 1, k)[:, 0]
    return torch.where(found, th_pv, math.nan)
