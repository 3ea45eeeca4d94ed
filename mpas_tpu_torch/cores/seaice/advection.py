"""Upwind flux-form transport of the ITD tracer hierarchy (port of
mpas_tpu/cores/seaice/advection.py).

ref: src/core_seaice/shared/mpas_seaice_advection_upwind.F: first-order
upwind advection of iceAreaCategory and its child tracers (iceVolume,
snowVolume, area-weighted surface temperature). Child tracers are
transported weighted by their parent (surfaceTemperature rides on
iceAreaCategory), so that a cell that loses all its ice also loses its
temperature signal.

Edge normal velocities come from the two edge vertices once a step; the
category fields advect in one batched gather and sum (category =
trailing dim). The divergence at a cell is a masked sum over edgesOnCell.
"""

from __future__ import annotations

import dataclasses

import torch

from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.state import SeaiceGrid, SeaiceState


def edge_normal_velocity(grid: SeaiceGrid, u_v, v_v):
    """Project vertex velocities onto edge normals.
    ref: seaice_interpolate_vertex_to_edge + normal projection in
    mpas_seaice_advection_upwind.F."""
    m = grid.mesh
    voe = m.verticesOnEdge
    ue = 0.5 * (u_v[voe[:, 0]] + u_v[voe[:, 1]])
    ve = 0.5 * (v_v[voe[:, 0]] + v_v[voe[:, 1]])
    un = ue * torch.cos(m.angleEdge) + ve * torch.sin(m.angleEdge)
    # closed walls: no flux through boundary edges
    return torch.where(m.boundaryEdge > 0, 0.0, un)


def _upwind_tend(grid: SeaiceGrid, un, phi):
    """d(phi)/dt from upwind fluxes; phi is an (nCells, ...) per-area
    density (one trailing dim at most)."""
    m = grid.mesh
    coe = m.cellsOnEdge
    lanes = phi.dim() > 1
    pos = (un > 0.0)[:, None] if lanes else un > 0.0
    up = torch.where(pos, phi[coe[:, 0]], phi[coe[:, 1]])
    flux = (un * m.dvEdge)[:, None] * up if lanes else un * m.dvEdge * up
    w = m.edgeSignOnCell[..., None] if lanes else m.edgeSignOnCell
    div = (w * flux[m.edgesOnCell]).sum(1)
    inv_a = m.invAreaCell[:, None] if lanes else m.invAreaCell
    return -div * inv_a


def advect_upwind(grid: SeaiceGrid, cfg: SeaiceConfig, state: SeaiceState,
                  dt) -> SeaiceState:
    """One upwind transport step of the tracer hierarchy."""
    un = edge_normal_velocity(grid, state.uVelocity, state.vVelocity)

    a = state.iceAreaCategory
    vi = state.iceVolumeCategory
    vs = state.snowVolumeCategory
    aT = a * state.surfaceTemperature  # parent-weighted child tracer

    a1 = (a + dt * _upwind_tend(grid, un, a)).clamp(min=0.0)
    vi1 = (vi + dt * _upwind_tend(grid, un, vi)).clamp(min=0.0)
    vs1 = (vs + dt * _upwind_tend(grid, un, vs)).clamp(min=0.0)
    aT1 = aT + dt * _upwind_tend(grid, un, aT)
    T1 = torch.where(a1 > cfg.puny, aT1 / a1.clamp(min=cfg.puny),
                     state.surfaceTemperature)
    return dataclasses.replace(state, iceAreaCategory=a1,
                               iceVolumeCategory=vi1,
                               snowVolumeCategory=vs1, surfaceTemperature=T1)
