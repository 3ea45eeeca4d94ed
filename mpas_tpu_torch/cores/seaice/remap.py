"""Incremental-remapping transport of the ITD tracer hierarchy (port of
mpas_tpu/cores/seaice/remap.py).

ref capability: src/core_seaice/shared/
mpas_seaice_advection_incremental_remap.F + ..._incremental_remap_tracers.F
(tracer hierarchy): geometric flux remapping (Dukowicz & Baumgardner 2000
/ Lipscomb & Hunke 2004): the transport across each edge over a step is
the integral of a limited linear reconstruction over the departure region
swept through the edge.

The machinery lives in ops/remap.py (shared with land ice):
  * departure points of the two edge vertices from the vertex velocities,
    the departure quad split into two triangles per edge;
  * each triangle is assigned whole to the cell on the upwind side of the
    edge (sign of its swept area): exact for sub-cell departure regions
    (CFL < 1) and conservative always;
  * limited linear reconstructions phi_c + g.(x - xc) (least-squares
    gradient over cellsOnCell, van-Leer min/max limiter);
  * triangle integrals by the 3-point edge-midpoint rule, exact for
    products of two linear reconstructions such as a*h;
  * the hierarchy a -> (h, hs, T) -> layer enthalpies transports children
    as products with the parent reconstruction.
"""

from __future__ import annotations

import dataclasses

import torch

from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.state import SeaiceGrid, SeaiceState
from mpas_tpu_torch.ops.remap import (apply_fluxes, cell_gradient,
                                      departure_triangles, edge_flux,
                                      product_flux)


def _departure_triangles(grid: SeaiceGrid, u_v, v_v, dt):
    """departure_triangles on the grid's mesh (the reference's adapter
    for its geometric-core tests)."""
    return departure_triangles(grid.mesh, u_v, v_v, dt)


def _per_parent(x, parent, puny, fallback):
    """x / parent where the parent holds ice, else `fallback`."""
    return torch.where(parent > puny, x / parent.clamp(min=puny), fallback)


def _remap_per_volume(m, flux_areas, qx, qy, q, vol, vol1, puny):
    """Layer enthalpies q (nCells, nCat, nl) carried as q*vol, back per
    unit of the new volume vol1."""
    qv = q * vol[..., None]
    gx, gy = cell_gradient(m, qv, m.xCell, m.yCell)
    (fq,) = edge_flux(m, flux_areas, qx, qy, [qv], [gx], [gy], m.xCell,
                      m.yCell)
    return _per_parent(apply_fluxes(m, fq, qv), vol1[..., None], puny, q)


def advect_incremental_remap(grid: SeaiceGrid, cfg: SeaiceConfig,
                             state: SeaiceState, dt) -> SeaiceState:
    """One IR transport step of the tracer hierarchy.
    ref driver: mpas_seaice_advection_incremental_remap.F
    seaice_run_advection_incremental_remap."""
    m = grid.mesh
    xc, yc = m.xCell, m.yCell
    puny = cfg.puny

    a = state.iceAreaCategory
    vi = state.iceVolumeCategory
    vs = state.snowVolumeCategory
    T = state.surfaceTemperature
    h = _per_parent(vi, a, puny, 0.0)
    hs = _per_parent(vs, a, puny, 0.0)

    # limited linear reconstructions (a; children h, hs, T on the parent)
    agx, agy = cell_gradient(m, a, xc, yc)
    hgx, hgy = cell_gradient(m, h, xc, yc)
    sgx, sgy = cell_gradient(m, hs, xc, yc)
    tgx, tgy = cell_gradient(m, T, xc, yc)

    flux_areas, qx, qy = departure_triangles(
        m, state.uVelocity, state.vVelocity, dt)

    (fa,) = edge_flux(m, flux_areas, qx, qy, [a], [agx], [agy], xc, yc)
    fvi = product_flux(m, flux_areas, qx, qy, a, agx, agy,
                       h, hgx, hgy, xc, yc)
    fvs = product_flux(m, flux_areas, qx, qy, a, agx, agy,
                       hs, sgx, sgy, xc, yc)
    faT = product_flux(m, flux_areas, qx, qy, a, agx, agy,
                       T, tgx, tgy, xc, yc)

    a1 = apply_fluxes(m, fa, a).clamp(min=0.0)
    vi1 = apply_fluxes(m, fvi, vi).clamp(min=0.0)
    vs1 = apply_fluxes(m, fvs, vs).clamp(min=0.0)
    T1 = _per_parent(apply_fluxes(m, faT, a * T), a1, puny, T)

    out = dataclasses.replace(state, iceAreaCategory=a1,
                              iceVolumeCategory=vi1, snowVolumeCategory=vs1,
                              surfaceTemperature=T1)
    # enthalpy tracers ride on volume (grandchildren of area)
    if state.iceEnthalpy is not None:
        out = dataclasses.replace(
            out,
            iceEnthalpy=_remap_per_volume(m, flux_areas, qx, qy,
                                          state.iceEnthalpy, vi, vi1, puny),
            snowEnthalpy=_remap_per_volume(m, flux_areas, qx, qy,
                                           state.snowEnthalpy, vs, vs1,
                                           puny))
    return out
