"""Land-ice incremental-remapping advection + vertex velocity recovery
(port of mpas_tpu/cores/landice/advection_ir.py).

ref capability: src/core_landice/mode_forward/mpas_li_advection.F
(`config_thickness_advection = 'incremental_remapping'` branch, which
calls the shared seaice IR machinery) — here the shared machinery lives
in ops/remap.py. Thickness is the parent field; temperature (or
enthalpy) layers ride on it as products, exactly the reference's tracer
hierarchy for land ice.

Vertex velocities for the departure trajectories are recovered from the
depth-averaged edge normal velocities by a per-vertex least-squares fit
over edgesOnVertex (3 normals per Voronoi vertex -> overdetermined 2x2
normal equations; exact for linear velocity fields).
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.ops.remap import (apply_fluxes, cell_gradient,
                                      departure_triangles, edge_flux,
                                      product_flux)


def vertex_velocity_from_edges(mesh, u_edge):
    """Least-squares (u, v) at vertices from edge normal components.

    Solves min sum_e (n_e . v - u_e)^2 over the (<= vertexDegree) edges
    of each vertex. ref capability: the IR driver's vertex velocity
    interpolation (mpas_seaice_velocity_solver interpolation genre).
    """
    eov = mesh.edgesOnVertex                      # (nV, deg)
    valid = (mesh.edgeSignOnVertex != 0).to(u_edge.dtype)
    ne = torch.cos(mesh.angleEdge)[eov] * valid
    nn = torch.sin(mesh.angleEdge)[eov] * valid
    ue = u_edge[eov] * valid
    # normal equations: [[sum ne^2, sum ne nn],[.., sum nn^2]] [u v]^T
    a11 = (ne * ne).sum(1) + 1e-12
    a12 = (ne * nn).sum(1)
    a22 = (nn * nn).sum(1) + 1e-12
    b1 = (ne * ue).sum(1)
    b2 = (nn * ue).sum(1)
    det = a11 * a22 - a12 * a12
    det = torch.where(det.abs() < 1e-10, torch.full_like(det, 1e-10), det)
    u_v = (a22 * b1 - a12 * b2) / det
    v_v = (a11 * b2 - a12 * b1) / det
    return u_v, v_v


def advect_thickness_ir(grid, cfg, thickness, temperature, u_int, dt):
    """IR transport of thickness + per-layer temperature hierarchy.

    u_int: (nEdges, nz+1) interface normal velocities from the velocity
    solver (SIA or FO). Returns (thickness, temperature).
    """
    m = grid.mesh
    u_layer = 0.5 * (u_int[:, :-1] + u_int[:, 1:])
    ubar = (u_layer * grid.layerSigmaFraction[None, :]).sum(1)
    ubar = torch.where(m.boundaryEdge > 0, torch.zeros_like(ubar), ubar)

    u_v, v_v = vertex_velocity_from_edges(m, ubar)
    flux_areas, qx, qy = departure_triangles(m, u_v, v_v, dt)

    xc, yc = m.xCell, m.yCell
    hgx, hgy = cell_gradient(m, thickness, xc, yc)
    (fh,) = edge_flux(m, flux_areas, qx, qy, [thickness], [hgx], [hgy],
                      xc, yc)
    h1 = apply_fluxes(m, fh, thickness).clamp(min=0.0)

    # temperature layers ride on thickness (parent*child product flux)
    tgx, tgy = cell_gradient(m, temperature, xc, yc)
    fTh = product_flux(m, flux_areas, qx, qy, thickness, hgx, hgy,
                       temperature, tgx, tgy, xc, yc)
    hT1 = apply_fluxes(m, fTh, thickness[:, None] * temperature)
    t1 = torch.where(h1[:, None] > 1e-6,
                     hT1 / h1[:, None].clamp(min=1e-6), temperature)
    return h1, t1
