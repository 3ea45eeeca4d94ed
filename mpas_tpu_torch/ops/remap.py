"""Mesh-generic incremental-remapping transport operators (port of
mpas_tpu/ops/remap.py).

ref capability: the geometric flux remapping shared by
src/core_seaice/shared/mpas_seaice_advection_incremental_remap.F and
src/core_landice/mode_forward/mpas_li_advection.F (incremental remapping
branch): Dukowicz & Baumgardner 2000 departure-region integration of
limited linear reconstructions.

Functions take the bare Mesh (not a core grid) so that every core can use
them; cores/seaice/remap.py has the design notes (departure quads split
into signed triangles, 3-point quadrature, upwind-side assignment).
"""

from __future__ import annotations

import torch


def _lift(v, extra):
    """v with `extra` trailing unit dims, to broadcast over tracer lanes."""
    return v.reshape(v.shape + (1,) * extra)


def cell_gradient(mesh, phi, xc, yc):
    """Least-squares linear gradient of a cell field over cellsOnCell,
    van-Leer limited so that the reconstruction stays within the
    neighbours' bounds. phi: (nCells, ...), trailing dims batched."""
    coc = mesh.cellsOnCell                      # (nCells, maxEdges)
    # valid-neighbour mask: a real edge slot and not a self/pad pointer
    self_ix = torch.arange(coc.shape[0], device=coc.device)[:, None]
    mask = mesh.edgesOnCellMask * (coc != self_ix)
    on = mask > 0
    dx = torch.where(on, xc[coc] - xc[:, None], 0.0)
    dy = torch.where(on, yc[coc] - yc[:, None], 0.0)

    extra = phi.dim() - 1
    on_l = _lift(on, extra)
    phin = phi[coc]
    dphi = torch.where(on_l, phin - phi[:, None], 0.0)
    # normal equations for [gx, gy]
    sxx = (dx * dx).sum(1) + 1e-12
    sxy = (dx * dy).sum(1)
    syy = (dy * dy).sum(1) + 1e-12
    bx = (_lift(dx, extra) * dphi).sum(1)
    by = (_lift(dy, extra) * dphi).sum(1)
    det = sxx * syy - sxy * sxy
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    gx = (_lift(syy, extra) * bx - _lift(sxy, extra) * by) / _lift(det, extra)
    gy = (_lift(sxx, extra) * by - _lift(sxy, extra) * bx) / _lift(det, extra)

    # van-Leer limiter: scale the gradient so that the reconstruction at
    # the neighbour-displacement extremes stays within the stencil's range
    own = phi[:, None].expand_as(phin)
    phin_max = torch.where(on_l, phin, own).amax(1)
    phin_min = torch.where(on_l, phin, own).amin(1)
    excur = _lift(dx, extra) * gx[:, None] + _lift(dy, extra) * gy[:, None]
    exc_max = torch.where(on_l, excur, 0.0).amax(1)
    exc_min = torch.where(on_l, excur, 0.0).amin(1)
    alpha_up = torch.where(exc_max > 1e-14,
                           (phin_max - phi) / exc_max.clamp(min=1e-14), 1.0)
    alpha_dn = torch.where(exc_min < -1e-14,
                           (phin_min - phi) / exc_min.clamp(max=-1e-14), 1.0)
    alpha = torch.minimum(alpha_up, alpha_dn).clamp(0.0, 1.0)
    return gx * alpha, gy * alpha


def departure_triangles(mesh, u_v, v_v, dt):
    """Per-edge departure quad split into two triangles.

    Returns (signed areas (nEdges, 2), quadrature points x/y
    (nEdges, 2, 3)). Signed area > 0 means flux cell1 -> cell2 (along the
    edge normal). ref: find_departure_points / triangle decomposition in
    mpas_seaice_advection_incremental_remap.F."""
    m = mesh
    v0, v1 = m.verticesOnEdge[:, 0], m.verticesOnEdge[:, 1]
    x1, y1 = m.xVertex[v0], m.yVertex[v0]
    x2, y2 = m.xVertex[v1], m.yVertex[v1]
    # departure points (backward trajectory)
    xd1 = x1 - dt * u_v[v0]
    yd1 = y1 - dt * v_v[v0]
    xd2 = x2 - dt * u_v[v1]
    yd2 = y2 - dt * v_v[v1]

    # edge normal (cell1 -> cell2)
    ne = torch.cos(m.angleEdge)
    nn = torch.sin(m.angleEdge)

    def tri(ax, ay, bx, by, cx, cy):
        # signed area, positive when wound counter-clockwise
        area = 0.5 * ((bx - ax) * (cy - ay) - (cx - ax) * (by - ay))
        # 3-point (edge midpoint) quadrature nodes
        qx = torch.stack([0.5 * (ax + bx), 0.5 * (bx + cx),
                          0.5 * (cx + ax)], -1)
        qy = torch.stack([0.5 * (ay + by), 0.5 * (by + cy),
                          0.5 * (cy + ay)], -1)
        return area, qx, qy

    # quad (v1, v2, d2, d1) -> triangles (v1, v2, d2) and (v1, d2, d1)
    a1, qx1, qy1 = tri(x1, y1, x2, y2, xd2, yd2)
    a2, qx2, qy2 = tri(x1, y1, xd2, yd2, xd1, yd1)
    areas = torch.stack([a1, a2], -1)                  # (nEdges, 2)
    qx = torch.stack([qx1, qx2], -2)                   # (nEdges, 2, 3)
    qy = torch.stack([qy1, qy2], -2)

    # flux(cell1 -> cell2) = -area * sign(t x n): a flipped vertex order
    # flips both the winding and the orientation
    tx = x2 - x1
    ty = y2 - y1
    orient = torch.sign(tx * nn - ty * ne + 1e-30)
    flux_areas = -areas * orient[:, None]
    # no transport through closed boundary edges
    open_edge = m.boundaryEdge <= 0
    return torch.where(open_edge[:, None], flux_areas, 0.0), qx, qy


def _source_cells(mesh, flux_areas):
    """The upwind cell of each triangle: cell1 where its flux area > 0."""
    coe = mesh.cellsOnEdge
    return torch.where(flux_areas > 0.0, coe[:, 0:1], coe[:, 1:2])


def edge_flux(mesh, flux_areas, qx, qy, fields, gxs, gys, xc, yc):
    """Integrate each reconstructed field over the departure triangles.

    fields/gxs/gys: lists of (nCells, ...) values and gradients. Returns
    per-field edge fluxes (nEdges, ...): the signed amount crossing from
    cell1 to cell2."""
    src = _source_cells(mesh, flux_areas)            # (nE, 2)
    outs = []
    for phi, gx, gy in zip(fields, gxs, gys):
        extra = phi.dim() - 1
        # quadrature evaluation of phi at the 3 nodes of both triangles
        dxq = _lift(qx - xc[src][..., None], extra)   # (nE, 2, 3, ...)
        dyq = _lift(qy - yc[src][..., None], extra)
        vals = (phi[src][:, :, None] + gx[src][:, :, None] * dxq
                + gy[src][:, :, None] * dyq)
        integ = _lift(flux_areas, extra) * vals.mean(2)
        outs.append(integ.sum(1))                    # the two triangles
    return outs


def product_flux(mesh, flux_areas, qx, qy,
                 parent, pgx, pgy, child, cgx, cgy, xc, yc):
    """Flux of the product parent*child (e.g. volume = a*h): both linear
    reconstructions evaluated at the quadrature nodes, their product
    integrated (the 3-point rule is exact for the quadratic integrand)."""
    src = _source_cells(mesh, flux_areas)
    # parent and child may carry different trailing tracer dims: both are
    # padded on the right to the common rank
    extra_p = parent.dim() - 1
    extra_c = child.dim() - 1
    extra = max(extra_p, extra_c)
    dxq = qx - xc[src][..., None]                   # (nE, 2, 3)
    dyq = qy - yc[src][..., None]

    def recon(phi, gx, gy, e):
        v = (phi[src][:, :, None] + gx[src][:, :, None] * _lift(dxq, e)
             + gy[src][:, :, None] * _lift(dyq, e))
        return _lift(v, extra - e)

    p = recon(parent, pgx, pgy, extra_p)
    c = recon(child, cgx, cgy, extra_c)
    integ = _lift(flux_areas, extra) * (p * c).mean(2)
    return integ.sum(1)


def apply_fluxes(mesh, flux, field):
    """Cell update: field -= sum(signed fluxes) / areaCell."""
    extra = field.dim() - 1
    div = (_lift(mesh.edgeSignOnCell, extra) * flux[mesh.edgesOnCell]).sum(1)
    return field - div * _lift(mesh.invAreaCell, extra)
