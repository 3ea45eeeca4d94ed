"""Land-ice calving schemes, the full config_calving option set (port of
mpas_tpu/cores/landice/calving.py).

ref: src/core_landice/mode_forward/mpas_li_calving.F (1,399 LoC):
li_calve_ice dispatch (:198-276) over 'thickness_threshold' (:582),
'floating' (:822), 'topographic_threshold' (:886), 'eigencalving'
(:966-1158) with calculate_calving_front_mask (:1330) and the
distribute/cleanup passes, plus li_restore_calving_front (:293-544).

Every mask pass is a batched neighbor gather over the padded cellsOnCell
table (PAD rows carry a validity mask) instead of the reference's
per-cell loops; the strain-rate principal values come from a closed-form
per-cell least-squares fit of the edge-normal velocities followed by
mesh cell gradients.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.ops.remap import cell_gradient


def _valid_slots(mesh, table):
    return (torch.arange(table.shape[1], device=table.device)[None, :]
            < mesh.nEdgesOnCell[:, None])


def _neighbors(mesh):
    """(cellsOnCell, valid) with padded slots masked off."""
    coc = mesh.cellsOnCell
    return coc, _valid_slots(mesh, coc)


def cell_masks(grid, cfg, thickness, min_ice=1.0, dynamic_thickness=10.0):
    """ice / floating / dynamic / margin masks (li_mask genre,
    mpas_li_mask.F definitions)."""
    m = grid.mesh
    ice = thickness > min_ice
    floating = (cfg.rho_ice * thickness
                < -cfg.rho_seawater * grid.bedTopography.clamp(max=0.0))
    floating = floating & ice
    dynamic = thickness > dynamic_thickness
    coc, valid = _neighbors(m)
    nbr_no_ice = ((~ice)[coc] & valid).any(1)
    margin = ice & nbr_no_ice
    nbr_dynamic = (dynamic[coc] & valid).any(1)
    dyn_margin = dynamic & ((~dynamic)[coc] & valid).any(1)
    return {"ice": ice, "floating": floating, "dynamic": dynamic,
            "margin": margin, "dynamic_margin": dyn_margin,
            "has_dynamic_neighbor": nbr_dynamic}


def cell_velocity_from_edges(grid, u_edge):
    """Closed-form least-squares (ux, uy) per cell from the edge-normal
    velocities of its edges: argmin sum_e (u_e - n_e . u)^2."""
    m = grid.mesh
    eoc = m.edgesOnCell
    valid = _valid_slots(m, eoc).to(u_edge.dtype)
    ang = m.angleEdge[eoc]
    nx = torch.cos(ang) * valid
    ny = torch.sin(ang) * valid
    ue = u_edge[eoc] * valid
    a11 = (nx * nx).sum(1)
    a12 = (nx * ny).sum(1)
    a22 = (ny * ny).sum(1)
    b1 = (nx * ue).sum(1)
    b2 = (ny * ue).sum(1)
    det = (a11 * a22 - a12 ** 2).clamp(min=1e-12)
    ux = (a22 * b1 - a12 * b2) / det
    uy = (a11 * b2 - a12 * b1) / det
    return ux, uy


def principal_strain_rates(grid, ux, uy):
    """eMax/eMin: eigenvalues of the horizontal strain-rate tensor from
    mesh cell gradients of the cell velocity (the velocityPool eMax/eMin
    the reference's eigencalving consumes)."""
    m = grid.mesh
    duxdx, duxdy = cell_gradient(m, ux, m.xCell, m.yCell)
    duydx, duydy = cell_gradient(m, uy, m.xCell, m.yCell)
    exx = duxdx
    eyy = duydy
    exy = 0.5 * (duxdy + duydx)
    mean = 0.5 * (exx + eyy)
    rad = torch.sqrt((0.25 * (exx - eyy) ** 2 + exy ** 2).clamp(min=0.0))
    return mean + rad, mean - rad


def calving_front_mask(grid, cfg, thickness, masks, sea_level=0.0):
    """Floating dynamic-margin cells adjacent to open ocean, directly or
    through a thin-ice neighbor (calculate_calving_front_mask,
    mpas_li_calving.F:1330-1394)."""
    m = grid.mesh
    coc, valid = _neighbors(m)
    ocean = (~masks["ice"]) & (grid.bedTopography < sea_level)
    thin_float = masks["floating"] & (~masks["dynamic"])
    # thin-ice cells that themselves touch open ocean
    thin_touches_ocean = thin_float & (ocean[coc] & valid).any(1)
    reach = ((ocean[coc] | thin_touches_ocean[coc]) & valid).any(1)
    return masks["floating"] & masks["dynamic_margin"] & reach


def eigencalving(grid, cfg, thickness, u_edge, dt, calving_flux,
                 k_eigen=1.0e17, sea_level=0.0):
    """Eigencalving (mpas_li_calving.F:966-1158): calving velocity
    K * max(0,e1) * max(0,e2) on floating ice; front cells lose volume
    at rate u_c * frontLength * frontHeight; cleanup removes thin front
    cells and floating ice with no dynamic neighbor.

    u_edge: vertically-averaged edge-normal velocity (nEdges,).
    Returns (thickness, calving_flux)."""
    m = grid.mesh
    zero = torch.zeros_like(thickness)
    masks = cell_masks(grid, cfg, thickness)
    ux, uy = cell_velocity_from_edges(grid, u_edge)
    e1, e2 = principal_strain_rates(grid, ux, uy)
    u_calv = k_eigen * e1.clamp(min=0.0) * e2.clamp(min=0.0) \
        * masks["floating"].to(thickness.dtype)

    front = calving_front_mask(grid, cfg, thickness, masks, sea_level)
    coc, valid = _neighbors(m)
    eoc = m.edgesOnCell
    ocean = (~masks["ice"]) & (grid.bedTopography < sea_level)
    thin_float = masks["floating"] & (~masks["dynamic"])
    open_nbr = (ocean[coc] | thin_float[coc]) & valid
    dv = m.dvEdge[eoc]
    front_len = torch.where(open_nbr, dv, torch.zeros_like(dv)).sum(1)
    hn = thickness[coc]
    front_hgt = torch.where(valid, hn, torch.zeros_like(hn)).amax(1)
    front_hgt = torch.maximum(front_hgt, thickness)
    vol_rate = u_calv * front_len * front_hgt              # m^3/s
    calv_thk = torch.where(front, torch.minimum(
        vol_rate * dt / m.areaCell, thickness), zero)
    h = thickness - calv_thk

    # cleanup 1: front cells thinner than the calving thickness go
    masks2 = cell_masks(grid, cfg, h)
    front2 = calving_front_mask(grid, cfg, h, masks2, sea_level)
    gone = front2 & (h < cfg.config_calving_thickness)
    calv_thk = calv_thk + torch.where(gone, h, zero)
    h = torch.where(gone, zero, h)

    # cleanup 2: floating ice with no dynamic neighbor calves entirely
    masks3 = cell_masks(grid, cfg, h)
    orphan = masks3["floating"] & (~masks3["has_dynamic_neighbor"])
    calv_thk = calv_thk + torch.where(orphan, h, zero)
    h = torch.where(orphan, zero, h)
    return h, calving_flux + calv_thk


def topographic_calving(grid, cfg, thickness, calving_flux,
                        bed_threshold=-500.0):
    """'topographic_threshold' (mpas_li_calving.F:886-949): margin cells
    over bed deeper than the threshold calve."""
    masks = cell_masks(grid, cfg, thickness)
    remove = masks["margin"] & (grid.bedTopography < bed_threshold)
    h = torch.where(remove, torch.zeros_like(thickness), thickness)
    return h, calving_flux + (thickness - h)


def restore_calving_front(grid, cfg, thickness, calving_flux,
                          initial_extent_mask):
    """li_restore_calving_front (:293-544): ice advanced beyond the
    initial extent is removed (the front is held fixed)."""
    outside = (~initial_extent_mask) & (thickness > 0.0)
    h = torch.where(outside, torch.zeros_like(thickness), thickness)
    return h, calving_flux + (thickness - h)
