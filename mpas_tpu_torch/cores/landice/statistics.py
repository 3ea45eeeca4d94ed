"""Land-ice analysis members: global and regional statistics (port of
mpas_tpu/cores/landice/statistics.py).

ref: src/core_landice/analysis_members/mpas_li_global_stats.F (619 LoC) —
domain-integrated volume/area/extent, volume above floatation, grounded vs
floating partition, min/max thickness and speed, total calving flux — and
mpas_li_regional_stats.F. Values are 0-d (or (nRegions,)) device tensors:
the caller reads them back when it needs them, not inside a step.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.cores.landice.config import LiConfig


def _floating(grid, cfg, h):
    return (cfg.rho_ice * h
            < -cfg.rho_seawater * grid.bedTopography.clamp(max=0.0))


def global_stats(grid, cfg: LiConfig, state):
    """{name: 0-d tensor}."""
    m = grid.mesh
    h = state.thickness
    area = m.areaCell
    zero = torch.zeros_like(area)
    has_ice = h > 1.0
    floating = _floating(grid, cfg, h)
    grounded = has_ice & ~floating

    # volume above floatation (ref: volumeAboveFloatation)
    haf = h + grid.bedTopography.clamp(max=0.0) \
        * (cfg.rho_seawater / cfg.rho_ice)
    vaf = (torch.where(grounded, haf.clamp(min=0.0), zero) * area).sum()

    speed = state.normalVelocity.abs().amax(1)
    return {
        "totalIceVolume": (h * area).sum(),
        "totalIceArea": torch.where(has_ice, area, zero).sum(),
        "groundedIceArea": torch.where(grounded, area, zero).sum(),
        "floatingIceArea": torch.where(has_ice & floating, area,
                                       zero).sum(),
        "volumeAboveFloatation": vaf,
        "maxThickness": h.max(),
        "maxSurfaceSpeed": speed.max(),
        "totalCalvingFlux": (state.calvingFlux * area).sum(),
    }


def regional_stats(grid, cfg: LiConfig, state, region_cell_masks,
                   sfc_mass_bal=None, basal_mass_bal=None):
    """Per-region land-ice statistics.

    ref: src/core_landice/analysis_members/mpas_li_regional_stats.F
    (li_compute_regional_stats:123-573) — the same reductions as the
    global member but restricted to each region of a cell-mask set: one
    masked einsum per quantity over a dense (nCells, nRegions) 0/1 mask
    array, all regions in a single pass.

    region_cell_masks: (nCells, nRegions). Returns a dict of (nRegions,)
    tensors."""
    m = grid.mesh
    h = state.thickness
    area = m.areaCell
    rmask = torch.as_tensor(region_cell_masks, dtype=h.dtype,
                            device=h.device)                 # (nC, nR)
    has_ice = (h > 1.0).to(h.dtype)
    floating = _floating(grid, cfg, h).to(h.dtype)
    grounded = has_ice * (1.0 - floating)
    floating = has_ice * floating

    def rsum(w):  # sum over cells of w, per region
        return torch.einsum("c,cr->r", w, rmask)

    haf = (h + grid.bedTopography.clamp(max=0.0)
           * (cfg.rho_seawater / cfg.rho_ice)).clamp(min=0.0)
    speed = state.normalVelocity.abs().amax(1)
    sp = speed[m.edgesOnCell]
    cell_speed = torch.where(m.edgesOnCell >= 0, sp,
                             torch.zeros_like(sp)).amax(1)

    big = 1.0e30
    inreg = rmask > 0
    hr = h[:, None].expand_as(rmask)
    out = {
        "regionalIceArea": rsum(has_ice * area),
        "regionalIceVolume": rsum(h * area),
        "regionalVolumeAboveFloatation": rsum(grounded * haf * area),
        "regionalGroundedIceArea": rsum(grounded * area),
        "regionalGroundedIceVolume": rsum(grounded * h * area),
        "regionalFloatingIceArea": rsum(floating * area),
        "regionalFloatingIceVolume": rsum(floating * h * area),
        "regionalMaxThickness": torch.where(
            inreg, hr, torch.full_like(hr, -big)).amax(0),
        "regionalMinThickness": torch.where(
            inreg & (has_ice[:, None] > 0), hr,
            torch.full_like(hr, big)).amin(0),
        "regionalMaxSurfaceSpeed": torch.where(
            inreg, cell_speed[:, None].expand_as(rmask),
            torch.zeros_like(rmask)).amax(0),
        "regionalSumCalvingFlux": rsum(state.calvingFlux * area),
    }
    if sfc_mass_bal is not None:
        out["regionalSumSfcMassBal"] = rsum(sfc_mass_bal * area)
        out["regionalSumGroundedSfcMassBal"] = rsum(
            grounded * sfc_mass_bal * area)
        out["regionalSumFloatingSfcMassBal"] = rsum(
            floating * sfc_mass_bal * area)
    if basal_mass_bal is not None:
        out["regionalSumBasalMassBal"] = rsum(basal_mass_bal * area)
    return out
