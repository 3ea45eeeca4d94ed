"""init_atmosphere cases 8 and 9: surface-update and LBC generation
(port of mpas_tpu/cores/init_atmosphere/surface_lbc.py).

ref: src/core_init_atmosphere/mpas_init_atm_cases.F:95-278 case dispatch —
  case 8 (ref mpas_init_atm_surface.F:29 init_atm_case_sfc): periodically
    read surface intermediate files (SST/SKINTEMP/SEAICE) and horizontally
    interpolate them to MPAS cells, producing the sfc_update stream that
    the atmosphere core reads during long runs;
  case 9 (ref init_atm_case_gfs with config_init_case=9 genre): run the
    case-7 first-guess pipeline at a sequence of met times and extract
    lateral-boundary-condition states (lbc_u/lbc_theta/lbc_rho/lbc_scalars
    on the boundary zone) at each time, the inputs of the regional
    atmosphere's specified/relaxation zones (ref
    dynamics/mpas_atm_boundaries.F).

Both reuse the case-7 machinery (met_reader WPS intermediate IO, the
horizontal interpolation of real_case, the hydrostatic column build).
Host numpy: the records hold numpy arrays, float64.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import numpy as np

from mpas_tpu_torch.containers import to_host
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.init_atmosphere.met_reader import read_met_file
from mpas_tpu_torch.cores.init_atmosphere.real_case import (_interp_surface,
                                                            init_real)


# ---------------------------------------------------------------------------
# case 8 — surface update stream (ref mpas_init_atm_surface.F:29-92)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SurfaceUpdate:
    """One sfc_update record: fields on MPAS cells at one time."""
    time: str
    sst: Any           # (nCells,) K
    xice: Any          # (nCells,) fraction
    skintemp: Any      # (nCells,) K


def interp_sfc_to_mpas(mesh, met_fields, time: str) -> SurfaceUpdate:
    """ref interp_sfc_to_MPAS (mpas_init_atm_surface.F:95): horizontal
    interpolation of the surface fields of one intermediate file."""
    lat_c = np.degrees(np.asarray(mesh.latCell))
    lon_c = np.degrees(np.asarray(mesh.lonCell))
    sst = _interp_surface(met_fields, "SST", lat_c, lon_c, default=None)
    if sst is None:
        sst = _interp_surface(met_fields, "SKINTEMP", lat_c, lon_c,
                              default=288.0)
    skintemp = _interp_surface(met_fields, "SKINTEMP", lat_c, lon_c,
                               default=None)
    if skintemp is None:
        skintemp = sst
    xice = _interp_surface(met_fields, "SEAICE", lat_c, lon_c, default=0.0)
    return SurfaceUpdate(time=time, sst=np.asarray(sst),
                         xice=np.clip(np.asarray(xice), 0.0, 1.0),
                         skintemp=np.asarray(skintemp))


def build_surface_updates(mesh, met_paths: Sequence[Tuple[str, str]]
                          ) -> List[SurfaceUpdate]:
    """case 8 driver: met_paths = [(time_string, intermediate path)].
    Returns the sfc_update records in time order (ref: the case-8 loop
    over config_fg_interval times, mpas_init_atm_cases.F:170-186)."""
    out = []
    for time, path in met_paths:
        fields = read_met_file(path)
        out.append(interp_sfc_to_mpas(mesh, fields, time))
    return out


# ---------------------------------------------------------------------------
# case 9 — LBC generation (ref: cases.F case 9 + mpas_atm_boundaries.F
# consumption)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LbcRecord:
    """One lbc.$time state restricted to the boundary zone."""
    time: str
    lbc_u: Any         # (nEdges, nz) valid where bdyMaskEdge > 0
    lbc_theta: Any     # (nCells, nz)
    lbc_rho: Any       # (nCells, nz)
    lbc_w: Any         # (nCells, nz+1)
    lbc_scalars: Any   # (nCells, nz, nScalars)


def build_lbc_records(mesh, cfg: AtmConfig, met_snapshots, bdy_masks,
                      nz1=None) -> List[LbcRecord]:
    """case 9 driver: met_snapshots = [(time_string, met_fields)]. Runs
    the case-7 first-guess pipeline at every time and extracts the
    boundary-zone state. bdy_masks: BdyMasks from
    cores/atmosphere/boundaries.build_bdy_masks (bdyMaskCell/Edge > 0
    marks the specified+relaxation zones)."""
    cell_mask = np.asarray(bdy_masks.bdyMaskCell.cpu()) > 0
    edge_mask = np.asarray(bdy_masks.bdyMaskEdge.cpu()) > 0
    out = []
    for time, fields in met_snapshots:
        _, state, diag, _ = init_real(mesh, cfg, fields)
        u = np.where(edge_mask[:, None], to_host(state.u), 0.0)
        th = np.where(cell_mask[:, None], to_host(state.theta_m), 0.0)
        rho = np.where(cell_mask[:, None], to_host(state.rho_zz), 1.0)
        w = np.where(cell_mask[:, None], to_host(state.w), 0.0)
        sc = np.where(cell_mask[:, None, None],
                      to_host(state.scalars), 0.0)
        out.append(LbcRecord(time=time, lbc_u=u, lbc_theta=th, lbc_rho=rho,
                             lbc_w=w, lbc_scalars=sc))
    return out
