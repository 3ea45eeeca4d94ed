"""Sea-ice analysis members: runtime-togglable diagnostic plugins (port of
mpas_tpu/cores/seaice/analysis.py).

ref: src/core_seaice/analysis_members/ — ~17 members driven by
mpas_seaice_analysis_driver.F; each registers init/compute callbacks and
a per-member compute alarm, writing to its own output stream
(Registry_seaice_*.xml). Mirrors the ocean AnalysisDriver: a member is a
small object with `compute(grid, cfg, state) -> dict`; the driver calls
due members from host code between steps. Values stay device tensors —
nothing here reads back to the host; the caller reads `history` when it
needs the numbers.

Members covered (reference file in parens):
  areaVariables (mpas_seaice_area_variables.F), conservationCheck
  (…conservation_check.F), icePresent (…ice_present.F),
  maximumIcePresence (…maximum_ice_presence.F), miscellaneous
  (…miscellaneous.F), pondDiagnostics (…pond_diagnostics.F),
  ridgingDiagnostics (…ridging_diagnostics.F), temperatures
  (…temperatures.F), regionalStatistics (…regional_statistics.F),
  pointwiseStats (…pointwise_stats.F), highFrequencyOutput
  (…high_frequency_output.F), geographicalVectors
  (…geographical_vectors.F), loadBalance (…load_balance.F),
  unitConversion (…unit_conversion.F), iceShelves (…ice_shelves.F:
  ice area over land-ice-masked cavity cells), timeSeriesStats
  (…time_series_stats.F genre: avg/min/max accumulation over the
  member's own call history).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from mpas_tpu_torch.containers import to_host
from mpas_tpu_torch.cores.seaice.thermo_vertical import (
    bl99_salinity_profile, temperature_ice_bl99, temperature_mush)
from mpas_tpu_torch.framework.timers import span

# sea-ice extent threshold: cells count toward 'extent' when total
# concentration exceeds 0.15 (the reference/observational convention used
# by mpas_seaice_regional_statistics.F)
EXTENT_THRESHOLD = 0.15


def _cell_totals(state):
    a = state.iceAreaCategory.sum(-1)
    vi = state.iceVolumeCategory.sum(-1)
    vs = state.snowVolumeCategory.sum(-1)
    return a, vi, vs


def _like(mask_like, values):
    """A host array as a tensor on mask_like's device and dtype."""
    return torch.as_tensor(np.asarray(values), dtype=mask_like.dtype,
                           device=mask_like.device)


class AreaVariables:
    """Category-aggregated cell fields (iceAreaCell, iceVolumeCell,
    snowVolumeCell, openWaterArea, cell mean thicknesses)."""

    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        a, vi, vs = _cell_totals(state)
        safe_a = a.clamp(min=cfg.puny)
        zero = torch.zeros_like(a)
        return {
            "iceAreaCell": a,
            "iceVolumeCell": vi,
            "snowVolumeCell": vs,
            "openWaterArea": (1.0 - a).clamp(min=0.0),
            "iceThicknessCell": torch.where(a > cfg.puny, vi / safe_a,
                                            zero),
            "snowThicknessCell": torch.where(a > cfg.puny, vs / safe_a,
                                             zero),
        }


class ConservationCheck:
    """Global mass/energy totals + deltas since the previous call
    (ref: the energy/water/salt conservation accumulators of
    mpas_seaice_conservation_check.F)."""

    def init(self, grid, cfg):
        self._prev = None

    def compute(self, grid, cfg, state):
        area = grid.mesh.areaCell
        _a, vi, vs = _cell_totals(state)
        out = {"totalIceMass": (vi * area).sum() * cfg.rho_ice,
               "totalSnowMass": (vs * area).sum() * cfg.rho_snow}
        if state.iceEnthalpy is not None:
            # q (J/m3) integrated over layer volume: vol/cat/nilyr slabs
            nilyr = state.iceEnthalpy.shape[-1]
            lv = state.iceVolumeCategory[..., None] / nilyr
            out["totalIceEnergy"] = (
                (state.iceEnthalpy * lv).sum((-1, -2)) * area).sum()
        if state.snowEnthalpy is not None:
            nslyr = state.snowEnthalpy.shape[-1]
            lv = state.snowVolumeCategory[..., None] / nslyr
            out["totalSnowEnergy"] = (
                (state.snowEnthalpy * lv).sum((-1, -2)) * area).sum()
        prev, self._prev = self._prev, dict(out)
        for k in list(out):
            out[f"{k}Delta"] = (out[k] - prev[k]) if prev else out[k] * 0.0
        return out


class IcePresent:
    """Accumulated fraction-of-calls with ice present per cell."""

    def init(self, grid, cfg):
        self._count = 0
        self._present = None

    def compute(self, grid, cfg, state):
        a, _, _ = _cell_totals(state)
        here = (a > cfg.puny).to(a.dtype)
        self._count += 1
        self._present = here if self._present is None \
            else self._present + here
        return {"icePresent": here,
                "icePresentFraction": self._present / self._count}


class MaximumIcePresence:
    """Running max concentration per cell over the run."""

    def init(self, grid, cfg):
        self._max = None

    def compute(self, grid, cfg, state):
        a, _, _ = _cell_totals(state)
        self._max = a if self._max is None else torch.maximum(self._max, a)
        return {"maximumIcePresence": self._max}


class Miscellaneous:
    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        speed = torch.sqrt(state.uVelocity ** 2 + state.vVelocity ** 2)
        return {"iceSpeedVertex": speed,
                "iceSpeedMax": speed.max(),
                "stressMaxAbs": state.stress11.abs().max()}


class PondDiagnostics:
    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        if state.pondArea is None:
            z = torch.zeros_like(state.iceAreaCategory[:, 0])
            return {"pondAreaCell": z, "pondVolumeCell": z}
        pa = (state.pondArea * state.iceAreaCategory).sum(-1)
        pv = (state.pondArea * state.pondDepth
              * state.iceAreaCategory).sum(-1)
        return {"pondAreaCell": pa, "pondVolumeCell": pv}


class RidgingDiagnostics:
    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        a, vi, _ = _cell_totals(state)
        if state.levelIceArea is None:
            lvl_a = a
            lvl_v = vi
        else:
            lvl_a = (state.levelIceArea * state.iceAreaCategory).sum(-1)
            lvl_v = (state.levelIceVolume
                     * state.iceVolumeCategory).sum(-1)
        return {"levelIceAreaCell": lvl_a,
                "ridgedIceAreaCell": (a - lvl_a).clamp(min=0.0),
                "ridgedIceVolumeCell": (vi - lvl_v).clamp(min=0.0)}


class Temperatures:
    """Layer temperatures recovered from the prognostic enthalpies
    (ref: mpas_seaice_temperatures.F converts q -> T via the column
    package's enthalpy inversion)."""

    def init(self, grid, cfg):
        self._sal = bl99_salinity_profile(cfg.config_n_ice_layers)

    def compute(self, grid, cfg, state):
        if state.iceEnthalpy is None:
            t0 = state.surfaceTemperature
            return {"iceTemperature": t0[..., None],
                    "surfaceTemperatureCell": t0.mean(-1)}
        q = state.iceEnthalpy
        s = _like(q, self._sal)[None, None, :]
        if cfg.config_thermo_type == "mushy":
            t = temperature_mush(cfg, q, s)
        else:
            t = temperature_ice_bl99(cfg, q, s)
        # only meaningful where ice exists
        has = state.iceVolumeCategory[..., None] > cfg.puny
        t = torch.where(has, t, torch.zeros_like(t))
        return {"iceTemperature": t,
                "surfaceTemperatureCell": state.surfaceTemperature.mean(-1)}


class RegionalStatistics:
    """Per-region totals: area, extent (conc > 0.15), volume, snow volume
    (ref: mpas_seaice_regional_statistics.F; default regions = the two
    hemispheres by latCell sign, planar meshes get one global region)."""

    def __init__(self, region_masks: Dict[str, Any] | None = None):
        self._regions = region_masks

    def init(self, grid, cfg):
        area = grid.mesh.areaCell
        if self._regions is None:
            lat = to_host(grid.mesh.latCell)
            if np.allclose(lat, 0.0):
                self._regions = {"global": np.ones_like(lat)}
            else:
                self._regions = {"northern": (lat > 0).astype(float),
                                 "southern": (lat <= 0).astype(float)}
        self._regions = {k: _like(area, v) for k, v in self._regions.items()}

    def compute(self, grid, cfg, state):
        area = grid.mesh.areaCell
        a, vi, vs = _cell_totals(state)
        ext = (a > EXTENT_THRESHOLD).to(a.dtype)
        out = {}
        for name, mask in self._regions.items():
            w = mask * area
            out[f"iceAreaRegion_{name}"] = (a * w).sum()
            out[f"iceExtentRegion_{name}"] = (ext * w).sum()
            out[f"iceVolumeRegion_{name}"] = (vi * w).sum()
            out[f"snowVolumeRegion_{name}"] = (vs * w).sum()
        return out


class PointwiseStats:
    """Field values sampled at chosen cells."""

    def __init__(self, cell_ids=(0,)):
        self._cells = np.asarray(cell_ids, dtype=np.int64)

    def init(self, grid, cfg):
        self._cells = torch.as_tensor(self._cells,
                                      device=grid.mesh.areaCell.device)

    def compute(self, grid, cfg, state):
        a, vi, vs = _cell_totals(state)
        c = self._cells
        return {"iceAreaPoints": a[c], "iceVolumePoints": vi[c],
                "snowVolumePoints": vs[c]}


class HighFrequencyOutput:
    """Cheap 2-D snapshot set for sub-stream-interval output."""

    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        a, vi, _ = _cell_totals(state)
        return {"iceAreaCellHF": a, "iceVolumeCellHF": vi,
                "uVelocityHF": state.uVelocity,
                "vVelocityHF": state.vVelocity}


class GeographicalVectors:
    """Vertex velocities projected onto geographic (zonal, meridional)
    axes (ref: mpas_seaice_geographical_vectors.F). The prognostic
    (u, v) already live in the local (east, north) frame, so on the
    sphere this is a rotation by the local-frame offset — identity in
    this mesh convention — and the member's job is the cell-centred
    area-weighted aggregate the reference writes out."""

    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        m = grid.mesh
        # vertex -> cell: arithmetic mean over the cell's vertices (a
        # polygon has one vertex per edge slot, so edgesOnCellMask is the
        # per-slot validity for verticesOnCell too)
        voc = m.verticesOnCell
        vocm = m.edgesOnCellMask
        nv = vocm.sum(1).clamp(min=1.0)
        u_c = (state.uVelocity[voc] * vocm).sum(1) / nv
        v_c = (state.vVelocity[voc] * vocm).sum(1) / nv
        return {"uGeographicalCell": u_c, "vGeographicalCell": v_c}


class LoadBalance:
    """Cells-with-ice count (the reference's per-block load metric)."""

    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        a, _, _ = _cell_totals(state)
        return {"nCellsWithIce": (a > cfg.puny).sum()}


class UnitConversion:
    """Headline numbers in publication units (10^6 km^2, km^3)."""

    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        area = grid.mesh.areaCell
        a, vi, _ = _cell_totals(state)
        ext = (a > EXTENT_THRESHOLD).to(a.dtype)
        return {
            "iceExtentMkm2": (ext * area).sum() / 1.0e12,
            "iceAreaMkm2": (a * area).sum() / 1.0e12,
            "iceVolumeKm3": (vi * area).sum() / 1.0e9,
        }


class TimeSeriesStats:
    """Running avg/min/max of scalar diagnostics across calls (the
    time_series_stats genre; daily/monthly/climatology variants are this
    operator driven at different compute intervals). The accumulators are
    0-d device tensors."""

    def init(self, grid, cfg):
        self._n = 0
        self._acc = {}

    def compute(self, grid, cfg, state):
        area = grid.mesh.areaCell
        a, vi, _ = _cell_totals(state)
        cur = {"iceArea": (a * area).sum(), "iceVolume": (vi * area).sum()}
        self._n += 1
        for k, v in cur.items():
            s = self._acc.setdefault(k, {"sum": torch.zeros_like(v),
                                         "min": v, "max": v})
            s["sum"] = s["sum"] + v
            s["min"] = torch.minimum(s["min"], v)
            s["max"] = torch.maximum(s["max"], v)
        out = {}
        for k, s in self._acc.items():
            out[f"{k}Avg"] = s["sum"] / self._n
            out[f"{k}Min"] = s["min"]
            out[f"{k}Max"] = s["max"]
        return out


class IceShelves:
    """Ice area over ice-shelf cavities: sum(iceAreaCell * areaCell) over
    cells flagged by a land-ice mask (ref:
    mpas_seaice_ice_shelves.F:223-322, iceAreaOverIceShelves). The
    reference mask arrives from the ocean coupler (landIceMask in the
    ocean_coupling pool); standalone runs here take an explicit mask.
    Without one the member reports ZERO (matching the reference when no
    coupler supplies landIceMask) rather than mislabeling all Southern
    Ocean ice as shelf-cavity ice — pass land_ice_mask explicitly to
    activate the diagnostic."""

    def __init__(self, land_ice_mask: Any | None = None):
        self._mask = land_ice_mask

    def init(self, grid, cfg):
        area = grid.mesh.areaCell
        if self._mask is None:
            self._mask = np.zeros(grid.mesh.nCells)
        self._mask = _like(area, self._mask)

    def compute(self, grid, cfg, state):
        a, _, _ = _cell_totals(state)
        return {"iceAreaOverIceShelves":
                (a * grid.mesh.areaCell * self._mask).sum()}


_REGISTRY = {
    "areaVariables": AreaVariables,
    "iceShelves": IceShelves,
    "conservationCheck": ConservationCheck,
    "icePresent": IcePresent,
    "maximumIcePresence": MaximumIcePresence,
    "miscellaneous": Miscellaneous,
    "pondDiagnostics": PondDiagnostics,
    "ridgingDiagnostics": RidgingDiagnostics,
    "temperatures": Temperatures,
    "regionalStatistics": RegionalStatistics,
    "pointwiseStats": PointwiseStats,
    "highFrequencyOutput": HighFrequencyOutput,
    "geographicalVectors": GeographicalVectors,
    "loadBalance": LoadBalance,
    "unitConversion": UnitConversion,
    "timeSeriesStats": TimeSeriesStats,
}


def available_members() -> List[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass
class SeaiceAnalysisDriver:
    """members: {name: compute_interval_seconds}; results accumulate in
    `history` as (time_seconds, {field: value}) per member. Same alarm
    semantics as the ocean AnalysisDriver."""
    members: Dict[str, float]
    history: Dict[str, list] = dataclasses.field(default_factory=dict)
    _instances: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _next_due: Dict[str, float] = dataclasses.field(default_factory=dict)

    def init(self, grid, cfg):
        for name in self.members:
            if name not in _REGISTRY:
                raise ValueError(f"unknown analysis member '{name}'; "
                                 f"available: {available_members()}")
            self._instances[name] = _REGISTRY[name]()
            self._instances[name].init(grid, cfg)
            self.history[name] = []
            self._next_due[name] = 0.0

    def _run(self, name, grid, cfg, state):
        with span(f"si.analysis.{name}"):
            return self._instances[name].compute(grid, cfg, state)

    def compute_due(self, grid, cfg, state, t_seconds: float):
        for name, interval in self.members.items():
            if t_seconds + 1e-9 >= self._next_due[name]:
                out = self._run(name, grid, cfg, state)
                self.history[name].append((t_seconds, out))
                while self._next_due[name] <= t_seconds + 1e-9:
                    self._next_due[name] += interval

    def compute_all(self, grid, cfg, state, t_seconds: float = 0.0):
        for name in self.members:
            out = self._run(name, grid, cfg, state)
            self.history[name].append((t_seconds, out))
