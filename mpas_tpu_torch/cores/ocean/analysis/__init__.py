"""Ocean analysis members: diagnostic plugins switched on at run time
(port of mpas_tpu/cores/ocean/analysis/__init__.py).

ref: src/core_ocean/analysis_members/, driven by
mpas_ocn_analysis_driver.F (:388-701): each member registers init and
compute callbacks and a compute alarm (config_AM_<member>_compute_interval).

A member is an object with init(grid, cfg) and compute(grid, cfg, state)
-> {name: tensor}; the AnalysisDriver keeps the alarms on the host and
calls the due members between steps. Members return tensors on the
state's device and read nothing back, so the history is read back once
by its caller.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, List

from mpas_tpu_torch.cores.ocean.analysis.extra_members import (
    DebugDiagnostics, EddyProductVariables, EliassenPalm,
    HighFrequencyOutput, PointwiseStats, RegionalStats, RpnCalculator,
    SurfaceAreaWeightedAverages, TestComputeInterval, TimeFilters,
    TransectTransport, WaterMassCensus)
from mpas_tpu_torch.cores.ocean.analysis.global_stats import GlobalStats
from mpas_tpu_torch.cores.ocean.analysis.layer_volume_weighted_average \
    import LayerVolumeWeightedAverage
from mpas_tpu_torch.cores.ocean.analysis.meridional_heat_transport import (
    MeridionalHeatTransport)
from mpas_tpu_torch.cores.ocean.analysis.mixed_layer_depths import (
    MixedLayerDepths)
from mpas_tpu_torch.cores.ocean.analysis.moc import MocStreamfunction
from mpas_tpu_torch.cores.ocean.analysis.okubo_weiss import OkuboWeiss
from mpas_tpu_torch.cores.ocean.analysis.zonal_mean import ZonalMean
from mpas_tpu_torch.framework.timers import span

_REGISTRY = {
    "globalStats": GlobalStats,
    "zonalMean": ZonalMean,
    "mixedLayerDepths": MixedLayerDepths,
    "meridionalHeatTransport": MeridionalHeatTransport,
    "okuboWeiss": OkuboWeiss,
    "layerVolumeWeightedAverage": LayerVolumeWeightedAverage,
    "mocStreamfunction": MocStreamfunction,
    "eddyProductVariables": EddyProductVariables,
    "waterMassCensus": WaterMassCensus,
    "transectTransport": TransectTransport,
    "highFrequencyOutput": HighFrequencyOutput,
    "surfaceAreaWeightedAverages": SurfaceAreaWeightedAverages,
    "pointwiseStats": PointwiseStats,
    "debugDiagnostics": DebugDiagnostics,
    "timeFilters": TimeFilters,
    "regionalStats": RegionalStats,
    "rpnCalculator": RpnCalculator,
    "eliassenPalm": EliassenPalm,
    "testComputeInterval": TestComputeInterval,
}


def available_members() -> List[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass
class AnalysisDriver:
    """ref: ocn_analysis_init/compute (mpas_ocn_analysis_driver.F:388-701).

    members: {name: compute interval in seconds}; each member's results
    accumulate in `history[name]` as (time_seconds, {field: value})."""
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

    def _run(self, name, grid, cfg, state, forcing):
        """Members whose compute declares a `forcing` parameter get the
        surface forcing (ref: members reading the forcing pool)."""
        fn = self._instances[name].compute
        with span(f"ocn.analysis.{name}"):
            if forcing is not None and \
                    "forcing" in inspect.signature(fn).parameters:
                return fn(grid, cfg, state, forcing=forcing)
            return fn(grid, cfg, state)

    def compute_due(self, grid, cfg, state, t_seconds: float,
                    forcing=None):
        """Run every member whose alarm rings at model time t."""
        for name, interval in self.members.items():
            if t_seconds + 1e-9 >= self._next_due[name]:
                out = self._run(name, grid, cfg, state, forcing)
                self.history[name].append((t_seconds, out))
                while self._next_due[name] <= t_seconds + 1e-9:
                    self._next_due[name] += interval

    def compute_all(self, grid, cfg, state, t_seconds: float = 0.0,
                    forcing=None):
        for name in self.members:
            out = self._run(name, grid, cfg, state, forcing)
            self.history[name].append((t_seconds, out))
