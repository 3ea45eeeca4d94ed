"""Time-series statistics analysis member (port of
mpas_tpu/cores/ocean/analysis/time_series_stats.py).

ref: src/core_ocean/analysis_members/mpas_ocn_time_series_stats.F: the
reference's accumulation engine (avg/min/max over windows, N repeated
buckets for climatologies; instances 'timeSeriesStatsMonthly',
'timeSeriesStatsClimatology', ...). The accumulators are tensors on the
state's device; nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

_EXPRESSIONS: Dict[str, Callable] = {
    "ssh": lambda grid, cfg, st: st.layerThickness.sum(-1)
    - grid.bottomDepth,
    "temperatureSurface": lambda grid, cfg, st: st.tracers[:, 0, 0],
    "kineticEnergyColumn": lambda grid, cfg, st: (st.u * st.u).sum(-1),
}


@dataclasses.dataclass
class TimeSeriesStats:
    """One instance (ref: one Registry-configured AM instance).

    window_seconds: the accumulation window; at each window's end a record
    {field_avg, field_min, field_max} joins `records`. n_buckets > 1 is
    climatology mode: windows cycle through the buckets and accumulate
    across repeats (ref: the 'Climatology' instance)."""
    window_seconds: float
    fields: tuple = ("ssh", "temperatureSurface")
    n_buckets: int = 1
    records: list = dataclasses.field(default_factory=list)
    _acc: dict = dataclasses.field(default_factory=dict)
    _bucket_acc: list = dataclasses.field(default_factory=list)
    _count: int = 0
    _window_start: float = 0.0
    _window_index: int = 0

    def init(self, grid, cfg):
        for f in self.fields:
            if f not in _EXPRESSIONS:
                raise ValueError(f"unknown time-series field '{f}'; "
                                 f"known: {sorted(_EXPRESSIONS)}")
        self._acc = {}
        self._count = 0
        self._bucket_acc = [None] * self.n_buckets

    def accumulate(self, grid, cfg, state, t_seconds: float):
        vals = {f: _EXPRESSIONS[f](grid, cfg, state) for f in self.fields}
        if not self._acc:
            self._acc = {f: {"sum": v.clone(), "min": v.clone(),
                             "max": v.clone()} for f, v in vals.items()}
            self._count = 1
        else:
            for f, v in vals.items():
                a = self._acc[f]
                a["sum"] = a["sum"] + v
                a["min"] = torch.minimum(a["min"], v)
                a["max"] = torch.maximum(a["max"], v)
            self._count += 1
        if t_seconds - self._window_start + 1e-9 >= self.window_seconds:
            self._close_window(t_seconds)

    def _close_window(self, t_seconds):
        rec = {}
        for f, a in self._acc.items():
            rec[f"{f}_avg"] = a["sum"] / max(self._count, 1)
            rec[f"{f}_min"] = a["min"]
            rec[f"{f}_max"] = a["max"]
        bucket = self._window_index % self.n_buckets
        if self.n_buckets > 1:
            # climatology: running mean across repeats of this bucket
            prev = self._bucket_acc[bucket]
            if prev is None:
                # the bucket holds this window's record itself, so later
                # repeats overwrite it in `records` too: the reference's
                # behaviour, kept (ROADMAP §3)
                self._bucket_acc[bucket] = {"n": 1, "rec": rec}
            else:
                n = prev["n"] + 1
                for k in rec:
                    if k.endswith("_avg"):
                        prev["rec"][k] = (prev["rec"][k] * prev["n"]
                                          + rec[k]) / n
                    elif k.endswith("_min"):
                        prev["rec"][k] = torch.minimum(prev["rec"][k],
                                                       rec[k])
                    else:
                        prev["rec"][k] = torch.maximum(prev["rec"][k],
                                                       rec[k])
                prev["n"] = n
        self.records.append((t_seconds, bucket, rec))
        self._acc = {}
        self._count = 0
        self._window_start = t_seconds
        self._window_index += 1

    def climatology(self, bucket: int):
        b = self._bucket_acc[bucket]
        return None if b is None else b["rec"]
