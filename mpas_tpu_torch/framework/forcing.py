"""Time-varying external forcing (port of mpas_tpu/framework/forcing.py).

ref: src/framework/mpas_forcing.F (2,690 LoC): forcing groups own a
forcing clock (offset from the model clock) and a set of streams, each
holding fields read from time-series files and interpolated to the
forcing time, 'constant' (piecewise) or 'linear' between the bracketing
records, optionally cyclic over a fixed cycle (mpas_forcing_init_group
:66, mpas_forcing_init_field :216, mpas_forcing_get_forcing :1162, the
forcing clock's restart :2494).

The records load on the host (numpy, lazily, per file, through
io/netcdf.py); each record a group uses goes to the group's device once,
and get_forcing interpolates there, so a call reads nothing back and
copies nothing from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mpas_tpu_torch.containers import resolve_device
from mpas_tpu_torch.framework.timekeeping import Time, TimeInterval
from mpas_tpu_torch.io.netcdf import read_netcdf


def _decode_xtime(x) -> list[str]:
    """xtime char array (Time, StrLen) -> list of trimmed strings."""
    out = []
    for row in np.asarray(x):
        s = b"".join(bytes([c]) if isinstance(c, int) else bytes(c)
                     for c in row.tolist()) if row.dtype.kind != "S" \
            else row.tobytes()
        out.append(s.decode().strip().strip("\x00"))
    return out


@dataclasses.dataclass
class ForcingStream:
    """One time-series forcing file: xtime records + named variables."""
    filename: str
    variables: list[str]
    _times: Optional[list[Time]] = None
    _data: Optional[dict] = None
    calendar: str = "gregorian_noleap"

    def _load(self):
        if self._data is not None:
            return
        data = read_netcdf(self.filename)[0]
        if "xtime" not in data:
            raise ValueError(f"forcing file {self.filename} has no xtime")
        self._times = [Time.from_string(s, self.calendar)
                       for s in _decode_xtime(data["xtime"])]
        self._data = {v: np.asarray(data[v]) for v in self.variables}

    @property
    def times(self) -> list[Time]:
        self._load()
        return self._times

    def record(self, i: int) -> dict:
        """Record i's variables, host numpy."""
        self._load()
        return {v: self._data[v][i] for v in self.variables}


@dataclasses.dataclass
class ForcingField:
    stream: ForcingStream
    name: str
    interpolation: str = "linear"     # 'linear' | 'constant'


class ForcingGroup:
    """A named set of forcing fields sharing one forcing clock.

    forcing_offset shifts the forcing time from the model time (ref: the
    forcing clock offset); cycle_start + cycle_duration make the forcing
    cyclic, times wrapped into [cycle_start, cycle_start +
    cycle_duration) (ref: the cyclic branch of mpas_forcing_get_forcing_time
    :1324). get_forcing's tensors live on `device` (cuda:0 where None) in
    the file's dtype."""

    def __init__(self, name: str,
                 forcing_offset: TimeInterval = TimeInterval(),
                 cycle_start: Optional[Time] = None,
                 cycle_duration: Optional[TimeInterval] = None,
                 device=None):
        self.name = name
        self.offset = forcing_offset
        self.cycle_start = cycle_start
        self.cycle_duration = cycle_duration
        if (cycle_start is None) != (cycle_duration is None):
            raise ValueError("cyclic forcing needs both cycle_start and "
                             "cycle_duration")
        if cycle_duration is not None and cycle_duration.months:
            raise ValueError("cycle_duration must be a fixed-length interval")
        self.device = resolve_device(device)
        self.fields: dict[str, ForcingField] = {}
        self._on_device: dict = {}

    def add_field(self, stream: ForcingStream, name: str,
                  interpolation: str = "linear"):
        if interpolation not in ("linear", "constant"):
            raise ValueError(f"unknown interpolation {interpolation!r}")
        if name not in stream.variables:
            raise ValueError(f"{name!r} not a variable of {stream.filename}")
        self.fields[name] = ForcingField(stream, name, interpolation)

    # -- time machinery ------------------------------------------------------

    def _forcing_time(self, model_time: Time) -> Time:
        t = model_time + self.offset
        if self.cycle_start is not None:
            rel = (t.us - self.cycle_start.us) % self.cycle_duration.us
            t = Time(self.cycle_start.us + rel, t.calendar)
        return t

    def _bracket(self, times: list[Time], t: Time):
        """(i0, i1, frac) with times[i0] <= t <= times[i1]. Cyclic groups
        wrap across the record boundary; acyclic groups clamp to the first
        or last record (the reference aborts outside the data; clamping is
        the reference package's forgiving variant)."""
        n = len(times)
        if n == 1:
            return 0, 0, 0.0
        if t <= times[0]:
            if self.cycle_start is not None:
                gap = self.cycle_duration.us - (times[-1].us - times[0].us)
                return (n - 1, 0, 1.0 - (times[0].us - t.us) / gap
                        if gap > 0 else 0.0)
            return 0, 0, 0.0
        if t >= times[-1]:
            if self.cycle_start is not None:
                gap = self.cycle_duration.us - (times[-1].us - times[0].us)
                return (n - 1, 0,
                        (t.us - times[-1].us) / gap if gap > 0 else 0.0)
            return n - 1, n - 1, 0.0
        lo = next(i for i in range(1, n) if times[i] >= t) - 1
        return lo, lo + 1, \
            (t.us - times[lo].us) / (times[lo + 1].us - times[lo].us)

    def _record(self, fld: ForcingField, i: int):
        """Record i of a field on the group's device (copied once)."""
        key = (id(fld.stream), fld.name, i)
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(np.ascontiguousarray(
                fld.stream.record(i)[fld.name])).to(self.device)
        return self._on_device[key]

    def get_forcing(self, model_time: Time) -> dict:
        """The forcing tensors at the (offset, wrapped) time (ref:
        mpas_forcing_get_forcing :1162)."""
        t = self._forcing_time(model_time)
        out = {}
        for name, fld in self.fields.items():
            i0, i1, frac = self._bracket(fld.stream.times, t)
            a = self._record(fld, i0)
            if fld.interpolation == "constant" or i0 == i1:
                out[name] = a
            else:
                out[name] = (1.0 - frac) * a + frac * self._record(fld, i1)
        return out

    # -- restart -------------------------------------------------------------

    def restart_times(self, model_time: Time) -> dict:
        """What restores the forcing clock on restart (ref:
        mpas_forcing_write_restart_times :2494)."""
        return {"group": self.name,
                "forcing_time": self._forcing_time(model_time).to_string()}
