"""Alarm-driven I/O stream manager (port of mpas_tpu/framework/streams.py).

Equivalent of the reference stream manager (ref:
src/framework/mpas_stream_manager.F: stream create/field-add/read/write with
per-stream alarms, filename templates, clobber modes; runtime configuration
parsed from streams.<core> XML by xml_stream_parser.c). Differences:

- Streams carry {field_name: (dims, provider)} with providers resolved at
  write time from the core's state and mesh containers — no pool
  indirection.
- Files are NetCDF-3 via mpas_tpu_torch.io.netcdf (interchangeable with
  reference output); time-templated filenames get one file per write; a
  fixed filename under clobber_mode 'append' is read back and rewritten
  with the new record appended (scipy's netcdf_file cannot append in
  place).
- The streams.<core> XML format is parsed for drop-in compatibility.
"""

from __future__ import annotations

import dataclasses
import os
import re
import xml.etree.ElementTree as ET
from typing import Callable

import numpy as np

from mpas_tpu_torch.framework.timekeeping import (Alarm, Clock, Time,
                                                  TimeInterval)
from mpas_tpu_torch.io.netcdf import read_netcdf, write_netcdf


def expand_filename_template(template: str, t: Time) -> str:
    """$Y/$M/$D/$h/$m/$s substitution (ref: stream filename templates,
    e.g. 'restart.$Y-$M-$D_$h.$m.$s.nc', core Registry immutable streams)."""
    s = t.to_string()  # YYYY-MM-DD_hh:mm:ss
    date, clock = s.split("_")
    y, mo, d = date.split("-")
    hh, mm, ss = clock.split(":")
    return (template.replace("$Y", y).replace("$M", mo).replace("$D", d)
            .replace("$h", hh).replace("$m", mm)
            .replace("$s", ss.split(".")[0]))


@dataclasses.dataclass
class Stream:
    name: str
    direction: str                      # 'input' | 'output' | 'input;output'
    filename_template: str
    fields: list
    input_interval: str | None = None   # interval string | 'initial_only'
    output_interval: str | None = None  # interval string | 'final_only' ...
    clobber_mode: str = "overwrite"     # 'never_modify'|'overwrite'|'append'
    packages: tuple = ()
    # per-field package gating: {field: (pkg, ...)} — a field whose
    # packages are all inactive is skipped at write time (ref: package-
    # gated stream contents, mpas_stream_manager.F + gen_inc.c:478)
    field_packages: dict = dataclasses.field(default_factory=dict)


class StreamManager:
    """Owns streams + their alarms; ring-driven read/write
    (ref: MPAS_stream_mgr_write :2722, _read :3425)."""

    def __init__(self, clock: Clock, run_dir: str = ".",
                 active_packages=None):
        self.clock = clock
        self.run_dir = run_dir
        self.streams: dict[str, Stream] = {}
        # None = all packages active (reference default)
        self.active_packages = None if active_packages is None \
            else set(active_packages)

    def _packages_active(self, pkgs) -> bool:
        if not pkgs or self.active_packages is None:
            return True
        return bool(set(pkgs) & self.active_packages)

    def streams_matching(self, stream_id: str) -> list[str]:
        """Names matching a streamID, which may be a POSIX regex (ref:
        regex_matching.c — streamID=\"block_.*\" addresses many streams).
        An exact name always matches itself."""
        if stream_id in self.streams:
            return [stream_id]
        pat = re.compile(stream_id + r"\Z")
        return [n for n in self.streams if pat.match(n)]

    def write_matching(self, stream_id: str, provider, dims,
                       force: bool = False, attrs=None) -> list:
        """Write every stream whose name matches the (regex) streamID."""
        return [self.write(n, provider, dims, force=force, attrs=attrs)
                for n in self.streams_matching(stream_id)]

    def add_stream(self, stream: Stream):
        self.streams[stream.name] = stream
        if "output" in stream.direction and stream.output_interval and \
                stream.output_interval not in ("initial_only", "final_only",
                                               "none"):
            self.clock.add_alarm(Alarm(
                name=f"stream_{stream.name}_out",
                interval=TimeInterval.from_string(stream.output_interval),
                reference=self.clock.start_time))

    def should_write(self, name: str, force: bool = False) -> bool:
        stream = self.streams[name]
        if "output" not in stream.direction:
            return False
        if force:
            return True
        if stream.output_interval in ("initial_only", "final_only", "none",
                                      None):
            return False
        return self.clock.is_ringing(f"stream_{name}_out")

    def write(self, name: str, provider: Callable[[str], tuple],
              dims: dict, force: bool = False, attrs: dict | None = None):
        """Write a stream if its alarm rings (or force).

        provider(field_name) -> (dim_names, ndarray); dims: sizes for all
        used dims (record dim 'Time' handled here).
        """
        stream = self.streams[name]
        if not self.should_write(name, force=force):
            return None
        # stream-level package gating: a stream whose packages are all
        # inactive is silently skipped (ref: package-gated streams)
        if not self._packages_active(stream.packages):
            return None
        t = self.clock.now
        fname = os.path.join(self.run_dir,
                             expand_filename_template(
                                 stream.filename_template, t))
        variables = {"xtime": (("Time", "StrLen"), _xtime_array(t))}
        for f in stream.fields:
            # field-level package gating: inactive fields never appear in
            # the output (mirrors never-allocated fields, mpas_dmpar.F:5226)
            if not self._packages_active(stream.field_packages.get(f)):
                continue
            dnames, arr = provider(f)
            variables[f] = (("Time",) + tuple(dnames),
                            np.asarray(arr)[None, ...])
        if os.path.exists(fname) and stream.clobber_mode == "never_modify":
            raise FileExistsError(
                f"stream {name}: {fname} exists and clobber=never_modify "
                "(ref: MPAS_STREAM_CLOBBER_NEVER, mpas_stream_manager.F:363)")
        if os.path.exists(fname) and stream.clobber_mode == "append":
            # append the new record to the existing record dimension
            old, old_dims, old_attrs = read_netcdf(fname)
            merged = {}
            for k, (dn, arr) in variables.items():
                if k in old:
                    merged[k] = (dn, np.concatenate(
                        [np.asarray(old[k]), np.asarray(arr)], axis=0))
                else:
                    merged[k] = (dn, arr)
            variables = merged
        all_dims = {"Time": None, "StrLen": 64, **dims}
        write_netcdf(fname, all_dims, variables, attrs=attrs or {})
        if f"stream_{name}_out" in self.clock.alarms and not force:
            self.clock.reset_alarm(f"stream_{name}_out")
        return fname

    def read(self, name: str, at_time: Time | None = None,
             variables=None):
        """Read a stream file (restart/input)."""
        stream = self.streams[name]
        t = at_time or self.clock.now
        fname = os.path.join(self.run_dir,
                             expand_filename_template(
                                 stream.filename_template, t))
        data, dims, attrs = read_netcdf(fname, variables)
        # drop the record dim for single-record files
        out = {}
        for k, v in data.items():
            out[k] = v[0] if (v.ndim > 0 and v.shape[0] == 1
                              and k != "xtime") else v
        return out, dims, attrs


def _xtime_array(t: Time):
    s = t.to_string().ljust(64)[:64]
    return np.frombuffer(s.encode(), dtype="S1").reshape(1, 64)


def parse_streams_xml(path: str) -> list[Stream]:
    """Parse a reference-format streams.<core> XML file
    (ref: xml_stream_parser.c; format: <streams><stream name=... type=...
    filename_template=... output_interval=...><var name=.../>...)."""
    tree = ET.parse(path)
    out = []
    for el in tree.getroot():
        if el.tag not in ("stream", "immutable_stream"):
            continue
        fields = [v.get("name") for v in el if v.tag in ("var", "var_array")]
        out.append(Stream(
            name=el.get("name"),
            direction=el.get("type", "output"),
            filename_template=el.get("filename_template", el.get("name")),
            fields=fields,
            input_interval=el.get("input_interval"),
            output_interval=el.get("output_interval"),
            clobber_mode=el.get("clobber_mode", "overwrite"),
            packages=tuple((el.get("packages") or "").split(";"))
            if el.get("packages") else ()))
    return out
