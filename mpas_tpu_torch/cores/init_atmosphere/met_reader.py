"""WPS intermediate-format first-guess reader/writer.

Port of mpas_tpu/cores/init_atmosphere/met_reader.py: numpy only, the same
arithmetic; the port keeps its own copy so that it imports nothing of the
JAX package.

ref: src/core_init_atmosphere/mpas_init_atm_read_met.F (read_met_init /
read_next_met_field) — the Fortran-unformatted "WPS intermediate" files
produced by ungrib (GFS/ERA first-guess data). Each field is a sequence
of Fortran records (4-byte big-endian length markers around each record):

  rec1: version (int32)
  rec2: hdate(24s), xfcst(f), map_source(32s), field(9s), units(25s),
        desc(46s), xlvl(f), nx(i), ny(i), iproj(i)
  rec3: projection parameters (depends on iproj)
  rec4: is_wind_grid_rel (int32-encoded logical)
  rec5: slab(nx*ny float32)

iproj: 0 = lat/lon (startlat, startlon, deltalat, deltalon, earth_radius)
       1 = mercator, 3 = lambert, 5 = polar stereographic.

The writer exists so tests (and users without ungrib output) can
round-trip files; both paths are plain NumPy — this is host-side I/O, not
device code.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class MetField:
    field: str
    units: str
    desc: str
    hdate: str
    xfcst: float
    xlvl: float            # pressure level (Pa) or 200100 = sfc
    nx: int
    ny: int
    iproj: int
    startlat: float
    startlon: float
    deltalat: float
    deltalon: float
    earth_radius: float
    is_wind_grid_rel: bool
    slab: np.ndarray       # (ny, nx)
    map_source: str = "mpas_tpu"
    # non-latlon projection params (iproj 1/3/5)
    truelat1: float = 0.0
    truelat2: float = 0.0
    xlonc: float = 0.0
    dx: float = 0.0
    dy: float = 0.0


def _wrec(f, payload: bytes):
    f.write(struct.pack(">i", len(payload)))
    f.write(payload)
    f.write(struct.pack(">i", len(payload)))


def _rrec(f) -> Optional[bytes]:
    head = f.read(4)
    if len(head) < 4:
        return None
    n = struct.unpack(">i", head)[0]
    payload = f.read(n)
    f.read(4)
    return payload


def write_met_file(path, fields: List[MetField]):
    """Write a WPS intermediate file (version 5 layout)."""
    with open(path, "wb") as f:
        for fl in fields:
            _wrec(f, struct.pack(">i", 5))
            hdr = struct.pack(
                ">24sf32s9s25s46sfiii",
                fl.hdate.ljust(24).encode(), fl.xfcst,
                fl.map_source.ljust(32).encode(),
                fl.field.ljust(9).encode(), fl.units.ljust(25).encode(),
                fl.desc.ljust(46).encode(), fl.xlvl, fl.nx, fl.ny,
                fl.iproj)
            _wrec(f, hdr)
            if fl.iproj == 0:
                _wrec(f, struct.pack(
                    ">8sfffff", b"SWCORNER", fl.startlat, fl.startlon,
                    fl.deltalat, fl.deltalon, fl.earth_radius))
            elif fl.iproj == 3:           # lambert
                _wrec(f, struct.pack(
                    ">8sffffffff", b"SWCORNER", fl.startlat, fl.startlon,
                    fl.dx, fl.dy, fl.xlonc, fl.truelat1, fl.truelat2,
                    fl.earth_radius))
            elif fl.iproj == 5:           # polar stereographic
                _wrec(f, struct.pack(
                    ">8sffffff", b"SWCORNER", fl.startlat, fl.startlon,
                    fl.dx, fl.dy, fl.xlonc, fl.truelat1))
            else:                          # mercator
                _wrec(f, struct.pack(
                    ">8sfffff", b"SWCORNER", fl.startlat, fl.startlon,
                    fl.dx, fl.dy, fl.truelat1))
            _wrec(f, struct.pack(">i", 1 if fl.is_wind_grid_rel else 0))
            slab = np.asarray(fl.slab, dtype=">f4")
            _wrec(f, slab.tobytes())


def read_met_file(path) -> List[MetField]:
    """Read every field of a WPS intermediate file.
    ref: read_next_met_field (mpas_init_atm_read_met.F)."""
    out: List[MetField] = []
    with open(path, "rb") as f:
        while True:
            rec = _rrec(f)
            if rec is None:
                break
            version = struct.unpack(">i", rec)[0]
            if version not in (3, 4, 5):
                raise ValueError(f"unsupported WPS intermediate version "
                                 f"{version}")
            hdr = _rrec(f)
            (hdate, xfcst, map_source, field, units, desc, xlvl, nx, ny,
             iproj) = struct.unpack(">24sf32s9s25s46sfiii", hdr)
            proj = _rrec(f)
            kw = dict(truelat1=0.0, truelat2=0.0, xlonc=0.0, dx=0.0,
                      dy=0.0, startlat=0.0, startlon=0.0, deltalat=0.0,
                      deltalon=0.0, earth_radius=6371.229)
            if iproj == 0:
                (_sw, kw["startlat"], kw["startlon"], kw["deltalat"],
                 kw["deltalon"], kw["earth_radius"]) = struct.unpack(
                    ">8sfffff", proj)
            elif iproj == 3:
                (_sw, kw["startlat"], kw["startlon"], kw["dx"], kw["dy"],
                 kw["xlonc"], kw["truelat1"], kw["truelat2"],
                 kw["earth_radius"]) = struct.unpack(">8sffffffff", proj)
            elif iproj == 5:
                (_sw, kw["startlat"], kw["startlon"], kw["dx"], kw["dy"],
                 kw["xlonc"], kw["truelat1"]) = struct.unpack(
                    ">8sffffff", proj)
            else:
                (_sw, kw["startlat"], kw["startlon"], kw["dx"], kw["dy"],
                 kw["truelat1"]) = struct.unpack(">8sfffff", proj)
            wrel = struct.unpack(">i", _rrec(f))[0]
            slab = np.frombuffer(_rrec(f), dtype=">f4").reshape(ny, nx)
            out.append(MetField(
                field=field.decode().strip(), units=units.decode().strip(),
                desc=desc.decode().strip(), hdate=hdate.decode().strip(),
                xfcst=xfcst, xlvl=xlvl, nx=nx, ny=ny, iproj=iproj,
                is_wind_grid_rel=bool(wrel),
                slab=np.asarray(slab, dtype=np.float64),
                map_source=map_source.decode().strip(), **kw))
    return out


def fields_by_level(fields: List[MetField], name: str):
    """Collect one variable's slabs sorted by decreasing pressure level
    (excluding the surface level 200100)."""
    lv = [(f.xlvl, f) for f in fields
          if f.field == name and f.xlvl < 200000.0]
    lv.sort(key=lambda t: -t[0])
    levels = np.asarray([t[0] for t in lv])
    slabs = np.stack([t[1].slab for t in lv], axis=0) if lv else None
    return levels, slabs


def surface_field(fields: List[MetField], name: str):
    for f in fields:
        if f.field == name and f.xlvl >= 200000.0:
            return f.slab
    return None
