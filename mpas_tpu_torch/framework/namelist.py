"""Typed run configuration ("namelist") system (port of
mpas_tpu/framework/namelist.py).

The reference compiles each core's Registry.xml into `setup_namelist` code
that reads Fortran namelist files (ref: src/tools/registry/gen_inc.c:520;
consumed at core%setup_namelist, mpas_subdriver.F:207). Here each core
declares a frozen dataclass whose fields use the same `config_*` names and
defaults as the reference Registry (the port's AtmConfig, SWConfig and
OcnConfig); values can be overridden programmatically or loaded from a
Fortran-namelist-format file of a reference run directory.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Type, TypeVar

T = TypeVar("T")

_NML_BLOCK = re.compile(r"&(\w+)(.*?)^\s*/", re.S | re.M)
_NML_ITEM = re.compile(r"(\w+)\s*=\s*([^\n!]+)")


def _parse_value(raw: str, target_type):
    raw = raw.strip().rstrip(",").strip()
    if target_type is bool:
        return raw.lower().strip(". ") in ("true", "t")
    if target_type is int:
        return int(raw)
    if target_type is float:
        return float(raw.replace("d", "e").replace("D", "e"))
    return raw.strip("'\"")


def parse_namelist_file(path: str) -> dict:
    """Parse a Fortran namelist file into {record: {option: raw_string}}."""
    with open(path) as f:
        text = f.read()
    out = {}
    for m in _NML_BLOCK.finditer(text):
        record = m.group(1).lower()
        items = {}
        for im in _NML_ITEM.finditer(m.group(2)):
            items[im.group(1).lower()] = im.group(2)
        out[record] = items
    return out


def from_namelist_file(cls: Type[T], path: str, **overrides) -> T:
    """Build a config dataclass from a Fortran namelist file + overrides.

    Unknown options in the file are ignored (the reference warns similarly);
    unknown override keys raise.
    """
    raw = parse_namelist_file(path)
    flat = {}
    for record in raw.values():
        flat.update(record)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name.lower() in flat:
            kwargs[f.name] = _parse_value(flat[f.name.lower()], f.type
                                          if isinstance(f.type, type)
                                          else type(f.default))
    kwargs.update(overrides)
    return cls(**kwargs)
