"""Python interface to the repository's registry compiler (port of
mpas_tpu/framework/registry.py).

ref: the registry toolchain (SURVEY §2.2): one declarative schema for the
namelist, the field allocation, the stream contents and the package
gating. tools/registry/registry_compiler (C++, registry_compiler.cpp)
parses a Registry.xml and emits a Python config dataclass, a JSON field
schema, and default namelist and streams files.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch

from mpas_tpu_torch.containers import resolve_device

_BIN = (Path(__file__).resolve().parents[2] / "tools" / "registry"
        / "registry_compiler")


def _compiler() -> str:
    """The repository's compiler binary (built by tools/registry/Makefile)."""
    if not _BIN.exists():
        raise FileNotFoundError(
            f"{_BIN} is missing: build it with make -C tools/registry "
            "(tools/registry/Makefile)")
    return str(_BIN)


def _run(registry_xml: str, mode: str) -> str:
    return subprocess.run([_compiler(), registry_xml, mode], check=True,
                          capture_output=True, text=True).stdout


def load_schema(registry_xml: str) -> dict:
    """The field / dim / package / stream schema of a Registry.xml."""
    return json.loads(_run(registry_xml, "--schema-json"))


def generate_config_class(registry_xml: str):
    """Compile and import the namelist dataclass of a Registry.xml."""
    ns: dict = {}
    exec(compile(_run(registry_xml, "--config-py"), "<registry_config>",
                 "exec"), ns)
    return ns["Config"]


def generate_default_namelist(registry_xml: str) -> str:
    return _run(registry_xml, "--namelist")


def generate_default_streams(registry_xml: str) -> str:
    return _run(registry_xml, "--streams")


def build_state_pytree(schema: dict, dim_sizes: dict,
                       active_packages=None, dtype=None, device=None):
    """Allocate the per-var_struct state from a registry schema, with
    package gating: a var whose `packages` names only inactive packages
    is not allocated (ref: gen_inc.c:478 + mpas_dmpar.F:5226).

    Returns {struct_name: {var_name: zeros(dims)}} of tensors on `device`
    (cuda:0 where None): reals in `dtype` (float64 where None), integers
    int32, logicals bool. `dim_sizes` maps dim names to ints; an unknown
    dim raises KeyError. active_packages=None activates every package
    (the reference's default)."""
    device = resolve_device(device)
    real = dtype or torch.float64
    active = None if active_packages is None else set(active_packages)
    out = {}
    for sname, struct in schema.get("var_structs", {}).items():
        fields = {}
        for var in struct["vars"]:
            pkgs = [p for p in (var.get("packages") or "").split(";") if p]
            if pkgs and active is not None and not (set(pkgs) & active):
                continue                        # gated out: never allocated
            dims = [d.strip() for d in var["dims"].split() if d.strip()]
            try:
                shape = tuple(dim_sizes[d] for d in dims)
            except KeyError as e:
                raise KeyError(
                    f"var {var['name']}: unknown dimension {e} "
                    f"(have {sorted(dim_sizes)})") from None
            t = {"real": real, "integer": torch.int32,
                 "logical": torch.bool}.get(var["type"], real)
            fields[var["name"]] = torch.zeros(shape, dtype=t, device=device)
        out[sname] = fields
    return out
