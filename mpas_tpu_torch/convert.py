"""Carry a state across from the reference package.

The input is the reference's `AtmGrid`/`AtmState`/`AtmDiag`/`AtmCarry`,
`SWState` or `OcnGrid`/`OcnState`/`OcnSurfaceForcing` flattened to
nested dicts of numpy arrays plus their static ints and floats (nCells,
nz, cf1..3, adv_beta, sphere_radius, ...): the same field names, no JAX
types. Fields the port does not carry (the indexed advection stencil)
are ignored. Arrays become CPU tensors of the same float dtype; index
arrays become int64; fields that are None stay None.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.cores.atmosphere.setup import AtmGrid, VerticalGrid
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.cores.atmosphere.time_integration import AtmCarry
from mpas_tpu_torch.cores.ocean.forcing import OcnSurfaceForcing
from mpas_tpu_torch.cores.ocean.state import OcnGrid, OcnState
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.mesh.mesh import Mesh


def _tensor(v):
    a = np.array(v)                      # a copy: the port owns its memory
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def _build(cls, d, **nested):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in nested:
            kw[f.name] = nested[f.name]
        else:
            v = d[f.name]
            kw[f.name] = _tensor(v) if isinstance(v, np.ndarray) else v
    return cls(**kw)


def mesh_from_arrays(d) -> Mesh:
    return _build(Mesh, d)


def grid_from_arrays(d) -> AtmGrid:
    return _build(AtmGrid, d, mesh=mesh_from_arrays(d["mesh"]),
                  vert=_build(VerticalGrid, d["vert"]))


def state_from_arrays(d) -> AtmState:
    return _build(AtmState, d)


def diag_from_arrays(d) -> AtmDiag:
    return _build(AtmDiag, d)


def carry_from_arrays(d) -> AtmCarry:
    return _build(AtmCarry, d, state=state_from_arrays(d["state"]),
                  diag=diag_from_arrays(d["diag"]))


def sw_state_from_arrays(d) -> SWState:
    return _build(SWState, d)


def ocn_grid_from_arrays(d) -> OcnGrid:
    return _build(OcnGrid, d, mesh=mesh_from_arrays(d["mesh"]))


def ocn_state_from_arrays(d) -> OcnState:
    return _build(OcnState, d)


def ocn_forcing_from_arrays(d) -> OcnSurfaceForcing:
    return _build(OcnSurfaceForcing, d)


def to_arrays(obj):
    """Inverse direction: a port container -> nested dict of numpy arrays
    and statics, with the same field names."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_arrays(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = v
    return out
