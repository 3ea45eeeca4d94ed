"""Carry a state across from the reference package.

The input is the reference's `AtmGrid`/`AtmState`/`AtmDiag`/`AtmCarry`,
`PhysicsState`, `UrbanState`, `SWState`,
`OcnGrid`/`OcnState`/`OcnSurfaceForcing`,
`SeaiceGrid`/`SeaiceState`/`SeaiceForcing`, `LiGrid`/`LiState`,
`HydroState`, `ShardedMesh`, `BdyMasks`,
`LbcRecord` or `IAUIncrements` flattened to
nested dicts of numpy arrays plus their static ints and
floats (nCells, nz, cf1..3, adv_beta, sphere_radius, ...): the same field
names, no JAX types. The reconstruction coefficients are a plain array
(torch.from_numpy). Fields the port does not carry (the indexed advection
stencil) are ignored; a real-data grid, which carries only that stencil,
gets the factored advection tensors built from its mesh. Arrays become
CPU tensors of the same float dtype; index arrays become int64; fields
that are None stay None.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.cores.atmosphere.boundaries import BdyMasks
from mpas_tpu_torch.cores.atmosphere.iau import IAUIncrements
from mpas_tpu_torch.cores.atmosphere.setup import (AtmGrid, VerticalGrid,
                                                   build_adv_cell_tensors,
                                                   build_adv_factored,
                                                   build_cell_fit_matrices)
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.cores.atmosphere.physics.manager import PhysicsState
from mpas_tpu_torch.cores.atmosphere.physics.urban import UrbanState
from mpas_tpu_torch.cores.atmosphere.time_integration import AtmCarry
from mpas_tpu_torch.cores.ocean.forcing import OcnSurfaceForcing
from mpas_tpu_torch.cores.init_atmosphere.surface_lbc import LbcRecord
from mpas_tpu_torch.cores.landice.core import LiGrid, LiState
from mpas_tpu_torch.cores.landice.fo_stokes import FoGeom
from mpas_tpu_torch.cores.landice.hydro import HydroState
from mpas_tpu_torch.cores.ocean.state import OcnGrid, OcnState
from mpas_tpu_torch.cores.seaice.state import (SeaiceForcing, SeaiceGrid,
                                               SeaiceState)
from mpas_tpu_torch.cores.seaice.variational import VariationalCoeffs
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.parallel.layout import (HaloExchange, NeighborExchange,
                                            ShardedMesh)


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


def grid_from_arrays(d, adv_beta=None) -> AtmGrid:
    """A reference AtmGrid. Where it lacks the factored advection tensors
    (the real-data init fills only the indexed stencil), they are built
    from its mesh as the port's inits build them, and adv_beta must be
    given: the config's config_coef_3rd_order, which the reference's
    indexed stencil has baked into adv_coefs_3rd."""
    mesh = mesh_from_arrays(d["mesh"])
    nested = {}
    if d.get("d2_bmat") is None:
        if adv_beta is None:
            raise ValueError("the grid has no factored advection tensors: "
                             "pass adv_beta=config_coef_3rd_order")
        bmats = build_cell_fit_matrices(mesh)
        d2_bmat, d2w = build_adv_factored(mesh, bmats)
        d2w_own, d2w_opp, s_cp, dv_cell = build_adv_cell_tensors(mesh)
        nested = {k: _tensor(v) for k, v in dict(
            d2_bmat=d2_bmat, d2w=d2w, d2w_own=d2w_own, d2w_opp=d2w_opp,
            adv_sside=s_cp, dv_cell=dv_cell).items()}
        nested["adv_beta"] = float(adv_beta)
    return _build(AtmGrid, d, mesh=mesh,
                  vert=_build(VerticalGrid, d["vert"]), **nested)


def state_from_arrays(d) -> AtmState:
    return _build(AtmState, d)


def diag_from_arrays(d) -> AtmDiag:
    return _build(AtmDiag, d)


def carry_from_arrays(d) -> AtmCarry:
    return _build(AtmCarry, d, state=state_from_arrays(d["state"]),
                  diag=diag_from_arrays(d["diag"]))


def physics_state_from_arrays(d) -> PhysicsState:
    """A flattened reference PhysicsState; fields that are None (the Noah
    soil column in slab mode, the sea-ice and glacier masks, ...) stay
    None."""
    return _build(PhysicsState, d)


def urban_state_from_arrays(d) -> UrbanState:
    """A flattened reference UrbanState (the same ten fields)."""
    return _build(UrbanState, d)


def sw_state_from_arrays(d) -> SWState:
    return _build(SWState, d)


def ocn_grid_from_arrays(d) -> OcnGrid:
    return _build(OcnGrid, d, mesh=mesh_from_arrays(d["mesh"]))


def ocn_state_from_arrays(d) -> OcnState:
    return _build(OcnState, d)


def ocn_forcing_from_arrays(d) -> OcnSurfaceForcing:
    return _build(OcnSurfaceForcing, d)


def seaice_grid_from_arrays(d) -> SeaiceGrid:
    """A reference SeaiceGrid, with its VariationalCoeffs where it has
    them."""
    var = d["variational"]
    return _build(SeaiceGrid, d, mesh=mesh_from_arrays(d["mesh"]),
                  variational=None if var is None
                  else _build(VariationalCoeffs, var))


def seaice_state_from_arrays(d) -> SeaiceState:
    return _build(SeaiceState, d)


def seaice_forcing_from_arrays(d) -> SeaiceForcing:
    return _build(SeaiceForcing, d)


def landice_grid_from_arrays(d) -> LiGrid:
    """A reference LiGrid; its FoGeom (a NamedTuple there) as a dict of
    the same fields, or None."""
    geom = d["fo_geom"]
    if geom is not None:
        geom = {k: np.asarray(v) for k, v in dict(geom).items()}
        geom["nbr_mask"] = geom["nbr_mask"].astype(np.float64)
        geom = _build(FoGeom, geom)
    return _build(LiGrid, d, mesh=mesh_from_arrays(d["mesh"]),
                  fo_geom=geom)


def landice_state_from_arrays(d) -> LiState:
    return _build(LiState, d)


def hydro_state_from_arrays(d) -> HydroState:
    return _build(HydroState, d)


def sharded_mesh_from_arrays(d) -> ShardedMesh:
    """A reference ShardedMesh: its stacked mesh becomes a Mesh of CPU
    tensors; the schedules, masks and global ids stay numpy. The
    neighbor schedules are {depth: dict of NeighborExchange fields}, with
    send_idx a sequence of arrays and perms, sizes as the reference's."""
    def nx_table(t):
        return {int(depth): NeighborExchange(
            send_idx=tuple(np.asarray(a) for a in nx["send_idx"]),
            splice=np.asarray(nx["splice"]),
            perms=tuple(tuple((int(q), int(p)) for q, p in rnd)
                        for rnd in nx["perms"]),
            sizes=tuple(int(s) for s in nx["sizes"]),
            volume=int(nx["volume"])) for depth, nx in t.items()}

    host = {k: np.asarray(d[k]) for k in (
        "owned_cell_mask", "owned_edge_mask", "owned_vertex_mask",
        "cell_global", "edge_global", "vertex_global")}
    return _build(ShardedMesh, d, mesh=mesh_from_arrays(d["mesh"]), **host,
                  cell_xch=HaloExchange(**d["cell_xch"]),
                  edge_xch=HaloExchange(**d["edge_xch"]),
                  cell_nx=nx_table(d["cell_nx"]),
                  edge_nx=nx_table(d["edge_nx"]),
                  vertex_nx=nx_table(d["vertex_nx"]))


def bdy_masks_from_arrays(d) -> BdyMasks:
    return _build(BdyMasks, d)


def lbc_record_from_arrays(d) -> LbcRecord:
    """A reference LbcRecord: its arrays stay numpy, as the port's
    build_lbc_records gives them."""
    return LbcRecord(**{f.name: d[f.name]
                        for f in dataclasses.fields(LbcRecord)})


def iau_increments_from_arrays(d) -> IAUIncrements:
    return _build(IAUIncrements, d)


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
