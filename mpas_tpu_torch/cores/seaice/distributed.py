"""Sharded sea-ice stepping (port of mpas_tpu/cores/seaice/distributed.py).

The EVP elastic subcycle is the sea-ice core's communication-stress path
(ref: per-subcycle uVelocity/vVelocity exchanges inside
seaice_run_velocity_solver, mpas_seaice_velocity_solver.F:2326-2485):
here they become depth-2 vertex-field exchanges fired from the exchange
hook inside solve_velocities (velocity.py), mirroring the ocean
barotropic 'subcycleFields' choreography. Transport + column physics
consume the per-step full-depth cell-field refresh at step entry.

Both stress-divergence schemes shard: the weak scheme's geometry scatters
as plain cell/vertex fields; the variational corner tensors are rebuilt
from the local mesh (ShardedSeaice.local), matching the reference's
block-local variational init.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.core import seaice_timestep
from mpas_tpu_torch.cores.seaice.state import (SeaiceForcing, SeaiceGrid,
                                               SeaiceState)
from mpas_tpu_torch.cores.seaice.variational import (
    VariationalCoeffs, build_variational_coeffs)
from mpas_tpu_torch.parallel.layout import ShardedMesh, build_sharded_mesh
from mpas_tpu_torch.parallel.runner import (ShardExchange, ShardGroup,
                                            scatter_field)

SEAICE_HALO_DEPTH = 3

_VERTEX_STATE = ("uVelocity", "vVelocity")
_VERTEX_FORCING = ("sshGradientU", "sshGradientV")
_VERTEX_GRID = ("normalTriangleE", "normalTriangleN", "tanLatVertexOverR",
                "interiorVertex")
_CELL_GRID = ("normalPolygonE", "normalPolygonN", "tanLatCellOverR")


def local_variational_coeffs(mesh, basis: str = "wachspress"
                             ) -> VariationalCoeffs:
    """The variational basis of a padded local mesh (CPU tensors): a pure
    per-cell function of local geometry, so owned and halo rows match the
    global build; the dead-slot polygons are degenerate, and any
    non-finite value they give is set to 0 (their contributions are
    masked by valid_on_v and zero edge signs downstream), as the
    reference's per-shard build cleans them."""
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        vc = build_variational_coeffs(mesh, basis=basis)
    return dataclasses.replace(vc, **{
        f.name: torch.nan_to_num(getattr(vc, f.name), nan=0.0, posinf=0.0,
                                 neginf=0.0)
        for f in dataclasses.fields(vc)
        if getattr(vc, f.name).is_floating_point()})


@dataclasses.dataclass(frozen=True)
class ShardedSeaice:
    grid: SeaiceGrid            # stacked (P, ...) fields, no variational
    smesh: ShardedMesh
    variational_basis: str | None

    def local(self, group: ShardGroup, dtype) -> SeaiceGrid:
        """The grid `group` holds, on its device; the variational basis is
        built from the local mesh on the host (the loopback layout's
        block-diagonal mesh gives each shard's own build, its vertex
        stencils offset into the flat layout)."""
        g = self.grid
        var = None
        if self.variational_basis is not None:
            host = (self.smesh.flat() if group.loopback
                    else self.smesh.shard(group.rank))
            var = local_variational_coeffs(
                host, self.variational_basis).to(group.device, dtype)
        return dataclasses.replace(
            g, mesh=self.smesh.local(group, dtype), variational=var,
            dvEdgeMin=None if g.dvEdgeMin is None
            else g.dvEdgeMin.to(group.device, dtype),
            **{k: group.local(getattr(g, k), dtype)
               for k in _CELL_GRID + _VERTEX_GRID})


def shard_seaice_grid(grid: SeaiceGrid, part,
                      halo_depth: int = SEAICE_HALO_DEPTH,
                      variational_basis: str = "wachspress"
                      ) -> ShardedSeaice:
    """Per-shard local grids from a global one (host, once)."""
    smesh = build_sharded_mesh(grid.mesh, part, halo_depth=halo_depth)

    def sc(name, kind):
        return torch.from_numpy(scatter_field(
            smesh, getattr(grid, name).cpu().numpy(), kind))

    fields = {k: sc(k, "cell") for k in _CELL_GRID}
    fields.update({k: sc(k, "vertex") for k in _VERTEX_GRID})
    local = dataclasses.replace(
        grid, mesh=smesh.mesh, variational=None,
        # global scalar, replicated (the reference's dmpar_min result)
        dvEdgeMin=None if grid.dvEdgeMin is None else grid.dvEdgeMin.cpu(),
        **fields)
    return ShardedSeaice(grid=local, smesh=smesh,
                         variational_basis=None if grid.variational is None
                         else variational_basis)


def _shard_tree(smesh, obj, vertex_fields):
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kind = "vertex" if f.name in vertex_fields else "cell"
        kw[f.name] = None if v is None else torch.from_numpy(
            scatter_field(smesh, v.cpu().numpy(), kind))
    return type(obj)(**kw)


def shard_seaice_state(ssi: ShardedSeaice, state: SeaiceState
                       ) -> SeaiceState:
    """Stacked (P, ...) SeaiceState of CPU tensors."""
    return _shard_tree(ssi.smesh, state, _VERTEX_STATE)


def shard_seaice_forcing(ssi: ShardedSeaice,
                         forcing: SeaiceForcing) -> SeaiceForcing:
    """Stacked (P, ...) SeaiceForcing of CPU tensors."""
    return _shard_tree(ssi.smesh, forcing, _VERTEX_FORCING)


def make_run_steps_seaice(ssi: ShardedSeaice, cfg: SeaiceConfig,
                          group: ShardGroup):
    """The sharded runner: (grid_l, state_l, forcing_l, n_steps) ->
    state_l, where grid_l = ssi.local(group, dtype) and state_l,
    forcing_l = runner.place(stacked, group, dtype). A full-depth refresh
    of every state field at each step entry, then the elastic subcycle's
    vertex exchanges inside solve_velocities."""
    xch = ShardExchange(ssi.smesh, group)

    def refresh(s: SeaiceState) -> SeaiceState:
        kw = {}
        for f in dataclasses.fields(s):
            v = getattr(s, f.name)
            kw[f.name] = (None if v is None else xch.vertex(v)
                          if f.name in _VERTEX_STATE else xch.cell(v))
        return SeaiceState(**kw)

    def run(grid_l: SeaiceGrid, state_l: SeaiceState,
            forcing_l: SeaiceForcing, n_steps: int) -> SeaiceState:
        dt = float(cfg.config_dt)
        for _ in range(n_steps):
            state_l, _d = seaice_timestep(grid_l, cfg, refresh(state_l),
                                          forcing_l, dt, xch=xch)
        return state_l
    return run
