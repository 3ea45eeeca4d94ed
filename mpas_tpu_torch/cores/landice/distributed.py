"""Sharded land-ice stepping (port of mpas_tpu/cores/landice/distributed.py).

The land-ice forward core is halo-light by construction: one FE step's
stencil is the SIA velocity (surface-slope gradient at edges + TRiSK
tangential reconstruct, depth-2 in cells) feeding a divergence at owned
cells (depth-1 in edges); the thermal column solve and calving are
shard-local (SURVEY §5.7). The reference exchanges thickness/temperature
once per timestep before the velocity solve
(ref: mpas_li_time_integration_fe.F halo-update group on
thickness/temperature ahead of li_velocity_solve) — here that is one
full-depth cell exchange at step entry; everything downstream runs on the
halo'd copy and owners are gathered at the end.

The FO Stokes solve shards as a distributed Krylov solve: the LSQ
geometry is rebuilt from the local mesh, each operator apply refreshes
its operand's halo, and the CG dots sum over owned rows across shards
(runner.psum_owned) — the decomposition the reference's external Albany
solve uses over its own partition. The IR advection's departure stencils
close within the depth-3 halo.
"""

from __future__ import annotations

import dataclasses

import torch

from mpas_tpu_torch.cores.landice.config import LiConfig
from mpas_tpu_torch.cores.landice.core import (LiGrid, LiState, fe_step,
                                               with_polythermal)
from mpas_tpu_torch.cores.landice.fo_stokes import build_fo_geom
from mpas_tpu_torch.parallel.layout import ShardedMesh, build_sharded_mesh
from mpas_tpu_torch.parallel.runner import (ShardExchange, ShardGroup,
                                            scatter_field)

LANDICE_HALO_DEPTH = 3

_EDGE_STATE = ("normalVelocity",)


@dataclasses.dataclass(frozen=True)
class ShardedLandice:
    grid: LiGrid                # stacked (P, ...) local fields, no FO geom
    smesh: ShardedMesh
    fo: bool                    # build the FO geometry per shard

    def local(self, group: ShardGroup, dtype) -> LiGrid:
        """The grid `group` holds, on its device. The FO geometry is built
        from the local mesh (host numpy float64) — a per-cell function of
        the cell's own neighbours, so the loopback layout's block-diagonal
        mesh gives each shard's own build — and then cast to `dtype`."""
        g = self.grid
        mesh = self.smesh.local(group, dtype)
        fo_geom = None
        if self.fo:
            host = (self.smesh.flat() if group.loopback
                    else self.smesh.shard(group.rank))
            fo_geom = build_fo_geom(host).to(group.device, dtype)
        return LiGrid(mesh=mesh,
                      bedTopography=group.local(g.bedTopography, dtype),
                      layerInterfaceSigma=g.layerInterfaceSigma.to(
                          group.device, dtype),
                      layerSigmaFraction=g.layerSigmaFraction.to(
                          group.device, dtype),
                      fo_geom=fo_geom)


def shard_li_grid(grid: LiGrid, cfg: LiConfig, part,
                  halo_depth: int = LANDICE_HALO_DEPTH) -> ShardedLandice:
    """Per-shard local grids from a global one (host, once)."""
    smesh = build_sharded_mesh(grid.mesh, part, halo_depth=halo_depth)
    bed = scatter_field(smesh, grid.bedTopography.cpu().numpy(), "cell")
    local = LiGrid(mesh=smesh.mesh, bedTopography=torch.from_numpy(bed),
                   layerInterfaceSigma=grid.layerInterfaceSigma.cpu(),
                   layerSigmaFraction=grid.layerSigmaFraction.cpu())
    return ShardedLandice(grid=local, smesh=smesh,
                          fo=cfg.config_velocity_solver == "FO")


def shard_li_state(sli: ShardedLandice, state: LiState) -> LiState:
    """Stacked (P, ...) LiState of CPU tensors."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        kind = "edge" if f.name in _EDGE_STATE else "cell"
        kw[f.name] = None if v is None else torch.from_numpy(
            scatter_field(sli.smesh, v.cpu().numpy(), kind))
    return LiState(**kw)


def make_run_steps_li(sli: ShardedLandice, cfg: LiConfig,
                      group: ShardGroup):
    """The sharded runner: (grid_l, state_l, n_steps) -> state_l, where
    grid_l = sli.local(group, dtype) and state_l = runner.place(stacked
    state, group, dtype). One full-depth cell exchange of thickness and
    temperature at each step entry; the FO solve's hooks inside."""
    xch = ShardExchange(sli.smesh, group)

    def refresh(s: LiState) -> LiState:
        # the FE step's entire halo need; calvingFlux/normalVelocity are
        # pure owned-cell diagnostics and are never read through the halo
        return dataclasses.replace(s, thickness=xch.cell(s.thickness),
                                   temperature=xch.cell(s.temperature))

    def run(grid_l: LiGrid, state_l: LiState, n_steps: int) -> LiState:
        owned = group.local(sli.smesh.owned_cell_mask,
                            state_l.thickness.dtype)
        dt = float(cfg.config_dt)
        state_l = with_polythermal(cfg, state_l)
        for _ in range(n_steps):
            state_l = fe_step(grid_l, cfg, refresh(state_l), dt, xch=xch,
                              owned=owned, group=group)
        return state_l
    return run
