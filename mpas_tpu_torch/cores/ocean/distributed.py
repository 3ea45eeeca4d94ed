"""Sharded ocean stepping (port of mpas_tpu/cores/ocean/distributed.py).

The split-explicit integrator is the reference's communication-stress
path: per barotropic subcycle it reuses a fused, depth-restricted
exchange group on ssh + normalBarotropicVelocity (ref:
mpas_ocn_exch_group_reuse usage, mpas_ocn_time_integration_split.F:771)
and a full 'finalBtrFields' group after subcycling (:1282-1290). Here
those become neighbor-schedule halo refreshes fired from the exchange
hooks inside split_step and rk4_step (core.py). Columns stay shard-local,
as in the atmosphere and shallow-water runners.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.cores.ocean.config import OcnConfig
from mpas_tpu_torch.cores.ocean.core import ocn_timestep
from mpas_tpu_torch.cores.ocean.state import OcnGrid, OcnState
from mpas_tpu_torch.parallel.layout import ShardedMesh, build_sharded_mesh
from mpas_tpu_torch.parallel.runner import (ShardExchange, ShardGroup, place,
                                            psum_owned, scatter_field)

# full tendency stencil radius (ref halo depth: config_num_halos=3,
# core_ocean/Registry.xml:153; +1 covers the TRiSK fperp double-ring)
OCN_HALO_DEPTH = 4


@dataclasses.dataclass(frozen=True)
class ShardedOcn:
    grid: OcnGrid          # stacked (P, ...) local grids
    smesh: ShardedMesh

    def local(self, group: ShardGroup, dtype) -> OcnGrid:
        """The grid `group` holds, on its device."""
        g = self.grid
        changes = {f.name: group.local(getattr(g, f.name), dtype)
                   for f in dataclasses.fields(g)
                   if isinstance(getattr(g, f.name), torch.Tensor)}
        return dataclasses.replace(g, mesh=self.smesh.local(group, dtype),
                                   **changes)


def shard_ocn_grid(grid: OcnGrid, part, halo_depth: int = OCN_HALO_DEPTH
                   ) -> ShardedOcn:
    """Per-shard local OcnGrids from a global one (host, once)."""
    smesh = build_sharded_mesh(grid.mesh, part, halo_depth=halo_depth)

    def sc(x, kind):
        return None if x is None else scatter_field(smesh, x, kind)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    bd = sc(grid.bottomDepth, "cell")
    rt = sc(grid.restingThickness, "cell")
    local = dataclasses.replace(
        grid, mesh=smesh.mesh,
        # dead padded slots: benign positive depths/thicknesses so that
        # the ssh/thickness algebra on them stays finite (owned stencils
        # never read them and they are never gathered back)
        restingThickness=t(np.where(rt == 0.0, 1.0, rt)),
        bottomDepth=t(np.where(bd == 0.0, 1.0, bd)),
        maxLevelCell=t(sc(grid.maxLevelCell, "cell")),
        cellMask=t(sc(grid.cellMask, "cell")),
        edgeMask=t(sc(grid.edgeMask, "edge")),
        surfacePressure=t(sc(grid.surfacePressure, "cell")),
        tidalEnergyFlux=t(sc(grid.tidalEnergyFlux, "cell")))
    return ShardedOcn(grid=local, smesh=smesh)


def shard_ocn_state(socn: ShardedOcn, state: OcnState) -> OcnState:
    """Stacked (P, ...) OcnState of CPU tensors; dead cells keep a
    thickness of 1."""
    sm = socn.smesh

    def c(x):
        return None if x is None else torch.from_numpy(
            scatter_field(sm, x, "cell"))

    h = scatter_field(sm, state.layerThickness, "cell")
    ubtr = state.ubtr if state.ubtr is not None \
        else torch.zeros(state.u.shape[0], dtype=state.u.dtype)
    return OcnState(
        u=torch.from_numpy(scatter_field(sm, state.u, "edge")),
        layerThickness=torch.from_numpy(np.where(h == 0.0, 1.0, h)),
        tracers=c(state.tracers),
        ubtr=torch.from_numpy(scatter_field(sm, ubtr, "edge")),
        lowFreqDivergence=c(state.lowFreqDivergence),
        highFreqThickness=c(state.highFreqThickness))


def make_run_steps_ocn(socn: ShardedOcn, cfg: OcnConfig, group: ShardGroup):
    """The sharded runner: (grid_l, state_l, n_steps) -> state_l, where
    grid_l = socn.local(group, dtype) and state_l = runner.place(stacked
    state, group, dtype). Exchanges: a full-depth refresh of the
    prognostics at each step entry (the reference's start-of-step
    exchanges, mpas_ocn_time_integration_split.F:214-268), then the
    split/RK4 hooks inside the integrator."""
    xch = ShardExchange(socn.smesh, group)

    def refresh(s: OcnState) -> OcnState:
        def opt(x):
            return None if x is None else xch.cell(x)
        return OcnState(u=xch.edge(s.u),
                        layerThickness=xch.cell(s.layerThickness),
                        tracers=xch.cell(s.tracers), ubtr=xch.edge(s.ubtr),
                        lowFreqDivergence=opt(s.lowFreqDivergence),
                        highFreqThickness=opt(s.highFreqThickness))

    def run(grid_l: OcnGrid, state_l: OcnState, n_steps: int) -> OcnState:
        dt = float(cfg.config_dt)
        for _ in range(n_steps):
            state_l = ocn_timestep(grid_l, cfg, refresh(state_l), dt,
                                   xch=xch)
        return state_l
    return run


def volume_heat(grid_l: OcnGrid, state_l: OcnState, owned_cell_mask,
                group: ShardGroup):
    """(volume, heat) = sums of h area and h T area over owned cells only,
    in float64."""
    h = state_l.layerThickness.double() \
        * grid_l.mesh.areaCell.double()[:, None]
    mask = owned_cell_mask.double()
    return (float(psum_owned(h, mask, group)),
            float(psum_owned(h * state_l.tracers[..., 0].double(), mask,
                             group)))


def run_on_rank(group: ShardGroup, socn: ShardedOcn, cfg: OcnConfig,
                state_st: OcnState, n_steps: int, dtype=torch.float64):
    """Process-group worker (runner.spawn_ranks), or a loopback run: the
    stacked state stepped n_steps on `group`. Returns u, layerThickness
    and tracers stacked (P, n, ...) from every shard (group.stack) and the
    owned volume and heat (psum_owned)."""
    grid_l = socn.local(group, dtype)
    out = make_run_steps_ocn(socn, cfg, group)(
        grid_l, place(state_st, group, dtype), n_steps)
    res = {k: group.stack(getattr(out, k))
           for k in ("u", "layerThickness", "tracers")}
    res["volume"], res["heat"] = volume_heat(
        grid_l, out, group.local(socn.smesh.owned_cell_mask, dtype), group)
    return res
