"""Sharded shallow-water stepping (port of
mpas_tpu/cores/sw/distributed.py).

Parallel strategy re-designed from the reference's per-stage halo
exchanges of diagnostics + tendencies (ref: sw_rk4 halo calls,
mpas_sw_time_integration.F:131-137,153-157): each shard exchanges only
the three prognostic fields once per stage and recomputes the
diagnostics redundantly in a deep halo (halo_depth >= 4 covers the full
tendency stencil radius). Owned entities match the single-shard run.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.cores.sw.time_integration import (_RK_SUBSTEP,
                                                      _RK_WEIGHTS, _stage)
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.parallel.layout import ShardedMesh
from mpas_tpu_torch.parallel.runner import ShardExchange, ShardGroup

SW_HALO_DEPTH = 4  # tendency stencil radius of the TRiSK SW scheme


def _exchange_state(xch: ShardExchange, state: SWState) -> SWState:
    return SWState(u=xch.edge(state.u, SW_HALO_DEPTH),
                   h=xch.cell(state.h, SW_HALO_DEPTH),
                   tracers=xch.cell(state.tracers, SW_HALO_DEPTH))


def rk4_step_local(mesh: Mesh, xch: ShardExchange, cfg: SWConfig,
                   state: SWState, h_s, dt) -> SWState:
    """One RK4 step on the shards of `mesh`: the single-device rk4_step
    with one prognostic exchange per stage."""
    state = _exchange_state(xch, state)
    u0, h0 = state.u, state.h
    ct0 = state.tracers * h0[:, None]

    u_acc, h_acc, ct_acc = u0, h0, ct0
    provis = state
    for stage in range(4):
        tend_u, tend_h, tend_ct = _stage(mesh, cfg, provis, dt, h_s)

        u_acc = u_acc + dt * _RK_WEIGHTS[stage] * tend_u
        h_acc = h_acc + dt * _RK_WEIGHTS[stage] * tend_h
        ct_acc = ct_acc + dt * _RK_WEIGHTS[stage] * tend_ct

        if stage < 3:
            w = dt * _RK_SUBSTEP[stage]
            hp = h0 + w * tend_h
            provis = SWState(u=u0 + w * tend_u, h=hp,
                             tracers=(ct0 + w * tend_ct) / hp[:, None])
            provis = _exchange_state(xch, provis)

    # dead padded cell slots keep h == 0; avoid 0/0 in the decouple
    h_safe = torch.where(h_acc == 0, 1.0, h_acc)
    return SWState(u=u_acc, h=h_acc, tracers=ct_acc / h_safe[:, None])


def make_run_steps(smesh: ShardedMesh, cfg: SWConfig, group: ShardGroup):
    """The sharded runner: (mesh_l, state_l, hs_l, n_steps) -> state_l,
    where mesh_l = smesh.local(group, dtype) and state_l, hs_l come from
    runner.place / group.local of the stacked fields."""
    xch = ShardExchange(smesh, group)

    def run(mesh_l: Mesh, state_l: SWState, hs_l, n_steps: int) -> SWState:
        for _ in range(n_steps):
            state_l = rk4_step_local(mesh_l, xch, cfg, state_l, hs_l,
                                     cfg.config_dt)
        return state_l
    return run
