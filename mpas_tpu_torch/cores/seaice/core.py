"""Sea-ice core timestep: velocity solve -> transport -> column physics
(port of mpas_tpu/cores/seaice/core.py).

ref: src/core_seaice/shared/mpas_seaice_time_integration.F:42-174
(seaice_timestep: seaice_run_velocity_solver :148 -> seaice_run_advection
:154 -> column physics). A multi-step run is a Python loop of steps.
"""

from __future__ import annotations

from mpas_tpu_torch.cores.seaice.advection import advect_upwind
from mpas_tpu_torch.cores.seaice.column import column_physics_step
from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.remap import advect_incremental_remap
from mpas_tpu_torch.cores.seaice.state import (SeaiceForcing, SeaiceGrid,
                                               SeaiceState)
from mpas_tpu_torch.cores.seaice.velocity import solve_velocities


def seaice_timestep(grid: SeaiceGrid, cfg: SeaiceConfig, state: SeaiceState,
                    forcing: SeaiceForcing, dt, xch=None):
    """One step; returns (state, diagnostics of the velocity solve)."""
    diags = {}
    if cfg.config_use_velocity_solver:
        state, diags = solve_velocities(grid, cfg, state, forcing, dt,
                                        xch=xch)
    if cfg.config_advection_type == "upwind":
        state = advect_upwind(grid, cfg, state, dt)
    elif cfg.config_advection_type == "incremental_remap":
        state = advect_incremental_remap(grid, cfg, state, dt)
    if cfg.config_use_column_physics:
        state = column_physics_step(cfg, state, forcing, dt)
    return state, diags


def run_steps(grid: SeaiceGrid, cfg: SeaiceConfig, state: SeaiceState,
              forcing: SeaiceForcing, n_steps: int) -> SeaiceState:
    """n_steps of seaice_timestep at cfg.config_dt."""
    for _ in range(n_steps):
        state, _d = seaice_timestep(grid, cfg, state, forcing,
                                    float(cfg.config_dt))
    return state


def total_ice_volume(grid: SeaiceGrid, state: SeaiceState):
    """Domain-integrated ice volume (m^3): the conservation invariant, a
    0-d tensor."""
    return (state.iceVolumeCategory.sum(-1) * grid.mesh.areaCell).sum()
