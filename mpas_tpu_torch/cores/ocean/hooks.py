"""Ocean core hooks for the run driver (port of
mpas_tpu/cores/ocean/hooks.py; ref: ocn_forward_mode setup,
mpas_ocn_forward_mode.F:142): the baroclinic channel, restarted from
normalVelocity, normalBarotropicVelocity, layerThickness and tracers.
"""

from __future__ import annotations

import dataclasses

import torch

from mpas_tpu_torch.containers import to_host
from mpas_tpu_torch.cores.ocean.config import OcnConfig
from mpas_tpu_torch.cores.ocean.core import run_steps
from mpas_tpu_torch.cores.ocean.init_channel import init_baroclinic_channel
from mpas_tpu_torch.cores.ocean.state import OcnState
from mpas_tpu_torch.cores.sw.hooks import parse_mesh_spec
from mpas_tpu_torch.framework.driver import CoreHooks


@dataclasses.dataclass
class _OcnRun:
    grid: object
    cfg: OcnConfig
    state: OcnState


def _setup(cfg: OcnConfig, mesh_spec: str, device, dtype):
    grid, state = init_baroclinic_channel(parse_mesh_spec(mesh_spec))
    return _OcnRun(grid=grid.to(device, dtype), cfg=cfg,
                   state=state.to(device, dtype))


def _step_chunk(run: _OcnRun, n: int):
    run.state = run_steps(run.grid, run.cfg, run.state, n)
    return run


def _fields(run: _OcnRun, restart: bool):
    s = run.state
    m = run.grid.mesh
    out = {
        "normalVelocity": (("nEdges", "nVertLevels"), to_host(s.u)),
        "layerThickness": (("nCells", "nVertLevels"),
                           to_host(s.layerThickness)),
        "tracers": (("nCells", "nVertLevels", "nTracers"), to_host(s.tracers)),
    }
    if restart and s.ubtr is not None:
        out["normalBarotropicVelocity"] = (("nEdges",), to_host(s.ubtr))
    if not restart:
        out["ssh"] = (("nCells",), to_host(
            s.layerThickness.sum(-1) - run.grid.bottomDepth))
    dims = {"nCells": m.nCells, "nEdges": m.nEdges,
            "nVertLevels": run.grid.nz, "nTracers": s.tracers.shape[-1]}
    return out, dims


def _resume(run: _OcnRun, data: dict):
    like = run.state.u

    def t(a):
        return torch.as_tensor(a).to(like.device, like.dtype)

    u = t(data["normalVelocity"])
    ubtr = t(data["normalBarotropicVelocity"]) \
        if "normalBarotropicVelocity" in data else u.new_zeros(u.shape[0])
    run.state = OcnState(u=u, ubtr=ubtr,
                         layerThickness=t(data["layerThickness"]),
                         tracers=t(data["tracers"]))
    return run


HOOKS = CoreHooks(name="ocean", config_cls=OcnConfig, setup=_setup,
                  step_chunk=_step_chunk,
                  output_fields=lambda r: _fields(r, False),
                  restart_fields=lambda r: _fields(r, True),
                  resume=_resume)


def default_mesh(cfg: OcnConfig) -> str:
    return "channel:16,52,10000"
