"""Shallow-water core hooks for the run driver (port of
mpas_tpu/cores/sw/hooks.py), and the mesh specs every core's hooks read.

ref: sw_setup_core filling the core_type function pointers
(mpas_sw_core_interface.F:33).
"""

from __future__ import annotations

import dataclasses

import torch

from mpas_tpu_torch.containers import to_host
from mpas_tpu_torch.cores.sw import test_cases as tc
from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.cores.sw.time_integration import run_steps
from mpas_tpu_torch.framework.driver import CoreHooks
from mpas_tpu_torch.ops.reconstruct import (build_reconstruct_coeffs,
                                             reconstruct)


def parse_mesh_spec(spec: str):
    """icos:N | hex:NX,NY,DC | channel:NX,NY,DC | varres:N[,RATIO] |
    file:PATH | PATH.nc -> the port's Mesh (CPU tensors); icos and varres
    meshes go through the disk cache (mesh/cache.py); a grid file (classic
    NetCDF or netCDF4) is read by mesh/gridfile.py."""
    kind, _, rest = spec.partition(":")
    if kind == "icos":
        from mpas_tpu_torch.mesh.cache import cached
        from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
        n = int(rest)
        return cached(f"icos{n}_l4", lambda: icosahedral_mesh(
            n, lloyd_iters=4))
    if kind == "hex":
        from mpas_tpu_torch.mesh.planar import planar_hex_mesh
        nx, ny, dc = rest.split(",")
        return planar_hex_mesh(int(nx), int(ny), float(dc))
    if kind == "channel":
        from mpas_tpu_torch.mesh.planar import channel_hex_mesh
        nx, ny, dc = rest.split(",")
        return channel_hex_mesh(int(nx), int(ny), float(dc))
    if kind == "varres":
        # density-refined SCVT: varres:N[,ratio] (60-15km-style 4:1 default)
        from mpas_tpu_torch.mesh.cache import cached
        from mpas_tpu_torch.mesh.varres import variable_res_mesh
        parts = rest.split(",")
        n = int(parts[0])
        ratio = float(parts[1]) if len(parts) > 1 else 4.0
        return cached(f"varres{n}_r{ratio:g}",
                      lambda: variable_res_mesh(n, iterations=30,
                                                ratio=ratio))
    if kind == "file" or spec.endswith(".nc"):
        # an MPAS grid.nc / init.nc (ref mesh contract,
        # core_sw/Registry.xml:54-167)
        from mpas_tpu_torch.mesh.gridfile import mesh_from_netcdf
        return mesh_from_netcdf(rest if kind == "file" else spec)
    raise ValueError(f"unknown mesh spec {spec!r}")


@dataclasses.dataclass
class _SWRun:
    mesh: object
    cfg: SWConfig
    state: SWState
    h_s: object
    recon: object


def _setup(cfg: SWConfig, mesh_spec: str, device, dtype):
    mesh0 = parse_mesh_spec(mesh_spec)
    mesh, state, h_s = tc.SETUPS[cfg.config_test_case](mesh0)
    recon = torch.from_numpy(build_reconstruct_coeffs(mesh))
    return _SWRun(mesh=mesh.to(device, dtype), cfg=cfg,
                  state=state.to(device, dtype),
                  h_s=h_s.to(device, dtype), recon=recon.to(device, dtype))


def _step_chunk(run: _SWRun, n: int):
    run.state = run_steps(run.mesh, run.cfg, run.state, run.h_s, n)
    return run


def _fields(run: _SWRun, restart: bool):
    m = run.mesh
    s = run.state
    out = {"u": (("nEdges",), to_host(s.u)),
           "h": (("nCells",), to_host(s.h)),
           "tracers": (("nCells", "nTracers"), to_host(s.tracers))}
    if not restart:
        _, _, _, zon, mer = reconstruct(m, run.recon, s.u)
        out["uReconstructZonal"] = (("nCells",), to_host(zon))
        out["uReconstructMeridional"] = (("nCells",), to_host(mer))
    dims = {"nCells": m.nCells, "nEdges": m.nEdges,
            "nTracers": s.tracers.shape[-1]}
    return out, dims


def _resume(run: _SWRun, data: dict):
    like = run.state.h
    run.state = SWState(
        **{k: torch.as_tensor(data[k]).to(like.device, like.dtype)
           for k in ("u", "h", "tracers")})
    return run


HOOKS = CoreHooks(name="sw", config_cls=SWConfig, setup=_setup,
                  step_chunk=_step_chunk,
                  output_fields=lambda r: _fields(r, False),
                  restart_fields=lambda r: _fields(r, True),
                  resume=_resume)


def default_mesh(cfg: SWConfig) -> str:
    return "icos:16"
