"""landice_dome_4km and landice_dome_4km_fo: a Greenland-scale Halfar dome
at 4 km, under the reference's default options and under MALI's usual
ones.

    python -m mpas_tpu_torch.tools.landice_dome                 # cuda:0
    python -m mpas_tpu_torch.tools.landice_dome --path landice_dome_4km_fo \\
        --device cpu --steps 1 --mesh 20,20,3000 --dome 500,25000

Both paths share box_hex_mesh(302, 348, 4 km) (103,800 cells, a walled
1,208 x 1,205 km basin) and init_halfar's start: a dome of H0 = 3,000 m
and R0 = 550 km on a flat bed at 0 m (~0.95 M km^2 of ice), 10 layers,
float64 (the reference builds its land-ice state in float64, and the FO
solve's CG guards its divisions with 1e-300, which is 0 in float32),
dt 0.05 yr (config_dt's default, inside the SIA's explicit diffusive
limit at 4 km).

- landice_dome_4km: LiConfig() but for the level count: SIA, centered
  advection, the temperature solver, no calving.
- landice_dome_4km_fo: MALI's usual options: the first-order Stokes
  velocity (10 Picard x 120 CG, no-slip), the enthalpy solver with the
  Paterson-Budd flow factor, incremental remapping, eigencalving; after
  each fe_step one sgh_step_full of the subglacial hydrology (channels,
  10 substeps) fed by the step's basal melt and a sliding speed of 1e-6
  m/s under ice (tests/test_landice_hydro.py:97-114), then global_stats.

chip_smoke.py (phase 5) and tests/test_torch_landice_slice.py build the
paths from these functions. Run as a script, it builds one path on the
device, prints its setup seconds (mesh, grid, init), then times `--steps`
steps after one warm step and prints ms/step.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from mpas_tpu_torch.containers import resolve_device
from mpas_tpu_torch.cores.landice.config import LiConfig
from mpas_tpu_torch.cores.landice.core import (fe_step, make_grid,
                                               with_polythermal)
from mpas_tpu_torch.cores.landice.hydro import sgh_step_full, zero_hydro
from mpas_tpu_torch.cores.landice.init_dome import init_halfar
from mpas_tpu_torch.cores.landice.statistics import global_stats
from mpas_tpu_torch.framework.timers import span
from mpas_tpu_torch.mesh.planar import box_hex_mesh

MESH = (302, 348, 4000.0)      # 103,800 cells at 4 km
DOME = (3000.0, 550.0e3)       # h0, r0 (m)
PATHS = ("landice_dome_4km", "landice_dome_4km_fo")
N_LEVELS = 10
FO_OPTIONS = dict(config_velocity_solver="FO",
                  config_thermal_solver="enthalpy",
                  config_flowParamA_calculation="PB1982",
                  config_thickness_advection="incremental_remapping",
                  config_calving="eigencalving")
HYDRO_SUBSTEPS = 10
SLIDING_SPEED = 1.0e-6         # m/s under ice, drives cavity opening
# the parts of a step the profiled step reports (spans of step())
PARTS = ("li.velocity", "li.advection", "li.thermal", "li.calving",
         "li.hydrology", "li.stats")


def config(name, **overrides) -> LiConfig:
    """The path's configuration."""
    options = FO_OPTIONS if name == "landice_dome_4km_fo" else {}
    return LiConfig(**{"config_nvertlevels": N_LEVELS, **options,
                       **overrides})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(name, mesh, cfg, dome=DOME, dtype=torch.float64, device=None):
    """(grid, state, hydro, seconds) of the path on `mesh` in `dtype` on
    `device` (cuda:0 when None); hydro is None on landice_dome_4km, a dry
    bed with channels on the FO path. seconds = {"grid": make_grid with
    build_fo_geom where the path uses it, "init": the Halfar start},
    host clock, the device synchronised."""
    device = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()
    grid = make_grid(mesh, cfg).to(device, dtype)
    _sync(device)
    seconds["grid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _g, state, _t0 = init_halfar(mesh, dataclasses.replace(
        cfg, config_velocity_solver="sia"), h0=dome[0], r0=dome[1],
        dtype=dtype, device=device)
    state = with_polythermal(cfg, state)
    hydro = None
    if name == "landice_dome_4km_fo":
        hydro = zero_hydro(mesh.nCells, dtype=dtype, n_edges=mesh.nEdges,
                           device=device)
    _sync(device)
    seconds["init"] = time.perf_counter() - t0
    return grid, state, hydro, seconds


def sliding_speed(thickness):
    """SLIDING_SPEED under ice (thickness > 1 m), 0 elsewhere."""
    return torch.where(thickness > 1.0,
                       torch.full_like(thickness, SLIDING_SPEED),
                       torch.zeros_like(thickness))


def step(grid, cfg, state, hydro, resid_out=None):
    """One step of the path: fe_step, then on the FO path the hydrology;
    global_stats of the new state. Returns (state, hydro, stats); the
    stats are 0-d device tensors. Its parts are fe_step's spans,
    li.hydrology and li.stats (PARTS)."""
    dt = float(cfg.config_dt)
    state = fe_step(grid, cfg, state, dt, resid_out=resid_out)
    if hydro is not None:
        with span("li.hydrology"):
            h = state.thickness
            hydro = sgh_step_full(grid, cfg, hydro, h, state.basalMeltRate,
                                  sliding_speed(h), dt, n_sub=HYDRO_SUBSTEPS,
                                  channels=True)
    with span("li.stats"):
        stats = global_stats(grid, cfg, state)
    return state, hydro, stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=PATHS, default=PATHS[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0)")
    parser.add_argument("--mesh", default=",".join(str(x) for x in MESH),
                        help="box_hex_mesh's nx,ny,dc")
    parser.add_argument("--dome", default=",".join(str(x) for x in DOME),
                        help="the Halfar dome's h0,r0 in m")
    args = parser.parse_args(argv)
    nx, ny, dc = args.mesh.split(",")
    dome = tuple(float(x) for x in args.dome.split(","))
    t0 = time.perf_counter()
    mesh = box_hex_mesh(int(nx), int(ny), float(dc))
    mesh_s = time.perf_counter() - t0
    cfg = config(args.path)
    grid, state, hydro, seconds = setup(args.path, mesh, cfg, dome,
                                        device=args.device)
    device = state.thickness.device
    print(f"{args.path}: {mesh.nCells} cells x {cfg.config_nvertlevels} "
          f"levels on {device}; mesh {mesh_s:.2f} s, grid "
          f"{seconds['grid']:.2f} s, init {seconds['init']:.2f} s")
    state, hydro, _ = step(grid, cfg, state, hydro)            # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, hydro, stats = step(grid, cfg, state, hydro)
    _sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / max(args.steps, 1)
    print(f"{args.path}: {args.steps} steps at {ms:.2f} ms/step; "
          + ", ".join(f"{k} {float(v):.6e}" for k, v in stats.items()))


if __name__ == "__main__":
    main()
