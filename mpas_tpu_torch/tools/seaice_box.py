"""seaice_box_10km and seaice_box_10km_default: the sea-ice box at full
size, as MPAS-Seaice runs in E3SM and under the reference's defaults.

    python -m mpas_tpu_torch.tools.seaice_box                 # cuda:0
    python -m mpas_tpu_torch.tools.seaice_box --device cpu --steps 2 \\
        --mesh 12,12,10000

Both paths share box_hex_mesh(202, 202, 10 km) (40,000 cells, a
2,000 x 1,720 km basin with walls) and init_square's start and forcing:
a rotating 5 +- 3 m/s wind, a slowly circulating ocean, -10 C air,
50 / 250 W/m2 of shortwave / longwave; dt 3,600 s, 120 elastic
subcycles.

- seaice_box_10km: MPAS-Seaice's E3SM options (E3SM_OPTIONS): the
  variational stress divergence (Wachspress basis), incremental remapping,
  mushy thermodynamics with prognostic salinity (the coupled brine
  dynamics), delta-Eddington shortwave, level-ice ponds, the linear ITD,
  ice age; 5 categories, 7 ice layers and 1 snow layer, started as the
  reference's own tests compose the multilayer and tracer state
  (tests/test_seaice_column_pkgs.py:241-296, tests/test_seaice_thermo.py):
  enthalpy at -5 C over the BL99 salinity profile, ponds 0, level ice 1,
  age 0.
- seaice_box_10km_default: SeaiceConfig() (weak EVP, upwind transport,
  zero-layer thermodynamics, ccsm3 albedos, the rebin ITD).

chip_smoke.py (phase 5) and tests/test_torch_seaice_slice.py build the
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
from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.core import seaice_timestep
from mpas_tpu_torch.cores.seaice.init_square import init_square
from mpas_tpu_torch.cores.seaice.state import make_grid
from mpas_tpu_torch.cores.seaice.thermo_vertical import (
    bl99_salinity_profile, init_enthalpy)
from mpas_tpu_torch.mesh.planar import box_hex_mesh

MESH = (202, 202, 10000.0)     # 40,000 cells at 10 km
PATHS = ("seaice_box_10km", "seaice_box_10km_default")
N_ICE_LAYERS, N_SNOW_LAYERS = 7, 1
T_INIT = -5.0                  # C, the multilayer start
E3SM_OPTIONS = dict(config_stress_divergence_scheme="variational",
                    config_advection_type="incremental_remap",
                    config_thermo_type="mushy", config_use_zsalinity=True,
                    config_shortwave_type="dedd", config_pond_scheme="lvl",
                    config_itd_remap_type="linear", config_use_ice_age=True,
                    config_n_ice_layers=N_ICE_LAYERS,
                    config_n_snow_layers=N_SNOW_LAYERS)


# the fields a comparison of two runs holds: the dynamics fields as they
# are, each tracer as its content (tracer x parent). The transport and the
# linear ITD divide contents by their new parents, near empty in a cell
# that just gained or lost its ice, so a per-unit tracer there carries its
# content's rounding difference times 1/parent (ROADMAP §3).
DYNAMICS = ("iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory",
            "uVelocity", "vVelocity", "stress11", "stress22", "stress12")
TRACER_PARENTS = {"surfaceTemperature": "iceAreaCategory",
                  "iceEnthalpy": "iceVolumeCategory",
                  "snowEnthalpy": "snowVolumeCategory",
                  "iceSalinity": "iceVolumeCategory",
                  "pondArea": "iceAreaCategory",
                  "pondDepth": "iceAreaCategory",
                  "pondLid": "iceAreaCategory",
                  "levelIceArea": "iceAreaCategory",
                  "levelIceVolume": "iceAreaCategory",
                  "iceAge": "iceAreaCategory"}


def held_fields(state):
    """{name: tensor} of DYNAMICS and the content of each tracer the state
    carries ("<tracer>*<parent>")."""
    out = {k: getattr(state, k) for k in DYNAMICS}
    for k, parent in TRACER_PARENTS.items():
        t = getattr(state, k)
        if t is not None:
            p = getattr(state, parent)
            out[f"{k}*{parent}"] = t * p.reshape(p.shape + (1,) * (t.dim()
                                                                   - p.dim()))
    return out


def config(name, **overrides) -> SeaiceConfig:
    """The path's configuration (dt 3,600 s and 120 elastic subcycles are
    SeaiceConfig's defaults)."""
    options = E3SM_OPTIONS if name == "seaice_box_10km" else {}
    return SeaiceConfig(**{**options, **overrides})


def e3sm_tracers(cfg: SeaiceConfig, state):
    """The multilayer and tracer start of seaice_box_10km: enthalpies at
    T_INIT, the BL99 salinity profile, ponds 0, level ice 1, age 0."""
    a = state.iceAreaCategory
    nC, nCat = a.shape
    q_i, q_s = init_enthalpy(cfg, nC, nCat, N_ICE_LAYERS, N_SNOW_LAYERS,
                             T_INIT, dtype=a.dtype, device=a.device)
    salinity = torch.as_tensor(bl99_salinity_profile(N_ICE_LAYERS),
                               dtype=a.dtype, device=a.device)
    zero = torch.zeros_like(a)
    return dataclasses.replace(
        state, iceEnthalpy=q_i, snowEnthalpy=q_s,
        iceSalinity=salinity.expand(nC, nCat, N_ICE_LAYERS).clone(),
        pondArea=zero, pondDepth=zero, pondLid=zero,
        levelIceArea=torch.ones_like(a), levelIceVolume=torch.ones_like(a),
        iceAge=zero)


def setup(name, mesh, cfg, dtype=torch.float32, device=None):
    """(grid, state, forcing, seconds) of the path on `mesh` in `dtype` on
    `device` (cuda:0 when None); seconds = {"grid": make_grid with the
    variational build where the path uses it, "init": init_square and the
    tracer start}, host clock, the device synchronised."""
    device = resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()
    grid = None
    if cfg.config_stress_divergence_scheme == "variational":
        grid = make_grid(mesh, variational=True).to(device, dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds["grid"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    weak_grid, state, forcing = init_square(mesh, cfg, dtype, device)
    if name == "seaice_box_10km":
        state = e3sm_tracers(cfg, state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds["init"] = time.perf_counter() - t0
    return (weak_grid if grid is None else grid), state, forcing, seconds


def total_volume(grid, state):
    """Domain ice volume (m^3) as a host float, summed in float64."""
    return float((state.iceVolumeCategory.double().sum(-1)
                  * grid.mesh.areaCell.double()).sum())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=PATHS, default=PATHS[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0)")
    parser.add_argument("--mesh", default=",".join(str(x) for x in MESH),
                        help="box_hex_mesh's nx,ny,dc")
    args = parser.parse_args(argv)
    nx, ny, dc = args.mesh.split(",")
    t0 = time.perf_counter()
    mesh = box_hex_mesh(int(nx), int(ny), float(dc))
    mesh_s = time.perf_counter() - t0
    cfg = config(args.path)
    grid, state, forcing, seconds = setup(args.path, mesh, cfg,
                                          device=args.device)
    device = state.uVelocity.device
    print(f"{args.path}: {mesh.nCells} cells on {device}; mesh "
          f"{mesh_s:.2f} s, grid {seconds['grid']:.2f} s, init "
          f"{seconds['init']:.2f} s")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    dt = float(cfg.config_dt)
    state, _ = seaice_timestep(grid, cfg, state, forcing, dt)   # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = seaice_timestep(grid, cfg, state, forcing, dt)
    sync()
    ms = 1e3 * (time.perf_counter() - t0) / max(args.steps, 1)
    print(f"{args.path}: {args.steps} steps at {ms:.2f} ms/step, max |u| "
          f"{float(torch.hypot(state.uVelocity, state.vVelocity).max()):.4f}"
          f" m/s, ice volume {total_volume(grid, state):.6e} m^3")


if __name__ == "__main__":
    main()
