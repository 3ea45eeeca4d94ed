"""ocean_global_120km: the global ocean as MPAS-Ocean runs it, and a probe
of the largest stable split-explicit dt for it.

    python -m mpas_tpu_torch.tools.ocean_global                # cuda:0
    python -m mpas_tpu_torch.tools.ocean_global --device cpu --steps 3

The path: init_global_ocean on icosahedral_mesh(64, 4) (40,962 cells,
~120 km) from synthetic_woa_dataset(180, 360, 102) (WOA's 1-degree
grid and 102 standard depths) at nz layers (60: E3SM's global meshes),
land as the reference's 2-level columns, the init's wind stress as the
surface forcing; tracers T, S, the 8 ecosys pools of
init_configs.ecosys_profiles at index 2, DIC and ALK at 10 and 11. A step
is split_step (dt PATH_DT, config_btr_dt 60 s) through run_steps with
the forcing,
then ecosys_step under 250 max(cos lat, 0) W/m2 of shortwave, then
carbon_step with the state's SST and SSS and a 7 m/s wind (the
reference's operator split, tests/test_ocean_ecosys_inits.py:67-76).
Analysis (every member of available_members() through an
AnalysisDriver) and four ParticleTrackers, one per vertical treatment,
one particle at the centre of each ocean cell, ride along.
chip_smoke.py (phase 5) and tests/test_torch_ocean_global_slice.py build
the path from these functions.

Run as a script, it takes `--steps` (3) float64 steps (dynamics + BGC)
at the path's full size at each dt of DT_CANDIDATES on the device and
prints, per dt, max |u|
after each step and where the last one sits, whether every field stayed
finite and the volume drift, then one JSON line with the largest dt that
stayed finite with max |u| < 5 m/s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from mpas_tpu_torch.containers import resolve_device, to_host
from mpas_tpu_torch.cores.ocean import bgc as ocean_bgc
from mpas_tpu_torch.cores.ocean.analysis import (AnalysisDriver,
                                                 available_members)
from mpas_tpu_torch.cores.ocean.analysis.particles import ParticleTracker
from mpas_tpu_torch.cores.ocean.config import OcnConfig
from mpas_tpu_torch.cores.ocean.core import (equation_of_state, run_steps,
                                             thickness_tendency)
from mpas_tpu_torch.cores.ocean.init_configs import ecosys_profiles
from mpas_tpu_torch.cores.ocean.init_global_ocean import (
    init_global_ocean, synthetic_woa_dataset)
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs

N_SUBDIV, NZ = 64, 60        # 40,962 cells; E3SM's global meshes' layers
DT_CANDIDATES = (1800.0, 900.0, 600.0)
# the path's dt: the largest of DT_CANDIDATES that this probe found stable
# over 11 float64 steps at full size (1,800 s turns non-finite at step 6)
PATH_DT = 900.0
BTR_DT = 60.0                 # barotropic Courant ~0.11 at 228 m/s, 120 km
ECOSYS_INDEX0, DIC_INDEX, ALK_INDEX = 2, 10, 11
DIC, ALK = 2.0e-3, 2.3e-3     # mol/kg: tests/test_ocean_fidelity.py:183-196
SW_PEAK = 250.0               # W/m2 at the equator
WIND10 = 7.0                  # m/s
MAX_U = 5.0                   # m/s: the stability bound of the probe
VERTICAL_MODES = ("indexLevel", "fixedZLevel", "passiveFloat", "isopycnal")
PARTICLE_LAYER = 1            # indexLevel's layer
PARTICLE_DEPTH = 100.0        # fixedZLevel's and passiveFloat's start (m)
ISOPYCNAL_LAYER = 5           # the layer whose t=0 density is the target


def woa_dataset():
    """WOA's 1-degree grid and its 102 standard depth levels."""
    return synthetic_woa_dataset(nlat=180, nlon=360, ndep=102)


def setup(mesh, nz, dataset=None):
    """(cfg, grid, state, forcing) of the path, CPU tensors in float64:
    init_global_ocean plus the 8 ecosys pools, DIC and ALK."""
    grid, state, forcing = init_global_ocean(
        mesh, woa_dataset() if dataset is None else dataset, nz=nz)
    h = to_host(state.layerThickness)
    z_mid = -np.cumsum(h, -1) + 0.5 * h
    extra = ecosys_profiles(z_mid) + [np.full(z_mid.shape, DIC),
                                      np.full(z_mid.shape, ALK)]
    tracers = torch.cat([state.tracers, torch.from_numpy(
        np.stack(extra, -1))], -1)
    cfg = OcnConfig(config_dt=PATH_DT, config_btr_dt=BTR_DT)
    return cfg, grid, dataclasses.replace(state, tracers=tracers), forcing


def ocean_cells(grid):
    """Indices of the ocean cells: init_global_ocean zeroes the tidal
    energy flux over land and the dataset's is positive elsewhere."""
    return torch.nonzero(grid.tidalEnergyFlux > 0)[:, 0]


def shortwave(grid):
    """250 max(cos lat, 0) W/m2 at the surface."""
    return SW_PEAK * torch.clamp(torch.cos(grid.mesh.latCell), min=0.0)


def dynamics(grid, cfg, state, forcing):
    """One split-explicit step with the surface forcing."""
    return run_steps(grid, cfg, state, 1, forcing)


def bgc(grid, state, dt, sw):
    """ecosys_step, then carbon_step with the state's SST and SSS."""
    state = ocean_bgc.ecosys_step(state, grid, dt, sw,
                                  index0=ECOSYS_INDEX0)
    wind = torch.full_like(sw, WIND10)
    state, _ = ocean_bgc.carbon_step(state, grid, dt, state.tracers[:, 0, 0],
                                     state.tracers[:, 0, 1], wind, DIC_INDEX,
                                     ALK_INDEX)
    return state


def analysis_driver(grid, cfg, interval):
    """An initialised AnalysisDriver of every member at `interval` s."""
    driver = AnalysisDriver({n: interval for n in available_members()})
    driver.init(grid, cfg)
    return driver


def analysis(driver, grid, cfg, state, t_seconds, forcing):
    driver.compute_due(grid, cfg, state, t_seconds, forcing=forcing)


def trackers(grid, cfg, state, coeffs=None):
    """One ParticleTracker per vertical treatment, one particle at the
    centre of each ocean cell (which starts the walk), on the grid's
    device and dtype; the isopycnal target is each cell's t=0 density at
    ISOPYCNAL_LAYER."""
    m = grid.mesh
    cells = ocean_cells(grid)
    if coeffs is None:
        coeffs = build_reconstruct_coeffs(m)
    rho = equation_of_state(cfg, state.tracers[..., 0],
                            state.tracers[..., 1])
    depth = torch.full(cells.shape, PARTICLE_DEPTH, dtype=m.xCell.dtype,
                       device=cells.device)
    extra = {"indexLevel": {}, "fixedZLevel": {"depth": depth},
             "passiveFloat": {"depth": depth},
             "isopycnal": {"target_rho": rho[cells, ISOPYCNAL_LAYER]}}
    return [ParticleTracker(m, m.xCell[cells], m.yCell[cells],
                            layer=PARTICLE_LAYER, z0=m.zCell[cells],
                            vertical_mode=mode, coeffs=coeffs, cell0=cells,
                            **extra[mode]) for mode in VERTICAL_MODES]


def vertical_transport(grid, state):
    """w_top (nCells, nz + 1) of the state's masked thickness flux."""
    c1, c2 = grid.mesh.cellsOnEdge[:, 0], grid.mesh.cellsOnEdge[:, 1]
    h = state.layerThickness
    uh = state.u * 0.5 * (h[c1] + h[c2])
    if grid.edgeMask is not None:
        uh = uh * grid.edgeMask
    return thickness_tendency(grid, uh)[2]


def particles(tracker_list, grid, cfg, state, dt):
    """One RK2 step of every tracker in the state's flow, the cell-centre
    velocity reconstructed once for all of them."""
    rho = equation_of_state(cfg, state.tracers[..., 0],
                            state.tracers[..., 1])
    w = vertical_transport(grid, state)
    uv = tracker_list[0].cell_velocity(state.u)
    for tr in tracker_list:
        tr.step(state.u, dt, layer_thickness=state.layerThickness,
                w_vert=w, density=rho, cell_velocity=uv)


def volume(grid, state):
    """Ocean volume, sum of area h over the active levels, in float64."""
    h = state.layerThickness.double()
    if grid.cellMask is not None:
        h = h * grid.cellMask.double()
    return float((h * grid.mesh.areaCell.double()[:, None]).sum())


def probe(steps=3, device=None):
    """3 float64 steps (dynamics + BGC) at each dt; returns one dict per
    dt and prints a line for each."""
    device = resolve_device(device)
    f64 = torch.float64
    t0 = time.perf_counter()
    mesh = icosahedral_mesh(N_SUBDIV, 4)
    cfg, grid, state0, forcing = setup(mesh, NZ)
    print(f"mesh and init: {mesh.nCells} cells x {NZ} levels in "
          f"{time.perf_counter() - t0:.1f} s")
    grid, state0, forcing = (grid.to(device, f64), state0.to(device, f64),
                             forcing.to(device, f64))
    sw = shortwave(grid)
    vol0 = volume(grid, state0)
    out = []
    for dt in DT_CANDIDATES:
        cfg = dataclasses.replace(cfg, config_dt=dt)
        state = state0
        umax = []
        for _ in range(steps):
            state = bgc(grid, dynamics(grid, cfg, state, forcing), dt, sw)
            umax.append(float(state.u.abs().max()))
        e, k = divmod(int(state.u.abs().argmax()), NZ)
        c = grid.mesh.cellsOnEdge[e]
        where = (f"edge {e} layer {k} at lat "
                 f"{float(grid.mesh.latEdge[e]) * 57.29578:.1f}, its cells' "
                 f"maxLevelCell {grid.maxLevelCell[c].tolist()}")
        finite = all(bool(torch.isfinite(getattr(state, k)).all())
                     for k in ("u", "layerThickness", "tracers", "ubtr"))
        rec = dict(dt=dt, max_u=umax, finite=finite,
                   volume_drift=abs(volume(grid, state) - vol0) / vol0)
        print(f"dt {dt:g} s: max |u| per step {umax}, finite {finite}, "
              f"volume drift {rec['volume_drift']:.3e}; the last max at "
              f"{where}")
        out.append(rec)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default cuda:0)")
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    recs = probe(args.steps, args.device)
    stable = [r["dt"] for r in recs
              if r["finite"] and max(r["max_u"]) < MAX_U]
    print(json.dumps({"largest_stable_dt": max(stable) if stable else None,
                      "runs": recs}))


if __name__ == "__main__":
    main()
