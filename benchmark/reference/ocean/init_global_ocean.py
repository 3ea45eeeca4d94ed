# Frozen copy of mpas_tpu_torch/cores/ocean/init_global_ocean.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
# load_dataset_netcdf is left out: the benchmark makes its dataset.
"""Real-data global-ocean initialisation: gridded T/S/topography onto a
mesh (port of mpas_tpu/cores/ocean/init_global_ocean.py).

ref: src/core_ocean/mode_init/mpas_ocn_init_global_ocean.F (1-3338): the
reference interpolates observed lat/lon/depth temperature and salinity
climatologies and gridded topography onto an MPAS mesh: horizontal
interpolation of topography and tracers, depth-level to layer vertical
interpolation with below-data extrapolation, a minimum ocean depth, land
detection, and wind-stress interpolation. A WOA/ETOPO file loads through
io.netcdf.read_netcdf (netCDF-3 or netCDF4) into the dataset dict;
synthetic_woa_dataset() makes one of the same form.

Host numpy, as the reference; the result holds CPU tensors (move it with
.to(device, dtype)).

Dataset dict (all numpy):
  lat (nlat,) radians ascending; lon (nlon,) radians [0, 2pi) ascending
  depth (ndep,) positive metres, ascending
  temperature/salinity (ndep, nlat, nlon)
  topography (nlat, nlon)  negative = ocean floor elevation (ETOPO sign)
  windstress_zonal (nlat, nlon), tidal_energy_flux (nlat, nlon) optional
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.containers import to_host
from benchmark.reference.ocean.init_configs import (_earth, _forcing,
                                                     _pbc_grid, _planet_f,
                                                     _state, _t)
from benchmark.reference.mesh.mesh import Mesh


def synthetic_woa_dataset(nlat=60, nlon=120, ndep=30):
    """A WOA/ETOPO-shaped synthetic dataset: Levitus-like stratification,
    a meridional SST gradient, basins with shelves, a mid-ocean ridge and
    two continents; the shapes and conventions of a real file's."""
    lat = np.linspace(-np.pi / 2 + 0.01, np.pi / 2 - 0.01, nlat)
    lon = np.linspace(0.0, 2.0 * np.pi, nlon, endpoint=False)
    depth = np.linspace(5.0, 5300.0, ndep)
    LA, LO = np.meshgrid(lat, lon, indexing="ij")
    topo = -5200.0 + 1200.0 * np.cos(2 * LO) ** 2 * np.cos(LA) ** 2 \
        + 900.0 * np.exp(-((LO - np.pi) / 0.15) ** 2)
    topo = np.where((np.abs(LO - 0.6) < 0.25)
                    | (np.abs(LO - 3.8) < 0.3), 300.0, topo)
    z = depth[:, None, None]
    sst = 28.0 * np.cos(LA) ** 2 - 1.0
    T = 2.0 + (sst[None] - 2.0) * np.exp(-z / 800.0)
    S = 34.7 + 0.8 * np.exp(-z / 1000.0) * np.cos(LA)[None] \
        + 0.2 * np.sin(LA[None]) ** 2
    tau = 0.1 * np.cos(3.0 * LA) * np.cos(LA)
    tidal = 2.0e-3 * np.exp(-((LO - np.pi) / 0.2) ** 2) + 2.0e-4
    return {"lat": lat, "lon": lon, "depth": depth,
            "temperature": T, "salinity": S, "topography": topo,
            "windstress_zonal": tau, "tidal_energy_flux": tidal}


def _bilinear(lat_g, lon_g, field, lat_q, lon_q):
    """Bilinear interpolation of field(..., nlat, nlon) at query points,
    periodic in lon."""
    nlat, nlon = field.shape[-2], field.shape[-1]
    i = np.clip(np.searchsorted(lat_g, lat_q) - 1, 0, nlat - 2)
    wy = np.clip((lat_q - lat_g[i]) / (lat_g[i + 1] - lat_g[i]), 0.0, 1.0)
    dlon = lon_g[1] - lon_g[0]
    j = np.floor((lon_q - lon_g[0]) / dlon).astype(np.int64) % nlon
    jp = (j + 1) % nlon
    wx = np.clip((np.mod(lon_q - lon_g[j], 2.0 * np.pi)) / dlon, 0.0, 1.0)
    f00 = field[..., i, j]
    f01 = field[..., i, jp]
    f10 = field[..., i + 1, j]
    f11 = field[..., i + 1, jp]
    return ((1 - wy) * ((1 - wx) * f00 + wx * f01)
            + wy * ((1 - wx) * f10 + wx * f11))


def init_global_ocean(mesh: Mesh, dataset: dict, nz: int = 40,
                      max_depth: float | None = None,
                      min_ocean_depth: float = 30.0,
                      smoothing_passes: int = 1,
                      dtype=np.float64):
    """The interpolating global-ocean initialisation (module docstring).
    Returns (grid, state, forcing). Land cells (topography above
    -min_ocean_depth) get inert 2-level columns through the level masks
    (ref: the topography and minimum-depth blocks)."""
    if not mesh.on_sphere:
        raise ValueError("global ocean requires a spherical mesh")
    mesh = _earth(mesh)
    lat = to_host(mesh.latCell)
    lon = np.mod(to_host(mesh.lonCell), 2.0 * np.pi)

    def interp(key):
        return _bilinear(dataset["lat"], dataset["lon"], dataset[key], lat,
                         lon)

    # topography -> bottomDepth, smoothed over cell neighbours (ref:
    # config_global_ocean_topography_smoothing)
    topo = interp("topography")
    coc = to_host(mesh.cellsOnCell)
    valid = np.arange(mesh.maxEdges)[None, :] \
        < to_host(mesh.nEdgesOnCell)[:, None]
    for _ in range(smoothing_passes):
        nb = np.where(valid, topo[np.maximum(coc, 0)], 0.0)
        topo = 0.5 * topo + 0.5 * nb.sum(1) / np.maximum(valid.sum(1), 1)
    depth = -topo
    land = depth < min_ocean_depth
    if max_depth is None:
        max_depth = float(np.max(dataset["depth"]))
    depth = np.clip(depth, min_ocean_depth, max_depth)
    grid, h0 = _pbc_grid(mesh, nz, np.where(land, 0.0, depth), max_depth,
                         dtype, coriolis=_planet_f)

    # T/S: horizontal interpolation at each data level, then linear in
    # depth to the layer mid-depths, nearest beyond the data
    ddep = np.asarray(dataset["depth"])
    Tq, Sq = interp("temperature"), interp("salinity")   # (ndep, nC)
    z_mid = np.cumsum(h0, -1) - 0.5 * h0                 # positive down
    T = np.empty_like(z_mid)
    S = np.empty_like(z_mid)
    cols = np.arange(mesh.nCells)
    for k in range(nz):
        zk = z_mid[:, k]
        i = np.clip(np.searchsorted(ddep, zk) - 1, 0, len(ddep) - 2)
        w = np.clip((zk - ddep[i]) / (ddep[i + 1] - ddep[i]), 0.0, 1.0)
        T[:, k] = (1 - w) * Tq[i, cols] + w * Tq[i + 1, cols]
        S[:, k] = (1 - w) * Sq[i, cols] + w * Sq[i + 1, cols]
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)

    if "tidal_energy_flux" in dataset:
        grid = dataclasses.replace(grid, tidalEnergyFlux=_t(
            np.where(land, 0.0, interp("tidal_energy_flux")), dtype))
    wind = {}
    if "windstress_zonal" in dataset:
        wind["windStressZonal"] = np.asarray(interp("windstress_zonal"),
                                             dtype)
    return grid, state, _forcing(mesh.nCells, dtype, **wind)
