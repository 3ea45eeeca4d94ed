# Frozen copy of mpas_tpu_torch/cores/ocean/init_configs.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
# Only the helpers of init_global_ocean and ecosys_profiles are kept.
"""The idealized ocean init-mode configurations (port of
mpas_tpu/cores/ocean/init_configs.py).

ref: src/core_ocean/mode_init/ — the reference generates its idealized
configurations in-model (mpas_ocn_init_<name>.F, each with its own
Registry block): overflow, internal_waves, cosine_bell, lock_exchange,
sea_mount, ziso, soma, isomip, sub_ice_shelf_2D, cvmix_WSwSBF, an
idealized global_ocean, isomip_plus (with the ssh / land-ice pressure
balance), periodic_planar, ecosys_column and iso.

Host numpy, bit for bit the reference; every function returns CPU
tensors (move them with .to(device, dtype)). Land and bathymetry are
handled by maxLevelCell and the level masks, with a partial bottom cell
(_pbc_grid).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.constants import omega, pii
from benchmark.reference.containers import to_host
from benchmark.reference.ocean.config import OcnConfig
from benchmark.reference.ocean.core import (build_level_masks,
                                             equation_of_state)
from benchmark.reference.ocean.forcing import zero_forcing
from benchmark.reference.ocean.state import OcnGrid, OcnState
from benchmark.reference.mesh.mesh import Mesh


def _t(a, dtype=None):
    """A host array as a CPU tensor (cast to `dtype` where given)."""
    a = np.asarray(a) if dtype is None else np.asarray(a, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a))


def _host(x):
    """A tensor's values as numpy; anything else as it is."""
    return to_host(x) if isinstance(x, torch.Tensor) else x


def _earth(mesh: Mesh) -> Mesh:
    """A unit-sphere mesh scaled to the Earth's radius (6,371 km)."""
    return mesh.scaled(6.371e6) if mesh.sphere_radius < 1e6 else mesh


def _torch_dtype(dtype):
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _forcing(n_cells, dtype, **fields):
    """zero_forcing in `dtype` (numpy) with the named (nCells,) fields
    set."""
    f = zero_forcing(n_cells, dtype=_torch_dtype(dtype))
    return dataclasses.replace(f, **{k: _t(v) for k, v in fields.items()})


def _uniform_grid(mesh, nz, bottom_depth, dtype, coriolis=0.0):
    nC = mesh.nCells
    h0 = np.full((nC, nz), bottom_depth / nz)
    dtypec = to_host(mesh.areaCell).dtype
    mesh = dataclasses.replace(
        mesh, fEdge=_t(np.full(mesh.nEdges, coriolis, dtype=dtypec)),
        fVertex=_t(np.full(mesh.nVertices, coriolis, dtype=dtypec)),
        fCell=_t(np.full(mesh.nCells, coriolis, dtype=dtypec)))
    grid = OcnGrid(mesh=mesh, restingThickness=_t(h0, dtype),
                   bottomDepth=_t(np.full(nC, bottom_depth, dtype=dtype)),
                   maxLevelCell=_t(np.full(nC, nz, dtype=np.int32)), nz=nz)
    return grid, h0


def _pbc_grid(mesh, nz, bottom_depth_cell, max_depth, dtype, coriolis=None,
              min_pbc_fraction=0.25):
    """z-level grid with partial bottom cells over variable bathymetry
    (ref: ocn_init_vertical_grids + config_min_pbc_fraction): uniform
    refBottomDepth, maxLevelCell from the local depth (at least 2), the
    bottom layer partial, dead levels at epsilon thickness and excluded
    by the level masks. coriolis(y, lat) gives f at each location."""
    nC = mesh.nCells
    dz = max_depth / nz
    depth = np.clip(np.asarray(bottom_depth_cell, dtype=np.float64),
                    2.0 * dz, max_depth)
    mlc = np.minimum(np.ceil(depth / dz - 1e-9).astype(np.int64), nz)
    mlc = np.maximum(mlc, 2)
    k = np.arange(nz)
    h0 = np.full((nC, nz), dz)
    bottom_partial = np.maximum(depth - (mlc - 1) * dz,
                                min_pbc_fraction * dz)
    h0 = np.where(k[None, :] == (mlc - 1)[:, None],
                  bottom_partial[:, None], h0)
    eps = 1e-3 * dz
    h0 = np.where(k[None, :] >= mlc[:, None], eps, h0)
    depth_actual = np.sum(np.where(k[None, :] < mlc[:, None], h0, 0.0), -1)

    dtypec = to_host(mesh.areaCell).dtype
    if coriolis is not None:
        def f(y, lat):
            return _t(coriolis(to_host(y), to_host(lat)), dtypec)
        mesh = dataclasses.replace(
            mesh, fEdge=f(mesh.yEdge, mesh.latEdge),
            fVertex=f(mesh.yVertex, mesh.latVertex),
            fCell=f(mesh.yCell, mesh.latCell))
    cmask, emask = build_level_masks(mesh, mlc, nz, dtype)
    grid = OcnGrid(mesh=mesh, restingThickness=_t(h0, dtype),
                   bottomDepth=_t(depth_actual, dtype),
                   maxLevelCell=_t(mlc, np.int32), nz=nz,
                   cellMask=cmask, edgeMask=emask)
    return grid, h0


def _state(mesh, nz, h0, tracers, dtype, u=None):
    if u is None:
        u = np.zeros((mesh.nEdges, nz))
    return OcnState(ubtr=_t(np.zeros(mesh.nEdges, dtype=dtype)),
                    u=_t(u, dtype), layerThickness=_t(h0, dtype),
                    tracers=_t(tracers, dtype))


def _z_mid(h0):
    """Layer mid-depths, negative down."""
    return -np.cumsum(h0, -1) + 0.5 * h0


def _constant_f(value):
    return lambda yy, lat: np.full_like(yy, value)


def _planet_f(yy, lat):
    return 2.0 * omega * np.sin(lat)


def ecosys_profiles(z_mid):
    """The 8 ecosys pools (bgc.EcosysParams order: NO3, SiO3, Fe, spN,
    diatN, zooN, detN, detSi) at layer mid-depths z_mid (negative down):
    nutrient-rich deep water and seed plankton in the euphotic zone."""
    zf = -z_mid
    eu = np.exp(z_mid / 30.0)
    return [1.0 + 30.0 * zf / (zf + 100.0), 2.0 + 60.0 * zf / (zf + 150.0),
            1e-4 + 5e-4 * zf / (zf + 200.0), 0.1 * eu, 0.1 * eu, 0.05 * eu,
            np.full(z_mid.shape, 1e-3), np.full(z_mid.shape, 1e-3)]
