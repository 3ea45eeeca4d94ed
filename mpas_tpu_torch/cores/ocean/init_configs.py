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

from mpas_tpu_torch.constants import omega, pii
from mpas_tpu_torch.containers import to_host
from mpas_tpu_torch.cores.ocean.config import OcnConfig
from mpas_tpu_torch.cores.ocean.core import (build_level_masks,
                                             equation_of_state)
from mpas_tpu_torch.cores.ocean.forcing import zero_forcing
from mpas_tpu_torch.cores.ocean.state import OcnGrid, OcnState
from mpas_tpu_torch.mesh.mesh import Mesh


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


def init_overflow(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """Dense plume on a slope (ref: mpas_ocn_init_overflow.F): cold water
    south of a front at y0 over the full depth. Channel mesh."""
    nC = mesh.nCells
    y = to_host(mesh.yCell)
    grid, h0 = _uniform_grid(mesh, nz, 2000.0, dtype)
    t_ambient, t_dense = 10.0, 1.0
    frontal_width = 0.1 * (y.max() - y.min())
    y0 = y.min() + 0.2 * (y.max() - y.min())
    frac = np.clip((y - y0) / frontal_width, 0.0, 1.0)
    T = (t_dense + (t_ambient - t_dense) * frac)[:, None] * np.ones((1, nz))
    S = np.full((nC, nz), 35.0)
    return grid, _state(mesh, nz, h0, np.stack([T, S], axis=-1), dtype)


def init_internal_waves(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """Internal-wave channel (ref: mpas_ocn_init_internal_waves.F): a
    mid-depth temperature interface raised in the channel centre."""
    bottom_depth = 500.0
    nC = mesh.nCells
    y = to_host(mesh.yCell)
    grid, h0 = _uniform_grid(mesh, nz, bottom_depth, dtype)
    z_mid = -(np.arange(nz) + 0.5) * bottom_depth / nz
    t_surf, t_bot = 20.1, 10.1
    interface0 = -0.5 * bottom_depth
    amplitude = 0.3 * bottom_depth
    yfrac = (y - y.min()) / (y.max() - y.min())
    interface = interface0 + amplitude * np.exp(-((yfrac - 0.5) / 0.15) ** 2)
    width = 0.1 * bottom_depth
    T = t_bot + (t_surf - t_bot) * 0.5 * (
        1.0 + np.tanh((z_mid[None, :] - interface[:, None]) / width))
    S = np.full((nC, nz), 35.0)
    return grid, _state(mesh, nz, h0, np.stack([T, S], axis=-1), dtype)


def init_cosine_bell(mesh: Mesh, nz: int = 3, dtype=np.float64):
    """Cosine-bell passive tracer (tracer 3) in solid-body zonal rotation
    on the sphere (ref: mpas_ocn_init_cosine_bell.F)."""
    if not mesh.on_sphere:
        raise ValueError("cosine_bell needs a spherical mesh")
    nC = mesh.nCells
    grid, h0 = _uniform_grid(mesh, nz, 300.0, dtype)
    lat, lon = to_host(mesh.latCell), to_host(mesh.lonCell)
    lat0, lon0 = 0.0, 3.0 * pii / 2.0
    radius = mesh.sphere_radius / 3.0
    r = mesh.sphere_radius * np.arccos(
        np.clip(np.sin(lat0) * np.sin(lat)
                + np.cos(lat0) * np.cos(lat) * np.cos(lon - lon0),
                -1.0, 1.0))
    psi = np.where(r < radius, 0.5 * (1.0 + np.cos(pii * r / radius)), 0.0)
    u0 = 2.0 * pii * mesh.sphere_radius / (24.0 * 86400.0)
    un = u0 * np.cos(to_host(mesh.latEdge)) * np.cos(to_host(mesh.angleEdge))
    u = np.broadcast_to(un[:, None], (mesh.nEdges, nz))
    T = np.full((nC, nz), 15.0)
    S = np.full((nC, nz), 35.0)
    bell = np.broadcast_to(psi[:, None], (nC, nz))
    return grid, _state(mesh, nz, h0, np.stack([T, S, bell], axis=-1),
                        dtype, u=u)


def init_lock_exchange(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """Lock exchange (ref: mpas_ocn_init_lock_exchange.F): cold water in
    the left half of a flat box, warm in the right."""
    nC = mesh.nCells
    x = to_host(mesh.xCell)
    grid, h0 = _uniform_grid(mesh, nz, 20.0, dtype)
    x_mid = 0.5 * (x.min() + x.max())
    T = np.where(x[:, None] < x_mid, 5.0, 30.0) * np.ones((1, nz))
    S = np.full((nC, nz), 35.0)
    return grid, _state(mesh, nz, h0, np.stack([T, S], -1), dtype)


def init_sea_mount(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """Stratified rest over a Gaussian seamount (ref:
    mpas_ocn_init_sea_mount.F), the pressure-gradient-error test."""
    max_depth = 5000.0
    nC = mesh.nCells
    x, y = to_host(mesh.xCell), to_host(mesh.yCell)
    x0, y0 = 0.5 * (x.min() + x.max()), 0.5 * (y.min() + y.max())
    width = 0.15 * (x.max() - x.min())
    depth = max_depth - 0.9 * max_depth * np.exp(
        -((x - x0) ** 2 + (y - y0) ** 2) / width ** 2)
    grid, h0 = _pbc_grid(mesh, nz, depth, max_depth, dtype,
                         coriolis=_constant_f(1e-4))
    T = 5.0 + 15.0 * np.exp(_z_mid(h0) / 1000.0)
    S = np.full((nC, nz), 35.0)
    return grid, _state(mesh, nz, h0, np.stack([T, S], -1), dtype)


def init_ziso(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """Zonally-periodic Idealized Southern Ocean (ref:
    mpas_ocn_init_ziso.F): beta-plane channel, shelf-slope bathymetry, a
    tanh thermocline (ref :388-389) and a sin^2 westerly wind. Returns
    (grid, state, forcing)."""
    max_depth, shelf_depth = 2500.0, 500.0
    nC = mesh.nCells
    y = to_host(mesh.yCell)
    ly = y.max() - y.min()
    y_rel = y - y.min()
    slope_center, slope_half = 0.25 * ly, 0.1 * ly
    depth = shelf_depth + 0.5 * (max_depth - shelf_depth) \
        * (1.0 + np.tanh((y_rel - slope_center) / slope_half))
    f0, beta = -1e-4, 1e-11
    grid, h0 = _pbc_grid(mesh, nz, depth, max_depth, dtype,
                         coriolis=lambda yy, lat: f0 + beta * (yy - y.min()))
    z_mid = _z_mid(h0)
    t1, t2, h1, mt = 6.0, 3.6, 300.0, 0.0
    T = t1 + t2 * np.tanh(z_mid / h1) + mt * z_mid
    S = np.full((nC, nz), 34.5)
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)
    tau = 0.2 * np.sin(pii * y_rel / ly) ** 2
    return grid, state, _forcing(nC, h0.dtype,
                                 windStressZonal=np.asarray(tau, dtype))


def init_soma(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """SOMA (ref: mpas_ocn_init_soma.F): a circular mid-latitude basin
    with a shelf rim (bowl factor 1 - r^2/W^2, ref :252-259), an
    exponential thermocline and a double-gyre zonal wind. Returns (grid,
    state, forcing)."""
    if not mesh.on_sphere:
        raise ValueError("soma needs a spherical mesh")
    mesh = _earth(mesh)
    bottom_depth, shelf_depth = 2500.0, 100.0
    lat_c, lon_c = 35.0 * pii / 180.0, pii
    domain_width = 1.25e6 / mesh.sphere_radius
    nC = mesh.nCells
    lat, lon = to_host(mesh.latCell), to_host(mesh.lonCell)
    dlat = lat - lat_c
    dlon = (lon - lon_c + pii) % (2.0 * pii) - pii
    dist = np.sqrt(dlat ** 2 + (np.cos(lat_c) * dlon) ** 2)
    factor = 1.0 - dist ** 2 / domain_width ** 2
    depth = shelf_depth + 0.5 * (bottom_depth - shelf_depth) \
        * (1.0 + np.tanh(8.0 * (factor - 0.2)))
    grid, h0 = _pbc_grid(mesh, nz, depth, bottom_depth, dtype,
                         coriolis=_planet_f)
    z_mid = _z_mid(h0)
    T = 20.0 + 13.0 * (np.exp(z_mid / 300.0) - 1.0)
    S = 34.0 - 2.0 * z_mid / bottom_depth
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)
    tau = 0.1 * np.cos(pii * (lat - lat_c) / (0.5 * domain_width)) \
        * (dist < domain_width)
    return grid, state, _forcing(nC, h0.dtype,
                                 windStressZonal=np.asarray(tau, dtype))


def _cavity_extras(draft, dtype):
    rho_i = 918.0
    return {"landIceDraft": _t(-draft, dtype),
            "landIcePressure": _t(rho_i * 9.80616 * draft, dtype)}


def init_isomip(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """ISOMIP ice-shelf cavity (ref: mpas_ocn_init_isomip.F): a cold
    cavity under a draft deepening poleward. Returns (grid, state,
    extras) with landIceDraft and landIcePressure."""
    bottom_depth = 900.0
    nC = mesh.nCells
    y = to_host(mesh.yCell)
    yfrac = (y - y.min()) / max(y.max() - y.min(), 1.0)
    draft = 700.0 - 500.0 * yfrac
    grid, h0 = _pbc_grid(mesh, nz, bottom_depth - draft, bottom_depth,
                         dtype, coriolis=_constant_f(-1.4e-4))
    T = np.full((nC, nz), -1.9)
    S = np.full((nC, nz), 34.5)
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)
    return grid, state, _cavity_extras(draft, dtype)


def init_sub_ice_shelf_2d(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """2-D sub-ice-shelf channel (ref: mpas_ocn_init_sub_ice_shelf_2D.F):
    a linear ice draft over half the channel. Returns (grid, state,
    extras)."""
    bottom_depth = 720.0
    nC = mesh.nCells
    y = to_host(mesh.yCell)
    yfrac = (y - y.min()) / max(y.max() - y.min(), 1.0)
    draft = np.where(yfrac < 0.5, 600.0 * (1.0 - 2.0 * yfrac), 0.0)
    grid, h0 = _pbc_grid(mesh, nz, bottom_depth - draft, bottom_depth,
                         dtype, coriolis=_constant_f(-1.4e-4))
    T = np.full((nC, nz), -1.5)
    S = np.full((nC, nz), 34.7)
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)
    return grid, state, _cavity_extras(draft, dtype)


def init_cvmix_wswsbf(mesh: Mesh, nz: int = 40, dtype=np.float64):
    """Wind stress with surface buoyancy forcing (ref:
    mpas_ocn_init_cvmix_WSwSBF.F): a uniformly stratified resting column
    under constant wind and surface cooling. Returns (grid, state,
    forcing)."""
    bottom_depth = 400.0
    nC = mesh.nCells
    grid, h0 = _uniform_grid(mesh, nz, bottom_depth, dtype, coriolis=1e-4)
    z_mid = -(np.arange(nz) + 0.5) * bottom_depth / nz
    T = (15.0 + 0.01 * z_mid)[None, :] * np.ones((nC, 1))
    S = np.full((nC, nz), 35.0)
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)
    return grid, state, _forcing(
        nC, h0.dtype, windStressZonal=np.full(nC, 0.1, dtype=dtype),
        sensibleHeatFlux=np.full(nC, -75.0, dtype=dtype))


def init_global_ocean_idealized(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """An aqua-planet stand-in for the real-data global_ocean (ref:
    mpas_ocn_init_global_ocean.F): analytic basins and an equatorial
    ridge, Levitus-like stratification, polar caps as 2-level columns,
    trade and westerly wind bands. Returns (grid, state, forcing)."""
    if not mesh.on_sphere:
        raise ValueError("global_ocean needs a spherical mesh")
    mesh = _earth(mesh)
    max_depth = 5000.0
    nC = mesh.nCells
    lat, lon = to_host(mesh.latCell), to_host(mesh.lonCell)
    depth = max_depth - 1500.0 * np.cos(2.0 * lon) ** 2 \
        * np.cos(lat) ** 2 - 800.0 * np.exp(-(lat / 0.15) ** 2)
    depth = np.where(np.abs(lat) > 80.0 * pii / 180.0,
                     2.0 * max_depth / nz, depth)
    grid, h0 = _pbc_grid(mesh, nz, depth, max_depth, dtype,
                         coriolis=_planet_f)
    z_mid = _z_mid(h0)
    T = 2.0 + 25.0 * np.exp(z_mid / 800.0) * np.cos(lat[:, None]) ** 2
    S = 34.7 + 0.7 * np.exp(z_mid / 1000.0)
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)
    tau = 0.1 * (np.cos(3.0 * lat) * np.cos(lat))
    return grid, state, _forcing(nC, h0.dtype,
                                 windStressZonal=np.asarray(tau, dtype))


def ssh_and_land_ice_pressure_balance(grid, state, ssh=None,
                                      land_ice_pressure=None,
                                      variable="landIcePressure",
                                      dtype=np.float64):
    """Balance land-ice pressure against SSH (ref:
    ocn_init_ssh_and_landIcePressure_balance,
    mpas_ocn_init_ssh_and_landIcePressure.F:107-420).

    variable='landIcePressure': landIcePressure = g rho_top (-ssh) with
    the JM density of the top layer; variable='ssh': the inverse. The live
    layers are scaled so that each column spans [-bottomDepth, ssh].
    Returns (state', ssh, landIcePressure), the last two numpy."""
    g = 9.80616
    h = to_host(state.layerThickness).astype(np.float64)
    tr = state.tracers.double().cpu()
    rho = to_host(equation_of_state(OcnConfig(config_eos_type="jm"),
                                    tr[..., 0], tr[..., 1]))
    rho_top = rho[:, 0]
    if variable == "ssh":
        if land_ice_pressure is None:
            raise ValueError("variable='ssh' needs land_ice_pressure")
        lip = np.asarray(_host(land_ice_pressure), dtype=np.float64)
        ssh = -lip / (g * np.maximum(rho_top, 1.0))
    else:
        if ssh is None:
            raise ValueError("variable='landIcePressure' needs ssh")
        ssh = np.asarray(_host(ssh), dtype=np.float64)
        lip = g * np.maximum(rho_top, 1.0) * (-ssh)
    bd = to_host(grid.bottomDepth).astype(np.float64)
    mlc = to_host(grid.maxLevelCell)
    live = np.arange(grid.nz)[None, :] < mlc[:, None]
    h_live = np.where(live, h, 0.0)
    col = np.sum(h_live, -1)
    scale = np.maximum(bd + ssh, 1e-2) / np.maximum(col, 1e-12)
    h_new = np.where(live, h_live * scale[:, None], h)
    state = dataclasses.replace(state, layerThickness=_t(h_new, dtype))
    return state, ssh.astype(dtype), lip.astype(dtype)


def init_isomip_plus(mesh: Mesh, nz: int = 30, dtype=np.float64,
                     warm: bool = True):
    """ISOMIP+ Ocean0-style cavity (ref: mpas_ocn_init_isomip_plus.F):
    linear-in-depth T/S, a draft ramp from the grounding line to the
    front at 60% of the domain, the ssh / landIcePressure balance, and
    far-field restoring at the open end. Returns (grid, state, extras)
    with landIceDraft, landIcePressure, restoringMask, restoringT and
    restoringS."""
    bottom_depth = 720.0
    nC = mesh.nCells
    y = to_host(mesh.yCell)
    yfrac = (y - y.min()) / max(y.max() - y.min(), 1.0)
    front = 0.6
    draft = np.where(yfrac < front, 640.0 * (1.0 - yfrac / front), 0.0)
    grid, h0 = _pbc_grid(mesh, nz, np.full(nC, bottom_depth), bottom_depth,
                         dtype, coriolis=_constant_f(-1.4e-4))
    if warm:
        top_t, bot_t, top_s, bot_s = -1.9, 1.0, 33.8, 34.7
    else:
        top_t, bot_t, top_s, bot_s = -1.9, -1.9, 33.8, 34.55
    frac = np.clip(-_z_mid(h0) / bottom_depth, 0.0, 1.0)
    T = (1.0 - frac) * top_t + frac * bot_t
    S = (1.0 - frac) * top_s + frac * bot_s
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)
    state, ssh, lip = ssh_and_land_ice_pressure_balance(
        grid, state, ssh=-draft, variable="landIcePressure", dtype=dtype)
    grid = dataclasses.replace(grid, surfacePressure=_t(lip))
    restoring = np.clip((yfrac - 0.9) / 0.1, 0.0, 1.0)
    extras = {"landIceDraft": _t(-draft, dtype), "landIcePressure": _t(lip),
              "restoringMask": _t(restoring, dtype),
              "restoringT": _t(T, dtype), "restoringS": _t(S, dtype)}
    return grid, state, extras


def init_periodic_planar(mesh: Mesh, nz: int = 10, dtype=np.float64,
                         velocity_strength: float = 1.0,
                         bottom_depth: float = 1000.0):
    """Doubly periodic planar debug configuration (ref:
    mpas_ocn_init_periodic_planar.F:77-361): uniform T/S and the
    divergence-free velocity of the vertex streamfunction
    psi = y * strength (a uniform +x flow)."""
    nC = mesh.nCells
    grid, h0 = _uniform_grid(mesh, nz, bottom_depth, dtype, coriolis=1e-4)
    T = np.full((nC, nz), 15.0)
    S = np.full((nC, nz), 35.0)
    psi_v = to_host(mesh.yVertex).astype(np.float64) * velocity_strength
    voe = to_host(mesh.verticesOnEdge)
    dv = to_host(mesh.dvEdge).astype(np.float64)
    # the periodic seam: a psi jump of more than half a period is a wrap
    dpsi = psi_v[voe[:, 1]] - psi_v[voe[:, 0]]
    if mesh.y_period > 0.0:
        p = mesh.y_period * velocity_strength
        dpsi = dpsi - p * np.round(dpsi / p)
    u_e = -(dpsi / np.maximum(dv, 1e-12))[:, None] * np.ones((1, nz))
    return grid, _state(mesh, nz, h0, np.stack([T, S], -1), dtype, u=u_e)


def ecosys_profiles(z_mid):
    """The 8 ecosys pools (bgc.EcosysParams order: NO3, SiO3, Fe, spN,
    diatN, zooN, detN, detSi) at layer mid-depths z_mid (negative down):
    nutrient-rich deep water and seed plankton in the euphotic zone."""
    zf = -z_mid
    eu = np.exp(z_mid / 30.0)
    return [1.0 + 30.0 * zf / (zf + 100.0), 2.0 + 60.0 * zf / (zf + 150.0),
            1e-4 + 5e-4 * zf / (zf + 200.0), 0.1 * eu, 0.1 * eu, 0.05 * eu,
            np.full(z_mid.shape, 1e-3), np.full(z_mid.shape, 1e-3)]


def init_ecosys_column(mesh: Mesh, nz: int = 30, dtype=np.float64):
    """Ecosystem column test (ref: mpas_ocn_init_ecosys_column.F, with the
    analytic equivalents of its file profiles): stratified T/S plus the 8
    ecosys pools of ecosys_profiles. Returns (grid, state)."""
    nC = mesh.nCells
    grid, h0 = _uniform_grid(mesh, nz, 300.0, dtype)
    z_mid = _z_mid(h0)
    T = 4.0 + 16.0 * np.exp(z_mid / 50.0)
    S = np.full((nC, nz), 34.5)
    tracers = np.stack([T, S] + ecosys_profiles(z_mid), axis=-1)
    return grid, _state(mesh, nz, h0, tracers, dtype)


def init_iso(mesh: Mesh, nz: int = 20, dtype=np.float64,
             ridge: bool = True, plateau: bool = True, shelf: bool = True,
             cont_slope: bool = True, embayment: bool = True,
             depression: bool = True):
    """ISO, the Idealized Southern Ocean (ref: mpas_ocn_init_iso.F +
    Registry_iso.xml): a circumpolar channel between 70S and 50S whose
    bathymetry composes the reference's feature flags (ridge, plateau,
    shelf, continental slope, embayment, depression), an exponential
    thermocline and a zonal jet over the channel. Returns (grid, state,
    forcing)."""
    if not mesh.on_sphere:
        raise ValueError("iso needs a spherical mesh")
    mesh = _earth(mesh)
    R = mesh.sphere_radius
    d2r = pii / 180.0
    lat, lon = to_host(mesh.latCell), to_host(mesh.lonCell)
    lat_s, lat_n = -70.0 * d2r, -50.0 * d2r
    main_depth = 4000.0
    depth = np.full(mesh.nCells, main_depth)

    def dlon_m(lon0_deg, at_lat):
        d = (lon - lon0_deg * d2r + pii) % (2.0 * pii) - pii
        return d * np.cos(at_lat) * R

    if ridge:           # Registry_iso.xml:22-32
        depth -= 2000.0 * np.exp(-(dlon_m(180.0, lat) / 1.0e6) ** 2)
    if plateau:         # Registry_iso.xml:38-56
        dx = dlon_m(300.0, -58.0 * d2r)
        dy = (lat - (-58.0 * d2r)) * R
        r = np.sqrt(dx ** 2 + dy ** 2)
        depth -= 2000.0 * 0.5 * (1.0 - np.tanh((r - 2.0e5) / 5.0e5))
    if embayment:
        dx = dlon_m(60.0, -71.0 * d2r)
        dy = (lat - (-71.0 * d2r)) * R
        emb = np.sqrt(dx ** 2 + dy ** 2) < 5.0e5
    else:
        emb = np.zeros_like(lat, dtype=bool)
    if shelf:
        ds = (lat - lat_s) * R
        on_shelf = (ds < 1.2e5) & ~emb
        depth = np.where(on_shelf, 500.0, depth)
        if cont_slope:
            slope_w = (main_depth - 500.0) / 0.01
            ramp = np.clip((ds - 1.2e5) / slope_w, 0.0, 1.0)
            depth = np.where(~on_shelf & ~emb,
                             np.minimum(depth, 500.0 + ramp
                                        * (main_depth - 500.0)), depth)
    if embayment:
        depth = np.where(emb, np.minimum(depth, 2000.0), depth)
    if depression:      # Registry_iso.xml:102-118
        dx = np.abs(dlon_m(60.0, -68.0 * d2r))
        band = (dx < 2.4e5) & (lat > -72.0 * d2r) & (lat < -65.0 * d2r)
        depth = np.where(band, depth + 800.0, depth)
    depth = np.clip(depth, 500.0, main_depth + 800.0)
    inside = (lat > lat_s) & (lat < lat_n)
    depth = np.where(inside, depth, 2.0 * (main_depth / nz))

    grid, h0 = _pbc_grid(mesh, nz, depth, main_depth + 800.0, dtype,
                         coriolis=_planet_f)
    z_mid = _z_mid(h0)
    T = 0.5 + 6.5 * np.exp(z_mid / 500.0)
    S = 34.0 + 0.6 * (1.0 - np.exp(z_mid / 800.0))
    state = _state(mesh, nz, h0, np.stack([T, S], -1), dtype)
    lat_c = 0.5 * (lat_s + lat_n)
    tau = 0.2 * np.cos(0.5 * pii * (lat - lat_c)
                       / (0.5 * (lat_n - lat_s))) ** 2 * inside
    return grid, state, _forcing(mesh.nCells, h0.dtype,
                                 windStressZonal=np.asarray(tau, dtype))
