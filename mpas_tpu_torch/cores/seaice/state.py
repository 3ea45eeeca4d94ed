"""Sea-ice grid, state and forcing containers (port of
mpas_tpu/cores/seaice/state.py).

ref: src/core_seaice/Registry.xml var_structs `icestate` (iceAreaCategory,
iceVolumeCategory, snowVolumeCategory, ...), `velocity_solver` (uVelocity,
vVelocity, stresses), `atmos_coupling`/`ocean_coupling` forcing fields.
Flat structs of tensors; the ITD category dimension is the trailing
dimension, so that the column physics runs over (nCells, nCat) at once.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from mpas_tpu_torch.containers import to_device, to_host
from mpas_tpu_torch.mesh.mesh import Mesh


@functools.cache
def const_tensor(values, device, dtype):
    """A constant table (a tuple, or a tuple of tuples) as a tensor on
    (device, dtype), copied there once: a copy from pageable host memory
    would wait for the device at every call."""
    return torch.as_tensor(np.asarray(values, dtype=np.float64),
                           dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class SeaiceGrid:
    mesh: Mesh
    # outward unit normal of each cell's edges in local (east, north)
    # coordinates: ref normalVectorPolygon (mpas_seaice_mesh.F:713)
    normalPolygonE: Any    # (nCells, maxEdges)
    normalPolygonN: Any    # (nCells, maxEdges)
    # outward unit normal of each vertex dual-triangle side:
    # ref normalVectorTriangle (mpas_seaice_mesh.F:714)
    normalTriangleE: Any   # (nVertices, vertexDegree)
    normalTriangleN: Any   # (nVertices, vertexDegree)
    # metric-term latitudes (zeros on planar meshes)
    tanLatCellOverR: Any   # (nCells,)
    tanLatVertexOverR: Any  # (nVertices,)
    # interior-vertex mask (0 at domain-boundary vertices: no-slip walls)
    interiorVertex: Any    # (nVertices,)
    # Wachspress/PWL basis tensors of the variational scheme (None =
    # weak only)
    variational: Any = None
    # global minimum edge length, for the revised-EVP numerical inertia
    # coefficient (ref: seaice_init_evp's dvEdgeMinGlobal dmpar_min,
    # mpas_seaice_velocity_solver_constitutive_relation.F:104-131)
    dvEdgeMin: Any = None

    def to(self, device, dtype) -> "SeaiceGrid":
        return to_device(self, device, dtype)


@dataclasses.dataclass(frozen=True)
class SeaiceState:
    # ice-thickness-distribution state, per cell per category
    iceAreaCategory: Any      # (nCells, nCat) fractional area
    iceVolumeCategory: Any    # (nCells, nCat) m (volume per unit cell area)
    snowVolumeCategory: Any   # (nCells, nCat) m
    surfaceTemperature: Any   # (nCells, nCat) deg C
    # dynamics state at vertices
    uVelocity: Any            # (nVertices,)
    vVelocity: Any            # (nVertices,)
    # persisted EVP stresses at cells (weak scheme), ref stress11/22/12var
    stress11: Any             # (nCells,)
    stress22: Any             # (nCells,)
    stress12: Any             # (nCells,)
    # multilayer thermodynamics (None in zero-layer mode): per-layer
    # enthalpies, J/m3 (ref iceEnthalpy/snowEnthalpy tracers)
    iceEnthalpy: Any = None   # (nCells, nCat, nIceLayers)
    snowEnthalpy: Any = None  # (nCells, nCat, nSnowLayers)
    # melt-pond tracers (ref pondArea/pondDepth/pondLidThickness)
    pondArea: Any = None      # (nCells, nCat) pond fraction
    pondDepth: Any = None     # (nCells, nCat) m
    pondLid: Any = None       # (nCells, nCat) refrozen lid, m (lvl only)
    # level-ice tracers fed by ridging (ref alvl/vlvl)
    levelIceArea: Any = None  # (nCells, nCat) level fraction of area
    levelIceVolume: Any = None
    # age / first-year tracers (ice_age.F90, ice_firstyear.F90)
    iceAge: Any = None        # (nCells, nCat) seconds
    firstYearArea: Any = None
    # BGC (ice_brine.F90 / ice_algae.F90)
    brineHeight: Any = None   # (nCells, nCat) m from the ice bottom
    # prognostic per-layer bulk salinity (ice_zsalinity.F90 /
    # ice_therm_mushy.F90)
    iceSalinity: Any = None   # (nCells, nCat, nIceLayers) psu
    algaeIce: Any = None      # (nCells, nCat) mmol N/m2 skeletal layer
    nitrateIce: Any = None
    silicateIce: Any = None
    # snow metamorphism (grain radius m, effective density kg/m3)
    snowGrainRadius: Any = None
    snowDensity: Any = None

    def to(self, device, dtype) -> "SeaiceState":
        return to_device(self, device, dtype)


@dataclasses.dataclass(frozen=True)
class SeaiceForcing:
    # atmosphere (at cells)
    uAirVelocity: Any         # (nCells,)
    vAirVelocity: Any         # (nCells,)
    airTemperature: Any       # (nCells,) deg C
    shortwaveDown: Any        # (nCells,) W/m2
    longwaveDown: Any         # (nCells,) W/m2
    # ocean (at cells)
    uOceanVelocity: Any       # (nCells,)
    vOceanVelocity: Any       # (nCells,)
    seaSurfaceTemperature: Any  # (nCells,) deg C
    oceanHeatFlux: Any        # (nCells,) W/m2 into the ice bottom
    # sea-surface tilt force at vertices, grad(ssh) premultiplied by -g
    # (ref surface_tilt_* mpas_seaice_velocity_solver.F:1819)
    sshGradientU: Any         # (nVertices,)
    sshGradientV: Any         # (nVertices,)
    # precipitation (ref rainfallRate/snowfallRate)
    rainfallRate: Any = None  # (nCells,) kg/m2/s
    snowfallRate: Any = None  # (nCells,) m/s of snow depth
    # aerosol deposition (nCells, nSpecies) kg/m2/s; None = no aerosols
    aerosolDeposition: Any = None

    def to(self, device, dtype) -> "SeaiceForcing":
        return to_device(self, device, dtype)


def make_grid(mesh: Mesh, variational=False) -> SeaiceGrid:
    """The weak-scheme geometry, built on the host once; the grid's
    tensors lie on the mesh's device in its dtype. `variational` True
    (Wachspress) or "pwl"/"wachspress" adds the variational basis tensors.

    ref: seaice_init_velocity_solver_weak
    (mpas_seaice_velocity_solver_weak.F:49) builds normalVectorPolygon /
    normalVectorTriangle; here both come from angleEdge:
      n_e = (cos a, sin a)  (edge normal, cell1 -> cell2)
      t_e = k x n_e = (-sin a, cos a)  (vertex1 -> vertex2)
      polygon outward normal  = edgeSignOnCell * n_e
      triangle outward normal = -edgeSignOnVertex * t_e
    """
    m = mesh
    ang = to_host(m.angleEdge).astype(np.float64)
    ne = np.cos(ang)
    nn = np.sin(ang)
    te = -nn
    tn = ne

    eoc = to_host(m.edgesOnCell)
    sgc = to_host(m.edgeSignOnCell).astype(ne.dtype)
    polyE = sgc * ne[eoc]
    polyN = sgc * nn[eoc]

    eov = to_host(m.edgesOnVertex)
    sgv_raw = to_host(m.edgeSignOnVertex)
    sgv = sgv_raw.astype(ne.dtype)
    triE = -sgv * te[eov]
    triN = -sgv * tn[eov]

    if m.on_sphere:
        tlc = np.tan(to_host(m.latCell)) / m.sphere_radius
        tlv = np.tan(to_host(m.latVertex)) / m.sphere_radius
    else:
        tlc = np.zeros(m.nCells)
        tlv = np.zeros(m.nVertices)

    # a vertex is interior iff none of its edges is a boundary edge and it
    # has a full complement of distinct cells
    bnd_e = to_host(m.boundaryEdge) > 0
    interior = ~np.any(bnd_e[eov] | (sgv_raw == 0), axis=1)

    var_coeffs = None
    if variational:
        from mpas_tpu_torch.cores.seaice.variational import (
            build_variational_coeffs)
        var_coeffs = build_variational_coeffs(
            mesh, basis=variational if isinstance(variational, str)
            else "wachspress")
    dv = to_host(m.dvEdge)
    device, dtype = m.xCell.device, m.xCell.dtype

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return SeaiceGrid(
        mesh=mesh, normalPolygonE=t(polyE), normalPolygonN=t(polyN),
        normalTriangleE=t(triE), normalTriangleN=t(triN),
        tanLatCellOverR=t(tlc), tanLatVertexOverR=t(tlv),
        interiorVertex=t(interior.astype(ne.dtype)),
        variational=var_coeffs, dvEdgeMin=t(float(np.min(dv[dv > 0]))))


def zero_state(mesh: Mesh, n_cat: int, dtype=torch.float64,
               device=None) -> SeaiceState:
    """The nine required fields at zero, on `device` (the mesh's when
    None)."""
    device = mesh.xCell.device if device is None else device
    nC, nV = mesh.nCells, mesh.nVertices
    zc = torch.zeros((nC, n_cat), dtype=dtype, device=device)
    zv = torch.zeros((nV,), dtype=dtype, device=device)
    z1 = torch.zeros((nC,), dtype=dtype, device=device)
    return SeaiceState(iceAreaCategory=zc, iceVolumeCategory=zc,
                       snowVolumeCategory=zc, surfaceTemperature=zc,
                       uVelocity=zv, vVelocity=zv,
                       stress11=z1, stress22=z1, stress12=z1)
