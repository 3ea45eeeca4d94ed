"""Baroclinic channel initial condition (port of
mpas_tpu/cores/ocean/init_channel.py).

ref: src/core_ocean/mode_init/mpas_ocn_init_baroclinic_channel.F:198-300:
a stratified channel with a meandering temperature front and a localized
perturbation that triggers baroclinic eddies (the compass
baroclinic_channel test group). Host numpy, bit for bit the reference;
the result holds CPU tensors (move it with .to(device, dtype)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.constants import pii
from mpas_tpu_torch.cores.ocean.state import OcnGrid, OcnState
from mpas_tpu_torch.mesh.mesh import Mesh

# defaults (ref: Registry.xml baroclinic_channel config block)
BOTTOM_DEPTH = 1000.0
SURFACE_T = 13.1
BOTTOM_T = 10.1
TEMPERATURE_DIFFERENCE = 1.2
SALINITY = 35.0
CORIOLIS_F = -1.2e-4
GRADIENT_WIDTH_FRAC = 0.08


def init_baroclinic_channel(mesh: Mesh, nz: int = 20, dtype=np.float64):
    """Returns (OcnGrid, OcnState) on a channel mesh (periodic x, walls y)
    of CPU tensors."""
    nC = mesh.nCells
    x = mesh.xCell.cpu().numpy()
    y = mesh.yCell.cpu().numpy()
    x_min, x_max = 0.0, mesh.x_period
    y_min, y_max = y.min(), y.max()
    y_mid = 0.5 * (y_min + y_max)
    width = (y_max - y_min) * GRADIENT_WIDTH_FRAC

    # uniform layers (interfaceLocations linear; ref :210-214)
    h0 = np.full((nC, nz), BOTTOM_DEPTH / nz)
    ref_zmid = -(np.arange(nz) + 0.5) * BOTTOM_DEPTH / nz

    # stratification (ref :226-233)
    T = BOTTOM_T + (SURFACE_T - BOTTOM_T) \
        * ((ref_zmid + BOTTOM_DEPTH) / BOTTOM_DEPTH)
    T = np.broadcast_to(T, (nC, nz)).copy()

    # meandering front (ref :217-244)
    y_offset = width * np.sin(6.0 * pii * (x - x_min) / (x_max - x_min))
    south = y < (y_mid - y_offset)
    frontal = (~south) & (y < y_mid - y_offset + width)
    T[south] -= TEMPERATURE_DIFFERENCE
    frac = 1.0 - (y - (y_mid - y_offset)) / width
    T[frontal] -= TEMPERATURE_DIFFERENCE * frac[frontal, None]

    # localized crest perturbation (ref :246-258)
    xp_min = x_min + 1.2 * (x_max - x_min) / 4.0
    xp_max = x_min + 1.8 * (x_max - x_min) / 4.0
    y_off2 = 0.5 * width * np.sin(pii * (x - xp_min) / (xp_max - xp_min))
    in_pert = ((y >= y_mid - y_off2 - 0.5 * width)
               & (y <= y_mid - y_off2 + 0.5 * width)
               & (x >= xp_min) & (x <= xp_max))
    bump = 0.3 * (1.0 - (y - (y_mid - y_off2)) / (0.5 * width))
    T[in_pert] += bump[in_pert, None]

    S = np.full((nC, nz), SALINITY)
    tracers = np.stack([T, S], axis=-1)

    dtypec = mesh.areaCell.cpu().numpy().dtype

    def const(n):
        return torch.from_numpy(np.full(n, CORIOLIS_F, dtype=dtypec))

    mesh = dataclasses.replace(mesh, fEdge=const(mesh.nEdges),
                               fVertex=const(mesh.nVertices),
                               fCell=const(mesh.nCells))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    grid = OcnGrid(mesh=mesh, restingThickness=t(h0.astype(dtype)),
                   bottomDepth=t(np.full(nC, BOTTOM_DEPTH, dtype=dtype)),
                   maxLevelCell=t(np.full(nC, nz, dtype=np.int32)), nz=nz)
    state = OcnState(ubtr=t(np.zeros(mesh.nEdges, dtype=dtype)),
                     u=t(np.zeros((mesh.nEdges, nz), dtype=dtype)),
                     layerThickness=t(h0.astype(dtype)),
                     tracers=t(tracers.astype(dtype)))
    return grid, state
