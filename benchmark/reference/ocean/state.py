# Frozen copy of mpas_tpu_torch/cores/ocean/state.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Ocean prognostic state and grid (port of the OcnState and OcnGrid of
mpas_tpu/cores/ocean/core.py).

Layout: layer k = 0 is the surface; u (nEdges, nz), layerThickness
(nCells, nz), tracers (nCells, nz, nT) with T and S first.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from benchmark.reference.containers import to_device
from benchmark.reference.mesh.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class OcnState:
    u: Any               # (nEdges, nz) normal velocity
    layerThickness: Any  # (nCells, nz)
    tracers: Any         # (nCells, nz, nT)
    # split-explicit barotropic velocity, persisted between steps (ref:
    # state normalBarotropicVelocity); None on the RK4 path
    ubtr: Any = None     # (nEdges,)
    # z-tilde prognostics (ref: state lowFreqDivergence /
    # highFreqThickness, Registry.xml); None under z-star only
    lowFreqDivergence: Any = None   # (nCells, nz)
    highFreqThickness: Any = None   # (nCells, nz)

    def to(self, device, dtype) -> "OcnState":
        return to_device(self, device, dtype)


@dataclasses.dataclass(frozen=True)
class OcnGrid:
    mesh: Mesh
    restingThickness: Any   # (nCells, nz)
    bottomDepth: Any        # (nCells,)
    maxLevelCell: Any       # (nCells,) int
    nz: int
    # variable-bathymetry level masks (None = full columns everywhere):
    # cellMask[c, k] = 1 for k < maxLevelCell[c]; edgeMask[e, k] = 1 for
    # k < min(maxLevelCell of the edge's two cells), the reference's
    # maxLevelEdgeTop loop bounds (ref: ocn_init_routines). Dead levels
    # carry an epsilon thickness and are excluded from every flux.
    cellMask: Any = None    # (nCells, nz)
    edgeMask: Any = None    # (nEdges, nz)
    # surface pressure on top of the pressure integral (ref: the
    # surfacePressure/landIcePressure term of ocn_diagnostics)
    surfacePressure: Any = None   # (nCells,)
    # column tidal energy flux (W/m2) of the CVMix tidal-mixing scheme
    tidalEnergyFlux: Any = None   # (nCells,)

    def to(self, device, dtype) -> "OcnGrid":
        return to_device(self, device, dtype)
