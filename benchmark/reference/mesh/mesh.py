# Frozen copy of mpas_tpu_torch/mesh/mesh.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Unstructured Voronoi mesh container (port of mpas_tpu/mesh/mesh.py).

Struct of tensors. Index tables are 0-based; padded slots point at entity
0 and carry zero weight/sign. The sign conventions are those of the
reference package: the normal of edge e points from cellsOnEdge[e,0] to
cellsOnEdge[e,1]; edgeSignOnCell[c,j] = +1 where c is cellsOnEdge[e,0];
edgeSignOnVertex[v,i] = +1 where v is verticesOnEdge[e,1].
"""

from __future__ import annotations

import dataclasses
from typing import Any

from benchmark.reference.containers import to_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    # --- static metadata ---
    nCells: int
    nEdges: int
    nVertices: int
    maxEdges: int
    maxEdges2: int
    vertexDegree: int
    on_sphere: bool
    sphere_radius: float
    x_period: float
    y_period: float

    # --- connectivity (int64 after .to(); padded entries = 0) ---
    cellsOnEdge: Any          # (nEdges, 2)
    verticesOnEdge: Any       # (nEdges, 2)
    edgesOnCell: Any          # (nCells, maxEdges)
    nEdgesOnCell: Any         # (nCells,)
    cellsOnCell: Any          # (nCells, maxEdges)
    verticesOnCell: Any       # (nCells, maxEdges)
    cellsOnVertex: Any        # (nVertices, vertexDegree)
    edgesOnVertex: Any        # (nVertices, vertexDegree)
    edgesOnEdge: Any          # (nEdges, maxEdges2)
    nEdgesOnEdge: Any         # (nEdges,)

    # --- masks / signs ---
    edgesOnCellMask: Any      # (nCells, maxEdges) 1.0 where valid
    edgeSignOnCell: Any       # (nCells, maxEdges) +1 outward-normal, 0 padded
    edgeSignOnVertex: Any     # (nVertices, vertexDegree) +-1, 0 padded
    cellsOnVertexMask: Any    # (nVertices, vertexDegree)
    boundaryEdge: Any         # (nEdges,)
    boundaryCell: Any         # (nCells,)
    boundaryVertex: Any       # (nVertices,)

    # --- geometry ---
    xCell: Any
    yCell: Any
    zCell: Any
    latCell: Any
    lonCell: Any
    xEdge: Any
    yEdge: Any
    zEdge: Any
    latEdge: Any
    lonEdge: Any
    xVertex: Any
    yVertex: Any
    zVertex: Any
    latVertex: Any
    lonVertex: Any
    dvEdge: Any               # (nEdges,) distance between edge's vertices
    dcEdge: Any               # (nEdges,) distance between edge's cells
    areaCell: Any             # (nCells,)
    areaTriangle: Any         # (nVertices,)
    kiteAreasOnVertex: Any    # (nVertices, vertexDegree)
    kiteAreasOnCell: Any      # (nCells, maxEdges)
    angleEdge: Any            # (nEdges,)
    weightsOnEdge: Any        # (nEdges, maxEdges2) TRiSK tangential weights
    # cell-assembled TRiSK operator: v(e) = G[c1(e), slot1(e)]
    # + G[c2(e), slot2(e)], G[c,p] = sum_i triskM[c,p,i] x[edgesOnCell[c,i]]
    triskM: Any               # (nCells, maxEdges, maxEdges)
    edgeSlotOnCell: Any       # (nEdges, 2) slot of e in its cells
    meshDensity: Any          # (nCells,)

    # --- reciprocals ---
    invAreaCell: Any
    invAreaTriangle: Any
    invDvEdge: Any
    invDcEdge: Any

    # --- stencil weight bundles, row-aligned with the index tables ---
    divW: Any                 # (nCells, maxEdges) = edgeSignOnCell*dvEdge[eoc]
    keW: Any                  # (nCells, maxEdges) = 0.25*dc*dv[eoc]*mask
    curlW: Any                # (nVertices, vertexDegree) = sign*dcEdge[eov]

    # --- Coriolis ---
    fEdge: Any
    fVertex: Any
    fCell: Any

    # --- mesh scaling of the del2/del4 dissipation ---
    meshScalingDel2: Any
    meshScalingDel4: Any

    def scaled(self, radius: float) -> "Mesh":
        """Rescale a unit-sphere mesh to the given radius
        (ref: mpas_sw_test_cases.F:303-318)."""
        if not self.on_sphere:
            raise ValueError("scaled() only applies to spherical meshes")
        r = radius / self.sphere_radius
        return dataclasses.replace(
            self, sphere_radius=float(radius),
            xCell=self.xCell * r, yCell=self.yCell * r, zCell=self.zCell * r,
            xEdge=self.xEdge * r, yEdge=self.yEdge * r, zEdge=self.zEdge * r,
            xVertex=self.xVertex * r, yVertex=self.yVertex * r,
            zVertex=self.zVertex * r,
            dvEdge=self.dvEdge * r, dcEdge=self.dcEdge * r,
            invDvEdge=self.invDvEdge / r, invDcEdge=self.invDcEdge / r,
            divW=self.divW * r, curlW=self.curlW * r,
            keW=self.keW * r * r,
            areaCell=self.areaCell * r * r,
            areaTriangle=self.areaTriangle * r * r,
            kiteAreasOnVertex=self.kiteAreasOnVertex * r * r,
            kiteAreasOnCell=self.kiteAreasOnCell * r * r,
            invAreaCell=self.invAreaCell / (r * r),
            invAreaTriangle=self.invAreaTriangle / (r * r),
        )

    def to(self, device, dtype) -> "Mesh":
        return to_device(self, device, dtype)

    def validate(self):
        """Cheap structural invariants (host-side)."""
        assert tuple(self.cellsOnEdge.shape) == (self.nEdges, 2)
        assert tuple(self.edgesOnCell.shape) == (self.nCells, self.maxEdges)
        assert tuple(self.weightsOnEdge.shape) == (self.nEdges,
                                                   self.maxEdges2)
        assert int(self.nEdgesOnCell.max()) <= self.maxEdges
