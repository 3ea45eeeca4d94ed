# Frozen copy of mpas_tpu_torch/ops/stencils.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Mesh-generic TRiSK stencil operators (port of mpas_tpu/ops/stencils.py).

Every operator is a gather from the destination entity followed by a
weighted sum over its small neighbour axis; padded neighbour slots point
at entity 0 and carry zero weight. Fields may carry trailing dims, e.g.
(nCells, nz) or (nCells, nTracers).

Reference loops (ref: src/core_sw/mpas_sw_time_integration.F):
  divergence at cells        :1205-1224
  circulation / vorticity    :1186-1199
  normal gradient at edges   :489-497
  tangential velocity        mpas_tangential_velocity,
                             src/operators/mpas_vector_operations.F:352-360
  kinetic energy at cells    :1230-1241
  cell -> vertex kite remap  :1272-1283
  vertex -> cell kite remap  :1330-1341
  vertex -> edge average     :1302-1310

The cell-assembled TRiSK operators evaluate v(e) = sum_j w(e,j) u(e_j) per
cell: one edgesOnCell gather, a per-cell (maxEdges x maxEdges) contraction
with the weights triskM (kernel K2), and a pick of each edge's entry from
its two cells.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.plain import tinydot
from benchmark.reference.mesh.mesh import Mesh


def _w(weights, field_ndim):
    """Broadcast (n, s) weights over a gathered (n, s, ...) field."""
    return weights.reshape(weights.shape + (1,) * (field_ndim - 2))


def _per_row(x, ndim):
    """Broadcast an (n,) vector over an (n, ...) field of `ndim` dims."""
    return x.reshape((-1,) + (1,) * (ndim - 1))


def edge_divergence(mesh: Mesh, u_edge):
    """Divergence at cell centres of an edge field:
    div(c) = (1/A_c) sum_j sign(c,j) u(e_j) dvEdge(e_j)."""
    ue = u_edge[mesh.edgesOnCell]                      # (nC, mE, ...)
    acc = (_w(mesh.divW, ue.dim()) * ue).sum(1)
    return acc * _per_row(mesh.invAreaCell, acc.dim())


def edge_circulation(mesh: Mesh, u_edge):
    """Circulation at vertices: sum_i sign(v,i) u(e_i) dcEdge(e_i)."""
    ue = u_edge[mesh.edgesOnVertex]
    return (_w(mesh.curlW, ue.dim()) * ue).sum(1)


def edge_curl(mesh: Mesh, u_edge):
    """Relative vorticity at vertices: circulation / areaTriangle."""
    circ = edge_circulation(mesh, u_edge)
    return circ * _per_row(mesh.invAreaTriangle, circ.dim())


def cell_gradient_n(mesh: Mesh, f_cell, mask_boundary: bool = True):
    """Normal gradient at edges, (f(cell2) - f(cell1)) / dcEdge, zeroed on
    boundary edges when mask_boundary."""
    f2 = f_cell[mesh.cellsOnEdge[:, 1]]
    f1 = f_cell[mesh.cellsOnEdge[:, 0]]
    g = (f2 - f1) * _per_row(mesh.invDcEdge, f1.dim())
    if mask_boundary:
        g = g * _per_row(1.0 - mesh.boundaryEdge, g.dim())
    return g


def cell_to_edge_mean(mesh: Mesh, f_cell):
    """Two-point cell -> edge mean (2nd-order h_edge)."""
    return 0.5 * (f_cell[mesh.cellsOnEdge[:, 0]]
                  + f_cell[mesh.cellsOnEdge[:, 1]])


def vertex_gradient_t(mesh: Mesh, f_vertex):
    """Tangential gradient at edges: (f(v2) - f(v1)) / dvEdge."""
    f2 = f_vertex[mesh.verticesOnEdge[:, 1]]
    f1 = f_vertex[mesh.verticesOnEdge[:, 0]]
    return (f2 - f1) * _per_row(mesh.invDvEdge, f1.dim())


def vertex_to_edge_mean(mesh: Mesh, f_vertex):
    """0.5 (f(v1) + f(v2))."""
    return 0.5 * (f_vertex[mesh.verticesOnEdge[:, 0]]
                  + f_vertex[mesh.verticesOnEdge[:, 1]])


def tangential_velocity(mesh: Mesh, u_edge):
    """TRiSK tangential reconstruction over edgesOnEdge:
    v(e) = sum_i w(e,i) u(edgesOnEdge[e,i])."""
    ue = u_edge[mesh.edgesOnEdge]
    return (_w(mesh.weightsOnEdge, ue.dim()) * ue).sum(1)


def tangential_cell_assembled(mesh: Mesh, x_edge):
    """The same TRiSK tangential operator, cell-assembled, of x_edge (nE,)
    or (nE, K); returns the same shape:
    v(e) = G[c1(e), slot1(e)] + G[c2(e), slot2(e)],
    G[c, p] = sum_i triskM[c, p, i] * x[edgesOnCell[c, i]].
    A 1-D field goes through K2 as a (nC, mE, 1) operand."""
    if x_edge.dim() == 1:
        return tangential_cell_assembled(mesh, x_edge[:, None])[:, 0]
    G = tinydot(mesh.triskM, x_edge[mesh.edgesOnCell])     # (nC, mE, K)
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    s1, s2 = mesh.edgeSlotOnCell[:, 0], mesh.edgeSlotOnCell[:, 1]
    return G[c1, s1] + G[c2, s2]


def trisk_q_cell_assembled(mesh: Mesh, u_weighted, pv_edge):
    """Nonlinear Coriolis q(e) = sum_j w(e,j) u_w(e_j) 0.5 (pv(e) + pv(e_j))
    as q = 0.5 * (pv * T(u_w) + T(u_w * pv)), with both tangential
    operators in one K2 call (ref loop: mpas_atm_time_integration.F:
    4803-4813). u_weighted is u (atmosphere) or u * h_edge (shallow
    water); u_weighted, pv_edge: (nE,) or (nE, K)."""
    if u_weighted.dim() == 1:
        t = tangential_cell_assembled(
            mesh, torch.stack([u_weighted, u_weighted * pv_edge], dim=-1))
        return 0.5 * (pv_edge * t[:, 0] + t[:, 1])
    k = u_weighted.shape[-1]
    t = tangential_cell_assembled(
        mesh, torch.cat([u_weighted, u_weighted * pv_edge], dim=-1))
    return 0.5 * (pv_edge * t[:, :k] + t[:, k:])


def kinetic_energy_cell(mesh: Mesh, u_edge):
    """KE at cells: (1/A) sum_j 0.25 dc dv u^2 over edgesOnCell."""
    ue = u_edge[mesh.edgesOnCell]
    acc = (_w(mesh.keW, ue.dim()) * ue * ue).sum(1)
    return acc * _per_row(mesh.invAreaCell, acc.dim())


def cell_to_vertex_kite(mesh: Mesh, f_cell):
    """Kite-area-weighted cell -> vertex remap (h_vertex)."""
    fc = f_cell[mesh.cellsOnVertex]
    acc = (_w(mesh.kiteAreasOnVertex, fc.dim()) * fc).sum(1)
    return acc * _per_row(mesh.invAreaTriangle, acc.dim())


def vertex_to_cell_kite(mesh: Mesh, f_vertex):
    """Kite-area-weighted vertex -> cell remap (pv_cell, vorticity_cell)."""
    fv = f_vertex[mesh.verticesOnCell]
    acc = (_w(mesh.kiteAreasOnCell, fv.dim()) * fv).sum(1)
    return acc * _per_row(mesh.invAreaCell, acc.dim())


def edge_sum_on_cell(mesh: Mesh, f_edge, weights=None):
    """Masked sum of an edge field over each cell's edges, optionally
    weighted by a (nCells, maxEdges) array."""
    fe = f_edge[mesh.edgesOnCell]
    w = mesh.edgesOnCellMask if weights is None \
        else mesh.edgesOnCellMask * weights
    return (_w(w, fe.dim()) * fe).sum(1)
