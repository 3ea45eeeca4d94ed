"""Cell-assembled TRiSK operators of the dycore's path (port of
mpas_tpu/ops/stencils.py:104-140).

The TRiSK tangential operator v(e) = sum_j w(e,j) u(e_j) is evaluated per
cell: one edgesOnCell gather, a per-cell (maxEdges x maxEdges)
contraction with the weights triskM (kernel K2), and a pick of each edge's
entry from its two cells (ref loop: mpas_tangential_velocity,
src/operators/mpas_vector_operations.F:352-360).
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.kernels.tinydot import tinydot
from mpas_tpu_torch.mesh.mesh import Mesh


def tangential_cell_assembled(mesh: Mesh, x_edge):
    """TRiSK tangential operator of an edge field x_edge (nE, K) -> (nE, K):
    v(e) = G[c1(e), slot1(e)] + G[c2(e), slot2(e)],
    G[c, p] = sum_i triskM[c, p, i] * x[edgesOnCell[c, i]]."""
    G = tinydot(mesh.triskM, x_edge[mesh.edgesOnCell])     # (nC, mE, K)
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    s1, s2 = mesh.edgeSlotOnCell[:, 0], mesh.edgeSlotOnCell[:, 1]
    return G[c1, s1] + G[c2, s2]


def trisk_q_cell_assembled(mesh: Mesh, u_weighted, pv_edge):
    """Nonlinear Coriolis q(e) = sum_j w(e,j) u_w(e_j) 0.5 (pv(e) + pv(e_j))
    as q = 0.5 * (pv * T(u_w) + T(u_w * pv)), with both tangential
    operators in one call (ref loop: mpas_atm_time_integration.F:4803-4813).
    u_weighted, pv_edge: (nE, K)."""
    k = u_weighted.shape[-1]
    t = tangential_cell_assembled(
        mesh, torch.cat([u_weighted, u_weighted * pv_edge], dim=-1))
    return 0.5 * (pv_edge * t[:, :k] + t[:, k:])
