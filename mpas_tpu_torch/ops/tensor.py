"""Standalone R3 tensor operations on the Voronoi mesh (port of
mpas_tpu/ops/tensor.py).

ref capability: src/operators/mpas_tensor_operations.F —
  mpas_strain_rate_R3Cell            (:78)
  mpas_divergence_of_tensor_R3Cell   (:191)
  mpas_tensor_edge_R3_to_2D          (:288)
  mpas_tensor_edge_2D_to_R3          (:387)
  mpas_tensor_LonLat_to_R3           (:489)
  mpas_tensor_LonLatR_to_R3          (:568)
  mpas_tensor_R3_to_LonLat           (:641)
  mpas_tensor_R3_to_LonLatR          (:717)
plus the sym6 <-> 3x3 conversions from mpas_matrix_operations.F:228,278.

Symmetric tensors ride in the reference's 6-index form
[xx, yy, zz, xy, yz, xz] (off-diagonals averaged on conversion), stored
in the LAST axis so cells/edges batch in the leading axes.

The mesh-indirection sums (strain rate, tensor divergence) are the same
edge->cell segment pattern as ops/stencils.py: padded edgesOnCell
gathers masked by edgesOnCellMask, vectorized over all cells and levels
at once. The 3x3 basis rotations are einsums, batched over any leading
shape.
"""

from __future__ import annotations

import numpy as np
import torch

from mpas_tpu_torch.containers import to_host

__all__ = [
    "sym6_to_3x3", "matrix_3x3_to_sym6",
    "edge_basis_vectors",
    "outer_product_edge", "strain_rate_r3_cell",
    "divergence_of_tensor_r3_cell",
    "tensor_edge_r3_to_2d", "tensor_edge_2d_to_r3",
    "zonal_meridional_vectors",
    "tensor_lonlat_to_r3", "tensor_r3_to_lonlat",
    "tensor_lonlatr_to_r3", "tensor_r3_to_lonlatr",
]

# index maps for [xx, yy, zz, xy, yz, xz]
_I = (0, 1, 2, 0, 1, 0)
_J = (0, 1, 2, 1, 2, 2)
# sym6 slot of each (i, j) of the 3x3 matrix
_SLOT = ((0, 3, 5), (3, 1, 4), (5, 4, 2))


def sym6_to_3x3(t6):
    """(..., 6) sym6 -> (..., 3, 3) (ref mpas_matrix_operations.F:228)."""
    idx = torch.tensor(_SLOT, device=t6.device).reshape(-1)
    return t6[..., idx].reshape(t6.shape[:-1] + (3, 3))


def matrix_3x3_to_sym6(m):
    """(..., 3, 3) -> (..., 6) with off-diagonal averaging
    (ref mpas_matrix_operations.F:278: B(4)=0.5*(A12+A21) etc.)."""
    sym = 0.5 * (m + m.transpose(-1, -2))
    return sym[..., list(_I), list(_J)]


def edge_basis_vectors(mesh):
    """(edgeNormalVectors, edgeTangentVectors, edgeVerticalVectors), each
    (nEdges, 3), built in host numpy float64 (ref mpas_vector_operations.F
    :652 mpas_initialize_vectors) and returned as tensors on the mesh's
    device in its dtype: normal points cell1 -> cell2 (boundary edges:
    cell1 -> edge midpoint), tangent points vertex1 -> vertex2, vertical
    completes the right-handed frame n x t."""
    def xyz(k):
        return np.stack([to_host(getattr(mesh, f"{c}{k}")).astype(
            np.float64) for c in "xyz"], -1)

    xc, xe, xv = xyz("Cell"), xyz("Edge"), xyz("Vertex")
    coe = to_host(mesh.cellsOnEdge)
    voe = to_host(mesh.verticesOnEdge)
    boundary = to_host(mesh.boundaryEdge) > 0

    def wrap(d):
        # shortest-image displacement on doubly periodic planes
        if not mesh.on_sphere:
            for ax, period in ((0, mesh.x_period), (1, mesh.y_period)):
                if period and period > 0:
                    d[:, ax] -= period * np.round(d[:, ax] / period)
        return d

    d = np.where(boundary[:, None], wrap(xe - xc[coe[:, 0]]),
                 wrap(xc[coe[:, 1]] - xc[coe[:, 0]]))
    en = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
    t = wrap(xv[voe[:, 1]] - xv[voe[:, 0]])
    # project out the normal so (n, t) is orthonormal even on the sphere
    t = t - en * np.sum(t * en, -1, keepdims=True)
    et = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-30)
    ev = np.cross(en, et)
    dev, dt = mesh.xCell.device, mesh.xCell.dtype
    return tuple(torch.as_tensor(a, dtype=dt, device=dev)
                 for a in (en, et, ev))


def outer_product_edge(u_normal, u_tangential, edge_normal, edge_tangent):
    """Velocity outer product at edges in sym6 form
    (ref mpas_strain_rate_R3Cell :150-160: n (u n + v t)^T symmetrized).

    u_normal/u_tangential: (nE, nz); edge_normal/edge_tangent: (nE, 3).
    Returns (nE, nz, 6)."""
    vel = (u_normal[..., None] * edge_normal[:, None, :]
           + u_tangential[..., None] * edge_tangent[:, None, :])  # (nE,nz,3)
    outer = edge_normal[:, None, :, None] * vel[..., None, :]     # n_i v_j
    return matrix_3x3_to_sym6(outer)


def _edge_to_cell_div(mesh, edge_vals):
    """(1/A_c) sum_e sign_ce dv_e x_e over edgesOnCell; edge_vals
    (nE, ...) -> (nC, ...). The reference writes this with a leading
    minus because its edgeSignOnCell is -1 on the outward side
    (ref :170); this mesh stores outward = +1 (mesh/build.py, matching
    ops/stencils.edge_divergence), so the signed sum is positive."""
    eoc = mesh.edgesOnCell
    g = edge_vals[eoc]                                   # (nC, maxE, ...)
    w = mesh.edgeSignOnCell * mesh.dvEdge[eoc]
    w = torch.where(mesh.edgesOnCellMask > 0, w, torch.zeros_like(w))
    w = w.reshape(w.shape + (1,) * (g.dim() - 2))
    acc = (w * g).sum(1)
    return acc * mesh.invAreaCell.reshape((-1,) + (1,) * (acc.dim() - 1))


def strain_rate_r3_cell(mesh, outer6_edge):
    """Cell-centered strain rate from edge outer products
    (ref mpas_strain_rate_R3Cell :163-175). outer6_edge (nE, nz, 6)
    -> (nC, nz, 6)."""
    return _edge_to_cell_div(mesh, outer6_edge)


def divergence_of_tensor_r3_cell(mesh, tensor6_edge, edge_normal):
    """Divergence of an edge tensor as a cell 3-vector
    (ref mpas_divergence_of_tensor_R3Cell :191): contract the edge
    normal with the tensor, then take the signed edge sum."""
    m = sym6_to_3x3(tensor6_edge)                        # (nE, nz, 3, 3)
    ndot = torch.einsum("ep,ekpq->ekq", edge_normal, m)  # (nE, nz, 3)
    return _edge_to_cell_div(mesh, ndot)


def _rotate(m, rot, to_local: bool):
    """R^T m R (to_local) or R m R^T; rot (..., 3, 3) columns = basis."""
    if to_local:
        return torch.einsum("...pi,...pq,...qj->...ij", rot, m, rot)
    return torch.einsum("...ip,...pq,...jq->...ij", rot, m, rot)


def _edge_rot(edge_normal, edge_tangent):
    ev = torch.linalg.cross(edge_normal, edge_tangent, dim=-1)
    return torch.stack([edge_normal, edge_tangent, ev], dim=-1)  # cols


def tensor_edge_r3_to_2d(tensor6_edge, edge_normal, edge_tangent):
    """R3 sym6 at edges -> 2D sym3 [nn, tt, nt] in the (normal, tangent)
    edge frame (ref mpas_tensor_edge_R3_to_2D :288)."""
    rot = _edge_rot(edge_normal, edge_tangent)
    r = _rotate(sym6_to_3x3(tensor6_edge), rot[:, None], to_local=True)
    return torch.stack([r[..., 0, 0], r[..., 1, 1],
                        0.5 * (r[..., 0, 1] + r[..., 1, 0])], dim=-1)


def _embed_sym3(t3):
    """sym3 [aa, bb, ab] -> the 3x3 with a zero third row/column."""
    z = torch.zeros_like(t3[..., 0])
    return torch.stack([
        torch.stack([t3[..., 0], t3[..., 2], z], -1),
        torch.stack([t3[..., 2], t3[..., 1], z], -1),
        torch.stack([z, z, z], -1)], -2)


def tensor_edge_2d_to_r3(tensor3_edge, edge_normal, edge_tangent):
    """Inverse of tensor_edge_r3_to_2d (ref :387): embed sym3 in the
    edge frame and rotate back to R3."""
    rot = _edge_rot(edge_normal, edge_tangent)
    r = _rotate(_embed_sym3(tensor3_edge), rot[:, None], to_local=False)
    return matrix_3x3_to_sym6(r)


def zonal_meridional_vectors(lon, lat):
    """Unit (zonal, meridional, vertical) at (lon, lat)
    (ref mpas_vector_operations.F mpas_zonal_meridional_vectors)."""
    sl, cl = torch.sin(lon), torch.cos(lon)
    sp, cp = torch.sin(lat), torch.cos(lat)
    zonal = torch.stack([-sl, cl, torch.zeros_like(sl)], -1)
    merid = torch.stack([-sp * cl, -sp * sl, cp], -1)
    vert = torch.stack([cp * cl, cp * sl, sp], -1)
    return zonal, merid, vert


def _lonlat_rot(lon, lat):
    z, m, v = zonal_meridional_vectors(lon, lat)
    return torch.stack([z, m, v], dim=-1)      # columns = local basis


def tensor_lonlat_to_r3(tensor3, lon, lat):
    """sym3 [zonal-zonal, merid-merid, zonal-merid] -> R3 sym6
    (ref mpas_tensor_LonLat_to_R3 :489)."""
    r = _rotate(_embed_sym3(tensor3), _lonlat_rot(lon, lat),
                to_local=False)
    return matrix_3x3_to_sym6(r)


def tensor_r3_to_lonlat(tensor6, lon, lat):
    """R3 sym6 -> sym3 in the local (zonal, meridional) plane
    (ref mpas_tensor_R3_to_LonLat :641)."""
    r = _rotate(sym6_to_3x3(tensor6), _lonlat_rot(lon, lat), to_local=True)
    return torch.stack([r[..., 0, 0], r[..., 1, 1],
                        0.5 * (r[..., 0, 1] + r[..., 1, 0])], dim=-1)


def tensor_lonlatr_to_r3(tensor3x3, lon, lat):
    """Full 3x3 (zonal, meridional, radial) -> R3 3x3
    (ref mpas_tensor_LonLatR_to_R3 :568)."""
    return _rotate(tensor3x3, _lonlat_rot(lon, lat), to_local=False)


def tensor_r3_to_lonlatr(tensor3x3, lon, lat):
    """R3 3x3 -> (zonal, meridional, radial) 3x3
    (ref mpas_tensor_R3_to_LonLatR :717)."""
    return _rotate(tensor3x3, _lonlat_rot(lon, lat), to_local=True)
