# Frozen copy of mpas_tpu_torch/ops/reconstruct.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""RBF vector reconstruction: edge-normal components -> cell-centre vectors
(port of mpas_tpu/ops/reconstruct.py).

ref: src/operators/mpas_vector_reconstruction.F (mpas_init_reconstruct :51
builds per-cell coefficients through the RBF machinery of
mpas_rbf_interpolation.F; mpas_reconstruct :195/:309 applies them) — the
constant-preserving inverse-multiquadric vector RBF in the cell tangent
plane. The weights are built once on the host in numpy; applying them is
one edgesOnCell gather and a sum over the cell's edges, returning the
cell-centred (X, Y, Z) and (zonal, meridional) winds as the reference does.
Padded edgesOnCell slots point at edge 0 and carry zero weight.
"""

from __future__ import annotations

import numpy as np
import torch


def _phi(r):
    """Inverse multiquadric kernel (ref: mpas_rbf_interpolation.F)."""
    return 1.0 / np.sqrt(1.0 + r * r)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def build_reconstruct_coeffs(mesh):
    """coeffs_reconstruct (nCells, maxEdges, 3), float64 numpy: the 3-D
    vector weight of each edge's normal velocity in the cell-centre
    reconstruction. Move it to the card with torch.as_tensor(...).to()."""
    nC, mE = mesh.nCells, mesh.maxEdges
    nEoC = _host(mesh.nEdgesOnCell)
    eoc = _host(mesh.edgesOnCell)
    cxyz = np.stack([_host(mesh.xCell), _host(mesh.yCell),
                     _host(mesh.zCell)], -1).astype(float)
    exyz = np.stack([_host(mesh.xEdge), _host(mesh.yEdge),
                     _host(mesh.zEdge)], -1).astype(float)
    ang = _host(mesh.angleEdge)
    latE, lonE = _host(mesh.latEdge), _host(mesh.lonEdge)
    if mesh.on_sphere:
        ee = np.stack([-np.sin(lonE), np.cos(lonE), np.zeros_like(lonE)], -1)
        ne = np.stack([-np.sin(latE) * np.cos(lonE),
                       -np.sin(latE) * np.sin(lonE), np.cos(latE)], -1)
        normals = np.cos(ang)[:, None] * ee + np.sin(ang)[:, None] * ne
    else:
        normals = np.stack([np.cos(ang), np.sin(ang),
                            np.zeros_like(ang)], -1)

    coeffs = np.zeros((nC, mE, 3))
    # the cells with n edges at once: one batch of (n+2)-square systems
    for n in np.unique(nEoC):
        n = int(n)
        cells = np.nonzero(nEoC == n)[0]
        es = eoc[cells, :n]                             # (G, n)
        d = exyz[es] - cxyz[cells][:, None, :]          # (G, n, 3)
        if mesh.x_period > 0:
            d[..., 0] -= mesh.x_period * np.round(d[..., 0] / mesh.x_period)
        if mesh.y_period > 0:
            d[..., 1] -= mesh.y_period * np.round(d[..., 1] / mesh.y_period)
        # tangent-plane basis at each cell
        if mesh.on_sphere:
            up = cxyz[cells] / np.linalg.norm(cxyz[cells], axis=-1,
                                              keepdims=True)
            d0 = d[:, 0]
            t1 = d0 - np.sum(d0 * up, -1, keepdims=True) * up
            t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
            t2 = np.cross(up, t1)
        else:
            t1 = np.broadcast_to([1.0, 0.0, 0.0], (cells.size, 3))
            t2 = np.broadcast_to([0.0, 1.0, 0.0], (cells.size, 3))

        def plane(v):                                   # (G, n, 2)
            return np.stack([np.sum(v * t1[:, None], -1),
                             np.sum(v * t2[:, None], -1)], -1)
        P = plane(d)                                    # locations
        Nv = plane(normals[es])
        Nv /= np.maximum(np.linalg.norm(Nv, axis=-1, keepdims=True), 1e-12)
        alpha = np.mean(np.linalg.norm(P, axis=-1), axis=-1)   # (G,)
        # constant-preserving vector RBF system (ref: rbf ..._const_dir):
        # V(x) = sum_j c_j phi(|x-x_j|/a) n_j + d0 ;  V(x_i).n_i = u_i ;
        # sum_j c_j n_j = 0
        r = np.linalg.norm(P[:, :, None] - P[:, None], axis=-1) \
            / alpha[:, None, None]
        A = np.zeros((cells.size, n + 2, n + 2))
        A[:, :n, :n] = _phi(r) * np.einsum("gik,gjk->gij", Nv, Nv)
        A[:, :n, n:] = Nv
        A[:, n:, :n] = Nv.transpose(0, 2, 1)
        rhs = np.zeros((n + 2, n))
        rhs[:n, :n] = np.eye(n)
        X = np.linalg.solve(A, np.broadcast_to(rhs, A.shape[:1] + rhs.shape))
        # evaluate at the cell centre (distance |P_j|/alpha)
        phi_c = _phi(np.linalg.norm(P, axis=-1) / alpha[:, None])  # (G, n)
        V2 = np.einsum("gjk,gji->gki", phi_c[..., None] * Nv, X[:, :n]) \
            + X[:, n:]                                  # (G, 2, n)
        coeffs[cells, :n, :] = V2[:, 0, :, None] * t1[:, None] \
            + V2[:, 1, :, None] * t2[:, None]
    return coeffs


def reconstruct(mesh, coeffs, u_edge):
    """Apply the weights: returns (Vx, Vy, Vz, zonal, meridional) at cells
    (ref: mpas_reconstruct_2d :309). coeffs is a (nCells, maxEdges, 3)
    tensor on u_edge's device."""
    ue = u_edge[mesh.edgesOnCell]                       # (nC, mE, ...)
    extra = ue.dim() - 2
    w = coeffs.reshape(coeffs.shape[:2] + (1,) * extra + (3,))
    V = torch.sum(w * ue[..., None], dim=1)             # (nC, ..., 3)
    lat, lon = mesh.latCell, mesh.lonCell
    if mesh.on_sphere:
        east = torch.stack([-torch.sin(lon), torch.cos(lon),
                            torch.zeros_like(lon)], -1)
        north = torch.stack([-torch.sin(lat) * torch.cos(lon),
                             -torch.sin(lat) * torch.sin(lon),
                             torch.cos(lat)], -1)
    else:
        one, zero = torch.ones_like(lon), torch.zeros_like(lon)
        east = torch.stack([one, zero, zero], -1)
        north = torch.stack([zero, one, zero], -1)
    shape = (V.shape[0],) + (1,) * extra + (3,)
    zonal = torch.sum(V * east.reshape(shape), dim=-1)
    merid = torch.sum(V * north.reshape(shape), dim=-1)
    return V[..., 0], V[..., 1], V[..., 2], zonal, merid
