# Frozen copy of mpas_tpu_torch/mesh/build.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Host-side mesh construction: raw Voronoi topology on the sphere or the
(periodic) plane -> Mesh (port of mpas_tpu/mesh/build.py).

Given cell centres, vertex positions and per-cell vertex rings, derive
every connectivity, geometry, sign and TRiSK-weight field. Runs once on
the host in numpy; the result is a Mesh of float64/int64 CPU tensors.

TRiSK tangential-reconstruction weights follow Thuburn, Ringler, Skamarock
& Klemp (JCP 2009) eq. 33 as used by mpas_tangential_velocity
(ref: src/operators/mpas_vector_operations.F:352-360): for edge e and each
adjacent cell c, walking the edges of c counterclockwise starting after e,
the weight of the j-th edge e' is

    w(e,e') = s(c,e) * (1/2 - sum_{k<=j} A_kite(v_k, c)/A_c)
              * (dvEdge(e') / dcEdge(e)) * n_sign(e', c)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.mesh.mesh import Mesh

PAD = 0  # padded index slots point at entity 0 and carry zero weight


def _sphere_arc(p, q):
    """Great-circle distance between unit vectors (last axis 3)."""
    cr = np.linalg.norm(np.cross(p, q), axis=-1)
    dt = np.sum(p * q, axis=-1)
    return np.arctan2(cr, dt)


def _sphere_tri_area(p1, p2, p3):
    """Signed spherical excess of the triangle of unit vectors; positive
    when (p1,p2,p3) is counterclockwise seen from outside."""
    num = np.sum(p1 * np.cross(p2, p3), axis=-1)
    den = 1.0 + np.sum(p1 * p2, axis=-1) + np.sum(p2 * p3, axis=-1) \
        + np.sum(p3 * p1, axis=-1)
    return 2.0 * np.arctan2(num, den)


def _normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _wrap_disp(d, x_period, y_period):
    """Minimal-image displacement on an (optionally) periodic plane."""
    d = np.array(d, dtype=np.float64, copy=True)
    if x_period > 0.0:
        d[..., 0] -= x_period * np.round(d[..., 0] / x_period)
    if y_period > 0.0:
        d[..., 1] -= y_period * np.round(d[..., 1] / y_period)
    return d


class _Geom:
    """One geometry interface over the sphere and the (periodic) plane."""

    def __init__(self, on_sphere, x_period=0.0, y_period=0.0):
        self.on_sphere = on_sphere
        self.x_period = x_period
        self.y_period = y_period

    def distance(self, p, q):
        if self.on_sphere:
            return _sphere_arc(p, q)
        return np.linalg.norm(_wrap_disp(q - p, self.x_period, self.y_period),
                              axis=-1)

    def midpoint(self, p, q):
        if self.on_sphere:
            return _normalize(0.5 * (p + q))
        return p + 0.5 * _wrap_disp(q - p, self.x_period, self.y_period)

    def tri_area(self, p1, p2, p3):
        """Signed area of a triangle, positive counterclockwise."""
        if self.on_sphere:
            return _sphere_tri_area(p1, p2, p3)
        d2 = _wrap_disp(p2 - p1, self.x_period, self.y_period)
        d3 = _wrap_disp(p3 - p1, self.x_period, self.y_period)
        return 0.5 * (d2[..., 0] * d3[..., 1] - d2[..., 1] * d3[..., 0])

    def tangent_angle(self, origin, basis_e, basis_n, point):
        """Angle of (point - origin) in the (basis_e, basis_n) tangent frame."""
        if self.on_sphere:
            d = point - origin
        else:
            d = _wrap_disp(point - origin, self.x_period, self.y_period)
        return np.arctan2(np.sum(d * basis_n, axis=-1),
                          np.sum(d * basis_e, axis=-1))

    def local_frame(self, p):
        """(east, north) tangent basis at p (consistent frame at the poles)."""
        if not self.on_sphere:
            e = np.zeros_like(p)
            e[..., 0] = 1.0
            n = np.zeros_like(p)
            n[..., 1] = 1.0
            return e, n
        up = _normalize(p)
        z = np.zeros_like(p)
        z[..., 2] = 1.0
        east = np.cross(z, up)
        nrm = np.linalg.norm(east, axis=-1, keepdims=True)
        polar = nrm[..., 0] < 1e-12
        if np.any(polar):
            x = np.zeros_like(p)
            x[..., 0] = 1.0
            east[polar] = np.cross(x, up[polar])
            nrm = np.linalg.norm(east, axis=-1, keepdims=True)
        east = east / nrm
        north = np.cross(up, east)
        return east, north


def build_mesh(cell_xyz, vertex_xyz, vertices_on_cell, *, on_sphere=True,
               sphere_radius=1.0, x_period=0.0, y_period=0.0) -> Mesh:
    """Construct a complete Mesh from raw Voronoi topology.

    cell_xyz (nCells, 3) and vertex_xyz (nVertices, 3) are unit vectors on
    the sphere, or points of the z=0 plane with on_sphere=False (periodic
    in x and/or y where x_period/y_period > 0); vertices_on_cell is a list
    of per-cell vertex index rings, oriented counterclockwise here."""
    geom = _Geom(on_sphere, x_period, y_period)
    cell_xyz = np.asarray(cell_xyz, dtype=np.float64)
    vertex_xyz = np.asarray(vertex_xyz, dtype=np.float64)
    nCells = cell_xyz.shape[0]
    nVertices = vertex_xyz.shape[0]

    # --- orient vertex rings counterclockwise -----------------------------
    voc = [np.asarray(ring, dtype=np.int64) for ring in vertices_on_cell]
    for c in range(nCells):
        ring = voc[c]
        pts = vertex_xyz[ring]
        area = np.sum(geom.tri_area(cell_xyz[c][None, :], pts,
                                    np.roll(pts, -1, axis=0)))
        if area < 0.0:
            voc[c] = ring[::-1]
    maxEdges = max(len(r) for r in voc)
    maxEdges2 = 2 * maxEdges
    nEdgesOnCell = np.array([len(r) for r in voc], dtype=np.int64)

    # --- build edges from consecutive vertex pairs ------------------------
    # the first cell to create an edge becomes cellsOnEdge[:,0] and fixes
    # verticesOnEdge in its own ccw order, so t = k x n
    edge_of_pair = {}
    cellsOnEdge_l = []
    verticesOnEdge_l = []
    edgesOnCell = np.full((nCells, maxEdges), PAD, dtype=np.int64)
    for c in range(nCells):
        ring = voc[c]
        n = len(ring)
        for j in range(n):
            va, vb = int(ring[j]), int(ring[(j + 1) % n])
            key = (va, vb) if va < vb else (vb, va)
            e = edge_of_pair.get(key)
            if e is None:
                e = len(cellsOnEdge_l)
                edge_of_pair[key] = e
                cellsOnEdge_l.append([c, -1])
                verticesOnEdge_l.append([va, vb])
            else:
                cellsOnEdge_l[e][1] = c
            edgesOnCell[c, j] = e
    nEdges = len(cellsOnEdge_l)
    cellsOnEdge = np.asarray(cellsOnEdge_l, dtype=np.int64)
    verticesOnEdge = np.asarray(verticesOnEdge_l, dtype=np.int64)
    del cellsOnEdge_l, verticesOnEdge_l

    boundaryEdge = (cellsOnEdge[:, 1] < 0).astype(np.float64)
    interior = cellsOnEdge[:, 1] >= 0

    cellsOnCell = np.full((nCells, maxEdges), PAD, dtype=np.int64)
    eoc_valid = np.arange(maxEdges)[None, :] < nEdgesOnCell[:, None]
    e_of = edgesOnCell[eoc_valid]
    c_of = np.repeat(np.arange(nCells), nEdgesOnCell)
    other = np.where(cellsOnEdge[e_of, 0] == c_of,
                     cellsOnEdge[e_of, 1], cellsOnEdge[e_of, 0])
    cellsOnCell[eoc_valid] = np.where(other < 0, PAD, other)

    verticesOnCell = np.full((nCells, maxEdges), PAD, dtype=np.int64)
    for c in range(nCells):
        verticesOnCell[c, :nEdgesOnCell[c]] = voc[c]

    # --- vertex-incident connectivity, ordered ccw around the vertex ------
    vertexDegree = 3
    cov_lists = [[] for _ in range(nVertices)]
    for c in range(nCells):
        for v in voc[c]:
            cov_lists[int(v)].append(c)
    vertexDegree = max(vertexDegree, max(len(l) for l in cov_lists))

    eov_lists = [[] for _ in range(nVertices)]
    for e in range(nEdges):
        eov_lists[int(verticesOnEdge[e, 0])].append(e)
        eov_lists[int(verticesOnEdge[e, 1])].append(e)

    cellsOnVertex = np.full((nVertices, vertexDegree), PAD, dtype=np.int64)
    edgesOnVertex = np.full((nVertices, vertexDegree), PAD, dtype=np.int64)
    cellsOnVertexMask = np.zeros((nVertices, vertexDegree))
    ve_east, ve_north = geom.local_frame(vertex_xyz)
    for v in range(nVertices):
        cl = cov_lists[v]
        ang = geom.tangent_angle(vertex_xyz[v], ve_east[v], ve_north[v],
                                 cell_xyz[cl])
        order = np.argsort(ang)
        cellsOnVertex[v, :len(cl)] = np.asarray(cl)[order]
        cellsOnVertexMask[v, :len(cl)] = 1.0
        el = eov_lists[v]
        mid = geom.midpoint(vertex_xyz[verticesOnEdge[el, 0]],
                            vertex_xyz[verticesOnEdge[el, 1]])
        ang = geom.tangent_angle(vertex_xyz[v], ve_east[v], ve_north[v], mid)
        order = np.argsort(ang)
        edgesOnVertex[v, :len(el)] = np.asarray(el)[order]

    boundaryVertex = np.zeros(nVertices)
    boundaryVertex[verticesOnEdge[boundaryEdge > 0].ravel()] = 1.0
    boundaryCell = np.zeros(nCells)
    boundaryCell[cellsOnEdge[boundaryEdge > 0, 0]] = 1.0

    # --- edge positions and lengths ---------------------------------------
    c1, c2 = cellsOnEdge[:, 0], cellsOnEdge[:, 1]
    v1, v2 = verticesOnEdge[:, 0], verticesOnEdge[:, 1]
    edge_xyz = np.where(interior[:, None],
                        geom.midpoint(cell_xyz[c1],
                                      cell_xyz[np.maximum(c2, 0)]),
                        geom.midpoint(vertex_xyz[v1], vertex_xyz[v2]))
    if on_sphere:
        edge_xyz = _normalize(edge_xyz)
    dvEdge = geom.distance(vertex_xyz[v1], vertex_xyz[v2])
    dcEdge = np.where(interior,
                      geom.distance(cell_xyz[c1], cell_xyz[np.maximum(c2, 0)]),
                      2.0 * geom.distance(cell_xyz[c1], edge_xyz))

    # --- areas -------------------------------------------------------------
    areaCell = np.zeros(nCells)
    for j in range(maxEdges):
        valid = j < nEdgesOnCell
        jn = (j + 1) % np.maximum(nEdgesOnCell, 1)
        va = verticesOnCell[np.arange(nCells), np.minimum(j, nEdgesOnCell - 1)]
        vb = verticesOnCell[np.arange(nCells), jn]
        tri = geom.tri_area(cell_xyz, vertex_xyz[va], vertex_xyz[vb])
        areaCell += np.where(valid, tri, 0.0)

    # kites: for vertex v = verticesOnCell[c, j] the kite is the quad (cell
    # centre, edge point j-1, vertex, edge point j)
    kite_cv = {}  # (v, c) -> kite area
    rows = np.repeat(np.arange(nCells), nEdgesOnCell)
    cols = np.concatenate([np.arange(n) for n in nEdgesOnCell])
    jprev = (cols - 1) % nEdgesOnCell[rows]
    vv = verticesOnCell[rows, cols]
    e_prev = edgesOnCell[rows, jprev]
    e_next = edgesOnCell[rows, cols]
    xc = cell_xyz[rows]
    xv = vertex_xyz[vv]
    xe_p = edge_xyz[e_prev]
    xe_n = edge_xyz[e_next]
    kite = np.abs(geom.tri_area(xc, xe_p, xv)) \
        + np.abs(geom.tri_area(xc, xv, xe_n))
    for (v, c, k) in zip(vv, rows, kite):
        kite_cv[(int(v), int(c))] = float(k)

    kiteAreasOnVertex = np.zeros((nVertices, vertexDegree))
    for i in range(vertexDegree):
        for v in range(nVertices):
            if cellsOnVertexMask[v, i] > 0:
                kiteAreasOnVertex[v, i] = kite_cv[(v, int(cellsOnVertex[v, i]))]
    areaTriangle = np.sum(kiteAreasOnVertex, axis=1)

    kiteAreasOnCell = np.zeros((nCells, maxEdges))
    kiteAreasOnCell[rows, cols] = kite

    # --- signs -------------------------------------------------------------
    cell_idx = np.arange(nCells)[:, None]
    edgeSignOnCell = np.where(
        eoc_valid,
        np.where(cellsOnEdge[edgesOnCell, 0] == cell_idx, 1.0, -1.0), 0.0)
    edgesOnCellMask = eoc_valid.astype(np.float64)

    vert_idx = np.arange(nVertices)[:, None]
    eov_valid = np.zeros((nVertices, vertexDegree), dtype=bool)
    for v in range(nVertices):
        eov_valid[v, :len(eov_lists[v])] = True
    edgeSignOnVertex = np.where(
        eov_valid,
        np.where(verticesOnEdge[edgesOnVertex, 1] == vert_idx, 1.0, -1.0), 0.0)

    # --- lat/lon and angleEdge --------------------------------------------
    def latlon(p):
        if not on_sphere:
            return np.zeros(p.shape[0]), np.zeros(p.shape[0])
        pn = _normalize(p)
        lat = np.arcsin(np.clip(pn[:, 2], -1.0, 1.0))
        lon = np.mod(np.arctan2(pn[:, 1], pn[:, 0]), 2.0 * np.pi)
        return lat, lon

    latCell, lonCell = latlon(cell_xyz)
    latEdge, lonEdge = latlon(edge_xyz)
    latVertex, lonVertex = latlon(vertex_xyz)

    # normal = unit displacement c1 -> c2 (interior) or c1 -> edge (boundary)
    tgt = np.where(interior[:, None], cell_xyz[np.maximum(c2, 0)], edge_xyz)
    if on_sphere:
        nvec = tgt - cell_xyz[c1]
        up = _normalize(edge_xyz)
        nvec = nvec - np.sum(nvec * up, axis=-1, keepdims=True) * up
    else:
        nvec = _wrap_disp(tgt - cell_xyz[c1], x_period, y_period)
    nvec = _normalize(nvec)
    e_east, e_north = geom.local_frame(edge_xyz)
    angleEdge = np.arctan2(np.sum(nvec * e_north, axis=-1),
                           np.sum(nvec * e_east, axis=-1))

    # --- TRiSK edgesOnEdge / weightsOnEdge --------------------------------
    edgesOnEdge = np.full((nEdges, maxEdges2), PAD, dtype=np.int64)
    weightsOnEdge = np.zeros((nEdges, maxEdges2))
    nEdgesOnEdge = np.zeros(nEdges, dtype=np.int64)
    # cell-assembled factorization of the same operator: triskM[c, p, i]
    # accumulates w(e_p, e_i) for edges of cell c
    triskM = np.zeros((nCells, maxEdges, maxEdges))
    edgeSlotOnCell = np.zeros((nEdges, 2), dtype=np.int64)

    def kite_of(v_arr, c_arr):
        out = np.zeros(v_arr.shape[0])
        for i in range(vertexDegree):
            hit = cellsOnVertex[v_arr, i] == c_arr
            out = np.where(hit & (cellsOnVertexMask[v_arr, i] > 0),
                           kiteAreasOnVertex[v_arr, i], out)
        return out

    eids = np.arange(nEdges)
    for side in range(2):
        c = cellsOnEdge[:, side]
        has = c >= 0
        cc = np.maximum(c, 0)
        nEC = nEdgesOnCell[cc]
        j0 = np.argmax(edgesOnCell[cc] == eids[:, None], axis=1)
        # s(c,e): +1 if c is the c1 of e (outward normal at e), -1 if c2
        s = np.where(side == 0, 1.0, -1.0) * np.ones(nEdges)
        R = np.zeros(nEdges)
        for j in range(1, maxEdges):
            valid = has & (j <= nEC - 1)
            jj = (j0 + j) % np.maximum(nEC, 1)
            ep = edgesOnCell[cc, jj]
            vv2 = verticesOnCell[cc, jj]
            R = np.where(valid, R + kite_of(vv2, cc)
                         / np.maximum(areaCell[cc], 1e-300), R)
            nsign = np.where(cellsOnEdge[ep, 0] == cc, 1.0, -1.0)
            w = s * (0.5 - R) * dvEdge[ep] / np.maximum(dcEdge, 1e-300) * nsign
            col = side * (maxEdges - 1) + (j - 1)
            edgesOnEdge[:, col] = np.where(valid, ep, PAD)
            weightsOnEdge[:, col] = np.where(valid, w, 0.0)
            nEdgesOnEdge += valid.astype(np.int64)
            sel = np.where(valid)[0]
            triskM[cc[sel], j0[sel], jj[sel]] = w[sel]
        edgeSlotOnCell[:, side] = np.where(has, j0, 0)

    # --- assemble ----------------------------------------------------------
    def r(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))

    def i(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))

    return Mesh(
        nCells=nCells, nEdges=nEdges, nVertices=nVertices,
        maxEdges=maxEdges, maxEdges2=maxEdges2, vertexDegree=vertexDegree,
        on_sphere=bool(on_sphere), sphere_radius=float(sphere_radius),
        x_period=float(x_period), y_period=float(y_period),
        cellsOnEdge=i(np.maximum(cellsOnEdge, 0)),
        verticesOnEdge=i(verticesOnEdge),
        edgesOnCell=i(edgesOnCell), nEdgesOnCell=i(nEdgesOnCell),
        cellsOnCell=i(cellsOnCell), verticesOnCell=i(verticesOnCell),
        cellsOnVertex=i(cellsOnVertex), edgesOnVertex=i(edgesOnVertex),
        edgesOnEdge=i(edgesOnEdge), nEdgesOnEdge=i(nEdgesOnEdge),
        edgesOnCellMask=r(edgesOnCellMask), edgeSignOnCell=r(edgeSignOnCell),
        edgeSignOnVertex=r(edgeSignOnVertex),
        cellsOnVertexMask=r(cellsOnVertexMask),
        boundaryEdge=r(boundaryEdge), boundaryCell=r(boundaryCell),
        boundaryVertex=r(boundaryVertex),
        xCell=r(cell_xyz[:, 0]), yCell=r(cell_xyz[:, 1]),
        zCell=r(cell_xyz[:, 2]),
        latCell=r(latCell), lonCell=r(lonCell),
        xEdge=r(edge_xyz[:, 0]), yEdge=r(edge_xyz[:, 1]),
        zEdge=r(edge_xyz[:, 2]),
        latEdge=r(latEdge), lonEdge=r(lonEdge),
        xVertex=r(vertex_xyz[:, 0]), yVertex=r(vertex_xyz[:, 1]),
        zVertex=r(vertex_xyz[:, 2]),
        latVertex=r(latVertex), lonVertex=r(lonVertex),
        dvEdge=r(dvEdge), dcEdge=r(dcEdge),
        areaCell=r(areaCell), areaTriangle=r(areaTriangle),
        kiteAreasOnVertex=r(kiteAreasOnVertex),
        kiteAreasOnCell=r(kiteAreasOnCell),
        angleEdge=r(angleEdge), weightsOnEdge=r(weightsOnEdge),
        triskM=r(triskM), edgeSlotOnCell=i(edgeSlotOnCell),
        meshDensity=r(np.ones(nCells)),
        divW=r(edgeSignOnCell * dvEdge[edgesOnCell]),
        keW=r(0.25 * edgesOnCellMask * (dcEdge * dvEdge)[edgesOnCell]),
        curlW=r(edgeSignOnVertex * dcEdge[edgesOnVertex]),
        invAreaCell=r(1.0 / areaCell),
        invAreaTriangle=r(1.0 / np.maximum(areaTriangle, 1e-300)),
        invDvEdge=r(1.0 / np.maximum(dvEdge, 1e-300)),
        invDcEdge=r(1.0 / np.maximum(dcEdge, 1e-300)),
        fEdge=r(np.zeros(nEdges)), fVertex=r(np.zeros(nVertices)),
        fCell=r(np.zeros(nCells)),
        meshScalingDel2=r(np.ones(nEdges)), meshScalingDel4=r(np.ones(nEdges)),
    )


def compute_mesh_scaling(mesh: Mesh, scale_with_mesh: bool = True) -> Mesh:
    """del2/del4 dissipation scaling from meshDensity.

    ref: atm_compute_mesh_scaling (mpas_atm_core.F:927-967) and sw
    compute_mesh_scaling (mpas_sw_core.F:347):
      del2 scale = ((rho(c1)+rho(c2))/2)^-0.25, del4 scale = ^-0.75,
    with meshDensity normalized so the finest region has rho = 1 (cell
    width ~ rho^-1/4). scale_with_mesh=False gives ones."""
    if not scale_with_mesh:
        return dataclasses.replace(
            mesh, meshScalingDel2=torch.ones_like(mesh.meshScalingDel2),
            meshScalingDel4=torch.ones_like(mesh.meshScalingDel4))
    rho = mesh.meshDensity.numpy().astype(np.float64)
    coe = mesh.cellsOnEdge.numpy()
    rho_e = 0.5 * (rho[coe[:, 0]] + rho[coe[:, 1]])
    dtype = mesh.meshScalingDel2.dtype
    return dataclasses.replace(
        mesh, meshScalingDel2=torch.from_numpy(rho_e ** -0.25).to(dtype),
        meshScalingDel4=torch.from_numpy(rho_e ** -0.75).to(dtype))
