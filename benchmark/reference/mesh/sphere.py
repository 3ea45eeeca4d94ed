# Frozen copy of mpas_tpu_torch/mesh/sphere.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Spherical centroidal Voronoi meshes of the icosahedral family
(port of mpas_tpu/mesh/sphere.py).

Cells are the generators of a spherical Voronoi diagram: a subdivided
icosahedron (10*n^2+2 generators), Lloyd-relaxed toward a spherical
centroidal Voronoi tessellation (Ringler et al. 2008 SCVT grids). n=64
gives the 40,962-cell (~120 km) mesh. Host numpy + scipy.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import SphericalVoronoi, cKDTree

from benchmark.reference.mesh.build import _normalize, _sphere_tri_area, build_mesh
from benchmark.reference.mesh.mesh import Mesh


def icosahedron_vertices():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = []
    for s1 in (-1.0, 1.0):
        for s2 in (-phi, phi):
            v.append((0.0, s1, s2))
            v.append((s1, s2, 0.0))
            v.append((s2, 0.0, s1))
    return _normalize(np.asarray(sorted(set(v))))


def _icosahedron_faces(verts):
    """20 triangular faces as vertex index triples (by nearest-neighbor)."""
    n = len(verts)
    d = verts @ verts.T
    nbr = np.argsort(-d, axis=1)[:, 1:6]
    faces = set()
    for i in range(n):
        for j in nbr[i]:
            for k in nbr[j]:
                if k in nbr[i] and i < j < k:
                    faces.add((i, int(j), int(k)))
    if len(faces) != 20:
        raise RuntimeError(f"expected 20 icosahedron faces, got {len(faces)}")
    return sorted(faces)


def icosphere_points(n: int):
    """10*n^2 + 2 quasi-uniform points from an n-fold subdivided icosahedron."""
    verts = icosahedron_vertices()
    faces = _icosahedron_faces(verts)
    key_to_id = {}
    pts = []

    def add(p):
        key = tuple(np.round(p * 1e10).astype(np.int64))
        pid = key_to_id.get(key)
        if pid is None:
            pid = len(pts)
            key_to_id[key] = pid
            pts.append(p)
        return pid

    for (ia, ib, ic) in faces:
        A, B, C = verts[ia], verts[ib], verts[ic]
        for i in range(n + 1):
            for j in range(n + 1 - i):
                add(_normalize((n - i - j) * A + i * B + j * C))
    pts = np.asarray(pts)
    if pts.shape[0] != 10 * n * n + 2:
        raise RuntimeError(f"icosphere({n}) produced {pts.shape[0]} points")
    return pts


def lloyd_relax(points, iterations: int = 0):
    """Lloyd iterations toward an SCVT: move generators to region centroids."""
    pts = _normalize(np.asarray(points, dtype=np.float64))
    for _ in range(iterations):
        sv = SphericalVoronoi(pts, radius=1.0, threshold=1e-10)
        sv.sort_vertices_of_regions()
        new = np.empty_like(pts)
        for c, region in enumerate(sv.regions):
            ring = sv.vertices[region]
            # area-weighted centroid from the triangle fan about the generator
            a = _sphere_tri_area(pts[c][None], ring, np.roll(ring, -1, axis=0))
            tri_cent = pts[c][None] + ring + np.roll(ring, -1, axis=0)
            w = np.abs(a)[:, None]
            new[c] = np.sum(w * tri_cent, axis=0)
        pts = _normalize(new)
    return pts


def sphere_voronoi_mesh(points, merge_tol: float = 0.0) -> Mesh:
    """Unit-sphere Voronoi Mesh from generator points. Voronoi vertices that
    coincide (symmetric configurations) are merged into one.

    merge_tol > 0 also merges Voronoi vertices closer than merge_tol x the
    local circumradius (distance to the nearest generator): near-cocircular
    generator quadruples, common on variable-resolution SCVTs, otherwise
    leave edges of near-zero dvEdge, whose 1/dvEdge rides the pv and
    circulation stencils. A merged vertex sits at its cluster's centroid."""
    pts = _normalize(np.asarray(points, dtype=np.float64))
    sv = SphericalVoronoi(pts, radius=1.0, threshold=1e-10)
    sv.sort_vertices_of_regions()

    nv = len(sv.vertices)
    parent = np.arange(nv, dtype=np.int64)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    key_to_id = {}
    for i, p in enumerate(sv.vertices):
        key = tuple(np.round(p * 1e9).astype(np.int64))
        j = key_to_id.setdefault(key, i)
        if j != i:
            parent[find(i)] = find(j)

    if merge_tol > 0.0:
        circum, _ = cKDTree(pts).query(sv.vertices, k=1)
        vtree = cKDTree(sv.vertices)
        for i, j in vtree.query_pairs(merge_tol * float(np.max(circum))):
            d = np.linalg.norm(sv.vertices[i] - sv.vertices[j])
            if d <= merge_tol * min(circum[i], circum[j]):
                parent[find(i)] = find(j)

    roots = np.array([find(i) for i in range(nv)], dtype=np.int64)
    uniq, remap = np.unique(roots, return_inverse=True)
    vxyz = np.zeros((uniq.size, 3))
    np.add.at(vxyz, remap, sv.vertices)
    vxyz = _normalize(vxyz)

    vertices_on_cell = []
    for region in sv.regions:
        ring = [int(remap[v]) for v in region]
        # collapse merge-repeated neighbours (incl. wraparound)
        ring = [v for k, v in enumerate(ring) if v != ring[k - 1]]
        vertices_on_cell.append(ring)

    return build_mesh(pts, vxyz, vertices_on_cell, sphere_radius=1.0)


def icosahedral_mesh(n: int, lloyd_iters: int = 4) -> Mesh:
    """Quasi-uniform icosahedral SCVT mesh with 10*n^2+2 cells, unit radius.

    n=8 -> 642 cells; n=64 -> 40962 (~120 km at Earth radius)."""
    pts = icosphere_points(n)
    pts = lloyd_relax(pts, lloyd_iters)
    return sphere_voronoi_mesh(pts)
