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

import itertools

import numpy as np
from scipy.spatial import SphericalVoronoi

from benchmark.reference.mesh.build import (_normalize, _sphere_tri_area,
                                           build_mesh, by_length, padded,
                                           ragged_index)
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
    """10*n^2 + 2 quasi-uniform points from an n-fold subdivided icosahedron:
    the points (n-i-j) A + i B + j C of each face (A, B, C) for i = 0..n,
    j = 0..n-i, normalised; a point that an earlier face or (i, j) already
    gave (the same to 1e-10) is kept once, in the order first met."""
    verts = icosahedron_vertices()
    faces = np.asarray(_icosahedron_faces(verts))
    i, j = ragged_index(np.arange(n + 1, 0, -1))
    w = np.stack([n - i - j, i, j], axis=-1).astype(np.float64)[None, :, :,
                                                               None]
    A, B, C = (verts[faces[:, k]][:, None] for k in range(3))
    pts = _normalize((w[:, :, 0] * A + w[:, :, 1] * B + w[:, :, 2] * C)
                     .reshape(-1, 3))
    key = np.round(pts * 1e10).astype(np.int64)
    _, first = np.unique(key, axis=0, return_index=True)
    pts = pts[np.sort(first)]
    if pts.shape[0] != 10 * n * n + 2:
        raise RuntimeError(f"icosphere({n}) produced {pts.shape[0]} points")
    return pts


def _ragged(regions):
    """(flat int64, lengths) of a list of index lists."""
    lengths = np.fromiter(map(len, regions), dtype=np.int64,
                          count=len(regions))
    flat = np.fromiter(itertools.chain.from_iterable(regions),
                       dtype=np.int64, count=int(lengths.sum()))
    return flat, lengths


def lloyd_relax(points, iterations: int = 0):
    """Lloyd iterations toward an SCVT: move generators to region centroids."""
    pts = _normalize(np.asarray(points, dtype=np.float64))
    for _ in range(iterations):
        sv = SphericalVoronoi(pts, radius=1.0, threshold=1e-10)
        sv.sort_vertices_of_regions()
        flat, lengths = _ragged(sv.regions)
        regions = padded(flat, lengths)
        new = np.empty_like(pts)
        for n, rows in by_length(lengths):
            ring = sv.vertices[regions[rows, :n]]
            nxt = np.roll(ring, -1, axis=1)
            # area-weighted centroid from the triangle fan about the
            # generator, the triangles summed one after another
            a = _sphere_tri_area(pts[rows][:, None], ring, nxt)
            tri_cent = pts[rows][:, None] + ring + nxt
            new[rows] = np.sum(np.abs(a)[..., None] * tri_cent, axis=1)
        pts = _normalize(new)
    return pts


def sphere_voronoi_mesh(points) -> Mesh:
    """Unit-sphere Voronoi Mesh from generator points. Voronoi vertices that
    coincide (symmetric configurations: the same to 1e-9) are merged into
    one, at their normalised sum, and a ring keeps a merged vertex once."""
    pts = _normalize(np.asarray(points, dtype=np.float64))
    sv = SphericalVoronoi(pts, radius=1.0, threshold=1e-10)
    sv.sort_vertices_of_regions()

    # each vertex stands for the first with its rounded position
    key = np.round(sv.vertices * 1e9).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    uniq, remap = np.unique(first[inv.reshape(-1)], return_inverse=True)
    vxyz = np.zeros((uniq.size, 3))
    np.add.at(vxyz, remap, sv.vertices)
    vxyz = _normalize(vxyz)

    flat, lengths = _ragged(sv.regions)
    ring = remap[flat]
    # collapse merge-repeated neighbours (incl. wraparound)
    cell, k = ragged_index(lengths)
    at = np.arange(ring.size)
    prev = np.where(k == 0, at + lengths[cell] - 1, at - 1)
    keep = ring != ring[prev]
    kept = np.bincount(cell[keep], minlength=lengths.size)
    return build_mesh(pts, vxyz, (ring[keep], kept), sphere_radius=1.0)


def icosahedral_mesh(n: int, lloyd_iters: int = 4) -> Mesh:
    """Quasi-uniform icosahedral SCVT mesh with 10*n^2+2 cells, unit radius.

    n=8 -> 642 cells; n=64 -> 40962 (~120 km at Earth radius)."""
    pts = icosphere_points(n)
    pts = lloyd_relax(pts, lloyd_iters)
    return sphere_voronoi_mesh(pts)
