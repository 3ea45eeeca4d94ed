"""Geometry utilities on the sphere and the plane (port of
mpas_tpu/ops/geometry.py).

ref: src/operators/mpas_geometry_utils.F — spherical arcs, angles and
areas, Wachspress barycentric coordinates (:1246), the point-location walk
(:1026). The array functions take and return torch tensors (the last axis
of a point is its 3 coordinates); the walk runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def sphere_distance(lat1, lon1, lat2, lon2, radius=1.0):
    """Great-circle distance (ref: mpas_sphere_distance, haversine form)."""
    arg = torch.sqrt(torch.sin(0.5 * (lat2 - lat1)) ** 2
                     + torch.cos(lat1) * torch.cos(lat2)
                     * torch.sin(0.5 * (lon2 - lon1)) ** 2)
    return 2.0 * radius * torch.arcsin(torch.clamp(arg, -1.0, 1.0))


def arc_length(p, q):
    """Arc length between unit vectors (last axis 3)."""
    cr = torch.linalg.norm(torch.linalg.cross(p, q), dim=-1)
    dt = torch.sum(p * q, dim=-1)
    return torch.arctan2(cr, dt)


def sphere_angle(a, b, c):
    """Angle at vertex a of the spherical triangle (a, b, c)
    (ref: sphere_angle in several reference files)."""
    ab = torch.linalg.cross(a, b)
    ac = torch.linalg.cross(a, c)
    nab = ab / torch.clamp(torch.linalg.norm(ab, dim=-1, keepdim=True),
                           min=1e-30)
    nac = ac / torch.clamp(torch.linalg.norm(ac, dim=-1, keepdim=True),
                           min=1e-30)
    cosang = torch.clamp(torch.sum(nab * nac, dim=-1), -1.0, 1.0)
    return torch.arccos(cosang)


def triangle_signed_area_sphere(p1, p2, p3):
    """Signed spherical excess, counter-clockwise positive seen from
    outside (ref: mpas_triangle_signed_area_sphere)."""
    num = torch.sum(p1 * torch.linalg.cross(p2, p3), dim=-1)
    den = 1.0 + torch.sum(p1 * p2, dim=-1) + torch.sum(p2 * p3, dim=-1) \
        + torch.sum(p3 * p1, dim=-1)
    return 2.0 * torch.arctan2(num, den)


def _tri_area(a, b, c):
    return 0.5 * ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                  - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def wachspress_coordinates(vertices, point):
    """Wachspress barycentric coordinates of `point` inside the convex
    polygon `vertices` (n, 2 or 3; planar) — ref: mpas_wachspress_coordinates
    (:1246); used by the sea-ice variational velocity solver.

    Planar formula: w_i = A(prev,i,next) / (A(prev,i,p) * A(i,next,p)),
    normalized."""
    v = torch.as_tensor(vertices)
    p = torch.as_tensor(point, dtype=v.dtype, device=v.device)
    prev = torch.roll(v, 1, dims=0)
    nxt = torch.roll(v, -1, dims=0)
    w = _tri_area(prev, v, nxt) / (_tri_area(prev, v, p[None, :])
                                   * _tri_area(v, nxt, p[None, :]))
    return w / torch.sum(w)


def point_in_cell_walk(mesh, point_xyz, start_cell: int = 0,
                       max_steps: int = 200):
    """Host-side point-location walk: step to the neighbour closest to the
    target until converged (ref: mpas_get_cell_point_walk :1026)."""
    cxyz = np.stack([np.asarray(mesh.xCell), np.asarray(mesh.yCell),
                     np.asarray(mesh.zCell)], -1)
    coc = np.asarray(mesh.cellsOnCell)
    nEoC = np.asarray(mesh.nEdgesOnCell)
    p = np.asarray(point_xyz, dtype=float)
    c = int(start_cell)
    for _ in range(max_steps):
        nbrs = coc[c, :nEoC[c]]
        cand = np.concatenate([[c], nbrs])
        d = np.linalg.norm(cxyz[cand] - p, axis=1)
        best = cand[int(np.argmin(d))]
        if best == c:
            return c
        c = int(best)
    return c
