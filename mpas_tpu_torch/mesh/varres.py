"""Variable-resolution SCVT meshes by density-weighted Lloyd iteration
(port of mpas_tpu/mesh/varres.py).

The reference reads variable-resolution meshes (e.g. the 60-15 km refined
mesh) generated offline by MPAS-Tools; the model only reads meshDensity
and scales its dissipation by it (ref: atm_compute_mesh_scaling,
mpas_atm_core.F:927). Here they are generated natively.

For a density rho on the sphere an SCVT equidistributes rho^(1/4) per cell
in two dimensions (Ringler, Ju & Gunzburger, Ocean Dyn. 2008), so the cell
width goes as rho^(-1/4) and a coarse/fine width ratio R needs a density
ratio R^4; meshDensity is normalized to 1 in the finest region. Each
weighted Lloyd iteration moves every generator to the rho-weighted
centroid of its Voronoi region. Host numpy and scipy, the same operations
in the same order as the reference, so that a seed gives the reference's
mesh bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.spatial import SphericalVoronoi

from mpas_tpu_torch.mesh.build import (_normalize, _sphere_tri_area,
                                       compute_mesh_scaling)
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.mesh.sphere import icosphere_points, sphere_voronoi_mesh


def circular_refinement_density(center_lat: float, center_lon: float,
                                radius: float, width: float,
                                ratio: float = 4.0):
    """Density of a circular refinement region: 1 (finest) inside the
    great-circle cap of `radius` radians around the centre, falling to
    (1/ratio)^4 outside across a tanh band of `width` radians; ratio is the
    coarse/fine cell width (60/15 = 4)."""
    cx = np.array([np.cos(center_lat) * np.cos(center_lon),
                   np.cos(center_lat) * np.sin(center_lon),
                   np.sin(center_lat)])
    rho_min = float(ratio) ** -4.0

    def rho(pts):
        pts = _normalize(np.asarray(pts, dtype=np.float64))
        dist = np.arccos(np.clip(pts @ cx, -1.0, 1.0))
        t = 0.5 * (1.0 - np.tanh((dist - radius) / max(width, 1e-6)))
        return rho_min + (1.0 - rho_min) * t

    return rho


def sample_points_by_density(n: int, rho, seed: int = 0):
    """n initial generators: a quasi-uniform icosphere shell (~15% of n)
    that keeps the coarse region structured, the rest drawn from
    numpy.random.default_rng(seed) by rejection sampling with acceptance
    rho^(1/2) (between uniform and the full density; the Lloyd iteration
    sets the final distribution)."""
    rng = np.random.default_rng(seed)
    pts = []
    base = icosphere_points(max(2, int(np.sqrt(0.15 * n / 10.0))))
    need = n - base.shape[0]
    while need > 0:
        cand = _normalize(rng.normal(size=(4 * max(need, 256), 3)))
        p = rho(cand) ** 0.5
        keep = rng.uniform(size=cand.shape[0]) < p / p.max()
        cand = cand[keep][:need]
        if cand.size:
            pts.append(cand)
            need -= cand.shape[0]
    return np.concatenate([base] + pts, axis=0) if pts else base


def weighted_lloyd(points, rho, iterations: int = 25):
    """Density-weighted Lloyd relaxation: each generator moves to the
    rho-weighted centroid of its region, integrated over the triangle fan
    about the generator with rho at the triangle centroids."""
    pts = _normalize(np.asarray(points, dtype=np.float64))
    for _ in range(iterations):
        sv = SphericalVoronoi(pts, radius=1.0, threshold=1e-10)
        sv.sort_vertices_of_regions()
        # every region's triangle fan, flattened into one pass
        lens = np.array([len(r) for r in sv.regions], dtype=np.int64)
        cells = np.repeat(np.arange(pts.shape[0]), lens)
        flat = np.concatenate(sv.regions).astype(np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
        pos = np.arange(flat.shape[0]) - np.repeat(offs, lens)
        nxt_pos = np.where(pos + 1 < np.repeat(lens, lens), pos + 1, 0)
        nxt = flat[np.repeat(offs, lens) + nxt_pos]
        v1 = sv.vertices[flat]
        v2 = sv.vertices[nxt]
        gen = pts[cells]
        a = np.abs(_sphere_tri_area(gen, v1, v2))
        cent = _normalize(gen + v1 + v2)
        w = (a * rho(cent))[:, None]
        new = np.zeros_like(pts)
        np.add.at(new, cells, w * cent)
        pts = _normalize(new)
    return pts


def variable_res_mesh(n_points: int, rho=None, iterations: int = 25,
                      seed: int = 0, scale_with_mesh: bool = True,
                      ratio: float = 4.0) -> Mesh:
    """Variable-resolution unit-sphere SCVT Mesh.

    rho defaults to a 4:1 (60-15 km style) circular refinement centred at
    (30N, 90E) with a cap radius of 30 degrees. meshDensity is rho at the
    cell centres normalized to max 1; meshScalingDel2/4 follow from it
    (compute_mesh_scaling)."""
    if rho is None:
        rho = circular_refinement_density(
            center_lat=np.pi / 6.0, center_lon=np.pi / 2.0,
            radius=np.pi / 6.0, width=np.pi / 18.0, ratio=ratio)
    pts = sample_points_by_density(n_points, rho, seed=seed)
    pts = weighted_lloyd(pts, rho, iterations=iterations)
    mesh = sphere_voronoi_mesh(pts, merge_tol=0.2)
    density = rho(np.stack([mesh.xCell.numpy(), mesh.yCell.numpy(),
                            mesh.zCell.numpy()], axis=-1))
    mesh = dataclasses.replace(
        mesh, meshDensity=torch.from_numpy(density / density.max()))
    return compute_mesh_scaling(mesh, scale_with_mesh)
