"""Planar hexagonal Voronoi meshes: doubly periodic, channel and box
(port of mpas_tpu/mesh/planar.py).

Stands in for the external MPAS-Tools planar_hex generator of the
reference's planar configurations (idealized supercell, ocean baroclinic
channel). The periodic Voronoi diagram of the generators is taken from a
3x3 tiling, with vertices identified modulo the periods; walls come from
culling cell rows. Host numpy + scipy; the result is a Mesh of CPU
tensors from mesh.build.build_mesh.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Voronoi

from mpas_tpu_torch.mesh.build import build_mesh
from mpas_tpu_torch.mesh.mesh import Mesh


def hex_lattice_points(nx: int, ny: int, dc: float):
    """Cell centres of an nx-by-ny hex lattice with spacing dc.

    Row j is offset by dc/2 for odd j (ny must be even for y-periodicity).
    Periods: x_period = nx*dc, y_period = ny*dc*sqrt(3)/2."""
    if ny % 2 != 0:
        raise ValueError("ny must be even for a periodic hex lattice")
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    x = (ii + 0.5 * (jj % 2)) * dc
    y = jj * (dc * np.sqrt(3.0) / 2.0)
    return np.stack([x.ravel(), y.ravel()], axis=-1)


def _planar_topology(points_xy, x_period: float, y_period: float):
    """Raw (cell_xyz, vertex_xyz, vertices_on_cell) of the periodic Voronoi
    diagram of the generators."""
    pts = np.asarray(points_xy, dtype=np.float64)
    n = pts.shape[0]
    tiles = [pts + np.array([dx * x_period, dy * y_period])
             for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    # central copy first, so point indices 0..n-1 are the real cells
    order = [4, 0, 1, 2, 3, 5, 6, 7, 8]
    vor = Voronoi(np.concatenate([tiles[k] for k in order], axis=0))

    # one vertex id per position modulo the periods
    tol = 1e-8 * max(x_period, y_period)
    vkey_to_id = {}
    vxy = []

    def vertex_id(p):
        x = np.mod(p[0], x_period)
        y = np.mod(p[1], y_period)
        # snap coordinates just below a period onto the seam at 0
        if x_period - x < tol:
            x = 0.0
        if y_period - y < tol:
            y = 0.0
        key = (round(x / tol), round(y / tol))
        vid = vkey_to_id.get(key)
        if vid is None:
            vid = len(vxy)
            vkey_to_id[key] = vid
            vxy.append((x, y))
        return vid

    vertices_on_cell = []
    for c in range(n):
        region = vor.regions[vor.point_region[c]]
        if -1 in region or len(region) < 3:
            raise RuntimeError("open Voronoi region in periodic mesh build")
        ring_pts = vor.vertices[region]
        # angle-sort around the generator (cells are convex)
        d = ring_pts - pts[c]
        ring_pts = ring_pts[np.argsort(np.arctan2(d[:, 1], d[:, 0]))]
        vertices_on_cell.append([vertex_id(p) for p in ring_pts])

    vxyz = np.zeros((len(vxy), 3))
    vxyz[:, :2] = np.asarray(vxy)
    cxyz = np.zeros((n, 3))
    cxyz[:, :2] = np.mod(pts, [x_period, y_period])
    return cxyz, vxyz, vertices_on_cell


def planar_voronoi_mesh(points_xy, x_period: float,
                        y_period: float) -> Mesh:
    """Doubly periodic planar Voronoi Mesh from generator points."""
    cxyz, vxyz, voc = _planar_topology(points_xy, x_period, y_period)
    return build_mesh(cxyz, vxyz, voc, on_sphere=False,
                      x_period=x_period, y_period=y_period)


def cull_cells(cell_xyz, vertex_xyz, vertices_on_cell, keep):
    """Drop the cells where keep is False, remove orphaned vertices and
    renumber. Edges left with one cell become boundary edges when the
    topology is built (MPAS-Tools' MpasCellCuller for channel meshes)."""
    keep = np.asarray(keep, dtype=bool)
    voc_new = [vertices_on_cell[c] for c in range(len(keep)) if keep[c]]
    used = sorted({int(v) for ring in voc_new for v in ring})
    vmap = {v: i for i, v in enumerate(used)}
    voc_new = [[vmap[int(v)] for v in ring] for ring in voc_new]
    return cell_xyz[keep], vertex_xyz[used], voc_new


def channel_hex_mesh(nx: int, ny: int, dc: float) -> Mesh:
    """Hex mesh periodic in x with solid walls in y (top and bottom cell
    rows culled): the ocean baroclinic-channel domain."""
    pts = hex_lattice_points(nx, ny, dc)
    Lx, Ly = nx * dc, ny * dc * np.sqrt(3.0) / 2.0
    cxyz, vxyz, voc = _planar_topology(pts, Lx, Ly)
    row = np.arange(nx * ny) // nx
    keep = (row > 0) & (row < ny - 1)
    cxyz, vxyz, voc = cull_cells(cxyz, vxyz, voc, keep)
    return build_mesh(cxyz, vxyz, voc, on_sphere=False,
                      x_period=Lx, y_period=0.0)


def box_hex_mesh(nx: int, ny: int, dc: float) -> Mesh:
    """Hex mesh with solid walls on all four sides (outermost cell ring
    culled): the closed square domain of the sea-ice box experiment."""
    pts = hex_lattice_points(nx, ny, dc)
    Lx, Ly = nx * dc, ny * dc * np.sqrt(3.0) / 2.0
    cxyz, vxyz, voc = _planar_topology(pts, Lx, Ly)
    idx = np.arange(nx * ny)
    row, col = idx // nx, idx % nx
    keep = (row > 0) & (row < ny - 1) & (col > 0) & (col < nx - 1)
    cxyz, vxyz, voc = cull_cells(cxyz, vxyz, voc, keep)
    return build_mesh(cxyz, vxyz, voc, on_sphere=False,
                      x_period=0.0, y_period=0.0)


def planar_hex_mesh(nx: int, ny: int, dc: float) -> Mesh:
    """Uniform doubly periodic hexagonal mesh (nx*ny cells, spacing dc)."""
    pts = hex_lattice_points(nx, ny, dc)
    return planar_voronoi_mesh(pts, nx * dc, ny * dc * np.sqrt(3.0) / 2.0)
