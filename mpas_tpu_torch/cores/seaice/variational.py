"""Variational (Wachspress or PWL basis) sea-ice velocity discretization
(port of mpas_tpu/cores/seaice/variational.py).

ref: src/core_seaice/shared/mpas_seaice_velocity_solver_variational.F +
..._wachspress.F + ..._pwl.F + ..._velocity_solver_variational_shared.F:
strains evaluated AT cell corners from basis-function derivatives; the
stress divergence at a vertex comes from the variational principle,
F_u(v) = -(1/A_v) sum_cells sum_corners [ s11 * Sx + s12 * Sy ] with basis
integrals S{x,y}[cell, j, k] = int_cell phi_j d(phi_k)/d{x,y} dA (ref
basisIntegralsU/V + variationalDenominator).

The host build evaluates the basis for every cell of one polygon size at
once (cells batched by nEdgesOnCell, in chunks), in numpy: the reference
loops over cells in Python, which takes minutes at 40,000 cells. The fan
quadrature accumulates in the reference's order (triangle, then
quadrature point). The device path is gathers and einsums: strains per
corner, divergence per vertex, no scatter. Per-cell local coordinates make
this exact on planar meshes; on the sphere each cell is projected onto its
tangent plane.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mpas_tpu_torch.containers import to_device, to_host
from mpas_tpu_torch.mesh.mesh import Mesh

CHUNK = 4096   # cells a batch of the host build evaluates at once


@dataclasses.dataclass(frozen=True)
class VariationalCoeffs:
    # basis derivative values at corners: D{x,y}[c, j, k] = d(phi_k)/d{x,y}
    # evaluated at corner j of cell c
    dx: Any                 # (nCells, mE, mE)
    dy: Any                 # (nCells, mE, mE)
    # basis integrals S{x,y}[c, j, k] = int phi_j d(phi_k)/d{x,y} dA
    sx: Any                 # (nCells, mE, mE)
    sy: Any                 # (nCells, mE, mE)
    mass: Any               # (nCells, mE) int phi_j dA
    # vertex stencil: for vertex v and adjacent cell slot i
    cell_on_v: Any          # (nVertices, vertexDegree) cell index
    corner_on_v: Any        # (nVertices, vertexDegree) local corner of v
    valid_on_v: Any         # (nVertices, vertexDegree) 1/0
    area_v: Any             # (nVertices,) variational denominator

    def to(self, device, dtype) -> "VariationalCoeffs":
        return to_device(self, device, dtype)


def _tri(a, b, c):
    """Signed area of triangles (a, b, c), points in the last axis."""
    return 0.5 * ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                  - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))


def _wachspress(verts, p):
    """Wachspress basis of B convex n-gons verts (B, n, 2) at points
    p (B, P, 2): (phi (B, P, n), grad phi (B, P, n, 2)).
    w_i = A(v_i-1, v_i, v_i+1) prod_{j != i-1, i} A(v_j, v_j+1, p)."""
    n = verts.shape[1]
    prev = np.roll(verts, 1, axis=1)
    nxt = np.roll(verts, -1, axis=1)
    a_full = _tri(prev, verts, nxt)                        # (B, n)
    a_edge = _tri(verts[:, None], nxt[:, None], p[:, :, None])  # (B, P, n)
    ga_edge = 0.5 * np.stack([verts[..., 1] - nxt[..., 1],
                              nxt[..., 0] - verts[..., 0]], -1)  # (B, n, 2)

    def prod(ks):
        """prod_k A_k(p), multiplied in the reference's (ascending) order."""
        if not ks:
            return np.ones(a_edge.shape[:2])
        out = a_edge[..., ks[0]]
        for k in ks[1:]:
            out = out * a_edge[..., k]
        return out

    w = np.empty(a_edge.shape)
    gw = np.empty(a_edge.shape + (2,))
    for i in range(n):
        # the edges of w_i's product: all but i-1 and i
        kept = [j for j in range(n) if j not in (i, (i - 1) % n)]
        w[..., i] = a_full[:, None, i] * prod(kept)
        # gradient of the product, one included edge j at a time:
        # g += grad A_j prod_{k kept, k != j} A_k
        g = np.zeros(a_edge.shape[:2] + (2,))
        for j in kept:
            g = g + ga_edge[:, None, j] \
                * prod([k for k in kept if k != j])[..., None]
        gw[..., i, :] = a_full[:, None, i, None] * g
    wsum = w.sum(-1)
    gsum = gw.sum(-2)
    phi = w / wsum[..., None]
    gphi = gw / wsum[..., None, None] \
        - w[..., None] * gsum[..., None, :] / (wsum * wsum)[..., None, None]
    return phi, gphi


def _pwl(verts, p):
    """Piecewise-linear basis of B convex n-gons at points p (ref:
    mpas_seaice_velocity_solver_pwl.F): the cell is fanned into
    subtriangles from the vertex-average centre; basis function j is the
    linear interpolant of {1 at corner j, 0 at the other corners, 1/n at
    the centre} on the subtriangle whose smallest barycentric coordinate
    at p is largest (the first such)."""
    B, n = verts.shape[:2]
    center = verts.mean(axis=1)                            # (B, 2)
    cval = 1.0 / n
    lams, tinvs = [], []
    scores = np.empty((B, p.shape[1], n))
    for k in range(n):
        b, c = verts[:, k], verts[:, (k + 1) % n]
        T = np.stack([np.stack([b[:, 0] - center[:, 0],
                                c[:, 0] - center[:, 0]], -1),
                      np.stack([b[:, 1] - center[:, 1],
                                c[:, 1] - center[:, 1]], -1)], -2)
        degenerate = np.abs(np.linalg.det(T)) < 1e-30
        Tinv = np.linalg.inv(np.where(degenerate[:, None, None],
                                      np.eye(2), T))
        lam = np.matmul(Tinv[:, None], (p - center[:, None])[..., None])
        l1, l2 = lam[..., 0, 0], lam[..., 1, 0]
        l0 = 1.0 - l1 - l2
        score = np.minimum(np.minimum(l0, l1), l2)
        scores[..., k] = np.where(degenerate[:, None], -np.inf, score)
        lams.append(np.stack([l0, l1, l2], -1))
        tinvs.append(Tinv)
    k = np.argmax(scores, axis=-1)                         # (B, P)
    lam = np.take_along_axis(np.stack(lams, -2), k[..., None, None],
                             -2)[..., 0, :]                # (B, P, 3)
    tinv = np.stack(tinvs, 1)[np.arange(B)[:, None], k]    # (B, P, 2, 2)
    g1, g2 = tinv[..., 0, :], tinv[..., 1, :]
    g0 = -(g1 + g2)
    on_k = (np.arange(n) == k[..., None]).astype(np.float64)
    on_k2 = (np.arange(n) == ((k + 1) % n)[..., None]).astype(np.float64)
    phi = cval * lam[..., 0:1] + on_k * lam[..., 1:2] + on_k2 * lam[..., 2:3]
    grad = (cval * g0)[..., None, :] + on_k[..., None] * g1[..., None, :] \
        + on_k2[..., None] * g2[..., None, :]
    return phi, grad


# 6-point degree-4 Dunavant quadrature on the unit triangle
_QP = np.array([
    [0.44594849091597, 0.44594849091597],
    [0.44594849091597, 0.10810301816807],
    [0.10810301816807, 0.44594849091597],
    [0.09157621350977, 0.09157621350977],
    [0.09157621350977, 0.81684757298046],
    [0.81684757298046, 0.09157621350977]])
_QW = np.array([0.22338158967801, 0.22338158967801, 0.22338158967801,
                0.10995174365532, 0.10995174365532, 0.10995174365532])


def _local_vertices(m, cells, n, voc, xv, yv, zv, xc, yc, zc, lat, lon):
    """(B, n, 2) corner coordinates of `cells` (all n-gons) in each cell's
    local frame: the tangent plane at the centre on the sphere, the
    periodic-wrapped offsets on the plane."""
    vids = voc[cells, :n]                                  # (B, n)
    if m.on_sphere:
        lo, la = lon[cells], lat[cells]
        east = np.stack([-np.sin(lo), np.cos(lo), np.zeros_like(lo)], -1)
        north = np.stack([-np.sin(la) * np.cos(lo), -np.sin(la) * np.sin(lo),
                          np.cos(la)], -1)
        rel = np.stack([xv[vids] - xc[cells][:, None],
                        yv[vids] - yc[cells][:, None],
                        zv[vids] - zc[cells][:, None]], -1)   # (B, n, 3)
        # one matmul per cell, as the reference's rel @ east: the PWL
        # basis picks its subtriangle by a comparison that a last-bit
        # difference in a corner's coordinates can flip
        return np.stack([np.matmul(rel, east[..., None])[..., 0],
                         np.matmul(rel, north[..., None])[..., 0]], -1)
    vx = xv[vids] - xc[cells][:, None]
    vy = yv[vids] - yc[cells][:, None]
    if m.x_period > 0:
        vx = (vx + 0.5 * m.x_period) % m.x_period - 0.5 * m.x_period
    if m.y_period > 0:
        vy = (vy + 0.5 * m.y_period) % m.y_period - 0.5 * m.y_period
    return np.stack([vx, vy], -1)


def build_variational_coeffs(mesh: Mesh,
                             basis: str = "wachspress") -> VariationalCoeffs:
    """Host-side precompute (ref: seaice_init_velocity_solver_variational
    + the Wachspress/PWL basis and integral setup,
    config_variational_basis = 'wachspress'|'pwl'). The result lies on
    the mesh's device in its float dtype."""
    m = mesh
    nC, mE = m.nCells, m.maxEdges
    voc = to_host(m.verticesOnCell)
    nEoC = to_host(m.nEdgesOnCell)
    geo = [to_host(getattr(m, k)).astype(np.float64) for k in (
        "xVertex", "yVertex", "zVertex", "xCell", "yCell", "zCell",
        "latCell", "lonCell")]
    wg = _pwl if basis == "pwl" else _wachspress

    dx = np.zeros((nC, mE, mE))
    dy = np.zeros((nC, mE, mE))
    sx = np.zeros((nC, mE, mE))
    sy = np.zeros((nC, mE, mE))
    mass = np.zeros((nC, mE))
    for n in np.unique(nEoC):
        n = int(n)
        group = np.nonzero(nEoC == n)[0]
        for s in range(0, len(group), CHUNK):
            cells = group[s:s + CHUNK]
            verts = _local_vertices(m, cells, n, voc, *geo)   # (B, n, 2)
            centroid = verts.mean(axis=1)                     # (B, 2)
            # derivatives at corners (nudged slightly inward: Wachspress
            # gradients are singular exactly at the corners)
            corners = verts + 1e-6 * (centroid[:, None] - verts)
            _, g = wg(verts, corners)                         # (B, n, n, 2)
            dx[cells, :n, :n] = g[..., 0]
            dy[cells, :n, :n] = g[..., 1]
            # integrals by fan-triangulation quadrature from the centroid,
            # accumulated triangle by triangle, point by point
            a = verts                                         # (B, n, 2)
            b = np.roll(verts, -1, axis=1)
            c = centroid[:, None]
            area2 = ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                     - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))
            pts = (a[:, :, None] + _QP[None, None, :, 0:1]
                   * (b - a)[:, :, None]
                   + _QP[None, None, :, 1:2] * (c - a)[:, :, None])
            phi, g = wg(verts, pts.reshape(len(cells), n * len(_QW), 2))
            phi = phi.reshape(len(cells), n, len(_QW), n)
            g = g.reshape(len(cells), n, len(_QW), n, 2)
            sxb = np.zeros((len(cells), n, n))
            syb = np.zeros((len(cells), n, n))
            mb = np.zeros((len(cells), n))
            for j in range(n):
                for q, wq in enumerate(_QW):
                    wgt = (wq * 0.5 * area2[:, j])[:, None]
                    ph = phi[:, j, q]
                    sxb += wgt[..., None] * (ph[:, :, None]
                                             * g[:, j, q, None, :, 0])
                    syb += wgt[..., None] * (ph[:, :, None]
                                             * g[:, j, q, None, :, 1])
                    mb += wgt * ph
            sx[cells, :n, :n] = sxb
            sy[cells, :n, :n] = syb
            mass[cells, :n] = mb

    # vertex stencils: the (cell, local corner) pairs of each vertex, by
    # matching the vertex among its cells' corners
    cov = to_host(m.cellsOnVertex)                          # (nV, vd)
    nV = m.nVertices
    slots = np.arange(mE)[None, None, :] < nEoC[cov][..., None]
    match = (voc[cov] == np.arange(nV)[:, None, None]) & slots
    valid = match.sum(-1) == 1
    corner = np.argmax(match, axis=-1)
    cell_on_v = np.where(valid, cov, 0)
    corner_on_v = np.where(valid, corner, 0)
    area_v = np.zeros(nV)
    for i in range(cov.shape[1]):
        area_v += np.where(valid[:, i], mass[cov[:, i], corner[:, i]], 0.0)
    area_v = np.maximum(area_v, 1e-12)

    device, dtype = m.xCell.device, m.xCell.dtype

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return VariationalCoeffs(
        dx=f(dx), dy=f(dy), sx=f(sx), sy=f(sy), mass=f(mass),
        cell_on_v=i(cell_on_v), corner_on_v=i(corner_on_v),
        valid_on_v=f(valid.astype(np.float64)), area_v=f(area_v))


def strain_tensor_variational(mesh: Mesh, coeffs: VariationalCoeffs,
                              u_v, v_v):
    """Strains at cell corners: e[c, j] = sum_k u(v_k) D[c, j, k].
    ref: seaice_strain_tensor_variational."""
    voc = mesh.verticesOnCell
    uc = u_v[voc]                                 # (nC, mE)
    vc = v_v[voc]
    e11 = torch.einsum("cjk,ck->cj", coeffs.dx, uc)
    e22 = torch.einsum("cjk,ck->cj", coeffs.dy, vc)
    e12 = 0.5 * (torch.einsum("cjk,ck->cj", coeffs.dy, uc)
                 + torch.einsum("cjk,ck->cj", coeffs.dx, vc))
    return e11, e22, e12


def vertex_integral_columns(coeffs: VariationalCoeffs):
    """The integral columns S{x,y}[c, :, l] of each vertex's (cell, corner)
    pairs, (nV, vd, mE), zero at invalid pairs (the reference's
    sx[cell_on_v, :, corner_on_v] times valid_on_v). Constant through a
    run: the velocity solver gathers them once a step."""
    cv, lv = coeffs.cell_on_v, coeffs.corner_on_v
    val = coeffs.valid_on_v[..., None]
    return (coeffs.sx.transpose(1, 2)[cv, lv] * val,
            coeffs.sy.transpose(1, 2)[cv, lv] * val)


def stress_divergence_variational(mesh: Mesh, coeffs: VariationalCoeffs,
                                  s11, s22, s12, columns=None):
    """Vertex stress divergence from the variational principle.
    ref: seaice_stress_divergence_variational:
      F_u(v) = -(1/A_v) sum_{c in C(v)} sum_j [s11(c,j) Sx(c,j,l)
                                               + s12(c,j) Sy(c,j,l)]
    (s11/s22/s12 per cell corner, (nCells, maxEdges)); `columns` is
    vertex_integral_columns(coeffs), computed here when None."""
    sx_col, sy_col = vertex_integral_columns(coeffs) if columns is None \
        else columns
    cv = coeffs.cell_on_v
    s11g = s11[cv]                                # (nV, vd, mE)
    s22g = s22[cv]
    s12g = s12[cv]
    fu = -(s11g * sx_col + s12g * sy_col).sum((1, 2)) / coeffs.area_v
    fv = -(s22g * sy_col + s12g * sx_col).sum((1, 2)) / coeffs.area_v
    return fu, fv
