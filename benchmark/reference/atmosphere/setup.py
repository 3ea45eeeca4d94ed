# Frozen copy of mpas_tpu_torch/cores/atmosphere/setup.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Host-side atmosphere grid setup (port of
mpas_tpu/cores/atmosphere/setup.py): vertical coordinate, the factored
advection tensors, deformation and wind-reconstruction weights, omega
metric terms and the w-damping profile.

Only the grid fields the factored advection path reads are carried; the
reference's indexed `advCellsForEdge`/`adv_coefs` stencil is its
reference algebra and has no consumer in the dycore. `build_adv_coefs`
builds it all the same, so that a test can hold the factored edge values
to the indexed contraction. Everything runs once on the host in numpy;
the containers hold torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from benchmark.reference.constants import pii
from benchmark.reference.containers import to_device
from benchmark.reference.mesh.build import _wrap_disp
from benchmark.reference.mesh.mesh import Mesh

N_ADV = 10  # padded advection stencil: 2 cells + 8 distinct neighbours


@dataclasses.dataclass(frozen=True)
class VerticalGrid:
    """1-D vertical coordinate metadata (levels k=0..nz-1, interfaces 0..nz)."""
    nz: int
    zw: Any             # (nz+1,) nominal zeta interface heights
    dzw: Any            # (nz,)
    rdzw: Any           # (nz,)
    rdzu: Any           # (nz+1,) interface 1/dz (0 at k=0 and k=nz)
    fzm: Any            # (nz+1,) interface interpolation weights (0 ends)
    fzp: Any            # (nz+1,)
    cf1: float          # surface extrapolation weights of levels 0, 1, 2
    cf2: float
    cf3: float

    def to(self, device, dtype) -> "VerticalGrid":
        return to_device(self, device, dtype)


@dataclasses.dataclass(frozen=True)
class AtmGrid:
    """Mesh + the static atmosphere grid fields the dry dycore reads."""
    mesh: Mesh
    vert: VerticalGrid
    zgrid: Any          # (nCells, nz+1) physical interface heights
    zz: Any             # (nCells, nz) d(zeta)/dz
    zxu: Any            # (nEdges, nz) metric slope at edges
    dss: Any            # (nCells, nz) w-damping coefficient
    zb_cell: Any        # (maxEdges, nCells, nz+1) omega metric, slot-major
    zb3_cell: Any       # (maxEdges, nCells, nz+1) (pre-scaled by coef_3rd)
    defc_a: Any         # (nCells, maxEdges)
    defc_b: Any         # (nCells, maxEdges)
    recon_zonal: Any    # (nCells, maxEdges) LSQ weights: zonal wind at cell
    recon_merid: Any    # (nCells, maxEdges)
    # base state (defined by the initial case)
    rho_base: Any       # (nCells, nz)
    rtheta_base: Any
    exner_base: Any
    pressure_base: Any  # (nCells, nz) base-state pressure
    # cell-assembled advection factorization (build_adv_factored)
    d2_bmat: Any        # (nCells, 3, maxEdges+1) fxx/fxy/fyy fit rows
    d2w: Any            # (nEdges, 2, 3), -dc^2/12*dv baked in
    adv_beta: float
    # cell-assembled tendency tensors (build_adv_cell_tensors)
    d2w_own: Any        # (nCells, maxEdges, 3), -dc^2/12, no dv
    d2w_opp: Any        # (nCells, maxEdges, 3)
    adv_sside: Any      # (nCells, maxEdges) +-1 upwind orientation
    dv_cell: Any        # (nCells, maxEdges) dvEdge per cell edge

    def to(self, device, dtype) -> "AtmGrid":
        return to_device(self, device, dtype)


def build_vertical_grid(nz: int, zt: float = 45000.0, stretch: float = 1.5):
    """Uniform 1-D zeta coordinate (ref: mpas_init_atm_cases.F:636-676).
    Returns (VerticalGrid of float64 tensors, sh, ah): sh is the stretched
    height fraction and ah the terrain-decay profile (numpy)."""
    k = np.arange(nz + 1, dtype=np.float64)
    dz = zt / nz
    sh = (k * dz / zt) ** stretch
    zw = k * dz
    ah = 1.0 - np.cos(0.5 * pii * k * dz / zt) ** 6
    dzw = zw[1:] - zw[:-1]
    rdzw = 1.0 / dzw
    dzu = np.zeros(nz + 1)
    fzm = np.zeros(nz + 1)
    fzp = np.zeros(nz + 1)
    rdzu = np.zeros(nz + 1)
    dzu[1:nz] = 0.5 * (dzw[1:] + dzw[:-1])
    rdzu[1:nz] = 1.0 / dzu[1:nz]
    fzp[1:nz] = 0.5 * dzw[1:] / dzu[1:nz]
    fzm[1:nz] = 0.5 * dzw[:-1] / dzu[1:nz]
    cof1 = (2.0 * dzu[1] + dzu[2]) / (dzu[1] + dzu[2]) * dzw[0] / dzu[1]
    cof2 = dzu[1] / (dzu[1] + dzu[2]) * dzw[0] / dzu[2]
    t = torch.from_numpy
    vg = VerticalGrid(nz=nz, zw=t(zw), dzw=t(dzw), rdzw=t(rdzw),
                      rdzu=t(rdzu), fzm=t(fzm), fzp=t(fzp),
                      cf1=float(fzp[1] + cof1),
                      cf2=float(fzm[1] - cof1 - cof2), cf3=float(cof2))
    return vg, sh, ah


# ---------------------------------------------------------------------------
# local tangent-plane coordinates + quadratic LSQ (deriv_two)
# ---------------------------------------------------------------------------

def _cell_xyz(mesh: Mesh):
    return np.stack([np.asarray(mesh.xCell), np.asarray(mesh.yCell),
                     np.asarray(mesh.zCell)], -1).astype(np.float64)


def _tangent_coords(mesh: Mesh, origin_xyz, points_xyz):
    """Local (x, y) coordinates of points about origin. On the sphere:
    tangent-plane azimuth preserved, radial chord rescaled to great-circle
    arc length. On the plane: the minimal-image displacement."""
    if not mesh.on_sphere:
        d = _wrap_disp(points_xyz - origin_xyz, mesh.x_period, mesh.y_period)
        return d[..., 0], d[..., 1]
    o = origin_xyz / np.linalg.norm(origin_xyz, axis=-1, keepdims=True)
    p = points_xyz / np.linalg.norm(points_xyz, axis=-1, keepdims=True)
    z = np.array([0.0, 0.0, 1.0])
    east = np.cross(z, o)
    n = np.linalg.norm(east, axis=-1, keepdims=True)
    if np.any(n < 1e-12):
        east = np.where(n < 1e-12, np.cross([1.0, 0.0, 0.0], o), east)
        n = np.linalg.norm(east, axis=-1, keepdims=True)
    east = east / n
    north = np.cross(o, east)
    d = p - o
    x = np.sum(d * east, axis=-1)
    y = np.sum(d * north, axis=-1)
    chord = np.sqrt(x * x + y * y)
    arc = 2.0 * np.arcsin(np.clip(0.5 * np.linalg.norm(p - o, axis=-1),
                                  -1.0, 1.0))
    scale = np.where(chord > 1e-14, arc / np.maximum(chord, 1e-30), 1.0)
    return x * scale * mesh.sphere_radius, y * scale * mesh.sphere_radius


def build_cell_fit_matrices(mesh: Mesh):
    """Per-cell quadratic LSQ fit matrices over the stencil [cell itself,
    cellsOnCell(1..nEdgesOnCell)]. Returns (nCells, 6, maxEdges+1): row m
    gives the weights of polynomial coefficient m in 1, x, y, x^2, xy, y^2
    order; padded stencil slots carry zero weight."""
    nC = mesh.nCells
    mE = mesh.maxEdges
    cxyz = _cell_xyz(mesh)
    coc = np.asarray(mesh.cellsOnCell)
    nEoC = np.asarray(mesh.nEdgesOnCell)
    bmats = np.zeros((nC, 6, mE + 1))
    # batched over cells grouped by stencil size; nondimensionalized by the
    # mean stencil distance to keep the Vandermonde well conditioned
    for n in np.unique(nEoC):
        n = int(n)
        sel = np.where(nEoC == n)[0]
        nbrs = coc[sel, :n]
        xs, ys = _tangent_coords(mesh, cxyz[sel][:, None, :], cxyz[nbrs])
        L = np.sqrt(np.mean(xs * xs + ys * ys, axis=1))
        xs_, ys_ = xs / L[:, None], ys / L[:, None]
        G = sel.size
        A = np.zeros((G, n + 1, 6))
        A[:, 0, 0] = 1.0
        A[:, 1:, 0] = 1.0
        A[:, 1:, 1] = xs_
        A[:, 1:, 2] = ys_
        A[:, 1:, 3] = xs_ * xs_
        A[:, 1:, 4] = xs_ * ys_
        A[:, 1:, 5] = ys_ * ys_
        B = np.linalg.pinv(A)
        B[:, 1:3, :] /= L[:, None, None]
        B[:, 3:6, :] /= (L * L)[:, None, None]
        bmats[sel, :, :n + 1] = B
    return bmats


def _edge_direction_weights(mesh: Mesh):
    """Per-edge per-side weights of d2f/dx'^2 along the cell->edge
    direction: 2cos^2(t)*fxx + 2cos(t)sin(t)*fxy + 2sin^2(t)*fyy.
    Returns (nEdges, 2, 3)."""
    cxyz = _cell_xyz(mesh)
    exyz = np.stack([np.asarray(mesh.xEdge), np.asarray(mesh.yEdge),
                     np.asarray(mesh.zEdge)], -1).astype(np.float64)
    coe = np.asarray(mesh.cellsOnEdge)
    out = np.zeros((mesh.nEdges, 2, 3))
    for side in range(2):
        xs, ys = _tangent_coords(mesh, cxyz[coe[:, side]], exyz)
        theta = np.arctan2(ys, xs)
        out[:, side, 0] = 2.0 * np.cos(theta) ** 2
        out[:, side, 1] = 2.0 * np.cos(theta) * np.sin(theta)
        out[:, side, 2] = 2.0 * np.sin(theta) ** 2
    return out


def build_deriv_two(mesh: Mesh, bmats):
    """Quadratic-fit second-derivative stencils (nEdges, 2, maxEdges+1)
    along each cell->edge direction (ref: atm_initialize_advection_rk,
    mpas_atm_advection.F:330-392)."""
    coe = np.asarray(mesh.cellsOnEdge)
    dirw = _edge_direction_weights(mesh)
    deriv_two = np.zeros((mesh.nEdges, 2, mesh.maxEdges + 1))
    for side in range(2):
        B = bmats[coe[:, side]]
        deriv_two[:, side, :] = (dirw[:, side, 0, None] * B[:, 3, :]
                                 + dirw[:, side, 1, None] * B[:, 4, :]
                                 + dirw[:, side, 2, None] * B[:, 5, :])
    return deriv_two


def build_adv_factored(mesh: Mesh, bmats):
    """Cell-assembled factorization of the SG11 advection stencil
    (ref: atm_adv_coef_compression, mpas_atm_core.F:1113-1266):
        F_m[c]   = bmats[c, 3+m, :] . psi[stencil(c)]
        D2_s[e]  = sum_m d2w[e,s,m] * F_m[coe[e,s]]
        value[e] = dv*0.5*(psi[c1]+psi[c2]) + D2_1 + D2_2
                   + sign(uh)*beta*(D2_1 - D2_2)
    Returns (d2_bmat (nCells, 3, maxEdges+1), d2w (nEdges, 2, 3))."""
    d2_bmat = np.ascontiguousarray(bmats[:, 3:6, :])
    dirw = _edge_direction_weights(mesh)
    dc = np.asarray(mesh.dcEdge)
    dv = np.asarray(mesh.dvEdge)
    d2w = dirw * (-(dc ** 2) / 12.0 * dv)[:, None, None]
    return d2_bmat, d2w


def build_adv_cell_tensors(mesh: Mesh):
    """Per-cell copies of the factored advection edge weights: for each of
    a cell's edges, its own and the opposite cell's direction weights, the
    upwind orientation sign and dvEdge. Returns (d2w_own (nC, mE, 3),
    d2w_opp (nC, mE, 3), s_cp (nC, mE), dv_cell (nC, mE))."""
    dirw = _edge_direction_weights(mesh)
    dc = np.asarray(mesh.dcEdge)
    w = dirw * (-(dc ** 2) / 12.0)[:, None, None]
    eoc = np.asarray(mesh.edgesOnCell)
    coe = np.asarray(mesh.cellsOnEdge)
    nC = eoc.shape[0]
    side_c = (coe[eoc, 0] != np.arange(nC)[:, None]).astype(np.int64)
    d2w_own = w[eoc, side_c]
    d2w_opp = w[eoc, 1 - side_c]
    s_cp = np.where(side_c == 0, 1.0, -1.0)
    dv_cell = np.asarray(mesh.dvEdge)[eoc]
    return d2w_own, d2w_opp, s_cp, dv_cell


def build_adv_coefs(mesh: Mesh, deriv_two, coef_3rd_order: float):
    """Compress deriv_two into per-edge advection stencils
    (ref: atm_adv_coef_compression, mpas_atm_core.F:1113-1266).
    adv_coefs include the dvEdge factor; adv_coefs_3rd pre-scaled by
    config_coef_3rd_order (ref: atm_couple_coef_3rd_order)."""
    nE = mesh.nEdges
    coc = np.asarray(mesh.cellsOnCell)
    nEoC = np.asarray(mesh.nEdgesOnCell)
    coe = np.asarray(mesh.cellsOnEdge)
    dc = np.asarray(mesh.dcEdge)
    dv = np.asarray(mesh.dvEdge)

    # stencil width: 2 cells + their distinct neighbors; N_ADV (=10) fits
    # maxEdges=6 quasi-uniform meshes, variable-resolution meshes can have
    # 7+-sided cells so the pad adapts (ref dims advCellsForEdge FIFTEEN,
    # core_atmosphere/Registry.xml)
    n_adv = max(N_ADV, 2 * mesh.maxEdges)
    mE = mesh.maxEdges
    c1, c2 = coe[:, 0], coe[:, 1]

    # Vectorized stencil dedup (replaces the per-edge Python loop; same
    # candidate order as the reference, so slot layout and accumulation
    # order — hence bits — are identical):
    # candidates per edge = [c1, c2, coc[c1,:], coc[c2,:]]  (S = 2+2*mE)
    S = 2 + 2 * mE
    cand = np.concatenate([c1[:, None], c2[:, None], coc[c1], coc[c2]],
                          axis=1)                               # (nE, S)
    i_idx = np.arange(mE)[None, :]
    valid = np.concatenate(
        [np.ones((nE, 2), bool), i_idx < nEoC[c1][:, None],
         i_idx < nEoC[c2][:, None]], axis=1)                    # (nE, S)
    # first occurrence of each candidate among the valid slots
    eq = cand[:, :, None] == cand[:, None, :]                   # (nE, S, S)
    earlier = np.tril(np.ones((S, S), bool), -1)[None]
    dup = np.any(eq & earlier & valid[:, None, :], axis=2)
    is_first = valid & ~dup
    slot = np.cumsum(is_first, axis=1) - 1                      # rank if first
    # map every valid candidate to its first occurrence's compressed slot
    first_j = np.argmax(eq & is_first[:, None, :], axis=2)      # (nE, S)
    tgt = np.take_along_axis(slot, first_j, axis=1)             # (nE, S)
    nAdv = np.sum(is_first, axis=1).astype(np.int64)

    advCells = np.zeros((nE, n_adv), dtype=np.int64)
    rows = np.repeat(np.arange(nE), S).reshape(nE, S)
    advCells[rows[is_first], slot[is_first]] = cand[is_first]

    # contributions in the reference's order (c1 self, c1 nbrs, c2 self,
    # c2 nbrs), accumulated slot-wise with np.add.at (ordered, sequential
    # — matches the loop's += order bitwise)
    contrib = np.concatenate(
        [deriv_two[:, 0, 0][:, None], deriv_two[:, 1, 0][:, None],
         deriv_two[:, 0, 1:mE + 1], deriv_two[:, 1, 1:mE + 1]], axis=1)
    sgn3 = np.concatenate(
        [np.ones((nE, 1)), -np.ones((nE, 1)),
         np.ones((nE, mE)), -np.ones((nE, mE))], axis=1)
    order = np.array([0] + list(range(2, 2 + mE))
                     + [1] + list(range(2 + mE, S)))
    a = np.zeros((nE, n_adv))
    a3 = np.zeros((nE, n_adv))
    flat_rows = rows[:, order][valid[:, order]]
    flat_tgt = tgt[:, order][valid[:, order]]
    np.add.at(a, (flat_rows, flat_tgt), contrib[:, order][valid[:, order]])
    np.add.at(a3, (flat_rows, flat_tgt),
              (contrib * sgn3)[:, order][valid[:, order]])
    a *= -(dc ** 2)[:, None] / 12.0
    a3 *= -(dc ** 2)[:, None] / 12.0
    a[np.arange(nE), tgt[:, 0]] += 0.5
    a[np.arange(nE), tgt[:, 1]] += 0.5
    coefs = dv[:, None] * a
    coefs3 = dv[:, None] * a3 * coef_3rd_order
    return (advCells.astype(np.int32), coefs, coefs3, nAdv)


def build_deformation_weights(mesh: Mesh):
    """defc_a/defc_b for the Smagorinsky deformation
    (ref: atm_initialize_deformation_weights, mpas_atm_advection.F:744-937)."""
    nC, mE = mesh.nCells, mesh.maxEdges
    cxyz = _cell_xyz(mesh)
    vxyz = np.stack([np.asarray(mesh.xVertex), np.asarray(mesh.yVertex),
                     np.asarray(mesh.zVertex)], -1).astype(np.float64)
    voc = np.asarray(mesh.verticesOnCell)
    eoc = np.asarray(mesh.edgesOnCell)
    coe = np.asarray(mesh.cellsOnEdge)
    nEoC = np.asarray(mesh.nEdgesOnCell)
    j = np.arange(mE)[None, :]
    n = nEoC[:, None]
    valid = j < n
    xs, ys = _tangent_coords(mesh, cxyz[:, None, :], vxyz[voc])
    jn = np.where(j + 1 < n, j + 1, 0)
    xn = np.take_along_axis(xs, jn, axis=1)
    yn = np.take_along_axis(ys, jn, axis=1)
    terms = 0.25 * (xs + xn) * (yn - ys) - 0.25 * (ys + yn) * (xn - xs)
    area = np.sum(np.where(valid, terms, 0.0), axis=1, keepdims=True)
    dl = np.sqrt((xn - xs) ** 2 + (yn - ys) ** 2)
    theta = np.arctan2(yn - ys, xn - xs)
    ca = dl * (np.cos(theta) ** 2 - np.sin(theta) ** 2) / area
    cb = dl * 2.0 * np.sin(theta) * np.cos(theta) / area
    sign = np.where(coe[eoc, 0] == np.arange(nC)[:, None], 1.0, -1.0)
    defc_a = np.where(valid, ca * sign, 0.0)
    defc_b = np.where(valid, cb * sign, 0.0)
    return defc_a, defc_b


def build_reconstruct_weights(mesh: Mesh):
    """Per-cell least-squares reconstruction of the horizontal wind from
    edge-normal components: V = argmin sum_e (V.n_e - u_e)^2 over the
    cell's edges. Returns (w_zonal, w_merid), each (nCells, maxEdges)
    (stands in for ref: mpas_vector_reconstruction.F:51)."""
    mE = mesh.maxEdges
    nEoC = np.asarray(mesh.nEdgesOnCell)
    eoc = np.asarray(mesh.edgesOnCell)
    ang = np.asarray(mesh.angleEdge)
    j = np.arange(mE)[None, :]
    valid = (j < nEoC[:, None]).astype(np.float64)
    if mesh.on_sphere:
        # edge normals in 3-D, projected on each cell's (east, north)
        latE, lonE = np.asarray(mesh.latEdge), np.asarray(mesh.lonEdge)
        latC, lonC = np.asarray(mesh.latCell), np.asarray(mesh.lonCell)
        ee = np.stack([-np.sin(lonE), np.cos(lonE), np.zeros_like(lonE)], -1)
        ne = np.stack([-np.sin(latE) * np.cos(lonE),
                       -np.sin(latE) * np.sin(lonE), np.cos(latE)], -1)
        nvec3 = np.cos(ang)[:, None] * ee + np.sin(ang)[:, None] * ne
        ec = np.stack([-np.sin(lonC), np.cos(lonC), np.zeros_like(lonC)], -1)
        ncv = np.stack([-np.sin(latC) * np.cos(lonC),
                        -np.sin(latC) * np.sin(lonC), np.cos(latC)], -1)
        nx = np.einsum("cmk,ck->cm", nvec3[eoc], ec) * valid
        ny = np.einsum("cmk,ck->cm", nvec3[eoc], ncv) * valid
    else:
        nx = np.cos(ang[eoc]) * valid
        ny = np.sin(ang[eoc]) * valid
    # closed-form pseudo-inverse (N^T N)^{-1} N^T: a 2x2 solve per cell
    g11 = np.sum(nx * nx, axis=1)
    g12 = np.sum(nx * ny, axis=1)
    g22 = np.sum(ny * ny, axis=1)
    det = g11 * g22 - g12 * g12
    w_zonal = (g22[:, None] * nx - g12[:, None] * ny) / det[:, None] * valid
    w_merid = (g11[:, None] * ny - g12[:, None] * nx) / det[:, None] * valid
    return w_zonal, w_merid


def build_zb(mesh: Mesh, vg: VerticalGrid, zgrid, deriv_two,
             theta_adv_order: int, coef_3rd_order: float):
    """Omega metric terms zb/zb3, stored per cell and slot-major
    (maxEdges, nCells, nz+1), zb3 pre-scaled by coef_3rd_order
    (ref: mpas_init_atm_cases.F:1009-1040 and atm_compute_signs)."""
    nE, nC, mE = mesh.nEdges, mesh.nCells, mesh.maxEdges
    nzp = vg.nz + 1
    coe = np.asarray(mesh.cellsOnEdge)
    coc = np.asarray(mesh.cellsOnCell)
    nEoC = np.asarray(mesh.nEdgesOnCell)
    eoc = np.asarray(mesh.edgesOnCell)
    dv = np.asarray(mesh.dvEdge)
    dc = np.asarray(mesh.dcEdge)
    areaC = np.asarray(mesh.areaCell)
    c1, c2 = coe[:, 0], coe[:, 1]

    if theta_adv_order == 2:
        z_edge = 0.5 * (zgrid[c1] + zgrid[c2])
        z_edge3 = np.zeros((nE, nzp))
    else:
        d2 = np.zeros((2, nE, nzp))
        for side in range(2):
            cells = coe[:, side]
            acc = deriv_two[:, side, 0][:, None] * zgrid[cells]
            for i in range(mE):
                valid = i < nEoC[cells]
                nb = coc[cells, i]
                acc = acc + np.where(valid[:, None],
                                     deriv_two[:, side, i + 1][:, None]
                                     * zgrid[nb], 0.0)
            d2[side] = acc
        z_edge = 0.5 * (zgrid[c1] + zgrid[c2]) \
            - (dc ** 2)[:, None] * (d2[0] + d2[1]) / 12.0
        if theta_adv_order == 3:
            z_edge3 = -(dc ** 2)[:, None] * (d2[0] - d2[1]) / 12.0
        else:
            z_edge3 = np.zeros((nE, nzp))

    zb = np.zeros((nE, 2, nzp))
    zb3 = np.zeros((nE, 2, nzp))
    zb[:, 0, :] = (z_edge - zgrid[c1]) * (dv / areaC[c1])[:, None]
    zb[:, 1, :] = (z_edge - zgrid[c2]) * (dv / areaC[c2])[:, None]
    zb3[:, 0, :] = z_edge3 * (dv / areaC[c1])[:, None]
    zb3[:, 1, :] = z_edge3 * (dv / areaC[c2])[:, None]

    zb_cell = np.zeros((mE, nC, nzp))
    zb3_cell = np.zeros((mE, nC, nzp))
    for i in range(mE):
        valid = i < nEoC
        e = eoc[:, i]
        own_side = np.where(coe[e, 0] == np.arange(nC), 0, 1)
        zb_cell[i] = np.where(valid[:, None], zb[e, own_side, :], 0.0)
        zb3_cell[i] = np.where(valid[:, None],
                               zb3[e, own_side, :] * coef_3rd_order, 0.0)
    return zb_cell, zb3_cell


def build_dss(mesh: Mesh, zgrid, zd: float, xnutr: float):
    """w-damping layer profile (ref: atm_compute_damping_coefs,
    mpas_atm_core.F:1077-1111)."""
    zt = zgrid[:, -1:]
    z = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])
    dss = np.where(z > zd,
                   xnutr * np.sin(0.5 * pii * (z - zd)
                                  / np.maximum(zt - zd, 1.0)) ** 2, 0.0)
    md = np.asarray(mesh.meshDensity)[:, None]
    return dss / md ** 0.25
