"""Radial-basis-function interpolation library (port of mpas_tpu/ops/rbf.py).

Covers the reference RBF machinery (ref: src/operators/
mpas_rbf_interpolation.F, public API :30-129): inverse-multiquadric RBF
(:1369-1419), 2-D fixed-function/variable-location scalar interpolation
with derivatives (:165-430), 3-D scalar Dirichlet and Dirichlet/Neumann
coefficient computation with constant or linear polynomial augmentation
(:440-980), 3-D vector constant-basis Dirichlet coefficients and the
planar (tangent-plane) variants (:989-1120), plus the geometric
initialization (edge normals, cell tangent planes, local verticals;
ref mpas_vector_operations.F:652 mpas_initialize_vectors) and the RBF
vector reconstruction built on top (ref mpas_vector_reconstruction.F:51).

Every routine is batched over leading dims: one dense (N+k) linear
solve per destination point, all destinations in one batched
torch.linalg.solve, with masked rows for padded stencils (maxEdges
padding) so shapes stay fixed. All solves run at setup time
(coefficients are then fixed gather weights in the step function). The
systems are ill-conditioned (the inverse multiquadric's interpolation
matrices at stencil spacing ~ alpha): coefficients carry the condition
number times the rounding, the reconstructed values do not.
"""

from __future__ import annotations

import numpy as np
import torch

from mpas_tpu_torch.containers import to_host


def _lift(a, k):
    """A scalar or a tensor of batch shape with k trailing unit dims."""
    return a.reshape(a.shape + (1,) * k) if isinstance(a, torch.Tensor) \
        else a


def _bt(a):
    """Swap the last two dims."""
    return a.transpose(-1, -2)


def _block(a, b, c, d):
    """[[a, b], [c, d]] over the last two dims."""
    return torch.cat([torch.cat([a, b], -1), torch.cat([c, d], -1)], -2)


def _pairwise_d2(p):
    """(..., N, N) squared distances between the rows of p (..., N, d)."""
    return ((p[..., :, None, :] - p[..., None, :, :]) ** 2).sum(-1)


def _valid(valid, n, k, like):
    """(..., n + k) bool: `valid` (or all-true) and k trailing trues."""
    batch = like.shape[:-2]
    ones = torch.ones(batch + (k,), dtype=torch.bool, device=like.device)
    if valid is None:
        return torch.ones(batch + (n + k,), dtype=torch.bool,
                          device=like.device)
    return torch.cat([valid.to(torch.bool).expand(batch + (n,)), ones], -1)


# ---------------------------------------------------------------------------
# kernel (ref :1369-1419): inverse multiquadric
# ---------------------------------------------------------------------------

def rbf_value(r2):
    """phi(r^2) = 1/sqrt(1 + r^2)."""
    return 1.0 / torch.sqrt(1.0 + r2)


def rbf_derivs(r2):
    """(phi, phi'/r, phi'') of the inverse multiquadric (ref :1409-1419)."""
    v = rbf_value(r2)
    return v, -v ** 3, (2.0 * r2 - 1.0) * v ** 5


def _masked_solve(matrix, rhs, valid):
    """Solve (..., N, N) systems with dead rows/cols replaced by identity.

    valid: (..., N) bool; invalid rows get row=I, rhs=0 so their
    coefficient is exactly 0 and they do not affect live coefficients.
    rhs: (..., N) or (..., N, k)."""
    n = matrix.shape[-1]
    eye = torch.eye(n, dtype=matrix.dtype, device=matrix.device)
    v2 = valid[..., :, None] & valid[..., None, :]
    m = torch.where(v2, matrix, eye)
    vec = rhs.dim() == matrix.dim() - 1
    r = rhs[..., None] if vec else rhs
    r = torch.where(valid[..., None], r, torch.zeros_like(r))
    x = torch.linalg.solve(m, r)
    return x[..., 0] if vec else x


# ---------------------------------------------------------------------------
# 2-D scalar, fixed function / variable evaluation location (ref :165-430)
# ---------------------------------------------------------------------------

def loc_2d_scalar_const_coeffs(points, values, alpha, valid=None):
    """RBF+constant expansion coefficients of a fixed 2-D scalar field
    (ref mpas_rbf_interp_loc_2D_sca_const_comp_coeffs :165).

    points: (..., N, 2), values: (..., N). Returns (..., N+1)."""
    n = points.shape[-2]
    phi = rbf_value(_pairwise_d2(points) / _lift(alpha, 2) ** 2)
    one = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                     device=points.device)
    z = torch.zeros(points.shape[:-2] + (1, 1), dtype=points.dtype,
                    device=points.device)
    m = _block(phi, one, _bt(one), z)
    rhs = torch.cat([values, z[..., 0]], -1)
    return _masked_solve(m, rhs, _valid(valid, n, 1, points))


def loc_2d_scalar_lin_coeffs(points, values, alpha, valid=None):
    """RBF + linear polynomial expansion (ref :231). Returns (..., N+3)."""
    n = points.shape[-2]
    phi = rbf_value(_pairwise_d2(points) / _lift(alpha, 2) ** 2)
    poly = torch.cat([torch.ones_like(points[..., :1]), points], -1)
    z = torch.zeros(points.shape[:-2] + (3, 3), dtype=points.dtype,
                    device=points.device)
    m = _block(phi, poly, _bt(poly), z)
    rhs = torch.cat([values, z[..., 0]], -1)
    return _masked_solve(m, rhs, _valid(valid, n, 3, points))


def loc_2d_scalar_const_eval_with_derivs(coeffs, eval_point, points, alpha):
    """Evaluate (f, df/dx, df/dy, d2f/dx2, d2f/dxdy, d2f/dy2) of the
    const-augmented expansion at eval_point (ref :305-360)."""
    a2 = _lift(alpha, 1) ** 2
    dx = eval_point[..., None, :] - points                   # (..., N, 2)
    r2 = (dx ** 2).sum(-1) / a2
    phi, dphi_r, d2phi = rbf_derivs(r2)
    dphi_r = dphi_r / a2
    d2phi = d2phi / a2
    c = coeffs[..., :-1]
    f = (c * phi).sum(-1) + coeffs[..., -1]
    g = (c[..., None] * dphi_r[..., None] * dx).sum(-2)
    # second derivatives: split radial/tangential (ref :327-340)
    r2s = r2.clamp(min=1e-14)
    xx = dx[..., 0] ** 2 / (a2 * r2s)
    yy = dx[..., 1] ** 2 / (a2 * r2s)
    xy = dx[..., 0] * dx[..., 1] / (a2 * r2s)
    small = r2 < 1e-7
    hxx = (c * torch.where(small, d2phi, d2phi * xx
                           + dphi_r * (1.0 - xx))).sum(-1)
    hyy = (c * torch.where(small, d2phi, d2phi * yy
                           + dphi_r * (1.0 - yy))).sum(-1)
    hxy = (c * torch.where(small, torch.zeros_like(xy),
                           (d2phi - dphi_r) * xy)).sum(-1)
    return f, g[..., 0], g[..., 1], hxx, hxy, hyy


def loc_2d_scalar_lin_eval_with_derivs(coeffs, eval_point, points, alpha):
    """Same for the linear-augmented expansion (ref :382-430)."""
    f, fx, fy, hxx, hxy, hyy = loc_2d_scalar_const_eval_with_derivs(
        torch.cat([coeffs[..., :-3], coeffs[..., -3:-2]], -1), eval_point,
        points, alpha)
    f = f + coeffs[..., -2] * eval_point[..., 0] \
        + coeffs[..., -1] * eval_point[..., 1]
    return f, fx + coeffs[..., -2], fy + coeffs[..., -1], hxx, hxy, hyy


# ---------------------------------------------------------------------------
# 3-D scalar Dirichlet / Dirichlet+Neumann coefficients (ref :440-980)
# ---------------------------------------------------------------------------

def _poly_block(points, kind):
    one = torch.ones_like(points[..., :1])
    return one if kind == "const" else torch.cat([one, points], -1)


def _dest_rhs(source_points, destination_point, alpha, basis):
    r2d = ((destination_point[..., None, :] - source_points) ** 2).sum(-1)
    one = torch.ones_like(destination_point[..., :1])
    dest_poly = one if basis == "const" else \
        torch.cat([one, destination_point], -1)
    return torch.cat([rbf_value(r2d / _lift(alpha, 1) ** 2), dest_poly], -1)


def func_3d_scalar_dir_coeffs(source_points, destination_point, alpha,
                              basis="const", valid=None):
    """Dirichlet interpolation coefficients: f(dest) = sum(c_i f(x_i))
    (ref mpas_rbf_interp_func_3D_sca_{const,lin}_dir_comp_coeffs
    :440,:540). source_points (..., N, d), d in {2, 3}."""
    n = source_points.shape[-2]
    phi = rbf_value(_pairwise_d2(source_points) / _lift(alpha, 2) ** 2)
    poly = _poly_block(source_points, basis)
    k = poly.shape[-1]
    z = torch.zeros(poly.shape[:-2] + (k, k), dtype=poly.dtype,
                    device=poly.device)
    m = _block(phi, poly, _bt(poly), z)
    rhs = _dest_rhs(source_points, destination_point, alpha, basis)
    return _masked_solve(m, rhs, _valid(valid, n, k, source_points)
                         )[..., :n]


def func_3d_scalar_dir_neu_coeffs(source_points, is_interface,
                                  interface_normals, destination_point,
                                  alpha, basis="const", valid=None):
    """Dirichlet AND Neumann coefficient sets (ref :640-980; matrix/rhs
    setup :1471-1515): at interface points the Neumann matrix column uses
    d(phi)/dn instead of phi, and its polynomial row is zeroed.

    Returns (dirichlet_coeffs (..., N), neumann_coeffs (..., N))."""
    n = source_points.shape[-2]
    a2 = _lift(alpha, 2) ** 2
    diff = source_points[..., :, None, :] - source_points[..., None, :, :]
    phi, dphi_r, _ = rbf_derivs((diff ** 2).sum(-1) / a2)
    # normalDotX_{ij} = n_j . (x_j - x_i)  (ref :1493)
    ndx = (interface_normals[..., None, :, :] * (-diff)).sum(-1)
    neu = torch.where(is_interface[..., None, :], (dphi_r / a2) * ndx, phi)
    poly = _poly_block(source_points, basis)
    k = poly.shape[-1]
    poly_neu = torch.where(is_interface[..., :, None],
                           torch.zeros_like(poly), poly)
    zkk = torch.zeros(poly.shape[:-2] + (k, k), dtype=poly.dtype,
                      device=poly.device)
    m_dir = _block(phi, poly, _bt(poly), zkk)
    m_neu = _block(neu, poly_neu, _bt(poly_neu), zkk)
    rhs = _dest_rhs(source_points, destination_point, alpha, basis)
    v = _valid(valid, n, k, source_points)
    return (_masked_solve(m_dir, rhs, v)[..., :n],
            _masked_solve(m_neu, rhs, v)[..., :n])


def _to_plane(points, plane_basis):
    """(..., N, 3) points -> (..., N, 2) tangent-plane coordinates."""
    return points @ _bt(plane_basis)


def _point_to_plane(point, plane_basis):
    return (plane_basis @ point[..., None])[..., 0]


def func_3d_plane_scalar_dir_coeffs(source_points, destination_point,
                                    plane_basis, alpha, basis="lin",
                                    valid=None):
    """Planar variant: project into the tangent plane first (ref :540)."""
    return func_3d_scalar_dir_coeffs(
        _to_plane(source_points, plane_basis),
        _point_to_plane(destination_point, plane_basis), alpha,
        basis=basis, valid=valid)


def func_3d_plane_scalar_dir_neu_coeffs(source_points, is_interface,
                                        interface_normals,
                                        destination_point, plane_basis,
                                        alpha, basis="lin", valid=None):
    return func_3d_scalar_dir_neu_coeffs(
        _to_plane(source_points, plane_basis), is_interface,
        _to_plane(interface_normals, plane_basis),
        _point_to_plane(destination_point, plane_basis), alpha,
        basis=basis, valid=valid)


# ---------------------------------------------------------------------------
# 3-D vector constant-basis Dirichlet coefficients (ref :989-1120)
# ---------------------------------------------------------------------------

def _vector_dirichlet_system(source_points, unit_vectors,
                             destination_point, alpha):
    """ref mpas_set_up_vector_dirichlet_rbf_matrix_and_rhs (:1527)."""
    phi = rbf_value(_pairwise_d2(source_points) / _lift(alpha, 2) ** 2)
    uu = unit_vectors @ _bt(unit_vectors)
    m = phi * uu
    r2d = ((destination_point[..., None, :] - source_points) ** 2).sum(-1)
    rhs = rbf_value(r2d / _lift(alpha, 1) ** 2)[..., None] * unit_vectors
    return m, rhs


def _vector_block(m0, right, unit_vectors, valid):
    n, d = unit_vectors.shape[-2:]
    z = torch.zeros(m0.shape[:-2] + (d, d), dtype=m0.dtype,
                    device=m0.device)
    m = _block(m0, right, _bt(unit_vectors), z)
    return m, _valid(valid, n, d, unit_vectors)


def func_3d_vector_const_dir_coeffs(source_points, unit_vectors,
                                    destination_point, alpha, valid=None):
    """Vector Dirichlet coefficients (ref :989-1038): reconstruct the full
    vector at `destination_point` from u.n values at the sources.
    Returns (..., N, d) coefficients with d = source dimension."""
    n, d = source_points.shape[-2:]
    m0, rhs0 = _vector_dirichlet_system(source_points, unit_vectors,
                                        destination_point, alpha)
    m, v = _vector_block(m0, unit_vectors, unit_vectors, valid)
    eye = torch.eye(d, dtype=m0.dtype, device=m0.device).expand(
        rhs0.shape[:-2] + (d, d))
    rhs = torch.cat([rhs0, eye], -2)
    return _masked_solve(m, rhs, v)[..., :n, :]


def func_3d_plane_vec_const_dir_coeffs(source_points, unit_vectors,
                                       destination_point, plane_basis,
                                       alpha, valid=None):
    """Planar variant (ref :1042-1120): project to the tangent plane,
    solve the 2-D vector system, map coefficients back to 3-D."""
    c2 = func_3d_vector_const_dir_coeffs(
        _to_plane(source_points, plane_basis),
        _to_plane(unit_vectors, plane_basis),
        _point_to_plane(destination_point, plane_basis), alpha,
        valid=valid)
    return c2 @ plane_basis                     # (..., N, 3)


# ---------------------------------------------------------------------------
# 3-D vector constant-basis tangent-Neumann (free-slip) coefficients
# (ref :1149-1352 + matrix setup
#  mpas_set_up_vector_free_slip_rbf_matrix_and_rhs :1571-1617)
# ---------------------------------------------------------------------------

def _vector_free_slip_system(source_points, is_tangent, normal_index,
                             unit_vectors, destination_point, alpha):
    """ref mpas_set_up_vector_free_slip_rbf_matrix_and_rhs (:1571).

    Column j of the matrix carries phi * (u_i . u_j) for Dirichlet
    (non-tangent) sources and (phi'/r)/alpha^2 * (n_j.(x_j - x_i))
    * (u_i . u_j) for tangent sources, where n_j =
    unit_vectors[normal_index[j]] — the normal-derivative constraint of the
    free-slip condition. The rhs is the plain Dirichlet rhs.
    """
    a2 = _lift(alpha, 2) ** 2
    diff = source_points[..., :, None, :] - source_points[..., None, :, :]
    r2 = (diff ** 2).sum(-1) / a2
    phi = rbf_value(r2)
    dphi_over_r = rbf_derivs(r2)[1]
    uu = unit_vectors @ _bt(unit_vectors)                     # (N,N) i.j
    idx = normal_index.to(torch.int64)[..., None].expand(
        normal_index.shape + (unit_vectors.shape[-1],))
    nvec = torch.gather(unit_vectors, -2, idx)                # (N,d) per j
    # n_j . (x_j - x_i) = -n_j . diff[i,j]
    ndx = -torch.einsum("...ijd,...jd->...ij", diff, nvec)
    m_dir = phi * uu
    m_neu = (dphi_over_r / a2) * ndx * uu
    m = torch.where(is_tangent[..., None, :], m_neu, m_dir)
    r2d = ((destination_point[..., None, :] - source_points) ** 2).sum(-1)
    rhs = rbf_value(r2d / _lift(alpha, 1) ** 2)[..., None] * unit_vectors
    return m, rhs


def func_3d_vec_const_tan_neu_coeffs(source_points, is_tangent,
                                     normal_index, unit_vectors,
                                     destination_point, alpha, valid=None):
    """Free-slip vector coefficients (ref :1189-1236): reconstruct the full
    vector at `destination_point` from u.n at non-tangent sources and
    (du/dn).u_j at tangent sources (Dirichlet-normal / Neumann-tangential —
    the free-slip boundary condition). Returns (..., N, d)."""
    n, d = source_points.shape[-2:]
    m0, rhs0 = _vector_free_slip_system(source_points, is_tangent,
                                        normal_index, unit_vectors,
                                        destination_point, alpha)
    # constant-vector block: bottom rows always carry unitVectors; the
    # right column does so only for non-tangent sources (ref :1222-1227)
    right = torch.where(is_tangent[..., None], torch.zeros_like(
        unit_vectors), unit_vectors)
    m, v = _vector_block(m0, right, unit_vectors, valid)
    eye = torch.eye(d, dtype=m0.dtype, device=m0.device).expand(
        rhs0.shape[:-2] + (d, d))
    rhs = torch.cat([rhs0, eye], -2)
    return _masked_solve(m, rhs, v)[..., :n, :]


def func_3d_plane_vec_const_tan_neu_coeffs(source_points, is_tangent,
                                           normal_index, unit_vectors,
                                           destination_point, plane_basis,
                                           alpha, valid=None):
    """Planar free-slip variant (ref :1286-1352): project sources/vectors
    onto the tangent plane, solve the 2-D free-slip system, map the
    coefficients back to 3-D."""
    c2 = func_3d_vec_const_tan_neu_coeffs(
        _to_plane(source_points, plane_basis), is_tangent, normal_index,
        _to_plane(unit_vectors, plane_basis),
        _point_to_plane(destination_point, plane_basis), alpha, valid=valid)
    return c2 @ plane_basis                     # (..., N, 3)


# ---------------------------------------------------------------------------
# geometric initialization (ref mpas_rbf_interp_initialize :110-160 and
# mpas_vector_operations.F:652 mpas_initialize_vectors)
# ---------------------------------------------------------------------------

def _xyz(mesh, kind):
    return np.stack([to_host(getattr(mesh, f"{c}{kind}")).astype(
        np.float64) for c in "xyz"], -1)


def _interp_initialize_host(mesh):
    xc, xe = _xyz(mesh, "Cell"), _xyz(mesh, "Edge")
    coe = to_host(mesh.cellsOnEdge)
    if mesh.on_sphere:
        vert = xc / np.linalg.norm(xc, axis=-1, keepdims=True)
    else:
        vert = np.zeros_like(xc)
        vert[:, 2] = 1.0
    # edge normal: unit vector from cell1 toward cell2 (interior edges);
    # boundary edges point from cell1 toward the edge midpoint
    c1, c2 = coe[:, 0], coe[:, 1]
    boundary = to_host(mesh.boundaryEdge) > 0
    d = np.where(boundary[:, None], xe - xc[c1], xc[c2] - xc[c1])
    nrm = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
    # cell tangent plane: first vector toward first edge, projected
    first_edge = to_host(mesh.edgesOnCell)[:, 0]
    t1 = xe[first_edge] - xc
    t1 = t1 - vert * np.sum(t1 * vert, -1, keepdims=True)
    t1 = t1 / np.maximum(np.linalg.norm(t1, axis=-1, keepdims=True), 1e-30)
    t2 = np.cross(vert, t1)
    plane = np.stack([t1, t2], axis=1)           # (nC, 2, 3)
    return nrm, plane, vert


def interp_initialize(mesh):
    """(edgeNormalVector (nE,3), cellTangentPlane (nC,2,3),
    localVerticalUnitVectors (nC,3)), built in host numpy float64 and
    returned as tensors on the mesh's device in its dtype."""
    dev, dt = mesh.xCell.device, mesh.xCell.dtype
    return tuple(torch.as_tensor(a, dtype=dt, device=dev)
                 for a in _interp_initialize_host(mesh))


def reconstruct_init(mesh):
    """RBF coefficients for edge-normal -> cell-center vector
    reconstruction (ref mpas_vector_reconstruction.F:51 mpas_init_reconstruct).

    Returns coeffs (nCells, maxEdges, 3) on the mesh's device in its
    dtype; reconstruct via `reconstruct(mesh, coeffs, u)`. The geometry is
    host numpy float64; the solves are one batched solve in float64."""
    nrm, plane, _vert = _interp_initialize_host(mesh)
    xc, xe = _xyz(mesh, "Cell"), _xyz(mesh, "Edge")
    eoc = to_host(mesh.edgesOnCell)
    mask = to_host(mesh.edgesOnCellMask) > 0
    pts = xe[eoc]                                # (nC, mE, 3)
    uvs = nrm[eoc]
    # periodic planar meshes: wrap source points near the cell center
    if not mesh.on_sphere and (mesh.x_period or mesh.y_period):
        for dim, period in ((0, mesh.x_period), (1, mesh.y_period)):
            if period:
                delta = pts[..., dim] - xc[:, None, dim]
                pts[..., dim] -= np.round(delta / period) * period
    r = np.linalg.norm(pts - xc[:, None, :], axis=-1)
    # alpha = mean distance over live edges (ref :124-129)
    cnt = np.maximum(mask.sum(-1), 1)
    alpha = np.where(mask, r, 0.0).sum(-1) / cnt
    dev = mesh.xCell.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    mask_t = torch.as_tensor(mask, device=dev)
    coeffs = func_3d_plane_vec_const_dir_coeffs(
        t(pts), t(uvs), t(xc), t(plane), t(alpha), valid=mask_t)
    coeffs = torch.where(mask_t[..., None], coeffs,
                         torch.zeros_like(coeffs))
    return coeffs.to(mesh.xCell.dtype)


def reconstruct(mesh, coeffs, u):
    """Edge-normal field (nE, ...) -> cell XYZ vectors + zonal/meridional
    (ref mpas_reconstruct_2d :309). Returns (uX, uY, uZ, uZonal, uMerid),
    each (nCells, ...)."""
    ue = u[mesh.edgesOnCell]                     # (nC, mE, ...)
    extra = ue.dim() - 2
    cexp = coeffs.reshape(coeffs.shape[:2] + (1,) * extra + (3,))
    ux = (cexp[..., 0] * ue).sum(1)
    uy = (cexp[..., 1] * ue).sum(1)
    uz = (cexp[..., 2] * ue).sum(1)
    shape = (-1,) + (1,) * extra
    lat, lon = mesh.latCell, mesh.lonCell
    clat, slat = torch.cos(lat).reshape(shape), torch.sin(lat).reshape(shape)
    clon, slon = torch.cos(lon).reshape(shape), torch.sin(lon).reshape(shape)
    uzonal = -ux * slon + uy * clon
    umerid = -(ux * clon + uy * slon) * slat + uz * clat
    return ux, uy, uz, uzonal, umerid
