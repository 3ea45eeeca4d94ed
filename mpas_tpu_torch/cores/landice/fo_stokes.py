"""First-order (Blatter-Pattyn) Stokes velocity solver (port of
mpas_tpu/cores/landice/fo_stokes.py).

ref: the reference delegates this solve to the Albany/FELIX library
through Interface_velocity_solver.cpp (velocity_solver_solve_fo :341,
extruded-grid construction :928); mpas_li_velocity_external.F drives it.
This module is the in-framework equivalent: the same first-order Stokes
system, discretized finite-volume on the extruded Voronoi mesh and solved
matrix-free (Picard on the Glen viscosity, conjugate gradients on the
symmetric linearized operator).

System (FO approximation; u, v horizontal velocities on sigma levels):
  d/dx(nu (4 du/dx + 2 dv/dy)) + d/dy(nu (du/dy + dv/dx))
      + d/dz(nu du/dz) = rho g ds/dx
  d/dx(nu (du/dy + dv/dx)) + d/dy(nu (4 dv/dy + 2 du/dx))
      + d/dz(nu dv/dz) = rho g ds/dy
  nu = 1/2 A^(-1/n) eps_e^((1-n)/n),  n = 3 (Glen)
Boundary conditions: stress-free surface; basal no-slip (beta -> inf) or
linear friction nu du/dz = beta^2 u (ISMIP-HOM A vs C genres).

Discretization: u, v at cell centers x nz layers (sigma coordinate in
the ice column, layer midpoints); horizontal derivatives by per-cell
least-squares gradients over cellsOnCell (periodic-aware); membrane
fluxes assembled in flux form; vertical diffusion by FD on the local
layer thickness. The CG and Picard iterations are Python loops of fixed
counts; their scalars stay 0-d device tensors (nothing is read back).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mpas_tpu_torch.containers import to_device, to_host
from mpas_tpu_torch.cores.landice.core import add_col

N_GLEN = 3.0
# strain-rate regularization, (1/s)^2: well below ice strain rates
# (~1e-9..1e-7 1/s) so it never dominates a real solution
EPS_REG = 1e-22


@dataclasses.dataclass(frozen=True)
class FoGeom:
    """Host-built geometry for the FO solve."""
    gradx_w: Any     # (nC, maxNbr+1) LSQ d/dx weights over [self, nbrs]
    grady_w: Any
    nbr: Any         # (nC, maxNbr) cellsOnCell (self-padded)
    nbr_mask: Any    # (nC, maxNbr) 1.0 on real neighbours
    area: Any        # (nC,)

    def to(self, device, dtype) -> "FoGeom":
        return to_device(self, device, dtype)


def build_fo_geom(mesh) -> FoGeom:
    """Per-cell least-squares gradient weights (periodic-aware), built in
    host numpy float64; tensors on the mesh's device in its float dtype."""
    nC = mesh.nCells
    coc = to_host(mesh.cellsOnCell)
    mask = to_host(mesh.edgesOnCellMask) > 0
    xc = to_host(mesh.xCell).astype(np.float64)
    yc = to_host(mesh.yCell).astype(np.float64)
    nbr = np.where(mask, coc, np.arange(nC)[:, None])
    dx = xc[nbr] - xc[:, None]
    dy = yc[nbr] - yc[:, None]
    if mesh.x_period:
        dx -= np.round(dx / mesh.x_period) * mesh.x_period
    if mesh.y_period:
        dy -= np.round(dy / mesh.y_period) * mesh.y_period
    dx = np.where(mask, dx, 0.0)
    dy = np.where(mask, dy, 0.0)
    # 2x2 normal equations per cell
    a11 = np.sum(dx * dx, -1)
    a12 = np.sum(dx * dy, -1)
    a22 = np.sum(dy * dy, -1)
    det = np.maximum(a11 * a22 - a12 * a12, 1e-30)
    wx = (a22[:, None] * dx - a12[:, None] * dy) / det[:, None]
    wy = (a11[:, None] * dy - a12[:, None] * dx) / det[:, None]
    # weights apply to (f_nbr - f_self): express as [self, nbr] weights
    gradx_w = np.concatenate([-wx.sum(-1, keepdims=True), wx], axis=-1)
    grady_w = np.concatenate([-wy.sum(-1, keepdims=True), wy], axis=-1)
    # clamp: padded dead-slot cells of a sharded local mesh carry zero
    # area; their weights are all zero, so clamping keeps their operator
    # rows at exactly 0 instead of 0/0
    area = np.maximum(to_host(mesh.areaCell).astype(np.float64), 1e-30)
    dev, dt = mesh.xCell.device, mesh.xCell.dtype

    def f(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    return FoGeom(gradx_w=f(gradx_w), grady_w=f(grady_w),
                  nbr=torch.as_tensor(nbr, dtype=torch.int64, device=dev),
                  nbr_mask=f(mask.astype(np.float64)), area=f(area))


def _hgrad(geom: FoGeom, f):
    """(df/dx, df/dy) at cells for f (nC, nz)."""
    vals = torch.cat([f[:, None, :], f[geom.nbr]], dim=1)
    fx = (geom.gradx_w[..., None] * vals).sum(1)
    fy = (geom.grady_w[..., None] * vals).sum(1)
    return fx, fy


def _hdiv(geom: FoGeom, fx, fy):
    """Adjoint-consistent divergence: -_hgrad^T, area-weighted, so the
    assembled operator stays symmetric for CG. div(F) at cell c =
    (1/A_c) [sum over all cells c' of w(c',c) A_c' F(c') ...] — built by
    scattering each cell's weighted gradient contributions back (a
    segment sum over the neighbour lists, index_add_). A box mesh's
    boundary cells list cell 0 for each missing neighbour, so a gather
    table of the transpose would be as wide as the boundary is long."""
    a = geom.area[:, None, None]
    own = (geom.gradx_w[:, 0:1, None] * fx[:, None, :] * a
           + geom.grady_w[:, 0:1, None] * fy[:, None, :] * a)
    nbr_c = (geom.gradx_w[:, 1:, None] * fx[:, None, :] * a
             + geom.grady_w[:, 1:, None] * fy[:, None, :] * a)
    out = own[:, 0].index_add(0, geom.nbr.reshape(-1),
                              nbr_c.reshape(-1, fx.shape[-1]))
    return out / geom.area[:, None]


def effective_viscosity(geom: FoGeom, u, v, dz, a_glen):
    """Glen-law viscosity at cell-levels (Pa s)."""
    ux, uy = _hgrad(geom, u)
    vx, vy = _hgrad(geom, v)
    uz = _dz_center(u, dz)
    vz = _dz_center(v, dz)
    eps2 = ux ** 2 + vy ** 2 + ux * vy + 0.25 * (uy + vx) ** 2 \
        + 0.25 * uz ** 2 + 0.25 * vz ** 2
    eps2 = eps2 + EPS_REG
    return 0.5 * a_glen ** (-1.0 / N_GLEN) \
        * eps2 ** ((1.0 - N_GLEN) / (2.0 * N_GLEN))


def _dz_center(f, dz):
    """Centered vertical derivative at layer midpoints (one-sided ends)."""
    df = (f[:, 2:] - f[:, :-2]) / (dz[:, 2:] + 2.0 * dz[:, 1:-1]
                                   + dz[:, :-2]) * 2.0
    d0 = (f[:, 1:2] - f[:, 0:1]) / (0.5 * (dz[:, 0:1] + dz[:, 1:2]))
    dn = (f[:, -1:] - f[:, -2:-1]) / (0.5 * (dz[:, -1:] + dz[:, -2:-1]))
    return torch.cat([d0, df, dn], dim=-1)


def _vert_visc_apply(f, nu, dz, beta2):
    """-d/dz(nu df/dz) with stress-free top (k=0) and basal friction
    beta^2 f at the bottom layer (beta2 = inf-like large -> no-slip)."""
    nu_i = 0.5 * (nu[:, 1:] + nu[:, :-1])
    dz_i = 0.5 * (dz[:, 1:] + dz[:, :-1])
    flux = nu_i * (f[:, 1:] - f[:, :-1]) / dz_i       # stress at interfaces
    zero = torch.zeros_like(f[:, :1])
    flux_full = torch.cat([zero, flux, zero], dim=-1)
    out = -(flux_full[:, 1:] - flux_full[:, :-1]) / dz
    # basal drag on the lowest layer (bottom interface stress = beta2*f)
    return add_col(out, -1, beta2 * f[:, -1] / dz[:, -1])


def fo_operator(geom: FoGeom, nu, dz, beta2, u, v):
    """Apply the FO-Stokes linear operator (nu frozen)."""
    ux, uy = _hgrad(geom, u)
    vx, vy = _hgrad(geom, v)
    # membrane stress components
    su_x = nu * (4.0 * ux + 2.0 * vy)
    su_y = nu * (uy + vx)
    sv_x = nu * (uy + vx)
    sv_y = nu * (4.0 * vy + 2.0 * ux)
    # _hdiv is the exact area-weighted adjoint of _hgrad (+G^T), i.e.
    # MINUS the divergence — so "+_hdiv" is the positive-definite
    # -div(sigma) needed for CG
    lu = _hdiv(geom, su_x, su_y) + _vert_visc_apply(u, nu, dz, beta2)
    lv = _hdiv(geom, sv_x, sv_y) + _vert_visc_apply(v, nu, dz, beta2)
    return lu, lv


def _cg(matvec, b_u, b_v, x_u, x_v, iters, owned=None, group=None):
    """Conjugate gradients on the coupled (u, v) system.

    owned: optional (nC,) 1/0 mask for the sharded solve — inner products
    restrict to owned rows and sum across shards (runner.psum_owned over
    `group`), which makes the sharded iteration identical (to roundoff)
    to the global one: the matvec refreshes its operand's halo, owned
    rows of A p match the global rows, and the scalars alpha/beta are
    globally reduced. alpha, beta and the dots stay 0-d device tensors."""
    if owned is None:
        def dot(au, av, bu, bv):
            return (au * bu).sum() + (av * bv).sum()
    else:
        from mpas_tpu_torch.parallel.runner import psum_owned
        ones = torch.ones_like(owned)

        def dot(au, av, bu, bv):
            # where() (not mask-multiply) so a non-finite value in an
            # unowned row can never poison the reduction
            prod = torch.where(owned[:, None] > 0, au * bu + av * bv, 0.0)
            return psum_owned(prod, ones, group)

    lu, lv = matvec(x_u, x_v)
    ru, rv = b_u - lu, b_v - lv
    pu, pv = ru, rv
    rs = dot(ru, rv, ru, rv)
    for _ in range(iters):
        apu, apv = matvec(pu, pv)
        denom = dot(pu, pv, apu, apv)
        alpha = rs / denom.clamp(min=1e-300)
        x_u = x_u + alpha * pu
        x_v = x_v + alpha * pv
        ru = ru - alpha * apu
        rv = rv - alpha * apv
        rs_new = dot(ru, rv, ru, rv)
        beta = rs_new / rs.clamp(min=1e-300)
        pu = ru + beta * pu
        pv = rv + beta * pv
        rs = rs_new
    return x_u, x_v, torch.sqrt(dot(ru, rv, ru, rv))


def solve_fo_stokes(geom: FoGeom, thickness, surface, a_glen, beta2,
                    rho_g, nz: int = 10, picard_iters: int = 12,
                    cg_iters: int = 150, slope=None):
    """Solve the FO-Stokes system on the extruded column.

    thickness, surface: (nC,); a_glen: Glen rate factor (Pa^-3 s^-1,
    scalar or (nC, nz)); beta2: basal friction (Pa s/m; 1e12-like for
    no-slip); rho_g = rho_ice * gravity. slope: optional prescribed mean
    surface slope (sx, sy) ADDED to the gradient of `surface` — the
    ISMIP-HOM setups prescribe a mean slope on a periodic domain where a
    linear surface cannot be represented. Returns (u, v, resid) with
    u, v (nC, nz) at layer midpoints (k=0 surface .. nz-1 base)."""
    return _solve_fo_stokes_impl(geom, thickness, surface, a_glen, beta2,
                                 rho_g, nz, picard_iters, cg_iters, slope)


def _solve_fo_stokes_impl(geom: FoGeom, thickness, surface, a_glen, beta2,
                          rho_g, nz: int = 10, picard_iters: int = 12,
                          cg_iters: int = 150, slope=None, xch=None,
                          owned=None, group=None, resid_out=None):
    """Body of solve_fo_stokes; also the sharded entry. xch:
    runner.ShardExchange — each matvec/viscosity evaluation refreshes its
    operand's cell halo, which is the distributed-Krylov structure of the
    reference's Albany solve (halo import before each apply, plus
    globally-summed dots). resid_out: a list that receives the CG
    residual of each Picard pass (0-d tensors)."""
    nC = thickness.shape[0]
    h = thickness.clamp(min=1.0)
    dz = (h / nz)[:, None].expand(nC, nz)
    sx, sy = _hgrad(geom, surface[:, None])
    if slope is not None:
        sx = sx + slope[0]
        sy = sy + slope[1]
    bu = -rho_g * sx.expand(nC, nz)
    bv = -rho_g * sy.expand(nC, nz)

    a3 = torch.as_tensor(a_glen, dtype=h.dtype, device=h.device)
    if a3.dim() == 0:
        a3 = a3.expand(nC, nz)

    u = torch.zeros((nC, nz), dtype=h.dtype, device=h.device)
    v = torch.zeros_like(u)
    resid = torch.zeros((), dtype=h.dtype, device=h.device)

    def refresh(f):
        return f if xch is None else xch.cell(f)

    for _ in range(picard_iters):
        u, v = refresh(u), refresh(v)
        nu = effective_viscosity(geom, u, v, dz, a3)

        def matvec(uu, vv, nu=nu):
            return fo_operator(geom, nu, dz, beta2, refresh(uu),
                               refresh(vv))

        u, v, resid = _cg(matvec, bu, bv, u, v, cg_iters, owned=owned,
                          group=group)
        if resid_out is not None:
            resid_out.append(resid)
    # the CG updates leave halo rows stale; downstream consumers (edge
    # projection in fo_velocity) read through the halo
    return refresh(u), refresh(v), resid
