"""Mountain-wave idealized case (init case 6), terrain-following grid
(port of mpas_tpu/cores/atmosphere/init_mtn_wave.py).

ref: src/core_init_atmosphere/mpas_init_atm_cases.F:1898-2400
(init_atm_case_mtn_wave): a Schaer-type ridge
    hx(x) = hm exp(-((x-xc)/xa)^2) cos^2(pi (x-xc)/xla),
hm=250 m, xa=5 km, xla=4 km, on a doubly periodic planar mesh, with the
basic terrain-following coordinate
    zgrid(k) = zc(k) (1 - hx/zt) + hx,   zt = 21 km (linear decay),
metric terms zz = d(zeta)/dz and zxu (edge slope, :2204-2210), and a
two-layer stability profile (N^2 = 1e-4, inversion at 3 km, t0=288 K) with
uniform cross-ridge flow. The reference drives the flow along the mesh
y-axis (vm=10); here the flow crosses the ridge (um=10) so the case
actually launches vertically propagating gravity waves.

This exercises the dycore's full terrain path: the zxu pressure-gradient
metric, the zb/zb3 omega lower-boundary terms and the dss damping layer.
Host numpy in float64; returns CPU float64 tensors. Like init_jw and
init_supercell, it builds only the grid fields the factored advection
path reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.constants import cp, cv, gravity, p0, rgas
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.setup import (AtmGrid,
                                                   build_adv_cell_tensors,
                                                   build_adv_factored,
                                                   build_cell_fit_matrices,
                                                   build_deformation_weights,
                                                   build_deriv_two, build_dss,
                                                   build_reconstruct_weights,
                                                   build_vertical_grid,
                                                   build_zb)
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.mesh.mesh import Mesh

RCV = rgas / (cp - rgas)

HM = 250.0           # ridge height (ref :1912 hm=250)
XA = 5000.0          # envelope half-width (ref :2083)
XLA = 4000.0         # cosine wavelength (ref :2084)
ZT = 21000.0         # model top (ref :2088)
T0 = 288.0           # ref :1912
ZINV = 3000.0        # inversion height (ref :2243)
XN2 = 1.0e-4         # N^2 above/below (ref :2244-2246)
UM = 10.0            # cross-ridge wind


def init_mtn_wave(mesh: Mesh, cfg: AtmConfig, um: float = UM,
                  hm: float = HM, xa: float = XA, xla: float = XLA):
    """Build (AtmGrid, AtmState, AtmDiag) with real terrain.

    hm/xa/xla default to the reference's Schaer ridge (designed for
    sub-km grids); pass larger scales on coarser meshes so the ridge is
    resolved (xla >= 4 dx)."""
    if mesh.on_sphere:
        raise ValueError("the mountain-wave case is planar")
    nz1 = cfg.config_nvertlevels
    nz = nz1 + 1
    nC, nE = mesh.nCells, mesh.nEdges
    x = np.asarray(mesh.xCell, dtype=np.float64)
    xc = 0.5 * (x.min() + x.max())

    # ---- vertical zeta grid (uniform, str=1; ref :2095-2116) -------------
    vg, _, _ = build_vertical_grid(nz1, zt=ZT, stretch=1.0)
    zw, dzw = vg.zw.numpy(), vg.dzw.numpy()
    fzm, fzp = vg.fzm.numpy(), vg.fzp.numpy()
    dzu = np.concatenate([[0.0], 0.5 * (dzw[1:] + dzw[:-1]), [0.0]])

    # ---- terrain + terrain-following coordinate (ref :2147-2210) ----------
    xi = x - xc
    hx = hm * np.exp(-(xi / xa) ** 2) * np.cos(np.pi * xi / xla) ** 2
    zgrid = zw[None, :] * (1.0 - hx[:, None] / ZT) + hx[:, None]
    zz = dzw[None, :] / (zgrid[:, 1:] - zgrid[:, :-1])
    coe = np.asarray(mesh.cellsOnEdge)
    c1, c2 = coe[:, 0], coe[:, 1]
    zxu = 0.5 * ((zgrid[c2, :-1] - zgrid[c1, :-1])
                 + (zgrid[c2, 1:] - zgrid[c1, 1:])) \
        * np.asarray(mesh.invDcEdge)[:, None] \
        * (1.0 - np.asarray(mesh.boundaryEdge))[:, None]

    # ---- two-layer stability sounding (ref :2242-2262) --------------------
    zmid = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])
    tb = T0 * (1.0 + 0.0 * zmid)                       # neutral base (xn2m=0)
    t_full = np.where(
        zmid <= ZINV, T0 * (1.0 + XN2 / gravity * zmid),
        T0 * (1.0 + XN2 / gravity * ZINV + XN2 / gravity * (zmid - ZINV)))

    # ---- hydrostatic Exner integration (ref :2277-2301) -------------------
    def pi_columns(theta):
        # shared pi at the (flat) model top from the domain-mean column
        th_m = theta.mean(axis=0)
        zz_m = zz.mean(axis=0)
        pitop = 1.0 - 0.5 * dzw[0] * gravity / (cp * th_m[0] * zz_m[0])
        for k in range(1, nz1):
            th_i = fzm[k] * th_m[k] + fzp[k] * th_m[k - 1]
            zz_i = fzm[k] * zz_m[k] + fzp[k] * zz_m[k - 1]
            pitop = pitop - dzu[k] * gravity / (cp * th_i * zz_i)
        pitop = pitop - 0.5 * dzw[nz1 - 1] * gravity \
            / (cp * th_m[nz1 - 1] * zz_m[nz1 - 1])
        pi = np.zeros((nC, nz1))
        pi[:, nz1 - 1] = pitop + 0.5 * dzw[nz1 - 1] * gravity \
            / (cp * theta[:, nz1 - 1] * zz[:, nz1 - 1])
        for k in range(nz1 - 2, -1, -1):
            pi[:, k] = pi[:, k + 1] + dzu[k + 1] * gravity \
                / (cp * 0.5 * (theta[:, k] + theta[:, k + 1])
                   * 0.5 * (zz[:, k] + zz[:, k + 1]))
        return pi

    pb = pi_columns(tb)
    p = pi_columns(t_full)
    rb = pb ** (1.0 / RCV) / ((rgas / p0) * tb * zz)
    rtb = rb * tb
    rr = p ** (1.0 / RCV) / ((rgas / p0) * t_full * zz) - rb
    rho_zz = rb + rr
    rt = rho_zz * t_full - rtb

    # ---- static coefficient fields -----------------------------------------
    bmats = build_cell_fit_matrices(mesh)
    deriv_two = build_deriv_two(mesh, bmats)
    d2_bmat, d2w = build_adv_factored(mesh, bmats)
    d2w_own, d2w_opp, s_cp, dv_cell = build_adv_cell_tensors(mesh)
    defc_a, defc_b = build_deformation_weights(mesh)
    recon_zonal, recon_merid = build_reconstruct_weights(mesh)
    zb_cell, zb3_cell = build_zb(mesh, vg, zgrid, deriv_two,
                                 cfg.config_theta_adv_order,
                                 cfg.config_coef_3rd_order)
    dss = build_dss(mesh, zgrid, cfg.config_zd, cfg.config_xnutr)

    mesh = dataclasses.replace(
        mesh, fEdge=torch.zeros(nE, dtype=torch.float64),
        fVertex=torch.zeros(mesh.nVertices, dtype=torch.float64),
        fCell=torch.zeros(nC, dtype=torch.float64))

    # ---- winds + coupled diagnostics ---------------------------------------
    ang = np.asarray(mesh.angleEdge, dtype=np.float64)
    u = np.broadcast_to((um * np.cos(ang))[:, None], (nE, nz1)).copy()
    u *= (1.0 - np.asarray(mesh.boundaryEdge))[:, None]
    ru = 0.5 * (rho_zz[c1] + rho_zz[c2]) * u
    pressure_p = zz * rgas * (p * rt + rtb * (p - pb))

    def r(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))

    grid = AtmGrid(
        mesh=mesh, vert=vg,
        zgrid=r(zgrid), zz=r(zz), zxu=r(zxu), dss=r(dss),
        zb_cell=r(zb_cell), zb3_cell=r(zb3_cell),
        defc_a=r(defc_a), defc_b=r(defc_b),
        recon_zonal=r(recon_zonal), recon_merid=r(recon_merid),
        rho_base=r(rb), rtheta_base=r(rtb), exner_base=r(pb),
        pressure_base=r(p0 * (zz * rgas * rtb / p0) ** (cp / cv)),
        d2_bmat=r(d2_bmat), d2w=r(d2w),
        adv_beta=float(cfg.config_coef_3rd_order),
        d2w_own=r(d2w_own), d2w_opp=r(d2w_opp), adv_sside=r(s_cp),
        dv_cell=r(dv_cell))
    state = AtmState(u=r(u), w=r(np.zeros((nC, nz))), theta_m=r(t_full),
                     rho_zz=r(rho_zz), scalars=r(np.zeros((nC, nz1, 1))))
    diag = AtmDiag(ru=r(ru), rw=r(np.zeros((nC, nz))), rho_p=r(rr),
                   rtheta_p=r(rt), exner=r(p), pressure_p=r(pressure_p),
                   ruAvg=r(np.zeros_like(ru)), wwAvg=r(np.zeros((nC, nz))))
    return grid, state, diag
