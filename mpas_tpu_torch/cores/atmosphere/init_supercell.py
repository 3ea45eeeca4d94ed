"""Squall-line / supercell idealized initialization, moist and planar
(port of mpas_tpu/cores/atmosphere/init_supercell.py).

ref: init_atm_case_squall_line, src/core_init_atmosphere/
mpas_init_atm_cases.F:1313-1860 (init cases 4 = squall line, 5 = supercell):
Weisman-Klemp-type sounding with a vapour profile capped at 0.014 kg/kg,
sheared zonal wind, a 3 K warm bubble, and two 30-iteration balance solves
(the moist hydrostatic sounding, then the non-hydrostatic perturbation
pressure of the bubble). Flat terrain, uniform dz, zt = 20 km, f = 0, on a
doubly periodic plane.

The horizontally uniform sounding is solved once as one column and
broadcast; the bubble's pressure solve is vectorized over cells. Host
numpy in float64; returns CPU float64 tensors. Like init_jw, it builds only
the grid fields the factored advection path reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.constants import cp, cv, gravity, p0, pii, rgas
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

ZT = 20000.0
ZTR = 12000.0      # tropopause height (ref :1592)
THETAR = 343.0     # tropopause theta
TTR = 213.0        # tropopause temperature
THETAS = 300.5     # surface theta floor
DELT = 3.0         # bubble amplitude [K] (ref :1745)
RADX = 10000.0     # bubble horizontal radius
RADZ = 1500.0      # bubble vertical radius
ZCENT = 1500.0     # bubble centre height
QV_MAX = 0.014     # vapour cap (ref :1700)

RCP = rgas / cp
RCV = rgas / (cp - rgas)


def _sounding_theta_relhum(zmid):
    """Analytic theta / relative-humidity profiles (ref :1610-1620)."""
    frac = np.minimum(zmid / ZTR, 1.0) ** 1.25
    theta = np.where(zmid > ZTR,
                     THETAR * np.exp(9.8 * (zmid - ZTR) / (1003.0 * TTR)),
                     np.maximum(300.0 + 43.0 * frac, THETAS))
    relhum = np.where(zmid > ZTR, 0.25, 1.0 - 0.75 * frac)
    return theta, relhum


def _hydrostatic_pi_top(t, qv_sfc, qv_top, cqw, dzw, dzu):
    """Column-integrated Exner at the model top (ref :1654-1668)."""
    nz1 = t.shape[0]
    pitop = 1.0 - 0.5 * dzw[0] * gravity * (1.0 + qv_sfc) / (cp * t[0])
    for k in range(1, nz1):
        pitop -= dzu[k] * gravity / (cp * cqw[k] * 0.5 * (t[k] + t[k - 1]))
    pitop -= 0.5 * dzw[nz1 - 1] * gravity * (1.0 + qv_top) / (cp * t[nz1 - 1])
    return pitop


def _integrate_pi_down(pitop, t, qv_top, cqw, dzw, dzu):
    """Exner from the top down (ref :1674-1682); zz == 1 (flat)."""
    nz1 = t.shape[0]
    p = np.zeros(nz1)
    p[nz1 - 1] = pitop + 0.5 * dzw[nz1 - 1] * gravity * (1.0 + qv_top) \
        / (cp * t[nz1 - 1])
    for k in range(nz1 - 2, -1, -1):
        p[k] = p[k + 1] + dzu[k + 1] * gravity \
            / (cp * cqw[k + 1] * 0.5 * (t[k] + t[k + 1]))
    return p


def init_supercell(mesh: Mesh, cfg: AtmConfig, case: int = 5):
    """Build (AtmGrid, AtmState, AtmDiag) on a doubly periodic planar mesh.

    case=4 squall line (um=12, us=10, zts=2500); case=5 supercell
    (um=30, us=15, zts=5000) (ref :1626-1634). Scalars carry (qv, qc, qr)."""
    if mesh.on_sphere:
        raise ValueError("the squall-line/supercell cases are planar")
    if case == 4:
        um, us, zts = 12.0, 10.0, 2500.0
    else:
        um, us, zts = 30.0, 15.0, 5000.0

    nz1 = cfg.config_nvertlevels
    nz = nz1 + 1
    nC, nE = mesh.nCells, mesh.nEdges

    vg, _, _ = build_vertical_grid(nz1, zt=ZT, stretch=1.0)
    dzw = vg.dzw.numpy()
    dzu = np.concatenate([[0.0], 0.5 * (dzw[1:] + dzw[:-1]), [0.0]])
    fzm, fzp = vg.fzm.numpy(), vg.fzp.numpy()
    zw = vg.zw.numpy()
    zmid1d = 0.5 * (zw[:-1] + zw[1:])

    # flat terrain: zgrid uniform, zz = 1, zxu = 0 (ref :1560-1576, hx=0)
    zgrid = np.broadcast_to(zw, (nC, nz)).copy()
    zz = np.ones((nC, nz1))
    zxu = np.zeros((nE, nz1))

    # ---- base/full sounding, 30-iteration moist balance (ref :1654-1720) ---
    thi1d, relhum1d = _sounding_theta_relhum(zmid1d)
    tbi1d = thi1d.copy()
    qv1d = np.zeros(nz1)
    t1d = thi1d.copy()        # theta_m column
    tb1d = tbi1d.copy()       # base theta_m (dry: qvb = 0, ref :1707)
    cqw1d = np.ones(nz1)
    cqwb1d = np.ones(nz1)
    for _ in range(30):
        pitop = _hydrostatic_pi_top(t1d, qv1d[0], qv1d[-1], cqw1d, dzw, dzu)
        pibtop = _hydrostatic_pi_top(tb1d, 0.0, 0.0, cqwb1d, dzw, dzu)
        p1d = _integrate_pi_down(pitop, t1d, qv1d[-1], cqw1d, dzw, dzu)
        pb1d = _integrate_pi_down(pibtop, tb1d, 0.0, cqwb1d, dzw, dzu)
        # vapour from relative humidity at the current state (ref :1694-1700)
        temp = p1d * thi1d
        pres = p0 * p1d ** (1.0 / RCP)
        qvs = 380.0 * np.exp(17.27 * (temp - 273.0) / (temp - 36.0)) / pres
        qv1d = np.minimum(QV_MAX, relhum1d * qvs)
        t1d = thi1d * (1.0 + 1.61 * qv1d)
        cqw1d[1:] = 1.0 / (1.0 + 0.5 * (qv1d[1:] + qv1d[:-1]))

    rb1d = pb1d ** (1.0 / RCV) / ((rgas / p0) * tb1d)
    rtb1d = rb1d * tb1d
    rr1d = p1d ** (1.0 / RCV) / ((rgas / p0) * t1d) - rb1d
    ptopb = p0 * pibtop ** (1.0 / RCP)

    def bc(col):
        return np.broadcast_to(col, (nC, nz1)).copy()

    thi = bc(thi1d)
    qv = bc(qv1d)
    tb = bc(tb1d)
    rb = bc(rb1d)
    rtb = bc(rtb1d)
    rr = bc(rr1d)
    pb = bc(pb1d)
    p = bc(p1d)

    # ---- warm bubble (ref :1736-1775) --------------------------------------
    x = np.asarray(mesh.xCell, dtype=np.float64)
    y = np.asarray(mesh.yCell, dtype=np.float64)
    xloc = (x - 0.5 * x.max())[:, None]
    yloc = (y - 0.5 * y.max())[:, None] if case == 5 else np.zeros((nC, 1))
    rad = np.sqrt((xloc / RADX) ** 2 + (yloc / RADX) ** 2
                  + ((zmid1d[None, :] - ZCENT) / RADZ) ** 2)
    thi = thi + np.where(rad < 1.0, DELT * np.cos(0.5 * pii * rad) ** 2, 0.0)
    t = thi * (1.0 + 1.61 * qv)

    # ---- perturbation pressure iteration (ref :1779-1820) ------------------
    # pitop from the unperturbed sounding column (the reference uses cell 1,
    # which lies outside the centred bubble)
    pp = np.zeros((nC, nz1))
    rt = np.zeros((nC, nz1))
    for _ in range(30):
        pitop = _hydrostatic_pi_top(t1d, qv1d[0], qv1d[-1], cqw1d, dzw, dzu)
        ptop = p0 * pitop ** (1.0 / RCP)
        pp[:, nz1 - 1] = ptop - ptopb + 0.5 * dzw[nz1 - 1] * gravity \
            * (rr[:, nz1 - 1] + (rr[:, nz1 - 1] + rb[:, nz1 - 1])
               * qv[:, nz1 - 1])
        for k in range(nz1 - 2, -1, -1):
            pp[:, k] = pp[:, k + 1] + dzu[k + 1] * gravity * (
                fzm[k + 1] * (rb[:, k + 1] * qv[:, k + 1]
                              + rr[:, k + 1] * (1.0 + qv[:, k + 1]))
                + fzp[k + 1] * (rb[:, k] * qv[:, k]
                                + rr[:, k] * (1.0 + qv[:, k])))
        rt = (pp / rgas - rtb * (p - pb)) / p
        p = ((rgas / p0) * (rtb + rt)) ** RCV
        rr = (rt - rb * (t - tb)) / t

    rho_zz = rb + rr

    # ---- winds (ref :1636-1650): sheared zonal profile ---------------------
    coe = np.asarray(mesh.cellsOnEdge)
    c1, c2 = coe[:, 0], coe[:, 1]
    ze = 0.25 * (zgrid[c1, :-1] + zgrid[c1, 1:]
                 + zgrid[c2, :-1] + zgrid[c2, 1:])
    uprof = np.where(ze < zts, um * ze / zts, um)
    angle = np.asarray(mesh.angleEdge, dtype=np.float64)
    u = np.cos(angle)[:, None] * (uprof - us)

    # f = 0 on the plane (ref :1838-1844)
    mesh = dataclasses.replace(mesh, fEdge=torch.zeros(nE, dtype=torch.float64),
                               fVertex=torch.zeros(mesh.nVertices,
                                                   dtype=torch.float64),
                               fCell=torch.zeros(nC, dtype=torch.float64))

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

    # ---- coupled diagnostics (flat: w = rw = 0, ref :1826-1834) ------------
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
    scalars = np.zeros((nC, nz1, 3))
    scalars[:, :, 0] = qv
    state = AtmState(u=r(u), w=r(np.zeros((nC, nz))), theta_m=r(t),
                     rho_zz=r(rho_zz), scalars=r(scalars))
    diag = AtmDiag(ru=r(ru), rw=r(np.zeros((nC, nz))), rho_p=r(rr),
                   rtheta_p=r(rt), exner=r(p), pressure_p=r(pressure_p),
                   ruAvg=r(np.zeros_like(ru)), wwAvg=r(np.zeros((nC, nz))))
    return grid, state, diag
