# Frozen copy of mpas_tpu_torch/cores/atmosphere/init_jw.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Jablonowski & Williamson (2006) baroclinic wave initialization, dry
(port of mpas_tpu/cores/atmosphere/init_jw.py).

ref: init_atm_case_jw, src/core_init_atmosphere/mpas_init_atm_cases.F:367-1160
(cases 1-3: unperturbed / Gaussian perturbation / normal-mode perturbation).
Vectorized over columns; the per-column double-iteration hydrostatic
balance (10 outer x 25 inner) is reproduced exactly. Winds use the
original JW analytic profile (ref :951-966, rebalance=False branch).

Also builds the AtmGrid and the coupled diagnostics, so one call yields a
ready-to-step model. Host numpy in float64; returns CPU float64 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.constants import a as EARTH_RADIUS
from benchmark.reference.constants import cp, gravity, omega, p0, pii, rgas
from benchmark.reference.atmosphere.config import AtmConfig
from benchmark.reference.atmosphere.setup import (AtmGrid,
                                                   build_adv_cell_tensors,
                                                   build_adv_factored,
                                                   build_cell_fit_matrices,
                                                   build_deformation_weights,
                                                   build_deriv_two, build_dss,
                                                   build_reconstruct_weights,
                                                   build_vertical_grid,
                                                   build_zb)
from benchmark.reference.atmosphere.state import AtmDiag, AtmState
from benchmark.reference.mesh.build import compute_mesh_scaling
from benchmark.reference.mesh.mesh import Mesh

# JW constants (ref: mpas_init_atm_cases.F:372-386)
U0 = 35.0
T0B = 250.0
T0 = 288.0
DELTA_T = 4.8e5
DTDZ = 0.005
ETA_T = 0.2
U_PERTURBATION = 1.0
PERT_RADIUS = 0.1
LATITUDE_PERT = 40.0
LONGITUDE_PERT = 20.0
K_X = 9.0  # normal-mode wave number (case 3)
ZT = 45000.0


def _hx_profile(lat, r_earth, u0):
    """Surface geopotential height / g (ref :598-608)."""
    etavs = (1.0 - 0.252) * pii / 2.0
    return u0 / gravity * np.cos(etavs) ** 1.5 * (
        (-2.0 * np.sin(lat) ** 6 * (np.cos(lat) ** 2 + 1.0 / 3.0)
         + 10.0 / 63.0) * u0 * np.cos(etavs) ** 1.5
        + (1.6 * np.cos(lat) ** 3 * (np.sin(lat) ** 2 + 2.0 / 3.0)
           - pii / 4.0) * r_earth * omega)


def _sphere_distance(lat1, lon1, lat2, lon2, radius):
    arg = np.sqrt(np.sin(0.5 * (lat2 - lat1)) ** 2
                  + np.cos(lat1) * np.cos(lat2)
                  * np.sin(0.5 * (lon2 - lon1)) ** 2)
    return 2.0 * radius * np.arcsin(np.clip(arg, -1.0, 1.0))


def init_jw(mesh: Mesh, cfg: AtmConfig, case: int = 2,
            n_scalars: int = 1, u0: float = U0, radius: float = EARTH_RADIUS):
    """Build (AtmGrid, AtmState, AtmDiag) for JW cases 1/2/3 on a
    unit-sphere mesh, scaled to `radius` here like the reference init.
    u0=0 gives a resting atmosphere over flat terrain; radius < Earth's
    gives the reduced-radius ("small planet") configuration. With
    config_h_ScaleWithMesh the dissipation scales with meshDensity."""
    if cfg.config_h_ScaleWithMesh:
        mesh = compute_mesh_scaling(mesh, True)
    mesh = mesh.scaled(radius)
    nz = cfg.config_nvertlevels
    nC, nE = mesh.nCells, mesh.nEdges
    r_earth = radius

    vg, sh, ah = build_vertical_grid(nz, zt=ZT, stretch=1.5)
    zw, dzw = vg.zw.numpy(), vg.dzw.numpy()
    fzm, fzp = vg.fzm.numpy(), vg.fzp.numpy()
    latC = np.asarray(mesh.latCell, dtype=np.float64)
    latE = np.asarray(mesh.latEdge, dtype=np.float64)
    lonE = np.asarray(mesh.lonEdge, dtype=np.float64)
    latV = np.asarray(mesh.latVertex, dtype=np.float64)
    coe = np.asarray(mesh.cellsOnEdge)
    voe = np.asarray(mesh.verticesOnEdge)

    # --- terrain-following heights (ref :631-684) --------------------------
    hx = _hx_profile(latC, r_earth, u0)
    zgrid = ((1.0 - ah)[None, :] * (sh[None, :] * (ZT - hx[:, None])
                                    + hx[:, None])
             + ah[None, :] * sh[None, :] * ZT)             # (nC, nz+1)
    dzw_nominal = (zw[1:] - zw[:-1])[None, :]
    zz = dzw_nominal / (zgrid[:, 1:] - zgrid[:, :-1])      # (nC, nz)
    c1, c2 = coe[:, 0], coe[:, 1]
    zxu = 0.5 * ((zgrid[c2, :-1] - zgrid[c1, :-1])
                 + (zgrid[c2, 1:] - zgrid[c1, 1:])) \
        / np.asarray(mesh.dcEdge)[:, None]                 # (nE, nz)

    # --- base state (ref :841-855) -----------------------------------------
    zmid = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])
    ppb = p0 * np.exp(-gravity * zmid / (rgas * T0B))
    pb = (ppb / p0) ** (rgas / cp)
    rb = ppb / (rgas * T0B * zz)
    tb = T0B / pb

    # --- hydrostatic iteration (ref :860-930, dry) -------------------------
    dzu = np.zeros(nz + 1)
    dzu[1:nz] = 0.5 * (dzw[1:] + dzw[:-1])
    pp = np.zeros((nC, nz))
    rr = np.zeros((nC, nz))
    phi = latC[:, None]
    for _ in range(10):
        eta = (ppb + pp) / p0
        etav = (eta - 0.252) * pii / 2.0
        teta = np.where(eta >= ETA_T,
                        T0 * eta ** (rgas * DTDZ / gravity),
                        T0 * eta ** (rgas * DTDZ / gravity)
                        + DELTA_T * np.maximum(ETA_T - eta, 0.0) ** 5)
        tt = teta + 0.75 * eta * pii * u0 / rgas * np.sin(etav) \
            * np.sqrt(np.cos(etav)) * (
                (-2.0 * np.sin(phi) ** 6 * (np.cos(phi) ** 2 + 1.0 / 3.0)
                 + 10.0 / 63.0) * 2.0 * u0 * np.cos(etav) ** 1.5
                + (1.6 * np.cos(phi) ** 3 * (np.sin(phi) ** 2 + 2.0 / 3.0)
                   - pii / 4.0) * r_earth * omega)
        # inner-loop invariants (tt is fixed within the 25 relaxations)
        inv_tt = 1.0 / tt
        p_fac = inv_tt / (rgas * zz)
        r_off = rb * (tt - T0B) * inv_tt
        cm = -dzu[1:nz] * gravity * fzp[1:nz]
        cp_ = -dzu[1:nz] * gravity * fzm[1:nz]
        base0 = p0 - ppb[:, 0]
        rr_b = np.empty_like(pp)
        incr_b = np.empty((nC, nz - 1))
        ppi_b = np.empty((nC, nz))
        scr = np.empty((nC, nz - 1))
        for _ in range(25):
            np.multiply(pp, p_fac, out=rr_b)
            rr_b -= r_off
            rr = rr_b
            ppi0 = base0 - 0.5 * dzw[0] * gravity \
                * (1.25 * (rr[:, 0] + rb[:, 0])
                   - 0.25 * (rr[:, 1] + rb[:, 1]))
            # hydrostatic downward integration as a cumulative sum
            np.multiply(rr[:, :-1], cm, out=incr_b)
            np.multiply(rr[:, 1:], cp_, out=scr)
            incr_b += scr
            ppi_b[:, 0] = 0.0
            np.cumsum(incr_b, axis=1, out=ppi_b[:, 1:])
            ppi_b += ppi0[:, None]
            pp *= 0.8
            ppi_b *= 0.2
            pp += ppi_b
    exner = ((ppb + pp) / p0) ** (rgas / cp)
    theta = tt / exner
    rho_zz = rb + rr

    # --- winds (ref :951-1000, rebalance=False branch) ---------------------
    lat1 = latV[voe[:, 0]]
    lat2 = latV[voe[:, 1]]
    dv = np.asarray(mesh.dvEdge, dtype=np.float64)
    flux_w = (0.5 * (lat2 - lat1)
              - 0.125 * (np.sin(4.0 * lat2) - np.sin(4.0 * lat1))) \
        * r_earth / dv
    lat_pert = LATITUDE_PERT * pii / 180.0
    lon_pert = LONGITUDE_PERT * pii / 180.0
    if case == 2:
        r_pert = _sphere_distance(latE, lonE, lat_pert, lon_pert, 1.0) \
            / PERT_RADIUS
        u_pert = U_PERTURBATION * np.exp(-r_pert ** 2) * (lat2 - lat1) \
            * r_earth / dv
    elif case == 3:
        u_pert = U_PERTURBATION * np.cos(K_X * (lonE - lon_pert)) * flux_w
    else:
        u_pert = np.zeros(nE)
    etavs_e = (0.5 * (ppb[c1] + ppb[c2] + pp[c1] + pp[c2]) / p0 - 0.252) \
        * pii / 2.0
    u = u0 * flux_w[:, None] * np.cos(etavs_e) ** 1.5 + u_pert[:, None]

    # --- Coriolis ----------------------------------------------------------
    t = torch.from_numpy
    mesh = dataclasses.replace(mesh, fEdge=t(2.0 * omega * np.sin(latE)),
                               fVertex=t(2.0 * omega * np.sin(latV)),
                               fCell=t(2.0 * omega * np.sin(latC)))

    # --- advection / deformation / omega-metric coefficients ---------------
    bmats = build_cell_fit_matrices(mesh)
    deriv_two = build_deriv_two(mesh, bmats)
    d2_bmat, d2w = build_adv_factored(mesh, bmats)
    d2w_own, d2w_opp, s_cp, dv_cell = build_adv_cell_tensors(mesh)
    defc_a, defc_b = build_deformation_weights(mesh)
    recon_zonal, recon_merid = build_reconstruct_weights(mesh)
    zb_cell, zb3_cell = build_zb(mesh, vg, zgrid, deriv_two,
                                 cfg.config_theta_adv_order,
                                 cfg.config_coef_3rd_order)
    # the model applies its own w-damping profile at startup (ref:
    # atm_compute_damping_coefs with namelist config_zd/config_xnutr)
    dss = build_dss(mesh, zgrid, cfg.config_zd, cfg.config_xnutr)

    # --- coupled diagnostics (ref: atm_init_coupled_diagnostics) -----------
    ru = 0.5 * (rho_zz[c1] + rho_zz[c2]) * u
    eoc = np.asarray(mesh.edgesOnCell)
    sign = np.asarray(mesh.edgeSignOnCell)
    zz_int = np.zeros((nC, nz + 1))
    zz_int[:, 1:nz] = fzm[1:nz] * zz[:, 1:] + fzp[1:nz] * zz[:, :-1]
    ru_int = np.zeros((nE, nz + 1))
    ru_int[:, 1:nz] = fzm[1:nz] * ru[:, 1:] + fzp[1:nz] * ru[:, :-1]
    rho_int = np.zeros((nC, nz + 1))
    rho_int[:, 1:nz] = fzm[1:nz] * rho_zz[:, 1:] + fzp[1:nz] * rho_zz[:, :-1]

    # metric part of rho*omega (ref: mpas_atm_time_integration.F:5944-5956)
    rw_metric = np.zeros((nC, nz + 1))
    for i in range(mesh.maxEdges):
        flux = ru_int[eoc[:, i]]
        zbz3 = zb_cell[i] + np.sign(flux) * zb3_cell[i]
        rw_metric -= sign[:, i:i + 1] * zbz3 * flux * zz_int
    # initial w diagnosed from the metric flux (ref :1043-1075: no zz
    # division there)
    w = np.zeros((nC, nz + 1))
    w[:, 1:nz] = rw_metric[:, 1:nz] / rho_int[:, 1:nz]
    rw = w * rho_int * zz_int + rw_metric
    rw[:, 0] = 0.0
    rw[:, nz] = 0.0

    rho_p = rho_zz - rb
    theta_m = theta  # dry
    rtheta_base = rb * tb
    rtheta_p = theta_m * rho_p + rb * (theta_m - tb)
    rcv = rgas / (cp - rgas)
    exner_full = (zz * (rgas / p0) * (rtheta_p + rtheta_base)) ** rcv
    exner_b = (zz * (rgas / p0) * rtheta_base) ** rcv
    pressure_p = zz * rgas * (exner_full * rtheta_p
                              + rtheta_base * (exner_full - exner_b))

    def r(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))

    grid = AtmGrid(
        mesh=mesh, vert=vg,
        zgrid=r(zgrid), zz=r(zz), zxu=r(zxu), dss=r(dss),
        zb_cell=r(zb_cell), zb3_cell=r(zb3_cell),
        defc_a=r(defc_a), defc_b=r(defc_b),
        recon_zonal=r(recon_zonal), recon_merid=r(recon_merid),
        rho_base=r(rb), rtheta_base=r(rtheta_base), exner_base=r(exner_b),
        pressure_base=r(zz * rgas * exner_b * rtheta_base),
        d2_bmat=r(d2_bmat), d2w=r(d2w),
        adv_beta=float(cfg.config_coef_3rd_order),
        d2w_own=r(d2w_own), d2w_opp=r(d2w_opp), adv_sside=r(s_cp),
        dv_cell=r(dv_cell))
    state = AtmState(u=r(u), w=r(w), theta_m=r(theta_m), rho_zz=r(rho_zz),
                     scalars=r(np.zeros((nC, nz, n_scalars))))
    diag = AtmDiag(ru=r(ru), rw=r(rw), rho_p=r(rho_p), rtheta_p=r(rtheta_p),
                   exner=r(exner_full), pressure_p=r(pressure_p),
                   ruAvg=r(np.zeros_like(ru)), wwAvg=r(np.zeros((nC, nz + 1))))
    return grid, state, diag
