"""Nonhydrostatic split-explicit RK3 dynamics (port of
mpas_tpu/cores/atmosphere/nhyd.py).

ref: src/core_atmosphere/dynamics/mpas_atm_time_integration.F
  solve_diagnostics      <- atm_compute_solve_diagnostics_work (:5513)
  smagorinsky_kdiff      <- 2d_smagorinsky block of dyn_tend (:4668-4700)
  compute_dyn_tend       <- atm_compute_dyn_tend_work (:4481)
  vert_imp_coefs         <- atm_compute_vert_imp_coefs_work (:2012)
  set_smlstep_pert       <- atm_set_smlstep_pert_variables_work (:2224)
  acoustic_step          <- atm_advance_acoustic_step_work (:2447)
  divergence_damping_3d  <- atm_divergence_damping_3d (:2726)
  recover_large_step     <- atm_recover_large_step_variables_work (:2909)
  compute_moist_coefficients <- atm_compute_moist_coefficients (:1862)

Layout: levels minor, (nCells, nz) and (nCells, nz+1); horizontal stencils
are destination-side gathers over the whole column. The moist coupling
(cqu, cqw, qtot, rt_diabatic_tend) enters through optional arguments whose
default None is the dry path (cqu=cqw=1, qtot=0, no diabatic tendency),
which then runs none of the moist terms. Where the reference rebinds a
name to an updated copy (`x.at[:, 0].set(0.0)`), this port writes into the
freshly computed tensor in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from mpas_tpu_torch.constants import cp, gravity, omega, p0, rgas
from mpas_tpu_torch.cores.atmosphere.advection import (
    advective_tendencies_cell)
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.setup import AtmGrid
from mpas_tpu_torch.framework.timers import span, spanned
from mpas_tpu_torch.kernels.acoustic import acoustic_cell_update
from mpas_tpu_torch.ops.stencils import (tangential_cell_assembled,
                                         trisk_q_cell_assembled)
from mpas_tpu_torch.ops.vscan import thomas_prefactor

SECONDS_PER_DAY = 86400.0

RCV = rgas / (cp - rgas)
C2 = cp * RCV


# ---------------------------------------------------------------------------
# vertical helpers (levels k=0..nz-1; interfaces i=0..nz)
# ---------------------------------------------------------------------------

def to_interface(x, fzm, fzp):
    """Level field -> interface field (0 at bottom/top).
    interface i (1..nz-1): fzm[i]*x[i] + fzp[i]*x[i-1]."""
    nz = x.shape[-1]
    return F.pad(fzm[1:nz] * x[..., 1:] + fzp[1:nz] * x[..., :-1], (1, 1))


def flux3_vertical(x, mass_int, fzm, fzp, coef3):
    """3rd/4th-order vertical flux of level field x with interface mass
    flux: 0 at the ends, 2nd order at i=1 and i=nz-1, flux3 at i=2..nz-2
    (ref: the wduz/wdtz statement functions, :4658-4663)."""
    nz = x.shape[-1]
    second = mass_int[..., 1:nz] * (fzm[1:nz] * x[..., 1:]
                                    + fzp[1:nz] * x[..., :-1])
    qm2 = x[..., 0:nz - 3]
    qm1 = x[..., 1:nz - 2]
    qi = x[..., 2:nz - 1]
    qp1 = x[..., 3:nz]
    m = mass_int[..., 2:nz - 1]
    f4 = m * (7.0 * (qi + qm1) - (qp1 + qm2)) / 12.0
    f3 = f4 + coef3 * torch.abs(m) * ((qp1 - qm2) - 3.0 * (qi - qm1)) / 12.0
    return F.pad(torch.cat([second[..., :1], f3,
                            second[..., nz - 2:nz - 1]], dim=-1), (1, 1))


def _add_interior(x, delta):
    """x + delta on interface rows 1..nz-1, identity at 0 and nz."""
    return x + F.pad(delta, (1, 1))


def _slot_sum(rows, weights, field):
    """sum_s weights[:, s] * field[rows[:, s]] -> (nRows, K)."""
    return (weights[..., None] * field[rows]).sum(1)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

class AtmSolveDiag(NamedTuple):
    rho_edge: Any       # (nE, nz)
    ke: Any             # (nC, nz)
    divergence: Any     # (nC, nz)
    vorticity: Any      # (nV, nz)
    pv_edge: Any        # (nE, nz)
    v: Any              # (nE, nz) tangential velocity


def solve_diagnostics(grid: AtmGrid, cfg: AtmConfig, u, rho_zz, dt,
                      reconstruct_v: bool = True, v_prev=None):
    """ref: atm_compute_solve_diagnostics_work (:5513). h == rho_zz here."""
    mesh = grid.mesh
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    v1, v2 = mesh.verticesOnEdge[:, 0], mesh.verticesOnEdge[:, 1]
    inv_a = mesh.invAreaCell[:, None]
    inv_t = mesh.invAreaTriangle[:, None]

    rho_edge = 0.5 * (rho_zz[c1] + rho_zz[c2])
    ke_edge = (mesh.dcEdge * mesh.dvEdge)[:, None] * u * u
    vorticity = _slot_sum(mesh.edgesOnVertex, mesh.curlW, u) * inv_t
    divergence = _slot_sum(mesh.edgesOnCell, mesh.divW, u) * inv_a
    ke = 0.25 * _slot_sum(mesh.edgesOnCell, mesh.edgesOnCellMask,
                          ke_edge) * inv_a

    # Hollingsworth correction (ref :5607-5652): blend cell KE with
    # vertex-remapped KE, ke_fact = 1 - 0.375; padded edgesOnVertex slots
    # are masked by |edgeSignOnVertex|
    ke_vertex = 0.25 * _slot_sum(mesh.edgesOnVertex,
                                 torch.abs(mesh.edgeSignOnVertex),
                                 ke_edge) * inv_t
    ke_fact = 1.0 - 0.375
    pv_vertex = mesh.fVertex[:, None] + vorticity       # no 1/rho (ref :5707)
    ke = ke_fact * ke + (1.0 - ke_fact) \
        * _slot_sum(mesh.verticesOnCell, mesh.kiteAreasOnCell,
                    ke_vertex) * inv_a

    if reconstruct_v or v_prev is None:
        v = tangential_cell_assembled(mesh, u)
    else:
        v = v_prev

    pv1, pv2 = pv_vertex[v1], pv_vertex[v2]
    pv_edge = 0.5 * (pv1 + pv2)
    if cfg.config_apvm_upwinding > 0.0:
        pv_cell = _slot_sum(mesh.verticesOnCell, mesh.kiteAreasOnCell,
                            pv_vertex) * inv_a
        gradPVt = (pv2 - pv1) * mesh.invDvEdge[:, None]
        gradPVn = (pv_cell[c2] - pv_cell[c1]) * mesh.invDcEdge[:, None]
        r = cfg.config_apvm_upwinding * dt
        pv_edge = pv_edge - r * (v * gradPVt + u * gradPVn)

    return AtmSolveDiag(rho_edge=rho_edge, ke=ke, divergence=divergence,
                        vorticity=vorticity, pv_edge=pv_edge, v=v)


def smagorinsky_kdiff(grid: AtmGrid, cfg: AtmConfig, u, v, dt):
    """2d_smagorinsky eddy viscosity (ref :4668-4690)."""
    eoc = grid.mesh.edgesOnCell
    gu, gv = u[eoc], v[eoc]                             # (nC, mE, nz)
    a = grid.defc_a[..., None]
    b = grid.defc_b[..., None]
    d_diag = (a * gu - b * gv).sum(1)
    d_off = (b * gu + a * gv).sum(1)
    ls = cfg.config_smagorinsky_coef * cfg.config_len_disp
    return torch.clamp(ls * ls * torch.sqrt(d_diag ** 2 + d_off ** 2),
                       max=0.01 * cfg.config_len_disp ** 2 / dt)


def reconstruct_cell_winds(grid: AtmGrid, u):
    """Cell-centred (zonal, meridional) winds (nCells, nz) via per-cell LSQ
    weights (stands in for the RBF reconstruction,
    ref: mpas_vector_reconstruction.F:195)."""
    eoc = grid.mesh.edgesOnCell
    return (_slot_sum(eoc, grid.recon_zonal, u),
            _slot_sum(eoc, grid.recon_merid, u))


# ---------------------------------------------------------------------------
# large-step tendencies (ref: atm_compute_dyn_tend_work :4481)
# ---------------------------------------------------------------------------

class EulerTends(NamedTuple):
    """Forward-Euler mixing+pgf tendencies computed on rk_step 1 and reused
    (ref: 'mixing terms are integrated using forward-Euler' :4618)."""
    tend_u_euler: Any
    tend_w_euler: Any
    tend_theta_euler: Any
    kdiff: Any
    dpdz: Any
    tend_rho: Any


def _vertical_laplacian(f, zgrid):
    """d2f/dz2 at the interior levels on the layer midpoints of zgrid
    (nz+1 interfaces), zero at the bottom and top levels."""
    zmid = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])
    dzp = zmid[:, 2:] - zmid[:, 1:-1]
    dzm = zmid[:, 1:-1] - zmid[:, :-2]
    lap = ((f[:, 2:] - f[:, 1:-1]) / dzp
           - (f[:, 1:-1] - f[:, :-2]) / dzm) / (0.5 * (dzp + dzm))
    return F.pad(lap, (1, 1))


def compute_moist_coefficients(grid: AtmGrid, scalars):
    """Moisture coupling coefficients (ref: atm_compute_moist_coefficients,
    mpas_atm_time_integration.F:1862-1933): qtot = qv+qc+qr (the first
    three scalars) at cells, cqw = 1/(1+qtot) at cell interfaces,
    cqu = 1/(1+qtot) at edges. Returns (qtot (nC,nz), cqw (nC,nz+1),
    cqu (nE,nz))."""
    mesh = grid.mesh
    qtot = scalars[..., :3].sum(-1)
    cqw = 1.0 / (1.0 + F.pad(0.5 * (qtot[:, 1:] + qtot[:, :-1]), (1, 1)))
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    cqu = 1.0 / (1.0 + 0.5 * (qtot[c1] + qtot[c2]))
    return qtot, cqw, cqu


@spanned("atm.dyn_tend")
def compute_dyn_tend(grid: AtmGrid, cfg: AtmConfig, rk_step: int, dt,
                     u, w, theta_m, rho_zz, diag: AtmSolveDiag,
                     ru, rw, ru_save, rw_save, theta_m_save, rho_p_save,
                     pressure_p, ur_cell, vr_cell,
                     euler: EulerTends | None, cqu=None, cqw=None,
                     qtot=None, rt_diabatic_tend=None):
    """Large-step tendencies; the moist arguments default to the dry path.
    Returns (tend_u, tend_rho, tend_theta, tend_w_raw, h_divergence,
    euler); tend_w_raw is the physical-w tendency before the omega
    conversion of set_smlstep_pert_variables."""
    mesh = grid.mesh
    vg = grid.vert
    nz = vg.nz
    fzm, fzp, rdzw, rdzu = vg.fzm, vg.fzp, vg.rdzw, vg.rdzu
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    v1, v2 = mesh.verticesOnEdge[:, 0], mesh.verticesOnEdge[:, 1]
    eoc = mesh.edgesOnCell
    inva = mesh.invAreaCell[:, None]
    r_dc = mesh.invDcEdge[:, None]
    inv_r_earth = 1.0 / mesh.sphere_radius if mesh.on_sphere else 0.0
    smag = cfg.config_horiz_mixing == "2d_smagorinsky"
    if smag:
        h_mom_visc4 = cfg.config_visc4_2dsmag * cfg.config_len_disp ** 3
        h_theta_visc4 = h_mom_visc4
    else:
        h_mom_visc4 = cfg.config_h_mom_eddy_visc4
        h_theta_visc4 = cfg.config_h_theta_eddy_visc4

    # --- h_divergence (ref :4706-4729) -------------------------------------
    h_divergence = _slot_sum(eoc, mesh.divW, ru) * inva

    # --- rk_step 1: tend_rho, dpdz, kdiff (ref :4737-4766) -----------------
    if rk_step == 1:
        tend_rho = -h_divergence - rdzw * (rw[:, 1:] - rw[:, :-1])
        if qtot is None:
            dpdz = -gravity * rho_p_save      # dry: qtot=0 (ref :4763)
        else:
            dpdz = -gravity * (grid.rho_base * qtot
                               + rho_p_save * (1.0 + qtot))  # (ref :4763)
        if smag:
            kdiff = smagorinsky_kdiff(grid, cfg, u, diag.v, dt)
        else:
            kdiff = torch.full_like(h_divergence,
                                    cfg.config_h_theta_eddy_visc2)
    else:
        tend_rho = euler.tend_rho
        dpdz = euler.dpdz
        kdiff = euler.kdiff

    # --- u tendency (ref :4770-4830) ----------------------------------------
    with span("atm.dyn_tend.u"):
        rw_edge = 0.5 * (rw[c1] + rw[c2])                 # (nE, nz+1)
        wduz = flux3_vertical(u, rw_edge, fzm, fzp, 1.0)
        tend_u = -rdzw * (wduz[:, 1:] - wduz[:, :-1])
        # nonlinear Coriolis q (no h_edge factor, ref :4803-4813)
        q = trisk_q_cell_assembled(mesh, u, diag.pv_edge)
        dke = (diag.ke[c2] - diag.ke[c1]) * r_dc
        hdivu = u * 0.5 * (h_divergence[c1] + h_divergence[c2])
        tend_u = tend_u + diag.rho_edge * (q - dke) - hdivu

        if mesh.on_sphere:  # curvature terms (ref :4815-4823)
            w_mid = 0.5 * (w[:, :-1] + w[:, 1:])
            w4 = 0.5 * (w_mid[c1] + w_mid[c2])
            tend_u = tend_u - 2.0 * omega \
                * torch.cos(mesh.angleEdge)[:, None] \
                * torch.cos(mesh.latEdge)[:, None] * diag.rho_edge \
                * w4 - u * w4 * diag.rho_edge * inv_r_earth

    # --- u/w/theta mixing (rk 1 only; ref :4836-4975, :5094-5160,
    #     :5272-5310) ---------------------------------------------------------
    if rk_step == 1:
        with span("atm.dyn_tend.mixing"):
            zz_edge = 0.5 * (grid.zz[c1] + grid.zz[c2])
            tend_u_euler = -((pressure_p[c2] - pressure_p[c1]) * r_dc
                             / zz_edge
                             - 0.5 * grid.zxu * (dpdz[c1] + dpdz[c2]))
            if cqu is not None:
                tend_u_euler = cqu * tend_u_euler

            r_dv = torch.minimum(mesh.invDvEdge,
                                 4.0 * mesh.invDcEdge)[:, None]
            delsq_u = (diag.divergence[c2] - diag.divergence[c1]) * r_dc \
                - (diag.vorticity[v2] - diag.vorticity[v1]) * r_dv
            kdiffu = 0.5 * (kdiff[c1] + kdiff[c2])
            tend_u_euler = tend_u_euler + diag.rho_edge * kdiffu \
                * delsq_u * mesh.meshScalingDel2[:, None]

            rho_edge_int = F.pad(diag.rho_edge[:, 1:]
                                 + diag.rho_edge[:, :-1],
                                 (1, 1))                  # (nE, nz+1)
            dvdc = (mesh.dvEdge * mesh.invDcEdge)[:, None]
            wflux = 0.5 * dvdc * rho_edge_int * (w[c2] - w[c1])
            kd4 = F.pad(kdiff[:, 1:] + kdiff[:, :-1],
                        (1, 1))                           # (nC, nz+1)
            kdiff_int_e = 0.25 * (kd4[c1] + kd4[c2])
            wflux_mix = wflux * mesh.meshScalingDel2[:, None] \
                * kdiff_int_e
            dth = (theta_m[c2] - theta_m[c1]) * dvdc * diag.rho_edge
            # prandtl = 1
            mixth = dth * kdiffu * mesh.meshScalingDel2[:, None]
            sgn = mesh.edgeSignOnCell
            delsq_w = _slot_sum(eoc, sgn, wflux) * inva
            tend_w_euler = _slot_sum(eoc, sgn, wflux_mix) * inva
            delsq_theta = _slot_sum(eoc, sgn, dth) * inva
            tend_theta_euler = _slot_sum(eoc, sgn, mixth) * inva
            w_d4 = sgn * mesh.meshScalingDel4[eoc]

            if h_mom_visc4 > 0.0:
                # u del4 (ref :4884-4947)
                delsq_div = _slot_sum(eoc, mesh.divW, delsq_u) * inva
                delsq_vort = _slot_sum(
                    mesh.edgesOnVertex, mesh.curlW,
                    delsq_u) * mesh.invAreaTriangle[:, None]
                ms4 = mesh.meshScalingDel4[:, None] * h_mom_visc4
                u_diff4 = diag.rho_edge * (
                    (delsq_div[c2] - delsq_div[c1]) * r_dc
                    * cfg.config_del4u_div_factor
                    - (delsq_vort[v2] - delsq_vort[v1]) * r_dv) * ms4
                tend_u_euler = tend_u_euler - u_diff4
                # w del4 (ref :5094-5160)
                dsw = (delsq_w[c2] - delsq_w[c1]) * dvdc
                tend_w_euler = tend_w_euler - h_mom_visc4 \
                    * _slot_sum(eoc, w_d4, dsw) * inva
            tend_w_euler[:, 0] = 0.0
            tend_w_euler[:, nz] = 0.0
            if cfg.config_v_mom_eddy_visc2 > 0.0:
                # vertical u mixing (ref :4950)
                # (nE, nz+1)
                zgrid_e = 0.5 * (grid.zgrid[c1] + grid.zgrid[c2])
                tend_u_euler = tend_u_euler + diag.rho_edge \
                    * cfg.config_v_mom_eddy_visc2 * _vertical_laplacian(
                        u, zgrid_e)
            if h_theta_visc4 > 0.0:
                # theta del4 (ref :5272-5310)
                dst = (delsq_theta[c2] - delsq_theta[c1]) * dvdc
                tend_theta_euler = tend_theta_euler - h_theta_visc4 \
                    * _slot_sum(eoc, w_d4, dst) * inva
            if cfg.config_v_theta_eddy_visc2 > 0.0:
                # vertical theta mixing (ref :5342-5381)
                tend_theta_euler = tend_theta_euler \
                    + cfg.config_v_theta_eddy_visc2 * rho_zz \
                    * _vertical_laplacian(theta_m, grid.zgrid)
    else:
        tend_u_euler = euler.tend_u_euler
        tend_w_euler = euler.tend_w_euler
        tend_theta_euler = euler.tend_theta_euler

    if cfg.config_rayleigh_damp_u:
        # Rayleigh damping of u over the top levels, every RK stage
        nlev = cfg.config_number_rayleigh_damp_u_levels
        coef_inv = 1.0 / (nlev * cfg.config_rayleigh_damp_u_timescale_days
                          * SECONDS_PER_DAY)
        kk = torch.arange(nz, device=u.device, dtype=u.dtype)
        coef = torch.where(kk >= nz - nlev, (kk - (nz - nlev - 1)) * coef_inv,
                           0.0)
        tend_u = tend_u - diag.rho_edge * u * coef
    tend_u = tend_u + tend_u_euler

    # --- w tendency (ref :5017-5233) ----------------------------------------
    with span("atm.dyn_tend.w"):
        # horizontal advection of w and theta in one cell-assembled pass
        ru_int = to_interface(ru, fzm, fzp)               # (nE, nz+1)
        tend_w, tend_theta_adv = advective_tendencies_cell(
            grid, [(w, ru_int), (theta_m, ru)])

        if mesh.on_sphere:  # curvature for w (ref :5074-5086)
            rho_int = to_interface(rho_zz, fzm, fzp)
            ur_int = to_interface(ur_cell, fzm, fzp)
            vr_int = to_interface(vr_cell, fzm, fzp)
            curv_w = rho_int * (ur_int ** 2 + vr_int ** 2) \
                * inv_r_earth \
                + 2.0 * omega * torch.cos(mesh.latCell)[:, None] \
                * ur_int * rho_int
            # config_w_curvature="physical" (default) applies the pair
            # at full size after the invAreaCell scaling; "reference"
            # adds it before, as the Fortran does, which divides it by
            # the cell area (see the reference package's
            # nhyd.compute_dyn_tend)
        else:
            curv_w = None

        # vertical advection of w (ref :5163-5177); wdwz lives at
        # levels j=0..nz
        rw_lev = 0.5 * (rw[:, 1:] + rw[:, :-1])
        second_b = 0.25 * (rw[:, 1:2] + rw[:, 0:1]) \
            * (w[:, 1:2] + w[:, 0:1])
        second_t = 0.25 * (rw[:, nz - 1:nz] + rw[:, nz - 2:nz - 1]) \
            * (w[:, nz - 1:nz] + w[:, nz - 2:nz - 1])
        qm2 = w[:, 0:nz - 3]
        qm1 = w[:, 1:nz - 2]
        qi = w[:, 2:nz - 1]
        qp1 = w[:, 3:nz]
        m = rw_lev[:, 1:nz - 2]
        f4 = m * (7.0 * (qi + qm1) - (qp1 + qm2)) / 12.0
        f3 = f4 + 1.0 * torch.abs(m) \
            * ((qp1 - qm2) - 3.0 * (qi - qm1)) / 12.0
        wdwz = F.pad(torch.cat([second_b, f3, second_t], dim=-1), (1, 1))
        if curv_w is not None and cfg.config_w_curvature == "reference":
            tend_w = tend_w + curv_w
        tend_w = tend_w * inva
        if curv_w is not None and cfg.config_w_curvature != "reference":
            tend_w = tend_w + curv_w
        vert = rdzu[1:nz] * (wdwz[:, 2:nz + 1] - wdwz[:, 1:nz])
        tend_w = _add_interior(tend_w, -vert)
        tend_w[:, 0] = 0.0
        tend_w[:, nz] = 0.0

        if rk_step == 1:
            dpdz_int = to_interface(dpdz, fzm, fzp)
            pgrad = F.pad((pressure_p[:, 1:] - pressure_p[:, :-1])
                          * rdzu[1:nz], (1, 1))
            pgrad = pgrad - dpdz_int
            if cqw is not None:
                pgrad = cqw * pgrad
            tend_w_euler = tend_w_euler - pgrad
            tend_w_euler[:, 0] = 0.0
            tend_w_euler[:, nz] = 0.0
            if cfg.config_v_mom_eddy_visc2 > 0.0:  # (ref :5212-5222)
                lap = F.pad((w[:, 2:] - w[:, 1:-1]) * rdzw[1:]
                            - (w[:, 1:-1] - w[:, :-2]) * rdzw[:-1],
                            (1, 1)) * rdzu
                rho_pair = F.pad(0.5 * (rho_zz[:, 1:] + rho_zz[:, :-1]),
                                 (1, 1))
                tend_w_euler = tend_w_euler \
                    + cfg.config_v_mom_eddy_visc2 * rho_pair * lap

        tend_w = tend_w + tend_w_euler

    # --- theta tendency (ref :5239-5410) ------------------------------------
    with span("atm.dyn_tend.theta"):
        tend_theta = tend_theta_adv
        if rk_step > 1:  # perturbation-flux pickup (ref :5252-5266)
            th_save_edge = 0.5 * (theta_m_save[c1] + theta_m_save[c2])
            pf_e = mesh.dvEdge[:, None] * (ru_save - ru) * th_save_edge
            tend_theta = tend_theta - _slot_sum(eoc, mesh.edgeSignOnCell,
                                                pf_e)

        # vertical advection of theta with the rtheta_pp redefinition
        # (ref :5316-5336); the top interior interface uses rw_save only
        th_save_int = to_interface(theta_m_save, fzm, fzp)
        wdtz = flux3_vertical(theta_m, rw, fzm, fzp,
                              cfg.config_coef_3rd_order)
        th_int = to_interface(theta_m, fzm, fzp)
        wdtz = wdtz + (rw_save - rw) * th_save_int
        wdtz[:, nz - 1] = rw_save[:, nz - 1] * th_int[:, nz - 1]

        tend_theta = tend_theta * inva \
            - rdzw * (wdtz[:, 1:] - wdtz[:, :-1])
        tend_theta = tend_theta + tend_theta_euler
        if rt_diabatic_tend is not None:
            # physics heating applied during the RK stages, removed
            # again by recover_large_step_variables at rk_step 3 (ref
            # :5352, :3025)
            tend_theta = tend_theta + rho_zz * rt_diabatic_tend

    new_euler = EulerTends(tend_u_euler=tend_u_euler,
                           tend_w_euler=tend_w_euler,
                           tend_theta_euler=tend_theta_euler,
                           kdiff=kdiff, dpdz=dpdz, tend_rho=tend_rho)
    return tend_u, tend_rho, tend_theta, tend_w, h_divergence, new_euler


# ---------------------------------------------------------------------------
# acoustic-step machinery
# ---------------------------------------------------------------------------

class VertImpCoefs(NamedTuple):
    cofrz: Any        # (nz,)
    cofwr: Any        # (nC, nz+1) interfaces (0 ends)
    cofwz: Any        # (nC, nz+1)
    coftz: Any        # (nC, nz+1)
    cofwt: Any        # (nC, nz)
    a_tri: Any        # (nC, nz+1)
    alpha_tri: Any    # (nC, nz+1)
    gamma_tri: Any    # (nC, nz+1)


def vert_imp_coefs(grid: AtmGrid, cfg: AtmConfig, dts, theta_m, exner,
                   rtheta_p, qtot=None, cqw=None) -> VertImpCoefs:
    """ref: atm_compute_vert_imp_coefs_work (:2012); qtot (nC, nz) and cqw
    (nC, nz+1) default to the dry path (qtot=0, cqw=1)."""
    vg = grid.vert
    nz = vg.nz
    fzm, fzp, rdzw, rdzu = vg.fzm, vg.fzp, vg.rdzw, vg.rdzu
    zz = grid.zz
    dtseps = 0.5 * dts * (1.0 + cfg.config_epssm)

    cofrz = dtseps * rdzw
    zz_int = fzm[1:nz] * zz[:, 1:] + fzp[1:nz] * zz[:, :-1]
    p_int = fzm[1:nz] * exner[:, 1:] + fzp[1:nz] * exner[:, :-1]
    t_int = fzm[1:nz] * theta_m[:, 1:] + fzp[1:nz] * theta_m[:, :-1]

    cofwr = F.pad(0.5 * dtseps * gravity * zz_int, (1, 1))
    cofwz = dtseps * C2 * zz_int * rdzu[1:nz]
    if cqw is not None:
        cofwz = cofwz * cqw[:, 1:nz]
    cofwz = F.pad(cofwz * p_int, (1, 1))
    coftz = F.pad(dtseps * t_int, (1, 1))
    cofwt = 0.5 * dtseps * RCV * zz * gravity * grid.rho_base
    if qtot is not None:
        cofwt = cofwt / (1.0 + qtot)
    cofwt = cofwt * exner / ((grid.rtheta_base + rtheta_p) * grid.exner_base)

    # tridiagonal coefficients at interfaces i=1..nz-1 (ref :2092-2121)
    a_mid = -cofwz[:, 1:nz] * coftz[:, 0:nz - 1] * rdzw[:nz - 1] \
        * zz[:, 0:nz - 1] \
        + cofwr[:, 1:nz] * cofrz[:nz - 1] \
        - cofwt[:, 0:nz - 1] * coftz[:, 0:nz - 1] * rdzw[:nz - 1]
    b_mid = 1.0 + cofwz[:, 1:nz] * (coftz[:, 1:nz] * rdzw[1:nz] * zz[:, 1:nz]
                                    + coftz[:, 1:nz] * rdzw[:nz - 1]
                                    * zz[:, 0:nz - 1]) \
        - coftz[:, 1:nz] * (cofwt[:, 1:nz] * rdzw[1:nz]
                            - cofwt[:, 0:nz - 1] * rdzw[:nz - 1]) \
        + cofwr[:, 1:nz] * (cofrz[1:nz] - cofrz[:nz - 1])
    c_mid = -cofwz[:, 1:nz] * coftz[:, 2:nz + 1] * rdzw[1:nz] * zz[:, 1:nz] \
        - cofwr[:, 1:nz] * cofrz[1:nz] \
        + cofwt[:, 1:nz] * coftz[:, 2:nz + 1] * rdzw[1:nz]
    alpha_mid, gamma_mid = thomas_prefactor(a_mid, b_mid, c_mid)

    return VertImpCoefs(cofrz=cofrz, cofwr=cofwr, cofwz=cofwz, coftz=coftz,
                        cofwt=cofwt, a_tri=F.pad(a_mid, (1, 1)),
                        alpha_tri=F.pad(alpha_mid, (1, 1)),
                        gamma_tri=F.pad(gamma_mid, (1, 1)))


def set_smlstep_pert_variables(grid: AtmGrid, tend_u, tend_w):
    """Convert the w tendency to an omega tendency (ref :2224-2309)."""
    mesh = grid.mesh
    vg = grid.vert
    nz = vg.nz
    ut_int = to_interface(tend_u, vg.fzm, vg.fzp)       # (nE, nz+1)
    # sign() uses the LEVEL-k value of tend_u at interface k (ref :2294);
    # the top interface pads with 0
    sign_int = F.pad(torch.sign(tend_u), (0, 1))
    eocT = mesh.edgesOnCell.T                            # (mE, nC)
    g = ut_int[eocT]                                     # (mE, nC, nz+1)
    zbz3 = grid.zb_cell + sign_int[eocT] * grid.zb3_cell
    contrib = (mesh.edgeSignOnCell.T[:, :, None] * zbz3 * g).sum(0)
    w_tend = (tend_w - contrib) * to_interface(grid.zz, vg.fzm, vg.fzp)
    w_tend[:, 0] = 0.0
    w_tend[:, nz] = 0.0
    return w_tend


class AcousticVars(NamedTuple):
    ru_p: Any         # (nE, nz)
    rho_pp: Any       # (nC, nz)
    rtheta_pp: Any    # (nC, nz)
    rtheta_pp_old: Any
    rw_p: Any         # (nC, nz+1)
    ruAvg: Any
    wwAvg: Any


class AcousticHoist(NamedTuple):
    """Edge quantities fixed across a substep's acoustic iterations."""
    zz_pair: Any      # (nE, nz)  0.5*(zz[c1]+zz[c2])
    pg_coef: Any      # (nE, nz)  cqu*0.5*C2*(exner[c1]+exner[c2])
    th_edge: Any      # (nE, nz)  0.5*(theta_m[c1]+theta_m[c2])
    th_sum: Any       # (nE, nz)  theta_m[c1]+theta_m[c2]


def acoustic_hoist(grid: AtmGrid, theta_m, exner,
                   cqu=None) -> AcousticHoist:
    """Substep-invariant edge quantities of the acoustic loop
    (ref :2480-2504, :2536-2549, :2726-2805); cqu (nE, nz) defaults to the
    dry path (cqu=1)."""
    mesh = grid.mesh
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    th_sum = theta_m[c1] + theta_m[c2]
    coef = 0.5 * C2 if cqu is None else cqu * 0.5 * C2
    return AcousticHoist(zz_pair=0.5 * (grid.zz[c1] + grid.zz[c2]),
                         pg_coef=coef * (exner[c1] + exner[c2]),
                         th_edge=0.5 * th_sum, th_sum=th_sum)


def acoustic_step(grid: AtmGrid, cfg: AtmConfig, coefs: VertImpCoefs,
                  av: AcousticVars, dts,
                  theta_m, exner, w, rho_zz, rw, rw_save, ru, ru_save,
                  tend_ru, tend_rho, tend_rt, tend_rw, cqu=None,
                  hoist: AcousticHoist | None = None, damp: bool = False,
                  xch_rtheta=None):
    """One forward-backward acoustic substep (ref :2447-2723).

    With `av` zero at each RK stage the general branch reproduces the
    reference's small_step==1 special case. damp=True folds the previous
    iteration's 3D divergence damping (ref :2726-2805) into this step's
    entry; the last iteration's damping is applied by the caller. The
    cell-local column update runs in kernel K1 (kernels/acoustic.py).
    cqu enters only through the hoisted pressure-gradient coefficient, so
    it is read only when `hoist` is not given. xch_rtheta: optional
    halo-refresh callable fired on rtheta_pp the moment it is produced
    (the sharded runner's layer-1 exchange, ref :845)."""
    mesh = grid.mesh
    vg = grid.vert
    nz = vg.nz
    fzm, fzp, rdzw = vg.fzm, vg.fzp, vg.rdzw
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    if hoist is None:
        hoist = acoustic_hoist(grid, theta_m, exner, cqu)

    ru_p_in = av.ru_p
    if damp:
        dpdt = av.rtheta_pp - av.rtheta_pp_old           # (ref :2791)
        coefd = 2.0 * cfg.config_smdiv * cfg.config_len_disp / dts
        ru_p_in = ru_p_in + coefd * (dpdt[c1] - dpdt[c2]) / hoist.th_sum

    # horizontal momentum update with pressure gradient (ref :2480-2504)
    pgrad = ((av.rtheta_pp[c2] - av.rtheta_pp[c1])
             * mesh.invDcEdge[:, None]) / hoist.zz_pair
    pgrad = hoist.pg_coef * pgrad
    pgrad = pgrad + 0.5 * grid.zxu * gravity * (av.rho_pp[c1]
                                                + av.rho_pp[c2])
    ru_p = ru_p_in + dts * (tend_ru - pgrad)
    ruAvg = av.ruAvg + ru_p

    # cell divergence contributions (ref :2536-2549)
    flux_r = mesh.dvEdge[:, None] * ru_p
    flux_t = flux_r * hoist.th_edge
    coefc = (dts * mesh.invAreaCell)[:, None]
    rs_flux = -_slot_sum(mesh.edgesOnCell, mesh.edgeSignOnCell, flux_r) \
        * coefc
    ts_flux = -_slot_sum(mesh.edgesOnCell, mesh.edgeSignOnCell, flux_t) \
        * coefc

    # reference indexes the level array dss with the interface index
    # (ref :2611 dss(k,iCell), k=2..nVertLevels): interface i <- level i
    zz_int = to_interface(grid.zz, fzm, fzp)
    rho_int = to_interface(rho_zz, fzm, fzp)
    rw_p, rho_pp, rtheta_pp, wwAvg = acoustic_cell_update(
        nz, cfg.config_epssm, dts,
        av.rho_pp + dts * tend_rho + rs_flux,
        av.rtheta_pp + dts * tend_rt + ts_flux,
        av.rw_p, av.wwAvg, tend_rw, av.rho_pp, av.rtheta_pp,
        coefs.cofwz, coefs.cofwr, coefs.cofwt, coefs.coftz,
        coefs.cofrz, rdzw, coefs.a_tri, coefs.alpha_tri,
        coefs.gamma_tri, grid.zz, F.pad(grid.dss, (0, 1)), rw_save - rw,
        zz_int * rho_int * w)
    if xch_rtheta is not None:
        rtheta_pp = xch_rtheta(rtheta_pp)
    return AcousticVars(ru_p=ru_p, rho_pp=rho_pp, rtheta_pp=rtheta_pp,
                        rtheta_pp_old=av.rtheta_pp, rw_p=rw_p,
                        ruAvg=ruAvg, wwAvg=wwAvg)


def divergence_damping_3d(grid: AtmGrid, cfg: AtmConfig, av: AcousticVars,
                          dts, theta_m, th_sum=None):
    """ref: atm_divergence_damping_3d (:2726). th_sum: optional precomputed
    theta_m[c1]+theta_m[c2] (AcousticHoist)."""
    mesh = grid.mesh
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    coef = 2.0 * cfg.config_smdiv * cfg.config_len_disp / dts
    dpdt = av.rtheta_pp - av.rtheta_pp_old
    if th_sum is None:
        th_sum = theta_m[c1] + theta_m[c2]
    ru_p = av.ru_p + coef * (-dpdt[c2] + dpdt[c1]) / th_sum
    return av._replace(ru_p=ru_p)


def recover_large_step_variables(grid: AtmGrid, cfg: AtmConfig,
                                 av: AcousticVars, rk_step: int, dt, ns,
                                 rho_p_save, rtheta_p_save, ru_save, rw_save,
                                 theta_m, rt_diabatic_tend=None):
    """ref: atm_recover_large_step_variables_work (:2909). At rk_step 3 the
    diabatic heating rt_diabatic_tend (None: dry) is taken out of
    rtheta_p again (ref :3025).
    Returns (u, w, theta_m, rho_zz, ru, rw, rho_p, rtheta_p, exner,
    pressure_p, ruAvg, wwAvg); exner/pressure_p are None unless rk_step 3."""
    mesh = grid.mesh
    vg = grid.vert
    nz = vg.nz
    fzm, fzp = vg.fzm, vg.fzp
    cf1, cf2, cf3 = vg.cf1, vg.cf2, vg.cf3
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    inv_ns = 1.0 / float(ns)

    rho_p = rho_p_save + av.rho_pp
    rho_zz = rho_p + grid.rho_base
    wwAvg = rw_save + av.wwAvg * inv_ns
    rw = rw_save + av.rw_p
    zz_int = to_interface(grid.zz, fzm, fzp)
    rho_int = to_interface(rho_zz, fzm, fzp)

    rtheta_p = rtheta_p_save + av.rtheta_pp
    if rk_step == 3 and rt_diabatic_tend is not None:
        rtheta_p = rtheta_p - dt * rho_zz * rt_diabatic_tend
    theta_m_new = (rtheta_p + grid.rtheta_base) / rho_zz
    if rk_step == 3:
        exner = (grid.zz * (rgas / p0)
                 * (rtheta_p + grid.rtheta_base)) ** RCV
        pressure_p = grid.zz * rgas * (exner * rtheta_p + grid.rtheta_base
                                       * (exner - grid.exner_base))
    else:
        exner = None
        pressure_p = None

    ruAvg = ru_save + av.ruAvg * inv_ns
    ru = ru_save + av.ru_p
    u = 2.0 * ru / (rho_zz[c1] + rho_zz[c2])

    # metric part of w (ref :2978-3005); the surface flux uses the cf1/2/3
    # extrapolation
    eocT = mesh.edgesOnCell.T
    sgnT = mesh.edgeSignOnCell.T                         # (mE, nC)
    gi = to_interface(ru, fzm, fzp)[eocT]                # (mE, nC, nz+1)
    zbz3 = grid.zb_cell + torch.sign(gi) * grid.zb3_cell
    w_metric = (sgnT[:, :, None] * zbz3 * gi).sum(0)
    gs = (cf1 * ru[:, 0] + cf2 * ru[:, 1] + cf3 * ru[:, 2])[eocT]
    zbz3s = grid.zb_cell[:, :, 0] + torch.sign(gs) * grid.zb3_cell[:, :, 0]
    w_sfc = (sgnT * zbz3s * gs).sum(0)
    rho_sfc = cf1 * rho_zz[:, 0] + cf2 * rho_zz[:, 1] + cf3 * rho_zz[:, 2]

    # w from omega: interior (rw/zz_int + metric)/rho_int, surface from the
    # extrapolated flux, 0 at the top (ref :2946-2955)
    w = torch.zeros_like(rw)
    w[:, 0] = w_sfc / rho_sfc
    w[:, 1:nz] = (rw[:, 1:nz] / zz_int[:, 1:nz] + w_metric[:, 1:nz]) \
        / rho_int[:, 1:nz]

    return (u, w, theta_m_new, rho_zz, ru, rw, rho_p, rtheta_p, exner,
            pressure_p, ruAvg, wwAvg)
