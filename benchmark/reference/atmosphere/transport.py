# Frozen copy of mpas_tpu_torch/cores/atmosphere/transport.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Scalar transport: Skamarock & Gassmann (2011) 3rd/4th-order flux-form
advection with optional Zalesak monotonic limiting (port of
mpas_tpu/cores/atmosphere/transport.py).

ref: atm_advance_scalars_work (src/core_atmosphere/dynamics/
mpas_atm_time_integration.F:3238) and atm_advance_scalars_mono_work (:3612).

Shapes: scalars (nCells, nz, nS); ruAvg (nEdges, nz); wwAvg (nCells, nz+1).
Each scalar is advanced as a (cells, levels) field in a loop over scalars,
as the reference's per-scalar loop does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.atmosphere.advection import edge_value_parts
from benchmark.reference.atmosphere.config import AtmConfig
from benchmark.reference.atmosphere.setup import AtmGrid

EPS = 1.0e-20


def _edge_flux_value_s(grid: AtmGrid, psi_s, sign_uh):
    """High-order edge value for one scalar (nC, nz) -> (nE, nz)."""
    base, third = edge_value_parts(grid, psi_s)
    return base + sign_uh * third


def _edge_sum(mesh, weights, fe):
    """sum_s weights[:, s] * fe[edgesOnCell[:, s]] for an edge field fe."""
    return (weights[..., None] * fe[mesh.edgesOnCell]).sum(1)


def _vert_flux3_s(grid: AtmGrid, psi_s, ww, coef3):
    """flux3 vertical flux of one scalar (nC, nz); ww (nC, nz+1)."""
    nz = grid.vert.nz
    fzm, fzp = grid.vert.fzm, grid.vert.fzp
    second = ww[:, 1:nz] * (fzm[1:nz] * psi_s[:, 1:]
                            + fzp[1:nz] * psi_s[:, :-1])
    qm2 = psi_s[:, 0:nz - 3]
    qm1 = psi_s[:, 1:nz - 2]
    qi = psi_s[:, 2:nz - 1]
    qp1 = psi_s[:, 3:nz]
    m = ww[:, 2:nz - 1]
    f4 = m * (7.0 * (qi + qm1) - (qp1 + qm2)) / 12.0
    f3 = f4 + coef3 * torch.abs(m) * ((qp1 - qm2) - 3.0 * (qi - qm1)) / 12.0
    return F.pad(torch.cat([second[:, :1], f3, second[:, nz - 2:nz - 1]],
                           dim=1), (1, 1))


def _rho_int(grid: AtmGrid, rho_old, ruAvg, wwAvg, dt):
    """Re-integrated density from the time-averaged fluxes
    (ref mono :3755-3775)."""
    mesh = grid.mesh
    div = _edge_sum(mesh, mesh.divW, ruAvg) * mesh.invAreaCell[:, None]
    return rho_old + dt * (-div - grid.vert.rdzw
                           * (wwAvg[:, 1:] - wwAvg[:, :-1]))


def _time_weight(rk_step, order, advance_density):
    if not advance_density:
        return 1.0
    if rk_step == 1:
        return 1.0 / 3.0 if order == 3 else 0.5
    if rk_step == 2:
        return 0.5
    return 1.0


def advance_scalars(grid: AtmGrid, cfg: AtmConfig, scalars_old, scalars_new,
                    rho_old, rho_new, ruAvg, wwAvg, dt, rk_step: int,
                    advance_density: bool):
    """Unlimited SG11 transport (ref :3238). Returns updated mixing ratios."""
    mesh = grid.mesh
    rdzw = grid.vert.rdzw
    wtn = _time_weight(rk_step, cfg.config_time_integration_order,
                       advance_density)
    rho_denom = (1.0 - wtn) * rho_old + wtn * rho_new
    sign_uh = torch.sign(ruAvg)
    outs = []
    for i in range(scalars_old.shape[-1]):
        po, pn = scalars_old[..., i], scalars_new[..., i]
        psi_edge = _edge_flux_value_s(grid, pn, sign_uh)
        tend = -_edge_sum(mesh, mesh.edgeSignOnCell, ruAvg * psi_edge) \
            * mesh.invAreaCell[:, None]
        wdtn = _vert_flux3_s(grid, pn, wwAvg, cfg.config_coef_3rd_order)
        outs.append((po * rho_old
                     + dt * (tend - rdzw * (wdtn[:, 1:] - wdtn[:, :-1])))
                    / rho_denom)
    return torch.stack(outs, dim=-1)


def advance_scalars_mono(grid: AtmGrid, cfg: AtmConfig, scalars_old,
                         scalars_new, rho_old, rho_new, ruAvg, wwAvg, dt,
                         advance_density: bool,
                         positive_definite_only: bool = False):
    """Zalesak-limited transport (ref :3612): 3rd/4th-order fluxes split
    into a monotone upwind part + a limited correction."""
    mesh = grid.mesh
    nz = grid.vert.nz
    rdzw = grid.vert.rdzw
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    if advance_density:
        rho_denom = _rho_int(grid, rho_old, ruAvg, wwAvg, dt)
    else:
        rho_denom = rho_new

    sign_uh = torch.sign(ruAvg)
    uh_pos = torch.clamp(ruAvg, min=0.0)
    uh_neg = torch.clamp(ruAvg, max=0.0)
    dv_dt = mesh.dvEdge[:, None] * dt
    ww_pos = torch.clamp(wwAvg[:, 1:nz], min=0.0)
    ww_neg = torch.clamp(wwAvg[:, 1:nz], max=0.0)
    inv_area = mesh.invAreaCell[:, None]
    sgn = mesh.edgeSignOnCell
    valid = (mesh.edgesOnCellMask > 0)[..., None]

    outs = []
    for i in range(scalars_old.shape[-1]):
        psi_o, pn = scalars_old[..., i], scalars_new[..., i]

        # --- high-order fluxes -------------------------------------------
        flux_h = ruAvg * _edge_flux_value_s(grid, pn, sign_uh)
        wdtn = _vert_flux3_s(grid, pn, wwAvg, cfg.config_coef_3rd_order)

        # --- monotone bounds from psi_old (ref :3820-3906) -------------
        lo = torch.cat([psi_o[:, :1], psi_o, psi_o[:, -1:]], dim=1)
        s_max = torch.maximum(torch.maximum(lo[:, :-2], lo[:, 1:-1]),
                              lo[:, 2:])
        s_min = torch.minimum(torch.minimum(lo[:, :-2], lo[:, 1:-1]),
                              lo[:, 2:])
        nb = psi_o[mesh.cellsOnCell]                     # (nC, mE, nz)
        s_max = torch.maximum(
            s_max, torch.where(valid, nb, -torch.inf).amax(1))
        s_min = torch.minimum(
            s_min, torch.where(valid, nb, torch.inf).amin(1))
        if positive_definite_only:
            s_min = torch.zeros_like(s_min)
            s_max = torch.full_like(s_max, torch.inf)

        # --- upwind parts (ref :3965-3980, :4005-4013) -----------------
        fu_h = dv_dt * (uh_pos * psi_o[c1] + uh_neg * psi_o[c2])
        flux_corr_h = dt * flux_h - fu_h
        fu_v = F.pad(dt * (ww_pos * psi_o[:, :-1] + ww_neg * psi_o[:, 1:]),
                     (1, 1))
        wdtn_corr = dt * wdtn - fu_v

        # --- upwind (low-order) update (ref :3966-3977, :4020) ---------
        acc = psi_o * rho_old - rdzw * (fu_v[:, 1:] - fu_v[:, :-1])
        sc_in = -rdzw * (torch.clamp(wdtn_corr[:, 1:], max=0.0)
                         - torch.clamp(wdtn_corr[:, :-1], min=0.0))
        sc_out = -rdzw * (torch.clamp(wdtn_corr[:, 1:], min=0.0)
                          - torch.clamp(wdtn_corr[:, :-1], max=0.0))
        acc = acc - _edge_sum(mesh, sgn, fu_h) * inv_area
        signed = sgn[..., None] * flux_corr_h[mesh.edgesOnCell]
        sc_out = sc_out - torch.clamp(signed, min=0.0).sum(1) * inv_area
        sc_in = sc_in - torch.clamp(signed, max=0.0).sum(1) * inv_area

        # --- limiter (ref :4036-4060) ----------------------------------
        scale_in = torch.clamp((s_max * rho_denom - acc) / (sc_in + EPS),
                               0.0, 1.0)
        scale_out = torch.clamp((s_min * rho_denom - acc) / (sc_out - EPS),
                                0.0, 1.0)

        # --- rescale fluxes (ref :4104-4130) ---------------------------
        fh = torch.clamp(flux_corr_h, min=0.0) \
            * torch.minimum(scale_out[c1], scale_in[c2]) \
            + torch.clamp(flux_corr_h, max=0.0) \
            * torch.minimum(scale_in[c1], scale_out[c2])
        fv = F.pad(torch.clamp(wdtn_corr[:, 1:nz], min=0.0)
                   * torch.minimum(scale_out[:, :-1], scale_in[:, 1:])
                   + torch.clamp(wdtn_corr[:, 1:nz], max=0.0)
                   * torch.minimum(scale_out[:, 1:], scale_in[:, :-1]),
                   (1, 1))

        # --- final update (ref :4136-4153) -----------------------------
        acc = acc - _edge_sum(mesh, sgn, fh) * inv_area
        acc = acc - rdzw * (fv[:, 1:] - fv[:, :-1])
        outs.append(acc / rho_denom)
    return torch.stack(outs, dim=-1)
