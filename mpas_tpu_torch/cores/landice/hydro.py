"""Subglacial hydrology: distributed sheet + channelized drainage (port of
mpas_tpu/cores/landice/hydro.py).

ref: src/core_landice/mode_forward/mpas_li_subglacial_hydro.F (1,757 LoC),
a GlaDS-class model (Werder et al. 2013 lineage):

- distributed sheet: d(W)/dt = melt/rho_w - dWtill/dt - div(q)
  - div(Q_chnl), q = -k W^alpha |grad phi|^(beta-2) grad phi
  (calc_edge_quantities :666-872)
- prognostic water pressure, 'cavity' closure (calc_pressure
  :1117-1268): dP/dt = (closing - opening + input - till change
  - div q - div Q - channel area change) * rho_w g / porosity;
  opening = bedRough * |u_b| * (bedRoughMax - W), closing
  = creepCoeff * A * N^3 * W, N = rho_i g H - P clamped to [0, overburden]
- till reservoir with capacity tillMax and constant drainage
- channels on edges (update_channel :1363-1524, evolve_channel
  :1538-1614): discharge Q = -Kc S^alpha_c |grad phi|^(beta_c-2)
  d(phi)/ds, opening from dissipation melt (channel + incipient-sheet
  width) minus the pressure-melt freeze-on term, creep closing
  2A/27-genre with the reference coefficient, dS/dt integrated on edges
  with cell-divergence feedback into W and P
- hydropotential phi = rho_w g z_b + P_w (full model) or the
  zero-water-pressure form (compressed sgh_step retained)

Upwinded edge fluxes, masked per-cell assembles, fixed-substep forward
Euler (the reference's adaptive CFL subcycling becomes a fixed n_sub, a
Python loop), no per-cell control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mpas_tpu_torch.containers import resolve_device, to_device
from mpas_tpu_torch.cores.landice.config import LiConfig


@dataclasses.dataclass(frozen=True)
class HydroState:
    waterThickness: Any     # (nCells,) m — the distributed sheet
    tillWater: Any          # (nCells,) m — till reservoir
    waterPressure: Any = None   # (nCells,) Pa — prognostic (full model)
    channelArea: Any = None     # (nEdges,) m^2 — channel cross-section

    def to(self, device, dtype) -> "HydroState":
        return to_device(self, device, dtype)


def zero_hydro(n_cells, dtype=torch.float64, n_edges=None,
               device=None) -> HydroState:
    """Dry bed; waterPressure/channelArea only where n_edges is given
    (the full model). device None: cuda:0."""
    device = resolve_device(device)
    z = torch.zeros(n_cells, dtype=dtype, device=device)
    return HydroState(
        waterThickness=z, tillWater=z,
        waterPressure=z if n_edges is not None else None,
        channelArea=(torch.zeros(n_edges, dtype=dtype, device=device)
                     if n_edges is not None else None))


# sheet-flux law constants (ref: config_SGH_conduc_coeff, alpha/beta
# exponents of the Darcy-Weisbach sheet law)
_K_SHEET = 1.0e-3
_ALPHA = 5.0 / 4.0
_BETA = 3.0 / 2.0
_TILL_MAX = 2.0          # m (ref: config_SGH_till_max)
_TILL_DRAIN = 3.17e-11   # m/s (ref: config_SGH_till_drainage ~1 mm/yr)
_RHO_W = 1000.0


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi) = min(max(x, lo), hi), lo/hi tensors or
    floats."""
    lo = lo if isinstance(lo, torch.Tensor) else torch.full_like(x, lo)
    hi = hi if isinstance(hi, torch.Tensor) else torch.full_like(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def _div_cells(m, edge_flux):
    """sum_e sign * F_e over edgesOnCell, / areaCell."""
    return (m.edgeSignOnCell * edge_flux[m.edgesOnCell]).sum(1) \
        * m.invAreaCell


def hydraulic_potential(grid, cfg: LiConfig, thickness):
    """phi = rho_w g z_b + rho_i g H (zero water-pressure sheet).
    ref: the potential build in li_SGH_solve."""
    return (_RHO_W * cfg.gravity * grid.bedTopography
            + cfg.rho_ice * cfg.gravity * thickness)


def sgh_step(grid, cfg: LiConfig, hydro: HydroState, thickness,
             basal_melt_rate, dt, n_sub: int = 4) -> HydroState:
    """Advance the water sheet by dt.

    basal_melt_rate: (nCells,) m/s of water added at the bed (from the
    thermal solver's basal energy balance or a file, ref :329-340)."""
    m = grid.mesh
    phi = hydraulic_potential(grid, cfg, thickness)
    coe = m.cellsOnEdge
    not_bnd = 1.0 - m.boundaryEdge
    gphi = (phi[coe[:, 1]] - phi[coe[:, 0]]) * m.invDcEdge * not_bnd

    has_ice = (thickness > 1.0).to(phi.dtype)
    dts = dt / n_sub
    w, till = hydro.waterThickness, hydro.tillWater
    for _ in range(n_sub):
        # till reservoir first (ref: till drainage ordering)
        fill = torch.minimum(basal_melt_rate * dts, _TILL_MAX - till)
        fill = fill.clamp(min=0.0)
        till_new = _clip(till + fill - _TILL_DRAIN * dts, 0.0, _TILL_MAX)
        to_sheet = basal_melt_rate * dts - fill

        # sheet flux, upwind water thickness in the down-potential direction
        # (|grad phi|^(beta-2) with beta<2 is singular at zero gradient —
        # guard like the reference's minimum-gradient floor)
        w_up = torch.where(gphi < 0.0, w[coe[:, 0]], w[coe[:, 1]])
        gmag = gphi.abs().clamp(min=1e-3)
        q = -_K_SHEET * w_up.clamp(min=0.0) ** _ALPHA \
            * gmag ** (_BETA - 2.0) * gphi * not_bnd
        div = _div_cells(m, q * m.dvEdge)
        w = (w + to_sheet - dts * div).clamp(min=0.0) * has_ice
        till = till_new * has_ice
    return HydroState(waterThickness=w, tillWater=till)


def basal_melt_from_thermal(grid, cfg: LiConfig, thickness, temperature):
    """Basal melt rate (m/s water) from the excess of the geothermal +
    frictional flux over what conduction removes at a temperate bed.
    ref: 'thermal' branch of config_SGH_basal_melt (:333)."""
    latent = 3.34e5 * _RHO_W
    nz = temperature.shape[-1]
    dz_b = thickness.clamp(min=10.0) / nz
    t_bed = temperature[:, -1]
    temperate = t_bed >= 273.15 - 1e-3
    cond_out = cfg.ice_conductivity * (
        273.15 - temperature[:, -2]).clamp(min=0.0) / dz_b
    melt = (cfg.config_geothermal_flux - cond_out).clamp(min=0.0) / latent
    return torch.where(temperate & (thickness > 1.0), melt,
                       torch.zeros_like(melt))


# -- full GlaDS-class model (ref li_SGH_solve :206-586) ----------------------
_POROSITY = 0.01          # config_SGH_englacial_porosity
_BED_ROUGH = 0.5          # config_SGH_bed_roughness (1/m)
_BED_ROUGH_MAX = 0.1      # config_SGH_bed_roughness_max (m)
_CREEP = 0.04             # config_SGH_creep_coefficient
_KC = 0.1                 # config_SGH_chnl_conduc_coeff
_ALPHA_C = 1.25           # config_SGH_chnl_alpha
_BETA_C = 1.5             # config_SGH_chnl_beta
_CREEP_C = 0.04           # config_SGH_chnl_creep_coefficient
_W_INCIPIENT = 2.0        # config_SGH_incipient_channel_width (m)
_LATENT = 3.34e5          # J/kg
_CP_W = 4218.0
_CC_SLOPE = 7.9e-8        # iceMeltingPointPressureDependence (K/Pa)
_FLOW_A = 2.4e-24         # Pa^-3 s^-1 basal flow-law parameter (EISMINT)


def sgh_step_full(grid, cfg: LiConfig, hydro: HydroState, thickness,
                  basal_melt_rate, basal_speed, dt, n_sub: int = 8,
                  channels: bool = True) -> HydroState:
    """Full distributed+channelized step with prognostic water pressure
    (ref li_SGH_solve sequence: edge quantities -> channels -> water
    thickness -> till -> pressure).

    basal_speed: (nCells,) m/s sliding speed (drives cavity opening).
    Returns the advanced HydroState (waterPressure/channelArea filled).
    """
    m = grid.mesh
    coe = m.cellsOnEdge
    not_bnd = 1.0 - m.boundaryEdge
    has_ice = (thickness > 1.0).to(thickness.dtype)
    overburden = cfg.rho_ice * cfg.gravity * thickness

    w = hydro.waterThickness
    till = hydro.tillWater
    P = (hydro.waterPressure if hydro.waterPressure is not None
         else 0.5 * overburden)
    S = (hydro.channelArea if hydro.channelArea is not None
         else torch.zeros(m.nEdges, dtype=thickness.dtype,
                          device=thickness.device))

    dts = dt / n_sub
    for _ in range(n_sub):
        # hydropotential with the prognostic pressure (ref :750-787)
        phi = _RHO_W * cfg.gravity * grid.bedTopography + P
        gphi = (phi[coe[:, 1]] - phi[coe[:, 0]]) * m.invDcEdge * not_bnd
        gP = (P[coe[:, 1]] - P[coe[:, 0]]) * m.invDcEdge * not_bnd
        gmag = gphi.abs().clamp(min=1e-3)

        # sheet flux (upwind W), limited by the water available in the
        # upwind cell per substep (the reference's advective CFL,
        # check_timestep :888-1102, as a flux limiter)
        w_up = torch.where(gphi < 0.0, w[coe[:, 0]], w[coe[:, 1]])
        q = -_K_SHEET * w_up.clamp(min=0.0) ** _ALPHA \
            * gmag ** (_BETA - 2.0) * gphi * not_bnd
        wa = w * m.areaCell
        wa_min = torch.minimum(wa[coe[:, 0]], wa[coe[:, 1]])
        qmax = 0.25 * wa_min / (m.dvEdge * dts) + 1.0e-14
        q = _clip(q, -qmax, qmax)
        div_q = _div_cells(m, q * m.dvEdge)

        # channels (ref update_channel :1440-1524). The reference bounds
        # the melt-opening feedback with its adaptive channel CFL
        # (check_timestep :1094-1100); at a fixed dts that becomes (a)
        # creep closing treated implicitly, (b) per-substep opening
        # capped at a doubling of S, (c) discharge limited by the water
        # actually available in the adjacent sheet
        if channels:
            qc = -_KC * S.clamp(min=0.0) ** _ALPHA_C \
                * gmag ** (_BETA_C - 2.0) * gphi
            Qc = torch.where(gmag < 0.01, torch.zeros_like(qc), qc) \
                * not_bnd
            qlim = 0.25 * wa_min / dts + 1.0e-12
            Qc = _clip(Qc, -qlim, qlim)
            melt_c = ((Qc * gphi).abs()
                      + (q * gphi * _W_INCIPIENT).abs()) / _LATENT
            p_freeze = -_CC_SLOPE * _CP_W * _RHO_W \
                * (Qc + q * _W_INCIPIENT) * gP / _LATENT
            open_c = ((melt_c - p_freeze) / cfg.rho_ice).clamp(min=0.0)
            n_cell = (overburden - P).clamp(min=0.0)
            N_edge = 0.5 * (n_cell[coe[:, 0]] + n_cell[coe[:, 1]])
            close_rate = _CREEP_C * _FLOW_A * N_edge ** 3      # 1/s
            growth = torch.minimum(dts * open_c, S.clamp(min=1.0e-6))
            # physical R-channel areas are O(1-10 m^2); the cap stands
            # in for the reference's channel CFL during spin-up bursts
            S_new = ((S + growth) / (1.0 + dts * close_rate)).clamp(
                max=50.0) * not_bnd
            dS_eff = (S_new - S) / dts
            S = S_new
            div_Qc = _div_cells(m, Qc)
            dSdt_cell = (m.edgeSignOnCell.abs()
                         * (dS_eff * m.dcEdge * 0.5)[m.edgesOnCell]
                         ).sum(1) * m.invAreaCell
        else:
            div_Qc = torch.zeros_like(div_q)
            dSdt_cell = torch.zeros_like(div_q)

        # till reservoir
        fill = _clip(basal_melt_rate * dts, 0.0, _TILL_MAX - till)
        till_new = _clip(till + fill - _TILL_DRAIN * dts, 0.0, _TILL_MAX)
        dtill_dt = (till_new - till) / dts
        to_sheet = basal_melt_rate - dtill_dt

        # cavity opening/closing (ref calc_pressure :1165-1170)
        N = (overburden - P).clamp(min=0.0)
        opening = (_BED_ROUGH * basal_speed
                   * (_BED_ROUGH_MAX - w)).clamp(min=0.0)
        closing = _CREEP * _FLOW_A * N ** 3 * w

        # water sheet update with a per-substep change cap (explicit
        # stability guard standing in for the reference's adaptive dt)
        dw = dts * (to_sheet + opening - closing
                    - div_q - div_Qc - dSdt_cell)
        cap = (0.5 * w).clamp(min=1.0e-3)
        dw = _clip(dw, -cap, cap)
        w = (w + dw).clamp(min=0.0) * has_ice
        till = till_new * has_ice

        # pressure, 'cavity' closure (ref :1180-1196) integrated toward
        # its STIFF-LIMIT attractor: the reference evolves dP/dt with an
        # adaptive deltatSGH that collapses to the ~seconds pressure
        # timescale, whose attractor is the quasi-steady balance
        # closing(P) = opening - input + div (N = cbrt(rhs/(creep A W))).
        # Relaxing P toward that attractor over tau_p keeps the
        # cell-to-cell pressure field smooth at climate substeps.
        rhs = (opening - to_sheet + div_q + div_Qc
               + dSdt_cell).clamp(min=0.0)
        N_qs = (rhs / (_CREEP * _FLOW_A
                       * w.clamp(min=1.0e-4))) ** (1.0 / 3.0)
        P_qs = _clip(overburden - N_qs, 0.0, overburden)
        tau_p = 2.0 * 86400.0
        rate = dts / tau_p
        rate = rate.clamp(max=1.0) if isinstance(rate, torch.Tensor) \
            else min(rate, 1.0)
        P = P + (P_qs - P) * rate
        P = _clip(P, 0.0, overburden) * has_ice
    return HydroState(waterThickness=w, tillWater=till, waterPressure=P,
                      channelArea=S)


def effective_pressure(cfg: LiConfig, hydro: HydroState, thickness):
    """N = rho_i g H - P_w (ref calc_pressure_diag_vars :1281-1348)."""
    overburden = cfg.rho_ice * cfg.gravity * thickness
    P = (hydro.waterPressure if hydro.waterPressure is not None
         else torch.zeros_like(thickness))
    return (overburden - P).clamp(min=0.0)
