"""K-profile parameterization (KPP) ocean boundary-layer mixing (port of
mpas_tpu/cores/ocean/kpp.py).

ref capability: src/core_ocean/shared/mpas_ocn_vmix_cvmix.F
(`config_use_cvmix_kpp` path), the Large, McWilliams & Doney (1994)
scheme as CVMix implements it: bulk-Richardson boundary-layer depth,
Monin-Obukhov stability-dependent turbulent velocity scales, cubic shape
function, matching to interior shear/convective mixing below, and the
non-local (counter-gradient) tracer transport. The boundary-layer depth
search is a masked first crossing + linear interpolation per column.
"""

from __future__ import annotations

import math

import torch

from mpas_tpu_torch.constants import gravity
from mpas_tpu_torch.cores.ocean.vmix import coefs_rich, edge_mean_on_cell

KAPPA = 0.4          # von Karman
RI_CRIT = 0.3        # CVMix default KPP_Ri_crit
EPS_SL = 0.1         # surface-layer fraction
C_S = 98.96          # unresolved-shear constant (CVMix c_s)
C_V = 1.7            # Vt2 coefficient
BETA_T = -0.2        # entrainment ratio
ZETA_S = -1.0        # unstable-regime match point (scalars)
ZETA_M = -0.2        # (momentum)
A_S = -28.86
A_M = 1.26
C_M = 8.38
NONLOCAL_CS = 6.32739901508     # CVMix Cstar*kappa*(c_s*kappa*eps)^(1/3)


def _w_scales(sigma, hbl, ustar, bflux):
    """Turbulent velocity scales w_m, w_s at sigma = depth/hbl; bflux > 0
    is destabilizing (surface buoyancy loss).
    ref: cvmix_kpp_compute_turbulent_scales (Large et al. eq. 13/B1)."""
    # surface-layer-capped sigma under destabilizing forcing
    sig_eff = torch.where(bflux[..., None] > 0.0,
                          torch.clamp(sigma, max=EPS_SL), sigma)
    safe_b = torch.where(bflux.abs() < 1e-12, -1e-12, bflux)
    l_mo = -(ustar ** 3) / (KAPPA * safe_b)
    zeta = sig_eff * hbl[..., None] / l_mo[..., None]

    # stable (zeta > 0): w = kappa u* / (1 + 5 zeta)
    w_stab = KAPPA * ustar[..., None] / (1.0 + 5.0 * torch.clamp(zeta,
                                                                 min=0.0))
    # unstable; the branch not taken may be NaN, as in the reference
    zm = torch.clamp(zeta, max=0.0)
    w_m_un = torch.where(
        zm > ZETA_M,
        KAPPA * ustar[..., None] * (1.0 - 16.0 * zm) ** 0.25,
        KAPPA * ustar[..., None] * (A_M - C_M * zm) ** (1.0 / 3.0))
    w_s_un = torch.where(
        zm > ZETA_S,
        KAPPA * ustar[..., None] * (1.0 - 16.0 * zm) ** 0.5,
        KAPPA * ustar[..., None] * (A_S - C_S * zm) ** (1.0 / 3.0))
    stable = zeta >= 0.0
    w_m = torch.where(stable, w_stab, w_m_un)
    w_s = torch.where(stable, w_stab, w_s_un)
    return w_m, w_s


def surface_forcing_scales(cfg, forcing, rho, tracers):
    """u* (m/s) and the destabilizing surface buoyancy flux (m2/s3).
    ref: mpas_ocn_vmix_cvmix.F surfaceBuoyancyForcing /
    surfaceFrictionVelocity."""
    rho0 = cfg.config_density0
    tau = torch.sqrt(forcing.windStressZonal ** 2
                     + forcing.windStressMeridional ** 2)
    ustar = torch.sqrt(tau / rho0)
    # buoyancy gain: g alpha_t Q/(rho0 cp) + g beta_t S FW/rho0
    cp = 3996.0
    alpha_t = cfg.config_eos_linear_alpha / rho0   # 1/K
    beta_t = cfg.config_eos_linear_beta / rho0     # 1/psu
    q_net = forcing.sensibleHeatFlux + forcing.shortwaveFlux
    sss = tracers[:, 0, 1]
    b_gain = gravity * alpha_t * q_net / (rho0 * cp) \
        + gravity * beta_t * sss * forcing.freshwaterFlux / rho0
    return ustar, -b_gain


def boundary_layer_depth(grid, cfg, u, h, rho, ustar, bflux):
    """Bulk-Richardson OBL depth per cell column.
    ref: cvmix_kpp_compute_OBL_depth; Ri_b(z) = (B_r - B(z)) z /
    (|V_r - V(z)|^2 + V_t^2(z))."""
    m = grid.mesh
    rho0 = cfg.config_density0
    z_mid = torch.cumsum(h, dim=-1) - 0.5 * h           # positive down
    b = -gravity * rho / rho0                            # buoyancy
    b_ref = b[:, :1]

    # cell-centred speed from edge normal velocities (mean of squares)
    u2_cell = edge_mean_on_cell(m, u ** 2)
    dv2 = torch.clamp(u2_cell[:, :1] - 2.0 * torch.sqrt(
        u2_cell[:, :1] * u2_cell) + u2_cell, min=0.0) + 1e-10

    # N at layer middles (from local stratification)
    dz = torch.clamp(0.5 * (h + torch.roll(h, 1, dims=-1)), min=1e-3)
    db = b - torch.cat([b[:, :1], b[:, :-1]], dim=-1)
    n2 = torch.clamp(-db / dz, min=0.0)
    n_freq = torch.sqrt(n2)

    # unresolved shear Vt^2 (Large eq. 23)
    w_m, w_s = _w_scales(torch.ones_like(rho), h.sum(-1), ustar, bflux)
    vt2 = (C_V * math.sqrt(-BETA_T / (C_S * EPS_SL))
           / (RI_CRIT * KAPPA ** 2) * z_mid * n_freq * w_s)
    vt2 = torch.clamp(vt2, min=1e-10)

    rib = (b_ref - b) * z_mid / (dv2 + vt2)

    # shallowest depth where rib > RI_CRIT: first crossing + interpolation
    above = rib > RI_CRIT
    first = above.to(torch.int32).argmax(dim=-1)     # 0 if none/immediate
    any_cross = above.any(dim=-1)
    nz = rib.shape[-1]
    idx = torch.clamp(first, 1, nz - 1)[:, None]
    idx0 = torch.clamp(idx - 1, min=0)
    r1, r0 = rib.gather(-1, idx)[:, 0], rib.gather(-1, idx0)[:, 0]
    z1, z0 = z_mid.gather(-1, idx)[:, 0], z_mid.gather(-1, idx0)[:, 0]
    frac = torch.clamp((RI_CRIT - r0) / torch.where(
        (r1 - r0).abs() < 1e-12, 1e-12, r1 - r0), 0.0, 1.0)
    hbl = z0 + frac * (z1 - z0)
    col_depth = h.sum(-1)
    hbl = torch.where(any_cross, hbl, col_depth)       # mixes to bottom
    # Ekman/Monin-Obukhov limits under stable forcing
    return torch.minimum(torch.maximum(hbl, 0.5 * h[:, 0]), col_depth)


def coefs_kpp(grid, cfg, u, h, rho, forcing=None, tracers=None):
    """KPP viscosity (nEdges, nz-1), diffusivity (nCells, nz-1), nonlocal
    transport coefficient (nCells, nz-1) and boundary-layer depth
    (nCells,); the nonlocal term multiplies the surface tracer flux
    (ref: vertNonLocalFlux)."""
    m = grid.mesh

    if forcing is None:
        ustar = torch.full((m.nCells,), 1e-3, dtype=u.dtype, device=u.device)
        bflux = torch.zeros((m.nCells,), dtype=u.dtype, device=u.device)
    else:
        ustar, bflux = surface_forcing_scales(cfg, forcing, rho, tracers)
    ustar = torch.clamp(ustar, min=1e-4)

    hbl = boundary_layer_depth(grid, cfg, u, h, rho, ustar, bflux)

    # interior interface depths (nz-1 of them), positive down
    z_int = torch.cumsum(h, dim=-1)[:, :-1]
    sigma = torch.clamp(z_int / hbl[:, None], 0.0, 1.0)
    w_m, w_s = _w_scales(sigma, hbl, ustar, bflux)
    shape = sigma * (1.0 - sigma) ** 2                # G(sigma)

    k_m_bl = hbl[:, None] * w_m * shape
    k_s_bl = hbl[:, None] * w_s * shape

    # interior mixing below the OBL: shear (Richardson) + background
    visc_int_e, diff_int_c = coefs_rich(grid, cfg, u, h, rho)

    in_bl = z_int < hbl[:, None]
    diff = torch.where(in_bl, torch.maximum(k_s_bl, diff_int_c), diff_int_c)

    # momentum: map the cell-based K_m to edges
    coe = m.cellsOnEdge
    k_m_edge = 0.5 * (k_m_bl[coe[:, 0]] + k_m_bl[coe[:, 1]])
    in_bl_f = in_bl.to(u.dtype)
    in_bl_edge = 0.5 * (in_bl_f[coe[:, 0]] + in_bl_f[coe[:, 1]]) > 0.5
    visc = torch.where(in_bl_edge, torch.maximum(k_m_edge, visc_int_e),
                       visc_int_e)

    # nonlocal transport (unstable only): gamma = Cs G(sigma)
    nonlocal_c = torch.where((bflux > 0.0)[:, None], NONLOCAL_CS * shape,
                             0.0)
    nonlocal_c = torch.where(in_bl, nonlocal_c, 0.0)
    return visc, diff, nonlocal_c, hbl
