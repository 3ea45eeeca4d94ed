"""Vertical mixing coefficient schemes (port of
mpas_tpu/cores/ocean/vmix.py).

ref: src/core_ocean/shared/mpas_ocn_vmix.F (dispatch + implicit solves) and
the coefficient builders: mpas_ocn_vmix_coefs_const.F,
mpas_ocn_vmix_coefs_rich.F (Richardson; visc :258-282, diff :362-385),
mpas_ocn_vmix_coefs_tanh.F, mpas_ocn_vmix_cvmix.F (CVMix interface).

Each builder returns interface coefficients:
  vert_visc: (nEdges, nz-1)  at interior interfaces of edge columns
  vert_diff: (nCells, nz-1)  at interior interfaces of cell columns
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import gravity
from mpas_tpu_torch.ops import stencils as st


def edge_mean_on_cell(mesh, f_edge):
    """Mean of an (nEdges, k) field over each cell's edges (the cell
    averages of the shear, the Redi slope and the KPP speed)."""
    cnt = torch.clamp(mesh.edgesOnCellMask.sum(1), min=1.0)
    return st.edge_sum_on_cell(mesh, f_edge) / cnt[:, None]


def richardson_number(grid, cfg, u, h, rho):
    """Ri at interior cell interfaces: N^2 / shear^2, and its edge mean.
    ref: ocn_vmix_get_rich_numbers (mpas_ocn_vmix_coefs_rich.F:403+)."""
    m = grid.mesh
    rho0 = cfg.config_density0
    h_mid = 0.5 * (h[:, :-1] + h[:, 1:])                  # (nCells, nz-1)
    drho = rho[:, 1:] - rho[:, :-1]                       # > 0 stable
    n2 = (gravity / rho0) * drho / torch.clamp(h_mid, min=1e-3)

    du2_edge = (u[:, :-1] - u[:, 1:]) ** 2                # (nEdges, nz-1)
    # edge -> cell mean (ref averages du2 onto cells, :560-572)
    du2_cell = edge_mean_on_cell(m, du2_edge)
    shear2 = du2_cell / torch.clamp(h_mid, min=1e-3) ** 2

    ri = n2 / torch.clamp(shear2, min=1e-12)
    coe = m.cellsOnEdge
    ri_edge = 0.5 * (ri[coe[:, 0]] + ri[coe[:, 1]])
    return ri, ri_edge


def coefs_const(grid, cfg, u, h, rho):
    """ref: mpas_ocn_vmix_coefs_const.F."""
    nzm1 = grid.nz - 1
    visc = torch.full((grid.mesh.nEdges, nzm1), cfg.config_vert_visc,
                      dtype=u.dtype, device=u.device)
    diff = torch.full((grid.mesh.nCells, nzm1), cfg.config_vert_diff,
                      dtype=u.dtype, device=u.device)
    return visc, diff


def coefs_rich(grid, cfg, u, h, rho):
    """Richardson-number dependent Pacanowski-Philander mixing.
    ref: mpas_ocn_vmix_coefs_rich.F:258-282 (visc), :362-385 (diff)."""
    ri_cell, ri_edge = richardson_number(grid, cfg, u, h, rho)
    bk_v = cfg.config_bkrd_vert_visc
    bk_d = cfg.config_bkrd_vert_diff
    mix = cfg.config_rich_mix

    den_e = (1.0 + 5.0 * torch.clamp(ri_edge, min=0.0)) ** 2
    visc = torch.where(
        ri_edge > 0.0,
        torch.clamp(bk_v + mix / den_e, max=cfg.config_convective_visc),
        cfg.config_convective_visc)

    den_c = 1.0 + 5.0 * torch.clamp(ri_cell, min=0.0)
    diff = torch.where(
        ri_cell > 0.0,
        torch.clamp(bk_d + (bk_v + mix / den_c ** 2) / den_c,
                    max=cfg.config_convective_diff),
        cfg.config_convective_diff)
    return visc, diff


def coefs_tanh(grid, cfg, u, h, rho):
    """Depth-profile tanh mixing (max near the surface, min at depth).
    ref: mpas_ocn_vmix_coefs_tanh.F:220-223."""
    depth_int = torch.cumsum(h, dim=-1)[:, :-1]          # (nCells, nz-1)
    zmid = cfg.config_tanh_zmid
    width = cfg.config_tanh_zwidth

    def prof(vmax, vmin, d):
        return (-(vmax - vmin) * 0.5 * torch.tanh((d + zmid) / width)
                + (vmax + vmin) * 0.5)

    diff = prof(cfg.config_max_diff_tanh, cfg.config_min_diff_tanh,
                depth_int)
    coe = grid.mesh.cellsOnEdge
    d_edge = 0.5 * (depth_int[coe[:, 0]] + depth_int[coe[:, 1]])
    visc = prof(cfg.config_max_visc_tanh, cfg.config_min_visc_tanh, d_edge)
    return visc, diff


def _convective(grid, cfg, rho, visc, diff):
    """Raise the coefficients to their convective values wherever the
    column is statically unstable (N^2 < 0)."""
    unstable_c = (rho[:, 1:] - rho[:, :-1]) < 0.0        # (nCells, nz-1)
    diff = torch.where(unstable_c, cfg.config_convective_diff, diff)
    coe = grid.mesh.cellsOnEdge
    unstable_e = unstable_c[coe[:, 0]] | unstable_c[coe[:, 1]]
    visc = torch.where(unstable_e, cfg.config_convective_visc, visc)
    return visc, diff


def coefs_cvmix_convection(grid, cfg, u, h, rho):
    """Convective-instability mixing (the CVMix convection scheme of
    mpas_ocn_vmix_cvmix.F): background values, raised to convective values
    wherever the column is statically unstable."""
    visc, diff = coefs_const(grid, cfg, u, h, rho)
    return _convective(grid, cfg, rho, visc, diff)


def coefs_cvmix_shear(grid, cfg, u, h, rho):
    """CVMix shear-instability interior mixing (ref: mpas_ocn_vmix_cvmix.F
    cvmix_shear block, config_cvmix_shear_mixing_scheme):
      'KPP' = LMD94:  nu = nu0 * (1 - (Ri/Ri0)^2)^3  for 0 < Ri < Ri0
      'PP'  = Pacanowski-Philander: nu = nu0/(1+5Ri)^2, kappa = nu/(1+5Ri)
    Returns the shear contribution only."""
    ri_cell, ri_edge = richardson_number(grid, cfg, u, h, rho)
    if cfg.config_cvmix_shear_mixing_scheme == "PP":
        nu0 = cfg.config_cvmix_shear_pp_nu_zero
        alpha = 5.0
        visc = nu0 / (1.0 + alpha * torch.clamp(ri_edge, min=0.0)) ** 2
        diff = (nu0 / (1.0 + alpha * torch.clamp(ri_cell, min=0.0)) ** 2) \
            / (1.0 + alpha * torch.clamp(ri_cell, min=0.0))
        return visc, diff
    nu0 = cfg.config_cvmix_shear_kpp_nu_zero
    ri0 = cfg.config_cvmix_shear_kpp_Ri_zero
    expo = cfg.config_cvmix_shear_kpp_exp

    def lmd(ri):
        x = torch.clamp(ri / ri0, 0.0, 1.0)
        return nu0 * (1.0 - x * x) ** expo
    return (lmd(torch.clamp(ri_edge, min=0.0)),
            lmd(torch.clamp(ri_cell, min=0.0)))


def coefs_cvmix_tidal(grid, cfg, u, h, rho):
    """CVMix tidal mixing, Simmons et al. (2004) genre
    (ref: mpas_ocn_vmix_cvmix.F cvmix_tidal block):
      kappa(z) = q * Gamma * E(x,y) * F(z) / (rho * max(N^2, N2min))
      F(z) = exp(-(H - d)/zeta) / (zeta * (1 - exp(-H/zeta)))
    E: grid.tidalEnergyFlux where present, else the config constant."""
    m = grid.mesh
    q = cfg.config_cvmix_tidal_mixing_q
    gam = cfg.config_cvmix_tidal_efficiency
    zeta = cfg.config_cvmix_tidal_vertical_decay_scale
    e_flux = grid.tidalEnergyFlux
    if e_flux is None:
        e_flux = torch.full((m.nCells,), cfg.config_cvmix_tidal_energy_flux,
                            dtype=u.dtype, device=u.device)
    rho0 = cfg.config_density0
    h_mid = 0.5 * (h[:, :-1] + h[:, 1:])
    drho = rho[:, 1:] - rho[:, :-1]
    n2 = (gravity / rho0) * drho / torch.clamp(h_mid, min=1e-3)
    n2 = torch.clamp(n2, min=1.0e-8)
    depth_int = torch.cumsum(h, dim=-1)[:, :-1]          # interface depth
    hcol = h.sum(-1, keepdim=True)
    fz = torch.exp(-(hcol - depth_int) / zeta) \
        / (zeta * torch.clamp(1.0 - torch.exp(-hcol / zeta), min=1e-6))
    diff = q * gam * e_flux[:, None] * fz / (rho0 * n2)
    diff = torch.clamp(diff, max=cfg.config_cvmix_tidal_max)
    coe = m.cellsOnEdge
    visc = 0.5 * (diff[coe[:, 0]] + diff[coe[:, 1]])
    return visc, diff


def coefs_cvmix_double_diffusion(grid, cfg, tracers, h):
    """CVMix double diffusion (LMD94 salt fingering + diffusive
    convection; ref: mpas_ocn_vmix_cvmix.F cvmix_ddiff block): the
    diffusivity contribution at cell interfaces."""
    t = tracers[..., 0]
    s = tracers[..., 1]
    alpha = cfg.config_eos_linear_alpha
    beta = cfg.config_eos_linear_beta
    dT = t[:, :-1] - t[:, 1:]       # positive: warm over cold
    dS = s[:, :-1] - s[:, 1:]
    num = alpha * dT
    den = beta * dS
    r_rho = num / torch.where(den.abs() > 1e-12, den, 1e-12)
    # salt fingering: warm-salty over cold-fresh, 1 < R_rho < 1.9
    rr0 = 1.9
    kap_max = 1.0e-4
    x = torch.clamp((r_rho - 1.0) / (rr0 - 1.0), 0.0, 1.0)
    finger = torch.where((num > 0) & (den > 0) & (r_rho > 1.0),
                         kap_max * (1.0 - x) ** 3, 0.0)
    # diffusive convection: cold-fresh over warm-salty, 0 < R_rho < 1
    mol = 1.4e-7
    rr = torch.clamp(r_rho, 1e-3, 1.0)
    dc = torch.where((num < 0) & (den < 0) & (r_rho < 1.0) & (r_rho > 0.0),
                     mol * 0.909 * torch.exp(
                         4.6 * torch.exp(-0.54 * (1.0 / rr - 1.0))), 0.0)
    return finger + dc


def coefs_cvmix(grid, cfg, u, h, rho, tracers=None):
    """CVMix combination: background + enabled interior schemes (shear, tidal,
    double diffusion), convective values applied last
    (ref: mpas_ocn_vmix_cvmix.F:169-420)."""
    visc, diff = coefs_const(grid, cfg, u, h, rho)
    if cfg.config_use_cvmix_shear:
        v2, d2 = coefs_cvmix_shear(grid, cfg, u, h, rho)
        visc = visc + v2
        diff = diff + d2
    if cfg.config_use_cvmix_tidal_mixing:
        v3, d3 = coefs_cvmix_tidal(grid, cfg, u, h, rho)
        visc = visc + v3
        diff = diff + d3
    if cfg.config_use_cvmix_double_diffusion \
            and tracers is not None and tracers.shape[-1] >= 2:
        diff = diff + coefs_cvmix_double_diffusion(grid, cfg, tracers, h)
    if cfg.config_use_cvmix_convection:
        visc, diff = _convective(grid, cfg, rho, visc, diff)
    return visc, diff


_SCHEMES = {
    "const": coefs_const,
    "rich": coefs_rich,
    "tanh": coefs_tanh,
    "cvmix": coefs_cvmix_convection,
}


def build_coefs(grid, cfg, u, h, rho, forcing=None, tracers=None):
    """Scheme dispatcher (ref: ocn_vmix_coefs_build, mpas_ocn_vmix.F).
    Returns (vert_visc, vert_diff, nonlocal or None); only the KPP scheme
    produces the nonlocal coefficient."""
    scheme = cfg.config_vert_mix_scheme
    if scheme in ("kpp", "cvmix_kpp"):
        from mpas_tpu_torch.cores.ocean.kpp import coefs_kpp
        visc, diff, nonlocal_c, _hbl = coefs_kpp(
            grid, cfg, u, h, rho, forcing=forcing, tracers=tracers)
        return visc, diff, nonlocal_c
    if scheme == "cvmix" and (cfg.config_use_cvmix_shear
                              or cfg.config_use_cvmix_tidal_mixing
                              or cfg.config_use_cvmix_double_diffusion):
        visc, diff = coefs_cvmix(grid, cfg, u, h, rho, tracers=tracers)
        return visc, diff, None
    visc, diff = _SCHEMES[scheme](grid, cfg, u, h, rho)
    return visc, diff, None
