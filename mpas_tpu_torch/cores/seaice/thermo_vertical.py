"""Multilayer vertical sea-ice thermodynamics, BL99 and mushy (port of
mpas_tpu/cores/seaice/thermo_vertical.py).

ref capability: src/core_seaice/column/ice_therm_bl99.F90 (Bitz &
Lipscomb 1999 salinity-dependent heat equation), ice_therm_mushy.F90
(mushy-layer enthalpy formulation), ice_therm_vertical.F90 (growth/melt +
enthalpy-conserving layer remap), driven from shared/mpas_seaice_column.F.

Every column (cell x category) is independent, so the scheme is a batched
solve with the vertical nodes in the last dimension:

  * prognostic per-layer enthalpy q (J/m3, <= 0) for nIceLayers ice and
    nSnowLayers snow layers, plus the skin temperature Ts;
  * the heat equation solved implicitly: one coupled tridiagonal system
    over the nodes [Ts, snow..., ice...] per column
    (`ops.matrix.tridiagonal_solve`), with 4 Picard passes updating the
    T-dependent conductivity/heat capacity and the linearized surface
    energy balance;
  * melting surfaces (Ts clamped to 0 C) take a second solve with a
    Dirichlet surface row, selected per column;
  * basal growth/melt from the conductive/ocean flux imbalance; surface
    melt of snow, then ice, from the residual surface flux;
  * an enthalpy-conserving remap back to equal-thickness sigma layers
    through an (nlyr x nlyr) overlap matrix.

Closures (`config_thermo_type`): "bl99", q(T) of the Bitz-Lipscomb
brine-pocket form with the fixed CICE salinity profile, k = k0 + beta S /
T; "mushy", q = phi rho_w c_w T + (1 - phi)(rho_i c_i T - rho_i L) with
phi = S / S_br(T), S_br = -T/mu, the conductivity blending brine and ice.
"""

from __future__ import annotations

import numpy as np
import torch

from mpas_tpu_torch.containers import resolve_device
from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.state import const_tensor
from mpas_tpu_torch.ops.matrix import tridiagonal_solve

_T0 = 273.15
CP_ICE = 2106.0       # J/kg/K   (ref ice_constants_colpkg.F90 cp_ice)
CP_OCN = 4218.0       # J/kg/K   (cp_ocn)
LFRESH = 3.34e5       # J/kg     (Lfresh)
MU = 0.054            # liquidus slope, degC / (g/kg)  (depressT/mu)
KICE0 = 2.03          # W/m/K    fresh-ice conductivity
BETA_K = 0.13         # BL99 salinity conductivity coefficient
KSNOW = 0.30
RHOW = 1026.0
MIN_K = 0.1


def bl99_salinity_profile(nilyr: int) -> np.ndarray:
    """Prescribed CICE/BL99 salinity at layer midpoints (g/kg).
    ref: ice_therm_bl99.F90 salinity profile s(z) =
    0.5 smax (1 - cos(pi z^(a/(z+b)))), a=0.407, b=0.573, smax=3.2."""
    z = (np.arange(nilyr) + 0.5) / nilyr
    smax, a, b = 3.2, 0.407, 0.573
    return 0.5 * smax * (1.0 - np.cos(np.pi * z ** (a / (z + b))))


def _sigma_interfaces(n, like):
    """(k / n for k = 0..n) on like's device and dtype."""
    return const_tensor(tuple(np.arange(n + 1) / n), like.device,
                        like.dtype)


# ---------------------------------------------------------------------------
# enthalpy <-> temperature relations
# ---------------------------------------------------------------------------

def enthalpy_ice_bl99(cfg: SeaiceConfig, T, S):
    """q(T,S) J/m3 (<=0), BL99 brine-pocket form.
    ref: ice_therm_shared.F90 enthalpy_ice."""
    Tm = -MU * S
    T = torch.minimum(T, Tm - 1e-6)
    return -cfg.rho_ice * (CP_ICE * (Tm - T)
                           + LFRESH * (1.0 - Tm / T) - CP_OCN * Tm)


def temperature_ice_bl99(cfg: SeaiceConfig, q, S):
    """Invert BL99 enthalpy: quadratic closed form.
    ref: ice_therm_shared.F90 calculate_Tin_from_qin."""
    Tm = -MU * S
    a = CP_ICE
    b = (CP_OCN - CP_ICE) * Tm - q / cfg.rho_ice - LFRESH
    c = LFRESH * Tm
    disc = (b * b - 4.0 * a * c).clamp(min=0.0)
    T = (-b - torch.sqrt(disc)) / (2.0 * a)
    return torch.minimum(T, Tm)


def enthalpy_mush(cfg: SeaiceConfig, T, S):
    """Mush enthalpy: phi rho_w c_w T + (1-phi)(rho_i c_i T - rho_i L).
    phi = S/S_br(T), S_br = -T/mu (linear liquidus).
    ref capability: ice_mushy_physics.F90 enthalpy_mush/liquid_fraction."""
    Sbr = (-T / MU).clamp(min=1e-12)
    phi = (S / Sbr).clamp(0.0, 1.0)
    return (phi * RHOW * CP_OCN * T
            + (1.0 - phi) * (cfg.rho_ice * CP_ICE * T
                             - cfg.rho_ice * LFRESH))


def temperature_mush(cfg: SeaiceConfig, q, S):
    """Invert mush enthalpy for T (quadratic in T when phi < 1).
    ref capability: ice_mushy_physics.F90 temperature_mush."""
    # fully frozen branch: q = rho_i c_i T - rho_i L
    T_fr = (q + cfg.rho_ice * LFRESH) / (cfg.rho_ice * CP_ICE)
    # mush branch: a T^2 + b T + c = 0 with
    a = cfg.rho_ice * CP_ICE
    b = (cfg.rho_ice * CP_ICE - RHOW * CP_OCN) * MU * S \
        - cfg.rho_ice * LFRESH - q
    c = -cfg.rho_ice * LFRESH * MU * S
    disc = (b * b - 4.0 * a * c).clamp(min=0.0)
    T_mu = (-b - torch.sqrt(disc)) / (2.0 * a)
    # the mush branch applies while the implied liquid fraction is positive
    phi_mu = (S / (-T_mu / MU).clamp(min=1e-12)).clamp(0.0, 1.0)
    T = torch.where(phi_mu > 1e-6, T_mu, T_fr)
    return torch.minimum(T, -MU * S)


def enthalpy_snow(cfg: SeaiceConfig, T):
    """ref: ice_therm_shared.F90 enthalpy_snow: -rho_s (L - c_i T)."""
    return -cfg.rho_snow * (LFRESH - CP_ICE * T)


def temperature_snow(cfg: SeaiceConfig, q):
    return ((LFRESH + q / cfg.rho_snow) / CP_ICE).clamp(max=0.0)


def conductivity_ice(cfg: SeaiceConfig, T, S, mushy: bool):
    if mushy:
        Sbr = (-T / MU).clamp(min=1e-12)
        phi = (S / Sbr).clamp(0.0, 1.0)
        k = (1.0 - phi) * KICE0 + phi * 0.56   # brine conductivity
    else:
        k = KICE0 + BETA_K * S / T.clamp(max=-0.02)
    return k.clamp(min=MIN_K)


def heat_capacity_ice(cfg: SeaiceConfig, T, S):
    """Effective volumetric heat capacity rho c_eff = dq/dT (J/m3/K);
    the BL99 form c = c0 + L mu S / T^2, also a mush approximation."""
    T = T.clamp(max=-0.02)
    return cfg.rho_ice * (CP_ICE + LFRESH * MU * S / (T * T))


# ---------------------------------------------------------------------------
# implicit vertical heat solve
# ---------------------------------------------------------------------------

def _solve_heat(cfg: SeaiceConfig, T_s, T_sn, T_in, S_in, h_i, h_s,
                surf_fn, sw_ice, dt, mushy):
    """One column heat solve, batched over leading dims.

    Nodes: [surface skin, snow (nslyr), ice (nilyr)]; bottom Dirichlet at
    the basal liquidus. surf_fn(Ts) -> (f, df/dTs): the surface energy
    balance re-linearized at each Picard pass. sw_ice: absorbed shortwave
    per ice layer (W/m2). Returns (T_s, T_sn, T_in, kh0, kh_bot).
    ref: ice_therm_bl99.F90 temperature_changes tridiagonal assembly."""
    nslyr = T_sn.shape[-1]
    dz_i = h_i.clamp(min=1e-3)[..., None] / T_in.shape[-1]
    # vanished snow -> a thermally thin 1 mm contact layer (negligible
    # resistance and heat capacity, handled implicitly)
    dz_s = h_s.clamp(min=1e-3)[..., None] / nslyr
    T_bot = -MU * S_in[..., -1]
    dz = torch.cat([dz_s.expand_as(T_sn), dz_i.expand_as(T_in)], -1)
    dz_half = 0.5 * dz
    sw_lyr = torch.cat([torch.zeros_like(T_sn), sw_ice], -1)
    rc_s = torch.full_like(T_sn, cfg.rho_snow * CP_ICE)
    k_sn = torch.full_like(T_sn, KSNOW)

    for _ in range(4):   # Picard passes
        f0, dfdt = surf_fn(T_s)
        kk = torch.cat([k_sn, conductivity_ice(cfg, T_in, S_in, mushy)], -1)
        rc = torch.cat([rc_s, heat_capacity_ice(cfg, T_in, S_in)], -1)

        # interface conductances between node j and j+1
        kh_int = kk[..., :-1] * kk[..., 1:] / (
            kk[..., :-1] * dz_half[..., 1:] + kk[..., 1:] * dz_half[..., :-1]
        ).clamp(min=1e-12)
        kh0 = kk[..., 0] / dz_half[..., 0].clamp(min=1e-6)
        kh_bot = kk[..., -1] / dz_half[..., -1].clamp(min=1e-6)
        eta = dt / (rc * dz).clamp(min=1e-12)
        T_old = torch.cat([T_sn, T_in], -1)

        # tridiagonal of n = 1 + nslyr + nilyr rows: the surface row
        # (dfdt - kh0) Ts + kh0 T1 = -f0 + dfdt Ts, then the layer rows
        kh_up = torch.cat([kh0[..., None], kh_int], -1)
        kh_dn = torch.cat([kh_int, kh_bot[..., None]], -1)
        zero = torch.zeros_like(kh0[..., None])
        a = torch.cat([zero, -eta * kh_up], -1)
        b = torch.cat([(dfdt - kh0)[..., None],
                       1.0 + eta * (kh_up + kh_dn)], -1)
        c = torch.cat([kh0[..., None], -eta[..., :-1] * kh_dn[..., :-1],
                       zero], -1)
        rhs = T_old + eta * sw_lyr
        rhs = torch.cat([rhs[..., :-1], (rhs[..., -1] + eta[..., -1]
                                         * kh_bot * T_bot)[..., None]], -1)
        d = torch.cat([(-f0 + dfdt * T_s)[..., None], rhs], -1)

        sol = tridiagonal_solve(a, b, c, d)
        T_s_new = sol[..., 0].clamp(max=0.0)

        # melting columns: a Dirichlet Ts = 0 re-solve
        melting = sol[..., 0] > 0.0
        b0 = torch.where(melting, 1.0, b[..., 0])
        c0 = torch.where(melting, 0.0, c[..., 0])
        d0 = torch.where(melting, 0.0, d[..., 0])
        sol2 = tridiagonal_solve(a, torch.cat([b0[..., None], b[..., 1:]], -1),
                                 torch.cat([c0[..., None], c[..., 1:]], -1),
                                 torch.cat([d0[..., None], d[..., 1:]], -1))
        sol = torch.where(melting[..., None], sol2, sol)
        T_s = torch.where(melting, 0.0, T_s_new)
        T_sn = sol[..., 1:1 + nslyr].clamp(max=0.0)
        T_in = torch.minimum(sol[..., 1 + nslyr:], -MU * S_in - 1e-4)

    return T_s, T_sn, T_in, kh0, kh_bot


def thermo_multilayer(cfg: SeaiceConfig, a, vi, vs, T_s, q_i, q_s,
                      sw_down, lw_down, t_air, f_ocean, dt,
                      sw_abs_lyr=None, albedo=None, sw_through=None,
                      salinity=None):
    """Full multilayer vertical thermodynamics for (nCells, nCat) columns.

    Returns the updated (a, vi, vs, T_s, q_i, q_s) and a dict of
    diagnostics. ref: ice_therm_vertical.F90 thermo_vertical call sequence.

    salinity: optional prognostic per-layer bulk salinity
    (nCells, nCat, nilyr) from the zsalinity tracer; when given, the
    conductivity and the mush liquidus use the evolving profile in place
    of the fixed BL99 shape."""
    mushy = cfg.config_thermo_type == "mushy"
    nilyr = q_i.shape[-1]
    if salinity is not None and salinity.shape == q_i.shape:
        S = salinity.to(q_i.dtype)
    else:
        S = const_tensor(tuple(bl99_salinity_profile(nilyr)), q_i.device,
                         q_i.dtype).expand(q_i.shape)

    has_ice = a > cfg.puny
    a_safe = a.clamp(min=cfg.puny)
    h_i = torch.where(has_ice, vi / a_safe, 0.0)
    h_s = torch.where(has_ice, vs / a_safe, 0.0)

    T_in = temperature_mush(cfg, q_i, S) if mushy \
        else temperature_ice_bl99(cfg, q_i, S)
    T_sn = temperature_snow(cfg, q_s)

    # surface energy balance linearization
    if sw_abs_lyr is None:
        # CCSM3-style band albedos + Beer's-law interior absorption
        if albedo is None:
            albedo = torch.where(h_s > 0.01, torch.full_like(h_s, 0.80),
                                 0.60)
        i0 = torch.where(h_s > 1e-4, torch.zeros_like(h_s), 0.17)
        sw_net = (1.0 - albedo) * sw_down
        sw_surf = (1.0 - i0) * sw_net
        kap = 1.4                                 # 1/m
        tr = torch.exp(-kap * (_sigma_interfaces(nilyr, h_i)
                               * h_i[..., None]))
        sw_pen = i0 * sw_net
        sw_abs_lyr = sw_pen[..., None] * (tr[..., :-1] - tr[..., 1:])
        sw_ocean_thru = sw_pen * tr[..., -1]
    else:
        # delta-Eddington per-layer absorption (W/m2); the surface takes
        # the net minus the interior minus the transmitted
        sw_ocean_thru = (torch.zeros_like(sw_down) if sw_through is None
                         else sw_through)
        sw_net = (1.0 - albedo) * sw_down
        sw_surf = (sw_net - sw_abs_lyr.sum(-1) - sw_ocean_thru).clamp(
            min=0.0)

    c_sens = 10.0
    eps_sigma = cfg.emissivity * cfg.stefan_boltzmann

    def surf_fn(ts):
        tk = ts + _T0
        f = sw_surf + lw_down - eps_sigma * tk ** 4 - c_sens * (ts - t_air)
        df = -4.0 * eps_sigma * tk ** 3 - c_sens
        return f, df

    T_s2, T_sn2, T_in2, kh0, kh_bot = _solve_heat(
        cfg, T_s, T_sn, T_in, S, h_i, h_s, surf_fn, sw_abs_lyr, dt, mushy)

    # post-solve layer enthalpies (for the melt energies and the remap)
    q_i = enthalpy_fn(cfg, mushy)(T_in2, S)
    q_s = enthalpy_snow(cfg, T_sn2)

    # --- growth / melt ---------------------------------------------------
    T_bot = -MU * S[..., -1]
    f_cond_bot = kh_bot * (T_bot - T_in2[..., -1])   # upward conduction
    # enthalpy of new basal ice at (T_bot, S_bot)
    q_bot = enthalpy_fn(cfg, mushy)(T_bot - 0.5, S[..., -1])
    grow = (f_cond_bot - f_ocean).clamp(min=0.0)
    dh_grow = dt * grow / (-q_bot).clamp(min=1e3)
    melt_b = (f_ocean - f_cond_bot).clamp(min=0.0)
    dh_melt_bot = torch.minimum(dt * melt_b / (-q_i[..., -1]).clamp(min=1e3),
                                h_i)

    # surface melt: the balance's residual at Ts = 0 beyond what conducts
    f_cond_top = kh0 * (T_s2 - T_sn2[..., 0])
    tk2 = T_s2 + _T0
    f_surf = (sw_surf + lw_down - eps_sigma * tk2 ** 4
              - c_sens * (T_s2 - t_air))
    f_melt = (f_surf - f_cond_top).clamp(min=0.0) * (T_s2 >= -1e-6)
    dh_snow_melt = torch.minimum(
        dt * f_melt / (-q_s[..., 0]).clamp(min=1e3), h_s)
    used = dh_snow_melt * (-q_s[..., 0]) / dt
    dh_ice_surf_melt = torch.minimum(
        dt * (f_melt - used).clamp(min=0.0) / (-q_i[..., 0]).clamp(min=1e3),
        h_i)

    h_i_new = (h_i + dh_grow - dh_melt_bot - dh_ice_surf_melt).clamp(min=0.0)
    h_s_new = (h_s - dh_snow_melt).clamp(min=0.0)

    # --- enthalpy remap to sigma layers ----------------------------------
    # The post-change column = [post-solve column shaved at both ends][new
    # basal slab of q_bot], remapped conservatively onto nilyr equal sigma
    # layers (ref: adjust_enthalpy). Fully melted layers collapse to zero
    # width and drop out of the overlap weights.
    sig = _sigma_interfaces(nilyr, h_i)
    lo_clip = dh_ice_surf_melt[..., None]
    hi_clip = (h_i - dh_melt_bot)[..., None]
    zo = torch.minimum(torch.maximum(sig * h_i[..., None], lo_clip),
                       torch.maximum(hi_clip, lo_clip)) - lo_clip
    # the growth slab as one extra pseudo-layer
    zo_all = torch.cat([zo, zo[..., -1:] + dh_grow[..., None]], -1)
    q_all = torch.cat([q_i, q_bot[..., None]], -1)
    zn = sig * h_i_new.clamp(min=1e-12)[..., None]
    lo = torch.maximum(zo_all[..., None, :-1], zn[..., :-1, None])
    hi_ = torch.minimum(zo_all[..., None, 1:], zn[..., 1:, None])
    w = (hi_ - lo).clamp(min=0.0)
    q_i_new = torch.einsum("...jk,...k->...j", w, q_all) / w.sum(-1).clamp(
        min=1e-12)
    q_i_new = torch.where(h_i_new[..., None] > cfg.puny, q_i_new,
                          enthalpy_fn(cfg, mushy)(torch.full_like(q_i, -5.0),
                                                  S))
    q_s_new = torch.where(h_s_new[..., None] > cfg.puny,
                          enthalpy_snow(cfg, T_sn2),
                          enthalpy_snow(cfg, torch.zeros_like(T_sn2)))

    gone = (h_i_new <= cfg.puny) | ~has_ice
    a_new = torch.where(gone, 0.0, a)
    vi_new = a_new * h_i_new
    vs_new = torch.where(gone, 0.0, a_new * h_s_new)
    T_s_out = torch.where(gone, 0.0, T_s2)

    diags = {
        "basalGrowth": (a * dh_grow).sum(-1) / dt,
        "basalMelt": (a * dh_melt_bot).sum(-1) / dt,
        "surfaceMelt": (a * (dh_ice_surf_melt + dh_snow_melt)).sum(-1) / dt,
        "shortwaveThroughOcean": (a * sw_ocean_thru).sum(-1),
        "congelation": (a * dh_grow).sum(-1),
    }
    return a_new, vi_new, vs_new, T_s_out, q_i_new, q_s_new, diags


def enthalpy_fn(cfg: SeaiceConfig, mushy: bool):
    if mushy:
        return lambda T, S: enthalpy_mush(cfg, T, S)
    return lambda T, S: enthalpy_ice_bl99(cfg, T, S)


def init_enthalpy(cfg: SeaiceConfig, n_cells: int, n_cat: int,
                  nilyr: int = 7, nslyr: int = 1, T_init: float = -5.0,
                  dtype=torch.float64, device=None):
    """Cold-start per-layer enthalpies at a uniform temperature, on
    `device` (cuda:0 when None)."""
    device = resolve_device(device)
    S = torch.as_tensor(bl99_salinity_profile(nilyr), dtype=dtype,
                        device=device)
    T = torch.full((n_cells, n_cat, nilyr), T_init, dtype=dtype,
                   device=device)
    mushy = cfg.config_thermo_type == "mushy"
    q_i = enthalpy_fn(cfg, mushy)(T, S.expand(T.shape))
    q_s = enthalpy_snow(cfg, torch.full((n_cells, n_cat, nslyr), T_init,
                                        dtype=dtype, device=device))
    return q_i, q_s


def column_energy(cfg: SeaiceConfig, a, vi, vs, q_i, q_s):
    """Total column energy (J/m2 of grid area) for conservation checks."""
    e_i = q_i.sum(-1) * vi / q_i.shape[-1]
    e_s = q_s.sum(-1) * vs / q_s.shape[-1]
    return (e_i + e_s).sum(-1)
