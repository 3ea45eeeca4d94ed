"""Mushy-layer sea-ice physics: Assur liquidus, enthalpy inversion,
two-mode gravity drainage, flushing, and the coupled T-S column update
(port of mpas_tpu/cores/seaice/mushy.py).

ref: src/core_seaice/column/ice_mushy_physics.F90 (two-region Assur 1958
liquidus :28-135, enthalpy_mush :287-327, temperature_mush quadratic
inversion :361-409, enthalpy_brine :345-357, density_brine :163-180) and
src/core_seaice/column/ice_therm_mushy.F90 (Turner, Hunke & Jeffery 2013
two-mode gravity drainage: explicit_flow_velocities :2840-3011, Golden et
al. 2007 permeability :2820-2836, flushing_velocity :3017-3133,
solve_salinity :2690-2766, and the Picard-coupled temperature-salinity
iteration :1118-1379).

Per-layer arrays are (..., nilyr) with layers last; the layer loops with
cumulative state (the bottom-up permeability/density sweeps) are Python
loops over nilyr. The reference's per-column early exits become masks.

Drainage constants = the reference Registry defaults
(src/core_seaice/Registry.xml:1506-1530): a_rapid_mode = 0.5 mm, Rac =
10, aspect = 1, dSdt_slow = -1.5e-7 m/s/K (the colpkg default),
phi_c_slow = 0.05.
"""

from __future__ import annotations

import math

import torch

# base constants (ref: ice_constants_colpkg.F90, cice set)
RHOI = 917.0
RHOW = 1026.0
RHOS = 330.0
CP_ICE = 2106.0
CP_OCN = 4218.0
LFRESH = 3.34e5
GRAV = 9.80616
VISC_DYN = 1.79e-3          # dynamic viscosity of brine (kg/m/s)
KAPPA_L = 8.824e-8          # heat diffusivity of liquid (m2/s)

# drainage-mode constants (ref Registry.xml:1506-1530 defaults)
A_RAPID = 0.5e-3            # channel radius (m)
RAC_RAPID = 10.0            # critical Rayleigh number
ASPECT_RAPID = 1.0
DSDT_SLOW = -1.5e-7         # slow-mode strength (m/s/K)
PHI_C_SLOW = 0.05
S_MIN = 0.01                # psu floor in solve_salinity
ZSIN_MIN = 0.1

# ---------------------------------------------------------------------------
# Assur (1958) two-region liquidus (ref ice_mushy_physics.F90:28-135)
# ---------------------------------------------------------------------------
AZ1, BZ1 = -18.48, 0.0
AZ2, BZ2 = -10.3085, 62.4
TB_LIQ = -7.6362968855167352
SB_LIQ = 123.66702800276086
AZ1P, BZ1P = AZ1 / 1000.0, BZ1 / 1000.0
AZ2P, BZ2P = AZ2 / 1000.0, BZ2 / 1000.0

AS1 = AZ1P * (RHOW * CP_OCN - RHOI * CP_ICE)
AC1 = RHOI * CP_ICE * AZ1
BS1 = (1.0 + BZ1P) * (RHOW * CP_OCN - RHOI * CP_ICE) + RHOI * LFRESH * AZ1P
BQ1 = -AZ1
BC1 = RHOI * CP_ICE * BZ1 - RHOI * LFRESH * AZ1
CS1 = RHOI * LFRESH * (1.0 + BZ1P)
CQ1 = -BZ1
CC1 = -RHOI * LFRESH * BZ1

AS2 = AZ2P * (RHOW * CP_OCN - RHOI * CP_ICE)
AC2 = RHOI * CP_ICE * AZ2
BS2 = (1.0 + BZ2P) * (RHOW * CP_OCN - RHOI * CP_ICE) + RHOI * LFRESH * AZ2P
BQ2 = -AZ2
BC2 = RHOI * CP_ICE * BZ2 - RHOI * LFRESH * AZ2
CS2 = RHOI * LFRESH * (1.0 + BZ2P)
CQ2 = -BZ2
CC2 = -RHOI * LFRESH * BZ2

D_LIQ = ((1.0 + AZ1P * TB_LIQ + BZ1P) / (AZ1 * TB_LIQ + BZ1)) \
    * ((CP_OCN * RHOW - CP_ICE * RHOI) * TB_LIQ + LFRESH * RHOI)
E_LIQ = CP_ICE * RHOI * TB_LIQ - LFRESH * RHOI

F1 = (-1000.0 * CP_OCN * RHOW) / AZ1
G1 = -1000.0
H1 = (-BZ1 * CP_OCN * RHOW) / AZ1
F2 = (-1000.0 * CP_OCN * RHOW) / AZ2
G2 = -1000.0
H2 = (-BZ2 * CP_OCN * RHOW) / AZ2
I_LIQ = 1.0 / (CP_OCN * RHOW)

J1, K1, L1 = BZ1 / AZ1, 1.0 / 1000.0, (1.0 + BZ1P) / AZ1
J2, K2, L2 = BZ2 / AZ2, 1.0 / 1000.0, (1.0 + BZ2P) / AZ2
M1, N1, O1 = AZ1, -AZ1P, -BZ1 / AZ1
M2, N2, O2 = AZ2, -AZ2P, -BZ2 / AZ2


def _layer_column(x, like):
    """x (a tensor of like's leading shape, or a number) as one extra
    layer beside like (..., nilyr): (..., 1)."""
    if isinstance(x, torch.Tensor):
        return x[..., None].expand_as(like[..., :1])
    return torch.full_like(like[..., :1], x)


def liquidus_brine_salinity(T):
    """Equilibrium brine salinity Sbr(T) (ppt); ref :237-260."""
    sbr = torch.where(T > TB_LIQ, (T + J1) / (K1 * T + L1),
                      (T + J2) / (K2 * T + L2))
    return torch.where(T <= 0.0, sbr, 0.0)


def liquidus_temperature(Sbr):
    """Equilibrium temperature T(Sbr) (C); ref :264-283."""
    return torch.where(Sbr <= SB_LIQ, Sbr / (M1 + N1 * Sbr) + O1,
                       Sbr / (M2 + N2 * Sbr) + O2)


def liquid_fraction(T, S):
    """phi = S / Sbr(T), clipped to [0, 1]; ref :218-233."""
    sbr = liquidus_brine_salinity(T).clamp(min=1.0e-10)
    return (S / sbr).clamp(0.0, 1.0)


def enthalpy_mush(T, S):
    """q(T, S) (J/m3); ref :287-306."""
    phi = liquid_fraction(T, S)
    return phi * (CP_OCN * RHOW - CP_ICE * RHOI) * T \
        + RHOI * CP_ICE * T - (1.0 - phi) * RHOI * LFRESH


def temperature_mush(q, S):
    """T(q, S) via the two-region quadratic inversion; ref :361-409."""
    s_low = S < SB_LIQ
    q0 = torch.where(s_low, (F1 * S) / (G1 + S) + H1,
                     (F2 * S) / (G2 + S) + H2)
    melted = q > q0
    hi = q > D_LIQ * S + E_LIQ
    A = torch.where(hi, AS1 * S + AC1, AS2 * S + AC2)
    B = torch.where(hi, BS1 * S + BQ1 * q + BC1, BS2 * S + BQ2 * q + BC2)
    C = torch.where(hi, CS1 * S + CQ1 * q + CC1, CS2 * S + CQ2 * q + CC2)
    T = (-B + torch.sqrt((B * B - 4.0 * A * C).clamp(min=1.0e-30))) \
        / (2.0 * A)
    return torch.where(melted, q * I_LIQ, T)


def enthalpy_brine(T):
    """ref :345-357."""
    return CP_OCN * RHOW * T


def density_brine(Sbr):
    """ref :163-180 (empirical)."""
    return 1000.3 + 0.78237 * Sbr + 2.8008e-4 * Sbr ** 2


def permeability(phi):
    """Golden et al. 2007 (ref ice_therm_mushy.F90:2820-2836)."""
    return 3.0e-8 * (phi - 0.05).clamp(min=0.0) ** 3


# ---------------------------------------------------------------------------
# Turner et al. 2013 two-mode gravity drainage (ref :2840-3011)
# ---------------------------------------------------------------------------

def explicit_flow_velocities(zSin, zTin, Tsf, Tbot, dt, sss, qocn,
                             hilyr, hin):
    """Rapid-mode Darcy interface flows q (..., nilyr) [upward; q[k] is
    the flow at the TOP of layer k] and slow-mode dSdt, plus the brine
    salinity/enthalpy profiles, batched over leading dims; the bottom-up
    cumulative sweep is a loop over nilyr."""
    nilyr = zSin.shape[-1]
    Sbr = liquidus_brine_salinity(zTin)
    phi = liquid_fraction(zTin, zSin)
    qbr = enthalpy_brine(zTin)
    rho = density_brine(Sbr)
    rho_ocn = density_brine(sss)
    # rho at the interface above layer k: 0.5*(rho[k]+rho[k-1]),
    # rho[-1] = rho[0]
    rho_up = torch.cat([rho[..., :1], rho[..., :-1]], -1)
    rho_pipe = 0.5 * (rho + rho_up)

    qlimit = (0.2 * hilyr) / dt
    ra_const = GRAV / (VISC_DYN * KAPPA_L)
    Ap = (math.pi * A_RAPID ** 4) / (8.0 * VISC_DYN)

    q_list = [None] * nilyr
    dsdt_list = [None] * nilyr
    lead = zSin[..., 0]
    perm_min = torch.full_like(lead, 1.0e30)
    perm_harm = torch.zeros_like(lead)
    rho_sum = torch.zeros_like(lead)
    for j, k in enumerate(range(nilyr - 1, -1, -1)):
        z = ((k + 0.5) / nilyr) * hin
        perm = permeability(phi[..., k])
        perm_min = torch.minimum(perm_min, perm)
        perm_harm = perm_harm + 1.0 / perm.clamp(min=1.0e-30)
        rho_sum = rho_sum + rho[..., k]
        drho = (rho[..., k] - rho_ocn).clamp(min=0.0)
        Ra = drho * (hin - z) * perm_min * ra_const
        rn = float(j + 1)
        L = rn * hilyr
        dx = L * 2.0 * ASPECT_RAPID
        dx2 = dx * dx
        Am = (dx2 * rn) / (VISC_DYN * perm_harm)
        Bm = (-GRAV * rho_sum) / rn
        Bp = -rho_pipe[..., k] * GRAV
        qk = ((Am / dx2) * ((-Ap * Bp - Am * Bm) / (Am + Ap) + Bm)).clamp(
            min=1.0e-30)
        qk = torch.minimum(qk * ((Ra - RAC_RAPID).clamp(min=0.0)
                                 / (Ra + 1.0e-11)), qlimit)
        # slow-mode drainage (ref :2994-2999)
        dsdt = DSDT_SLOW * ((zSin[..., k] - PHI_C_SLOW * Sbr[..., k]).clamp(
            min=0.0) * (Tbot - Tsf).clamp(min=0.0)) / (hin + 0.001)
        dsdt = torch.maximum(dsdt, (-zSin[..., k] * 0.5) / dt)
        # salt-loss safety limiter (ref :3001-3009)
        if k == nilyr - 1:
            sbr_dn = sss * torch.ones_like(Sbr[..., k])
        else:
            sbr_dn = Sbr[..., k + 1]
        ds_guess = ((qk * (sbr_dn - Sbr[..., k])) / hilyr + dsdt) \
            * dt * 10.0
        tiny = ds_guess.abs() < 1.0e-11
        alpha = torch.where(tiny, 1.0, (ZSIN_MIN - zSin[..., k])
                            / torch.where(tiny, 1.0, ds_guess))
        alpha = torch.where((alpha < 0.0) | (alpha > 1.0), 1.0, alpha)
        q_list[k] = qk * alpha
        dsdt_list[k] = dsdt * alpha
    return (torch.stack(q_list, -1), torch.stack(dsdt_list, -1), Sbr, qbr,
            phi)


def flushing_velocity(zTin, phi, hin, hsn, hilyr, hpond, apond, dt):
    """Downward Darcy flushing velocity from the pond hydraulic head
    (ref :3017-3133)."""
    nilyr = phi.shape[-1]
    perm = permeability(phi)
    phi_min = phi.amin(-1)
    rho_br = density_brine(liquidus_brine_salinity(zTin))
    ice_mass = (phi * rho_br + (1.0 - phi) * RHOI).sum(-1) * hilyr
    perm_harm = nilyr / (1.0 / (perm + 1.0e-30)).sum(-1)
    hocn = (ice_mass + hpond * apond * RHOW + hsn * RHOS) / RHOW
    hbrine = hin + hpond
    dhhead = (hbrine - hocn).clamp(min=0.0)
    w = (perm_harm * RHOW * GRAV * (dhhead / hin.clamp(min=1e-6))) / VISC_DYN
    w = torch.minimum(w, (hpond * apond) / dt)
    wlimit = (0.005 * phi_min * hilyr) / dt
    big = w.abs() > 1.0e-11
    w = torch.where(big, w * (wlimit / torch.where(big, w, 1.0)).abs()
                    .clamp(0.0, 1.0), 0.0)
    return w.clamp(min=0.0)


def solve_salinity(zSin, Sbr, Spond, sss, q, dSdt, w, hilyr, dt):
    """Bulk-salinity update from drainage + flushing advection
    (ref :2690-2766). q[k] = upward Darcy flow at the top of layer k; the
    flux into layer k from below uses Sbr[k+1] (the ocean's for the
    bottom). Returns (zSin_new, fzsal): fzsal = net salt flux to the ocean
    (kg/m2/s, positive into the ocean)."""
    sbr_dn = torch.cat([Sbr[..., 1:], _layer_column(sss, Sbr)], -1)
    sbr_up = torch.cat([_layer_column(Spond, Sbr), Sbr[..., :-1]], -1)
    dS = ((q * (sbr_dn - Sbr)) / hilyr[..., None]
          + dSdt
          + (w[..., None] * (sbr_up - Sbr)) / hilyr[..., None]) * dt
    dS = torch.maximum(S_MIN - zSin, dS)
    zSin_new = zSin + dS
    # salt budget: whatever leaves the ice goes to the ocean
    # (kg salt / m2 / s, 1 ppt = 1 g/kg)
    fzsal = -dS.sum(-1) * hilyr * RHOI * 1.0e-3 / dt
    return zSin_new, fzsal


def drainage_heat_flux(q, w, qbr, qocn, qpond=0.0):
    """Brine advective heat flux divergence per layer (J/m3/s * hilyr;
    ref picard_drainage_fluxes :1545-1581 and picard_flushing_fluxes
    :1585-1606): upward drainage brings brine enthalpy from below,
    downward flushing from above."""
    qbr_dn = torch.cat([qbr[..., 1:], _layer_column(qocn, qbr)], -1)
    qbr_up = torch.cat([torch.full_like(qbr[..., :1], qpond),
                        qbr[..., :-1]], -1)
    return q * (qbr_dn - qbr) + w[..., None] * (qbr_up - qbr)


def mushy_coupled_step(zTin, zSin, Tsf, Tbot, h_i, h_s, hpond, apond,
                       sss, qocn, dt, n_picard: int = 3):
    """Coupled temperature-salinity Picard update for the brine dynamics
    (ref picard_solver :1118-1379, drainage+flushing part): iterates
    {flow velocities from (T, S)} -> {salinity update} -> {temperature
    correction from brine advective heat} holding the conductive state
    fixed (the conduction solve lives in thermo_vertical._solve_heat).

    All inputs batched (...); per-layer (..., nilyr).
    Returns (zTin', zSin', fzsal, fadvheat_total)."""
    nilyr = zSin.shape[-1]
    hilyr = h_i.clamp(min=1.0e-6) / nilyr
    T = zTin
    S = zSin
    fzsal_acc = 0.0
    for _ in range(n_picard):
        q, dSdt, Sbr, qbr, phi = explicit_flow_velocities(
            S, T, Tsf, Tbot, dt, sss, qocn, hilyr, h_i)
        w = flushing_velocity(T, phi, h_i, h_s, hilyr, hpond, apond, dt)
        S_new, fzsal = solve_salinity(S, Sbr, 0.0, sss, q, dSdt, w,
                                      hilyr, dt)
        # heat carried by the brine flows, applied at fixed enthalpy and
        # re-inverted for T at the NEW salinity (q is invariant under the
        # S update; advective heating adds to it)
        dq = drainage_heat_flux(q, w, qbr, qocn) \
            / hilyr[..., None].clamp(min=1e-6) * dt
        T = temperature_mush(enthalpy_mush(T, S) + dq, S_new).clamp(max=0.0)
        S = S_new
        fzsal_acc = fzsal
        # heat budget closure: the column gained sum(dq*hilyr); the
        # matching flux is drawn from the ocean (ref fadvheat)
        fadvheat = -dq.sum(-1) * hilyr / dt
    return T, S, fzsal_acc, fadvheat
