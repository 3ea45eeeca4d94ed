"""Land-ice enthalpy thermodynamics, the polythermal column solver (port
of mpas_tpu/cores/landice/thermal_enthalpy.py).

ref capability: src/core_landice/mode_forward/mpas_li_thermal.F
(3,316 LoC; `config_thermal_solver = 'enthalpy'` branch, Aschwanden et
al. 2012 genre): prognostic specific enthalpy E = c_i (T - T0) + w L per
layer handles cold and temperate ice in one conserved variable —
temperate ice carries liquid water fraction w where E exceeds the
pressure-melting enthalpy E_pmp(z); diffusion uses the cold-ice
conductivity below E_pmp and a small moisture diffusivity above it;
sources are strain (dissipation) heating, geothermal flux, and basal
friction; excess water above the drainage threshold becomes basal melt.

A batched implicit tridiagonal over the sigma layers with two Picard
passes for the E-dependent diffusivity switch; pure column math.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.cores.landice.core import add_col, flow_param_a
from mpas_tpu_torch.ops.matrix import tridiagonal_solve
from mpas_tpu_torch.ops.remap import cell_gradient

_T0 = 273.15
C_ICE = 2009.0          # J/kg/K (ref li constants)
L_FUS = 3.35e5          # J/kg
K_COLD = 2.1            # W/m/K
# temperate-ice enthalpy diffusivity = cold diffusivity / 100
# (ref enthalpy_matrix_elements, mpas_li_thermal.F:2416-2417)
KAPPA_TEMPERATE_RATIO = 0.01
BETA_CC = 9.8e-8        # Clausius-Clapeyron K/Pa
W_MAX = 0.01            # drainage threshold liquid fraction


def pmp_temperature(cfg, thickness, sigma_mid):
    """Pressure-melting temperature at layer midpoints.
    ref: li_thermal pressure melting point (T_pmp = T0 - beta rho g d)."""
    depth = thickness[:, None] * sigma_mid[None, :]
    return _T0 - BETA_CC * cfg.rho_ice * cfg.gravity * depth


def enthalpy_from_tw(T, w):
    return C_ICE * (T - _T0) + w * L_FUS


def tw_from_enthalpy(cfg, E, thickness, sigma_mid):
    """Invert E -> (T, w) against the pressure-melting enthalpy."""
    t_pmp = pmp_temperature(cfg, thickness, sigma_mid)
    e_pmp = C_ICE * (t_pmp - _T0)
    T = torch.where(E < e_pmp, _T0 + E / C_ICE, t_pmp)
    w = (E - e_pmp).clamp(min=0.0) / L_FUS
    return T, w


def _sigma_mid(grid):
    return 0.5 * (grid.layerInterfaceSigma[:-1]
                  + grid.layerInterfaceSigma[1:])


def strain_heating(grid, cfg, thickness, temperature):
    """SIA dissipation Phi = 2 A tau^(n+1) per layer (W/m3).
    tau(z) = rho g (s - z) |grad s|; slope magnitude from the limited
    cell gradient of the surface. ref: li_thermal dissipation source."""
    m = grid.mesh
    surface = grid.bedTopography + thickness
    gx, gy = cell_gradient(m, surface, m.xCell, m.yCell)
    slope = torch.sqrt(gx ** 2 + gy ** 2)
    tau = (cfg.rho_ice * cfg.gravity * thickness[:, None]
           * _sigma_mid(grid)[None, :] * slope[:, None])
    a_flow = flow_param_a(cfg, temperature)
    n = cfg.config_flowlaw_exponent
    return 2.0 * a_flow * tau ** (n + 1.0)


def thermal_solve_enthalpy(grid, cfg, thickness, temperature, waterFrac,
                           dt, basal_friction_flux=None):
    """One implicit enthalpy step for all columns.

    Returns (temperature, waterFrac, basal_melt_rate [m/s of ice]).
    ref: li_thermal_solver enthalpy branch call sequence: build E,
    diffuse with mode-dependent conductivity, apply sources, drain."""
    sig_mid = _sigma_mid(grid)
    h = thickness.clamp(min=10.0)[:, None]
    dz = h * grid.layerSigmaFraction[None, :]
    rho = cfg.rho_ice

    if waterFrac is None:
        waterFrac = torch.zeros_like(temperature)
    E = enthalpy_from_tw(temperature, waterFrac)
    phi = strain_heating(grid, cfg, thickness, temperature)  # W/m3

    geo = cfg.config_geothermal_flux
    fric = (basal_friction_flux if basal_friction_flux is not None
            else torch.zeros_like(thickness))

    t_pmp = pmp_temperature(cfg, thickness, sig_mid)
    e_pmp = C_ICE * (t_pmp - _T0)

    for _ in range(2):    # Picard passes over the cold/temperate switch
        temperate = E >= e_pmp
        # diffusivity in enthalpy space: cold k/(rho c); temperate is
        # cold/100 (ref mpas_li_thermal.F:2416-2417)
        kappa_cold = K_COLD / (rho * C_ICE)
        kappa = torch.where(temperate,
                            torch.full_like(E, KAPPA_TEMPERATE_RATIO
                                            * kappa_cold),
                            torch.full_like(E, kappa_cold))   # m2/s
        k_int = 2.0 * kappa[:, :-1] * kappa[:, 1:] / (
            kappa[:, :-1] + kappa[:, 1:]).clamp(min=1e-20)
        g_int = k_int / (0.5 * (dz[:, :-1] + dz[:, 1:]))
        g_surf = kappa[:, 0] / (0.5 * dz[:, 0])

        alpha = dt / dz
        zero = torch.zeros_like(g_surf)[:, None]
        a = torch.cat([zero, -alpha[:, 1:] * g_int], dim=1)
        c = torch.cat([-alpha[:, :-1] * g_int, zero], dim=1)
        b = 1.0 - a - c
        b = add_col(b, 0, alpha[:, 0] * g_surf)
        e_surf = C_ICE * (cfg.config_surface_air_temperature - _T0)
        d = E + dt * phi / rho
        d = add_col(d, 0, alpha[:, 0] * g_surf * e_surf)
        # basal flux (geothermal + friction) enters the bottom layer
        d = add_col(d, -1, dt * (geo + fric) / (rho * dz[:, -1]))
        E = tridiagonal_solve(a, b, c, d)

    # drainage: water above W_MAX leaves the column as basal melt
    excess = (E - (e_pmp + W_MAX * L_FUS)).clamp(min=0.0)
    E = torch.minimum(E, e_pmp + W_MAX * L_FUS)
    basal_melt = (excess / L_FUS * dz).sum(1) / dt           # m ice / s

    T, w = tw_from_enthalpy(cfg, E, thickness, sig_mid)
    active = thickness[:, None] > 1.0
    T = torch.where(active, T, temperature)
    w = torch.where(active, w, torch.zeros_like(w))
    return T, w, torch.where(thickness > 1.0, basal_melt,
                             torch.zeros_like(basal_melt))


def basal_energy_balance(cfg, thickness, temperature, waterFrac,
                         basal_friction_flux, basal_water_thickness,
                         dt):
    """Grounded basal energy balance -> basal mass balance (m ice/s,
    negative = melt), basal temperature, and the conductive flux
    (ref: basal_melt_grounded_ice, mpas_li_thermal.F:2632-2881).

    net = friction + geothermal + conductive(into bed);
    mass balance = -net / (L rho - q_bottom); a melting bed with no
    stored water is nudged just below the pressure-melting point, and a
    cold bed cannot melt."""
    nz = temperature.shape[-1]
    h = thickness.clamp(min=10.0)
    dz_bot = h * (1.0 / nz)
    t_pmp_bed = _T0 - BETA_CC * cfg.rho_ice * cfg.gravity * h
    t_bot = temperature[:, -1]
    # conductive flux from the bed into the ice interior (positive up);
    # into-bed flux is its negative
    flux_up = K_COLD * (t_pmp_bed - t_bot) / (0.5 * dz_bot)
    conductive_down = -flux_up
    net = basal_friction_flux + cfg.config_geothermal_flux \
        + conductive_down
    # bmb = -net / (L rho_i - q_bottom)  [ref :2765, q in J/m3]
    q_bot = cfg.rho_ice * enthalpy_from_tw(t_bot, waterFrac[:, -1])
    denom = (L_FUS * cfg.rho_ice - q_bot).clamp(min=1.0e6)
    bmb = -net / denom                                # m ice / s
    zero = torch.zeros_like(bmb)
    bmb = torch.where(thickness > 1.0, bmb, zero)
    # a cold bed cannot melt; freeze-on requires basal water
    cold = t_bot < t_pmp_bed - 1.0e-3
    bmb = torch.where(cold & (bmb < 0.0), zero, bmb)
    bmb = torch.where((bmb > 0.0) & (basal_water_thickness <= 0.0), zero,
                      bmb)
    basal_temperature = torch.minimum(t_bot, t_pmp_bed)
    return bmb, basal_temperature, conductive_down


def basal_melt_floating(cfg, thickness, bed_topography, ocean_temperature,
                        gamma_t: float = 1.0e-4):
    """Ocean-driven melt under floating ice, thermal-forcing form
    (ref: li_basal_melt_floating_ice, mpas_li_thermal.F:1403-1584,
    'temperature_forcing' genre): melt = gamma_T c_w rho_w / (rho_i L)
    * (T_ocn - T_freeze(draft)), with the pressure/salinity freezing
    point at the ice draft. Returns m ice/s (positive = melt)."""
    rho_w, c_w = 1028.0, 3974.0
    # floating: draft = -rho_i/rho_w * H
    draft = -cfg.rho_ice / rho_w * thickness
    t_freeze = _T0 - 1.85 - 7.61e-4 * (-draft)     # C->K offsets inline
    forcing = (ocean_temperature - t_freeze).clamp(min=0.0)
    melt = gamma_t * c_w * rho_w / (cfg.rho_ice * L_FUS) * forcing
    floating = bed_topography < -cfg.rho_ice / rho_w * thickness
    return torch.where(floating & (thickness > 1.0), melt,
                       torch.zeros_like(melt))
