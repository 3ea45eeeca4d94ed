"""Land-ice core configuration (port of mpas_tpu/cores/landice/config.py).

ref: src/core_landice/Registry.xml namelist records (velocity_solver,
thermal_solver, calving, physical_parameters). SI units throughout
(seconds, meters, Pa), like the reference.
"""

from __future__ import annotations

import dataclasses

SECONDS_PER_YEAR = 3600.0 * 24.0 * 365.0


@dataclasses.dataclass(frozen=True)
class LiConfig:
    config_dt: float = 0.05 * SECONDS_PER_YEAR

    # velocity (ref: config_velocity_solver 'sia'|'simple'|'FO' external)
    config_velocity_solver: str = "sia"
    # FO (Blatter-Pattyn) solver controls (ref: the Albany/FELIX solve
    # behind Interface_velocity_solver.cpp; fo_stokes.py here)
    config_fo_basal_friction: float = 1.0e12    # Pa s/m (~no-slip)
    config_fo_picard_iters: int = 10
    config_fo_cg_iters: int = 120
    config_nvertlevels: int = 5
    # Glen flow-law exponent (ref: li_constants n=3)
    config_flowlaw_exponent: float = 3.0
    # default flow parameter A when not computed from temperature
    # (ref: config_default_flowParamA, Pa^-3 s^-1)
    config_default_flowParamA: float = 3.1709792e-24
    config_flowParamA_calculation: str = "constant"  # or "PB1982"

    # thermal solver (ref: config_thermal_solver
    # 'none'|'temperature'|'enthalpy')
    config_thermal_solver: str = "temperature"
    # thickness advection (ref: config_thickness_advection
    # 'fo'|'centered'|'incremental_remapping')
    config_thickness_advection: str = "centered"
    config_surface_air_temperature: float = 268.15   # K
    config_geothermal_flux: float = 0.042            # W/m2 upward

    # calving (ref: config_calving 'none'|'floating'|
    # 'thickness_threshold'|'topographic_threshold'|'eigencalving',
    # mpas_li_calving.F:198-276)
    config_calving: str = "none"
    config_calving_thickness: float = 100.0          # m
    config_calving_topography: float = -500.0        # m bed threshold
    # eigencalving parameter K (m s; ref
    # config_calving_eigencalving_parameter_scalar_value)
    config_calving_eigencalving_k: float = 1.0e17

    # physical constants (ref: src/core_landice/shared li_constants)
    rho_ice: float = 910.0
    rho_seawater: float = 1028.0
    gravity: float = 9.80616
    ice_specific_heat: float = 2009.0        # J/kg/K
    ice_conductivity: float = 2.1            # W/m/K
    # Paterson-Budd (1982) Arrhenius parameters
    pb_a0_cold: float = 1.14e-5              # Pa^-3 yr^-1 (T* < 263.15)
    pb_q_cold: float = 60.0e3                # J/mol
    pb_a0_warm: float = 5.47e10
    pb_q_warm: float = 139.0e3
    gas_constant: float = 8.314
