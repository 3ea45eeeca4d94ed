"""Sea-ice core configuration (port of mpas_tpu/cores/seaice/config.py:
every field, the same defaults).

ref: src/core_seaice/Registry.xml namelist records (velocity_solver,
advection, column_* options). Defaults mirror the reference registry
defaults where a direct counterpart exists.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SeaiceConfig:
    # time management (ref: Registry.xml config_dt)
    config_dt: float = 3600.0

    # --- velocity solver (ref: Registry.xml velocity_solver record) ---
    config_use_velocity_solver: bool = True
    config_dynamics_subcycle_number: int = 1
    config_elastic_subcycle_number: int = 120
    # "weak" | "variational" (ref: config_stress_divergence_scheme /
    # config_strain_scheme; the variational scheme supports wachspress/pwl
    # basis — here the variational path uses Wachspress basis integrals)
    config_stress_divergence_scheme: str = "weak"
    config_revised_evp: bool = False
    config_use_ocean_stress: bool = True
    config_use_air_stress: bool = True
    config_use_surface_tilt: bool = True
    config_use_coriolis: bool = False  # square test case default
    config_ocean_heat_flux: float = 2.0        # W/m2 into ice bottom

    # --- advection (ref: config_advection_type upwind|incremental_remap) ---
    config_advection_type: str = "upwind"

    # --- column physics ---
    config_use_column_physics: bool = True
    config_n_categories: int = 5
    # thermodynamics closure: "zero_layer" (Semtner) | "bl99" | "mushy"
    # (ref: Registry.xml config_heat_conduction / ice_therm_{bl99,mushy})
    config_thermo_type: str = "zero_layer"
    config_n_ice_layers: int = 7
    config_n_snow_layers: int = 1
    # shortwave scheme: "ccsm3" (band albedos) | "dedd" (delta-Eddington)
    # (ref: Registry.xml config_shortwave_type, ice_shortwave.F90)
    config_shortwave_type: str = "ccsm3"
    # WMO-ish category bounds used by CICE ITD (m)
    config_itd_bounds: tuple = (0.0, 0.64, 1.39, 2.47, 4.57, 1.0e8)
    # ITD thickness-space transport: "rebin" (one-shot conservative rebin)
    # or "linear" (Lipscomb 2001 linear remapping, ref ice_itd.F90)
    config_itd_remap_type: str = "rebin"
    # melt ponds: "off" | "cesm" | "lvl" | "topo"
    # (ref ice_meltpond_{cesm,lvl,topo}.F90)
    config_pond_scheme: str = "off"
    # tracer packages (ref ice_age/ice_firstyear/ice_brine/ice_algae.F90)
    config_use_ice_age: bool = False
    config_use_first_year_ice: bool = False
    config_use_brine: bool = False
    # prognostic vertical salinity (ref: config_use_zsalinity +
    # ice_zsalinity.F90; gravity drainage per ice_therm_mushy.F90)
    config_use_zsalinity: bool = False
    config_use_algae: bool = False
    config_use_snow_metamorphism: bool = False
    # mixed-layer nutrient boundary conditions for the algae package
    config_ocean_nitrate: float = 5.0    # mmol/m3
    config_ocean_silicate: float = 10.0

    # constants (ref: src/core_seaice/shared/mpas_seaice_constants.F)
    rho_ice: float = 917.0
    rho_snow: float = 330.0
    rho_air: float = 1.3
    rho_seawater: float = 1026.0
    air_drag: float = 0.0012        # seaiceAirDragCoefficient (quadratic)
    ocean_drag: float = 0.00536     # seaiceIceOceanDragCoefficient
    air_turning_angle: float = 0.0  # radians
    ocean_turning_angle: float = 0.0
    ice_strength_pstar: float = 2.75e4   # P* (Hibler 1979)
    ice_strength_cstar: float = 20.0     # C*
    puny: float = 1.0e-11
    latent_heat_fusion: float = 3.34e5   # J/kg
    ice_conductivity: float = 2.03       # W/m/K
    snow_conductivity: float = 0.30
    stefan_boltzmann: float = 5.67e-8
    emissivity: float = 0.985
    freezing_point: float = -1.8         # deg C (seawater)
