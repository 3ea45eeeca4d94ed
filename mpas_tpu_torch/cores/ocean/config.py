"""Ocean forward-model configuration (port of the OcnConfig of
mpas_tpu/cores/ocean/core.py).

Every field and default of the reference, so that a configuration carries
across 1:1 (ref: src/core_ocean/Registry.xml namelist, subset).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OcnConfig:
    config_dt: float = 300.0
    # debug/validation mode: the run loop sweeps the state for non-finite
    # values after every chunk (ref: MPAS_DEBUG, SURVEY §5.2)
    config_debug_checks: bool = False

    config_time_integrator: str = "split_explicit"   # or "RK4"
    # equation of state: "linear" | "jm" (ref: config_eos_type)
    config_eos_type: str = "linear"
    config_eos_linear_alpha: float = 0.2
    config_eos_linear_beta: float = 0.8
    config_eos_linear_Tref: float = 5.0
    config_eos_linear_Sref: float = 35.0
    config_eos_linear_densityref: float = 1000.0
    config_density0: float = 1026.0
    config_mom_del2: float = 10.0
    config_tracer_del2: float = 10.0
    # vertical mixing (ref: config_vert_mix_scheme and the coefficient
    # namelists of mpas_ocn_vmix_coefs_{const,rich,tanh}.F / cvmix)
    config_vert_mix_scheme: str = "const"   # const|rich|tanh|cvmix|kpp
    config_vert_visc: float = 1.0e-4
    config_vert_diff: float = 1.0e-5
    config_bkrd_vert_visc: float = 1.0e-4
    config_bkrd_vert_diff: float = 1.0e-5
    config_rich_mix: float = 5.0e-3
    config_convective_visc: float = 1.0
    config_convective_diff: float = 1.0
    config_max_visc_tanh: float = 2.5e-1
    config_min_visc_tanh: float = 1.0e-4
    config_max_diff_tanh: float = 2.5e-2
    config_min_diff_tanh: float = 1.0e-5
    config_tanh_zmid: float = -100.0
    config_tanh_zwidth: float = 100.0
    # CVMix interior schemes (ref: mpas_ocn_vmix_cvmix.F namelists
    # config_use_cvmix_shear / _tidal_mixing / _double_diffusion)
    config_use_cvmix_convection: bool = True
    config_use_cvmix_shear: bool = False
    config_cvmix_shear_mixing_scheme: str = "KPP"   # LMD94 | "PP"
    config_cvmix_shear_kpp_nu_zero: float = 5.0e-3
    config_cvmix_shear_kpp_Ri_zero: float = 0.7
    config_cvmix_shear_kpp_exp: float = 3.0
    config_cvmix_shear_pp_nu_zero: float = 5.0e-3
    config_use_cvmix_tidal_mixing: bool = False
    config_cvmix_tidal_mixing_q: float = 0.33
    config_cvmix_tidal_efficiency: float = 0.2
    config_cvmix_tidal_vertical_decay_scale: float = 500.0
    config_cvmix_tidal_energy_flux: float = 1.0e-3   # W/m2 column default
    config_cvmix_tidal_max: float = 0.05
    config_use_cvmix_double_diffusion: bool = False
    # GM / Redi mesoscale eddy parameterization (ref: mpas_ocn_gm.F +
    # tracer_hmix_Redi namelists)
    config_use_gm: bool = False
    config_gm_constant_kappa: float = 900.0     # m2/s
    config_use_redi: bool = False
    config_redi_kappa: float = 400.0            # m2/s
    config_max_relative_slope: float = 0.01
    config_bottom_drag_coeff: float = 1.0e-3
    config_apvm_upwinding: float = 0.0   # ref: config_apvm_scale_factor = 0
    config_rayleigh_friction: float = 0.0
    # auxiliary tracer groups (ref: mpas_ocn_tracer_ideal_age.F,
    # mpas_ocn_tracer_exponential_decay.F, mpas_ocn_frazil_forcing.F)
    config_use_ideal_age: bool = False
    config_ideal_age_index: int = 2
    config_use_exponential_decay: bool = False
    config_exp_decay_index: int = 2
    config_exp_decay_efolding: float = 30.0 * 86400.0
    config_use_frazil: bool = False
    # split-explicit barotropic mode (ref: Registry.xml:947-991)
    config_n_ts_iter: int = 2
    config_n_bcl_iter_beg: int = 1
    config_n_bcl_iter_mid: int = 2
    config_n_bcl_iter_end: int = 2
    config_btr_dt: float = 15.0          # ref: '0000_00:00:15'
    config_btr_subcycle_loop_factor: int = 2
    config_n_btr_cor_iter: int = 2
    config_btr_gam1_velWt1: float = 0.5
    config_btr_gam2_SSHWt1: float = 1.0
    config_btr_gam3_velWt2: float = 1.0
    config_vel_correction: bool = True
    # z-tilde ALE (ref: mpas_ocn_thick_ale.F + the freq-filtered thickness
    # prognostics of mpas_ocn_tendency.F:908)
    config_use_freq_filtered_thickness: bool = False
    config_thickness_filter_timescale: float = 5.0    # days
    config_use_highFreqThick_restore: bool = True
    config_highFreqThick_restore_time: float = 30.0   # days
    config_highFreqThick_del2: float = 0.0
    config_use_min_max_thickness: bool = False
    config_max_thickness_factor: float = 6.0
    config_min_thickness: float = 1.0
    config_calendar_type: str = "gregorian_noleap"
    config_start_time: str = "0000-01-01_00:00:00"
    config_run_duration: str = "none"
    config_stop_time: str = "none"
    config_do_restart: bool = False
