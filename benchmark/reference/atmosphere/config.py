# Frozen copy of mpas_tpu_torch/cores/atmosphere/config.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Nonhydrostatic atmosphere core configuration.

Names/defaults mirror the reference namelist (ref: src/core_atmosphere/
Registry.xml:62-259). BASELINE runs use the split RK3 configuration
(config_time_integration_order=3, dynamics_split_steps=3, 2 acoustic
sub-steps; ref: Registry.xml:92-102 and SURVEY.md §6).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AtmConfig:
    config_dt: float = 720.0
    # debug/validation mode: the run loop sweeps the state for
    # non-finite values after every chunk (ref: MPAS_DEBUG,
    # SURVEY §5.2)
    config_debug_checks: bool = False

    config_time_integration_order: int = 3
    config_split_dynamics_transport: bool = True
    config_number_of_sub_steps: int = 2
    config_dynamics_split_steps: int = 3
    config_h_mom_eddy_visc2: float = 0.0
    config_h_mom_eddy_visc4: float = 0.0
    config_v_mom_eddy_visc2: float = 0.0
    config_h_theta_eddy_visc2: float = 0.0
    config_h_theta_eddy_visc4: float = 0.0
    config_v_theta_eddy_visc2: float = 0.0
    config_horiz_mixing: str = "2d_smagorinsky"
    config_len_disp: float = 120000.0
    config_visc4_2dsmag: float = 0.05
    config_del4u_div_factor: float = 10.0
    config_theta_adv_order: int = 3
    config_scalar_advection: bool = True
    config_positive_definite: bool = False
    config_monotonic: bool = True
    config_coef_3rd_order: float = 0.25
    config_smagorinsky_coef: float = 0.125
    config_mix_full: bool = True
    config_epssm: float = 0.1
    config_smdiv: float = 0.1
    config_apvm_upwinding: float = 0.5
    config_zd: float = 22000.0
    config_xnutr: float = 0.2
    config_mpas_cam_coef: float = 0.0
    config_rayleigh_damp_u: bool = False
    config_rayleigh_damp_u_timescale_days: float = 5.0
    config_number_rayleigh_damp_u_levels: int = 6
    config_h_ScaleWithMesh: bool = False
    # w-curvature term ordering (see nhyd.compute_dyn_tend): "physical"
    # applies the spherical curvature/Coriolis pair to tend_w at full size
    # AFTER the invAreaCell scaling of the horizontal flux divergence;
    # "reference" reproduces the reference ordering, which accumulates the
    # terms BEFORE the scaling (ref mpas_atm_time_integration.F:5076-5086
    # then :5185) so they are divided by cell area (~1e9 m^2) and
    # effectively vanish. Use "reference" for bitwise parity runs.
    config_w_curvature: str = "physical"
    # physics suite (ref: Registry.xml config_microp_scheme; "off" runs the
    # dry/moist dynamics without microphysics)
    config_microp_scheme: str = "off"
    # column-physics suite run before dynamics each step (ref:
    # config_physics_suite + the scheme calls of the reference physics);
    # "none" | "mesoscale_reference"
    config_physics_suite: str = "none"
    # idealized init case (ref: core_init_atmosphere Registry.xml
    # config_init_case; 1-3 = JW baroclinic wave, 4 = squall line,
    # 5 = supercell)
    config_init_case: int = 2
    config_nvertlevels: int = 26
    config_ztop: float = 30000.0
    config_calendar_type: str = "gregorian_noleap"
    config_start_time: str = "0000-01-01_00:00:00"
    config_run_duration: str = "none"
    config_stop_time: str = "none"
    config_do_restart: bool = False
