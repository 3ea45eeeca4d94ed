"""Shallow-water core configuration (port of mpas_tpu/cores/sw/config.py).

Names and defaults mirror the reference namelist (ref: src/core_sw/
Registry.xml:17-45).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SWConfig:
    config_test_case: int = 5
    # debug/validation mode: a driver sweeps the state for non-finite
    # values after every chunk (ref: MPAS_DEBUG, SURVEY §5.2)
    config_debug_checks: bool = False

    config_time_integration: str = "RK4"
    config_dt: float = 172.8
    config_stats_interval: int = 100
    config_h_ScaleWithMesh: bool = False
    config_h_mom_eddy_visc2: float = 0.0
    config_h_mom_eddy_visc4: float = 0.0
    config_h_tracer_eddy_diff2: float = 0.0
    config_h_tracer_eddy_diff4: float = 0.0
    config_thickness_adv_order: int = 2
    config_tracer_adv_order: int = 2
    config_positive_definite: bool = False
    config_monotonic: bool = False
    config_wind_stress: bool = False
    config_bottom_drag: bool = False
    config_apvm_upwinding: float = 0.5
    config_num_halos: int = 2
    config_do_restart: bool = False
    config_calendar_type: str = "gregorian_noleap"
    config_start_time: str = "0000-01-01_00:00:00"
    config_run_duration: str = "none"
    config_stop_time: str = "none"
