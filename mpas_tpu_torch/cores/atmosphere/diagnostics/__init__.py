"""Atmosphere diagnostics subsystem (port of
mpas_tpu/cores/atmosphere/diagnostics).

ref: src/core_atmosphere/diagnostics/ - a manager
(mpas_atm_diagnostics_manager.F: init/update/compute/reset hooks) driving
isobaric_diagnostics.F, convective_diagnostics.F, pv_diagnostics.F and
soundings.F, each with its own Registry_*.xml and output stream membership.
"""

from mpas_tpu_torch.cores.atmosphere.diagnostics.manager import (
    DiagnosticsManager)
