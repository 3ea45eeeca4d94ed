# Frozen copy of mpas_tpu_torch/cores/atmosphere/state.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Atmosphere prognostic state + coupled diagnostics (port of
mpas_tpu/cores/atmosphere/state.py). Levels minor; w/rw live on the nz+1
interfaces (ref: src/core_atmosphere/Registry.xml:470; the coupled
diagnostics of atm_init_coupled_diagnostics,
mpas_atm_time_integration.F:5825)."""

from __future__ import annotations

import dataclasses
from typing import Any

from benchmark.reference.containers import to_device


@dataclasses.dataclass(frozen=True)
class AtmState:
    u: Any          # (nEdges, nz) normal velocity
    w: Any          # (nCells, nz+1) vertical velocity at interfaces
    theta_m: Any    # (nCells, nz) moist potential temperature
    rho_zz: Any     # (nCells, nz) dry density / d(zeta)/dz
    scalars: Any    # (nCells, nz, nScalars) mixing ratios

    def to(self, device, dtype) -> "AtmState":
        return to_device(self, device, dtype)


@dataclasses.dataclass(frozen=True)
class AtmDiag:
    ru: Any         # (nEdges, nz) rho_edge * u
    rw: Any         # (nCells, nz+1) rho * omega
    rho_p: Any      # (nCells, nz) perturbation rho_zz
    rtheta_p: Any   # (nCells, nz) perturbation rho*theta_m
    exner: Any      # (nCells, nz)
    pressure_p: Any  # (nCells, nz) perturbation pressure
    ruAvg: Any      # (nEdges, nz) time-averaged ru for scalar transport
    wwAvg: Any      # (nCells, nz+1) time-averaged rho*omega

    def to(self, device, dtype) -> "AtmDiag":
        return to_device(self, device, dtype)
