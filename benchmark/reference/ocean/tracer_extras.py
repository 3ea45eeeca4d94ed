# Frozen copy of mpas_tpu_torch/cores/ocean/tracer_extras.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Auxiliary ocean tracer groups: ideal age, exponential decay, frazil
(port of mpas_tpu/cores/ocean/tracer_extras.py).

ref capabilities:
  * mpas_ocn_tracer_ideal_age.F: ageing source of +dt per step in the
    interior, reset to zero in the surface layer;
  * mpas_ocn_tracer_exponential_decay.F: first-order decay of a tracer
    with a prescribed e-folding time;
  * mpas_ocn_frazil_forcing.F: where the water is below the
    salinity-dependent freezing point, the heat deficit becomes frazil
    ice and the water is warmed back to freezing.

All are column-local elementwise updates, applied operator-split after
the dynamics step. Each returns new tensors; none writes its input.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# linear freezing point (ref: ocn_freezing_temperature coefficients)
FREEZE_DTDS = -0.0573        # degC / psu
FREEZE_T0 = 0.0832           # degC
LATENT_FUSION = 3.337e5      # J/kg
RHO_ICE = 918.0
CP_SW = 3996.0


def freezing_temperature(S):
    """ref: ocn_freezing_temperature (linear in salinity)."""
    return FREEZE_T0 + FREEZE_DTDS * S


def ideal_age_step(tracers, age_index: int, dt):
    """Advance the ideal-age tracer: +dt everywhere, zero at the surface.
    ref: ocn_tracer_ideal_age_compute."""
    tr = tracers.clone()
    tr[..., age_index] += dt
    tr[:, 0, age_index] = 0.0
    return tr


def exponential_decay_step(tracers, index: int, dt, efolding_s: float):
    """First-order decay with e-folding time (ref:
    ocn_tracer_exponential_decay_compute)."""
    lam = 1.0 / efolding_s
    tr = tracers.clone()
    tr[..., index] *= math.exp(-lam * float(dt))
    return tr


def frazil_adjustment(cfg, state, dt):
    """Frazil ice formation: restore sub-freezing water to the freezing
    point; the removed heat deficit becomes frazil ice volume.

    Returns (new_state, frazil ice volume (nCells,), m of ice produced this
    step per unit area), the coupling flux the sea-ice core consumes.
    ref capability: mpas_ocn_frazil_forcing.F."""
    T = state.tracers[..., 0]
    S = state.tracers[..., 1]
    h = state.layerThickness
    t_freeze = freezing_temperature(S)
    deficit = torch.clamp(t_freeze - T, min=0.0)      # K below freezing
    # energy to warm back to freezing, per layer (J/m2)
    energy = cfg.config_density0 * CP_SW * deficit * h
    dv_ice = energy / (RHO_ICE * LATENT_FUSION)       # m of new ice
    T_new = torch.where(deficit > 0.0, t_freeze, T)
    # brine rejection: the salt of the frozen freshwater stays in the layer
    dS = S * dv_ice * (RHO_ICE / cfg.config_density0) \
        / torch.clamp(h, min=1e-3)
    tr = state.tracers.clone()
    tr[..., 0] = T_new
    tr[..., 1] += dS
    frazil_total = dv_ice.sum(-1)
    return dataclasses.replace(state, tracers=tr), frazil_total
