"""The coupled physics-dynamics loop of the atmosphere core (port of
run_steps_with_physics in mpas_tpu/cores/atmosphere/hooks.py; ref:
atm_do_timestep, mpas_atm_core.F:830-873: the physics suite runs before the
dynamics at every step).

The run driver's other hooks (setup, output fields, restart) wait for the
framework driver.
"""

from __future__ import annotations

import dataclasses

from mpas_tpu_torch.cores.atmosphere import time_integration
from mpas_tpu_torch.cores.atmosphere.physics import manager


def run_steps_with_physics(grid, cfg, carry, phys, recon, dt, n, pcfg=None,
                           gmt_hours=12.0):
    """Advance `n` timesteps, each physics_step then srk3_step. pcfg: the
    PhysicsConfig; None runs PhysicsConfig() as the reference's hook does
    (Kain-Fritsch, YSU, the MM5 surface layer, the slab LSM and broadband
    radiation; pass resolve_suite(...) of a suite to run that suite, and
    give phys the Noah soil or the MYNN qke the suite needs); recon: the
    reconstruction coefficients as a tensor on the carry's device;
    gmt_hours: the hour of the solar geometry physics_step sees (the
    reference's default is noon; the day is physics_step's default).
    Returns (carry, phys)."""
    pcfg = manager.PhysicsConfig() if pcfg is None else pcfg
    for _ in range(n):
        th, sc, u, phys = manager.physics_step(
            grid, pcfg, grid.mesh, recon, carry.state, carry.diag, phys, dt,
            gmt_hours=gmt_hours)
        carry = dataclasses.replace(carry, state=dataclasses.replace(
            carry.state, theta_m=th, scalars=sc, u=u))
        carry = time_integration.srk3_step(grid, cfg, carry, dt)
    return carry, phys
