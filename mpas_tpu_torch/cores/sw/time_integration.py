"""Shallow-water RK4 time integration (port of
mpas_tpu/cores/sw/time_integration.py).

ref: sw_rk4, src/core_sw/mpas_sw_time_integration.F:65-357: one step
advances (u, h, tracers), the tracers in coupled (h * psi) form. A
multi-step run is a Python loop of steps.
"""

from __future__ import annotations

from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.cores.sw.dynamics import (compute_scalar_tend,
                                              compute_tend, solve_diagnostics)
from mpas_tpu_torch.cores.sw.fused import stage_tendencies
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.mesh.mesh import Mesh

# classic RK4 weights (ref: :115-123)
_RK_WEIGHTS = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
_RK_SUBSTEP = (0.5, 0.5, 1.0, 0.0)


def _stage(mesh, cfg, provis, dt, h_s):
    """One RK-stage tendency: the fused stage by default, the generic
    operator path when del4 or monotonic transport is on."""
    if cfg.config_h_mom_eddy_visc4 <= 0.0 and not cfg.config_monotonic:
        return stage_tendencies(mesh, cfg, provis, dt, h_s)
    diag = solve_diagnostics(mesh, cfg, provis, dt, h_s)
    ct_provis = provis.tracers * provis.h[:, None]
    tend_u, tend_h = compute_tend(mesh, cfg, provis, diag, h_s)
    tend_ct = compute_scalar_tend(mesh, cfg, provis, diag, ct_provis)
    return tend_u, tend_h, tend_ct


def rk4_step(mesh: Mesh, cfg: SWConfig, state: SWState, h_s, dt) -> SWState:
    """One RK4 step; tracers advance coupled to h (ref: :72-78)."""
    u0, h0 = state.u, state.h
    ct0 = state.tracers * h0[:, None]

    u_acc, h_acc, ct_acc = u0, h0, ct0
    provis = state
    for stage in range(4):
        tend_u, tend_h, tend_ct = _stage(mesh, cfg, provis, dt, h_s)

        u_acc = u_acc + dt * _RK_WEIGHTS[stage] * tend_u
        h_acc = h_acc + dt * _RK_WEIGHTS[stage] * tend_h
        ct_acc = ct_acc + dt * _RK_WEIGHTS[stage] * tend_ct

        if stage < 3:
            w = dt * _RK_SUBSTEP[stage]
            hp = h0 + w * tend_h
            provis = SWState(u=u0 + w * tend_u, h=hp,
                             tracers=(ct0 + w * tend_ct) / hp[:, None])

    return SWState(u=u_acc, h=h_acc, tracers=ct_acc / h_acc[:, None])


def run_steps(mesh: Mesh, cfg: SWConfig, state: SWState, h_s,
              n_steps: int) -> SWState:
    """Advance n_steps steps of cfg.config_dt."""
    for _ in range(n_steps):
        state = rk4_step(mesh, cfg, state, h_s, cfg.config_dt)
    return state
