"""Split-explicit RK3 time stepping of the dry nonhydrostatic core
(port of mpas_tpu/cores/atmosphere/time_integration.py).

ref: atm_srk3, src/core_atmosphere/dynamics/mpas_atm_time_integration.F:142.
The dynamics substeps, RK stages and acoustic substeps are plain Python
loops; each tensor operation runs eagerly on the tensors' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mpas_tpu_torch.containers import to_device
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.nhyd import (AcousticVars, AtmSolveDiag,
                                                  acoustic_hoist,
                                                  acoustic_step,
                                                  compute_dyn_tend,
                                                  divergence_damping_3d,
                                                  reconstruct_cell_winds,
                                                  recover_large_step_variables,
                                                  set_smlstep_pert_variables,
                                                  solve_diagnostics,
                                                  vert_imp_coefs)
from mpas_tpu_torch.cores.atmosphere.setup import AtmGrid
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.cores.atmosphere.transport import (advance_scalars,
                                                       advance_scalars_mono)


@dataclasses.dataclass(frozen=True)
class AtmCarry:
    """Everything advanced from step to step (dry path)."""
    state: AtmState
    diag: AtmDiag
    v: Any          # tangential velocity (recomputed on rk_step 3)
    sdiag_ke: Any
    sdiag_div: Any
    sdiag_vort: Any
    sdiag_pv_edge: Any
    sdiag_rho_edge: Any
    ur_cell: Any
    vr_cell: Any

    def to(self, device, dtype) -> "AtmCarry":
        return to_device(self, device, dtype)


def init_carry(grid: AtmGrid, cfg: AtmConfig, state: AtmState,
               diag: AtmDiag, dt) -> AtmCarry:
    """Initial diagnostics (ref: atm_mpas_init_block calls
    atm_compute_solve_diagnostics + mpas_reconstruct)."""
    sd = solve_diagnostics(grid, cfg, state.u, state.rho_zz, dt,
                           reconstruct_v=True)
    ur, vr = reconstruct_cell_winds(grid, state.u)
    return AtmCarry(state=state, diag=diag, v=sd.v, sdiag_ke=sd.ke,
                    sdiag_div=sd.divergence, sdiag_vort=sd.vorticity,
                    sdiag_pv_edge=sd.pv_edge, sdiag_rho_edge=sd.rho_edge,
                    ur_cell=ur, vr_cell=vr)


def _check_supported(cfg: AtmConfig, state: AtmState, xch):
    if cfg.config_microp_scheme != "off":
        raise NotImplementedError(
            f"config_microp_scheme={cfg.config_microp_scheme!r}: only the "
            "dry path ('off') is ported")
    if state.scalars.shape[-1] >= 3:
        raise NotImplementedError(
            "a moist state (3 or more scalars) is not ported; the dry path "
            "carries passive scalars only")
    if xch is not None:
        raise NotImplementedError("exchange hooks (the distributed runner) "
                                  "are not ported")


def srk3_step(grid: AtmGrid, cfg: AtmConfig, carry: AtmCarry, dt,
              xch=None) -> AtmCarry:
    """One full dry timestep (ref: atm_srk3 :142-1796)."""
    state1 = carry.state
    diag = carry.diag
    _check_supported(cfg, state1, xch)

    order = cfg.config_time_integration_order
    ns = cfg.config_number_of_sub_steps
    split = cfg.config_dynamics_split_steps \
        if cfg.config_split_dynamics_transport else 1
    dt_dyn = dt / split
    if order == 3:
        rk_timestep = (dt_dyn / 3.0, dt_dyn / 2.0, dt_dyn)
        rk_sub = (dt_dyn / 3.0, dt_dyn / ns, dt_dyn / ns)
        nsub = (1, max(1, ns // 2), ns)
    else:
        rk_timestep = (dt_dyn / 2.0, dt_dyn / 2.0, dt_dyn)
        rk_sub = (dt_dyn / ns,) * 3
        nsub = (max(1, ns // 2), max(1, ns // 2), ns)

    # working (time level 2) state and sub-step saves
    u2, w2 = state1.u, state1.w
    th2, rho2 = state1.theta_m, state1.rho_zz
    th1 = th2
    ru, rw = diag.ru, diag.rw
    rho_p, rtheta_p = diag.rho_p, diag.rtheta_p
    exner, pressure_p = diag.exner, diag.pressure_p
    sd = AtmSolveDiag(rho_edge=carry.sdiag_rho_edge, ke=carry.sdiag_ke,
                      divergence=carry.sdiag_div, vorticity=carry.sdiag_vort,
                      pv_edge=carry.sdiag_pv_edge, v=carry.v)
    ur_cell, vr_cell = carry.ur_cell, carry.vr_cell
    rho_zz_old_split = state1.rho_zz
    ruAvg_split = wwAvg_split = None

    for sub in range(split):
        # start-of-substep saves (ref: atm_rk_integration_setup :1799)
        ru_save, rw_save = ru, rw
        rtheta_p_save, rho_p_save = rtheta_p, rho_p
        th_save = th1

        coefs = vert_imp_coefs(grid, cfg, rk_sub[0], th2, exner, rtheta_p)
        hoist = acoustic_hoist(grid, th_save, exner)
        euler = None
        for rk in (1, 2, 3):
            if order == 3 and rk == 2:
                coefs = vert_imp_coefs(grid, cfg, rk_sub[1], th2, exner,
                                       rtheta_p)
            (tend_u, tend_rho, tend_theta, tend_w_raw, _,
             euler) = compute_dyn_tend(
                grid, cfg, rk, dt, u2, w2, th2, rho2, sd, ru, rw,
                ru_save, rw_save, th_save, rho_p_save, pressure_p,
                ur_cell, vr_cell, euler)
            tend_rw = set_smlstep_pert_variables(grid, tend_u, tend_w_raw)

            zero_e = torch.zeros_like(ru)
            zero_c = torch.zeros_like(rho2)
            zero_i = torch.zeros_like(rw)
            av = AcousticVars(ru_p=zero_e, rho_pp=zero_c, rtheta_pp=zero_c,
                              rtheta_pp_old=zero_c, rw_p=zero_i,
                              ruAvg=zero_e, wwAvg=zero_i)
            # damp=True folds the previous iteration's divergence damping
            # into this iteration (a no-op on the zero entry state); the
            # last iteration's damping follows the loop
            for _ in range(nsub[rk - 1]):
                av = acoustic_step(
                    grid, cfg, coefs, av, rk_sub[rk - 1],
                    th_save, exner, w2, rho2, rw, rw_save, ru, ru_save,
                    tend_u, tend_rho, tend_theta, tend_rw,
                    hoist=hoist, damp=True)
            av = divergence_damping_3d(grid, cfg, av, rk_sub[rk - 1],
                                       th_save, th_sum=hoist.th_sum)

            (u2, w2, th2, rho2, ru, rw, rho_p, rtheta_p, exner_new,
             pressure_p_new, ruAvg, wwAvg) = recover_large_step_variables(
                grid, cfg, av, rk, rk_timestep[rk - 1], nsub[rk - 1],
                rho_p_save, rtheta_p_save, ru_save, rw_save, th2)
            if rk == 3:
                exner, pressure_p = exner_new, pressure_p_new
            sd = solve_diagnostics(grid, cfg, u2, rho2, dt,
                                   reconstruct_v=(rk == 3), v_prev=sd.v)

        # substep finish (ref: atm_rk_dynamics_substep_finish :5993)
        if sub == 0:
            ruAvg_split, wwAvg_split = ruAvg, wwAvg
        else:
            ruAvg_split = ruAvg_split + ruAvg
            wwAvg_split = wwAvg_split + wwAvg
        th1 = th2

    ruAvg = ruAvg_split / split
    wwAvg = wwAvg_split / split

    # split RK3 scalar transport with the time-averaged mass fluxes
    # (ref: RK3_SPLIT_TRANSPORT :1230-1580; Skamarock & Gassmann 2011)
    scalars = state1.scalars
    if cfg.config_scalar_advection and scalars.shape[-1] > 0:
        tr_ts = (dt / 3.0, dt / 2.0, dt) if order == 3 \
            else (dt / 2.0, dt / 2.0, dt)
        sc_new = scalars
        limited = cfg.config_monotonic or cfg.config_positive_definite
        for rk in (1, 2, 3):
            if rk < 3 or not limited:
                sc_new = advance_scalars(
                    grid, cfg, scalars, sc_new, rho_zz_old_split, rho2,
                    ruAvg, wwAvg, tr_ts[rk - 1], rk, True)
            else:
                sc_new = advance_scalars_mono(
                    grid, cfg, scalars, sc_new, rho_zz_old_split, rho2,
                    ruAvg, wwAvg, tr_ts[rk - 1], True,
                    positive_definite_only=not cfg.config_monotonic)
        scalars = sc_new

    ur_cell, vr_cell = reconstruct_cell_winds(grid, u2)
    state2 = AtmState(u=u2, w=w2, theta_m=th2, rho_zz=rho2, scalars=scalars)
    diag2 = AtmDiag(ru=ru, rw=rw, rho_p=rho_p, rtheta_p=rtheta_p,
                    exner=exner, pressure_p=pressure_p,
                    ruAvg=ruAvg, wwAvg=wwAvg)
    return AtmCarry(state=state2, diag=diag2, v=sd.v, sdiag_ke=sd.ke,
                    sdiag_div=sd.divergence, sdiag_vort=sd.vorticity,
                    sdiag_pv_edge=sd.pv_edge, sdiag_rho_edge=sd.rho_edge,
                    ur_cell=ur_cell, vr_cell=vr_cell)


def run_steps(grid: AtmGrid, cfg: AtmConfig, carry: AtmCarry, dt,
              n_steps: int) -> AtmCarry:
    """Advance `n_steps` timesteps."""
    for _ in range(n_steps):
        carry = srk3_step(grid, cfg, carry, dt)
    return carry
