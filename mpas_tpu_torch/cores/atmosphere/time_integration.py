"""Split-explicit RK3 time stepping of the nonhydrostatic core, dry or
moist with Kessler, WSM6 or Thompson microphysics (port of
mpas_tpu/cores/atmosphere/time_integration.py).

ref: atm_srk3, src/core_atmosphere/dynamics/mpas_atm_time_integration.F:142.
The dynamics substeps, RK stages and acoustic substeps are plain Python
loops; each tensor operation runs eagerly on the tensors' device. The
exchange hooks (`xch`) fire at the reference's halo-exchange points; on
one shard they are the identity, and the sharded runner
(cores/atmosphere/distributed.py) makes them halo refreshes.
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
                                                  compute_moist_coefficients,
                                                  divergence_damping_3d,
                                                  reconstruct_cell_winds,
                                                  recover_large_step_variables,
                                                  set_smlstep_pert_variables,
                                                  solve_diagnostics,
                                                  vert_imp_coefs)
from mpas_tpu_torch.cores.atmosphere.physics.driver import (
    microphysics_step, microphysics_step_thompson, microphysics_step_wsm6)
from mpas_tpu_torch.cores.atmosphere.setup import AtmGrid
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.cores.atmosphere.transport import (advance_scalars,
                                                       advance_scalars_mono)
from mpas_tpu_torch.framework.timers import span, spanned


@dataclasses.dataclass(frozen=True)
class AtmCarry:
    """Everything advanced from step to step."""
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
    # physics coupling (ref: tend pool rt_diabatic_tend; diag_physics rainnc)
    rt_diabatic_tend: Any   # (nC, nz) theta_m tendency of the microphysics
    rainnc: Any             # (nC,) accumulated surface rain [m]

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
                    ur_cell=ur, vr_cell=vr,
                    rt_diabatic_tend=torch.zeros_like(state.theta_m),
                    rainnc=torch.zeros_like(state.theta_m[:, 0]))


class _NoExchange:
    """Identity exchange hooks (single shard). The distributed runner
    substitutes halo refreshes at exactly the reference's exchange points
    (ref: the mpas_dmpar_exch_halo_field calls inside atm_srk3). `depth`
    mirrors the reference's haloLayers argument (layer-restricted
    exchanges, e.g. layer 1 only inside the acoustic loop, ref :792,845)."""

    def cell(self, x, depth=None):
        return x

    def edge(self, x, depth=None):
        return x


NO_XCH = _NoExchange()


def _check_supported(cfg: AtmConfig, state: AtmState):
    """The reference's scheme and scalar-count checks (:89-106)."""
    scheme = cfg.config_microp_scheme
    nsc = state.scalars.shape[-1]
    if scheme not in ("off", "mp_kessler", "mp_wsm6", "mp_thompson"):
        raise ValueError(
            f"unknown config_microp_scheme {scheme!r}; supported: 'off', "
            "'mp_kessler', 'mp_wsm6', 'mp_thompson'")
    if scheme == "mp_kessler" and nsc < 3:
        raise ValueError("mp_kessler requires scalars (qv, qc, qr); "
                         f"got {nsc} scalar(s)")
    if scheme == "mp_wsm6" and nsc < 6:
        raise ValueError("mp_wsm6 requires scalars (qv,qc,qr,qi,qs,qg); "
                         f"got {nsc} scalar(s)")
    if scheme == "mp_thompson" and nsc < 8:
        raise ValueError(
            "mp_thompson requires scalars (qv,qc,qr,qi,qs,qg,nr,ni); "
            f"got {nsc} scalar(s)")


@spanned("atm.srk3_step")
def srk3_step(grid: AtmGrid, cfg: AtmConfig, carry: AtmCarry, dt,
              xch=None) -> AtmCarry:
    """One full timestep (ref: atm_srk3 :142-1796). xch: exchange hooks
    (.cell/.edge with a depth), None on a single shard."""
    xch = NO_XCH if xch is None else xch
    _check_supported(cfg, carry.state)
    # step-start halo refresh (ref: atm_srk3 :666-676 theta_m/scalars/
    # pressure_p/rtheta_p exchanges)
    state1 = dataclasses.replace(
        carry.state, theta_m=xch.cell(carry.state.theta_m),
        w=xch.cell(carry.state.w), rho_zz=xch.cell(carry.state.rho_zz),
        u=xch.edge(carry.state.u), scalars=xch.cell(carry.state.scalars))
    diag = dataclasses.replace(
        carry.diag, pressure_p=xch.cell(carry.diag.pressure_p),
        rtheta_p=xch.cell(carry.diag.rtheta_p),
        exner=xch.cell(carry.diag.exner), rho_p=xch.cell(carry.diag.rho_p),
        ru=xch.edge(carry.diag.ru), rw=xch.cell(carry.diag.rw))

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

    # moist coupling (ref: atm_compute_moist_coefficients :410), once per
    # step from the time-level-1 scalars. A state carrying at least
    # (qv, qc, qr) is moist; the dry configurations carry one passive
    # scalar and take the dry path.
    moist = state1.scalars.shape[-1] >= 3
    if moist:
        qtot, cqw, cqu = compute_moist_coefficients(grid, state1.scalars)
        rt_diab = carry.rt_diabatic_tend
    else:
        qtot = cqw = cqu = rt_diab = None

    for sub in range(split):
        # start-of-substep saves (ref: atm_rk_integration_setup :1799)
        ru_save, rw_save = ru, rw
        rtheta_p_save, rho_p_save = rtheta_p, rho_p
        th_save = th1

        with span("atm.vert_imp_coefs"):
            coefs = vert_imp_coefs(grid, cfg, rk_sub[0], th2, exner,
                                   rtheta_p, qtot, cqw)
        with span("atm.vert_imp_coefs"):
            hoist = acoustic_hoist(grid, th_save, exner, cqu)
        euler = None
        for rk in (1, 2, 3):
            if order == 3 and rk == 2:
                with span("atm.vert_imp_coefs"):
                    coefs = vert_imp_coefs(grid, cfg, rk_sub[1], th2,
                                           exner, rtheta_p, qtot, cqw)
            (tend_u, tend_rho, tend_theta, tend_w_raw, _,
             euler) = compute_dyn_tend(
                grid, cfg, rk, dt, u2, w2, th2, rho2, sd, ru, rw,
                ru_save, rw_save, th_save, rho_p_save, pressure_p,
                ur_cell, vr_cell, euler, cqu=cqu, cqw=cqw, qtot=qtot,
                rt_diabatic_tend=rt_diab)
            with span("atm.acoustic"):
                # ref: tend_u layer-1-only halo exchange before the
                # omega conversion (:642)
                tend_u = xch.edge(tend_u, depth=1)
                tend_rw = set_smlstep_pert_variables(grid, tend_u,
                                                     tend_w_raw)

                zero_e = torch.zeros_like(ru)
                zero_c = torch.zeros_like(rho2)
                zero_i = torch.zeros_like(rw)
                av = AcousticVars(ru_p=zero_e, rho_pp=zero_c,
                                  rtheta_pp=zero_c, rtheta_pp_old=zero_c,
                                  rw_p=zero_i, ruAvg=zero_e, wwAvg=zero_i)
                # damp=True folds the previous iteration's divergence
                # damping into this iteration (a no-op on the zero
                # entry state); the last iteration's damping follows
                # the loop. The reference's layer-1 rtheta_pp and
                # rho_pp exchanges (:792, :845) fire as each field is
                # produced.
                for _ in range(nsub[rk - 1]):
                    av = acoustic_step(
                        grid, cfg, coefs, av, rk_sub[rk - 1],
                        th_save, exner, w2, rho2, rw, rw_save, ru,
                        ru_save, tend_u, tend_rho, tend_theta, tend_rw,
                        hoist=hoist, damp=True,
                        xch_rtheta=lambda x: xch.cell(x, depth=1))
                    av = av._replace(rho_pp=xch.cell(av.rho_pp, depth=1))
                av = divergence_damping_3d(grid, cfg, av, rk_sub[rk - 1],
                                           th_save, th_sum=hoist.th_sum)
                # ref: rw_p/ru_p/rho_pp/rtheta_pp exchanged two layers
                # deep before the recovery (:873-887); ruAvg/wwAvg full
                # depth for the transport
                av = av._replace(rw_p=xch.cell(av.rw_p, depth=2),
                                 ru_p=xch.edge(av.ru_p, depth=2),
                                 rho_pp=xch.cell(av.rho_pp, depth=2),
                                 rtheta_pp=xch.cell(av.rtheta_pp,
                                                    depth=2),
                                 ruAvg=xch.edge(av.ruAvg),
                                 wwAvg=xch.cell(av.wwAvg))

            with span("atm.recover"):
                (u2, w2, th2, rho2, ru, rw, rho_p, rtheta_p, exner_new,
                 pressure_p_new, ruAvg,
                 wwAvg) = recover_large_step_variables(
                    grid, cfg, av, rk, rk_timestep[rk - 1], nsub[rk - 1],
                    rho_p_save, rtheta_p_save, ru_save, rw_save, th2,
                    rt_diabatic_tend=rt_diab)
            if rk == 3:
                exner, pressure_p = exner_new, pressure_p_new
            # ref: u full-halo exchange after the recovery (:988), w after
            # the diagnostics (:1234-1248)
            u2 = xch.edge(u2)
            w2 = xch.cell(w2)
            with span("atm.diagnostics"):
                sd = solve_diagnostics(grid, cfg, u2, rho2, dt,
                                       reconstruct_v=(rk == 3),
                                       v_prev=sd.v)

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
        with span("atm.transport"):
            tr_ts = (dt / 3.0, dt / 2.0, dt) if order == 3 \
                else (dt / 2.0, dt / 2.0, dt)
            sc_new = scalars
            limited = cfg.config_monotonic \
                or cfg.config_positive_definite
            for rk in (1, 2, 3):
                if rk < 3 or not limited:
                    sc_new = advance_scalars(
                        grid, cfg, scalars, sc_new, rho_zz_old_split,
                        rho2, ruAvg, wwAvg, tr_ts[rk - 1], rk, True)
                else:
                    sc_new = advance_scalars_mono(
                        grid, cfg, scalars, sc_new, rho_zz_old_split,
                        rho2, ruAvg, wwAvg, tr_ts[rk - 1], True,
                        positive_definite_only=not cfg.config_monotonic)
                sc_new = xch.cell(sc_new)
            scalars = sc_new

    # microphysics after transport, on the new time level; its theta_m
    # tendency feeds the next step's dynamics (ref: atm_srk3 :1654
    # driver_microphysics)
    rt_diab_out, rainnc = carry.rt_diabatic_tend, carry.rainnc
    mp = {"mp_kessler": microphysics_step,
          "mp_wsm6": microphysics_step_wsm6,
          "mp_thompson": microphysics_step_thompson}.get(
        cfg.config_microp_scheme)
    if mp is not None:
        with span("atm.microphysics"):
            (th2, scalars, rtheta_p, exner, pressure_p, rt_diab_out,
             rain) = mp(grid, th2, rho2, scalars, exner, dt)
            th2 = xch.cell(th2)
            scalars = xch.cell(scalars)
            rtheta_p = xch.cell(rtheta_p)
            exner = xch.cell(exner)
            pressure_p = xch.cell(pressure_p)
            rt_diab_out = xch.cell(rt_diab_out)
            rainnc = rainnc + rain

    with span("atm.reconstruct_winds"):
        ur_cell, vr_cell = reconstruct_cell_winds(grid, u2)
    state2 = AtmState(u=u2, w=w2, theta_m=th2, rho_zz=rho2, scalars=scalars)
    diag2 = AtmDiag(ru=ru, rw=rw, rho_p=rho_p, rtheta_p=rtheta_p,
                    exner=exner, pressure_p=pressure_p,
                    ruAvg=ruAvg, wwAvg=wwAvg)
    return AtmCarry(state=state2, diag=diag2, v=sd.v, sdiag_ke=sd.ke,
                    sdiag_div=sd.divergence, sdiag_vort=sd.vorticity,
                    sdiag_pv_edge=sd.pv_edge, sdiag_rho_edge=sd.rho_edge,
                    ur_cell=ur_cell, vr_cell=vr_cell,
                    rt_diabatic_tend=rt_diab_out, rainnc=rainnc)


def run_steps(grid: AtmGrid, cfg: AtmConfig, carry: AtmCarry, dt,
              n_steps: int) -> AtmCarry:
    """Advance `n_steps` timesteps."""
    return run_steps_xch(grid, cfg, carry, dt, n_steps, None)


def run_steps_xch(grid: AtmGrid, cfg: AtmConfig, carry: AtmCarry, dt,
                  n_steps: int, xch) -> AtmCarry:
    """Like run_steps, with exchange hooks (the sharded runner's)."""
    for _ in range(n_steps):
        carry = srk3_step(grid, cfg, carry, dt, xch=xch)
    return carry
