"""Layered hydrostatic ocean core, forward mode (port of
mpas_tpu/cores/ocean/core.py).

The MPAS-Ocean forward-mode essentials (ref: src/core_ocean/mode_forward
+ shared/):
  thickness tendency  <- ocn_tend_thick (mpas_ocn_tendency.F:107):
                         horizontal flux divergence + z-star ALE transport
  velocity tendency   <- ocn_tend_vel (:204): TRiSK q-term (Ringler 2010),
                         KE gradient, hydrostatic pressure gradient + SSH
                         tilt, vertical advection, del2 mixing, Rayleigh drag
  tracer tendency     <- ocn_tend_tracer (:363): flux-form advection +
                         del2 mixing
  equation of state   <- ocn_equation_of_state_linear (or JM, eos.py)
  vertical mixing     <- ocn_vmix implicit solves (mpas_ocn_vmix.F) with
                         the coefficients of vmix.py, Thomas algorithm
                         (kernel K3 on the card, kernels/vmix.py)
  RK4 integrator      <- mpas_ocn_time_integration_rk4.F:74
  split-explicit      <- mpas_ocn_time_integration_split.F:82-1926:
                         baroclinic predictor iterations + barotropic
                         subcycling (split_step)

Layout: layer k = 0 is the surface; u (nEdges, nz), layerThickness
(nCells, nz), tracers (nCells, nz, nT). Vertical transport w_top lives on
interfaces (nCells, nz+1), positive upward, w_top[:, nz] = 0 at the
bottom. Every TRiSK contraction of a step (the q-term, the Coriolis
reconstruction of the baroclinic and barotropic modes) goes through the
cell-assembled operators of ops/stencils.py, and so through kernel K2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from mpas_tpu_torch.constants import gravity
from mpas_tpu_torch.cores.ocean import gm, tracer_extras, ztilde
from mpas_tpu_torch.cores.ocean.config import OcnConfig
from mpas_tpu_torch.cores.ocean.eos import density_jm
from mpas_tpu_torch.cores.ocean.forcing import (surface_stress_tend,
                                                surface_tracer_tend)
from mpas_tpu_torch.cores.ocean.state import OcnGrid, OcnState
from mpas_tpu_torch.cores.ocean.vmix import build_coefs
from mpas_tpu_torch.framework.timers import span, spanned
from mpas_tpu_torch.kernels.vmix import vmix_solve
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.ops import stencils as st


def build_level_masks(mesh, maxLevelCell, nz, dtype=np.float64):
    """(cellMask, edgeMask) from maxLevelCell, built on the host with
    numpy and returned as CPU tensors."""
    mlc = np.asarray(maxLevelCell)
    k = np.arange(nz)
    cell_mask = (k[None, :] < mlc[:, None]).astype(dtype)
    coe = np.asarray(mesh.cellsOnEdge)
    mle = np.minimum(mlc[coe[:, 0]], mlc[coe[:, 1]])
    edge_mask = (k[None, :] < mle[:, None]).astype(dtype)
    return torch.from_numpy(cell_mask), torch.from_numpy(edge_mask)


def equation_of_state_linear(cfg: OcnConfig, T, S):
    """ref: mpas_ocn_equation_of_state_linear.F."""
    return (cfg.config_eos_linear_densityref
            - cfg.config_eos_linear_alpha * (T - cfg.config_eos_linear_Tref)
            + cfg.config_eos_linear_beta * (S - cfg.config_eos_linear_Sref))


def equation_of_state(cfg: OcnConfig, T, S):
    """EOS dispatcher: linear or Jackett-McDougall (surface-referenced).
    ref: ocn_equation_of_state_density (mpas_ocn_equation_of_state.F)."""
    if cfg.config_eos_type == "jm":
        return density_jm(T, S, 0.0)
    return equation_of_state_linear(cfg, T, S)


def _ale_thickness_tend(grid: OcnGrid, div_hu):
    """z-star ALE: project the column-integrated divergence onto layers by
    resting-thickness weights; returns (tend_h, w_top).
    ref: ocn_ale_thickness (mpas_ocn_thick_ale.F) + vertical transport."""
    total_div = div_hu.sum(-1, keepdim=True)
    resting = grid.restingThickness
    if grid.cellMask is not None:
        # dead levels get exactly zero weight, or column volume leaks
        # through their epsilon resting thickness
        resting = resting * grid.cellMask
    wgt = resting / resting.sum(-1, keepdim=True)
    tend_h = -wgt * total_div
    # continuity per layer: dh/dt = -div_hu - (w_top[k] - w_top[k+1]),
    # solved upward from the bottom (w_top[:, nz] = 0)
    resid = -div_hu - tend_h            # = w_top[k] - w_top[k+1]
    w_rev = torch.flip(torch.cumsum(torch.flip(resid, [-1]), -1), [-1])
    return tend_h, F.pad(w_rev, (0, 1))


def vel_tendency(grid: OcnGrid, cfg: OcnConfig, u, h, tr, w_top, dt,
                 planetary: bool = True):
    """Velocity tendency T(u, w, p) (ref: ocn_tend_vel,
    mpas_ocn_tendency.F:204).

    planetary=False drops the planetary-vorticity part of the q-term (ref:
    RK4On = 0 in ocn_vel_coriolis_tend for the split-explicit integrator,
    where planetary Coriolis is handled by the fuperp iterations and the
    barotropic subcycle)."""
    mesh = grid.mesh
    h_edge = st.cell_to_edge_mean(mesh, h)
    uh = u * h_edge

    ke = st.kinetic_energy_cell(mesh, u)
    vorticity = st.edge_curl(mesh, u)
    h_vertex = st.cell_to_vertex_kite(mesh, h)
    pv_vertex = (mesh.fVertex[:, None] + vorticity if planetary
                 else vorticity) / h_vertex
    pv_edge = st.vertex_to_edge_mean(mesh, pv_vertex)
    if cfg.config_apvm_upwinding > 0.0:
        vt = st.tangential_cell_assembled(mesh, u)
        gradPVt = st.vertex_gradient_t(mesh, pv_vertex)
        pv_edge = pv_edge - cfg.config_apvm_upwinding * vt * dt * gradPVt

    # hydrostatic pressure at layer mid from the EOS
    rho = equation_of_state(cfg, tr[..., 0], tr[..., 1])
    gh = gravity * rho * h
    inc = 0.5 * (gh[:, :-1] + gh[:, 1:])
    p = torch.cumsum(torch.cat([0.5 * gh[:, :1], inc], dim=1), dim=1)
    if grid.surfacePressure is not None:
        p = p + grid.surfacePressure[:, None]
    ssh = h.sum(-1) - grid.bottomDepth
    depth_above = torch.cumsum(F.pad(h[:, :-1], (1, 0)), dim=1)
    z_mid = ssh[:, None] - depth_above - 0.5 * h

    q = st.trisk_q_cell_assembled(mesh, uh, pv_edge)

    def grad(f):            # zero on the walls
        return st.cell_gradient_n(mesh, f)

    rho_edge = st.cell_to_edge_mean(mesh, rho)
    tend_u = q - grad(ke) \
        - (grad(p) + rho_edge * gravity * grad(z_mid)) / cfg.config_density0

    # vertical advection of u (flux form minus u * divergence)
    w_edge = st.cell_to_edge_mean(mesh, w_top)          # (nE, nz+1)
    u_int = F.pad(0.5 * (u[:, 1:] + u[:, :-1]), (1, 1))
    flux_u = w_edge * u_int
    dw = w_edge[:, :-1] - w_edge[:, 1:]
    tend_u = tend_u - (flux_u[:, :-1] - flux_u[:, 1:] - u * dw) \
        / torch.clamp(h_edge, min=1e-12)

    # del2 mixing (ref: ocn_vel_hmix_del2)
    if cfg.config_mom_del2 > 0.0:
        tend_u = tend_u + cfg.config_mom_del2 * (
            grad(st.edge_divergence(mesh, u))
            - st.vertex_gradient_t(mesh, vorticity))
    if cfg.config_rayleigh_friction > 0.0:
        tend_u = tend_u - cfg.config_rayleigh_friction * u
    not_bnd = (1.0 - mesh.boundaryEdge)[:, None]
    if grid.edgeMask is not None:       # no tendency below the bathymetry
        not_bnd = not_bnd * grid.edgeMask
    return tend_u * not_bnd


def tracer_tendency(grid: OcnGrid, cfg: OcnConfig, uh, w_top, h, tr):
    """Thickness-weighted tracer tendency (ref: ocn_tend_tracer,
    mpas_ocn_tendency.F:363): flux-form advection + del2 mixing."""
    mesh = grid.mesh
    fl = uh[..., None] * st.cell_to_edge_mean(mesh, tr)
    tend_hT = -st.edge_divergence(mesh, fl)
    tr_int = F.pad(0.5 * (tr[:, 1:] + tr[:, :-1]), (0, 0, 1, 1))
    fv = w_top[..., None] * tr_int
    tend_hT = tend_hT - (fv[:, :-1] - fv[:, 1:])
    if cfg.config_tracer_del2 > 0.0:
        gt = st.cell_gradient_n(mesh, tr)        # zero on the walls
        if grid.edgeMask is not None:
            gt = gt * grid.edgeMask[..., None]
        hflux = st.cell_to_edge_mean(mesh, h)[..., None] * gt
        tend_hT = tend_hT + cfg.config_tracer_del2 \
            * st.edge_divergence(mesh, hflux)
    return tend_hT


def thickness_tendency(grid: OcnGrid, uh):
    """(div_hu, tend_h, w_top) from edge thickness fluxes (ref:
    ocn_tend_thick + ocn_vert_transport_velocity_top)."""
    div_hu = st.edge_divergence(grid.mesh, uh)
    tend_h, w_top = _ale_thickness_tend(grid, div_hu)
    return div_hu, tend_h, w_top


def tendencies(grid: OcnGrid, cfg: OcnConfig, state: OcnState, dt):
    """(tend_u, tend_h, tend_hT), plus (tend_lfd, tend_hhf) under z-tilde:
    one evaluation of all terms (RK4 path)."""
    u, h, tr = state.u, state.layerThickness, state.tracers
    h_edge = st.cell_to_edge_mean(grid.mesh, h)
    # GM: transport velocity = resolved + bolus (ref: ocn_gm, tracer and
    # thickness advection use normalVelocity + normalGMBolusVelocity)
    u_trans = u
    if cfg.config_use_gm:
        rho = equation_of_state(cfg, tr[..., 0], tr[..., 1])
        u_trans = u + gm.bolus_velocity(grid, cfg, rho, h)
    uh = u_trans * h_edge
    if grid.edgeMask is not None:       # no flux through the bathymetry
        uh = uh * grid.edgeMask
    if cfg.config_use_freq_filtered_thickness \
            and state.highFreqThickness is not None:
        # z-tilde: high-frequency divergence inflates layers locally
        div_hu = st.edge_divergence(grid.mesh, uh)
        tend_lfd, tend_hhf = ztilde.freq_filtered_tends(
            grid, cfg, div_hu, h, state.lowFreqDivergence,
            state.highFreqThickness)
        tend_h, w_top = ztilde.ale_tends_ztilde(grid, div_hu, tend_hhf)
        tend_u = vel_tendency(grid, cfg, u, h, tr, w_top, dt,
                              planetary=True)
        tend_hT = tracer_tendency(grid, cfg, uh, w_top, h, tr)
        return tend_u, tend_h, tend_hT, tend_lfd, tend_hhf
    _, tend_h, w_top = thickness_tendency(grid, uh)
    tend_u = vel_tendency(grid, cfg, u, h, tr, w_top, dt, planetary=True)
    tend_hT = tracer_tendency(grid, cfg, uh, w_top, h, tr)
    return tend_u, tend_h, tend_hT


def implicit_vertical_mix(grid: OcnGrid, cfg: OcnConfig, state: OcnState,
                          dt, forcing=None):
    """Backward-Euler vertical mixing of u and tracers (ref: ocn_vmix
    implicit solves, mpas_ocn_vmix.F), with the interface coefficients of
    the configured scheme (vmix.build_coefs). The KPP scheme also gives
    the non-local counter-gradient transport: an explicit flux
    N(sigma) * F_surf whose divergence is added to the tracers (ref:
    vertNonLocalFlux / ocn_tracer_nonlocalflux_tend)."""
    mesh = grid.mesh
    rho = equation_of_state(cfg, state.tracers[..., 0],
                            state.tracers[..., 1])
    vert_visc, vert_diff, nonlocal_c = build_coefs(
        grid, cfg, state.u, state.layerThickness, rho,
        forcing=forcing, tracers=state.tracers)
    if nonlocal_c is not None and forcing is not None:
        # explicit nonlocal tracer flux F(z) = N(z) F_surf; tendency
        # -dF/dz per layer (temperature, from the net heat flux)
        cp_sw = 3996.0
        f_surf_T = (forcing.sensibleHeatFlux + forcing.shortwaveFlux) \
            / (cfg.config_density0 * cp_sw)
        n_full = F.pad(nonlocal_c, (1, 1))
        dflux = n_full[:, :-1] - n_full[:, 1:]   # + at top = convergence
        tr = state.tracers.clone()
        tr[..., 0] += dt * dflux * f_surf_T[:, None] / state.layerThickness
        state = dataclasses.replace(state, tracers=tr)
    if cfg.config_use_redi:
        # Redi (3,3) term: kappa_Redi S^2 enhances the vertical tracer
        # diffusivity (ref: mpas_ocn_tracer_hmix_Redi.F small-slope tensor)
        vert_diff = vert_diff + gm.redi_vertical_enhancement(
            grid, cfg, rho, state.layerThickness)

    # the backward-Euler solves, one launch each on the card (K3), the
    # Thomas loop of vmix_solve_plain on the CPU
    h_edge = st.cell_to_edge_mean(mesh, state.layerThickness)
    with span("ocn.vmix_solve"):
        u_new = vmix_solve(state.u, h_edge, vert_visc, dt,
                           mask=grid.edgeMask,
                           bottom_drag=cfg.config_bottom_drag_coeff,
                           boundary=mesh.boundaryEdge)
        tr_new = vmix_solve(state.tracers, state.layerThickness, vert_diff,
                            dt, mask=grid.cellMask)
    return dataclasses.replace(state, u=u_new, tracers=tr_new)


# K3 launches of one ocn_timestep on the card, under either integrator and
# every config: implicit_vertical_mix's velocity solve and its one solve of
# all tracers
VMIX_SOLVE_LAUNCHES_PER_STEP = 2


_RK_W = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
_RK_S = (0.5, 0.5, 1.0, 0.0)


def _hooks(xch):
    """(cell, edge) exchange hooks: the identity where xch is None (one
    shard), else the sharded runner's halo refreshes."""
    if xch is None:
        return (lambda x, depth=None: x), (lambda x, depth=None: x)
    return xch.cell, xch.edge


def _nonzero(x):
    """x with its exact zeros replaced by 1 (safe divisor)."""
    return torch.where(x == 0.0, 1.0, x)


def rk4_step(grid: OcnGrid, cfg: OcnConfig, state: OcnState, dt,
             forcing=None, xch=None) -> OcnState:
    """ref: mpas_ocn_time_integration_rk4.F:74: the SW core's pool
    choreography, with implicit vertical mixing after the RK update.
    xch: per-stage refresh of the provisional prognostics (the sharded
    SW-core strategy: exchange prognostics, recompute diagnostics in the
    halo); None on one shard."""
    ce, ee = _hooks(xch)
    use_zt = cfg.config_use_freq_filtered_thickness \
        and state.highFreqThickness is not None
    u0, h0 = state.u, state.layerThickness
    hT0 = state.tracers * h0[..., None]
    u_acc, h_acc, hT_acc = u0, h0, hT0
    lfd0 = hhf0 = lfd_acc = hhf_acc = None
    if use_zt:
        lfd0, hhf0 = state.lowFreqDivergence, state.highFreqThickness
        lfd_acc, hhf_acc = lfd0, hhf0
    provis = state
    for stage in range(4):
        tends = tendencies(grid, cfg, provis, dt)
        tu, th, thT = tends[:3]
        u_acc = u_acc + dt * _RK_W[stage] * tu
        h_acc = h_acc + dt * _RK_W[stage] * th
        hT_acc = hT_acc + dt * _RK_W[stage] * thT
        if use_zt:
            lfd_acc = lfd_acc + dt * _RK_W[stage] * tends[3]
            hhf_acc = hhf_acc + dt * _RK_W[stage] * tends[4]
        if stage < 3:
            w = dt * _RK_S[stage]
            hp = h0 + w * th
            provis = OcnState(
                u=ee(u0 + w * tu), layerThickness=ce(hp),
                tracers=ce((hT0 + w * thT) / _nonzero(hp)[..., None]),
                lowFreqDivergence=ce(lfd0 + w * tends[3]) if use_zt
                else None,
                highFreqThickness=ce(hhf0 + w * tends[4]) if use_zt
                else None)
    if cfg.config_use_min_max_thickness:
        # conservative per-column clamping of the ALE target thickness
        # (ref: mpas_ocn_thick_ale.F:186-214); tracer mass rides along
        h_acc = ztilde.min_max_thickness_filter(grid, cfg, h_acc)
    out = OcnState(u=u_acc, layerThickness=h_acc,
                   tracers=hT_acc / _nonzero(h_acc)[..., None],
                   ubtr=state.ubtr,
                   lowFreqDivergence=lfd_acc, highFreqThickness=hhf_acc)
    with span("ocn.vertical_mix"):
        return implicit_vertical_mix(grid, cfg, out, dt, forcing)


def _fperp(mesh: Mesh, v, f_at_edges):
    """sum_j w_j f(eoe) v(eoe): the +f v_perp tangential reconstruction
    (ref: ocn_fuperp, mpas_ocn_diagnostics.F:1062; also the CoriolisTerm
    of the barotropic subcycle, mpas_ocn_time_integration_split.F:820-828),
    one K2 launch."""
    if v.dim() == 1:
        return st.tangential_cell_assembled(mesh, v * f_at_edges)
    return st.tangential_cell_assembled(mesh, v * f_at_edges[:, None])


def _bcl_iterations(cfg: OcnConfig):
    """Baroclinic iterations of each outer pass of split_step."""
    n_bcl = [cfg.config_n_bcl_iter_mid] * cfg.config_n_ts_iter
    n_bcl[0] = cfg.config_n_bcl_iter_beg
    n_bcl[-1] = cfg.config_n_bcl_iter_end
    return n_bcl


def _btr_subcycles(cfg: OcnConfig):
    """(barotropic steps per dt, subcycles per outer pass), from
    config_dt, not the dt of the call (host ints)."""
    n_btr = max(1, int(round(float(cfg.config_dt) / cfg.config_btr_dt)))
    return n_btr, n_btr * cfg.config_btr_subcycle_loop_factor


def tinydot_launches_per_split_step(cfg: OcnConfig) -> int:
    """K2 launches of one split_step, from the config: the q-term of each
    outer pass's vel_tendency, one Coriolis reconstruction per baroclinic
    iteration, and (1 + config_n_btr_cor_iter) per barotropic subcycle
    (plus one vel_tendency's tangential velocity per pass where
    config_apvm_upwinding > 0)."""
    n_ts = cfg.config_n_ts_iter
    per_pass = 2 if cfg.config_apvm_upwinding > 0.0 else 1
    return (n_ts * per_pass + sum(_bcl_iterations(cfg))
            + n_ts * _btr_subcycles(cfg)[1] * (1 + cfg.config_n_btr_cor_iter))


def split_step(grid: OcnGrid, cfg: OcnConfig, state: OcnState,
               dt, forcing=None, xch=None) -> OcnState:
    """Split-explicit barotropic/baroclinic timestep (ref:
    ocn_time_integrator_split, mpas_ocn_time_integration_split.F:82-1926;
    Higdon 2005 scheme as implemented in MPAS-Ocean v7).

    Per outer iteration (config_n_ts_iter, midpoint predictor-corrector):
      stage 1  baroclinic prediction: n_bcl_iter fixed-point iterations on
               the linear Coriolis term; the thickness-weighted vertical
               mean is removed and becomes the barotropic forcing G
               (:525-618)
      stage 2  barotropic subcycling over loop_factor * dt with a
               forward-backward SSH solve, velocity corrector iterations
               and flux averaging (:632-1120); velocity correction
               (:1282-1345)
      stage 3  thickness/tracer update with the time-averaged transport
               velocity; midpoint state on non-final passes (:1390-1740)
    followed by implicit vertical mixing. The reference's scan over the
    barotropic subcycles is a Python loop over them here, with the same
    carries and arithmetic.

    xch: optional exchange hooks (cores/ocean/distributed.py) fired at the
    reference's halo-exchange points: ubcl per baroclinic iteration and G
    after them, the 'subcycleFields' ssh + ubtr pair depth-restricted at
    the top of every barotropic subcycle (ref exchange-group reuse,
    mpas_ocn_time_integration_split.F:771; 2 + config_n_btr_cor_iter
    rings deep), the 'finalBtrFields' group after subcycling
    (:1282-1290), and the midpoint thickness and tracers between outer
    passes. None on one shard.
    """
    ce, ee = _hooks(xch)
    mesh = grid.mesh
    not_bnd = 1.0 - mesh.boundaryEdge
    g = gravity
    f_edge = mesh.fEdge

    u_cur, h_cur, tr_cur = state.u, state.layerThickness, state.tracers
    ubtr_cur = state.ubtr * not_bnd
    ubcl_cur = (u_cur - ubtr_cur[:, None]) * not_bnd[:, None]
    ssh_cur = h_cur.sum(-1) - grid.bottomDepth

    n_ts = cfg.config_n_ts_iter
    n_bcl = _bcl_iterations(cfg)
    n_btr, n_loop = _btr_subcycles(cfg)
    # halo rings a barotropic subcycle reads. The JAX package exchanges 2
    # whatever the corrector count, which leaves the owned edges next to a
    # shard boundary a ring short per corrector iteration (3e-7 x max|u|
    # after one 300 s step of the 192-cell channel on 4 shards).
    btr_depth = 2 + cfg.config_n_btr_cor_iter
    gam1 = cfg.config_btr_gam1_velWt1
    gam2 = cfg.config_btr_gam2_SSHWt1

    # under land ice the barotropic gradient acts on the pressure-adjusted
    # SSH, ssh + p_surf / (g rho0) (ref: the landIcePressure contribution
    # to the barotropic forcing)
    p_corr = None if grid.surfacePressure is None \
        else grid.surfacePressure / (g * cfg.config_eos_linear_densityref)

    def grad_e(fld):        # zero on the walls (not_bnd built once)
        if p_corr is not None:
            fld = fld + p_corr
        return st.cell_gradient_n(mesh, fld, mask_boundary=False) * not_bnd

    # barotropic column thickness at edges (ref :906-907): sshEdge + the
    # smaller of the neighbouring resting depths
    coe = mesh.cellsOnEdge
    min_depth = torch.minimum(grid.bottomDepth[coe[:, 0]],
                              grid.bottomDepth[coe[:, 1]])

    # working level-2 state
    h_new, tr_new, ubcl_new, ssh_new = h_cur, tr_cur, ubcl_cur, ssh_cur
    w_for_tend = torch.zeros((mesh.nCells, grid.nz + 1), dtype=h_cur.dtype,
                             device=h_cur.device)
    ubtr_avg = ubtr_cur
    for outer in range(n_ts):
        # --- stage 1: baroclinic prediction --------------------------------
        with span("ocn.baroclinic"):
            if outer == 0:
                u_st, h_st, tr_st = u_cur, h_cur, tr_cur
            else:
                u_st, h_st, tr_st = u_new, h_new, tr_new
            h_edge = st.cell_to_edge_mean(mesh, h_st)
            h_edge_safe = _nonzero(h_edge.sum(-1))
            tend_u = vel_tendency(grid, cfg, u_st, h_st, tr_st, w_for_tend,
                                  dt, planetary=False)
            for _ in range(n_bcl[outer]):
                fperp = _fperp(mesh, ubcl_new, f_edge)
                u_temp = ubcl_cur + dt * (tend_u + fperp
                                          + g * grad_e(ssh_new)[:, None])
                G = (h_edge * u_temp).sum(-1) / h_edge_safe / dt
                ubcl_new = 0.5 * (ubcl_cur + u_temp - dt * G[:, None]) \
                    * not_bnd[:, None]
                # ref: normalBaroclinicVelocity exchanged per bcl iteration
                ubcl_new = ee(ubcl_new)
            G = ee(G)

        # --- stage 2: barotropic subcycling --------------------------------
        with span("ocn.barotropic"):
            dtb = dt / n_btr
            ssh_o, ubtr_o = ssh_cur, ubtr_cur
            ubtr_acc, flux_acc = ubtr_cur, torch.zeros_like(ubtr_cur)
            for _ in range(n_loop):
                # 'subcycleFields' exchange-group reuse, depth-restricted
                # (ref :771, haloLayers on ssh + ubtr): the rings this body
                # consumes, two for the predictor and one more per corrector
                # iteration (btr_depth)
                ssh_o = ce(ssh_o, depth=btr_depth)
                ubtr_o = ee(ubtr_o, depth=btr_depth)
                # velocity predictor (ref :820-838)
                cor = _fperp(mesh, ubtr_o, f_edge)
                ubtr_n = not_bnd * (ubtr_o + dtb * (cor - g * grad_e(ssh_o)
                                                    + G))
                # SSH forward-backward solve + flux accumulation (ref :896-960)
                h_sum = st.cell_to_edge_mean(mesh, ssh_o) + min_depth
                flux = ((1.0 - gam1) * ubtr_o + gam1 * ubtr_n) * h_sum \
                    * not_bnd
                ssh_n = ssh_o - dtb * st.edge_divergence(mesh, flux)
                flux_acc = flux_acc + flux
                # velocity corrector iterations (ref :1020-1076)
                for _ in range(cfg.config_n_btr_cor_iter):
                    cor = _fperp(mesh, ubtr_n, f_edge)
                    ssh_w = (1.0 - gam2) * ssh_o + gam2 * ssh_n
                    ubtr_n = not_bnd * (ubtr_o + dtb * (cor - g * grad_e(ssh_w)
                                                        + G))
                ssh_o, ubtr_o = ssh_n, ubtr_n
                ubtr_acc = ubtr_acc + ubtr_n
            # the velocity average counts the starting value, the flux
            # average does not (ref :1282-1290)
            flux_avg = flux_acc / n_loop
            ubtr_avg = ubtr_acc / (n_loop + 1)
            # 'finalBtrFields' full-depth exchange (ref :1282-1290)
            flux_avg = ee(flux_avg)
            ubtr_avg = ee(ubtr_avg)

        with span("ocn.update"):
            # velocity correction (ref :1282-1345)
            u_full = ubtr_avg[:, None] + ubcl_new
            if cfg.config_vel_correction:
                corr = (flux_avg - (h_edge * u_full).sum(-1)) / h_edge_safe
            else:
                corr = torch.zeros_like(ubtr_avg)
            u_transport = (u_full + corr[:, None]) * not_bnd[:, None]

            # --- stage 3: thickness / tracer update ------------------------
            if cfg.config_use_gm:
                # GM bolus transport added to the advective velocity (ref:
                # ocn_gm; as on the RK4 path)
                rho_gm = equation_of_state(cfg, tr_new[..., 0], tr_new[..., 1])
                u_transport = u_transport + gm.bolus_velocity(
                    grid, cfg, rho_gm, h_st)
            uh = u_transport * h_edge
            if grid.edgeMask is not None:
                uh = uh * grid.edgeMask
            _, tend_h, w_top = thickness_tendency(grid, uh)
            tend_hT = tracer_tendency(grid, cfg, uh, w_top, h_st, tr_new)
            w_for_tend = w_top
            if outer < n_ts - 1:
                temp_h = h_cur + dt * tend_h
                h_new = 0.5 * (h_cur + temp_h)
                temp_tr = (tr_cur * h_cur[..., None] + dt * tend_hT) \
                    / _nonzero(temp_h)[..., None]
                tr_new = 0.5 * (tr_cur + temp_tr)
                u_new = ubtr_avg[:, None] + ubcl_new
                # the midpoint prognostics feed the next outer pass: refresh
                # their halos (ref: the 'combined' exchange between ts
                # iterations, :1390+)
                h_new = ce(h_new)
                tr_new = ce(tr_new)
                ssh_new = h_new.sum(-1) - grid.bottomDepth
            else:
                h_new = h_cur + dt * tend_h
                tr_new = (tr_cur * h_cur[..., None] + dt * tend_hT) \
                    / _nonzero(h_new)[..., None]
                # ubcl_new is at n+1/2: extrapolate to n+1 (ref :1733-1737)
                u_new = ubtr_avg[:, None] + 2.0 * ubcl_new - ubcl_cur

    out = OcnState(u=u_new * not_bnd[:, None], layerThickness=h_new,
                   tracers=tr_new, ubtr=ubtr_avg)
    with span("ocn.vertical_mix"):
        mixed = implicit_vertical_mix(grid, cfg, out, dt, forcing)
    return dataclasses.replace(mixed, ubtr=ubtr_avg)


def apply_surface_forcing(grid: OcnGrid, cfg: OcnConfig, state: OcnState,
                          forcing, dt) -> OcnState:
    """Forward-Euler application of the surface forcing before the
    dynamics step (ref: the forcing tendencies of ocn_tend_vel /
    ocn_tend_tracer, applied operator-split here)."""
    h = state.layerThickness
    du = surface_stress_tend(grid, cfg, forcing, h)
    dhT = surface_tracer_tend(grid, cfg, forcing, h, state.tracers)
    tr = state.tracers + dt * dhT / torch.clamp(h, min=1e-3)[..., None]
    return dataclasses.replace(state, u=state.u + dt * du, tracers=tr)


@spanned("ocn.timestep")
def ocn_timestep(grid: OcnGrid, cfg: OcnConfig, state: OcnState,
                 dt, forcing=None, xch=None) -> OcnState:
    """Integrator dispatch (ref: ocn_timestep,
    mpas_ocn_time_integration.F:80)."""
    if forcing is not None:
        with span("ocn.forcing"):
            state = apply_surface_forcing(grid, cfg, state, forcing, dt)
    if cfg.config_time_integrator == "split_explicit":
        out = split_step(grid, cfg, state, dt, forcing, xch=xch)
    elif cfg.config_time_integrator == "RK4":
        out = rk4_step(grid, cfg, state, dt, forcing, xch=xch)
    else:
        raise ValueError(
            f"unknown config_time_integrator "
            f"{cfg.config_time_integrator!r}; "
            "supported: 'split_explicit', 'RK4'")
    # auxiliary tracer groups, operator-split after the dynamics (ref
    # ordering: tracer group tendencies in ocn_tend_tracer + the frazil
    # adjustment at the end of the split stage 3)
    if (cfg.config_use_ideal_age or cfg.config_use_exponential_decay
            or cfg.config_use_frazil):
        tr = out.tracers
        if cfg.config_use_ideal_age:
            tr = tracer_extras.ideal_age_step(tr, cfg.config_ideal_age_index,
                                              dt)
        if cfg.config_use_exponential_decay:
            tr = tracer_extras.exponential_decay_step(
                tr, cfg.config_exp_decay_index, dt,
                cfg.config_exp_decay_efolding)
        out = dataclasses.replace(out, tracers=tr)
        if cfg.config_use_frazil:
            out, _frazil = tracer_extras.frazil_adjustment(cfg, out, dt)
    return out


def run_steps(grid: OcnGrid, cfg: OcnConfig, state: OcnState,
              n_steps: int, forcing=None) -> OcnState:
    """n_steps calls of ocn_timestep at dt = config_dt, on the device of
    the state."""
    dt = float(cfg.config_dt)
    for _ in range(n_steps):
        state = ocn_timestep(grid, cfg, state, dt, forcing)
    return state
