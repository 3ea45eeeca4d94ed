"""Land-ice forward core: SIA or FO velocity + FE thickness evolution +
thermal column solve + calving (port of mpas_tpu/cores/landice/core.py).

ref call structure (src/core_landice/mode_forward/mpas_li_core.F:279
li_core_run -> mpas_li_time_integration.F -> mpas_li_time_integration_fe.F):
  1. velocity solve       (mpas_li_velocity.F -> mpas_li_sia.F:234 li_sia_solve)
  2. thickness advection  (mpas_li_advection.F, FO-upwind branch)
  3. thermal solve        (mpas_li_thermal.F vertical column)
  4. calving              (mpas_li_calving.F)

The SIA vertical profile is a cumulative sum over static sigma levels
(vectorized over edges); the thermal solve is a batched Thomas
tridiagonal over cells; calving is an elementwise mask. A multi-step run
is a Python loop of steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mpas_tpu_torch.containers import to_device
from mpas_tpu_torch.cores.landice.config import SECONDS_PER_YEAR, LiConfig
from mpas_tpu_torch.framework.timers import span
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.ops import stencils as st
from mpas_tpu_torch.ops.matrix import tridiagonal_solve


@dataclasses.dataclass(frozen=True)
class LiGrid:
    mesh: Mesh
    bedTopography: Any          # (nCells,) m (negative below sea level)
    # static sigma coordinate, 0 at surface -> 1 at bed, ref
    # layerInterfaceSigma (mpas_li_sia.F:428)
    layerInterfaceSigma: Any    # (nz+1,)
    layerSigmaFraction: Any     # (nz,) layer fractional thickness
    # first-order Stokes geometry (built when config_velocity_solver='FO';
    # ref: the extruded-grid setup of Interface_velocity_solver.cpp:928)
    fo_geom: Any = None

    def to(self, device, dtype) -> "LiGrid":
        return to_device(self, device, dtype)


@dataclasses.dataclass(frozen=True)
class LiState:
    thickness: Any              # (nCells,) m
    temperature: Any            # (nCells, nz) K, layer midpoints
    # diagnostics carried across steps
    normalVelocity: Any         # (nEdges, nz+1) m/s at layer interfaces
    calvingFlux: Any            # (nCells,) m of ice removed (cumulative)
    # polythermal state (enthalpy solver; ref waterFrac tracer)
    waterFrac: Any = None       # (nCells, nz) liquid water fraction
    basalMeltRate: Any = None   # (nCells,) m of ice / s

    def to(self, device, dtype) -> "LiState":
        return to_device(self, device, dtype)


def make_grid(mesh: Mesh, cfg: LiConfig, bed=None) -> LiGrid:
    """The grid on the mesh's device in its float dtype; the FO geometry
    (host numpy) where cfg asks for the FO solver."""
    nz = cfg.config_nvertlevels
    dev, dt = mesh.xCell.device, mesh.xCell.dtype
    sigma = torch.linspace(0.0, 1.0, nz + 1, dtype=dt, device=dev)
    frac = torch.full((nz,), 1.0 / nz, dtype=dt, device=dev)
    bed = (torch.zeros(mesh.nCells, dtype=dt, device=dev) if bed is None
           else torch.as_tensor(bed, dtype=dt, device=dev))
    fo_geom = None
    if cfg.config_velocity_solver == "FO":
        from mpas_tpu_torch.cores.landice.fo_stokes import build_fo_geom
        fo_geom = build_fo_geom(mesh)
    return LiGrid(mesh=mesh, bedTopography=bed, layerInterfaceSigma=sigma,
                  layerSigmaFraction=frac, fo_geom=fo_geom)


def fo_velocity(grid: LiGrid, cfg: LiConfig, thickness, temperature,
                xch=None, owned=None, group=None, resid_out=None):
    """First-order Stokes edge-normal interface velocities.

    ref: mpas_li_velocity_external.F + Interface_velocity_solver.cpp
    velocity_solver_solve_fo (:341) — here the Blatter-Pattyn solve of
    fo_stokes.py; cell (u, v) at layer midpoints are projected onto edge
    normals and interpolated to layer interfaces. xch/owned/group: the
    sharded-solve hooks (see _solve_fo_stokes_impl). resid_out: a list
    that receives the CG residual (a 0-d tensor) after each Picard pass."""
    from mpas_tpu_torch.cores.landice.fo_stokes import _solve_fo_stokes_impl
    m = grid.mesh
    nz = cfg.config_nvertlevels
    surface = grid.bedTopography + thickness
    flwa = flow_param_a(cfg, temperature)
    u, v, _ = _solve_fo_stokes_impl(
        grid.fo_geom, thickness, surface, flwa,
        cfg.config_fo_basal_friction, cfg.rho_ice * cfg.gravity, nz=nz,
        picard_iters=cfg.config_fo_picard_iters,
        cg_iters=cfg.config_fo_cg_iters, xch=xch, owned=owned, group=group,
        resid_out=resid_out)
    dyn = (thickness > 1.0).to(thickness.dtype)
    u = u * dyn[:, None]
    v = v * dyn[:, None]
    coe = m.cellsOnEdge
    cos_e = torch.cos(m.angleEdge)[:, None]
    sin_e = torch.sin(m.angleEdge)[:, None]
    un_mid = 0.5 * ((u[coe[:, 0]] + u[coe[:, 1]]) * cos_e
                    + (v[coe[:, 0]] + v[coe[:, 1]]) * sin_e)
    # midpoints (k=0 surface..nz-1 base) -> interfaces (nz+1): linear
    # interior, copy at the surface, zero at the bed contact
    interior = 0.5 * (un_mid[:, 1:] + un_mid[:, :-1])
    u_int = torch.cat([un_mid[:, :1], interior, un_mid[:, -1:]], dim=1)
    return u_int * (1.0 - m.boundaryEdge)[:, None]


def zero_state(mesh: Mesh, cfg: LiConfig, dtype=torch.float64,
               device=None) -> LiState:
    """Ice-free state on `device` (the mesh's device when None)."""
    nz = cfg.config_nvertlevels
    dev = mesh.xCell.device if device is None else device
    return LiState(
        thickness=torch.zeros(mesh.nCells, dtype=dtype, device=dev),
        temperature=torch.full((mesh.nCells, nz),
                               cfg.config_surface_air_temperature,
                               dtype=dtype, device=dev),
        normalVelocity=torch.zeros((mesh.nEdges, nz + 1), dtype=dtype,
                                   device=dev),
        calvingFlux=torch.zeros(mesh.nCells, dtype=dtype, device=dev))


def flow_param_a(cfg: LiConfig, temperature):
    """Arrhenius rate factor A(T*). ref: li_calculate_flowParamA
    (mpas_li_sia.F:336 capability; PB1982 option)."""
    if cfg.config_flowParamA_calculation == "constant":
        return torch.full_like(temperature, cfg.config_default_flowParamA)
    cold = temperature < 263.15
    # both branches as tensors of the state's dtype: a where() of two
    # Python floats is float32 whatever the run's dtype
    one = torch.ones_like(temperature)
    a0 = torch.where(cold, one * cfg.pb_a0_cold, one * cfg.pb_a0_warm)
    q = torch.where(cold, one * cfg.pb_q_cold, one * cfg.pb_q_warm)
    a_yr = a0 * torch.exp(-q / (cfg.gas_constant * temperature))
    return a_yr / SECONDS_PER_YEAR


def sia_velocity(grid: LiGrid, cfg: LiConfig, thickness, temperature):
    """Shallow-ice normal velocity at layer interfaces on edges.

    ref: li_sia_solve (mpas_li_sia.F:234-445):
      u(sig) = -0.5 (rho g)^n * |grad s|^(n-1) * ds/dn * H^(n+1)
               * sum_k flwa_k (sig_k^(n+1) - sig_{k+1}^(n+1))
    with centered thickness on edges and dynamic-cell-weighted flwa.
    """
    m = grid.mesh
    n = cfg.config_flowlaw_exponent
    surface = grid.bedTopography + thickness

    normal_slope = st.cell_gradient_n(m, surface)
    # tangent slope via TRiSK tangential reconstruct of the normal slope
    # (ref: 'from_normal_slope' option, mpas_li_sia.F:373)
    tangent_slope = st.tangential_velocity(m, normal_slope)
    slope = torch.sqrt(normal_slope ** 2 + tangent_slope ** 2)

    coe = m.cellsOnEdge
    dyn = (thickness > 1.0).to(thickness.dtype)           # dynamic-ice mask
    h_edge = 0.5 * (thickness[coe[:, 0]] + thickness[coe[:, 1]])
    d1, d2 = dyn[coe[:, 0]], dyn[coe[:, 1]]
    edge_dyn = ((d1 + d2) > 0).to(thickness.dtype) * (1.0 - m.boundaryEdge)

    flwa = flow_param_a(cfg, temperature)                  # (nCells, nz)
    flwa_edge = (flwa[coe[:, 0]] * d1[:, None]
                 + flwa[coe[:, 1]] * d2[:, None]) \
        / (d1 + d2).clamp(min=1.0)[:, None]

    factor = -0.5 * (cfg.rho_ice * cfg.gravity) ** n
    level_factor = slope ** (n - 1.0) * normal_slope * h_edge ** (n + 1.0)

    # vertical profile: u(sigma) = factor*level*flwa*(1 - sigma^(n+1)),
    # sigma measured from the surface (no sliding: u(1)=0); built as a
    # cumulative sum of per-layer increments so flwa may vary with depth
    # (ref: mpas_li_sia.F:424-429)
    sig = grid.layerInterfaceSigma
    dsig = sig[1:] ** (n + 1.0) - sig[:-1] ** (n + 1.0)    # (nz,) > 0
    # cumulative from the bed (interface nz) upward: u[k] = sum_{j>=k} inc_j
    inc = factor * level_factor[:, None] * flwa_edge * dsig[None, :]
    from_bed = torch.flip(torch.cumsum(torch.flip(inc, [1]), dim=1), [1])
    u_int = torch.cat([from_bed, torch.zeros_like(inc[:, :1])], dim=1)
    return u_int * edge_dyn[:, None]


def advect_thickness_fo(grid: LiGrid, cfg: LiConfig, thickness, u_int, dt,
                        scheme: str = "centered"):
    """Thickness transport with the depth-averaged velocity.

    ref: mpas_li_advection.F. `fo` is the reference's first-order upwind
    branch; `centered` uses the 2nd-order centered edge thickness, which for
    the diffusion-dominated SIA balance is stable under the diffusive CFL
    and ~5x more accurate on Halfar (ref comment mpas_li_sia.F:405-410).
    """
    m = grid.mesh
    # depth-average of the interface velocities per layer, then over layers
    u_layer = 0.5 * (u_int[:, :-1] + u_int[:, 1:])
    ubar = (u_layer * grid.layerSigmaFraction[None, :]).sum(1)

    coe = m.cellsOnEdge
    if scheme == "fo":
        h_edge = torch.where(ubar > 0.0, thickness[coe[:, 0]],
                             thickness[coe[:, 1]])
    else:
        h_edge = 0.5 * (thickness[coe[:, 0]] + thickness[coe[:, 1]])
    flux = ubar * h_edge * m.dvEdge
    div = (m.edgeSignOnCell * flux[m.edgesOnCell]).sum(1) * m.invAreaCell
    return (thickness - dt * div).clamp(min=0.0)


def add_col(x, k, v):
    """x with v added to its column k (x.at[:, k].add(v))."""
    k = k % x.shape[1]
    return torch.cat([x[:, :k], x[:, k:k + 1] + v[:, None], x[:, k + 1:]],
                     dim=1)


def thermal_solve(grid: LiGrid, cfg: LiConfig, thickness, temperature, dt):
    """Implicit vertical temperature diffusion per column.

    ref: mpas_li_thermal.F (temperature branch): conduction through the
    column, Dirichlet surface-air temperature at the top, geothermal flux at
    the bed; batched Thomas solve (columns stay shard-local, SURVEY §5.7).
    """
    rho_c = cfg.rho_ice * cfg.ice_specific_heat
    kappa = cfg.ice_conductivity
    h = thickness.clamp(min=10.0)[:, None]                 # avoid /0
    dz = h * grid.layerSigmaFraction[None, :]              # (nC, nz)

    # interface conductances between layer midpoints
    dz_mid = 0.5 * (dz[:, :-1] + dz[:, 1:])
    g_int = kappa / dz_mid                                 # (nC, nz-1)
    g_surf = kappa / (0.5 * dz[:, 0])

    alpha = dt / (rho_c * dz)
    zero = torch.zeros_like(g_surf)[:, None]
    a = torch.cat([zero, -alpha[:, 1:] * g_int], dim=1)
    c = torch.cat([-alpha[:, :-1] * g_int, zero], dim=1)
    b = 1.0 - a - c
    b = add_col(b, 0, alpha[:, 0] * g_surf)
    d = add_col(temperature, 0, alpha[:, 0] * g_surf
                * cfg.config_surface_air_temperature)
    d = add_col(d, -1, alpha[:, -1] * cfg.config_geothermal_flux)
    t_new = tridiagonal_solve(a, b, c, d)
    # pressure-melting cap
    t_new = t_new.clamp(max=273.15)
    return torch.where(thickness[:, None] > 1.0, t_new, temperature)


def calve(grid: LiGrid, cfg: LiConfig, thickness, calving_flux,
          u_int=None, dt=None):
    """ref: mpas_li_calving.F li_calve_ice dispatch (:198-276); the
    eigencalving/topographic variants live in calving.py."""
    if cfg.config_calving == "none":
        return thickness, calving_flux
    if cfg.config_calving == "topographic_threshold":
        from mpas_tpu_torch.cores.landice.calving import topographic_calving
        return topographic_calving(
            grid, cfg, thickness, calving_flux,
            bed_threshold=cfg.config_calving_topography)
    if cfg.config_calving == "eigencalving":
        from mpas_tpu_torch.cores.landice.calving import eigencalving
        u_mean = u_int.mean(1) if u_int is not None else \
            torch.zeros(grid.mesh.nEdges, dtype=thickness.dtype,
                        device=thickness.device)
        return eigencalving(grid, cfg, thickness, u_mean, dt,
                            calving_flux,
                            k_eigen=cfg.config_calving_eigencalving_k)
    floating = (cfg.rho_ice * thickness
                < -cfg.rho_seawater * grid.bedTopography.clamp(max=0.0))
    if cfg.config_calving == "floating":
        remove = floating
    else:  # thickness_threshold
        remove = floating & (thickness < cfg.config_calving_thickness)
    new_h = torch.where(remove, torch.zeros_like(thickness), thickness)
    return new_h, calving_flux + (thickness - new_h)


def fe_step(grid: LiGrid, cfg: LiConfig, state: LiState, dt,
            xch=None, owned=None, group=None, resid_out=None) -> LiState:
    """One forward-Euler step (ref: li_time_integrator_forwardeuler,
    mpas_li_time_integration_fe.F). xch/owned/group: the sharded hooks of
    the FO Stokes velocity solve (the SIA branch needs none). resid_out:
    see fo_velocity. Its parts are the spans li.velocity, li.advection,
    li.thermal and li.calving."""
    with span("li.velocity"):
        if cfg.config_velocity_solver == "FO":
            u_int = fo_velocity(grid, cfg, state.thickness,
                                state.temperature, xch=xch, owned=owned,
                                group=group, resid_out=resid_out)
        else:
            u_int = sia_velocity(grid, cfg, state.thickness,
                                 state.temperature)
    t = state.temperature
    with span("li.advection"):
        if cfg.config_thickness_advection == "incremental_remapping":
            from mpas_tpu_torch.cores.landice.advection_ir import (
                advect_thickness_ir)
            h, t = advect_thickness_ir(grid, cfg, state.thickness, t,
                                       u_int, dt)
        else:
            h = advect_thickness_fo(grid, cfg, state.thickness, u_int, dt,
                                    scheme=cfg.config_thickness_advection)
    out = state
    with span("li.thermal"):
        if cfg.config_thermal_solver == "temperature":
            t = thermal_solve(grid, cfg, h, t, dt)
        elif cfg.config_thermal_solver == "enthalpy":
            from mpas_tpu_torch.cores.landice.thermal_enthalpy import (
                thermal_solve_enthalpy)
            t, w, bmr = thermal_solve_enthalpy(grid, cfg, h, t,
                                               state.waterFrac, dt)
            out = dataclasses.replace(out, waterFrac=w, basalMeltRate=bmr)
    with span("li.calving"):
        h, cf = calve(grid, cfg, h, state.calvingFlux, u_int=u_int, dt=dt)
    return dataclasses.replace(out, thickness=h, temperature=t,
                               normalVelocity=u_int, calvingFlux=cf)


def with_polythermal(cfg: LiConfig, state: LiState) -> LiState:
    """The state with its enthalpy-solver carry materialised (zeros)
    where cfg runs that solver and the state lacks it."""
    if cfg.config_thermal_solver == "enthalpy" and state.waterFrac is None:
        return dataclasses.replace(
            state, waterFrac=torch.zeros_like(state.temperature),
            basalMeltRate=torch.zeros_like(state.thickness))
    return state


def run_steps(grid: LiGrid, cfg: LiConfig, state: LiState,
              n_steps: int) -> LiState:
    """n_steps of fe_step at cfg.config_dt."""
    state = with_polythermal(cfg, state)
    for _ in range(n_steps):
        state = fe_step(grid, cfg, state, float(cfg.config_dt))
    return state


def total_volume(grid: LiGrid, state: LiState):
    """Domain ice volume (m^3), a 0-d tensor."""
    return (state.thickness * grid.mesh.areaCell).sum()
