"""EVP sea-ice velocity solver, weak and variational discretizations
(port of mpas_tpu/cores/seaice/velocity.py).

ref: src/core_seaice/shared/mpas_seaice_velocity_solver.F (driver:
seaice_run_velocity_solver :495, elastic subcycle :2326-2485, momentum
solve solve_velocity :2593), mpas_seaice_velocity_solver_weak.F (strain
:239, stress divergence :521),
mpas_seaice_velocity_solver_constitutive_relation.F (EVP stress
relaxation :150-215).

The elastic subcycle is a Python loop of config_elastic_subcycle_number x
config_dynamics_subcycle_number iterations (the reference's `lax.scan`)
over gather stencils: strains at cells (or cell corners), EVP stress
relaxation (elementwise), stress divergence at vertices, and a closed-form
2x2 momentum solve with semi-implicit water drag and Coriolis. Nothing in
the loop reads the device back. What does not change across subcycles
(the variational integral columns, the drag's constant factor, the
Coriolis sign, the masks) is computed once before it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.state import (SeaiceForcing, SeaiceGrid,
                                               SeaiceState)
from mpas_tpu_torch.cores.seaice.variational import (
    strain_tensor_variational, stress_divergence_variational,
    vertex_integral_columns)
from mpas_tpu_torch.ops import stencils as st

# ref: mpas_seaice_velocity_solver_constitutive_relation.F:29-34
_ECCENTRICITY2 = 4.0
_DAMPING_PARAM = 0.36
# Bouillon et al. (2013) revised-EVP parameters
# (ref: mpas_seaice_velocity_solver_constitutive_relation.F:43-45)
_DAMPING_RATIO_DENOM = 0.86   # Se > 0.5
_DAMPING_RATIO = 5.5e-3       # xi = Sv/Sc < 1


def aggregate_state(cfg: SeaiceConfig, state: SeaiceState):
    """Sum the ITD over categories. ref: aggregate_mass_and_area
    (mpas_seaice_velocity_solver.F:610)."""
    ice_area = state.iceAreaCategory.sum(-1).clamp(0.0, 1.0)
    ice_vol = state.iceVolumeCategory.sum(-1)
    snow_vol = state.snowVolumeCategory.sum(-1)
    total_mass = cfg.rho_ice * ice_vol + cfg.rho_snow * snow_vol
    return ice_area, ice_vol, snow_vol, total_mass


def ice_strength(cfg: SeaiceConfig, ice_area, ice_vol):
    """Hibler (1979) strength P = P* v exp(-C*(1-a)).
    ref: ice_strength (mpas_seaice_velocity_solver.F:1263)."""
    return (cfg.ice_strength_pstar * ice_vol
            * torch.exp(-cfg.ice_strength_cstar * (1.0 - ice_area)))


def strain_tensor_weak(grid: SeaiceGrid, u_v, v_v, solve_stress):
    """Cell-centred strain rates by Green's theorem over the polygon.
    ref: seaice_strain_tensor_weak (mpas_seaice_velocity_solver_weak.F:239).
    """
    m = grid.mesh
    voe = m.verticesOnEdge
    u_edge = 0.5 * (u_v[voe[:, 0]] + u_v[voe[:, 1]])
    v_edge = 0.5 * (v_v[voe[:, 0]] + v_v[voe[:, 1]])

    eoc = m.edgesOnCell
    ue = u_edge[eoc]
    ve = v_edge[eoc]
    dv = m.dvEdge[eoc] * (m.edgeSignOnCell != 0)
    nE = grid.normalPolygonE
    nN = grid.normalPolygonN
    inv_a = m.invAreaCell

    e11 = (ue * nE * dv).sum(1) * inv_a
    e22 = (ve * nN * dv).sum(1) * inv_a
    e12 = 0.5 * ((ue * nN + ve * nE) * dv).sum(1) * inv_a

    # spherical metric terms, ref weak strain :373-375 (zero on the plane)
    u_c = st.vertex_to_cell_kite(m, u_v)
    v_c = st.vertex_to_cell_kite(m, v_v)
    e11 = e11 - v_c * grid.tanLatCellOverR
    e12 = e12 + 0.5 * u_c * grid.tanLatCellOverR

    msk = solve_stress
    return e11 * msk, e22 * msk, e12 * msk


def _relax(s11, s22, s12, e11, e22, e12, pressure, puny, rate, denom):
    """The stress relaxation both EVP variants share, for a relaxation
    factor pcoef = P/delta * rate and a denominator."""
    div = e11 + e22
    ten = e11 - e22
    shr = 2.0 * e12
    s1 = s11 + s22
    s2 = s11 - s22

    delta = torch.sqrt(div * div + (ten * ten + shr * shr) / _ECCENTRICITY2)
    pcoef = pressure / delta.clamp(min=puny)
    replacement_pressure = pcoef * delta
    pcoef = rate(pcoef)

    s1 = (s1 + pcoef * (div - delta)) / denom
    s2 = (s2 + (pcoef / _ECCENTRICITY2) * ten) / denom
    s12 = (s12 + (pcoef / _ECCENTRICITY2) * shr * 0.5) / denom
    return 0.5 * (s1 + s2), 0.5 * (s1 - s2), s12, replacement_pressure


def evp_constitutive(cfg: SeaiceConfig, s11, s22, s12, e11, e22, e12,
                     pressure, dt_elastic, damping_timescale):
    """One EVP stress relaxation step.
    ref: seaice_evp_constitutive_relation
    (mpas_seaice_velocity_solver_constitutive_relation.F:150-215)."""
    return _relax(s11, s22, s12, e11, e22, e12, pressure, cfg.puny,
                  lambda p: p * dt_elastic / (2.0 * damping_timescale),
                  1.0 + 0.5 * dt_elastic / damping_timescale)


def evp_constitutive_revised(cfg: SeaiceConfig, s11, s22, s12,
                             e11, e22, e12, pressure):
    """Revised-EVP stress relaxation (Bouillon et al. 2013): the fixed
    damping-ratio pair in place of dt_elastic/dampingTimescale, so that
    the pseudo-elastic waves decay by construction.
    ref: seaice_evp_constitutive_relation_revised
    (mpas_seaice_velocity_solver_constitutive_relation.F:230-294)."""
    return _relax(s11, s22, s12, e11, e22, e12, pressure, cfg.puny,
                  lambda p: p * 2.0 * _DAMPING_RATIO / _DAMPING_RATIO_DENOM,
                  1.0 + 2.0 * _DAMPING_RATIO / _DAMPING_RATIO_DENOM)


def stress_divergence_weak(grid: SeaiceGrid, s11, s22, s12, solve_velocity):
    """Vertex stress divergence: line integral around the dual triangle.
    ref: seaice_stress_divergence_weak
    (mpas_seaice_velocity_solver_weak.F:521)."""
    m = grid.mesh
    coe = m.cellsOnEdge
    # one-sided at boundary edges: the pad slot of cellsOnEdge points at
    # entity 0, whose stress must not leak into the line integral
    bnd = m.boundaryEdge > 0

    def edge_avg(f):
        f0 = f[coe[:, 0]]
        return torch.where(bnd, f0, 0.5 * (f0 + f[coe[:, 1]]))

    s11e = edge_avg(s11)
    s22e = edge_avg(s22)
    s12e = edge_avg(s12)

    eov = m.edgesOnVertex
    dc = m.dcEdge[eov] * (m.edgeSignOnVertex != 0)
    nE = grid.normalTriangleE
    nN = grid.normalTriangleN
    inv_a = m.invAreaTriangle

    div_u = ((s11e[eov] * nE + s12e[eov] * nN) * dc).sum(1) * inv_a
    div_v = ((s22e[eov] * nN + s12e[eov] * nE) * dc).sum(1) * inv_a

    # spherical metric terms, ref weak stress divergence :661-665
    s11v = st.cell_to_vertex_kite(m, s11)
    s22v = st.cell_to_vertex_kite(m, s22)
    s12v = st.cell_to_vertex_kite(m, s12)
    div_u = div_u - 2.0 * s12v * grid.tanLatVertexOverR
    div_v = div_v + (s11v - s22v) * grid.tanLatVertexOverR

    return div_u * solve_velocity, div_v * solve_velocity


def air_stress(cfg: SeaiceConfig, grid: SeaiceGrid, forcing: SeaiceForcing,
               ice_area_vertex):
    """Quadratic wind drag, cell -> vertex.
    ref: air_stress (mpas_seaice_velocity_solver.F:1444)."""
    m = grid.mesh
    ua, va = forcing.uAirVelocity, forcing.vAirVelocity
    speed = torch.sqrt(ua * ua + va * va)
    coef = cfg.rho_air * cfg.air_drag * speed
    ca, sa = math.cos(cfg.air_turning_angle), math.sin(cfg.air_turning_angle)
    tau_u = coef * (ua * ca - va * sa)
    tau_v = coef * (va * ca + ua * sa)
    return (st.cell_to_vertex_kite(m, tau_u) * ice_area_vertex,
            st.cell_to_vertex_kite(m, tau_v) * ice_area_vertex)


def solve_velocities(grid: SeaiceGrid, cfg: SeaiceConfig,
                     state: SeaiceState, forcing: SeaiceForcing, dt,
                     xch=None):
    """Full EVP solve for one dynamics step; returns the state with new
    velocities and stresses, and the diagnostic divergence, shear and ice
    pressure. ref: seaice_run_velocity_solver
    (mpas_seaice_velocity_solver.F:495).

    xch: optional sharded-exchange hooks: the elastic subcycle refreshes
    the vertex velocities at depth 2 every iteration (the reference
    exchanges uVelocity/vVelocity each elastic subcycle,
    mpas_seaice_velocity_solver.F:2326-2485)."""
    vx = (lambda x, depth=None: x) if xch is None else xch.vertex
    m = grid.mesh
    n_sub = cfg.config_elastic_subcycle_number
    dt_dyn = dt / cfg.config_dynamics_subcycle_number
    dt_e = dt_dyn / n_sub
    damping = _DAMPING_PARAM * dt_dyn

    ice_area, ice_vol, _, total_mass = aggregate_state(cfg, state)
    pressure = ice_strength(cfg, ice_area, ice_vol)

    mass_v = st.cell_to_vertex_kite(m, total_mass)
    area_v = st.cell_to_vertex_kite(m, ice_area)
    solve_stress = (ice_area > cfg.puny).to(ice_area.dtype)
    solve_vel = ((mass_v > cfg.puny) & (area_v > 0.001)
                 ).to(mass_v.dtype) * grid.interiorVertex
    moving = solve_vel > 0

    if cfg.config_use_air_stress:
        tau_au, tau_av = air_stress(cfg, grid, forcing, area_v)
    else:
        tau_au = tau_av = torch.zeros_like(mass_v)

    uo = st.cell_to_vertex_kite(m, forcing.uOceanVelocity)
    vo = st.cell_to_vertex_kite(m, forcing.vOceanVelocity)

    f_v = m.fVertex if cfg.config_use_coriolis else torch.zeros_like(mass_v)
    mass_f = mass_v * f_v

    # surface tilt force: -m g grad(ssh) (ref: surface_tilt_ssh_gradient
    # :1946); the forcing carries grad(ssh) premultiplied by -g
    if cfg.config_use_surface_tilt:
        tilt_u = mass_v * forcing.sshGradientU
        tilt_v = mass_v * forcing.sshGradientV
    else:
        tilt_u = tilt_v = torch.zeros_like(mass_v)

    co, so = (math.cos(cfg.ocean_turning_angle),
              math.sin(cfg.ocean_turning_angle))
    mass_safe = mass_v.clamp(min=cfg.puny)
    # the semi-implicit water drag's factor before the current speed (ref:
    # ocean_stress_coefficient :2499) and the Coriolis sign
    drag0 = cfg.ocean_drag * cfg.rho_seawater * area_v
    fsgn = torch.sign(mass_f)

    use_var = cfg.config_stress_divergence_scheme == "variational"
    if use_var and grid.variational is None:
        raise ValueError("variational scheme requires "
                         "make_grid(mesh, variational=True)")

    revised = cfg.config_revised_evp
    if revised:
        # numerical inertia coefficient brlx (ref: seaice_init_evp,
        # constitutive_relation.F:128-131); dvEdgeMin is the grid-build
        # global minimum (the dmpar_min analogue)
        if grid.dvEdgeMin is None:
            raise ValueError("config_revised_evp requires grid.dvEdgeMin "
                             "(rebuild the grid with make_grid)")
        gamma = 0.25 * 1.0e11 * dt_dyn
        brlx = (2.0 * _DAMPING_RATIO_DENOM * _DAMPING_RATIO * gamma) \
            / grid.dvEdgeMin ** 2
        u_init = state.uVelocity
        v_init = state.vVelocity

    if use_var:
        coeffs = grid.variational
        columns = vertex_integral_columns(coeffs)
        msk = solve_stress[:, None]
        p_corner = pressure[:, None]
        # corner stresses restart each dynamics solve (ref:
        # init_subcycle_variables zeroes stress11var etc. :2149)
        zc = torch.zeros((m.nCells, m.maxEdges), dtype=pressure.dtype,
                         device=pressure.device)
        u, v, s11, s22, s12 = (state.uVelocity, state.vVelocity, zc, zc, zc)
    else:
        u, v, s11, s22, s12 = (state.uVelocity, state.vVelocity,
                               state.stress11, state.stress22,
                               state.stress12)

    for _ in range(n_sub * cfg.config_dynamics_subcycle_number):
        # depth 2 restores the two rings (vertex -> cell strains ->
        # vertex divergence) each body consumes
        u = vx(u, 2)
        v = vx(v, 2)

        if use_var:
            # strains/stresses live at cell corners (ref:
            # seaice_internal_stress_variational)
            e11, e22, e12 = strain_tensor_variational(m, coeffs, u, v)
            if revised:
                s11, s22, s12, _rp = evp_constitutive_revised(
                    cfg, s11, s22, s12, e11 * msk, e22 * msk, e12 * msk,
                    p_corner)
            else:
                s11, s22, s12, _rp = evp_constitutive(
                    cfg, s11, s22, s12, e11 * msk, e22 * msk, e12 * msk,
                    p_corner, dt_e, damping)
            div_u, div_v = stress_divergence_variational(
                m, coeffs, s11, s22, s12, columns)
            div_u = div_u * solve_vel
            div_v = div_v * solve_vel
        else:
            e11, e22, e12 = strain_tensor_weak(grid, u, v, solve_stress)
            if revised:
                s11, s22, s12, _rp = evp_constitutive_revised(
                    cfg, s11, s22, s12, e11, e22, e12, pressure)
            else:
                s11, s22, s12, _rp = evp_constitutive(
                    cfg, s11, s22, s12, e11, e22, e12, pressure, dt_e,
                    damping)
            div_u, div_v = stress_divergence_weak(grid, s11, s22, s12,
                                                  solve_vel)

        # semi-implicit water drag coefficient (uses the *current*
        # velocity)
        if cfg.config_use_ocean_stress:
            w_coef = drag0 * torch.sqrt((uo - u) ** 2 + (vo - v) ** 2)
        else:
            w_coef = torch.zeros_like(u)

        # 2x2 per-vertex implicit solve (ref: solve_velocity :2593;
        # revised variant solve_velocity_revised :2721: numerical-inertia
        # relaxation toward the dynamics-step-initial velocity)
        if revised:
            a_diag = (brlx + 1.0) * mass_safe / dt_dyn + w_coef * co
            rhs_inert_u = mass_safe * (brlx * u + u_init) / dt_dyn
            rhs_inert_v = mass_safe * (brlx * v + v_init) / dt_dyn
        else:
            a_diag = mass_safe / dt_e + w_coef * co
            rhs_inert_u = mass_safe * u / dt_e
            rhs_inert_v = mass_safe * v / dt_e
        a11 = a_diag
        a12 = -mass_f - w_coef * so * fsgn
        a21 = mass_f + w_coef * so * fsgn
        a22 = a_diag
        rhs_u = (div_u + tau_au + tilt_u + w_coef * (uo * co - vo * so)
                 + rhs_inert_u)
        rhs_v = (div_v + tau_av + tilt_v + w_coef * (vo * co + uo * so)
                 + rhs_inert_v)
        det = a11 * a22 - a12 * a21
        u_new = (a22 * rhs_u - a12 * rhs_v) / det
        v_new = (a11 * rhs_v - a21 * rhs_u) / det
        u = torch.where(moving, u_new, 0.0)
        v = torch.where(moving, v_new, 0.0)

    # final diagnostic divergence/shear of the velocity field
    # (ref: final_divergence_shear :2893)
    e11, e22, e12 = strain_tensor_weak(grid, u, v, solve_stress)
    divergence = e11 + e22
    shear = torch.sqrt((e11 - e22) ** 2 + 4.0 * e12 * e12)

    if use_var:
        # persisted cell-mean stresses for diagnostics/IO
        nrm = 1.0 / (m.edgeSignOnCell != 0).sum(1).clamp(min=1).to(
            s11.dtype)
        s11c = s11.sum(1) * nrm
        s22c = s22.sum(1) * nrm
        s12c = s12.sum(1) * nrm
    else:
        s11c, s22c, s12c = s11, s22, s12

    return dataclasses.replace(
        state, uVelocity=u, vVelocity=v, stress11=s11c, stress22=s22c,
        stress12=s12c), {"divergence": divergence, "shear": shear,
                         "icePressure": pressure}


def principal_stresses(cfg: SeaiceConfig, s11, s22, s12, pressure):
    """Principal stresses normalized by the ice strength (for the
    elliptical-yield-curve diagnostic). ref: principal_stresses
    (mpas_seaice_velocity_solver.F:3066-3109)."""
    mean = 0.5 * (s11 + s22)
    rad = torch.sqrt((0.5 * (s11 - s22)) ** 2 + s12 * s12)
    pn = pressure.clamp(min=cfg.puny)
    has = pressure > cfg.puny
    return (torch.where(has, (mean + rad) / pn, math.nan),
            torch.where(has, (mean - rad) / pn, math.nan))
