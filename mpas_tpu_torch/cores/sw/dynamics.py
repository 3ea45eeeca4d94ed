"""Shallow-water diagnostics and tendencies, TRiSK C-grid scheme (port of
mpas_tpu/cores/sw/dynamics.py).

ref: src/core_sw/mpas_sw_time_integration.F:953 sw_compute_solve_diagnostics,
:360 sw_compute_tend, :639 sw_compute_scalar_tend. Every scatter loop of
the reference is a destination-side gather (mpas_tpu_torch.ops.stencils).
This generic path is the one the RK stage takes with del4 dissipation or
monotonic transport on; the default stage is fused.py's.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import gravity
from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.cores.sw.state import SWDiagnostics, SWState
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.ops import stencils as st


def solve_diagnostics(mesh: Mesh, cfg: SWConfig, state: SWState, dt: float,
                      h_s) -> SWDiagnostics:
    """All diagnostic fields from (u, h) (ref: :953-1395). h_edge is 2nd
    order (config_thickness_adv_order=2, the reference default)."""
    u, h = state.u, state.h

    h_edge = st.cell_to_edge_mean(mesh, h)
    circulation = st.edge_circulation(mesh, u)
    vorticity = circulation * mesh.invAreaTriangle
    divergence = st.edge_divergence(mesh, u)
    ke = st.kinetic_energy_cell(mesh, u)
    v = st.tangential_velocity(mesh, u)
    h_vertex = st.cell_to_vertex_kite(mesh, h)
    pv_vertex = (mesh.fVertex + vorticity) / h_vertex

    # APVM upwinding of pv_edge (ref: :1295-1326 and :1352-1358)
    gradPVt = st.vertex_gradient_t(mesh, pv_vertex)
    pv_edge = st.vertex_to_edge_mean(mesh, pv_vertex)
    pv_edge = pv_edge - cfg.config_apvm_upwinding * v * dt * gradPVt
    pv_cell = st.vertex_to_cell_kite(mesh, pv_vertex)
    vorticity_cell = st.vertex_to_cell_kite(mesh, vorticity)
    gradPVn = st.cell_gradient_n(mesh, pv_cell)
    pv_edge = pv_edge - cfg.config_apvm_upwinding * u * dt * gradPVn

    return SWDiagnostics(
        v=v, h_edge=h_edge, h_vertex=h_vertex, circulation=circulation,
        vorticity=vorticity, divergence=divergence, ke=ke,
        pv_vertex=pv_vertex, pv_edge=pv_edge, pv_cell=pv_cell,
        vorticity_cell=vorticity_cell, gradPVn=gradPVn, gradPVt=gradPVt)


def _del2_u(mesh: Mesh, divergence, vorticity):
    """grad(div) - k x grad(vort) at edges (ref: :508-517)."""
    return st.cell_gradient_n(mesh, divergence) \
        - st.vertex_gradient_t(mesh, vorticity)


def compute_tend(mesh: Mesh, cfg: SWConfig, state: SWState,
                 diag: SWDiagnostics, h_s, u_src=None):
    """(tend_u, tend_h) (ref: sw_compute_tend, :360-638)."""
    u, h = state.u, state.h

    # thickness: tend_h = -div(h_edge u) (ref: :460-474)
    tend_h = -st.edge_divergence(mesh, u * diag.h_edge)

    # momentum: q - grad(KE + g (h + h_s)) (ref: :477-498), with
    # q(e) = sum_j w_j u_j h_edge_j 0.5 (pv_e + pv_j)
    q = st.trisk_q_cell_assembled(mesh, u * diag.h_edge, diag.pv_edge)
    bernoulli = diag.ke + gravity * (h + h_s)
    tend_u = q - st.cell_gradient_n(mesh, bernoulli)

    # del2 dissipation (ref: :502-520)
    if cfg.config_h_mom_eddy_visc2 > 0.0:
        tend_u = tend_u + mesh.meshScalingDel2 * cfg.config_h_mom_eddy_visc2 \
            * _del2_u(mesh, diag.divergence, diag.vorticity)

    # del4 hyperdissipation: -nu4 del2(del2 u) (ref: :525-617)
    if cfg.config_h_mom_eddy_visc4 > 0.0:
        delsq_u = _del2_u(mesh, diag.divergence, diag.vorticity)
        delsq_vorticity = st.edge_curl(mesh, delsq_u)
        delsq_divergence = st.edge_divergence(mesh, delsq_u)
        tend_u = tend_u - mesh.meshScalingDel4 * cfg.config_h_mom_eddy_visc4 \
            * _del2_u(mesh, delsq_divergence, delsq_vorticity)

    # wind stress and bottom drag, single layer (ref: :620-637)
    if cfg.config_wind_stress and u_src is not None:
        tend_u = tend_u + u_src / 1000.0 / diag.h_edge
    if cfg.config_bottom_drag:
        ke_edge = st.cell_to_edge_mean(mesh, diag.ke)
        tend_u = tend_u - 1.0e-3 * u * torch.sqrt(2.0 * ke_edge) / diag.h_edge

    # boundary edges carry no normal flow (ref: sw_enforce_boundary_edge)
    return tend_u * (1.0 - mesh.boundaryEdge), tend_h


def compute_scalar_tend(mesh: Mesh, cfg: SWConfig, state: SWState,
                        diag: SWDiagnostics, coupled_tracers):
    """Flux-form tracer tendencies of the coupled tracers h*psi (nCells,
    nTracers), 2nd-order centred fluxes (config_tracer_adv_order=2, the
    reference default) (ref: sw_compute_scalar_tend, :639-952)."""
    uh = state.u * diag.h_edge                        # (nEdges,)
    psi = coupled_tracers / state.h[:, None]
    flux = uh[:, None] * st.cell_to_edge_mean(mesh, psi)
    tend = -st.edge_divergence(mesh, flux)

    if cfg.config_h_tracer_eddy_diff2 > 0.0:
        # h_edge-weighted del2 diffusion of the mixing ratios
        # (ref: :800-860)
        gpsi = st.cell_gradient_n(mesh, psi)
        tend = tend + cfg.config_h_tracer_eddy_diff2 * st.edge_divergence(
            mesh, diag.h_edge[:, None] * gpsi)
    return tend
