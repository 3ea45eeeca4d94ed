"""The default shallow-water RK stage (port of mpas_tpu/cores/sw/fused.py).

The same numbers as dynamics.solve_diagnostics + compute_tend +
compute_scalar_tend (ref: mpas_sw_time_integration.F:360-1395) with only
the diagnostics the tendencies read, and the tangential velocity of the
APVM upwinding cell-assembled: each stage launches K2 twice, the
tangential operator at K = 1 and the TRiSK q pair at K = 2.
"""

from __future__ import annotations

from mpas_tpu_torch.constants import gravity
from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.ops import stencils as st


def stage_tendencies(mesh: Mesh, cfg: SWConfig, state: SWState, dt, h_s):
    """(tend_u, tend_h, tend_coupled_tracers) for one RK stage."""
    u, h, tr = state.u, state.h, state.tracers
    apvm = cfg.config_apvm_upwinding
    visc2 = cfg.config_h_mom_eddy_visc2

    # thickness and tracer fluxes at edges, their divergence at cells
    uhe = u * st.cell_to_edge_mean(mesh, h)
    tend_h = -st.edge_divergence(mesh, uhe)
    tend_ct = -st.edge_divergence(
        mesh, uhe[:, None] * st.cell_to_edge_mean(mesh, tr))
    ke = st.kinetic_energy_cell(mesh, u)

    # potential vorticity at vertices, APVM-upwinded to edges
    vorticity = st.edge_curl(mesh, u)
    pv_vertex = (mesh.fVertex + vorticity) / st.cell_to_vertex_kite(mesh, h)
    v_t = st.tangential_cell_assembled(mesh, u)
    pv_edge = st.vertex_to_edge_mean(mesh, pv_vertex) \
        - apvm * v_t * dt * st.vertex_gradient_t(mesh, pv_vertex)
    pv_cell = st.vertex_to_cell_kite(mesh, pv_vertex)
    pv_edge = pv_edge - apvm * u * dt * st.cell_gradient_n(mesh, pv_cell)

    # momentum: the PV flux q minus the Bernoulli gradient [+ del2]
    tend_u = st.trisk_q_cell_assembled(mesh, uhe, pv_edge) \
        - st.cell_gradient_n(mesh, ke + gravity * (h + h_s))
    if visc2 > 0.0:
        divergence = st.edge_divergence(mesh, u)
        tend_u = tend_u + mesh.meshScalingDel2 * visc2 * (
            st.cell_gradient_n(mesh, divergence)
            - st.vertex_gradient_t(mesh, vorticity))
    return tend_u * (1.0 - mesh.boundaryEdge), tend_h, tend_ct
