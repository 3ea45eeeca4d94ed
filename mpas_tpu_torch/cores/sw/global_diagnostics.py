"""Global (domain-integrated) shallow-water diagnostics (port of
mpas_tpu/cores/sw/global_diagnostics.py).

ref: src/core_sw/mpas_sw_global_diagnostics.F:23 (total mass, energies,
potential enstrophy and CFL). They are computed in float64 whatever the
state's dtype, so a float32 run's budgets carry no float32 rounding of
their own, and returned as Python floats.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import gravity
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.ops import stencils as st


def global_diagnostics(mesh: Mesh, state: SWState, h_s, dt):
    f64 = torch.float64
    mesh = mesh.to(state.u.device, f64)
    u, h, h_s = state.u.to(f64), state.h.to(f64), h_s.to(f64)
    ke_cell = st.kinetic_energy_cell(mesh, u)
    vorticity = st.edge_curl(mesh, u)
    h_vertex = st.cell_to_vertex_kite(mesh, h)
    pv = (mesh.fVertex + vorticity) / h_vertex

    def total(x):
        return float(x.sum())

    area = mesh.areaCell
    kinetic = total(h * ke_cell * area)
    potential = total(0.5 * gravity * ((h + h_s) ** 2 - h_s ** 2) * area)
    return {
        "total_mass": total(h * area),
        "kinetic_energy": kinetic,
        "potential_energy": potential,
        "total_energy": kinetic + potential,
        "potential_enstrophy": total(0.5 * mesh.areaTriangle * h_vertex
                                     * pv * pv),
        "max_cfl": float((u.abs() * dt * mesh.invDcEdge).max()),
    }
