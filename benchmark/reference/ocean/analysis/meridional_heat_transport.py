# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/meridional_heat_transport.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Meridional heat transport analysis member (port of
mpas_tpu/cores/ocean/analysis/meridional_heat_transport.py).

ref: src/core_ocean/analysis_members/mpas_ocn_meridional_heat_transport.F:
heat transport through latitude (or y) bin boundaries, the sum over the
edges crossing each boundary of rho0 cp u h T_edge dvEdge.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.containers import to_host

_CP = 3996.0          # ref: seawater specific heat (mpas_ocn_constants)


def _bin_signs(mesh, yc, inner, cell_mask=None):
    """(nEdges, nInner) +1 where the edge's normal (cell 1 -> cell 2)
    crosses the boundary northward, -1 southward; edges with a cell
    outside `cell_mask` are excluded. Host numpy."""
    coe = to_host(mesh.cellsOnEdge)
    y1, y2 = yc[coe[:, 0]], yc[coe[:, 1]]
    crosses_n = (y1[:, None] < inner) & (y2[:, None] >= inner)
    crosses_s = (y2[:, None] < inner) & (y1[:, None] >= inner)
    sign = crosses_n.astype(np.float64) - crosses_s.astype(np.float64)
    if cell_mask is not None:
        cm = np.asarray(cell_mask).astype(bool)
        sign = sign * (cm[coe[:, 0]] & cm[coe[:, 1]])[:, None]
    return sign


def _lat_or_y(mesh, where="Cell"):
    return to_host(getattr(mesh, ("lat" if mesh.on_sphere else "y")
                           + where))


def _device_tensor(a, like):
    return torch.as_tensor(a).to(like.device, like.dtype)


class MeridionalHeatTransport:
    n_bins: int = 12

    def init(self, grid, cfg):
        m = grid.mesh
        yc = _lat_or_y(m)
        edges = np.linspace(yc.min() - 1e-9, yc.max() + 1e-9,
                            self.n_bins + 1)
        self._boundaries = _device_tensor(edges[1:-1], m.areaCell)
        self._sign = _device_tensor(_bin_signs(m, yc, edges[1:-1]),
                                    m.areaCell)

    def compute(self, grid, cfg, state):
        m = grid.mesh
        c1, c2 = m.cellsOnEdge[:, 0], m.cellsOnEdge[:, 1]
        h_edge = 0.5 * (state.layerThickness[c1] + state.layerThickness[c2])
        t_edge = 0.5 * (state.tracers[c1, :, 0] + state.tracers[c2, :, 0])
        # column-integrated heat flux through each edge (W per edge)
        q_edge = cfg.config_density0 * _CP * (
            state.u * h_edge * t_edge).sum(-1) * m.dvEdge
        return {"binBoundaryMerHeatTrans": self._boundaries,
                "meridionalHeatTransportLat": self._sign.T @ q_edge}
