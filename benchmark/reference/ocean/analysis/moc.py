# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/moc.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Meridional overturning circulation (MOC) streamfunction member (port
of mpas_tpu/cores/ocean/analysis/moc.py).

ref: src/core_ocean/analysis_members/mpas_ocn_moc_streamfunction.F:
psi(lat_bin, z) = -sum_{k' >= k} T(y, k'), with T(y, k) the net
northward transport through the bin boundary at layer k; per-region
streamfunctions restrict the edges to a region's cell mask (the
regionCellMasks machinery, :128-144).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ocean.analysis.meridional_heat_transport import (
    _bin_signs, _device_tensor, _lat_or_y)


class MocStreamfunction:
    """n_bins: latitude bins; regions: optional {name: (nCells,) cell
    mask}, each reported as its own psi(lat, z)."""

    def __init__(self, n_bins: int = 12, regions: dict | None = None):
        self.n_bins = n_bins
        self.regions = regions or {}

    def init(self, grid, cfg):
        m = grid.mesh
        yc = _lat_or_y(m)
        edges = np.linspace(yc.min() - 1e-9, yc.max() + 1e-9,
                            self.n_bins + 1)
        inner = edges[1:-1]
        self._boundaries = _device_tensor(inner, m.areaCell)
        self._sign = _device_tensor(_bin_signs(m, yc, inner), m.areaCell)
        self._region_signs = {
            name: _device_tensor(_bin_signs(m, yc, inner, mask), m.areaCell)
            for name, mask in self.regions.items()}

    @staticmethod
    def _psi(sign, t_edge):
        t_bin = torch.einsum("eb,ek->bk", sign, t_edge)
        return -torch.flip(torch.cumsum(torch.flip(t_bin, [1]), 1), [1])

    def compute(self, grid, cfg, state):
        m = grid.mesh
        c1, c2 = m.cellsOnEdge[:, 0], m.cellsOnEdge[:, 1]
        h_edge = 0.5 * (state.layerThickness[c1] + state.layerThickness[c2])
        t_edge = state.u * h_edge * m.dvEdge[:, None]   # m3/s per layer
        out = {"binBoundaryMocStreamfunction": self._boundaries,
               "mocStreamvalLatAndDepth":
                   self._psi(self._sign, t_edge) / 1.0e6}    # Sv
        for name, sign in self._region_signs.items():
            out[f"mocStreamvalLatAndDepthRegion_{name}"] = \
                self._psi(sign, t_edge) / 1.0e6
        return out
