# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/zonal_mean.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Zonal-mean analysis member (port of
mpas_tpu/cores/ocean/analysis/zonal_mean.py).

ref: src/core_ocean/analysis_members/mpas_ocn_zonal_mean.F: cells binned
into latitude (or y) bands, tracers and thickness averaged per band and
level. The binning is a one-hot (nCells, nBins) matrix built once.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.ocean.analysis.meridional_heat_transport import (
    _device_tensor, _lat_or_y)


def band_onehot(mesh, n_bins):
    """(onehot (nCells, nBins), bin centres), host numpy: equal bands of
    latitude (or y) over the cells' range."""
    y = _lat_or_y(mesh)
    edges = np.linspace(y.min() - 1e-9, y.max() + 1e-9, n_bins + 1)
    which = np.clip(np.searchsorted(edges, y) - 1, 0, n_bins - 1)
    onehot = np.zeros((len(y), n_bins))
    onehot[np.arange(len(y)), which] = 1.0
    return onehot, 0.5 * (edges[:-1] + edges[1:])


class ZonalMean:
    n_bins: int = 16

    def init(self, grid, cfg):
        onehot, centers = band_onehot(grid.mesh, self.n_bins)
        like = grid.mesh.areaCell
        self._onehot = _device_tensor(onehot, like)
        self._bin_centers = _device_tensor(centers, like)

    def compute(self, grid, cfg, state):
        w = self._onehot * grid.mesh.areaCell[:, None]    # (nCells, nBins)
        wsum = w.sum(0).clamp(min=1e-30)               # empty bins -> 0

        def zmean(f):                                  # (nC, nz) -> (nB, nz)
            return (w.T @ f) / wsum[:, None]

        out = {"binCenters": self._bin_centers,
               "zonalMeanThickness": zmean(state.layerThickness)}
        names = ["temperature", "salinity"]
        for i in range(min(state.tracers.shape[-1], len(names))):
            out[f"zonalMean{names[i].capitalize()}"] = \
                zmean(state.tracers[..., i])
        return out
