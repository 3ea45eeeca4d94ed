# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/layer_volume_weighted_average.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Layer-volume-weighted averages analysis member (port of
mpas_tpu/cores/ocean/analysis/layer_volume_weighted_average.py).

ref: src/core_ocean/analysis_members/
mpas_ocn_layer_volume_weighted_averages.F: per-layer volume-weighted
means and min/max of the tracers and thickness over the domain.
"""

from __future__ import annotations


class LayerVolumeWeightedAverage:
    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        area = grid.mesh.areaCell[:, None]
        h = state.layerThickness
        vol = h * area                                  # (nCells, nz)
        vol_layer = vol.sum(0)                          # (nz,)
        out = {"avgLayerThickness": (h * area).sum(0) / area.sum(),
               "layerVolume": vol_layer}
        names = ["temperature", "salinity"]
        for i in range(min(state.tracers.shape[-1], len(names))):
            tr = state.tracers[..., i]
            nm = names[i].capitalize()
            out[f"avgLayer{nm}"] = (tr * vol).sum(0) / vol_layer
            out[f"minLayer{nm}"] = tr.min(0).values
            out[f"maxLayer{nm}"] = tr.max(0).values
        return out
