# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/mixed_layer_depths.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Mixed-layer-depth analysis member (port of
mpas_tpu/cores/ocean/analysis/mixed_layer_depths.py).

ref: src/core_ocean/analysis_members/mpas_ocn_mixed_layer_depths.F:
threshold MLDs, the depth where potential density (or temperature) first
departs from its surface value by more than a threshold, interpolated
linearly between layer midpoints.
"""

from __future__ import annotations

import torch

from benchmark.reference.ocean.core import equation_of_state


class MixedLayerDepths:
    # ref defaults: config_AM_mixedLayerDepths_Dthreshold = 0.03 kg/m3,
    # Tthreshold = 0.2 C
    den_threshold: float = 0.03
    temp_threshold: float = 0.2

    def init(self, grid, cfg):
        pass

    @staticmethod
    def _mld(h, field, threshold, sign=1.0):
        """First depth where sign * (field - field_surface) > threshold,
        the column's depth where it never is."""
        z_mid = torch.cumsum(h, -1) - 0.5 * h               # positive down
        dev = sign * (field - field[:, :1])
        exceeded = dev > threshold                           # (nCells, nz)
        any_exc = exceeded.any(-1)
        idx = torch.where(any_exc, exceeded.to(torch.uint8).argmax(-1),
                          h.shape[-1] - 1)
        iprev = torch.clamp(idx - 1, min=0)
        f1 = dev.gather(1, iprev[:, None])[:, 0]
        f2 = dev.gather(1, idx[:, None])[:, 0]
        z1 = z_mid.gather(1, iprev[:, None])[:, 0]
        z2 = z_mid.gather(1, idx[:, None])[:, 0]
        frac = torch.where((f2 - f1).abs() > 1e-12,
                           (threshold - f1) / (f2 - f1), 1.0)
        mld = z1 + torch.clamp(frac, 0.0, 1.0) * (z2 - z1)
        return torch.where(any_exc, mld, h.sum(-1))

    def compute(self, grid, cfg, state):
        h = state.layerThickness
        t = state.tracers[..., 0]
        rho = equation_of_state(cfg, t, state.tracers[..., 1])
        return {"dThreshMLD": self._mld(h, rho, self.den_threshold, 1.0),
                "tThreshMLD": self._mld(h, t, self.temp_threshold, -1.0)}
