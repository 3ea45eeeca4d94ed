# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/global_stats.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
# The sharded statistics are left out: the copy holds one shard only.
"""Global statistics analysis member (port of
mpas_tpu/cores/ocean/analysis/global_stats.py).

ref: src/core_ocean/analysis_members/mpas_ocn_global_stats.F: global
min / max / sum / rms / area- or volume-weighted mean of every field of
the state, plus vertical-sum extremes (:117-1579). The sweep covers every
tensor field of OcnState (found through the dataclass), then the derived
ssh, kinetic energy, density and CFL number. The results are 0-d tensors
on the state's device.

With a ShardGroup (and its ShardedMesh), every reduction runs over owned
entities only, through parallel.runner's psum_owned / pmin_owned /
pmax_owned: the reference's dmpar reductions.
"""

from __future__ import annotations

import dataclasses

from benchmark.reference.ocean.core import equation_of_state

_TRACER_NAMES = ["temperature", "salinity", "tracer3", "tracer4",
                 "tracer5", "tracer6", "tracer7", "tracer8"]


class GlobalStats:
    """The unsharded statistics (the benchmark's copy holds no shards)."""

    def init(self, grid, cfg):
        pass

    def _sum(self, x, kind):
        return x.sum()

    def _max(self, x, kind):
        return x.max()

    def _min(self, x, kind):
        return x.min()

    def _field_stats(self, out, name, f, weight, wsum, kind):
        """min/max/sum/avg/rms (+ vertical-sum extremes of 3-D fields)."""
        out[f"{name}GlobalMin"] = self._min(f, kind)
        out[f"{name}GlobalMax"] = self._max(f, kind)
        out[f"{name}GlobalSum"] = self._sum(f * weight, kind)
        out[f"{name}GlobalAvg"] = out[f"{name}GlobalSum"] / wsum
        out[f"{name}GlobalRms"] = (self._sum(f * f * weight, kind)
                                   / wsum).sqrt()
        if f.dim() >= 2 and f.shape[-1] > 1:
            vs = f.sum(1)
            out[f"{name}VertSumMin"] = self._min(vs, kind)
            out[f"{name}VertSumMax"] = self._max(vs, kind)

    def compute(self, grid, cfg, state):
        m = grid.mesh
        area = m.areaCell[:, None]
        h = state.layerThickness
        vol = h * area
        total_vol = self._sum(vol, "cell")
        total_area = self._sum(m.areaCell, "cell")
        out = {}

        for fdef in dataclasses.fields(state):
            f = getattr(state, fdef.name)
            if f is None:
                continue
            if fdef.name == "tracers":
                for i in range(f.shape[-1]):
                    nm = _TRACER_NAMES[i] if i < len(_TRACER_NAMES) \
                        else f"tracer{i+1}"
                    self._field_stats(out, nm, f[..., i], vol, total_vol,
                                      "cell")
                continue
            if f.shape[0] == m.nCells:
                kind = "cell"
                w, ws = (vol, total_vol) if f.dim() >= 2 \
                    else (m.areaCell, total_area)
            elif f.shape[0] == m.nEdges:
                # edge fields weighted by the edge area dv*dc/2
                kind = "edge"
                ae = 0.5 * m.dvEdge * m.dcEdge
                w = ae[:, None] if f.dim() >= 2 else ae
                ws = self._sum(ae, "edge") * (f.shape[-1] if f.dim() >= 2
                                              else 1.0)
            else:
                kind, w, ws = None, 1.0, float(f.numel())
            self._field_stats(out, fdef.name, f, w, ws, kind)

        out["volumeCellGlobal"] = total_vol
        out["normalVelocityGlobalMax"] = self._max(state.u.abs(), "edge")
        ssh = h.sum(-1) - grid.bottomDepth
        self._field_stats(out, "ssh", ssh, m.areaCell, total_area, "cell")
        ke = (m.keW[..., None] * (state.u * state.u)[m.edgesOnCell]).sum(1) \
            * m.invAreaCell[:, None]
        out["kineticEnergyGlobal"] = self._sum(ke * vol, "cell")
        out["kineticEnergyCellMax"] = self._max(ke, "cell")
        rho = equation_of_state(cfg, state.tracers[..., 0],
                                state.tracers[..., 1])
        self._field_stats(out, "density", rho, vol, total_vol, "cell")
        out["CFLNumberGlobal"] = self._max(
            state.u.abs() * (cfg.config_dt * m.invDcEdge[:, None]), "edge")
        return out
