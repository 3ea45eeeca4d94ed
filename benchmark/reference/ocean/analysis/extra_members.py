# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/extra_members.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Twelve more analysis members (port of
mpas_tpu/cores/ocean/analysis/extra_members.py), after
src/core_ocean/analysis_members/:

  eddyProductVariables        <- mpas_ocn_eddy_product_variables.F
  waterMassCensus             <- mpas_ocn_water_mass_census.F
  transectTransport           <- mpas_ocn_transect_transport.F
  highFrequencyOutput         <- mpas_ocn_high_frequency_output.F
  surfaceAreaWeightedAverages <- mpas_ocn_surface_area_weighted_averages.F
  pointwiseStats              <- mpas_ocn_pointwise_stats.F
  debugDiagnostics            <- mpas_ocn_debug_diagnostics.F
  timeFilters                 <- mpas_ocn_time_filters.F
  regionalStats               <- mpas_ocn_regional_stats.F
  rpnCalculator               <- mpas_ocn_rpn_calculator.F
  eliassenPalm                <- mpas_ocn_eliassen_palm.F
  testComputeInterval         <- mpas_ocn_test_compute_interval.F

Each member has init(grid, cfg) and compute(grid, cfg, state) -> dict,
the driver contract of analysis/__init__.py. Host work (masks, bins,
index lists, reconstruction weights) happens once in init; compute
returns tensors on the state's device and reads nothing back.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.containers import to_host
from benchmark.reference.ocean.analysis.meridional_heat_transport import (
    _device_tensor, _lat_or_y)
from benchmark.reference.ocean.analysis.zonal_mean import band_onehot
from benchmark.reference.ocean.core import equation_of_state
from benchmark.reference.ops.reconstruct import (build_reconstruct_coeffs,
                                            reconstruct)


def _ssh(grid, state):
    h = state.layerThickness
    if grid.cellMask is not None:
        h = h * grid.cellMask
    return h.sum(-1) - grid.bottomDepth


def reconstruct_coeffs(grid):
    """The cell-centre reconstruction weights of grid.mesh on its device
    and dtype (built on the host)."""
    return _device_tensor(build_reconstruct_coeffs(grid.mesh),
                          grid.mesh.areaCell)


def _cell_velocity(grid, state, coeffs):
    """Cell-centred (zonal, meridional) velocity from the edge normals
    (ops/reconstruct)."""
    _, _, _, uzonal, umerid = reconstruct(grid.mesh, coeffs, state.u)
    return uzonal, umerid


def _hist2d(x, y, weights, x_edges, y_edges):
    """np.histogram2d(x, y, (x_edges, y_edges), weights=weights)[0] on
    the tensors' device: bins closed on the left, the last also on the
    right; values outside the edges are dropped."""
    nx, ny = x_edges.numel() - 1, y_edges.numel() - 1

    def index(v, edges, n):
        i = torch.bucketize(v.contiguous(), edges, right=True) - 1
        return torch.where(v == edges[-1], n - 1, i)

    ix, iy = index(x, x_edges, nx), index(y, y_edges, ny)
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    flat = torch.where(inside, ix * ny + iy, nx * ny)    # nx*ny: dropped
    out = torch.zeros(nx * ny + 1, dtype=weights.dtype,
                      device=weights.device)
    return out.index_add(0, flat, weights)[:-1].reshape(nx, ny)


class EddyProductVariables:
    """Products whose time means minus the products of the time means
    give eddy covariances (ref: velocityZonal^2, u*v, u*T, SSH^2 ...)."""

    def init(self, grid, cfg):
        self._coeffs = reconstruct_coeffs(grid)

    def compute(self, grid, cfg, state):
        uz, um = _cell_velocity(grid, state, self._coeffs)
        T = state.tracers[..., 0]
        ssh = _ssh(grid, state)
        return {"uu": uz * uz, "vv": um * um, "uv": uz * um,
                "uT": uz * T, "vT": um * T, "ssh2": ssh * ssh}


class WaterMassCensus:
    """T/S-binned water-mass census (ref: mpas_ocn_water_mass_census.F;
    Registry_water_mass_census.xml): bin centres, the fractional volume
    distribution, the volume-weighted density and mean z of every T-S
    bin, globally and per region of `region_masks`."""
    t_edges = np.linspace(-2.0, 30.0, 17)
    s_edges = np.linspace(32.0, 37.0, 11)
    region_masks = None          # {name: bool (nCells,)}; None = halves

    def init(self, grid, cfg):
        if self.region_masks is None:
            yc = _lat_or_y(grid.mesh)
            mid = 0.5 * (yc.min() + yc.max())
            self.region_masks = {"south": yc < mid, "north": yc >= mid}
        like = grid.mesh.areaCell
        self._t_edges = _device_tensor(self.t_edges, like)
        self._s_edges = _device_tensor(self.s_edges, like)
        self._masks = {name: _device_tensor(np.asarray(m, np.float64), like)
                       for name, m in self.region_masks.items()}
        self._tc = _device_tensor(0.5 * (self.t_edges[:-1]
                                         + self.t_edges[1:]), like)
        self._sc = _device_tensor(0.5 * (self.s_edges[:-1]
                                         + self.s_edges[1:]), like)

    def _census(self, grid, state, cell_mask):
        h = state.layerThickness
        mask = grid.cellMask if grid.cellMask is not None \
            else torch.ones_like(h)
        if cell_mask is not None:
            mask = mask * cell_mask[:, None]
        vol = (h * mask * grid.mesh.areaCell[:, None]).reshape(-1)
        T = state.tracers[..., 0].reshape(-1)
        S = state.tracers[..., 1].reshape(-1)
        zmid = -(torch.cumsum(h, 1) - 0.5 * h).reshape(-1)
        # a sigma-0 label per bin (the census needs only a consistent one)
        sigma = (-0.2 * T + 0.8 * S) + 1000.0 - 1000.0
        census = _hist2d(T, S, vol, self._t_edges, self._s_edges)
        rho_sum = _hist2d(T, S, vol * sigma, self._t_edges, self._s_edges)
        z_sum = _hist2d(T, S, vol * zmid, self._t_edges, self._s_edges)
        tot = census.sum().clamp(min=1e-30)
        filled = census > 0
        denom = census.clamp(min=1e-30)
        zero = torch.zeros_like(census)
        return (census / tot, torch.where(filled, rho_sum / denom, zero),
                torch.where(filled, z_sum / denom, zero))

    def compute(self, grid, cfg, state):
        frac, rho_bin, z_bin = self._census(grid, state, None)
        out = {"waterMassCensusTemperatureValues": self._tc,
               "waterMassCensusSalinityValues": self._sc,
               "waterMassFractionalDistribution": frac,
               "potentialDensityOfTSDiagram": rho_bin,
               "zPositionOfTSDiagram": z_bin,
               "regionNames": list(self.region_masks)}
        per_region = [self._census(grid, state, m)
                      for m in self._masks.values()]
        out["waterMassCensusTemperatureValuesRegion"] = self._tc
        out["waterMassCensusSalinityValuesRegion"] = self._sc
        for i, name in enumerate(("waterMassFractionalDistributionRegion",
                                  "potentialDensityOfTSDiagramRegion",
                                  "zPositionOfTSDiagramRegion")):
            out[name] = torch.stack([r[i] for r in per_region])
        return out


class TransectTransport:
    """Volume transport (Sv) through the transect of edges crossed by the
    y (plane) or latitude (sphere) line through the domain's middle,
    positive toward +y / north (ref: mpas_ocn_transect_transport.F)."""

    def init(self, grid, cfg):
        mesh = grid.mesh
        coe = to_host(mesh.cellsOnEdge)
        yc = _lat_or_y(mesh)
        y0 = 0.5 * (yc.min() + yc.max())
        y1, y2 = yc[coe[:, 0]], yc[coe[:, 1]]
        crosses = ((y1 - y0) * (y2 - y0) < 0.0) \
            & (to_host(mesh.boundaryEdge) == 0)
        edge_ids = np.where(crosses)[0]
        self.n_edges = len(edge_ids)
        self._edges = torch.as_tensor(edge_ids).to(mesh.areaCell.device)
        self._sign = _device_tensor(np.sign(y2 - y1)[edge_ids],
                                    mesh.areaCell)

    def compute(self, grid, cfg, state):
        e = self._edges
        c1 = grid.mesh.cellsOnEdge[e, 0]
        c2 = grid.mesh.cellsOnEdge[e, 1]
        h_e = 0.5 * (state.layerThickness[c1] + state.layerThickness[c2])
        if grid.edgeMask is not None:
            h_e = h_e * grid.edgeMask[e]
        flux = (state.u[e] * h_e).sum(-1) * grid.mesh.dvEdge[e]
        return {"transectTransportSv": (self._sign * flux).sum() / 1e6,
                "nTransectEdges": self.n_edges}


class HighFrequencyOutput:
    """Snapshot fields for high-frequency streams (ref:
    mpas_ocn_high_frequency_output.F: ssh, surface T/S, kinetic
    energy)."""

    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        mesh = grid.mesh
        ke = (mesh.keW[..., None]
              * (state.u * state.u)[mesh.edgesOnCell]).sum(1) \
            * mesh.invAreaCell[:, None]
        return {"ssh": _ssh(grid, state),
                "surfaceTemperature": state.tracers[:, 0, 0],
                "surfaceSalinity": state.tracers[:, 0, 1],
                "kineticEnergyAtSurface": ke[:, 0]}


class SurfaceAreaWeightedAverages:
    """min / max / area-weighted mean of the reference's 30 surface
    fields, and sumSurfaceMaskValue (ref:
    mpas_ocn_surface_area_weighted_averages.F;
    Registry_surface_area_weighted_averages.xml). Forcing components the
    run does not carry enter as zeros."""

    #: the reference's 30-entry field order (Registry :1-96)
    FIELDS = (
        "SurfaceMaskValue", "SurfaceArea", "LatentHeatFlux",
        "SensibleHeatFlux", "LongWaveHeatFluxUp", "LongWaveHeatFluxDown",
        "SeaIceHeatFlux", "ShortWaveHeatFlux", "EvaporationFlux",
        "SeaIceFreshWaterFlux", "RiverRunoffFlux", "IceRunoffFlux",
        "RainFlux", "SnowFlux", "SeaIceEnergy", "SurfaceThicknessFlux",
        "SurfaceTemperatureFlux", "SurfaceSalinityFlux",
        "SeaIceSalinityFlux", "SurfaceWindStressMagnitude",
        "WindStressZonal", "WindStressMeridional", "SeaSurfacePressure",
        "SurfaceSSH", "SurfaceTemperature", "SurfaceSalinity",
        "BoundaryLayerDepth", "SurfaceNetHeatFlux",
        "SurfaceNetSalinitFlux", "SurfaceNetFreshWaterFlux")

    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state, forcing=None):
        mesh = grid.mesh
        zero = torch.zeros_like(mesh.areaCell)

        def fz(name):
            v = getattr(forcing, name, None) if forcing is not None \
                else None
            return zero if v is None else v

        cm = getattr(grid, "cellMask", None)
        mask = torch.ones_like(zero) if cm is None \
            else cm[:, 0] if cm.dim() == 2 else cm
        area = mesh.areaCell
        tx, ty = fz("windStressZonal"), fz("windStressMeridional")
        sens, sw, lat = (fz("sensibleHeatFlux"), fz("shortwaveFlux"),
                         fz("latentHeatFlux"))
        lwu, lwd = fz("longWaveHeatFluxUp"), fz("longWaveHeatFluxDown")
        iceq, evap = fz("seaIceHeatFlux"), fz("evaporationFlux")
        icefw = fz("seaIceFreshWaterFlux")
        riv, icer = fz("riverRunoffFlux"), fz("iceRunoffFlux")
        rain, snow = fz("rainFlux"), fz("snowFlux")
        fw, sisf = fz("freshwaterFlux"), fz("seaIceSalinityFlux")
        bld = getattr(state, "blDepth", None)
        vals = {
            "SurfaceMaskValue": mask,
            "SurfaceArea": area * mask,
            "LatentHeatFlux": lat,
            "SensibleHeatFlux": sens,
            "LongWaveHeatFluxUp": lwu,
            "LongWaveHeatFluxDown": lwd,
            "SeaIceHeatFlux": iceq,
            "ShortWaveHeatFlux": sw,
            "EvaporationFlux": evap,
            "SeaIceFreshWaterFlux": icefw,
            "RiverRunoffFlux": riv,
            "IceRunoffFlux": icer,
            "RainFlux": rain,
            "SnowFlux": snow,
            "SeaIceEnergy": fz("seaIceEnergy"),
            "SurfaceThicknessFlux": fw / 1000.0,
            "SurfaceTemperatureFlux": (sens + sw + lat + lwu + lwd
                                       + iceq) / (1026.0 * 3996.0),
            # the freshwater-equivalent dilution flux
            "SurfaceSalinityFlux": -fw / 1000.0 * state.tracers[:, 0, 1],
            "SeaIceSalinityFlux": sisf,
            "SurfaceWindStressMagnitude": torch.sqrt(tx * tx + ty * ty),
            "WindStressZonal": tx,
            "WindStressMeridional": ty,
            "SeaSurfacePressure": fz("seaSurfacePressure"),
            "SurfaceSSH": _ssh(grid, state),
            "SurfaceTemperature": state.tracers[:, 0, 0],
            "SurfaceSalinity": state.tracers[:, 0, 1],
            "BoundaryLayerDepth": zero if bld is None else bld,
            "SurfaceNetHeatFlux": sens + sw + lat + lwu + lwd + iceq,
            "SurfaceNetSalinitFlux": sisf,
            "SurfaceNetFreshWaterFlux": fw + rain + snow + evap + riv
            + icer + icefw,
        }
        w = area * mask
        tot = w.sum().clamp(min=1e-30)
        live = mask > 0
        out = {"sumSurfaceMaskValue": mask.sum()}
        for name in self.FIELDS:
            f = vals[name]
            out["min" + name] = torch.where(live, f, 1e30).min()
            out["max" + name] = torch.where(live, f, -1e30).max()
            out["avg" + name] = (f * w).sum() / tot
        return out


class PointwiseStats:
    """Field values at selected cells (ref: mpas_ocn_pointwise_stats.F):
    by default 8 cells spread through the index space (which follows the
    space-filling curve, so they spread over the domain)."""
    n_points = 8

    def init(self, grid, cfg):
        cells = np.linspace(0, grid.mesh.nCells - 1,
                            self.n_points).astype(np.int64)
        self.cells = torch.as_tensor(cells).to(grid.mesh.areaCell.device)

    def compute(self, grid, cfg, state):
        return {"cellIndices": self.cells,
                "sshAtPoints": _ssh(grid, state)[self.cells],
                "sstAtPoints": state.tracers[self.cells, 0, 0]}


def _nan_min_max(a):
    """(nanmin, nanmax, NaN count) of a tensor, as numpy's."""
    nan = torch.isnan(a)
    n_nan = nan.sum()
    all_nan = n_nan == a.numel()
    lo = torch.where(nan, torch.inf, a).min()
    hi = torch.where(nan, -torch.inf, a).max()
    return (torch.where(all_nan, torch.nan, lo),
            torch.where(all_nan, torch.nan, hi), n_nan)


class DebugDiagnostics:
    """Min / max / NaN counts of the prognostic state (ref:
    mpas_ocn_debug_diagnostics.F)."""

    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        out = {}
        for name, f in (("u", state.u), ("h", state.layerThickness),
                        ("T", state.tracers[..., 0]),
                        ("S", state.tracers[..., 1])):
            out[f"{name}Min"], out[f"{name}Max"], out[f"{name}NaNs"] = \
                _nan_min_max(f)
        return out


class TimeFilters:
    """Running exponential low-pass of u and SSH (ref:
    mpas_ocn_time_filters.F): each call blends with weight interval/tau,
    so compute() must run every `interval` seconds."""
    tau = 86400.0
    interval = 3600.0

    def init(self, grid, cfg):
        self._u = None
        self._ssh = None

    def compute(self, grid, cfg, state):
        w = min(self.interval / self.tau, 1.0)
        u, ssh = state.u, _ssh(grid, state)
        if self._u is None:
            self._u, self._ssh = u, ssh
        else:
            self._u = (1 - w) * self._u + w * u
            self._ssh = (1 - w) * self._ssh + w * ssh
        return {"uLowPass": self._u.clone(), "sshLowPass": self._ssh.clone()}


class RegionalStats:
    """Per-region min / max / area-weighted mean / std / sum of surface
    and column fields (ref: mpas_ocn_regional_stats.F +
    regional_stats_inc). Default regions: thirds of the domain by y
    (plane) or latitude (sphere); `region_masks` ({name: bool (nCells,)})
    set before init replaces them.

    bottomTemperature and bottomSalinity are taken at level nz - 1, as
    in the reference, not at maxLevelCell - 1 (ROADMAP §3)."""
    region_masks = None
    STATS = ("Min", "Max", "Avg", "Std", "Sum")

    def init(self, grid, cfg):
        if self.region_masks is None:
            yc = _lat_or_y(grid.mesh)
            lo, hi = yc.min(), yc.max()
            t1, t2 = lo + (hi - lo) / 3.0, lo + 2.0 * (hi - lo) / 3.0
            self.region_masks = {"south": yc < t1,
                                 "middle": (yc >= t1) & (yc < t2),
                                 "north": yc >= t2}
        device = grid.mesh.areaCell.device
        self._cells = {name: torch.as_tensor(np.nonzero(m)[0]).to(device)
                       for name, m in self.region_masks.items() if m.any()}

    def compute(self, grid, cfg, state):
        mesh = grid.mesh
        area = mesh.areaCell
        h = state.layerThickness
        ke = (mesh.keW[..., None] * (state.u ** 2)[mesh.edgesOnCell]
              ).sum(1)[:, 0] * mesh.invAreaCell
        fields = {
            "ssh": _ssh(grid, state),
            "surfaceTemperature": state.tracers[:, 0, 0],
            "surfaceSalinity": state.tracers[:, 0, 1],
            "bottomTemperature": state.tracers[:, -1, 0],
            "bottomSalinity": state.tracers[:, -1, 1],
            "columnThickness": h.sum(1),
            "heatContent": (state.tracers[..., 0] * h).sum(1)
            * 1026.0 * 3996.0,
            "surfaceKineticEnergy": ke,
        }
        out = {}
        for rname, cells in self._cells.items():
            a = area[cells]
            w = a / a.sum()
            out[f"{rname}Area"] = a.sum()
            out[f"{rname}NCells"] = cells.numel()
            for fname, f in fields.items():
                fv = f[cells]
                avg = (fv * w).sum()
                out[f"{rname}Min{fname}"] = fv.min()
                out[f"{rname}Max{fname}"] = fv.max()
                out[f"{rname}Avg{fname}"] = avg
                out[f"{rname}Std{fname}"] = (((fv - avg) ** 2) * w).sum() \
                    .sqrt()
                out[f"{rname}Sum{fname}"] = fv.sum()
        return out


class RpnCalculator:
    """Reverse-Polish field calculator (ref: mpas_ocn_rpn_calculator.F +
    rpn_calc_inc) over the fields temperature, salinity, ssh and
    layerThickness, numeric literals, + - * / and the built-in `sigma`
    (EOS density - 1000). Default: temperature salinity sigma."""
    expression = "temperature salinity sigma"

    def init(self, grid, cfg):
        pass

    def _fields(self, grid, cfg, state):
        return {"temperature": state.tracers[..., 0],
                "salinity": state.tracers[..., 1],
                "layerThickness": state.layerThickness,
                "ssh": _ssh(grid, state)}

    def compute(self, grid, cfg, state):
        fields = self._fields(grid, cfg, state)
        ops = {"+": lambda x, y: x + y, "-": lambda x, y: x - y,
               "*": lambda x, y: x * y, "/": lambda x, y: x / y}
        stack = []
        for tok in self.expression.split():
            if tok in fields:
                stack.append(fields[tok])
            elif tok in ops:
                b, a = stack.pop(), stack.pop()
                stack.append(ops[tok](a, b))
            elif tok == "sigma":
                S = stack.pop()
                T = stack.pop()
                stack.append(equation_of_state(cfg, T, S) - 1000.0)
            else:
                stack.append(float(tok))
        if len(stack) != 1:
            raise ValueError(f"rpn expression {self.expression!r} leaves "
                             f"{len(stack)} values on the stack")
        result = stack[0]
        if not isinstance(result, torch.Tensor):      # literals only
            result = torch.full((), result, dtype=grid.mesh.areaCell.dtype,
                                device=grid.mesh.areaCell.device)
        return {"rpnResult": result}


class EliassenPalm:
    """Eliassen-Palm flux diagnostics (ref: mpas_ocn_eliassen_palm.F, the
    thickness-weighted-average eddy flux tensor), in its z-level form:
    zonal-band TWA velocities, the eddy momentum flux u'v', the form-drag
    component h'u' and the band-wise divergence. Bands as ZonalMean's."""
    n_bins: int = 12

    def init(self, grid, cfg):
        onehot, centers = band_onehot(grid.mesh, self.n_bins)
        like = grid.mesh.areaCell
        self._onehot = _device_tensor(onehot, like)
        self._which = torch.as_tensor(np.argmax(onehot, axis=1)).to(
            like.device)
        self._centers = _device_tensor(centers, like)
        self._dy = float(centers[1] - centers[0])
        self._coeffs = reconstruct_coeffs(grid)

    def compute(self, grid, cfg, state):
        h = state.layerThickness
        w = self._onehot * grid.mesh.areaCell[:, None]
        wsum = w.sum(0).clamp(min=1e-30)[:, None]
        ux, vy = _cell_velocity(grid, state, self._coeffs)

        def band(f):                     # area mean per band
            return (w.T @ f) / wsum

        def band_twa(f):                 # thickness-weighted average
            return (w.T @ (f * h)) / (w.T @ h).clamp(min=1e-30)

        u_hat, v_hat, h_bar = band_twa(ux), band_twa(vy), band(h)
        up = ux - u_hat[self._which]
        vp = vy - v_hat[self._which]
        hp = h - h_bar[self._which]
        epfy = band_twa(up * vp)         # meridional eddy momentum flux
        return {"binCenters": self._centers, "uTWA": u_hat, "vTWA": v_hat,
                "epFluxMeridional": epfy, "epFormDrag": band(hp * up),
                "epFluxDivergence": torch.gradient(epfy, dim=0)[0]
                / self._dy}


class TestComputeInterval:
    """Compute-interval self test (ref: mpas_ocn_test_compute_interval.F):
    counts its own invocations, on the device."""

    def init(self, grid, cfg):
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=grid.mesh.areaCell.device)

    def compute(self, grid, cfg, state):
        self.count = self.count + 1
        return {"computeCount": self.count}
