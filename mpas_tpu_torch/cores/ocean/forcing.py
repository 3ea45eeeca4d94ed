"""Ocean surface forcing terms (port of mpas_tpu/cores/ocean/forcing.py).

ref: src/core_ocean/shared tendency-term modules:
  wind stress       mpas_ocn_vel_forcing_surface_stress.F (stress on the
                    top layer)
  surface restoring mpas_ocn_tracer_surface_restoring.F (piston-velocity
                    relaxation of SST/SSS toward climatology)
  shortwave         mpas_ocn_tracer_short_wave_absorption.F (Jerlov
                    two-band exponential transmission)
  surface fluxes    mpas_ocn_tracer_surface_flux.F (heat/freshwater into
                    the top layer)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mpas_tpu_torch.containers import to_device

_CP_SW = 3996.0          # seawater specific heat (ref: ocn constants)

# Jerlov water type IB coefficients (ref: short_wave_absorption defaults)
_JERLOV_R = 0.67
_JERLOV_D1 = 1.0         # m
_JERLOV_D2 = 17.0        # m


@dataclasses.dataclass(frozen=True)
class OcnSurfaceForcing:
    windStressZonal: Any        # (nCells,) N/m2
    windStressMeridional: Any   # (nCells,)
    sensibleHeatFlux: Any       # (nCells,) W/m2 positive into ocean
    shortwaveFlux: Any          # (nCells,) W/m2
    freshwaterFlux: Any         # (nCells,) kg/m2/s (P-E+R)
    sstRestore: Any             # (nCells,) deg C
    sssRestore: Any             # (nCells,)
    # the bulk-forcing decomposition (ref: the forcing pool consumed by
    # mpas_ocn_surface_area_weighted_averages.F); each (nCells,), None
    # where the run does not force that component
    latentHeatFlux: Any = None
    longWaveHeatFluxUp: Any = None
    longWaveHeatFluxDown: Any = None
    seaIceHeatFlux: Any = None
    evaporationFlux: Any = None
    seaIceFreshWaterFlux: Any = None
    riverRunoffFlux: Any = None
    iceRunoffFlux: Any = None
    rainFlux: Any = None
    snowFlux: Any = None
    seaIceEnergy: Any = None
    seaIceSalinityFlux: Any = None
    seaSurfacePressure: Any = None

    def to(self, device, dtype) -> "OcnSurfaceForcing":
        return to_device(self, device, dtype)


def zero_forcing(n_cells, dtype=torch.float64, device=None):
    z = torch.zeros((n_cells,), dtype=dtype, device=device)
    return OcnSurfaceForcing(windStressZonal=z, windStressMeridional=z,
                             sensibleHeatFlux=z, shortwaveFlux=z,
                             freshwaterFlux=z, sstRestore=z, sssRestore=z)


def surface_stress_tend(grid, cfg, forcing: OcnSurfaceForcing, h):
    """Velocity tendency from wind stress on the top layer.
    ref: ocn_vel_forcing_surface_stress_tend: tend_u(1) +=
    stress_n / (rho0 * h_top) at edges."""
    m = grid.mesh
    coe = m.cellsOnEdge
    ne = torch.cos(m.angleEdge)
    nn = torch.sin(m.angleEdge)
    tx = 0.5 * (forcing.windStressZonal[coe[:, 0]]
                + forcing.windStressZonal[coe[:, 1]])
    ty = 0.5 * (forcing.windStressMeridional[coe[:, 0]]
                + forcing.windStressMeridional[coe[:, 1]])
    stress_n = (tx * ne + ty * nn) * (1.0 - m.boundaryEdge)
    h_top = 0.5 * (h[coe[:, 0], 0] + h[coe[:, 1], 0])
    tend = torch.zeros((m.nEdges, grid.nz), dtype=h.dtype, device=h.device)
    tend[:, 0] = stress_n / (cfg.config_density0
                             * torch.clamp(h_top, min=1e-3))
    return tend


def shortwave_heating(cfg, forcing: OcnSurfaceForcing, h):
    """Thickness-weighted temperature tendency (K m/s) per layer from the
    Jerlov two-band transmission. ref:
    ocn_tracer_short_wave_absorption_jerlov_tend."""
    z_top = torch.cumsum(h, dim=-1) - h                # depth of layer tops
    z_bot = torch.cumsum(h, dim=-1)

    def trans(z):
        return (_JERLOV_R * torch.exp(-z / _JERLOV_D1)
                + (1.0 - _JERLOV_R) * torch.exp(-z / _JERLOV_D2))

    absorbed = trans(z_top) - trans(z_bot)             # fraction per layer
    q = forcing.shortwaveFlux[:, None] * absorbed      # W/m2 per layer
    return q / (cfg.config_density0 * _CP_SW)          # K m/s


def surface_tracer_tend(grid, cfg, forcing: OcnSurfaceForcing, h, tr,
                        piston_velocity: float = 4.0e-5,
                        salinity_piston: float = 4.0e-6):
    """Thickness-weighted tracer tendencies (nCells, nz, nT): surface heat
    flux + shortwave profile + piston-velocity restoring.
    ref: ocn_tracer_surface_flux_tend + surface_restoring_tend."""
    nT = tr.shape[-1]
    tend = torch.zeros_like(tr)
    # sensible/latent/longwave into the top layer
    tend[:, 0, 0] += forcing.sensibleHeatFlux / (cfg.config_density0
                                                 * _CP_SW)
    # penetrating shortwave over the column
    tend[..., 0] += shortwave_heating(cfg, forcing, h)
    # restoring (piston velocity w_p: flux = w_p (X_restore - X_surface))
    tend[:, 0, 0] += piston_velocity * (forcing.sstRestore - tr[:, 0, 0])
    if nT > 1:
        tend[:, 0, 1] += salinity_piston * (forcing.sssRestore
                                            - tr[:, 0, 1])
        # freshwater flux dilutes surface salinity: d(hS)/dt = -S FW/rho_fw
        tend[:, 0, 1] += -tr[:, 0, 1] * forcing.freshwaterFlux / 1000.0
    return tend
