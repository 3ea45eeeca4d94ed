"""Land-ice (ice-shelf) to ocean flux coupling (port of
mpas_tpu/cores/ocean/land_ice_flux.py).

ref: src/core_ocean/shared/mpas_ocn_surface_land_ice_fluxes.F (tracer,
velocity and thickness flux assembly :81-341; melt rates :357+) with the
ISOMIP three-equation melt parameterization
(config_land_ice_flux_mode = 'standalone'):

  T_b = lam1 S_b + lam2 + lam3 p_b                       (freezing point)
  rho cp gammaT (T_o - T_b) = m L + m cp_i (T_b - T_i)   (heat balance)
  m S_b = gammaS rho (S_o - S_b)                         (salt balance)

solved per cavity cell for (T_b, S_b, m); the heat, salt and freshwater
fluxes enter the top layer of the sub-shelf column and the melt adds to
its thickness. Elementwise per cell; the cavity is landIceDraft < 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

# freezing-point coefficients (ref: the linear ISOMIP freezing law)
LAM1 = -0.0573        # deg C / (g/kg)
LAM2 = 0.0832         # deg C
LAM3 = -7.53e-8       # deg C / Pa
LATENT_HEAT = 3.34e5  # J/kg
CP_OCEAN = 3974.0     # J/kg/K
CP_ICE = 2009.0
RHO0 = 1026.0
GAMMA_T = 1.0e-4      # m/s (ref config_land_ice_flux_ISOMIP_gammaT)
GAMMA_S = GAMMA_T / 35.0
T_ICE = -20.0         # deg C interior shelf temperature


class LandIceFluxes(NamedTuple):
    melt_rate: Any        # (nCells,) m/s of freshwater (positive = melt)
    heat_flux: Any        # (nCells,) W/m2 into the ocean (negative cools)
    freshwater_flux: Any  # (nCells,) kg/m2/s into the ocean
    salt_flux: Any        # (nCells,) (g/kg)(kg/m2/s) virtual salt flux
    t_boundary: Any       # (nCells,) deg C at the interface
    s_boundary: Any       # (nCells,)


def three_equation_melt(t_ocean, s_ocean, land_ice_pressure, cavity_mask):
    """The three-equation system per cavity cell. With the linear
    freezing law it reduces to a quadratic in S_b, of which the physical
    root is taken (ref: the standalone solve, :357+); the latent term
    uses T_b ~ tf(S_o) (the ISOMIP simplification)."""
    tf_const = LAM2 + LAM3 * land_ice_pressure
    ct = RHO0 * CP_OCEAN * GAMMA_T
    cs = RHO0 * GAMMA_S
    l_eff = LATENT_HEAT + CP_ICE * (LAM1 * s_ocean + tf_const - T_ICE)
    a2 = -ct * LAM1
    a1 = ct * (t_ocean - tf_const) + cs * l_eff
    a0 = -cs * l_eff * s_ocean
    disc = torch.clamp(a1 * a1 - 4.0 * a2 * a0, min=0.0)
    # a2 = -ct * LAM1 is a positive constant: the quadratic branch of the
    # reference's select (|a2| > 1e-12) always applies
    s_b = (-a1 + torch.sqrt(disc)) / (2.0 * a2 + 1e-30)
    s_b = torch.clamp(s_b, 1.0, 60.0)
    t_b = LAM1 * s_b + tf_const
    zero = torch.zeros_like(s_b)
    melt = torch.where(cavity_mask, cs * (s_ocean - s_b)
                       / torch.clamp(s_b, min=1.0), zero)       # kg/m2/s
    t_b = torch.where(cavity_mask, t_b, zero)
    s_b = torch.where(cavity_mask, s_b, s_ocean)
    return LandIceFluxes(melt_rate=melt / RHO0, heat_flux=-melt * l_eff,
                         freshwater_flux=melt, salt_flux=-melt * s_b,
                         t_boundary=t_b, s_boundary=s_b)


def apply_land_ice_fluxes(grid, cfg, state, land_ice_pressure,
                          land_ice_draft, dt):
    """Apply the melt fluxes to the top (sub-shelf) layer's T, S and
    thickness (ref: ocn_surface_land_ice_fluxes_{active_tracers,thick}):
    meltwater enters at the interface temperature without salt, and the
    interfacial heat flux cools the blended layer. Returns (state',
    LandIceFluxes)."""
    cavity = land_ice_draft < -1.0e-3
    t_o = state.tracers[:, 0, 0]
    s_o = state.tracers[:, 0, 1]
    fx = three_equation_melt(t_o, s_o, land_ice_pressure, cavity)
    h_top = state.layerThickness[:, 0]
    dh = dt * fx.freshwater_flux / RHO0      # meltwater layer added (m)
    h_new = h_top + dh
    t_new = (t_o * h_top + fx.t_boundary * dh) / h_new \
        + dt * fx.heat_flux / (RHO0 * CP_OCEAN * h_new)
    s_new = s_o * h_top / h_new
    top = torch.stack([t_new, s_new], -1)[:, None]
    tr = torch.cat([torch.cat([top, state.tracers[:, :1, 2:]], -1),
                    state.tracers[:, 1:]], 1)
    h = torch.cat([h_new[:, None], state.layerThickness[:, 1:]], 1)
    return dataclasses.replace(state, tracers=tr, layerThickness=h), fx
