"""Ocean biogeochemistry tracer tendencies (port of
mpas_tpu/cores/ocean/bgc.py).

ref capability: src/core_ocean/shared/mpas_ocn_tracer_ecosys.F +
mpas_ocn_tracer_DMS.F + mpas_ocn_tracer_MacroMolecules.F: the reference
couples the MARBL/ecosys library through per-tracer interior tendencies
and surface gas-exchange fluxes, evaluated operator-split in the tracer
update. The same coupling surface with self-contained models:

- NPZD (+ DMS): nutrient, phytoplankton, zooplankton, detritus, with
  light-limited Michaelis-Menten uptake under self-shading, Holling II
  grazing, mortalities, detritus sinking and remineralization, and DMS
  ventilation at the surface;
- the 8-pool ecosys group (NO3, SiO3, Fe, small phyto, diatoms, zoo,
  sinking PON and opal) with N/Si/Fe co-limitation;
- the DIC/ALK carbon pools with the air-sea CO2 flux of carbonate.py.

Every step returns a new state; the caller's tracers are not changed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mpas_tpu_torch.cores.ocean.carbonate import air_sea_co2_flux
from mpas_tpu_torch.framework.timers import spanned


def _pos(x):
    return torch.clamp(x, min=0.0)


def _light(h, sw_surface, kw, kc, biomass):
    """Light at layer mid-depths under water and self-shading
    attenuation."""
    tau = (kw + kc * biomass) * h
    cum = torch.cumsum(tau, dim=-1) - 0.5 * tau
    return sw_surface[:, None] * torch.exp(-cum)


def _set_tracers(tr, index0, cols):
    """tr with tracers index0 .. index0 + len(cols) - 1 (last axis)
    replaced by the fields `cols` (a new tensor)."""
    return torch.cat([tr[..., :index0], torch.stack(cols, -1),
                      tr[..., index0 + len(cols):]], -1)


class BgcParams(NamedTuple):
    mu_max: float = 2.0 / 86400.0      # max phyto growth (1/s)
    k_n: float = 0.5                   # nutrient half-saturation (mmol/m3)
    alpha_light: float = 0.04          # light-limitation slope (1/(W/m2))
    kw: float = 0.04                   # water light attenuation (1/m)
    kc: float = 0.03                   # self-shading (1/m per mmol/m3)
    graze_max: float = 1.0 / 86400.0   # max grazing (1/s)
    k_p: float = 1.0                   # grazing half-saturation
    assim: float = 0.7                 # zooplankton assimilation
    m_p: float = 0.05 / 86400.0        # phyto linear mortality
    m_z: float = 0.2 / 86400.0         # zoo quadratic mortality (1/s per X)
    remin: float = 0.1 / 86400.0       # detritus remineralization
    w_sink: float = 5.0 / 86400.0      # detritus sinking (m/s)
    dms_yield: float = 0.02            # DMS produced per grazing loss
    dms_decay: float = 1.0 / (3.0 * 86400.0)
    piston_dms: float = 3.0e-5         # surface ventilation (m/s)


def bgc_tendencies(h, sw_surface, n, p_phy, z, d, params: BgcParams,
                   dms=None):
    """Interior NPZD(+DMS) tendencies per second. h (nC, nz); sw_surface
    (nC,) W/m2; tracers (nC, nz) mmol/m3. Returns (dN, dP, dZ, dD[,
    dDMS])."""
    pr = params
    light = _light(h, sw_surface, pr.kw, pr.kc, _pos(p_phy))
    f_light = 1.0 - torch.exp(-pr.alpha_light * _pos(light))
    f_nut = _pos(n) / (pr.k_n + _pos(n))
    growth = pr.mu_max * f_light * f_nut * _pos(p_phy)
    graze = pr.graze_max * _pos(p_phy) / (pr.k_p + _pos(p_phy)) * _pos(z)
    mort_p = pr.m_p * _pos(p_phy)
    mort_z = pr.m_z * _pos(z) ** 2
    remin = pr.remin * _pos(d)

    dn = -growth + remin
    dp = growth - graze - mort_p
    dz = pr.assim * graze - mort_z
    dd = (1.0 - pr.assim) * graze + mort_p + mort_z - remin
    out = (dn, dp, dz, dd)
    if dms is not None:
        ddms = pr.dms_yield * graze - pr.dms_decay * _pos(dms)
        vent = pr.piston_dms * _pos(dms[:, 0]) / h[:, 0]
        ddms = torch.cat([(ddms[:, 0] - vent)[:, None], ddms[:, 1:]], 1)
        out = out + (ddms,)
    return out


def sink_detritus(d, h, w_sink, dt):
    """Upstream sinking of detritus; k = 0 is the surface, and what
    leaves the bottom layer is removed (export to sediment)."""
    cfl = torch.clamp(w_sink * dt / h, max=0.9)
    out = d * cfl
    inflow = torch.cat([torch.zeros_like(d[:, :1]), (out * h)[:, :-1]],
                       -1) / h
    return d - out + inflow


def bgc_step(state, grid, dt, sw_surface, params: BgcParams = BgcParams(),
             index0: int = 2, with_dms: bool = False):
    """Operator-split NPZD update of tracers index0 .. index0+3 (+4 with
    DMS) = (N, P, Z, D[, DMS])."""
    tr = state.tracers
    h = state.layerThickness
    n, p_phy, z, d = (tr[..., index0 + i] for i in range(4))
    dms = tr[..., index0 + 4] if with_dms else None
    tends = bgc_tendencies(h, sw_surface, n, p_phy, z, d, params, dms=dms)
    new = [_pos(x + dt * t) for x, t in zip((n, p_phy, z, d), tends)]
    new[3] = sink_detritus(new[3], h, params.w_sink, dt)
    if with_dms:
        new.append(_pos(dms + dt * tends[4]))
    return dataclasses.replace(state, tracers=_set_tracers(tr, index0, new))


class EcosysParams(NamedTuple):
    """Pools (mmol N/m3 except SiO3 mmol Si/m3 and Fe mmol Fe/m3): NO3,
    SiO3, Fe, spN (small phyto), diatN (diatoms), zooN, detN (sinking
    PON), detSi (sinking biogenic opal)."""
    mu_sp: float = 2.0 / 86400.0       # small-phyto max growth (1/s)
    mu_diat: float = 2.5 / 86400.0     # diatom max growth
    k_no3_sp: float = 0.25             # half saturations
    k_no3_diat: float = 0.8
    k_sio3: float = 1.0
    k_fe_sp: float = 6e-5
    k_fe_diat: float = 1.5e-4
    alpha_light: float = 0.04
    kw: float = 0.04
    kc: float = 0.03
    graze_sp: float = 1.2 / 86400.0    # grazing on small phyto
    graze_diat: float = 0.7 / 86400.0  # diatoms grazed more slowly
    k_graze: float = 1.0
    assim: float = 0.7
    m_p: float = 0.05 / 86400.0
    m_z: float = 0.2 / 86400.0
    remin_n: float = 0.1 / 86400.0
    remin_si: float = 0.03 / 86400.0   # opal dissolves more slowly
    r_si_n: float = 1.0                # diatom Si:N uptake ratio
    r_fe_n: float = 3e-5               # Fe:N ratio of all biomass
    fe_scav: float = 1.0 / (180.0 * 86400.0)  # scavenging of free Fe
    w_sink_n: float = 8.0 / 86400.0
    w_sink_si: float = 30.0 / 86400.0


def ecosys_tendencies(h, sw_surface, tr8, params: EcosysParams):
    """Interior tendencies of the 8 pools; tr8 (nC, nz, 8) in the
    EcosysParams order. Total N (NO3 + sp + diat + zoo + detN) and total Si
    (SiO3 + r_si_n diat + detSi) have zero interior tendency; Fe loses
    only to scavenging."""
    pr = params
    no3, sio3, fe, sp, diat, zoo, detn, detsi = tr8.unbind(-1)
    light = _light(h, sw_surface, pr.kw, pr.kc, _pos(sp) + _pos(diat))
    f_light = 1.0 - torch.exp(-pr.alpha_light * _pos(light))

    # Liebig co-limitation
    lim_sp = torch.minimum(_pos(no3) / (pr.k_no3_sp + _pos(no3)),
                           _pos(fe) / (pr.k_fe_sp + _pos(fe)))
    lim_diat = torch.minimum(
        torch.minimum(_pos(no3) / (pr.k_no3_diat + _pos(no3)),
                      _pos(sio3) / (pr.k_sio3 + _pos(sio3))),
        _pos(fe) / (pr.k_fe_diat + _pos(fe)))
    grow_sp = pr.mu_sp * f_light * lim_sp * _pos(sp)
    grow_diat = pr.mu_diat * f_light * lim_diat * _pos(diat)

    gr_sp = pr.graze_sp * _pos(sp) / (pr.k_graze + _pos(sp)) * _pos(zoo)
    gr_diat = pr.graze_diat * _pos(diat) / (pr.k_graze + _pos(diat)) \
        * _pos(zoo)
    mort_sp = pr.m_p * _pos(sp)
    mort_diat = pr.m_p * _pos(diat)
    mort_z = pr.m_z * _pos(zoo) ** 2
    remin_n = pr.remin_n * _pos(detn)
    remin_si = pr.remin_si * _pos(detsi)

    d_no3 = -(grow_sp + grow_diat) + remin_n
    d_sp = grow_sp - gr_sp - mort_sp
    d_diat = grow_diat - gr_diat - mort_diat
    d_zoo = pr.assim * (gr_sp + gr_diat) - mort_z
    d_detn = (1.0 - pr.assim) * (gr_sp + gr_diat) \
        + mort_sp + mort_diat + mort_z - remin_n
    # silicon: diatom uptake, opal from diatom losses, dissolution
    d_sio3 = -pr.r_si_n * grow_diat + remin_si
    d_detsi = pr.r_si_n * (gr_diat + mort_diat) - remin_si
    # iron rides the N pools at r_fe_n; scavenging is the one sink
    d_fe = pr.r_fe_n * (remin_n - grow_sp - grow_diat) \
        - pr.fe_scav * _pos(fe)
    return torch.stack([d_no3, d_sio3, d_fe, d_sp, d_diat, d_zoo,
                        d_detn, d_detsi], dim=-1)


@spanned("ocn.bgc")
def ecosys_step(state, grid, dt, sw_surface,
                params: EcosysParams = EcosysParams(), index0: int = 2):
    """Operator-split ecosys update of tracers index0 .. index0+7, with
    sinking of the two particulate pools."""
    tr = state.tracers
    h = state.layerThickness
    tr8 = tr[..., index0:index0 + 8]
    tr8 = _pos(tr8 + dt * ecosys_tendencies(h, sw_surface, tr8, params))
    pools = list(tr8.unbind(-1))
    pools[6] = sink_detritus(pools[6], h, params.w_sink_n, dt)
    pools[7] = sink_detritus(pools[7], h, params.w_sink_si, dt)
    return dataclasses.replace(state,
                               tracers=_set_tracers(tr, index0, pools))


@spanned("ocn.bgc")
def carbon_step(state, grid, dt, t_c, s, wind10, index_dic: int,
                index_alk: int, pco2_atm_uatm: float = 420.0,
                ice_frac=0.0):
    """DIC update from the air-sea CO2 exchange into the top layer (ref:
    the ecosys carbonate/gas-exchange block). t_c, s: surface temperature
    (C) and salinity, (nC,); wind10 (nC,) m/s; DIC and ALK in mol/kg at
    index_dic/index_alk. Returns (state, {pco2Surface, phSurface,
    co2Flux})."""
    tr = state.tracers
    h_top = state.layerThickness[:, 0]
    dic = tr[:, 0, index_dic]
    alk = tr[:, 0, index_alk]
    flux, pco2, ph = air_sea_co2_flux(dic, alk, t_c, s, wind10,
                                      pco2_atm_uatm=pco2_atm_uatm,
                                      ice_frac=ice_frac)
    # mol/m2/s into mol/kg of the top layer (rho0 ~ 1030 kg/m3)
    d_dic = flux * dt / (1030.0 * torch.clamp(h_top, min=0.1))
    top = _set_tracers(tr[:, 0], index_dic, [dic + d_dic])
    tr = torch.cat([top[:, None], tr[:, 1:]], 1)
    return dataclasses.replace(state, tracers=tr), {
        "pco2Surface": pco2, "phSurface": ph, "co2Flux": flux}
