"""Urban canopy physics: SLUCM + BEM building energy + BEP column sources
(port of mpas_tpu/cores/atmosphere/physics/urban.py).

ref capability: physics_wrf/module_sf_urban.F (4,042 LoC — the Kusaka/Chen
single-layer urban canopy model), module_sf_bem.F (2,352 — building energy
model), module_sf_bep.F / module_sf_bep_bem.F (multi-layer building-effect
parameterization). Implemented here at the reference's method fidelity:

- Canyon geometry and view factors exactly as the SLUCM block
  (module_sf_urban.F:790-796): VFGS=SVF, VFGW=1-SVF, VFWG=VFWS=
  (1-SVF)*RW/W, VFWW=1-2*VFWG with W=2*HGT.
- Shortwave with the 8-orientation direct-beam shadow model
  (module_sf_urban.F:850-886: SLX_i = HGT |tan theta_z| |sin(az - i pi/8)|
  capped at the road width, averaged) and the one-bounce road<->wall
  reflections (SG2/SB2 forms :888-891).
- Longwave with the exact two-bounce emissivity expressions RG1/RG2 and
  RB1/RB2 and their Newton derivatives (module_sf_urban.F:1252-1303).
- Canyon wind from the roof-level log profile attenuated exponentially
  with the Inoue (1963) mixing-length exponent BB
  (module_sf_urban.F:826-836); wall/road exchange via the Jurges
  CH_SCHEME=2 relations (:1198-1203), roof and canyon-top exchange via
  the Louis (1979) stability functions (louis79, :1686-1718).
- Facet energy balances: roof Newton iteration with wet-fraction latent
  heat (TS_SCHEME=1, :1000-1020) and the COUPLED wall-road 2x2 Newton
  with the diagnostic canyon air temperature/humidity
  TC=(RW aC TA + RW aG TG + W aB TB)/(...) and its dTC/dTB, dQC/dTB
  sensitivities (:1240-1352).
- Substrate: implicit multi-layer conduction with zero-flux or Dirichlet
  deep boundary (multi_layer, :1760-1835).
- URBPARM defaults for the three standard urban classes vendored
  (the reference reads URBPARM.TBL at runtime; the file is external to
  the distribution, so the canonical WRF default rows are inlined).
- BEM: indoor air + thermal-mass nodes, window (glazing) solar gain,
  internal heat gains, HVAC with COP whose waste heat enters the canyon
  (module_sf_bem.F structure).
- BEP: building-height distribution drag + wake-TKE production and
  per-level wall/roof heat sources distributed over the model column
  (module_sf_bep.F structure).

UrbanState is a plain dataclass of tensors with the reference's field
names. The parameters are host floats: the canyon geometry is computed
once per call on 0-d tensors, and the constant vectors (the substrate's
tridiagonal rows, the building-height bins) go to the device once per
(values, device, dtype).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from mpas_tpu_torch.containers import resolve_device, to_device
from mpas_tpu_torch.ops.matrix import tridiagonal_solve

_SB = 5.670374e-8
_CP_AIR = 1004.5
_RHO_AIR = 1.2
_LV = 2.5e6
_VONK = 0.4


class UrbanParams(NamedTuple):
    """URBPARM-genre parameters; defaults = low-intensity residential."""
    h_over_w: float = 1.0        # canyon aspect ratio ZR/ROAD_WIDTH
    roof_frac: float = 0.5       # R: building coverage ratio
    frc_urb: float = 0.9         # urban fraction of the cell
    zr: float = 7.5              # building height (m)
    alb_roof: float = 0.20
    alb_wall: float = 0.20
    alb_road: float = 0.20
    eps_roof: float = 0.90
    eps_wall: float = 0.90
    eps_road: float = 0.95
    cap_roof: float = 1.0e6      # J/m3/K
    cap_wall: float = 1.0e6
    cap_road: float = 1.4e6
    aks_roof: float = 0.67       # W/m/K
    aks_wall: float = 0.67
    aks_road: float = 0.40
    dz_layers: tuple = (0.05, 0.05, 0.1, 0.2)
    z0_roof: float = 0.01
    z0_wall: float = 0.0001
    z0_road: float = 0.01
    z0_canyon: float = 0.15      # Z0C: canyon aerodynamic roughness
    zdc_frac: float = 0.3        # ZDC/ZR displacement-height fraction
    za: float = 20.0             # forcing/reference height above canyon
    ch_urban: float = 7.0e-3     # legacy bulk coefficient (fallback)
    bet_roof: float = 0.0        # wet (evaporating) fraction, dry default
    bet_wall: float = 0.0
    bet_road: float = 0.0
    ah_peak: float = 20.0        # anthropogenic sensible heat peak (W/m2)
    alh_peak: float = 0.0        # anthropogenic latent heat peak
    bound_roof: int = 1          # 1: zero-flux deep boundary, 2: Dirichlet
    bound_wall: int = 2
    bound_road: int = 2
    t_deep: float = 290.0        # TRLEND/TGLEND Dirichlet value
    # BEM
    t_target: float = 295.0
    cop: float = 3.0
    cap_indoor: float = 4.0e5    # indoor air node (J/m2/K)
    cap_mass: float = 2.0e6      # furnishing/floor mass node (J/m2/K)
    k_indoor: float = 2.0        # wall->indoor conductance (W/m2/K)
    k_mass: float = 8.0          # air<->mass conductance (W/m2/K)
    glazing: float = 0.2         # window fraction of wall
    sw_transmit: float = 0.6     # window solar transmittance
    q_internal: float = 8.0      # internal gains (W/m2 floor, daytime)


# canonical WRF URBPARM.TBL rows: (low-intensity res., high-intensity
# res., commercial/industrial) - published WRF defaults
URBPARM_TABLE = {
    1: UrbanParams(),
    2: UrbanParams(h_over_w=1.4, roof_frac=0.9, frc_urb=0.9, zr=7.5,
                   ah_peak=50.0, cap_roof=1.0e6, aks_roof=0.67),
    3: UrbanParams(h_over_w=2.0, roof_frac=0.95, frc_urb=0.95, zr=10.0,
                   ah_peak=90.0, z0_canyon=0.8),
}


@dataclasses.dataclass(frozen=True)
class UrbanState:
    t_roof: Any     # (nC, 4) roof substrate layers
    t_wall: Any     # (nC, 4)
    t_road: Any     # (nC, 4)
    ts_roof: Any    # (nC,) skin temps
    ts_wall: Any
    ts_road: Any
    t_indoor: Any   # (nC,) BEM indoor air node
    t_mass: Any     # (nC,) BEM thermal-mass node
    tc_canyon: Any  # (nC,) diagnostic canyon air temperature
    qc_canyon: Any  # (nC,) canyon air specific humidity

    def to(self, device, dtype) -> "UrbanState":
        return to_device(self, device, dtype)


def init_urban_state(n_cells, t0=290.0, dtype=torch.float64,
                     device=None) -> UrbanState:
    """The urban state at t0 everywhere, on `device` (None: cuda:0, and an
    error where there is no CUDA device; pass device="cpu" for the CPU)."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    z = torch.full((n_cells,), t0, **kw)
    l4 = torch.full((n_cells, 4), t0, **kw)
    return UrbanState(t_roof=l4, t_wall=l4, t_road=l4,
                      ts_roof=z, ts_wall=z, ts_road=z, t_indoor=z,
                      t_mass=z, tc_canyon=z,
                      qc_canyon=torch.full((n_cells,), 0.008, **kw))


@functools.cache
def _vector(values, device, dtype):
    """A tuple of host floats as a tensor on (device, dtype), copied once."""
    return torch.as_tensor(values, dtype=dtype, device=device)


def _scalar(x, like):
    """A host float as a 0-d tensor on like's device and dtype (a fill,
    no host-to-device copy)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# geometry, stability, saturation
# --------------------------------------------------------------------------

def sky_view_factors(h_over_w):
    """Canyon view factors (ref geometry block, module_sf_urban.F:790):
    road-to-sky from the aspect ratio (a tensor); wall-to-sky by
    reciprocity."""
    hw = h_over_w
    svf_road = torch.sqrt(1.0 + hw ** 2) - hw
    svf_wall = 0.5 * (hw + 1.0 - torch.sqrt(1.0 + hw ** 2)) \
        / torch.clamp(hw, min=1e-6)
    return svf_road, svf_wall


def _shadow_fraction(h_over_w, mu):
    """Mean orientation-averaged road shadow fraction: <|sin|> = 2/pi of
    the 8-orientation SLUCM shadow model (module_sf_urban.F:856-886)."""
    mu = torch.clamp(mu, 1e-3, 1.0)
    tanz = torch.sqrt(torch.clamp(1.0 - mu ** 2, min=0.0)) / mu
    return torch.clamp(h_over_w * tanz * (2.0 / math.pi), 0.0, 1.0)


def _shadow_fraction_8dir(hgt_n, rw_n, mu, sin_az=None):
    """The 8-orientation SLX average (module_sf_urban.F:856-886),
    normalized by road width. If the solar azimuth is unknown the
    orientations sample |sin| uniformly (the reference's 8 canyon
    directions)."""
    mu = torch.clamp(mu, 1e-3, 1.0)
    tanz = torch.sqrt(torch.clamp(1.0 - mu ** 2, min=0.0)) / mu
    angles = torch.arange(1, 9, dtype=mu.dtype, device=mu.device) \
        * (math.pi / 8.0)
    proj = torch.abs(torch.sin(angles)) if sin_az is None else torch.abs(
        torch.sin(sin_az[..., None] - angles))
    slx = torch.minimum(hgt_n * tanz[..., None] * proj, rw_n)
    return torch.mean(slx, dim=-1) / torch.clamp(rw_n, min=1e-6)


def _louis79(rib, z, z0):
    """Louis (1979) bulk transfer coefficient CH (module_sf_urban.F
    louis79, :1686-1718), branch-free; z and z0 host floats."""
    lzz = math.log(z / z0)
    a2 = (_VONK / lzz) ** 2
    rib = torch.clamp(rib, min=-15.0)
    # stable branch
    xx = torch.where(rib >= 0.142857, 0.714,
                     rib * lzz / torch.clamp(1.0 - 7.0 * rib, min=1e-3))
    ch_st = 0.16 / 0.74 / (lzz + 7.0 * torch.clamp(xx, max=0.714)) ** 2
    # unstable branch
    chb = 5.3 * a2 * 9.4 * math.sqrt(z / z0)
    ch_un = a2 / 0.74 * (1.0 - 9.4 * rib
                         / (1.0 + chb * torch.sqrt(torch.clamp(-rib,
                                                               min=0.0))))
    return torch.where(rib >= 0.0, ch_st, ch_un)


def _qsat(t, p_hpa):
    es = 6.11 * torch.exp((_LV / 461.51) * (t - 273.15) / (273.15 * t))
    return 0.622 * es / (p_hpa - 0.378 * es)


def _dqsat_dt(t, p_hpa):
    es = 6.11 * torch.exp((_LV / 461.51) * (t - 273.15) / (273.15 * t))
    desdt = (_LV / 461.51) * es / t ** 2
    return desdt * 0.622 * p_hpa / (p_hpa - 0.378 * es) ** 2


@functools.cache
def _substrate_rows(dt, cap, aks, dzs, bound, device, dtype):
    """The tridiagonal rows (1, n) of the implicit conduction and the
    (eta_top, eta_bottom * kb) factors of its right-hand side, computed
    on the host in float64 and copied once."""
    dz = np.asarray(dzs, dtype=np.float64)
    kh = aks / (0.5 * (dz[:-1] + dz[1:]))
    eta = dt / (cap * dz)
    a = -eta * np.concatenate([[0.0], kh])
    c = -eta * np.concatenate([kh, [0.0]])
    b = 1.0 - a - c
    etakb = 0.0
    if bound == 2:
        kb = aks / (0.5 * dz[-1])
        b[-1] = b[-1] + eta[-1] * kb
        etakb = float(eta[-1] * kb)

    def t(x):
        return torch.as_tensor(x[None], dtype=dtype, device=device)
    return t(a), t(b), t(c), float(eta[0]), etakb


def _facet_substrate(t_layers, g_flux, dt, cap, aks, dzs, bound, t_end):
    """Implicit multi-layer conduction (ref multi_layer,
    module_sf_urban.F:1760-1835): top conductive flux G0 in, deep
    boundary zero-flux (bound=1) or Dirichlet t_end (bound=2)."""
    a, b, c, eta0, etakb = _substrate_rows(
        float(dt), float(cap), float(aks), tuple(float(x) for x in dzs),
        bound, t_layers.device, t_layers.dtype)
    d = t_layers.clone()
    d[:, 0] = d[:, 0] + eta0 * g_flux
    if bound == 2:
        d[:, -1] = d[:, -1] + etakb * t_end
    return tridiagonal_solve(a, b, c, d)


# --------------------------------------------------------------------------
# SLUCM
# --------------------------------------------------------------------------

def slucm_step(state: UrbanState, t_air, wind, swdown, lwdown, mu, dt,
               hour_utc=12.0, params: UrbanParams = UrbanParams(),
               qa=None, swddir=None, swddif=None, rain_mmh=None,
               sin_az=None):
    """One SLUCM step (ref: SUBROUTINE urban, module_sf_urban.F:296).

    Returns (new UrbanState, diagnostics): hfx_urban/lh_urban (W/m2 of
    urban tile, FRC_URB applied), ts_urban (radiative composite),
    tc_canyon (canyon 2m-analogue air temperature), q_ac, ah, per-facet
    skins and fluxes.
    """
    pr = params
    dtype = t_air.dtype
    if qa is None:
        qa = torch.full_like(t_air, 0.008)
    if rain_mmh is None:
        rain_mmh = torch.zeros_like(t_air)

    R = pr.roof_frac
    RW = 1.0 - R
    HGT = pr.h_over_w * RW            # normalized building height
    W = 2.0 * HGT                     # normalized wall area
    svf, _svf_w = sky_view_factors(_scalar(pr.h_over_w, t_air))
    VFGS = svf
    VFGW = 1.0 - svf
    VFWG = (1.0 - svf) * RW / max(W, 1e-6)
    VFWS = VFWG
    VFWW = 1.0 - 2.0 * VFWG

    rho = _RHO_AIR
    ps_hpa = 1000.0
    swd = torch.clamp(swdown, min=0.0)
    if swddir is None:
        # default direct/diffuse split by solar elevation
        fdir = torch.clamp(0.85 * torch.clamp(mu, 0.0, 1.0) ** 0.3,
                           0.0, 0.9)
        sd = swd * fdir
        sq = swd - sd
    else:
        sd = torch.clamp(swddir, min=0.0)
        sq = torch.clamp(swddif, min=0.0) if swddif is not None \
            else torch.zeros_like(sd)

    # ---- canyon wind (Inoue 1963 profile; :826-836) --------------------
    zr = pr.zr
    zdc = pr.zdc_frac * zr
    z0c = pr.z0_canyon
    za = max(pr.za, zr + 2.1)
    ur = wind * math.log((zr - zdc) / z0c) / math.log((za - zdc) / z0c)
    zc = 0.7 * zr
    xlb = 0.4 * (zr - zdc)
    bb = 0.4 * zr / (xlb * math.log((zr - zdc) / z0c))
    uc = torch.clamp(ur * math.exp(-bb * (1.0 - zc / zr)), min=0.1)

    # ---- shortwave on facets (:850-891) --------------------------------
    shadow = _shadow_fraction_8dir(_scalar(HGT, t_air), _scalar(RW, t_air),
                                   mu, sin_az=sin_az)   # SLX/RW in [0,1]
    day = (mu > 1e-3).to(dtype)
    sd = sd * day
    sq = sq * day
    sr1 = (1.0 - pr.alb_roof) * (sd + sq)
    sg1 = sd * (1.0 - shadow) * (1.0 - pr.alb_road) \
        + sq * VFGS * (1.0 - pr.alb_road)
    sb1 = sd * shadow * RW / max(W, 1e-6) * (1.0 - pr.alb_wall) \
        + sq * VFWS * (1.0 - pr.alb_wall)
    sg2 = sb1 * pr.alb_wall / (1.0 - pr.alb_wall) * VFGW \
        * (1.0 - pr.alb_road)
    sb2 = sg1 * pr.alb_road / (1.0 - pr.alb_road) * VFWG \
        * (1.0 - pr.alb_wall)
    sw_roof = sr1
    sw_road = sg1 + sg2
    sw_wall = sb1 + sb2

    # ---- anthropogenic heat (AH * diurnal profile) ---------------------
    diurnal = max(math.cos((hour_utc - 14.0) / 24.0 * 2.0 * math.pi), 0.1)
    ah = pr.ah_peak * diurnal
    alh = pr.alh_peak * diurnal

    # ---- wet fractions (IMP_SCHEME=1; :917-919,1206-1209) --------------
    wet = (rain_mmh > 1.0).to(dtype)
    betr = torch.clamp(wet * 0.7, min=pr.bet_roof)
    betg = torch.clamp(wet * 0.7, min=pr.bet_road)
    betb = pr.bet_wall

    # ---- roof: Newton with Louis-79 exchange (:985-1020) ---------------
    epsr, epsb, epsg = pr.eps_roof, pr.eps_wall, pr.eps_road
    dz0 = pr.dz_layers[0]
    kg_r = pr.aks_roof / (0.5 * dz0)
    ts_r = state.ts_roof
    t1_r = state.t_roof[:, 0]
    z_eff = max(za - zr, 2.0)
    wind5 = torch.clamp(wind, min=0.5)
    for _ in range(6):
        rib = (9.8 * 2.0 / (t_air + ts_r)) * (t_air - ts_r) \
            * (z_eff + pr.z0_roof) / wind5 ** 2
        chr_ = _louis79(rib, z_eff, pr.z0_roof)
        alphar = rho * _CP_AIR * chr_ * wind5
        qs0r = _qsat(ts_r, ps_hpa)
        dqs = _dqsat_dt(ts_r, ps_hpa)
        rr = epsr * (lwdown - _SB * ts_r ** 4)
        hr = alphar * (ts_r - t_air)
        eler = rho * _LV * chr_ * wind5 * betr * (qs0r - qa)
        g0r = kg_r * (ts_r - t1_r)
        f = sw_roof + rr - hr - eler - g0r
        dfdt = -4.0 * epsr * _SB * ts_r ** 3 - alphar \
            - rho * _LV * chr_ * wind5 * betr * dqs - kg_r
        ts_r = ts_r - f / dfdt
    h_roof = alphar * (ts_r - t_air)
    le_roof = rho * _LV * chr_ * wind5 * betr * (_qsat(ts_r, ps_hpa) - qa)
    g_roof = kg_r * (ts_r - t1_r)

    # ---- canyon: coupled wall-road Newton (:1240-1352) -----------------
    ts_b = state.ts_wall
    ts_g = state.ts_road
    tc = state.tc_canyon
    qc = state.qc_canyon
    kg_b = pr.aks_wall / (0.5 * dz0)
    kg_g = pr.aks_road / (0.5 * dz0)
    t1_b = state.t_wall[:, 0]
    t1_g = state.t_road[:, 0]

    # canyon-top exchange (Louis-79 on Z0C)
    sig = _SB
    # Jurges relations for wall/road (CH_SCHEME=2; :1198-1203)
    alphab = torch.where(uc > 5.0,
                         rho * _CP_AIR * 7.51 * uc ** 0.78 / 1200.0,
                         rho * _CP_AIR * (6.15 + 4.18 * uc) / 1200.0)
    alphag = alphab
    chb_u = alphab / (rho * _CP_AIR)
    chg_u = alphag / (rho * _CP_AIR)
    for _ in range(8):
        rib_c = (9.8 * 2.0 / (t_air + tc)) * (t_air - tc) \
            * (za - zdc + z0c) / wind5 ** 2
        chc = _louis79(rib_c, max(za - zdc, 2.0), z0c)
        alphac = rho * _CP_AIR * chc * wind5

        qs0b = _qsat(ts_b, ps_hpa)
        dqs0b = _dqsat_dt(ts_b, ps_hpa)
        qs0g = _qsat(ts_g, ps_hpa)
        dqs0g = _dqsat_dt(ts_g, ps_hpa)

        tb4 = sig * ts_b ** 4
        tg4 = sig * ts_g ** 4
        rg1 = epsg * (lwdown * VFGS + epsb * VFGW * tb4 - tg4)
        rb1 = epsb * (lwdown * VFWS + epsg * VFWG * tg4
                      + epsb * VFWW * tb4 - tb4)
        rg2 = epsg * ((1.0 - epsb) * (1.0 - svf) * VFWS * lwdown
                      + (1.0 - epsb) * (1.0 - svf) * VFWG * epsg * tg4
                      + epsb * (1.0 - epsb) * (1.0 - svf)
                      * (1.0 - 2.0 * VFWS) * tb4)
        rb2 = epsb * ((1.0 - epsg) * VFWG * VFGS * lwdown
                      + (1.0 - epsg) * epsb * VFGW * VFWG * tb4
                      + (1.0 - epsb) * VFWS * (1.0 - 2.0 * VFWS) * lwdown
                      + (1.0 - epsb) * VFWG * (1.0 - 2.0 * VFWS)
                      * epsg * epsg * tg4
                      + epsb * (1.0 - epsb) * (1.0 - 2.0 * VFWS) ** 2
                      * tb4)
        rg = rg1 + rg2
        rb = rb1 + rb2
        stb3 = 4.0 * sig * ts_b ** 3
        stg3 = 4.0 * sig * ts_g ** 3
        drbdtb = epsb * (epsb * stb3 * VFWW - stb3) \
            + epsb * ((1.0 - epsg) * epsb * stb3 * VFGW * VFWG
                      + epsb * (1.0 - epsb) * stb3 * VFWW * VFWW)
        drbdtg = epsb * (epsg * stg3 * VFWG) \
            + epsb * ((1.0 - epsb) * epsg * stg3 * VFWG * VFWW)
        drgdtb = epsg * (epsb * stb3 * VFGW) \
            + epsg * (epsb * (1.0 - epsb) * stb3 * VFWW * VFGW)
        drgdtg = -epsg * stg3 \
            + epsg * ((1.0 - epsb) * epsg * stg3 * VFWG * VFGW)

        hb = rho * _CP_AIR * chb_u * (ts_b - tc)
        hg = rho * _CP_AIR * chg_u * (ts_g - tc)
        denom_t = RW * alphac + RW * alphag + W * alphab
        dtcdtb = W * alphab / denom_t
        dtcdtg = RW * alphag / denom_t
        dhbdtb = rho * _CP_AIR * chb_u * (1.0 - dtcdtb)
        dhbdtg = rho * _CP_AIR * chb_u * (0.0 - dtcdtg)
        dhgdtg = rho * _CP_AIR * chg_u * (1.0 - dtcdtg)
        dhgdtb = rho * _CP_AIR * chg_u * (0.0 - dtcdtb)

        eleb = rho * _LV * chb_u * betb * (qs0b - qc)
        eleg = rho * _LV * chg_u * betg * (qs0g - qc)
        denom_q = RW * alphac + RW * alphag * betg + W * alphab * betb
        dqcdtb = W * alphab * betb * dqs0b / denom_q
        dqcdtg = RW * alphag * betg * dqs0g / denom_q
        delebdtb = rho * _LV * chb_u * betb * (dqs0b - dqcdtb)
        delebdtg = rho * _LV * chb_u * betb * (0.0 - dqcdtg)
        delegdtg = rho * _LV * chg_u * betg * (dqs0g - dqcdtg)
        delegdtb = rho * _LV * chg_u * betg * (0.0 - dqcdtb)

        g0b = kg_b * (ts_b - t1_b)
        g0g = kg_g * (ts_g - t1_g)

        f = sw_wall + rb - hb - eleb - g0b
        fx = drbdtb - dhbdtb - delebdtb - kg_b
        fy = drbdtg - dhbdtg - delebdtg
        gf = sw_road + rg - hg - eleg - g0g
        gx = drgdtb - dhgdtb - delegdtb
        gy = drgdtg - dhgdtg - delegdtg - kg_g
        det = fx * gy - gx * fy
        dtb = (gf * fy - f * gy) / torch.where(torch.abs(det) < 1e-12,
                                               1e-12, det)
        dtg = -(gf + gx * dtb) / torch.where(torch.abs(gy) < 1e-12,
                                             1e-12, gy)
        ts_b = ts_b + torch.clamp(dtb, -10.0, 10.0)
        ts_g = ts_g + torch.clamp(dtg, -10.0, 10.0)

        tc = (RW * alphac * t_air + RW * alphag * ts_g
              + W * alphab * ts_b) / denom_t
        qc = (RW * alphac * qa + RW * alphag * betg * _qsat(ts_g, ps_hpa)
              + W * alphab * betb * _qsat(ts_b, ps_hpa)) / denom_q

    hb = rho * _CP_AIR * chb_u * (ts_b - tc)
    hg = rho * _CP_AIR * chg_u * (ts_g - tc)
    g0b = kg_b * (ts_b - t1_b)
    g0g = kg_g * (ts_g - t1_g)

    # ---- BEM: indoor nodes (module_sf_bem.F structure) -----------------
    # window solar gain + internal gains onto the air node; wall inner
    # layer exchanges with indoor air; mass node buffers.
    sw_indoor = pr.glazing * pr.sw_transmit * sw_wall \
        / max(1.0 - pr.alb_wall, 1e-6)
    q_int = pr.q_internal * max(
        math.cos((hour_utc - 15.0) / 24.0 * 2.0 * math.pi), 0.2)
    gain_wall = pr.k_indoor * (state.t_wall[:, -1] - state.t_indoor)
    gain_mass = pr.k_mass * (state.t_mass - state.t_indoor)
    load = gain_wall + gain_mass + sw_indoor + q_int
    t_free = state.t_indoor + dt / pr.cap_indoor * load
    # HVAC: clamp the air node to the target band; removed (added) energy
    # is the cooling (heating) load
    t_indoor = torch.clamp(t_free, pr.t_target - 2.0, pr.t_target + 2.0)
    q_hvac = (t_free - t_indoor) * pr.cap_indoor / dt   # >0: cooling load
    q_cool = torch.clamp(q_hvac, min=0.0)
    q_ac = q_cool * (1.0 + 1.0 / pr.cop)                # waste heat out
    t_mass = state.t_mass + dt / pr.cap_mass \
        * (pr.k_mass * (t_indoor - state.t_mass))

    # ---- substrates -----------------------------------------------------
    t_roof = _facet_substrate(state.t_roof, g_roof, dt, pr.cap_roof,
                              pr.aks_roof, pr.dz_layers, pr.bound_roof,
                              pr.t_deep)
    t_wall = _facet_substrate(state.t_wall, g0b, dt, pr.cap_wall,
                              pr.aks_wall, pr.dz_layers, 2, t_indoor)
    t_road = _facet_substrate(state.t_road, g0g, dt, pr.cap_road,
                              pr.aks_road, pr.dz_layers, pr.bound_road,
                              pr.t_deep)

    # ---- aggregation (SLUCM flux composition) --------------------------
    # canyon sensible flux to the atmosphere = top exchange
    h_canyon = alphac * (tc - t_air) + ah + q_ac
    le_canyon = rho * _LV * chc * wind5 * (qc - qa) + alh
    hfx_urban = R * h_roof + RW * h_canyon
    lh_urban = R * le_roof + RW * le_canyon
    ts_urban = (R * epsr * ts_r ** 4
                + RW * (svf * epsg * ts_g ** 4
                        + (1.0 - svf) * epsb * ts_b ** 4)) \
        / (R * epsr + RW * (svf * epsg + (1.0 - svf) * epsb))
    ts_urban = ts_urban ** 0.25

    new = UrbanState(t_roof=t_roof, t_wall=t_wall, t_road=t_road,
                     ts_roof=ts_r, ts_wall=ts_b, ts_road=ts_g,
                     t_indoor=t_indoor, t_mass=t_mass,
                     tc_canyon=tc, qc_canyon=qc)
    diag = {"hfx_urban": hfx_urban * pr.frc_urb,
            "lh_urban": lh_urban * pr.frc_urb,
            "ts_urban": ts_urban, "tc_canyon": tc,
            "q_ac": q_ac, "ah": _scalar(ah, t_air), "uc_canyon": uc,
            "h_roof": h_roof, "h_wall": hb, "h_road": hg,
            "le_roof": le_roof}
    return new, diag


# --------------------------------------------------------------------------
# BEP: multi-layer building effects
# --------------------------------------------------------------------------

def bep_column_drag(u, v, z_mid, dt, building_height=20.0,
                    frontal_density=0.3, cd_building=0.4,
                    frc_urb=0.9, height_fractions=None, height_bins=None):
    """BEP multi-layer building drag + wake TKE (ref module_sf_bep.F).

    With a building-height distribution (height_bins (m), positive
    height_fractions summing to 1, the URBPARM HEIGHT_BIN/HPERCENT_BIN
    pairs), the frontal-area density at level z is scaled by the fraction
    of buildings taller than z, the BEP morphology. Without one, the
    single-height morphology (lambda_f constant below building_height).

    Implicit drag du/dt = -a(z)|V|u with a = 0.5 Cd lambda_f(z) frc_urb;
    returns (u_new, v_new, tke_source) with tke_source = a |V|^3.
    """
    if height_bins is not None:
        hb = _vector(tuple(map(float, height_bins)), u.device, u.dtype)
        hf = _vector(tuple(map(float, height_fractions)), u.device, u.dtype)
        taller = (z_mid[..., None] < hb).to(u.dtype)        # (..., nbin)
        frac_taller = torch.sum(taller * hf, -1)
        a = 0.5 * cd_building * frontal_density * frc_urb * frac_taller
    else:
        inside = (z_mid < building_height).to(u.dtype)
        a = 0.5 * cd_building * frontal_density * frc_urb * inside
    speed = torch.sqrt(u * u + v * v)
    fac = 1.0 / (1.0 + dt * a * speed)      # implicit update
    u_new = u * fac
    v_new = v * fac
    tke_src = a * speed ** 3
    return u_new, v_new, tke_src


def bep_heat_sources(z_int, ts_wall, ts_road, ts_roof, t_col,
                     uc=1.0, height_bins=(5.0, 10.0, 15.0),
                     height_fractions=(0.5, 0.3, 0.2),
                     wall_area_density=0.3, roof_frac=0.5,
                     frc_urb=0.9):
    """Per-level sensible heat sources from building surfaces
    (module_sf_bep.F: walls heat every in-canopy level, roofs heat the
    levels at the bin tops, the ground heats the lowest level).

    z_int (nC, nz+1) level interfaces, t_col (nC, nz) air temperature.
    Returns dtheta/dt source (nC, nz) in K/s per unit heat capacity
    (W/m3 divided by rho*cp).
    """
    dz = torch.clamp(z_int[:, 1:] - z_int[:, :-1], min=1e-3)
    zm = 0.5 * (z_int[:, 1:] + z_int[:, :-1])
    hb = _vector(tuple(map(float, height_bins)), t_col.device, t_col.dtype)
    hf = _vector(tuple(map(float, height_fractions)), t_col.device,
                 t_col.dtype)
    # Jurges wall exchange at canyon wind speed
    alpha = _RHO_AIR * _CP_AIR * (6.15 + 4.18 * uc) / 1200.0
    # walls: active wherever buildings are taller than z
    frac_taller = torch.sum((zm[..., None] < hb).to(t_col.dtype) * hf, -1)
    q_wall = alpha * (ts_wall[:, None] - t_col) \
        * wall_area_density * frac_taller                  # W/m3
    # roofs: bin tops deposit fluxes into the containing layer
    in_layer = (hb[None, None, :] >= z_int[:, :-1, None]) \
        & (hb[None, None, :] < z_int[:, 1:, None])
    q_roof = torch.sum(in_layer.to(t_col.dtype) * hf, -1) \
        * alpha * (ts_roof[:, None] - t_col) * roof_frac / dz
    # ground: lowest layer
    q_road = torch.zeros_like(t_col)
    q_road[:, 0] = alpha * (ts_road - t_col[:, 0]) * (1.0 - roof_frac) \
        / dz[:, 0]
    return frc_urb * (q_wall + q_roof + q_road) / (_RHO_AIR * _CP_AIR)
