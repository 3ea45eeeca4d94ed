"""Correlated-k (RRTMG-structure) spectral radiation (port of
mpas_tpu/cores/atmosphere/physics/rrtmg.py).

ref capability: src/core_atmosphere/physics/physics_wrf/
module_ra_rrtmg_lw.F / module_ra_rrtmg_sw.F as dispatched by
mpas_atmphys_driver_radiation_{lw,sw}.F:
  LW: the 16 RRTMG-LW bands (10-3250 cm^-1) at 140 g-points, per-band
      absorbers incl. N2O/CH4, per-band Planck fractions by numerical
      Planck integration, two-stream absorption/emission per g-point with
      the 1.66 diffusivity;
  SW: the 14 RRTMG-SW bands at 112 g-points, per-band Rayleigh
      coefficients, O3 bands, per-band solar fractions from a 5777-K Planck
      weighting, delta-two-stream cloud scattering.

Coefficients: physics/data/rrtmg_k.npz, this package's own byte-for-byte
copy of the reference package's table (Malkmus-band-model k-quantiles per
(band, gas) with per-gas pressure/temperature power-law scaling).

Every band's g-points are batched into one axis (140 LW, 112 SW), each
keeping its band's Planck or solar fraction, cloud coefficient and weight:
the LW down and up passes are one walk over the levels, one fused
multiply-add per level, instead of one walk per band. The arithmetic per
g-point is the reference's; only the order of the sum over bands differs.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from mpas_tpu_torch.constants import cp
from mpas_tpu_torch.cores.atmosphere.physics import o3

_SB = 5.67e-8
_S0 = 1361.0
_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23

DIFFUSIVITY = 1.66    # LW flux diffusivity factor (ref: rrtmg secdiff)
GASES = ("h2o", "co2", "o3", "n2o", "ch4", "h2oc")
# default well-mixed volume mixing ratios (ref: mpas_atmphys_rrtmg_lwinit
# co2vmr/n2ovmr/ch4vmr)
CO2_PPV = 400.0e-6
N2O_PPV = 320.0e-9
CH4_PPV = 1.8e-6
# mass mixing conversion (M_gas / M_air)
_MW = dict(h2o=18.016 / 28.966, co2=44.01 / 28.966, o3=48.0 / 28.966,
           n2o=44.013 / 28.966, ch4=16.043 / 28.966)
_PREF = 1.0e5
_TREF = 250.0
_N_QUAD = 8           # Planck-fraction quadrature nodes per band

# per-band LW cloud mass absorption (m2/kg liquid water): window bands
# (~800-1200 cm^-1) near the geometric-optics limit, far-IR reduced
_K_CLD_LW = {1: 60.0, 2: 90.0, 3: 110.0, 4: 120.0, 5: 130.0, 6: 140.0,
             7: 140.0, 8: 140.0, 9: 130.0, 10: 120.0, 11: 110.0,
             12: 100.0, 13: 90.0, 14: 90.0, 15: 80.0, 16: 80.0}


@functools.cache
def _tables():
    """The k-tables per band, as numpy (the reference's _tables)."""
    path = os.path.join(os.path.dirname(__file__), "data", "rrtmg_k.npz")
    raw = dict(np.load(path))
    t = {"lw": [], "sw": [], "p_exp": raw["p_exp"],
         "t_exp_lw": raw["t_exp_lw"], "t_exp_sw": raw["t_exp_sw"]}
    lw_edges = raw["lw_edges"]
    for b in range(1, 17):
        t["lw"].append({
            "nu": (float(lw_edges[b - 1]), float(lw_edges[b])),
            "w": raw[f"lw_w_{b}"],
            "k": np.stack([raw[f"lw_k_{b}_{g}"] for g in GASES], axis=1),
            "k_cld": _K_CLD_LW[b],
        })
    sw_edges = raw["sw_edges"]

    def sw_nu(b):
        if b <= 13:
            return float(sw_edges[b - 1]), float(sw_edges[b])
        return float(sw_edges[14]), float(sw_edges[15])

    # per-band solar fraction: Planck(5777 K) integral over the band
    fracs = np.asarray([_planck_fraction_np(5777.0, *sw_nu(b))
                        for b in range(1, 15)])
    fracs = fracs / fracs.sum()
    for b in range(1, 15):
        t["sw"].append({
            "nu": sw_nu(b),
            "w": raw[f"sw_w_{b}"],
            "k": np.stack([raw[f"sw_k_{b}_{g}"]
                           for g in ("h2o", "co2", "o3")], axis=1),
            "ray": float(raw[f"sw_ray_{b}"]),
            "solar_frac": float(fracs[b - 1]),
        })
    return t


def _planck_fraction_np(t, nu1, nu2, n_quad=32):
    nu = np.linspace(nu1, nu2, n_quad) * 100.0
    dnu = (nu2 - nu1) * 100.0 / (n_quad - 1)
    x = _H * _C * nu / (_KB * max(t, 120.0))
    b = 2.0 * _H * _C ** 2 * nu ** 3 / np.expm1(x)
    w = np.ones(n_quad)
    w[0] = w[-1] = 0.5
    return float(np.pi * np.sum(b * w) * dnu / (_SB * max(t, 120.0) ** 4))


@functools.cache
def _g_points_np(kind):
    """Every band's g-points in one axis: weights (G,), the k columns
    (G, len(gases)) of the gases present, band index (G,), and per g-point
    the LW cloud coefficient or the SW Rayleigh coefficient and solar
    fraction; the band edges (B, 2)."""
    bands = _tables()[kind]
    band_of = np.concatenate([np.full(len(b["w"]), i)
                              for i, b in enumerate(bands)])
    k = np.concatenate([b["k"] for b in bands])
    gases = gases_present(k)
    out = {"w": np.concatenate([b["w"] for b in bands]),
           "k": k[:, list(gases)], "gases": gases, "band": band_of,
           "nu": np.asarray([b["nu"] for b in bands])}
    if kind == "lw":
        out["k_cld"] = np.asarray([bands[i]["k_cld"] for i in band_of],
                                  dtype=np.float64)
    else:
        out["ray"] = np.asarray([bands[i]["ray"] for i in band_of])
        out["solar_frac"] = np.asarray([bands[i]["solar_frac"]
                                        for i in band_of])
    return out


@functools.cache
def _g_points(kind, device, dtype):
    """_g_points_np as tensors on (device, dtype), with the Planck
    quadrature of the bands: copied there once, so that a call makes no
    host-to-device copy (a copy from pageable memory waits for the
    device)."""
    np_ = _g_points_np(kind)
    gp = {k: (torch.as_tensor(v, device=device) if k == "band"
              else torch.as_tensor(v, dtype=dtype, device=device))
          for k, v in np_.items() if k not in ("nu", "gases")}
    nodes, dnu, w = _planck_quadrature(np_["nu"])
    gp.update(gases=np_["gases"],
              nu_nodes=torch.as_tensor(nodes, dtype=dtype, device=device),
              nu_dnu=torch.as_tensor(dnu, dtype=dtype, device=device),
              nu_w=torch.as_tensor(w, dtype=dtype, device=device))
    return gp


def _planck_quadrature(nu_edges, n_quad=_N_QUAD):
    """Trapezoid nodes (B, n_quad) in m^-1, spacings (B,) and weights of
    the bands [nu1, nu2] cm^-1 of nu_edges (B, 2)."""
    nu_edges = np.asarray(nu_edges, dtype=np.float64)
    nodes = np.stack([np.linspace(a, b, n_quad) for a, b in nu_edges]) \
        * 100.0
    dnu = (nu_edges[:, 1] - nu_edges[:, 0]) * 100.0 / (n_quad - 1)
    w = np.ones(n_quad)
    w[0] = w[-1] = 0.5
    return nodes, dnu, w


def _planck_band_fraction(t, nu, dnu, w):
    """Fraction of sigma T^4 emitted in each band, from the trapezoid
    nodes nu (B, n_quad), spacings dnu (B,) and weights w (n_quad,) of
    _planck_quadrature (as tensors): returns t.shape + (B,)."""
    tt = torch.clamp(t, min=120.0)
    x = _H * _C * nu / (_KB * tt[..., None, None])
    b = 2.0 * _H * _C ** 2 * nu ** 3 / torch.expm1(x)
    integral = torch.pi * torch.sum(b * w, dim=-1) * dnu
    return integral / (_SB * tt ** 4)[..., None]


def _gas_paths(t, qv, rho, dz, co2_ppv, o3_vmr):
    """Per-gas mass paths (kg/m2 per layer) and the layer pressure."""
    nz = qv.shape[1]
    path_a = rho * dz
    paths = {"h2o": path_a * qv,
             "co2": path_a * co2_ppv * _MW["co2"],
             "n2o": path_a * N2O_PPV * _MW["n2o"],
             "ch4": path_a * CH4_PPV * _MW["ch4"]}
    # H2O self-continuum: effective path = h2o path x (e / 10 hPa), e the
    # vapor partial pressure (ref: the selfref/forref continuum tables of
    # module_ra_rrtmg_lw.F taumol)
    p_tmp = rho * 287.0 * t
    paths["h2oc"] = path_a * qv * (qv * p_tmp / 0.622 / 1000.0)
    if o3_vmr is not None:
        paths["o3"] = o3.o3_path(rho, dz, o3_vmr)
    else:
        # midlatitude column proxy concentrated aloft
        o3_w = torch.zeros(nz, dtype=qv.dtype, device=qv.device)
        o3_w[3 * nz // 4:] = 1.0
        o3_w = o3_w / torch.clamp(torch.sum(o3_w), min=1.0)
        paths["o3"] = 6.5e-6 * o3_w[None, :] * torch.ones_like(qv[:, :1])
    p = rho * 287.0 * t
    return paths, p


def gases_present(k_np):
    """Indices of the gases that k rows k_np (ng, nGas) absorb in: a gas
    whose k is nowhere positive adds nothing and is skipped."""
    return tuple(gi for gi in range(k_np.shape[1]) if np.any(k_np[:, gi] > 0))


def _scaled_tau(tab, paths, p, t, t_exp, k_row, gases):
    """Optical depth of g-points with k rows k_row (ng, len(gases)), a
    tensor on t's device holding the columns `gases` (gases_present) of
    the table: the sum over gases of k(g, gas) * (p/pref)^a * (T/Tref)^b
    * path_gas. Returns (nC, ng, nz)."""
    pe = tab["p_exp"]
    pf = p / _PREF
    tf = t / _TREF
    scaled = []
    for gi in gases:
        if GASES[gi] == "h2oc":
            # vapor-pressure factor already in the path; continuum T
            # dependence ~ (296/T)^4 (CKD self-continuum genre)
            scale = (296.0 / t) ** 4
        else:
            scale = pf ** float(pe[gi]) * tf ** float(t_exp[gi])
        scaled.append(paths[GASES[gi]] * scale)
    return torch.einsum("gn,ncz->cgz", k_row, torch.stack(scaled))


def rrtmg_lw(t, qv, qc, rho, dz, tsk, emiss_sfc=0.985, co2_ppv=CO2_PPV,
             o3_vmr=None):
    """16-band x 140-g-point longwave. Returns (dT/dt, GLW, OLR); level 0
    lowest. ref: module_ra_rrtmg_lw.F rrtmg_lw (taumol + rtrnmc)."""
    nC, nz = t.shape
    tab = _tables()
    gp = _g_points("lw", t.device, t.dtype)
    band = gp["band"]
    quad = gp["nu_nodes"], gp["nu_dnu"], gp["nu_w"]
    paths, p = _gas_paths(t, qv, rho, dz, co2_ppv, o3_vmr)
    path_c = rho * dz * qc

    # Planck source per band, then per g-point: (nC, nz, G) and (nC, G)
    b_lyr = (_planck_band_fraction(t, *quad) * _SB) * (t ** 4)[..., None]
    b_sfc = (_planck_band_fraction(tsk, *quad) * _SB) * (tsk ** 4)[:, None]
    b_lyr, b_sfc = b_lyr[..., band], b_sfc[:, band]

    tau = _scaled_tau(tab, paths, p, t, tab["t_exp_lw"], gp["k"],
                      gp["gases"])
    tau = tau + gp["k_cld"][None, :, None] * path_c[:, None, :]
    emis = (1.0 - torch.exp(-DIFFUSIVITY * tau)).permute(2, 0, 1)
    # level-major (nz, nC, G): each level's slice is contiguous
    trans = (1.0 - emis).contiguous()
    src = (emis * b_lyr.permute(1, 0, 2)).contiguous()
    del tau, emis, b_lyr

    # downward pass (top -> surface) and upward pass (surface -> top), all
    # g-points at once: f <- f * (1 - e_k) + e_k * B_k
    f_dn = torch.empty((nz + 1,) + trans.shape[1:], dtype=t.dtype,
                       device=t.device)
    f_dn[nz].zero_()
    for k in range(nz - 1, -1, -1):
        torch.addcmul(src[k], f_dn[k + 1], trans[k], out=f_dn[k])
    f_up = torch.empty_like(f_dn)
    f_up[0] = emiss_sfc * b_sfc + (1.0 - emiss_sfc) * f_dn[0]
    for k in range(nz):
        torch.addcmul(src[k], f_up[k], trans[k], out=f_up[k + 1])

    f_dn_tot = (f_dn @ gp["w"]).T                      # (nC, nz+1)
    f_up_tot = (f_up @ gp["w"]).T
    glw = f_dn_tot[:, 0]
    olr = f_up_tot[:, -1]
    net = f_up_tot - f_dn_tot
    dtdt = -(net[:, 1:] - net[:, :-1]) / (rho * dz * cp)
    return dtdt, glw, olr


def rrtmg_sw(qv, qc, rho, dz, mu, albedo=0.2, o3_vmr=None,
             co2_ppv=CO2_PPV, t=None):
    """14-band x 112-g-point shortwave with delta-two-stream clouds.
    Returns (dT/dt, GSW absorbed at the surface); level 0 lowest.
    ref: module_ra_rrtmg_sw.F rrtmg_sw (taumol_sw + spcvmc)."""
    tab = _tables()
    gp = _g_points("sw", qv.device, qv.dtype)
    if t is None:
        t = torch.full_like(qv, _TREF)
    paths, p = _gas_paths(t, qv, rho, dz, co2_ppv, o3_vmr)
    path_a = rho * dz
    mu_s = torch.clamp(mu, min=0.05)
    sec = 1.0 / mu_s

    # cloud optics: tau = 3/2 LWP / (rho_w r_e), delta-scaled
    r_eff = 10.0e-6
    tau_cld = 1.5 * (qc * rho * dz) / (1000.0 * r_eff)
    g_cld = 0.85
    f = g_cld * g_cld
    tau_cld_s = (1.0 - 0.9994 * f) * tau_cld
    refl = (1.0 - g_cld) * tau_cld_s / (1.0 + (1.0 - g_cld) * tau_cld_s)
    ssa_cld = 0.9994
    tau_cld_abs = (1.0 - ssa_cld) * tau_cld_s

    w = gp["w"]
    toa = (_S0 * mu)[:, None] * gp["solar_frac"][None, :]     # (nC, G)
    tau_gas = _scaled_tau(tab, paths, p, t, tab["t_exp_sw"], gp["k"],
                          gp["gases"])
    tau_abs = tau_gas + tau_cld_abs[:, None, :]
    tau = tau_abs + gp["ray"][None, :, None] * path_a[:, None, :] \
        + (tau_cld_s - tau_cld_abs)[:, None, :]
    trans = torch.exp(-sec[:, None, None] * tau)
    eff_trans = trans * (1.0 - refl[:, None, :])
    log_step = torch.log(torch.clamp(eff_trans, min=1e-30))
    cum_log = torch.flip(torch.cumsum(torch.flip(log_step, [2]), dim=2), [2])
    cum = torch.exp(torch.nn.functional.pad(cum_log, (0, 1)))
    f_dn = toa[:, :, None] * cum                          # (nC, G, nz+1)
    gsw = (f_dn[:, :, 0] @ w) * (1.0 - albedo)
    heat = f_dn[:, :, 1:] * (1.0 - trans) * tau_abs \
        / torch.clamp(tau, min=1e-12)
    heat_tot = torch.einsum("cgz,g->cz", heat, w)
    dtdt = heat_tot / (rho * dz * cp)
    return dtdt, gsw
