"""Grell-Freitas scale-aware mass-flux convection (port of
mpas_tpu/cores/atmosphere/physics/gf.py).

ref capability: src/core_atmosphere/physics/physics_wrf/module_cu_gf.mpas.F
(Grell & Freitas 2014), dispatched from mpas_atmphys_driver_convection.F's
cu_grell_freitas branch:
  * a normalized updraft mass-flux profile between cloud base and cloud
    top, entrainment and detrainment derived from its vertical derivative;
  * the closure ensemble mean of CAPE removal over tau, the W* closure and
    low-level moisture convergence for the base mass flux;
  * scale awareness: the updraft area fraction sigma_u = f(radius / dx)
    damps the tendencies by (1 - sigma_u)^2 (Arakawa et al. 2011);
  * precipitation efficiency from the cloud depth; the non-precipitated
    condensate is detrained to the environment as qc.

Every column at once, levels on the last axis, no data-dependent control
flow: the parcel temperature takes a fixed 3 Newton iterations.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import cp, gravity

_LV = 2.5e6
_RD = 287.0
_T0 = 273.15
_TAU_DEEP = 3600.0
_CAPE_MIN = 70.0
_RADIUS_UP = 1000.0       # updraft radius scale (m), GF default genre


def _qsat(t, p):
    es = 611.2 * torch.exp(17.67 * (t - _T0) / torch.clamp(t - 29.65, min=1.0))
    return 0.622 * es / torch.clamp(p - es, min=100.0)


def _at(a, k):
    """a[c, k[c]] for a per-column level index k."""
    return torch.gather(a, 1, k[:, None])[:, 0]


def _diff_up(a):
    """jnp.diff(a, axis=1, append=a[:, -1:]): a[k+1] - a[k], 0 at the top."""
    return torch.diff(a, dim=1, append=a[:, -1:])


def gf_convection(th, qv, p, rho, z_mid, dz, exner, dt, dx=15000.0,
                  w_star=None, ccn=None):
    """Scale-aware deep and shallow convection on (nCells, nz) columns.

    dx: grid spacing in m (a float or (nCells,)) for the scale-aware
    damping; w_star: optional boundary-layer convective velocity (nCells,);
    ccn: optional CCN number (1/cm3) for the aerosol-aware efficiency.
    Returns (th_new, qv_new, qc_detrain, rain_conv [m], cape)."""
    nC, nz = th.shape
    t_env = th * exner
    tv = t_env * (1.0 + 0.61 * qv)
    h_env = cp * t_env + gravity * z_mid + _LV * qv          # MSE
    qs = _qsat(t_env, p)
    hs_env = cp * t_env + gravity * z_mid + _LV * qs         # saturation MSE

    # --- updraft source layer: the level of max MSE below 1.5 km
    h_low = torch.where(z_mid < 1500.0, h_env, -1e9)
    h_src, k_src = torch.max(h_low, dim=1)
    z_src = _at(z_mid, k_src)

    # --- cloud base: first level above the source where the (entraining)
    # parcel MSE exceeds saturation MSE (LCL-to-LFC shortcut, GF kbcon)
    ent_bulk = 7.0e-5                                     # 1/m bulk
    decay = torch.exp(-ent_bulk * torch.clamp(z_mid - z_src[:, None],
                                              min=0.0))
    h_up = h_env * (1.0 - decay) + h_src[:, None] * decay  # diluted MSE
    pos_buoy = (h_up > hs_env) & (z_mid > z_src[:, None])
    kb = torch.argmax(pos_buoy.to(torch.int32), dim=1)     # first True
    has_base = pos_buoy.any(dim=1)

    # --- cloud top: last contiguous buoyant level above base
    order = torch.arange(nz, device=th.device)[None, :]
    from_base = order >= kb[:, None]
    buoyant = pos_buoy & from_base
    # contiguity: cumulative product of the buoyancy flag from base up
    flag = torch.where(from_base, buoyant, True)
    contig = torch.cumprod(flag.to(torch.int32), dim=1).to(torch.bool)
    kt = torch.sum(contig & from_base, dim=1) + kb - 1
    kt = torch.clamp(torch.maximum(kt, kb), max=nz - 1)
    z_base = _at(z_mid, kb)
    z_top = _at(z_mid, kt)
    depth = z_top - z_base
    deep = has_base & (depth > 3000.0)
    shallow = has_base & (depth > 300.0) & ~deep
    active = deep | shallow

    # --- CAPE of the diluted parcel: the parcel T solves
    # h_up = cp*T + g*z + Lv*qsat(T,p) (3 Newton iterations)
    t_up = t_env
    for _ in range(3):
        qs_up = _qsat(t_up, p)
        dqs_dt = qs_up * 17.67 * 243.5 / torch.clamp((t_up - 29.65) ** 2,
                                                     min=1.0)
        f = h_up - (cp * t_up + gravity * z_mid + _LV * qs_up)
        t_up = t_up + f / (cp + _LV * dqs_dt)
    qs_up = _qsat(t_up, p)
    tv_up = t_up * (1.0 + 0.61 * qs_up)
    in_cloud = from_base & (order <= kt[:, None])
    cape = torch.sum(torch.where(
        in_cloud, gravity * torch.clamp(tv_up - tv, min=0.0)
        / torch.clamp(tv, min=150.0) * dz, 0.0), dim=1)

    # --- normalized mass-flux profile (GF eq. 2 genre): 1 at cloud base,
    # peaking ~1.3 at 40% of cloud depth, 0 at top; a linear sub-cloud
    # ramp (source -> base), so that compensating subsidence dries the
    # boundary layer as the reference does
    xc = torch.clamp((z_mid - z_base[:, None])
                     / torch.clamp((z_top - z_base)[:, None], min=1.0),
                     0.0, 1.0)
    eta_cloud = torch.where(xc < 0.4, 1.0 + 0.75 * xc,
                            1.3 * (1.0 - xc) / 0.6)
    sub = torch.clamp((z_mid - z_src[:, None])
                      / torch.clamp((z_base - z_src)[:, None], min=1.0),
                      0.0, 1.0)
    in_sub = (z_mid >= z_src[:, None]) & (z_mid < z_base[:, None])
    in_cld = (z_mid >= z_base[:, None]) & (z_mid <= z_top[:, None])
    eta_u = torch.where(in_cld, eta_cloud, torch.where(in_sub, sub, 0.0))

    # --- closure ensemble for the base mass flux mb (kg/m2/s) ----------
    rho_b = _at(rho, kb)
    # (1) CAPE removal: dCAPE/mb ~ cape/tau
    sqrt_cape = torch.sqrt(torch.clamp(cape, min=0.0))
    mb1 = rho_b * sqrt_cape / _TAU_DEEP * 2.0
    # (2) W* closure: mb2 = 0.03 * rho_b * w*
    if w_star is None:
        w_star = 0.5 * sqrt_cape * 0.05 + 0.3
    mb2 = 0.03 * rho_b * w_star
    # (3) moisture convergence proxy: the low-level precipitable water
    pw_low = torch.sum(torch.where(z_mid < 3000.0, rho * qv * dz, 0.0),
                       dim=1)
    mb3 = 0.01 * pw_low / _TAU_DEEP
    mb = (mb1 + mb2 + mb3) / 3.0
    mb = torch.where(deep, mb, torch.where(shallow, 0.3 * mb, 0.0))
    mb = torch.where(cape > _CAPE_MIN, mb, 0.0)
    # stability (CFL-like) cap: no level ventilates more than 1/4 of its
    # mass per step through the compensating subsidence
    vent = torch.amax(eta_u * dt / torch.clamp(rho * dz, min=1.0), dim=1)
    mb = torch.minimum(mb, 0.25 / torch.clamp(vent, min=1e-12))

    # --- scale-awareness (GF §2.3 / Arakawa 2011) ----------------------
    dx_arr = dx.to(th.dtype).expand(nC) if torch.is_tensor(dx) \
        else torch.full((nC,), dx, dtype=th.dtype, device=th.device)
    sigma_u = torch.clamp((2.0 * _RADIUS_UP / dx_arr) ** 2, 0.0, 0.9)
    scale_damp = (1.0 - sigma_u) ** 2

    # --- tendencies: compensating subsidence + detrainment -------------
    m_up = mb[:, None] * eta_u * scale_damp[:, None]     # kg/m2/s profile
    # subsidence heating/drying: -M/rho * d(s or qv)/dz (upwind down)
    dz1 = torch.clamp(dz, min=1.0)
    dth_dz = _diff_up(t_env) / dz1
    dqv_dz = _diff_up(qv) / dz1
    heat = m_up / rho * (gravity / cp + dth_dz)          # dT/dt
    dry = m_up / rho * dqv_dz                            # dqv/dt

    # detrainment at cloud top: deposit condensate + moisten
    detr = torch.clamp(-_diff_up(eta_u), min=0.0) * mb[:, None] \
        * scale_damp[:, None]
    q_cond = torch.clamp(_at(qv, k_src)[:, None] - qs, min=0.0)

    # precipitation efficiency from the cloud depth (GF pef genre)
    pef = torch.clamp(0.9 - 0.4 * torch.exp(-depth / 4000.0), 0.2, 0.9)
    if ccn is not None:
        # aerosol-aware autoconversion (ref: the GF aerosol option,
        # module_cu_gf.mpas.F Berry-style CCN dependence), normalized to
        # the 150/cm3 maritime reference and kept to >= 40% of the clean
        # efficiency
        ccn_fac = torch.clamp((150.0 / torch.clamp(ccn, min=10.0)) ** 0.3,
                              0.4, 1.0)
        pef = pef * ccn_fac
    cond_rate = m_up / rho * torch.clamp(-dqv_dz, min=0.0) \
        + detr / (rho * dz1) * q_cond
    rain_rate = pef[:, None] * cond_rate                  # kg/kg/s
    qc_detr = (1.0 - pef[:, None]) * cond_rate * dt       # -> cloud water

    # latent heating from the precipitating condensate
    heat = heat + _LV / cp * rain_rate

    t_new = t_env + dt * heat
    qv_new = torch.clamp(qv - dt * (dry + rain_rate), min=1e-8)
    # never produce negative-CAPE overshoot: clamp warming to 5 K/step
    t_new = torch.clamp(t_new, t_env - 5.0, t_env + 5.0)

    msk = active[:, None]
    th_new = torch.where(msk, t_new / exner, th)
    qv_new = torch.where(msk, qv_new, qv)
    qc_detr = torch.where(msk, qc_detr, 0.0)
    rain = torch.sum(torch.where(msk, rho * rain_rate * dz, 0.0),
                     dim=1) * dt / 1000.0                 # m of liquid
    return th_new, qv_new, qc_detr, torch.clamp(rain, min=0.0), cape
