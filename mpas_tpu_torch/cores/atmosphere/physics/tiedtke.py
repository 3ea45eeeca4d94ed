"""Tiedtke-class mass-flux convection (port of
mpas_tpu/cores/atmosphere/physics/tiedtke.py).

ref capability: src/core_atmosphere/physics/physics_wrf/
module_cu_tiedtke.F / module_cu_ntiedtke.F (Tiedtke 1989 + the "new
Tiedtke" updates): a bulk entraining updraft plume launched from the
lowest level, cloud-base mass flux from a CAPE-relaxation closure,
environmental compensating subsidence heating/drying and convective
precipitation. The plume ascent is a loop over the levels; everything
else is batched column math.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import cp, gravity

_LV = 2.5e6
_RV = 461.5
_T0 = 273.15
ENTR = 1.0e-4          # fractional entrainment (1/m), deep updraft
TAU_CAPE = 3600.0      # CAPE relaxation timescale (s)
MB_MAX = 0.1           # cloud-base mass flux cap (kg/m2/s)


def _qsat(t, p):
    es = 611.2 * torch.exp(17.67 * (t - _T0) / (t - 29.65))
    return 0.622 * es / torch.clamp(p - es, min=100.0)


def tiedtke(th, qv, p, rho, z_mid, dz, exner, dt):
    """One mass-flux convection step on (nCells, nz) columns. Returns
    (th_new, qv_new, rain_conv [m], cape) (ref driver:
    mpas_atmphys_driver_convection.F, the cu_ntiedtke branch)."""
    nz = th.shape[1]
    t = th * exner

    # --- updraft plume ascent from level 0 -------------------------------
    # parcel: moist static energy h = cp T + g z + Lv qv, entraining
    gz = gravity * z_mid
    h_env = cp * t + gz + _LV * qv
    qs_env = _qsat(t, p)
    h_sat = cp * t + gz + _LV * qs_env
    # per-level entrainment and the environment it mixes in
    ent = ENTR * (z_mid[:, 1:] - z_mid[:, :-1])        # (nC, nz-1)
    h_mix = ent * h_env[:, 1:]
    q_mix = ent * qv[:, 1:]
    one_ent = 1.0 + ent

    h_u = [h_env[:, 0]]
    q_u = [qv[:, 0]]
    cond = [torch.zeros_like(qv[:, 0])]
    for k in range(1, nz):
        h_k = (h_u[-1] + h_mix[:, k - 1]) / one_ent[:, k - 1]
        q_k = (q_u[-1] + q_mix[:, k - 1]) / one_ent[:, k - 1]
        # condensation: excess over saturation at the parcel temperature
        t_k = (h_k - gz[:, k] - _LV * q_k) / cp
        c_k = torch.clamp(q_k - _qsat(t_k, p[:, k]), min=0.0)
        h_u.append(h_k)
        q_u.append(q_k - c_k)
        cond.append(c_k)
    h_u = torch.stack(h_u, dim=1)
    cond = torch.stack(cond, dim=1)

    # buoyancy: parcel h vs saturated environment h (moist-adiabatic test)
    buoy = (h_u - h_sat) / cp                      # K excess proxy
    pos = buoy > 0.0
    cape = torch.sum(torch.where(pos, gravity * buoy
                                 / torch.clamp(t, min=200.0) * dz, 0.0),
                     dim=1)

    # cloud base = first buoyant level; cloud top = last buoyant level
    # (CUDA's argmax takes no bool; both libraries give the first maximum)
    posl = pos.long()
    k_base = torch.argmax(posl, dim=1)
    k_top = nz - 1 - torch.argmax(torch.flip(posl, [1]), dim=1)
    active = torch.any(pos, dim=1) & (k_top > k_base) & (cape > 50.0)

    # --- CAPE-relaxation closure for the cloud-base mass flux ------------
    mb = torch.clamp(cape / (TAU_CAPE * gravity) * 0.1, 0.0, MB_MAX)
    mb = torch.where(active, mb, 0.0)

    # normalized mass-flux profile: linear growth base->top (entrainment)
    ks = torch.arange(nz, device=th.device)[None, :]
    in_cloud = (ks >= k_base[:, None]) & (ks <= k_top[:, None])
    depth = torch.clamp((k_top - k_base)[:, None], min=1).to(th.dtype)
    mf_norm = torch.where(
        in_cloud, 1.0 + 0.5 * (ks - k_base[:, None]).to(th.dtype) / depth,
        0.0)
    m_u = mb[:, None] * mf_norm                      # (nC, nz) kg/m2/s

    # --- environment tendencies: compensating subsidence ----------------
    # d(phi)/dt = g M_u d(phi)/dz  (downward advection of environment)
    zero = torch.zeros_like(th[:, :1])
    dzm = z_mid[:, 1:] - z_mid[:, :-1]
    dth_dz = torch.cat([(th[:, 1:] - th[:, :-1]) / dzm, zero], dim=1)
    dqv_dz = torch.cat([(qv[:, 1:] - qv[:, :-1]) / dzm, zero], dim=1)
    th_tend = m_u / rho * dth_dz
    qv_tend = m_u / rho * dqv_dz

    precip_flux = torch.sum(m_u * cond, dim=1)       # kg/m2/s
    rain = dt * precip_flux / 1000.0                 # m

    # condensation heating in the cloud layer distributed by m_u*cond
    heat = _LV / cp * m_u * cond / (rho * dz)
    th_new = th + dt * (th_tend + heat / torch.clamp(exner, min=0.1))
    qv_new = torch.clamp(qv + dt * (qv_tend - m_u * cond / (rho * dz)),
                         min=0.0)
    return th_new, qv_new, rain, cape
