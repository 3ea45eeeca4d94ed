"""MYNN surface layer, the Nakanishi-Niino companion scheme (port of
mpas_tpu/cores/atmosphere/physics/mynn_sfc.py).

ref: src/core_atmosphere/physics/physics_wrf/module_sf_mynn.F —
  SFCLAY1D_mynn    (:419)  Monin-Obukhov iteration with surface-type-
                           dependent roughness closures
  charnock_1955    (:1392) variable-Charnock z0 over water (COARE3.0)
  garratt_1992     (:1414) zt/zq from the roughness Reynolds number
  andreas_2002     (:1553) zt/zq over snow/ice
  PSI_Hogstrom_1996(:1583) stability functions

The per-point iterative Monin-Obukhov solve is a fixed number of
iterations over all cells at once; every surface-type branch is a masked
select, so land, water and ice columns share one pass.
"""

from __future__ import annotations

import math

import torch

from mpas_tpu_torch.constants import cp, gravity

_KARMAN = 0.4
_E2 = math.exp(2.0)


def _viscosity(t):
    """Kinematic viscosity of air (ref :647 visc=1.32e-5*(1+0.0066*tc))."""
    return 1.32e-5 * (1.0 + 0.0066 * (t - 273.15))


def _charnock_z0(ust, wsp10, visc):
    """Variable-Charnock aerodynamic roughness over water (ref :1392)."""
    czc = 0.011 + 0.007 * torch.clamp((wsp10 - 10.0) / 8.0, 0.0, 1.0)
    return czc * ust * ust / gravity + 0.11 * visc / torch.clamp(ust, min=0.1)


def _garratt_ztzq(z0, ren, water):
    """Thermal/moisture roughness (ref garratt_1992 :1414)."""
    zt_w = torch.clamp(z0 * torch.exp(2.0 - 2.48 * ren ** 0.25), 2e-9, 5.5e-5)
    zq_w = torch.clamp(z0 * torch.exp(2.0 - 2.28 * ren ** 0.25), 2e-9, 5.5e-5)
    zt_l = z0 / _E2
    return torch.where(water, zt_w, zt_l), torch.where(water, zq_w, zt_l)


def _andreas_ztzq(z0, ren):
    """zt/zq over snow/ice (ref andreas_2002 :1553)."""
    r = torch.clamp(ren, 1e-3, 1000.0)
    ln = torch.log(r)
    smooth = r <= 0.135
    trans = (r > 0.135) & (r < 2.5)
    bt = torch.where(smooth, 1.25,
                     torch.where(trans, 0.149 - 0.55 * ln,
                                 0.317 - 0.565 * ln - 0.183 * ln * ln))
    bq = torch.where(smooth, 1.61,
                     torch.where(trans, 0.351 - 0.628 * ln,
                                 0.396 - 0.512 * ln - 0.180 * ln * ln))
    return z0 * torch.exp(bt), z0 * torch.exp(bq)


def _psi_hogstrom(zl, zt, z0, za):
    """Hogstrom (1996) stability functions (ref :1583)."""
    zml = z0 * zl / za
    zhl = zt * zl / za
    # stable branch
    psim_s = -5.3 * (zl - zml)
    psih_s = -8.0 * (zl - zhl)
    # unstable branch
    zl_n = torch.clamp(zl, max=0.0)
    zml_n = torch.clamp(zml, max=0.0)
    zhl_n = torch.clamp(zhl, max=0.0)
    x = (1.0 - 19.0 * zl_n) ** 0.25
    x0 = (1.0 - 19.0 * zml_n) ** 0.25
    y = torch.sqrt(1.0 - 11.6 * zl_n)
    y0 = torch.sqrt(1.0 - 11.6 * zhl_n)
    psim_u = (2.0 * torch.log((1.0 + x) / (1.0 + x0))
              + torch.log((1.0 + x * x) / (1.0 + x0 * x0))
              - 2.0 * torch.atan(x) + 2.0 * torch.atan(x0))
    psih_u = 2.0 * torch.log((1.0 + y) / (1.0 + y0))
    stable = zl > 0.0
    return (torch.where(stable, psim_s, psim_u),
            torch.where(stable, psih_s, psih_u))


def mynn_sfclay(u1, v1, th1, qv1, p1, rho1, z1, tsk, qsfc,
                xland=None, snowice=None, z0_land=0.1, n_iter: int = 5):
    """MYNN surface-layer fluxes.

    u1..z1: lowest-model-level fields (nCells,); tsk/qsfc surface values;
    xland 1=land 2=water (None: all land); snowice a bool mask. Returns
    dict(ust, hfx, qfx, lh, rmol, wspd, psim, psih, znt, zt, qke_sfc, chs,
    br) as the reference's (ref SFCLAY1D_mynn outputs; qke_sfc is the MYNN
    surface TKE lower boundary), and the drag coefficient
    cd = (ust / wspd)^2, which the PBL schemes read for the surface stress
    and the reference's dict lacks (its MYNN PBL reads sfc["cd"] and raises
    KeyError on this surface layer's output)."""
    water = torch.zeros_like(tsk, dtype=torch.bool) if xland is None \
        else xland > 1.5
    ice = torch.zeros_like(tsk, dtype=torch.bool) if snowice is None \
        else snowice
    t1 = th1 * (p1 / 1.0e5) ** (2.0 / 7.0)
    thv1 = th1 * (1.0 + 0.61 * qv1)
    thsk = tsk * (1.0e5 / p1) ** (2.0 / 7.0)
    thvsk = thsk * (1.0 + 0.61 * qsfc)
    visc = _viscosity(t1)

    # gustiness-enhanced wind (ref: VCONVC convective velocity)
    wspd0 = torch.sqrt(u1 * u1 + v1 * v1)
    dthv = thvsk - thv1
    vconv = torch.where(dthv > 0.0,
                        (gravity / torch.clamp(thv1, min=1.0)
                         * torch.clamp(dthv, min=0.0) * 1000.0)
                        ** (1.0 / 3.0), 0.0)
    wspd = torch.clamp(torch.sqrt(wspd0 ** 2 + vconv ** 2), min=0.1)

    # bulk Richardson first guess (ref BRi)
    br = gravity * z1 * (thv1 - thvsk) / (thv1 * wspd * wspd)
    zeta = torch.clamp(torch.where(br >= 0.0,
                                   br * 10.0
                                   / torch.clamp(1.0 - 5.0 * br, min=0.1)
                                   / 10.0, br), -5.0, 2.0)

    znt = torch.where(water, 1e-4, torch.full_like(tsk, z0_land))
    ust = _KARMAN * wspd / torch.log(z1 / znt)
    zt = znt / _E2
    psim = torch.zeros_like(tsk)
    psih = torch.zeros_like(tsk)
    for _ in range(n_iter):
        # roughness closures by surface type
        z0_w = _charnock_z0(ust, wspd0, visc)
        znt = torch.where(water, z0_w, z0_land)
        ren = ust * znt / visc
        zt_g, zq_g = _garratt_ztzq(znt, ren, water)
        zt_i, zq_i = _andreas_ztzq(znt, ren)
        zt = torch.where(ice, zt_i, zt_g)
        zq = torch.where(ice, zq_i, zq_g)

        psim, psih = _psi_hogstrom(zeta, zt, znt, z1)
        lnzz0 = torch.log((z1 + znt) / znt)
        lnzzt = torch.log((z1 + zt) / zt)
        ust = torch.clamp(_KARMAN * wspd / (lnzz0 - psim), min=1e-3)
        tstar = _KARMAN * (thv1 - thvsk) / (lnzzt - psih)
        # Obukhov length update (ref rmol = 1/L)
        lmo = thv1 * ust * ust / (_KARMAN * gravity
                                  * torch.where(tstar.abs() > 1e-10, tstar,
                                                1e-10))
        zeta = torch.clamp(z1 / lmo, -5.0, 2.0)

    lnzzt = torch.log((z1 + zt) / zt)
    lnzzq = torch.log((z1 + zq) / zq)
    chs = ust * _KARMAN / (lnzzt - psih)
    cqs = ust * _KARMAN / (lnzzq - psih)
    hfx = rho1 * cp * chs * (thsk - th1)
    qfx = rho1 * cqs * (qsfc - qv1)
    lh = 2.5e6 * qfx
    rmol = 1.0 / torch.where(lmo.abs() > 1e-10, lmo, 1e-10)
    # MYNN surface TKE lower boundary (ref module_bl_mynn: qke(kts) =
    # B1^(2/3) u*^2 with B1 = 24)
    qke_sfc = 24.0 ** (2.0 / 3.0) * ust * ust
    return {"ust": ust, "hfx": hfx, "qfx": qfx, "lh": lh, "rmol": rmol,
            "wspd": wspd, "psim": psim, "psih": psih, "znt": znt,
            "zt": zt, "qke_sfc": qke_sfc, "chs": chs, "br": br,
            "cd": (ust / wspd) ** 2}
