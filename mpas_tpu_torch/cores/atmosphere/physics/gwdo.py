"""Orographic gravity-wave drag + flow blocking (Kim & Arakawa / Kim &
Doyle) (port of mpas_tpu/cores/atmosphere/physics/gwdo.py).

ref: src/core_atmosphere/physics/physics_wrf/module_bl_gwdo.F (gwdo2d
:205-745) driven by mpas_atmphys_driver_gwdo.F. In the reference's order:
reference-level (2*sigma_h) PBL averages, wind-direction-dependent
orographic asymmetry and effective length, base-level wave stress (Kim &
Arakawa 1995 enhancement/sheltering), the vertical stress profile under the
Lindzen (1981) saturation hypothesis with the Shutts minimum-Richardson
criterion, Kim & Doyle (2005) flow-blocking drag, and a critical-line
time-step limiter.

The inputs are the subgrid orography statistics of init_atmosphere's GWD
stage (var2d, con, oa1-4, ol1-4; ref mpas_init_atm_gwd.F). One column pass
over (nCells, nz); the upward stress-saturation recurrence is a loop over
the levels, with every term that does not depend on the stress computed
for all levels before it (the critical-level flag is a cumulative OR).
"""

from __future__ import annotations

import functools
import math

import torch

from mpas_tpu_torch.constants import cp, gravity, rgas

# scheme constants (ref module_bl_gwdo.F:283-296)
_RIC = 0.25
_DW2MIN = 1.0
_RIMIN = -100.0
_BNV2MIN = 1.0e-5
_EFMIN, _EFMAX = 0.0, 10.0
_VELEPS = 1.0
_FRC = 1.0
_CE = 0.8
_CG = 0.5
_GMAX = 1.0
_FRMAX = 10.0
_OLMIN = 1.0e-5
_ODMIN, _ODMAX = 0.1, 10.0
_KPBLMIN = 1          # 0-based (ref kpblmin = 2, 1-based)
_FV = 0.6077          # rv/rd - 1 (ref fv_)

# nwd lookup: wind sector -> oa/ol direction slot (ref :327 data nwdir)
_NWDIR = (6, 7, 5, 8, 2, 3, 1, 4)


@functools.lru_cache(maxsize=None)
def _nwdir(device):
    """_NWDIR on `device`, copied there once."""
    return torch.tensor(_NWDIR, device=device)


def _swap_pairs(x):
    """x[:, [1, 0, 3, 2]] of an (nC, 4) tensor, without an index copy."""
    return x.reshape(-1, 2, 2).flip(-1).reshape(-1, 4)


def _pick(x4, slot):
    """x4[c, slot[c]] of an (nC, 4) tensor."""
    return torch.gather(x4, 1, slot[:, None])[:, 0]


def gwdo(u, v, t, qv, p_mid, z_mid, dz, var2d, oc1, oa4, ol4,
         dx, dt, kpblmax=None):
    """One GWDO step.

    u, v, t, qv, p_mid, z_mid, dz: (nC, nz), level 0 the lowest. var2d,
    oc1: (nC,); oa4, ol4: (nC, 4); dx: (nC,) grid length [m]. Returns
    (dudt, dvdt, dusfc, dvsfc): the wind tendencies (nC, nz) and the
    integrated surface stress (nC,) (ref gwdo2d outputs)."""
    nc, nz = u.shape
    if kpblmax is None:
        kpblmax = nz // 2
    karr = torch.arange(nz, device=u.device)
    rows = torch.arange(nc, device=u.device)

    # virtual temperatures and density (ref :395-401)
    vtj = t * (1.0 + _FV * qv)
    exner = (p_mid / 1.0e5) ** (rgas / cp)
    vtk = vtj / exner
    rho = p_mid / (rgas * vtj)

    # hydrostatic layer mass (Pa) and interface pressures
    delp = rho * gravity * dz
    p_int0 = p_mid[:, 0] + 0.5 * delp[:, 0]
    prsi = torch.cat([p_int0[:, None],
                      p_int0[:, None] - torch.cumsum(delp, dim=1)], dim=1)

    # reference level: first level 2*var above the surface (ref :403-426)
    zl = z_mid
    zrel = zl - zl[:, :1]
    above = (zrel >= (2.0 * var2d)[:, None]) & (karr[None, :] > 0)
    # CUDA's argmax takes no bool; both libraries give the first maximum
    kfound = torch.argmax(above.long(), dim=1)
    klowtop = torch.where(torch.any(above, dim=1), kfound + 1, 0)
    kbl = torch.clamp(klowtop, _KPBLMIN, kpblmax)

    below = karr[None, :] < kbl[:, None]              # k < kbl mask
    delks = 1.0 / (prsi[:, 0] - prsi[rows, kbl])
    delks1 = 1.0 / (p_mid[:, 0] - p_mid[rows, kbl])

    # PBL mass-weighted means (ref :437-447)
    wdel = torch.where(below, delp, 0.0)
    ubar = torch.sum(wdel * u, 1) * delks
    vbar = torch.sum(wdel * v, 1) * delks
    rhobar = torch.sum(wdel * rho, 1) * delks

    # wind-direction-dependent asymmetry/length selection (ref :449-480)
    wdir = torch.atan2(ubar, vbar) + math.pi
    fdir = 8.0 / (2.0 * math.pi)
    idir = torch.remainder(torch.round(fdir * wdir).long(), 8)
    nwd = _nwdir(u.device)[idir]                       # 1..8
    slot = torch.remainder(nwd - 1, 4)                 # 0..3
    oa = (1 - 2 * torch.div(nwd - 1, 4, rounding_mode="floor")).to(u.dtype) \
        * _pick(oa4, slot)
    ol = _pick(ol4, slot)
    olp = _pick(_swap_pairs(ol4), slot)
    od = torch.clamp(olp / torch.clamp(ol, min=_OLMIN), _ODMIN, _ODMAX)
    sq2 = math.sqrt(2.0)
    dxy4 = torch.stack([dx, dx, sq2 * dx, sq2 * dx], 1)
    dxy = _pick(dxy4, slot)
    dxyp = _pick(_swap_pairs(dxy4), slot)
    cleff = dx

    # Richardson number and N^2 between levels k, k+1 (ref :482-496)
    ti = 2.0 / (t[:, :-1] + t[:, 1:])
    rdz = 1.0 / (zl[:, 1:] - zl[:, :-1])
    dw2 = (u[:, :-1] - u[:, 1:]) ** 2 + (v[:, :-1] - v[:, 1:]) ** 2
    shr2 = torch.clamp(dw2, min=_DW2MIN) * rdz * rdz
    bvf2 = gravity * (gravity / cp + rdz * (vtj[:, 1:] - vtj[:, :-1])) * ti
    usqj = torch.clamp(bvf2 / shr2, min=_RIMIN)        # (nC, nz-1)
    bnv2 = 2.0 * gravity * rdz * (vtk[:, 1:] - vtk[:, :-1]) \
        / (vtk[:, 1:] + vtk[:, :-1])

    # low-level wind and its projection profile (ref :498-516)
    ulow = torch.clamp(torch.sqrt(ubar ** 2 + vbar ** 2), min=1.0)
    rulow = 1.0 / ulow
    velco = 0.5 * ((u[:, :-1] + u[:, 1:]) * ubar[:, None]
                   + (v[:, :-1] + v[:, 1:]) * vbar[:, None]) * rulow[:, None]
    velco = torch.where((velco < _VELEPS) & (velco > 0.0), _VELEPS, velco)

    # drag-off conditions (ref :518-560)
    low = karr[None, :-1] < kbl[:, None]               # (nC, nz-1)
    ldrag = (velco[:, 0] <= 0.0) | torch.any(low & (velco <= 0.0), dim=1)

    # mass-weighted low-level Ri and N^2 (ref :529-548)
    wt = torch.where(low, (p_mid[:, :-1] - p_mid[:, 1:]) * delks1[:, None],
                     0.0)
    bnvl2 = torch.sum(wt * bnv2, 1)
    usqj_ll = torch.sum(wt * usqj, 1)
    ldrag = ldrag | (bnvl2 <= 0.0) | (ulow == 1.0) | (var2d <= 0.0)
    usqj = torch.where(low, usqj_ll[:, None], usqj)

    # base-level stress (ref :562-597)
    bnv = torch.sqrt(torch.clamp(bnvl2, min=0.0))
    fr = torch.clamp(bnv * rulow * var2d * od, max=_FRMAX)
    xn = ubar * rulow
    yn = vbar * rulow
    efact = torch.clamp((oa + 2.0) ** (_CE * fr / _FRC), _EFMIN, _EFMAX)
    coefm = (1.0 + ol) ** (oa + 1.0)
    xlinv = coefm / cleff
    tem = fr * fr * oc1
    gfobnv = _GMAX * tem / ((tem + _CG) * torch.clamp(bnv, min=1e-10))
    taub = torch.where(ldrag, 0.0,
                       xlinv * rhobar * ulow ** 3 * gfobnv * efact)
    xn = torch.where(ldrag, 0.0, xn)
    yn = torch.where(ldrag, 0.0, yn)

    # vertical stress profile: Lindzen saturation above kbl (ref :599-652).
    # taup lives on the nz+1 interfaces; taup[k] = taub for k <= kbl.
    # The terms of each level k (0..nz-2) that do not depend on the stress:
    brvf = torch.sqrt(torch.clamp(bnv2, min=_BNV2MIN))  # (nC, nz-1)
    kk = karr[None, :-1]
    active = kk >= kbl[:, None]
    # critical level reached at or below k (from _KPBLMIN up)
    crit = active & ((usqj < _RIC) | (velco <= 0.0)) & (kk >= _KPBLMIN)
    icrilv = torch.cumsum(crit.long(), dim=1) > 0
    temv = 1.0 / torch.where(velco != 0.0, velco, 1e30)
    tem1 = coefm[:, None] / dxy[:, None] * (rho[:, 1:] + rho[:, :-1]) \
        * brvf * velco * 0.5
    tem1c = torch.clamp(tem1, min=1e-30)
    tem2 = torch.sqrt(torch.clamp(usqj, min=0.0))
    # saturation hypothesis (ref :633-641)
    temc = 2.0 + 1.0 / torch.clamp(tem2, min=1e-10)
    hd_sat = velco * (2.0 * torch.sqrt(temc) - temc) / brvf
    taup_sat = tem1 * hd_sat * hd_sat
    oa_ok = (oa <= 0.0)[:, None] | (kk + 1 >= _KPBLMIN)
    ok_static = active & ~ldrag[:, None] & ~icrilv
    # below kbl the profile stays at taub; above, a failed condition leaves
    # the initialization value 0 (ref taup init :380)
    fallback = torch.where(active, 0.0, taub[:, None])

    taup_k = taub
    levels = []
    for k in range(_KPBLMIN, nz - 1):
        hd = torch.sqrt(torch.clamp(taup_k, min=0.0) / tem1c[:, k])
        fro = brvf[:, k] * hd * temv[:, k]
        t1r = 1.0 + tem2[:, k] * fro
        rim = usqj[:, k] * (1.0 - fro) / (t1r * t1r)
        taup_next = torch.where((rim <= _RIC) & oa_ok[:, k], taup_sat[:, k],
                                taup_k)
        taup_k = torch.where(ok_static[:, k] & (taup_k > 0.0), taup_next,
                             fallback[:, k])
        levels.append(taup_k)
    # interfaces 0.._KPBLMIN hold taub; then the loop's levels, the last
    # repeated at the top
    taup = torch.stack([taub] * (_KPBLMIN + 1) + levels + levels[-1:], dim=1)

    # flow-blocking drag (Kim & Doyle 2005; ref :654-700)
    zkbl = zl[rows, kbl]
    contrib = torch.where(below,
                          bnv2_full(bnv2, nz) * (zkbl[:, None] - zl)
                          * delp / gravity / rho, 0.0)
    # cumulative PE integrating downward from kbl (ref loop k=kte..1,-1)
    pe_below = torch.flip(torch.cumsum(torch.flip(contrib, [1]), dim=1), [1])
    fbdke = 0.5 * (u ** 2 + v ** 2)
    blocked = below & (pe_below >= fbdke)
    kblk = torch.argmax(torch.where(blocked, karr[None, :], -1), dim=1)
    has_blk = torch.any(blocked, dim=1) & ~ldrag
    zblk = torch.where(has_blk, zl[rows, kblk] - zl[:, 0], 0.0)
    fbdcd = torch.clamp(2.0 - 1.0 / od, min=0.0)
    taufb0 = torch.where(
        has_blk,
        0.5 * rhobar * coefm / torch.clamp(dx, min=1.0) ** 2 * fbdcd * dxyp
        * olp * zblk * ulow ** 2, 0.0)
    # linear decrease from taufb0 at the surface to 0 at kblk (ref :685-688)
    kint = torch.arange(nz + 1, device=u.device)
    fracfb = torch.clamp(1.0 - kint[None, :]
                         / torch.clamp(kblk[:, None], min=1).to(u.dtype),
                         0.0, 1.0)
    taup = taup + taufb0[:, None] * fracfb

    # deceleration: -g dtau/dp with critical-line limiter (ref :702-743)
    taud = (taup[:, 1:] - taup[:, :-1]) * gravity / delp
    velco_f = torch.cat([velco, velco[:, -1:]], dim=1)
    nonzero = taud != 0.0
    lim = torch.where(below & nonzero,
                      torch.abs(velco_f / (dt * torch.where(nonzero, taud,
                                                            1e30))),
                      float("inf"))
    dtfac = torch.clamp(torch.amin(lim, dim=1), max=1.0)
    taud = taud * dtfac[:, None]
    dudt = taud * xn[:, None]
    dvdt = taud * yn[:, None]
    dusfc = -torch.sum(dudt * delp, 1) / gravity
    dvsfc = -torch.sum(dvdt * delp, 1) / gravity
    return dudt, dvdt, dusfc, dvsfc


def bnv2_full(bnv2, nz):
    """Pad the (nC, nz-1) interface N^2 to (nC, nz) by repeating the top
    (the reference indexes bnv2(i,k) with k up to kbl < nz-1)."""
    return torch.cat([bnv2, bnv2[:, -1:]], dim=1)
