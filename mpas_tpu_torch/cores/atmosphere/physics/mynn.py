"""MYNN level-2.5 TKE boundary-layer scheme (port of
mpas_tpu/cores/atmosphere/physics/mynn.py).

The Nakanishi-Niino (2006, 2009) level-2.5 scheme as configured in the
reference (ref: src/core_atmosphere/physics/physics_wrf/module_bl_mynn.F,
RAP/HRRR constants with the Canuto/Kitamura modification CKmod=1):

- mym_level2 (ref :380-543): gradients, G_M/G_H, gradient and flux
  Richardson numbers, level-2 stability functions Sm2/Sh2;
- mym_length (ref :559-723): surface-layer, turbulent-scale and buoyancy
  lengths blended harmonically, then towards the free-atmosphere parcel
  length above the PBL;
- mym_turbulence level 2.5 (ref :919-1110): the Helfand-Labraga growing
  branch, else the full e1..e4/eden closure; K_m, K_h, K_q;
- mym_predict (ref :1353-1600): TKE with implicit dissipation and
  implicit vertical diffusion, surface TKE from u* and phi_m;
- mym_condensation (ref :1637-1760, bl_mynn_cloudpdf=1): partial
  condensation and the buoyancy-flux coefficients feeding G_H.

Column algebra over (nCells, nz); the five implicit diffusions (theta and
qv with K_h, u and v with K_m, qke with K_q) are one batched Thomas solve,
each system's arithmetic that of its own solve.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import cp, gravity
from mpas_tpu_torch.ops.matrix import tridiagonal_solve

_KARMAN = 0.4
# closure constants (ref module_bl_mynn.F:84-107, CKmod=1 column)
PR = 0.74
G1 = 0.229
B1 = 24.0
B2 = 15.0
C2 = 0.729
C3 = 0.340
C4 = 0.0
C5 = 0.2
A1 = B1 * (1.0 - 3.0 * G1) / 6.0
C1 = G1 - 1.0 / (3.0 * A1 * 2.88449914061481660)   # = g1 - 1/(3 a1 b1^(1/3))
A2 = A1 * (G1 - C1) / (G1 * PR)
G2 = B2 / B1 * (1.0 - C3) + 2.0 * A1 / B1 * (3.0 - 2.0 * C2)
E1C = 3.0 * A2 * B2 * (1.0 - C3)
E2C = 9.0 * A1 * A2 * (1.0 - C2)
E3C = 9.0 * A2 * A2 * (1.0 - C2) * (1.0 - C5)
E4C = 12.0 * A1 * A2 * (1.0 - C2)
E5C = 6.0 * A1 * A1
# length-scale constants (RAP/HRRR set, ref :116-118)
QMIN, ZMAX, CNS = 0.0, 1.0, 2.1
ALP1, ALP2, ALP3, ALP4, ALP5 = 0.23, 0.65, 3.0, 20.0, 1.0
SQFAC = 2.0
TREF = 300.0
TV0 = 0.608 * TREF
GTR = gravity / TREF
QKE_MIN = 1.0e-4
XLV = 2.5e6
EP2 = 0.622


def _esat(t):
    return 611.2 * torch.exp(17.67 * (t - 273.15) / (t - 29.65))


def _level2(du2, dtl, dqw, vtt, vqq):
    """Level-2 Sm/Sh from the flux Richardson number (ref :470-540). All
    inputs at interfaces. Returns (gm, gh, sm2, sh2, a2den)."""
    dtq = vtt * dtl + vqq * dqw
    gm = du2
    gh = -dtq * GTR
    ri = -gh / torch.clamp(du2, min=1.0e-10)
    a2den = 1.0 + torch.clamp(ri, min=0.0)          # CKmod=1
    a2k = A2 / a2den
    f1 = B1 * (G1 - C1) + 3.0 * a2k * (1.0 - C2) * (1.0 - C5) \
        + 2.0 * A1 * (3.0 - 2.0 * C2)
    f2 = B1 * (G1 + G2) - 3.0 * A1 * (1.0 - C2)
    rf1 = B1 * (G1 - C1) / f1
    rf2 = B1 * G1 / f2
    smc = A1 / a2k * f1 / f2
    shc = 3.0 * a2k * (G1 + G2)
    rfc = G1 / (G1 + G2)
    ri1 = 0.5 / smc
    ri2 = rf1 * smc
    ri3 = 4.0 * rf2 * smc - 2.0 * ri2
    ri4 = ri2 ** 2
    rf = torch.clamp(
        ri1 * (ri + ri2 - torch.sqrt(torch.clamp(
            ri ** 2 - ri3 * ri + ri4, min=0.0))), max=rfc)
    sh2 = shc * (rfc - rf) / (1.0 - rf)
    sm2 = smc * (rf1 - rf) / (rf2 - rf) * sh2
    return gm, gh, sm2, sh2, a2den


def _length(z_int, dz_int, qkw, dtv, flt, flq, rmo, zi):
    """Master length scale (ref mym_length :559-723). All at interfaces
    (nC, nz-1). Returns el."""
    zi2 = torch.clamp(zi, min=300.0)
    h1 = torch.clamp(0.3 * zi2, 300.0, 750.0)
    h2 = 0.5 * h1

    # elt = alp1 * int(q z)/int(q) below min(zi2+h1, 4000)
    mask = z_int <= torch.clamp(zi2 + h1, max=4000.0)[:, None]
    qdz = torch.clamp(qkw - QMIN, min=0.03) * dz_int * mask
    elt = ALP1 * torch.sum(qdz * z_int, dim=1) \
        / torch.clamp(torch.sum(qdz, dim=1), min=1.0e-5)
    elt = torch.clamp(elt, min=1.0)
    # the dry buoyancy flux (the surface vt = vq = 0 of the reference's
    # call: (vt0 + 1) flt + (vq0 + TV0) flq)
    vflx = flt + TV0 * flq
    vsc = (GTR * elt * torch.clamp(vflx, min=0.0)) ** (1.0 / 3.0)

    bv = torch.sqrt(GTR * torch.clamp(dtv, min=1.0e-10))
    stable = dtv > 0.0
    elb = torch.where(
        stable,
        ALP2 * qkw / bv * (1.0 + ALP3 / ALP2
                           * torch.sqrt(vsc[:, None]
                                        / (bv * elt[:, None]))),
        1.0e10)
    elf = torch.where(stable, ALP2 * qkw / bv, 1.0e10)

    zrmo = z_int * rmo[:, None]
    els_stable = _KARMAN * z_int / (1.0 + CNS * torch.clamp(zrmo, max=ZMAX))
    els_unstab = _KARMAN * z_int \
        * torch.clamp(1.0 - ALP4 * zrmo, min=1.0e-4) ** 0.2
    els = torch.where(rmo[:, None] > 0.0, els_stable, els_unstab)

    el = torch.minimum(elb / (elb / elt[:, None] + elb / els + 1.0), elf)
    # free-atmosphere blend (ref :705-713): parcel-displacement length
    # sqrt(2 tke)/N as the BouLac-class estimate
    el_fa = ALP5 * torch.where(stable, qkw / bv, 100.0)
    wt = 0.5 * torch.tanh((z_int - (zi2 + h1)[:, None]) / h2[:, None]) + 0.5
    return el * (1.0 - wt) + torch.clamp(el_fa, max=200.0) * wt


def _turbulence25(el, qkw_int, gm, gh, sm2, sh2, a2den):
    """Level-2.5 stability functions (ref :1000-1090)."""
    elsq = el ** 2
    q2sq = B1 * elsq * (sm2 * gm + sh2 * gh)
    q3sq = qkw_int ** 2
    gmel = gm * elsq
    ghel = gh * elsq

    # growing turbulence (Helfand & Labraga 1988): scale level-2 values
    qdiv = torch.sqrt(torch.clamp(q3sq, min=1e-12)
                      / torch.clamp(q2sq, min=1e-12))
    sm_grow = sm2 * qdiv
    sh_grow = sh2 * qdiv

    e1 = q3sq - E1C * ghel / a2den
    e2 = q3sq - E2C * ghel / a2den
    e3 = e1 + E3C * ghel / (a2den ** 2)
    e4 = e1 - E4C * ghel / a2den
    eden = torch.clamp(e2 * e4 + e3 * E5C * gmel, min=1.0e-20)
    sm_full = q3sq * A1 * (e3 - 3.0 * C1 * e4) / eden
    sh_full = q3sq * (A2 / a2den) * (e2 + 3.0 * C1 * E5C * gmel) / eden

    grow = q3sq < q2sq
    sm = torch.where(grow, sm_grow, sm_full)
    sh = torch.where(grow, sh_grow, sh_full)
    return torch.clamp(sm, min=0.0), torch.clamp(sh, min=0.0)


def _condensation(thl, qw, p, exner, sh_lyr, el_lyr, dtl_lyr, dqw_lyr):
    """Partial condensation -> (vt, vq, cldfra, ql) at layers
    (ref mym_condensation :1637-1760, bl_mynn_cloudpdf=1: NN2004 eq. B6
    sigma from the resolved gradients)."""
    t = thl * exner
    esl = _esat(t)
    qsl = EP2 * esl / torch.clamp(p - 1.6 * esl, min=1.0)
    dqsl = qsl * EP2 * XLV / (287.04 * t ** 2)
    qmq = qw - qsl
    alp = 1.0 / (1.0 + dqsl * XLV / cp)
    bet = dqsl * exner
    sgm = torch.sqrt(torch.clamp(
        (alp ** 2 * torch.clamp(el_lyr ** 2, min=1.0) * B2
         * torch.clamp(sh_lyr, min=0.03)) / 4.0
        * (dqw_lyr - bet * dtl_lyr) ** 2, min=1.0e-10))
    q1 = qmq / sgm
    cld = 0.5 * (1.0 + torch.special.erf(q1 * 0.7071067811865476))
    eq1 = 0.3989422804 * torch.exp(-0.5 * torch.clamp(q1, -20.0, 20.0) ** 2)
    qll = torch.clamp(cld * q1 + eq1, min=0.0)
    ql = alp * sgm * qll
    q2p = XLV / cp / exner
    pt = thl + q2p * ql
    qt = 1.0 + 0.608 * qw - 1.608 * ql
    rac = alp * (cld - qll * eq1) * (q2p * qt - 1.608 * pt)
    vt = qt - 1.0 - rac * bet
    vq = 0.608 * pt - TV0 + rac
    return vt, vq, cld, ql


def mynn(u, v, th, qv, rho, z_mid, dz, sfc, qke, dt):
    """One MYNN-2.5 step. Returns (u, v, th, qv, hpbl, qke_new).
    Inputs (nC, nz), level 0 the lowest, with qke the prognostic 2*TKE
    carried in PhysicsState; sfc: dict with ust, hfx (W/m^2), qfx
    (kg/m^2/s) and cd."""
    thv = th * (1.0 + 0.608 * qv)
    flt = sfc["hfx"] / (rho[:, 0] * cp)             # K m/s
    flq = sfc["qfx"] / rho[:, 0]
    ust = torch.clamp(sfc["ust"], min=0.05)
    # Monin-Obukhov 1/L (ref driver: rmol)
    wthv = flt * (1.0 + 0.608 * qv[:, 0]) + 0.608 * th[:, 0] * flq
    rmo = -_KARMAN * gravity / thv[:, 0] * wthv / ust ** 3

    # PBL height: thv-excess method (ref GET_PBLH genre)
    thv_sfc = thv[:, 0] + 1.5 * torch.clamp(flt, min=0.0) / ust
    above = thv > (thv_sfc[:, None] + 0.5)
    k_top = torch.argmax(above.to(torch.int32), dim=1, keepdim=True)
    h_pbl = torch.where(above.any(dim=1),
                        torch.gather(z_mid, 1, k_top)[:, 0], z_mid[:, -1])
    h_pbl = torch.maximum(h_pbl, 1.5 * z_mid[:, 0])

    # interface geometry (internal walls k=1..nz-1 -> (nC, nz-1))
    dz_int = 0.5 * (dz[:, :-1] + dz[:, 1:])
    z_int = 0.5 * (z_mid[:, :-1] + z_mid[:, 1:])
    thl = th          # no resolved cloud input: thl = th, qw = qv
    qw = qv
    du = (u[:, 1:] - u[:, :-1]) / dz_int
    dv = (v[:, 1:] - v[:, :-1]) / dz_int
    du2 = du * du + dv * dv
    dtl = (thl[:, 1:] - thl[:, :-1]) / dz_int
    dqw = (qw[:, 1:] - qw[:, :-1]) / dz_int

    qke_int = torch.clamp(0.5 * (qke[:, :-1] + qke[:, 1:]), min=QKE_MIN)
    qkw = torch.sqrt(qke_int)

    # layer pressure from the gas law p = rho R thv (p/p0)^kappa, solved
    # in closed form
    kappa = 287.04 / cp
    p_mid = (rho * 287.04 * th * (1.0 + 0.608 * qv)
             / 1.0e5 ** kappa) ** (1.0 / (1.0 - kappa))
    exner = (p_mid / 1.0e5) ** kappa

    def pad(a):
        return torch.cat([a[:, :1], a], dim=1)

    # pass 1: dry buoyancy -> el, sh for the condensation sigma; pass 2
    # closes with the partial-condensation vt/vq (ref: vt/vq from the
    # previous step's covariances; one inner iteration reproduces that
    # coupling within the step)
    vtt = torch.ones_like(du2)
    vqq = torch.full_like(du2, TV0)
    for _ in range(2):
        gm, gh, sm2, sh2, a2den = _level2(du2, dtl, dqw, vtt, vqq)
        dtv = vtt * dtl + vqq * dqw
        el = _length(z_int, dz_int, qkw, dtv, flt, flq, rmo, h_pbl)
        sm, sh = _turbulence25(el, qkw, gm, gh, sm2, sh2, a2den)
        vt_l, vq_l, _cldfra, _ql = _condensation(
            thl, qw, p_mid, exner, pad(sh), pad(el), pad(dtl), pad(dqw))
        vtt = 1.0 + 0.5 * (vt_l[:, :-1] + vt_l[:, 1:])
        vqq = TV0 + 0.5 * (vq_l[:, :-1] + vq_l[:, 1:])

    elq = el * qkw
    km = torch.clamp(elq * sm, min=0.1)
    kh = torch.clamp(elq * sh, min=0.1)
    kq = SQFAC * km

    # --- mym_predict: TKE prognosis (ref :1353-1600) --------------------
    # production at interfaces
    pdk = elq * (sm * gm + sh * gh)                # q^3-rate (m^2/s^3)
    zero1 = torch.zeros_like(qke[:, :1])
    # mapped to layers
    p_lyr = 0.5 * (torch.cat([zero1, pdk], dim=1)
                   + torch.cat([pdk, zero1], dim=1))
    el_lyr = 0.5 * (torch.cat([el[:, :1], el], dim=1)
                    + torch.cat([el, el[:, -1:]], dim=1))
    q_lyr = torch.sqrt(torch.clamp(qke, min=QKE_MIN))
    # implicit dissipation: qke_new = (qke + 2 dt P)/(1 + 2 dt q/(B1 l))
    bp = 2.0 * q_lyr / (B1 * torch.clamp(el_lyr, min=1.0))
    qke_new = (qke + dt * 2.0 * p_lyr) / (1.0 + dt * bp)
    # surface TKE (ref :1399-1404 via the mym_initialize closure): phi_m
    # at z1 = 0.5 dz
    zet = 0.5 * dz[:, 0] * rmo
    phi_m = torch.where(zet >= 0.0, 1.0 + CNS * torch.clamp(zet, max=ZMAX),
                        torch.clamp(1.0 - ALP4 * zet, min=1e-4) ** (-0.2))
    wstar3 = torch.clamp(GTR * wthv * h_pbl, min=0.0)
    qke_sfc = B1 ** (2.0 / 3.0) * (ust ** 2 * phi_m ** (2.0 / 3.0)
                                   + 0.5 * wstar3 ** (2.0 / 3.0))
    qke_new = torch.cat([torch.clamp(qke_sfc, min=QKE_MIN)[:, None],
                         qke_new[:, 1:]], dim=1)

    # implicit vertical diffusion with a surface-flux bottom condition,
    # the five fields in one batched solve
    spd1 = torch.sqrt(torch.clamp(u[:, 0] ** 2 + v[:, 0] ** 2, min=1e-4))
    kcoef = torch.stack([kh, kh, km, km, kq])
    fields = torch.stack([th, qv, u, v, torch.clamp(qke_new, min=QKE_MIN)])
    sflux = torch.stack([flt, flq, -sfc["cd"] * spd1 * u[:, 0],
                         -sfc["cd"] * spd1 * v[:, 0],
                         torch.zeros_like(qke_sfc)])
    g = dt * kcoef / dz_int
    zero = torch.zeros_like(g[..., :1])
    a = -torch.cat([zero, g], dim=-1) / dz
    c = -torch.cat([g, zero], dim=-1) / dz
    b = 1.0 - a - c
    d = torch.cat([fields[..., :1] + (dt * sflux / dz[:, 0])[..., None],
                   fields[..., 1:]], dim=-1)
    th_new, qv_new, u_new, v_new, qke_new = tridiagonal_solve(a, b, c, d)
    return (u_new, v_new, th_new, torch.clamp(qv_new, min=0.0), h_pbl,
            torch.clamp(qke_new, QKE_MIN, 150.0))
