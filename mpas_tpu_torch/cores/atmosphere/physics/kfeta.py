"""Kain-Fritsch (eta) cumulus parameterization at full closure (port of
mpas_tpu/cores/atmosphere/physics/kfeta.py).

ref: src/core_atmosphere/physics/physics_wrf/module_cu_kfeta.F:1-2986;
Kain & Fritsch 1990 JAS; Kain 2004 JAM: updraft-source-layer search,
Fritsch-Chappell trigger with the grid-scale-w temperature perturbation
(ref :740-810), entraining/detraining updraft with Gaussian buoyancy
sorting (PROF5, ref :2616-2658), Ogura-Cho fallout with condensate loading
(CONDLOAD, ref :2543-2613), linear glaciation between TTFRZ and TBFRZ
(ref :900-921), precipitation efficiency from cloud-layer shear and
cloud-base height (ref :1330-1358), the evaporatively driven downdraft
(ref :1370-1520), compensating subsidence by upstream advection and the
iterative CAPE-removal closure (STAB=0.95; ref :1680-1995), and the
TKE-scaled shallow branch (ref :1634-1672).

As the reference package computes it:
- per-column loops are batched tensor ops; the reference's early EXITs
  are masks, and no value is read back from the device;
- the saturation-point tables (TPMIX2/TPMIX2DD) are a fixed 4-iteration
  Newton inversion of theta_e(T, qs(T), p);
- NUSL candidate source layers are evaluated at once and the lowest deep
  one selected; here the candidates are stacked along the column axis, so
  that one level walk of NUSL x nCells columns serves them all;
- the subsidence advection takes NSTEP_ADV substeps; the closure a fixed
  NITER_CLOSURE iterations with convergence masks;
- tendencies are rates over TIMEC applied as dt-scaled increments.

Where this port evaluates together what the reference evaluates apart
(the three theta_e evaluations of a Newton step, the two buoyancy-sorting
mixtures, the theta and qv advection), each element's arithmetic is the
reference's. All mass fluxes are per unit area.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

# saturation-vapor constants (ref DATA ALIQ,BLIQ,CLIQ,DLIQ)
ALIQ, BLIQ, CLIQ, DLIQ = 613.3, 17.502, 4780.8, 32.19
G = 9.81
CP = 1004.5
R_D = 287.04
P00 = 1.0e5
T00 = 273.16
TTFRZ, TBFRZ = 268.16, 248.16
XLV0, XLV1 = 3.147e6, 2369.0          # L_v = XLV0 - XLV1*T (ref)
RLF = 3.339e5                          # latent heat of freezing
RATE = 0.03                            # fallout rate 1/m (ref DATA RATE)
DPMIN = 5.0e3                          # min USL depth (Pa)
STAB = 0.95
GDRY = -G / CP
NUSL = 6                               # candidate source layers
NEWTON_ITERS = 4
NSTEP_ADV = 16                         # subsidence advection substeps
NITER_CLOSURE = 7
_NEWTON_DT = 0.5                       # the Newton step's difference
_MIX_F1 = (0.95, 0.10)                 # buoyancy-sorting mixtures


def esat(t):
    return ALIQ * torch.exp((BLIQ * t - CLIQ) / (t - DLIQ))


def qsat(t, p):
    es = esat(t)
    return 0.622 * es / torch.clamp(p - es, min=1.0)


def tlcl_bolton(t, q, p):
    """LCL temperature from mixed-parcel T, q, p (ref :723-739: dewpoint
    from vapor pressure, then the empirical TLCL correction)."""
    e = torch.clamp(q * p / (0.622 + q), min=1.0e-3)
    tlog = torch.log(e / ALIQ)
    tdpt = (CLIQ - DLIQ * tlog) / (BLIQ - tlog)
    tlcl = tdpt - (0.212 + 1.571e-3 * (tdpt - T00)
                   - 4.36e-4 * (t - T00)) * (t - tdpt)
    return torch.minimum(tlcl, t)


def thetae(t, q, p, tlcl):
    """theta_e (ref ENVIRTHT :2728-2764 / inline :1876)."""
    return t * (P00 / p) ** (0.2854 * (1.0 - 0.28 * q)) \
        * torch.exp((3374.6525 / tlcl - 2.5403) * q * (1.0 + 0.81 * q))


def _thes_sat(t, p):
    """theta_e of a saturated parcel at (t, p). qs is capped at 0.1
    kg/kg: past the p - es floor (stratospheric p with a warm iterate) the
    uncapped qs blows thetae's exponential to inf and the Newton
    difference to inf - inf = NaN."""
    return thetae(t, torch.clamp(qsat(t, p), max=0.1), p, t)


def wetbulb(p, thes, t_guess=None):
    """Invert thes = thetae(T, qs(T), p) for T (ref TPMIX2DD lookup ->
    Newton iteration here). Returns (T, qs(T, p)).

    The iterate is clamped to [140, 340] K: at stratospheric pressures the
    saturated theta_e exceeds any tropospheric thes and the inversion has
    no root (the reference's table saturates at its edge, TPMIX2 'OUT OF
    BOUNDS'); the clamped result is only consumed where an updraft exists,
    but it stays finite. Each step evaluates theta_e at T and T +- 0.5 K
    in one stacked call."""
    t = torch.full_like(thes, 280.0) if t_guess is None else \
        torch.clamp(t_guess, 140.0, 340.0)
    for _ in range(NEWTON_ITERS):
        ts = _thes_sat(torch.stack([t, t + _NEWTON_DT, t - _NEWTON_DT]), p)
        f = ts[0] - thes
        df = (ts[1] - ts[2]) / (2 * _NEWTON_DT)
        t = torch.clamp(t - f / torch.clamp(df, min=1e-3), 140.0, 340.0)
    return t, torch.clamp(qsat(t, p), max=0.1)


def tpmix(p, thes, qu, qliq, qice, t_guess):
    """Saturation-point adjustment of a parcel at pressure p carrying
    theta_e = thes (ref TPMIX2 :2375-2495). Returns (t, qu, qliq, qice,
    qnewlq); freezing is the caller's."""
    temp, qs = wetbulb(p, thes, t_guess)
    dq = qs - qu
    sat = dq <= 0.0
    # supersaturated: condense
    qnew = torch.where(sat, qu - qs, 0.0)
    qu_sat = torch.where(sat, qs, qu)
    # subsaturated: evaporate the available condensate
    qtot = qliq + qice
    enough = qtot >= dq
    rll = XLV0 - XLV1 * temp
    cpp = CP * (1.0 + 0.89 * qu)
    frac_l = dq * qliq / (qtot + 1e-10)
    frac_i = dq * qice / (qtot + 1e-10)
    t_noc = temp + rll * (dq / (1.0 + dq)) / cpp
    t_some = temp + rll * ((dq - qtot) / (1.0 + dq - qtot)) / cpp
    none = qtot < 1e-10
    sub_t = torch.where(none, t_noc, t_some)
    sub_qu = torch.where(none, qu, qu + qtot)
    t_out = torch.where(sat, temp, torch.where(enough, temp, sub_t))
    qu_out = torch.where(sat, qu_sat, torch.where(enough, qs, sub_qu))
    ql_out = torch.where(sat, qliq,
                         torch.where(enough, qliq - frac_l, 0.0))
    qi_out = torch.where(sat, qice,
                         torch.where(enough, qice - frac_i, 0.0))
    return t_out, qu_out, ql_out, qi_out, qnew


def prof5(eq):
    """Gaussian buoyancy-sorting integrals (ref PROF5 :2616-2658,
    Abramowitz & Stegun erf approximation). Returns (ee, ud)."""
    sqrt2p, a1, a2, a3 = 2.506628, 0.4361836, -0.1201676, 0.9372980
    pcoef, sigma, fe = 0.33267, 0.166666667, 0.202765151
    y = 6.0 * eq - 3.0
    ey = torch.exp(-0.5 * y * y)
    e45 = math.exp(-4.5)
    t2 = 1.0 / (1.0 + pcoef * torch.abs(y))
    t1 = 0.500498
    c1 = a1 * t1 + a2 * t1 ** 2 + a3 * t1 ** 3
    c2 = a1 * t2 + a2 * t2 ** 2 + a3 * t2 ** 3
    ee_pos = sigma * (0.5 * (sqrt2p - e45 * c1 - ey * c2)
                      + sigma * (e45 - ey)) - e45 * eq * eq / 2.0
    ud_pos = sigma * (0.5 * (ey * c2 - e45 * c1)
                      + sigma * (e45 - ey)) - e45 * (0.5 + eq * eq / 2.0
                                                     - eq)
    ee_neg = sigma * (0.5 * (ey * c2 - e45 * c1)
                      + sigma * (e45 - ey)) - e45 * eq * eq / 2.0
    ud_neg = sigma * (0.5 * (sqrt2p - e45 * c1 - ey * c2)
                      + sigma * (e45 - ey)) - e45 * (0.5 + eq * eq / 2.0
                                                     - eq)
    pos = y >= 0.0
    return (torch.where(pos, ee_pos, ee_neg) / fe,
            torch.where(pos, ud_pos, ud_neg) / fe)


def dtfrz(tu, p, qu, qfrz):
    """Freezing adjustment (ref DTFRZNEW :2497-2540): latent-heat-of-
    fusion warming, re-saturation, new theta_e."""
    rlc = 2.5e6 - 2369.276 * (tu - 273.16)
    rls = 2833922.0 - 259.532 * (tu - 273.16)
    rlf = rls - rlc
    cpp = CP * (1.0 + 0.89 * qu)
    # warming from freezing qfrz of liquid (vapor deposit adjustment)
    dtfr = rlf * qfrz / cpp
    tu1 = tu + dtfr
    es = esat(tu1)
    qs1 = 0.622 * es / torch.clamp(p - es, min=1.0)
    dqevap = torch.clamp(qs1 - qu, max=0.0)    # ref: may condense more
    tu2 = tu1 - dqevap * rls / cpp
    qu2 = qu + dqevap
    return tu2, qu2, thetae(tu2, qu2, p, tu2)


@functools.cache
def _mix_fractions(device, dtype):
    """The buoyancy-sorting mixtures' environmental fractions f1 and the
    parcel's f2 = 1 - f1, as (2, 1) tensors on (device, dtype), made there
    once (a copy from pageable memory waits for the device)."""
    f1 = torch.tensor(_MIX_F1, dtype=dtype, device=device)[:, None]
    f2 = torch.tensor([1.0 - f for f in _MIX_F1], dtype=dtype,
                      device=device)[:, None]
    return f1, f2


class _UplState(NamedTuple):
    theteu: torch.Tensor
    tu: torch.Tensor
    tvqu: torch.Tensor      # loaded virtual temp at the previous level
    qu: torch.Tensor
    qliq: torch.Tensor
    qice: torch.Tensor
    wtw: torch.Tensor
    umf: torch.Tensor
    ee1: torch.Tensor
    ud1: torch.Tensor
    abe: torch.Tensor
    let: torch.Tensor       # level of equilibrium temperature (int)
    ltop: torch.Tensor
    alive: torch.Tensor     # bool: the updraft is still rising
    ttemp: torch.Tensor     # glaciation tracker
    trppt: torch.Tensor
    upold: torch.Tensor


_PROFILES = ("umf", "uer", "udr", "detlq", "detic", "pptliq", "pptice",
             "qliq", "qice", "qdt", "dilfrc", "wu")


def _updraft(p, t, q, z, dp, dz_between, tv_env, theteu0, tlcl, tvlcl,
             zlcl, klcl, kpbl, vmflcl, wlcl, rad, dpthmx, qmix, tven):
    """Entraining/detraining updraft ascent (ref updraft: DO loop
    :880-1080), bottom to top over every level; levels below the LCL are
    masked. Returns the final _UplState and the per-level profiles
    {name: (N, nz)} of _PROFILES."""
    n, nz = p.shape
    # the environment's per-level terms, for all levels at once
    thetee = thetae(t, q, p, tlcl_bolton(t, q, p))
    rei_all = vmflcl[:, None] * dp * 0.03 / rad[:, None]
    feed_all = vmflcl[:, None] * dp / dpthmx[:, None]
    f1, f2 = _mix_fractions(p.device, p.dtype)
    zero = torch.zeros_like(vmflcl)
    s = _UplState(
        theteu=theteu0, tu=tlcl, tvqu=tvlcl, qu=qmix, qliq=zero, qice=zero,
        wtw=wlcl * wlcl, umf=vmflcl, ee1=torch.ones_like(vmflcl), ud1=zero,
        abe=zero, let=klcl, ltop=torch.full_like(klcl, nz - 1),
        alive=torch.ones_like(klcl, dtype=torch.bool),
        ttemp=torch.full_like(vmflcl, TTFRZ), trppt=zero, upold=vmflcl)
    prof = {k: [] for k in _PROFILES}

    for k in range(nz):
        # k is the DESTINATION level nk1 (ref: the loop starts at
        # K=KLCL-1, so the first destination level is KLCL, :1866-1872)
        pk, qk, tve = p[:, k], q[:, k], tv_env[:, k]
        thetee_k, rei = thetee[:, k], rei_all[:, k]
        at_start = klcl == k
        active = (klcl <= k) & s.alive

        # saturated ascent of the (undiluted-this-step) parcel
        tu1, qu1, ql1, qi1, qnewlq = tpmix(pk, s.theteu, s.qu, s.qliq,
                                           s.qice, s.tu)
        # glaciation (ref :900-921)
        tfrz = torch.clamp(s.ttemp, max=TTFRZ)
        do_frz = tu1 <= TTFRZ
        frc1 = torch.where(do_frz,
                           torch.where(tu1 > TBFRZ,
                                       (tfrz - tu1) / (tfrz - TBFRZ), 1.0),
                           0.0)
        frc1 = torch.clamp(frc1, 0.0, 1.0)
        qfrz = (ql1 + qnewlq) * frc1
        qnewic = qnewlq * frc1
        qnewlq = qnewlq - qnewlq * frc1
        qi1 = qi1 + ql1 * frc1
        ql1 = ql1 - ql1 * frc1
        tu_f, qu_f, theteu_f = dtfrz(tu1, pk, qu1, qfrz)
        tu1 = torch.where(do_frz, tu_f, tu1)
        qu1 = torch.where(do_frz, qu_f, qu1)
        theteu1 = torch.where(do_frz, theteu_f, s.theteu)
        ttemp_new = torch.where(do_frz, tu1, s.ttemp)

        tvu1 = tu1 * (1.0 + 0.608 * qu1)
        # vertical velocity + fallout (ref :925-940 + CONDLOAD)
        dzz = torch.where(at_start, z[:, k] - zlcl, dz_between[:, k])
        tvu_prev = torch.where(at_start, tvlcl, s.tu * (1.0 + 0.608 * s.qu))
        tve_prev = torch.where(at_start, tven, tv_env[:, max(k - 1, 0)])
        be = (tvu_prev + tvu1) / (tve_prev + tve) - 1.0
        boterm = 2.0 * dzz * G * be / 1.5
        enterm = 2.0 * rei * s.wtw / torch.clamp(s.upold, min=1e-10)

        # CONDLOAD (ref :2543-2613)
        qtot = ql1 + qi1
        qnew = qnewlq + qnewic
        qest = 0.5 * (qtot + qnew)
        g1 = torch.clamp(s.wtw + boterm - enterm
                         - 2.0 * G * dzz * qest / 1.5, min=0.0)
        wavg = 0.5 * (torch.sqrt(torch.clamp(s.wtw, min=1e-8))
                      + torch.sqrt(g1))
        conv = RATE * dzz / torch.clamp(wavg, min=1e-2)
        ratio3 = qnewlq / (qnew + 1e-8)
        qtot2 = qtot + 0.6 * qnew
        ratio4 = (0.6 * qnewlq + ql1) / (qtot2 + 1e-8)
        qtot3 = qtot2 * torch.exp(-conv)
        dq_f = qtot2 - qtot3
        qlqout = ratio4 * dq_f
        qicout = (1.0 - ratio4) * dq_f
        pptdrg = 0.5 * (qtot2 + qtot3 - 0.2 * qnew)
        wtw1 = s.wtw + boterm - enterm - 2.0 * G * dzz * pptdrg / 1.5
        wtw1 = torch.where(wtw1.abs() < 1e-4, 1e-4, wtw1)
        ql2 = ratio4 * qtot3 + ratio3 * 0.4 * qnew
        qi2 = (1.0 - ratio4) * qtot3 + (1.0 - ratio3) * 0.4 * qnew
        still = wtw1 >= 1e-3

        # CAPE contribution with loading (ref :955-963)
        tvqu1 = tu1 * (1.0 + 0.608 * qu1 - ql2 - qi2)
        tvqu_prev = torch.where(at_start, tvlcl, s.tvqu)
        dilbe = ((tvqu_prev + tvqu1) / (tve_prev + tve) - 1.0) * dzz
        abe1 = s.abe + torch.where(dilbe > 0.0, dilbe * G, 0.0)

        # buoyancy sorting (ref :966-1033): the 95% and 10% environmental
        # mixtures in one stacked saturation adjustment
        tt, qt, ql_, qi_, _ = tpmix(pk, f1 * thetee_k + f2 * theteu1,
                                    f1 * qk + f2 * qu1, f2 * ql2, f2 * qi2,
                                    tu1)
        tu95, tu10 = tt * (1.0 + 0.608 * qt - ql_ - qi_)
        flat = (tu10 - tvqu1).abs() < 1e-3
        eqfrc = (tve - tvqu1) * 0.10 / torch.where(flat, 1e-3, tu10 - tvqu1)
        eqfrc = torch.clamp(eqfrc, 0.0, 1.0)
        ee_g, ud_g = prof5(torch.clamp(eqfrc, 1e-3, 1.0 - 1e-3))
        whole = (tu95 > tve) | flat | (eqfrc >= 1.0 - 1e-6)
        none_mix = eqfrc <= 1e-6
        ee2 = torch.where(whole, 1.0, torch.where(none_mix, 0.0, ee_g))
        ud2 = torch.where(whole, 0.0, torch.where(none_mix, 1.0, ud_g))
        neg_buoy = tvqu1 <= tve
        ee2 = torch.where(neg_buoy, 0.5, ee2)
        ud2 = torch.where(neg_buoy, 1.0, ud2)
        let1 = torch.where(active & still & ~neg_buoy, k, s.let)
        ee2 = torch.clamp(ee2, min=0.5)
        ud2 = 1.5 * ud2
        uer1 = 0.5 * rei * (s.ee1 + ee2)
        udr1 = 0.5 * rei * (s.ud1 + ud2)

        # total-detrainment guard (ref :1036-1055)
        upold = s.umf - udr1
        dead = upold < 1.0e-3 * vmflcl
        abe1 = torch.where(dead & (dilbe > 0.0), abe1 - dilbe * G, abe1)
        let1 = torch.where(dead, s.let, let1)

        upnew = upold + uer1
        dilfrc1 = upnew / torch.clamp(upold, min=1e-10)
        detlq1 = ql2 * udr1
        detic1 = qi2 * udr1
        den = torch.clamp(upnew, min=1e-10)
        qu2 = (upold * qu1 + uer1 * qk) / den
        theteu2 = (theteu1 * upold + thetee_k * uer1) / den
        ql3 = ql2 * upold / den
        qi3 = qi2 * upold / den
        pptliq1 = qlqout * s.umf
        pptice1 = qicout * s.umf
        # source-layer feeding below kpbl (ref :1078)
        feed = torch.where(kpbl >= k, feed_all[:, k], 0.0)
        uer1 = uer1 + feed
        upnew = torch.where(kpbl >= k, upnew + feed, upnew)

        rising = still & ~dead
        ok = active & rising
        s = _UplState(
            theteu=torch.where(ok, theteu2, s.theteu),
            tu=torch.where(ok, tu1, s.tu),
            tvqu=torch.where(ok, tvqu1, s.tvqu),
            qu=torch.where(ok, qu2, s.qu),
            qliq=torch.where(ok, ql3, s.qliq),
            qice=torch.where(ok, qi3, s.qice),
            wtw=torch.where(ok, wtw1, s.wtw),
            umf=torch.where(ok, upnew, s.umf),
            ee1=torch.where(ok, ee2, s.ee1),
            ud1=torch.where(ok, ud2, s.ud1),
            abe=torch.where(active & still, abe1, s.abe),
            let=torch.where(active, let1, s.let),
            ltop=torch.where(active & ~rising,
                             torch.clamp(s.ltop, max=k - 1),
                             torch.where(active, k, s.ltop)),
            alive=s.alive & (rising | ~active),
            ttemp=torch.where(ok, ttemp_new, s.ttemp),
            trppt=torch.where(ok, s.trppt + pptliq1 + pptice1, s.trppt),
            upold=torch.where(ok, upnew, s.upold))
        for name, val, off in (
                ("umf", upnew, 0.0), ("uer", uer1, 0.0), ("udr", udr1, 0.0),
                ("detlq", detlq1, 0.0), ("detic", detic1, 0.0),
                ("pptliq", pptliq1, 0.0), ("pptice", pptice1, 0.0),
                ("qliq", ql3, 0.0), ("qice", qi3, 0.0), ("qdt", qu1, 0.0),
                ("dilfrc", dilfrc1, 1.0),
                ("wu", torch.sqrt(torch.clamp(wtw1, min=0.0)), 0.0)):
            prof[name].append(torch.where(ok, val, off))
    return s, {k: torch.stack(v, dim=1) for k, v in prof.items()}


def _take(a, idx):
    """a[c, idx[c]] for a per-column level index."""
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _candidates(t0, qv, p, z, dp, dz_between, tv0, w0avg, lc, dx):
    """Every candidate updraft source layer at once: the inputs are
    (N, nz) with N = NUSL x nCells (candidate-major), lc (N,) the level
    where each column's candidate starts. Returns the dict of per-column
    results of the reference's candidate()."""
    n, nz = t0.shape
    ar = torch.arange(nz, device=t0.device)[None, :]
    above = ar >= lc[:, None]
    cum = torch.cumsum(torch.where(above, dp, 0.0), dim=1)
    usl = above & (cum - dp <= DPMIN) & (ar < nz - 4)
    # guard: a candidate starting too high has an empty USL; the trigger
    # can never fire there, but the averages must stay finite
    dp_usl = torch.where(usl, dp, 0.0)
    dpthmx = torch.clamp(torch.sum(dp_usl, dim=1), min=1.0)
    n_usl = torch.sum(usl, dim=1)
    kpbl = n_usl - 1 + lc
    wgt = dp_usl / dpthmx[:, None]
    empty = n_usl == 0
    tmix = torch.where(empty, 200.0, torch.sum(wgt * t0, dim=1))
    qmix = torch.clamp(torch.sum(wgt * qv, dim=1), min=1e-9)
    pmix = torch.where(empty, 5.0e4, torch.sum(wgt * p, dim=1))
    zmix = torch.sum(wgt * z, dim=1)
    tlcl = tlcl_bolton(tmix, qmix, pmix)
    zlcl = zmix + (tmix - tlcl) * CP / G
    # klcl = first level with z >= zlcl
    above_lcl = z >= zlcl[:, None]
    klcl = torch.argmax(above_lcl.to(torch.int32), dim=1)
    klcl = torch.where(above_lcl.any(dim=1), klcl, nz - 1)
    klcl = torch.clamp(klcl, 1, nz - 2)
    kbelow = klcl - 1

    def at_lcl(a):
        a0 = _take(a, kbelow)
        return a0 + (_take(a, klcl) - a0) * dlp

    zk, zk1 = _take(z, kbelow), _take(z, klcl)
    dlp = torch.clamp((zlcl - zk) / torch.clamp(zk1 - zk, min=1.0), 0.0, 1.0)
    tenv = at_lcl(t0)
    qenv = at_lcl(qv)
    tven = tenv * (1.0 + 0.608 * qenv)
    plcl = at_lcl(p)

    # trigger (ref :750-800)
    wklcl = torch.where(zlcl < 2.0e3, 0.02 * zlcl / 2.0e3, 0.02)
    wkl = at_lcl(w0avg) * dx / 25.0e3 - wklcl
    dtlcl = torch.where(wkl < 1e-4, 0.0,
                        4.64 * torch.clamp(wkl, min=1e-4) ** 0.33)
    trig = (tlcl + dtlcl) > tenv

    gdt = 2.0 * G * torch.clamp(dtlcl, min=0.0) * 500.0 / tven
    wlcl = torch.clamp(1.0 + 0.5 * torch.sqrt(torch.clamp(gdt, min=0.0)),
                       max=3.0)
    tvlcl = tlcl * (1.0 + 0.608 * qmix)
    rholcl = plcl / (R_D * tvlcl)
    # per unit area: AU0 = 0.01*DXSQ -> 0.01 fractional area
    vmflcl = rholcl * wlcl * 0.01
    rad = torch.where(wkl < 0.0, 1000.0,
                      torch.where(wkl > 0.1, 2000.0,
                                  1000.0 + 1000.0 * wkl / 0.1))
    theteu0 = thetae(tmix, qmix, pmix, tlcl)

    st, prof = _updraft(p, t0, qv, z, dp, dz_between, tv0, theteu0, tlcl,
                        tvlcl, zlcl, klcl, kpbl, vmflcl, wlcl, rad, dpthmx,
                        qmix, tven)
    ltop = torch.clamp(st.ltop, 0, nz - 1)
    let = torch.clamp(st.let, 0, nz - 1)
    cldhgt = _take(z, ltop) - zlcl
    chmin = torch.where(tlcl > 293.0, 4.0e3,
                        torch.where(tlcl >= 273.0,
                                    2.0e3 + 100.0 * (tlcl - 273.0), 2.0e3))
    none_ok = (ltop <= klcl) | (ltop <= kpbl) | (let + 1 <= kpbl) | ~trig \
        | (ltop >= nz - 2)   # cloud would exit the model top
    # (ref :658 'WOULD GO OFF TOP': such columns are rejected, otherwise
    # draft mass flux through the lid leaks column energy)
    deep = ~none_ok & (cldhgt > chmin) & (st.abe > 1.0)
    shallow = ~none_ok & ~deep
    return dict(prof=prof, abe=st.abe, let=let, ltop=ltop,
                trppt=st.trppt, deep=deep, shallow=shallow,
                cldhgt=torch.where(shallow | deep, cldhgt, 0.0),
                klcl=klcl, kpbl=kpbl, tlcl=tlcl, tvlcl=tvlcl, zlcl=zlcl,
                tven=tven, vmflcl=vmflcl, wlcl=wlcl, dpthmx=dpthmx,
                tmix=tmix, qmix=qmix, pmix=pmix, zmix=zmix)


def kf_eta(th, qv, p, rho, z, dz, exner, dt, w0avg=None, u=None, v=None,
           dx=25.0e3):
    """Full KF-eta step. Inputs (nC, nz) bottom-up; dx a float or (nC,).
    Returns a dict with th and qv (new), qc_detr and qi_detr (mixing-ratio
    increments over dt), raincv_m (rain depth this step, m), cape, timec,
    ainc, ishall, peff, ltop and klcl."""
    nc, nz = th.shape
    t0 = th * exner
    lev = torch.arange(nz, device=th.device)[None, :]

    if w0avg is None:
        # idealized-column default: weak resolved ascent; real callers pass
        # the running-mean w
        w0avg = torch.full_like(t0, 0.1)
    if u is None:
        u = torch.zeros_like(t0)
    if v is None:
        v = torch.zeros_like(t0)

    dp = rho * G * dz                     # layer pressure depth
    tv0 = t0 * (1.0 + 0.608 * qv)
    dz_between = torch.cat([torch.zeros_like(z[:, :1]),
                            z[:, 1:] - z[:, :-1]], dim=1)

    # --- the NUSL candidate source layers, stacked along the columns ---
    def rep(a):
        return a.repeat(NUSL, *([1] * (a.dim() - 1)))
    lc = torch.arange(NUSL * nc, device=th.device) // nc
    dx_c = rep(dx) if torch.is_tensor(dx) and dx.dim() > 0 else dx
    cands = _candidates(rep(t0), rep(qv), rep(p), rep(z), rep(dp),
                        rep(dz_between), rep(tv0), rep(w0avg), lc, dx_c)

    def by_cand(a):
        return a.reshape((NUSL, nc) + a.shape[1:])

    # pick the lowest deep candidate, else the tallest shallow one
    deep_any = by_cand(cands["deep"])                       # (NUSL, nC)
    first_deep = torch.argmax(deep_any.to(torch.int32), dim=0)
    has_deep = deep_any.any(dim=0)
    best_shal = torch.argmax(by_cand(cands["cldhgt"]), dim=0)
    has_shal = by_cand(cands["shallow"]).any(dim=0)
    pick = torch.where(has_deep, first_deep, best_shal)
    ishall = ~has_deep & has_shal
    active_col = has_deep | has_shal

    def sel(a):
        vals = by_cand(a)
        idx = pick.reshape((1, nc) + (1,) * (vals.dim() - 2)) \
            .expand((1,) + vals.shape[1:])
        return torch.gather(vals, 0, idx)[0]

    prof = {k: sel(a) for k, a in cands["prof"].items()}
    umf, uer, udr = prof["umf"], prof["uer"], prof["udr"]
    detlq, detic = prof["detlq"], prof["detic"]
    pptliq, pptice = prof["pptliq"], prof["pptice"]
    qliq_u, qice_u, qdt = prof["qliq"], prof["qice"], prof["qdt"]
    dilfrc = prof["dilfrc"]
    abe, let, ltop, trppt = (sel(cands[k]) for k in ("abe", "let", "ltop",
                                                      "trppt"))
    klcl, kpbl = sel(cands["klcl"]), sel(cands["kpbl"])
    lc_lev = pick
    tlcl, zlcl = sel(cands["tlcl"]), sel(cands["zlcl"])
    vmflcl, wlcl = sel(cands["vmflcl"]), sel(cands["wlcl"])
    dpthmx, tmix, qmix, pmix, zmix = (sel(cands[k]) for k in (
        "dpthmx", "tmix", "qmix", "pmix", "zmix"))
    let = torch.where(ishall, torch.maximum(kpbl, klcl), let)

    in_cloud = (lev >= klcl[:, None]) & (lev <= ltop[:, None])

    # ---- total detrainment between LET and LTOP (ref :1163-1215) -------
    above_let = (lev > let[:, None]) & (lev <= ltop[:, None])
    dp_let = torch.where(above_let, dp, 0.0)
    dptt = torch.sum(dp_let, dim=1)
    umf_let = _take(umf, let)
    dumfdp = umf_let / torch.clamp(dptt, min=1.0)
    # linear decrease: umf(k) = umf(let) - cum_dp_above_let * dumfdp
    cum_above = torch.cumsum(dp_let, dim=1)
    umf_lin = torch.clamp(umf_let[:, None] - cum_above * dumfdp[:, None],
                          min=0.0)
    at_top = lev == ltop[:, None]
    umf_prev = torch.cat([umf[:, :1], umf[:, :-1]], dim=1)
    umf_lin_prev = torch.cat([umf_let[:, None], umf_lin[:, :-1]], dim=1)
    detr_mix = umf_lin * (1.0 - 1.0 / dilfrc)
    umf2 = torch.where(above_let, torch.where(at_top, 0.0, umf_lin), umf)
    uer2 = torch.where(above_let, torch.where(at_top, 0.0, detr_mix), uer)
    udr2 = torch.where(above_let,
                       torch.where(at_top, umf_lin_prev,
                                   umf_lin_prev - umf_lin + detr_mix), udr)
    detlq2 = torch.where(above_let, udr2 * qliq_u * dilfrc, detlq)
    detic2 = torch.where(above_let, udr2 * qice_u * dilfrc, detic)
    above_let2 = (lev >= (let + 2)[:, None]) & (lev <= ltop[:, None])
    # pptliq adjusted for the detrainment layer
    ratio_ppt = umf_lin_prev / torch.clamp(umf_prev, min=1e-10)
    pptliq2 = torch.where(above_let2, pptliq * ratio_ppt, pptliq)
    pptice2 = torch.where(above_let2, pptice * ratio_ppt, pptice)
    trppt = torch.sum(pptliq2 + pptice2, dim=1)

    # sub-cloud profiles (ref :1221-1260)
    below = lev < klcl[:, None]
    in_usl = (lev >= lc_lev[:, None]) & (lev <= kpbl[:, None])
    dp_usl = torch.where(in_usl, dp, 0.0)
    umf2 = torch.where(below,
                       torch.where(in_usl,
                                   vmflcl[:, None]
                                   * torch.cumsum(dp_usl, dim=1)
                                   / dpthmx[:, None],
                                   torch.where(lev > kpbl[:, None],
                                               vmflcl[:, None], 0.0)),
                       umf2)
    uer2 = torch.where(below & in_usl,
                       vmflcl[:, None] * dp / dpthmx[:, None],
                       torch.where(below, 0.0, uer2))
    out_of_cloud = below | (lev > ltop[:, None])
    udr2 = torch.where(out_of_cloud, 0.0, udr2)
    detlq2 = torch.where(out_of_cloud, 0.0, detlq2)
    detic2 = torch.where(out_of_cloud, 0.0, detic2)
    pptliq2 = torch.where(out_of_cloud, 0.0, pptliq2)
    pptice2 = torch.where(out_of_cloud, 0.0, pptice2)
    above_top = lev > ltop[:, None]
    umf2 = torch.where(above_top, 0.0, umf2)
    uer2 = torch.where(above_top, 0.0, uer2)

    # updraft theta (for the feedback; ref THTAU): a dry adiabat below the
    # cloud, the wet-bulb of the parcel's theta_e in it
    tu_prof = tmix[:, None] + (z - zmix[:, None]) * GDRY
    theteu_col = thetae(tmix, qmix, pmix, tlcl)
    tu_cloud, _ = wetbulb(p, theteu_col[:, None].expand_as(p), t0)
    tu_full = torch.where(in_cloud, tu_cloud, tu_prof)
    qu_full = torch.where(in_cloud, qdt, qmix[:, None])
    thtau = tu_full * (P00 / p) ** (0.2854 * (1.0 - 0.28 * qu_full))
    thta0 = t0 * (P00 / p) ** (0.2854 * (1.0 - 0.28 * qv))

    # ---- convective timescale + precipitation efficiency ---------------
    wspd_lcl = torch.sqrt(_take(u, klcl) ** 2 + _take(v, klcl) ** 2)
    # L5 ~ 500 hPa: the level closest to 500 hPa
    k5 = torch.argmin(torch.abs(p - 500.0e2), dim=1)
    wspd_5 = torch.sqrt(_take(u, k5) ** 2 + _take(v, k5) ** 2)
    vconv = 0.5 * (wspd_lcl + wspd_5)
    timec = torch.clamp(dx / torch.clamp(vconv, min=1.0), 1800.0, 3600.0)
    timec = torch.where(ishall, 2400.0, timec)

    u_top, v_top = _take(u, ltop), _take(v, ltop)
    du = u_top - _take(u, klcl)
    dv = v_top - _take(v, klcl)
    shsign = torch.where(torch.sqrt(u_top ** 2 + v_top ** 2) > wspd_lcl,
                         1.0, -1.0)
    vws = 1.0e3 * shsign * torch.sqrt(du * du + dv * dv) \
        / torch.clamp(_take(z, ltop) - _take(z, klcl), min=1.0)
    pef = torch.clamp(1.591 + vws * (-0.639 + vws * (9.53e-2
                                                     - vws * 4.96e-3)),
                      0.2, 0.9)
    cbh = (zlcl - z[:, 0]) * 3.281e-3
    rcbh = torch.where(
        cbh < 3.0, 0.02,
        0.96729352 + cbh * (-0.70034167 + cbh * (0.162179896 + cbh * (
            -1.2569798e-2 + cbh * (4.2772e-4 - cbh * 5.44e-6)))))
    rcbh = torch.where(cbh > 25.0, 2.4, rcbh)
    pefcbh = torch.clamp(1.0 / (1.0 + rcbh), max=0.9)
    peff = 0.5 * (pef + pefcbh)

    # ---- downdraft (ref :1370-1560) ------------------------------------
    kstart = kpbl + 1
    p_ks = _take(p, kstart)
    # LFS: first level > kstart with p(kstart) - p > 150 hPa, capped LET-1
    lfs_mask = (lev > kstart[:, None]) & (p_ks[:, None] - p > 150.0e2)
    klfs = torch.argmax(lfs_mask.to(torch.int32), dim=1)
    klfs = torch.where(lfs_mask.any(dim=1), klfs, let - 1)
    lfs = torch.clamp(torch.minimum(klfs, let - 1), 1, nz - 1)
    p_lfs = _take(p, lfs)
    dd_ok = ((p_ks - p_lfs) > 50.0e2) & ~ishall

    # theta_e and wet-bulb at LFS
    thetee = thetae(t0, qv, p, tlcl_bolton(t0, qv, p))
    rh = qv / torch.clamp(qsat(t0, p), min=1e-10)

    # entrainment descent LFS -> KSTART: mass-weighted theta_e/q mix
    dd_span = (lev >= kstart[:, None]) & (lev <= lfs[:, None])
    dp_dd = torch.where(dd_span, dp, 0.0)
    dp_dd_sum = torch.clamp(torch.sum(dp_dd, dim=1, keepdim=True), min=1.0)
    w_dd = dp_dd / dp_dd_sum
    theted_k = torch.sum(w_dd * thetee, dim=1)
    qd_k = torch.sum(w_dd * qv, dim=1)
    rhbar = torch.sum(w_dd * rh, dim=1)
    dmffrc = 2.0 * (1.0 - rhbar)

    # melting depression at KSTART (ref :1436-1455)
    pptmlt = torch.sum(torch.where(in_cloud, pptice2, 0.0), dim=1)
    umf_klcl = torch.clamp(_take(umf2, klcl), min=1e-10)
    dtmelt = torch.where(t0[:, 0] > T00, RLF * pptmlt / (CP * umf_klcl),
                         0.0)     # a melting level exists below the cloud
    tz_ks, _ = wetbulb(p_ks, theted_k)
    tz_ks = tz_ks - dtmelt
    qss_ks = qsat(tz_ks, p_ks)
    theted_ks = thetae(tz_ks, qss_ks, p_ks, tz_ks)

    # descent below KSTART with a 20%/km RH depression (ref :1460-1520)
    ldt = torch.minimum(lfs - 1, kstart - 1)
    tz_nd, qs_nd = wetbulb(p, theted_ks[:, None].expand_as(p), t0)
    rhh = 1.0 - 0.2e-3 * (_take(z, kstart)[:, None] - z)
    dssdt = (CLIQ - BLIQ * DLIQ) / ((tz_nd - DLIQ) ** 2)
    rl = XLV0 - XLV1 * tz_nd
    dtmp = rl * qs_nd * (1.0 - rhh) / (CP + rl * rhh * qs_nd * dssdt)
    subsat = rhh < 1.0
    t1rh = tz_nd + torch.where(subsat, dtmp, 0.0)
    qsrh = rhh * qsat(t1rh, p)
    # no negative evaporation
    qsrh = torch.maximum(qsrh, qd_k[:, None])
    tz_d = torch.where(subsat, tz_nd + (qs_nd - qsrh) * rl / CP, tz_nd)
    qsd = torch.where(subsat, qsrh, qs_nd)
    tvd = tz_d * (1.0 + 0.608 * qsd)
    # LDB: the highest level at or below LDT where the downdraft turns
    # buoyant (the descent stops there)
    buoyant_d = (tvd > tv0) & (lev <= ldt[:, None])
    ldb = torch.where(buoyant_d.any(dim=1),
                      (nz - 1) - torch.argmax(
                          torch.flip(buoyant_d, [1]).to(torch.int32), dim=1),
                      0)
    dd_ok = dd_ok & ((_take(p, ldb) - p_lfs) > 50.0e2)

    dd_lay = (lev >= ldb[:, None]) & (lev <= ldt[:, None])
    dpdd = torch.sum(torch.where(dd_lay, dp, 0.0), dim=1)
    # unit downdraft: DMF(KSTART) = -(1-PEFF) fractional area * rho
    rdd = p_lfs / (R_D * _take(tvd, lfs))
    a1 = (1.0 - peff) * 0.01 * wlcl
    dmf_lfs = -a1 * rdd
    ddr = torch.where(dd_lay, -dmf_lfs[:, None] * dp
                      / torch.clamp(dpdd, min=1.0)[:, None], 0.0)
    der = torch.where(dd_span, dmf_lfs[:, None] * dp_dd / dp_dd_sum, 0.0)
    # evaporation in the downdraft
    tder = torch.sum(torch.where(dd_lay, (qsd - qd_k[:, None]) * ddr, 0.0),
                     dim=1)
    dd_ok = dd_ok & (tder > 1e-8)
    tder = torch.where(dd_ok, tder, 0.0)

    # scale the downdraft (ref :1536-1546)
    ddinc = torch.where(dd_ok, -dmffrc * umf_klcl
                        / torch.clamp(dmf_lfs, max=-1e-10), 0.0)
    ddinc = torch.where(tder * ddinc > trppt,
                        trppt / torch.clamp(tder, min=1e-10), ddinc)
    tder = tder * ddinc
    ddr = ddr * ddinc[:, None]
    der = der * ddinc[:, None]
    pptflx = torch.where(dd_ok, trppt - tder, trppt)

    # downdraft detrained theta
    thtad = tz_d * (P00 / p) ** (0.2854 * (1.0 - 0.28 * qsd))

    # ---- closure iteration (ref :1680-1995) ----------------------------
    ems = dp / G
    emsd = 1.0 / ems
    # mass-availability bound AINCMX (ref :1600-1612)
    lmax = torch.maximum(klcl, lfs)
    avail = (lev >= lc_lev[:, None]) & (lev <= lmax[:, None])
    net_in = uer2 - der
    aincm1 = torch.where(avail & (net_in > 1e-8),
                         ems / torch.clamp(net_in * timec[:, None],
                                           min=1e-10), 1000.0)
    aincmx = torch.amin(aincm1, dim=1)
    ainc0 = torch.clamp(aincmx, max=1.0)
    # shallow closure (ref :1640-1672): EVAC = 0.5*TKEMAX*0.1, TKEMAX=5
    evac = 0.5 * 5.0 * 0.1
    ainc_sh = evac * dpthmx / torch.clamp(vmflcl * G * timec, min=1e-10)

    # theta and qv advected together: (2, nC, nz), each with its own
    # detrained values
    env = torch.stack([thta0, qv])
    detr_u = torch.stack([thtau, qdt])
    detr_d = torch.stack([thtad, qsd])
    dtime = (timec / NSTEP_ADV)[:, None]
    zero_col = torch.zeros_like(t0[:, :1])

    def apply_fluxes(ainc):
        """Compensating subsidence + draft detrainment -> new theta/qv
        (upstream advection in NSTEP_ADV substeps; ref :1694-1772)."""
        uer_s = uer2 * ainc[:, None]
        udr_s = udr2 * ainc[:, None]
        der_s = der * ainc[:, None]
        ddr_s = ddr * ainc[:, None]
        domgdp = -(uer_s - der_s - udr_s - ddr_s) * emsd
        omg = torch.cumsum(torch.cat([zero_col,
                                      -dp[:, :-1] * domgdp[:, :-1]], dim=1),
                           dim=1)
        fxm = omg / G
        down = omg <= 0.0
        src_u = udr_s * detr_u
        src_d = ddr_s * detr_d
        ent = (uer_s - der_s) * env
        x = env
        for _ in range(NSTEP_ADV):
            # face k sits at the BOTTOM of layer k: its transport couples
            # layers k-1 and k
            x_in = torch.where(down, -fxm * torch.cat([x[..., :1],
                                                       x[..., :-1]], dim=-1),
                               0.0)
            x_out = torch.where(omg > 0.0, fxm * x, 0.0)
            zero = torch.zeros_like(x[..., :1])
            up_in = torch.cat([x_in[..., 1:], zero], dim=-1)
            up_out = torch.cat([x_out[..., 1:], zero], dim=-1)
            d = x_in - x_out + up_out - up_in + src_u + src_d - ent
            x = x + d * dtime * emsd
        return x[0], torch.clamp(x[1], min=1e-9)

    wgt_usl = dp_usl / dpthmx[:, None]

    def new_cape(thg, qg):
        """Recompute ABE on the adjusted sounding (ref :1810-1905)."""
        tg = thg / (P00 / p) ** (0.2854 * (1.0 - 0.28 * qg))
        tvg = tg * (1.0 + 0.608 * qg)
        tmix_g = torch.sum(wgt_usl * tg, dim=1)
        qmix_g = torch.clamp(torch.sum(wgt_usl * qg, dim=1), min=1e-9)
        tlcl_g = tlcl_bolton(tmix_g, qmix_g, pmix)
        theteu_g = thetae(tmix_g, qmix_g, pmix, tlcl_g)
        # dilute ascent with the same dilution factors
        tu_g, qu_g = wetbulb(p, theteu_g[:, None].expand_as(p), tg)
        tvqu_g = tu_g * (1.0 + 0.608 * qu_g - qliq_u - qice_u)
        tvqu_mid = 0.5 * (tvqu_g + torch.cat([tvqu_g[:, :1],
                                              tvqu_g[:, :-1]], dim=1))
        tvg_mid = 0.5 * (tvg + torch.cat([tvg[:, :1], tvg[:, :-1]], dim=1))
        dilbe = (tvqu_mid / tvg_mid - 1.0) * dz_between
        return torch.sum(torch.where(in_cloud & (dilbe > 0.0), dilbe * G,
                                     0.0), dim=1)

    abe_safe = torch.clamp(abe, min=0.1)
    ainc = torch.where(ishall, ainc_sh, ainc0)
    done = ishall
    for _ in range(NITER_CLOSURE):
        thg, qg = apply_fluxes(ainc)
        abeg = new_cape(thg, qg)
        fabe = abeg / abe_safe
        dabe = torch.maximum(abe - abeg, 0.1 * abe)
        conv = (fabe <= 1.05 - STAB) & (fabe >= 0.95 - STAB)
        new_ainc = torch.where(fabe == 0.0, ainc * 0.5,
                               ainc * STAB * abe
                               / torch.clamp(dabe, min=1e-3))
        new_ainc = torch.minimum(new_ainc, aincmx)
        ainc = torch.where(done | conv | ishall, ainc, new_ainc)
        done = done | conv
    ainc = torch.where(active_col, ainc, 0.0)
    # negligible-convection cutoff (ref AINC<0.05 RETURN)
    ainc = torch.where(ainc < 0.05, 0.0, ainc)

    thg, qg = apply_fluxes(ainc)
    tg = thg / (P00 / p) ** (0.2854 * (1.0 - 0.28 * qg))

    # hydrometeor detrainment tendencies (ref :2000-2070, FBFRC=0: all
    # precipitation falls out; detrained ql/qi go to the grid)
    dql = detlq2 * ainc[:, None] * timec[:, None] * emsd
    dqi = detic2 * ainc[:, None] * timec[:, None] * emsd

    rain_flux = pptflx * ainc                 # kg/m^2/s over timec
    raincv = rain_flux * dt / 1000.0          # m of rain this step

    # apply over dt (tendency = (g - 0)/timec)
    frac = (dt / timec)[:, None]
    t_new = t0 + (tg - t0) * frac
    qv_new = qv + (qg - qv) * frac
    return dict(th=t_new / exner, qv=qv_new, qc_detr=dql * frac,
                qi_detr=dqi * frac, raincv_m=torch.clamp(raincv, min=0.0),
                cape=abe, timec=timec, ainc=ainc, ishall=ishall,
                peff=peff, ltop=ltop, klcl=klcl)
