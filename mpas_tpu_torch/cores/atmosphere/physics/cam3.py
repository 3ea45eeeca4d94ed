"""CAM3 radiation engine: radcswmx / radclwmx (port of
mpas_tpu/cores/atmosphere/physics/cam3.py).

ref capability: physics_wrf/module_ra_cam.F (radclwmx :4565, radcswmx
:5514, raddedmx :7333, radabs :2032, radems :3442, radtpl :4377) +
module_ra_cam_support.F (trcab :436, trcplk :1426, trcpth :1518, cldems
:2097, reltab :2301, reitab :2361).

Shortwave: 19 spectral intervals, pressure-and-zenith scaled absorber
paths, Slingo liquid and Ebert-Curry ice cloud optics, delta-Eddington
layer properties combined by the adding method over the maximum-overlap
binary cloud configurations, with a parallel clear-sky pass. Longwave: the
radclwmx absorptivity/emissivity exchange integral with the analytic band
models of the reference (H2O, CO2 15 um, O3 9.6 um, the trace gases) and
random-overlap cloud transmission. The arithmetic is the reference's; the
two scans of the adding method are Python loops over the layers, writing
each interface into a preallocated interface-major tensor.

All public entry points take bottom-up (k=0 = lowest layer) arrays in SI
units in cam_radiation.py; this module runs top-down in CGS, matching the
band-model constants. Constant tables go to the device once per (device,
dtype) (`_consts`), so that a call makes no host-to-device copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mpas_tpu_torch.cores.atmosphere.physics import cam3_data as D

_HCK = 1.438769      # hc/k in cm K

CP = 1004.64
GRAV_SI = 9.80616

# the three non-window H2O sub-bands of the Planck quadrature (cm-1)
_PLANCK_BANDS = ((10.0, 500.0), (500.0, 800.0), (1200.0, 2200.0))
# window sub-band widths (820-1170 cm-1 and the continuum wings)
_WINDOW_WEIGHTS = (0.10, 0.15, 0.05, 0.25, 0.325, 0.125)


@functools.cache
def _consts(device, dtype):
    """The tables the engine reads, as tensors on (device, dtype)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                               device=device)
    idx = D.INDXSL
    c = {name: t(getattr(D, name)[idx]).reshape(-1, 1, 1)
         for name in ("ABARL", "BBARL", "CBARL", "DBARL", "EBARL", "FBARL",
                      "ABARI", "BBARI", "CBARI", "DBARI", "EBARI", "FBARI")}
    for name in ("ABH2O", "ABO3", "ABCO2", "ABO2"):
        c[name] = t(getattr(D, name)).reshape(-1, 1, 1)
    c["trayoslp"] = t(D.RAYTAU / D.SSLP_CGS).reshape(-1, 1, 1)
    c["frcsol"] = t(D.FRCSOL * D.PSF)[:, None]
    c["nirwgt"] = t(D.NIRWGT)[:, None]
    c["vis"] = torch.as_tensor(D.WAVMID < 0.7, device=device)[:, None]
    c["retab"] = t(D.RETAB)
    for name in ("TG_F2", "TG_F3", "TG_AB", "TG_BB", "TG_ABP", "TG_BBP",
                 "TG_G1", "TG_G2", "TG_G3", "TG_G4"):
        c[name] = t(getattr(D, name))
    c["fat0"], c["fat1"] = t(D.FAT[0]), t(D.FAT[1])
    c["ww"] = t(_WINDOW_WEIGHTS)
    return c


@functools.cache
def _planck_nodes(nu1, nu2, n, device, dtype):
    """Midpoints and hc/k-scaled widths of n intervals of [nu1, nu2] cm-1,
    as tensors on (device, dtype)."""
    nus = np.linspace(nu1, nu2, n + 1)
    return (torch.as_tensor(0.5 * (nus[:-1] + nus[1:]), dtype=dtype,
                            device=device),
            torch.as_tensor(np.diff(nus) * _HCK, dtype=dtype, device=device))


# ==========================================================================
# helpers
# ==========================================================================

def reltab(t, landfrac=None, icefrac=None, snowh=None, landm=None):
    """Liquid effective radius (um); ref module_ra_cam_support.F:2301."""
    kw = dict(dtype=t.dtype, device=t.device)
    if landfrac is None:
        landfrac = torch.ones(t.shape[0], **kw)
    if icefrac is None:
        icefrac = torch.zeros(t.shape[0], **kw)
    if snowh is None:
        snowh = torch.zeros(t.shape[0], **kw)
    if landm is None:
        landm = landfrac
    tmelt = 273.16
    rliqocean, rliqice, rliqland = 14.0, 14.0, 8.0
    rel = rliqland + (rliqocean - rliqland) * torch.clamp(
        (tmelt - t) * 0.05, 0.0, 1.0)
    rel = rel + (rliqocean - rel) * torch.clamp(snowh[:, None] * 10.0,
                                                0.0, 1.0)
    rel = rel + (rliqocean - rel) * torch.clamp(1.0 - landm[:, None],
                                                0.0, 1.0)
    rel = rel + (rliqice - rel) * torch.clamp(icefrac[:, None], 0.0, 1.0)
    return rel


def reitab(t):
    """Ice effective radius (um) from the hexagonal-column table;
    ref module_ra_cam_support.F:2361-2384."""
    retab = _consts(t.device, t.dtype)["retab"]
    idx = torch.clamp(torch.floor(t - 179.0).to(torch.int64), 1, 94) - 1
    corr = t - torch.floor(t)
    return retab[idx] * (1.0 - corr) \
        + retab[torch.clamp(idx + 1, max=94)] * corr


def cldems(cwp_gm2, fice, rei):
    """Cloud LW emissivity; ref module_ra_cam_support.F:2137-2148.
    cwp in g/m2 (in-cloud)."""
    kabsi = 0.005 + 1.0 / torch.clamp(rei, min=1e-6)
    kabs = D.KABSL * (1.0 - fice) + kabsi * fice
    return 1.0 - torch.exp(-1.66 * kabs * torch.clamp(cwp_gm2, min=0.0))


def _planck_frac(t, nu1, nu2, n=24):
    """Fraction of blackbody emission between wavenumbers nu1..nu2 cm-1."""
    mid, dnu = _planck_nodes(float(nu1), float(nu2), n, t.device, t.dtype)
    t = torch.clamp(t, min=100.0)
    x = _HCK * mid / t[..., None]                             # (..., n)
    b = x ** 3 / torch.expm1(torch.clamp(x, max=60.0))
    # normalized: integral of x^3/(e^x-1) dx over 0..inf = pi^4/15
    return torch.sum(b * dnu / t[..., None], dim=-1) * (15.0 / np.pi ** 4)


def _max_overlap_configs(cld, cldmin=1e-3):
    """Binary cloud configurations for maximum overlap (single region;
    module_ra_cam.F:6665-6707): breakpoints are the sorted values of
    (1 - cld); configuration j covers the uniform-draw interval
    (b_j, b_{j+1}) and holds every cloud with 1 - cld <= b_j.
    Returns (present (nC, nz+1, nz) bool, weights (nC, nz+1))."""
    nC = cld.shape[0]
    kw = dict(dtype=cld.dtype, device=cld.device)
    a = torch.where(cld >= cldmin, 1.0 - cld, 1.0)
    c = torch.sort(a, dim=-1).values                          # ascending
    lo = torch.cat([torch.zeros((nC, 1), **kw), c], -1)       # (nC, nz+1)
    hi = torch.cat([c, torch.ones((nC, 1), **kw)], -1)
    w = torch.clamp(hi - lo, min=0.0)
    present = a[:, None, :] <= lo[:, :, None] + 1e-12         # (nC,nz+1,nz)
    present = present & (cld >= cldmin)[:, None, :]
    return present, w


# ==========================================================================
# shortwave: radcswmx
# ==========================================================================

def _sw_layer_props(tau, w0, g, f, mu0):
    """Delta-Eddington layer properties, the raddedmx statement functions
    (module_ra_cam.F:7473-7481 + body :7484-7520)."""
    ts = (1.0 - w0 * f) * tau
    ws = torch.clamp((1.0 - f) * w0 / (1.0 - w0 * f), 1e-12, 0.999999)
    gs = (g - f) / (1.0 - f)
    lm = torch.sqrt(3.0 * (1.0 - ws) * (1.0 - ws * gs))
    denom = 1.0 - lm ** 2 * mu0 ** 2
    denom = torch.where(torch.abs(denom) < 1e-7,
                        torch.sign(denom) * 1e-7 + 1e-12, denom)
    alp = 0.75 * ws * mu0 * (1.0 + gs * (1.0 - ws)) / denom
    gam = 0.50 * ws * (3.0 * gs * (1.0 - ws) * mu0 ** 2 + 1.0) / denom
    ue = 1.5 * (1.0 - ws * gs) / lm
    extins = torch.exp(-torch.clamp(lm * ts, max=25.0))
    ne = (ue + 1.0) ** 2 / extins - (ue - 1.0) ** 2 * extins
    rdif = (ue + 1.0) * (ue - 1.0) * (1.0 / extins - extins) / ne
    tdif = 4.0 * ue / ne
    explay = torch.exp(-torch.clamp(ts / mu0, max=25.0))
    apg = alp + gam
    amg = alp - gam
    rdir = amg * (tdif * explay - 1.0) + apg * rdif
    tdir = apg * tdif + (amg * rdif - (apg - 1.0)) * explay
    return (torch.clamp(rdir, min=0.0), torch.clamp(tdir, min=0.0),
            torch.clamp(rdif, min=0.0), torch.clamp(tdif, min=0.0), explay)


def _adding(rdir, tdir, rdif, tdif, explay, albdir, albdif):
    """Adding method over layers (axis -1 = layer, top first); batch dims
    lead. The radcswmx recursions (module_ra_cam.F:6957-7093).

    Returns per-interface (exptdn, rdndif, tdntot, rupdir, rupdif), each
    with a trailing interface axis of length L+1 (views of interface-major
    tensors). The downward pass starts from (1, 0, 1) at the top
    interface; the upward pass from the surface albedos at the bottom one
    and walks the layers from the bottom up.
    """
    # layer-major and contiguous: each layer's slice is one dense block
    # (a no-op for radcswmx's mixed properties, a small copy for the
    # clear-sky pass)
    xs = [a.movedim(-1, 0).contiguous()
          for a in (rdir, tdir, rdif, tdif, explay)]
    L = xs[0].shape[0]
    batch = torch.broadcast_shapes(*[a.shape[1:] for a in xs])
    kw = dict(dtype=rdir.dtype, device=rdir.device)
    exptdn, rdndif, tdntot, rupdir, rupdif = [
        torch.empty((L + 1,) + batch, **kw) for _ in range(5)]
    exptdn[0] = 1.0
    rdndif[0] = 0.0
    tdntot[0] = 1.0
    for k in range(L):
        yrdir, ytdir, yrdnd, ytdnd, yexpl = [a[k] for a in xs]
        xexpt, xrdnd, xtdnt = exptdn[k], rdndif[k], tdntot[k]
        rdenom = 1.0 / (1.0 - yrdnd * xrdnd)
        rdirexp = yrdir * xexpt
        tdnmexp = xtdnt - xexpt
        torch.mul(xexpt, yexpl, out=exptdn[k + 1])
        rdndif[k + 1] = yrdnd + xrdnd * ytdnd ** 2 * rdenom
        tdntot[k + 1] = xexpt * ytdir \
            + ytdnd * (tdnmexp + xrdnd * rdirexp) * rdenom
    rupdir[L] = albdir
    rupdif[L] = albdif
    for k in range(L - 1, -1, -1):
        yrdir, ytdir, yrupd, ytupd, yexpt = [a[k] for a in xs]
        xrups, xrupd = rupdir[k + 1], rupdif[k + 1]
        rdenom = 1.0 / (1.0 - yrupd * xrupd)
        tdnmexp = ytdir - yexpt
        rdirexp = xrups * yexpt
        rupdif[k] = yrupd + xrupd * ytupd ** 2 * rdenom
        rupdir[k] = yrdir + ytupd * (rdirexp + xrupd * tdnmexp) * rdenom
    return tuple(a.movedim(0, -1)
                 for a in (exptdn, rdndif, tdntot, rupdir, rupdif))


def radcswmx(pint, pmid, t, qv, o3mmr, cld, cliqwp, cicewp, rel, rei,
             coszrs, asdir, asdif, aldir=None, aldif=None,
             solcon=1367.0, co2vmr=3.55e-4, eccf=1.0):
    """Shortwave; all arrays TOP-DOWN (index 0 = model top).

    pint (nC, nz+1) Pa (pint[:,0]=model-top pressure), pmid (nC, nz) Pa,
    qv/o3mmr mass mixing ratios, cld cloud fraction, cliqwp/cicewp
    IN-CLOUD water paths per layer (g/m2), rel/rei effective radii (um),
    coszrs/albedos (nC,). Returns dict of fluxes (W/m2, positive down)
    and qrs (K/s), all top-down.
    """
    dtype, device = t.dtype, t.device
    kw = dict(dtype=dtype, device=device)
    cst = _consts(device, dtype)
    nC, nz = pmid.shape
    if aldir is None:
        aldir = asdir
    if aldif is None:
        aldif = asdif

    mu_raw = coszrs
    day = (mu_raw > 1e-4).to(dtype)
    mu = torch.clamp(mu_raw, 0.01, 1.0)[:, None]              # (nC,1)

    # --- CGS pressures incl. the extra above-model-top layer ------------
    pnm = pint * 10.0                                         # dyn/cm2
    pflx = torch.cat([torch.zeros((nC, 1), **kw), pnm], -1)   # (nC,nz+2)
    g = D.GRAVIT_CGS
    rga = 1.0 / g
    tmp1 = 0.5 / (g * D.SSLP_CGS)
    tmp2 = D.DELTA_H2O / g
    sqrco2 = float(np.sqrt(co2vmr * D.AMCO2 / D.AMD))
    zenfac = torch.sqrt(mu)

    # layer absorber amounts, L = nz+1 layers (index 0 = extra layer)
    ptop = pflx[:, 1:2]
    h2ostr0 = torch.sqrt(1.0 / torch.clamp(qv[:, :1], min=1e-12))
    uh2o0 = qv[:, :1] * (ptop ** 2 * tmp1
                         + ptop * rga * h2ostr0 * zenfac * D.DELTA_H2O)
    uo30 = o3mmr[:, :1] * ptop * rga
    uco20 = zenfac * sqrco2 * ptop * rga
    uo20 = zenfac * D.O2MMR * ptop * rga

    pdel = pnm[:, 1:] - pnm[:, :-1]                           # (nC, nz)
    path = pdel * rga
    h2ostr = torch.sqrt(1.0 / torch.clamp(qv, min=1e-12))
    uh2o = qv * ((pnm[:, 1:] ** 2 - pnm[:, :-1] ** 2) * tmp1
                 + pdel * h2ostr * zenfac * tmp2)
    uo3 = o3mmr * path
    uco2 = zenfac * sqrco2 * path
    uo2 = zenfac * D.O2MMR * path

    uh2o = torch.cat([uh2o0, uh2o], -1)                       # (nC, L)
    uo3 = torch.cat([uo30, uo3], -1)
    uco2 = torch.cat([uco20, uco2], -1)
    uo2 = torch.cat([uo20, uo2], -1)
    pdel_flx = pflx[:, 1:] - pflx[:, :-1]                     # (nC, L)

    # --- per-interval layer optics (19, nC, L) --------------------------
    al, bl, cl, dl, el, fl = [cst[n] for n in ("ABARL", "BBARL", "CBARL",
                                               "DBARL", "EBARL", "FBARL")]
    ai, bi, ci, di, ei, fi = [cst[n] for n in ("ABARI", "BBARI", "CBARI",
                                               "DBARI", "EBARI", "FBARI")]
    relx = torch.clamp(rel, min=4.0)[None]                    # (1,nC,nz)
    reix = torch.clamp(rei, min=4.0)[None]
    has_cld = (cld >= 1e-3)[None]
    tauxcl_m = torch.where(has_cld, cliqwp[None] * (al + bl / relx), 0.0)
    tauxci_m = torch.where(has_cld, cicewp[None] * (ai + bi / reix), 0.0)
    wcl_m = torch.clamp(1.0 - cl - dl * relx, max=0.999999)
    gcl_m = el + fl * relx
    wci_m = torch.clamp(1.0 - ci - di * reix, max=0.999999)
    gci_m = ei + fi * reix

    # extra layer: no cloud (module_ra_cam.F:6224-6231)
    zl = torch.zeros((D.NSPINT, nC, 1), **kw)
    tauxcl = torch.cat([zl, tauxcl_m], -1)                    # (19,nC,L)
    tauxci = torch.cat([zl, tauxci_m], -1)
    wcl = torch.cat([torch.full_like(zl, 0.999999), wcl_m], -1)
    gcl = torch.cat([torch.full_like(zl, 0.85), gcl_m], -1)
    wci = torch.cat([torch.full_like(zl, 0.999999), wci_m], -1)
    gci = torch.cat([torch.full_like(zl, 0.85), gci_m], -1)
    fcl = gcl ** 2
    fci = gci ** 2

    tauray = cst["trayoslp"] * pdel_flx[None]                 # (19,nC,L)
    taugab = (cst["ABH2O"] * uh2o[None] + cst["ABO3"] * uo3[None]
              + cst["ABCO2"] * uco2[None] + cst["ABO2"] * uo2[None])

    def combine(taucl, tauci):
        tautot = taucl + tauci + tauray + taugab
        taucsc = taucl * wcl + tauci * wci
        wtau = D.WRAY * tauray
        wt = wtau + taucsc
        wtot = wt / torch.clamp(tautot, min=1e-30)
        gtot = (wtau * D.GRAY + gcl * wcl * taucl
                + gci * wci * tauci) / torch.clamp(wt, min=1e-30)
        ftot = (wtau * D.FRAY + fcl * wcl * taucl
                + fci * wci * tauci) / torch.clamp(wt, min=1e-30)
        return tautot, torch.clamp(wtot, 0.0, 0.999999), gtot, ftot

    mu_b = mu[None]                                           # (1,nC,1)
    props_cld = _sw_layer_props(*combine(tauxcl, tauxci), mu_b)
    zero = torch.zeros_like(tauxcl)
    props_clr = _sw_layer_props(*combine(zero, zero), mu_b)
    del tauxcl, tauxci, wcl, gcl, wci, gci, fcl, fci, zero

    # --- cloud configurations (max overlap) -----------------------------
    present, wcfg = _max_overlap_configs(cld)                 # (nC,NCFG,nz)
    NCFG = wcfg.shape[1]
    pres = torch.cat([torch.zeros((nC, NCFG, 1), dtype=torch.bool,
                                  device=device), present], -1)
    # layer props with the configuration's choice, layer-major
    # (L, 19, nC, NCFG) so that each layer of the adding loops is one
    # contiguous slice; passed to _adding with the layer axis last. The
    # select's inputs are made layer-major first: torch lays a result out
    # in the order of its inputs' strides
    pres_l = pres.permute(2, 0, 1).contiguous()[:, None]      # (L,1,nC,NCFG)
    mix = [torch.where(pres_l, c.permute(2, 0, 1).contiguous()[..., None],
                       r.permute(2, 0, 1).contiguous()[..., None])
           .movedim(0, -1) for c, r in zip(props_cld, props_clr)]
    del props_cld, pres, pres_l, present

    vis = cst["vis"]                                          # (19,1)
    albdir = torch.where(vis, asdir[None], aldir[None])       # (19,nC)
    albdif = torch.where(vis, asdif[None], aldif[None])

    exptdn, rdndif, tdntot, rupdir, rupdif = _adding(
        *mix, albdir[:, :, None], albdif[:, :, None])         # (...,L+1)
    del mix

    rdenom = 1.0 / (1.0 - rdndif * rupdif)
    fluxup = (exptdn * rupdir + (tdntot - exptdn) * rupdif) * rdenom
    fluxdn = exptdn + (tdntot - exptdn
                       + exptdn * rupdir * rdndif) * rdenom
    del rdenom, rdndif, tdntot, rupdir, rupdif
    # weight configs
    wc = wcfg[None, :, :, None]
    fluxup = torch.sum(fluxup * wc, 2)                        # (19,nC,L+1)
    fluxdn = torch.sum(fluxdn * wc, 2)
    wexptdn = torch.sum(exptdn[..., -1] * wcfg[None], 2)      # (19,nC)
    del exptdn

    # clear-sky pass (single all-clear config)
    cexp, crdn, ctdn, crus, crud = _adding(*props_clr, albdir, albdif)
    crden = 1.0 / (1.0 - crdn * crud)
    fluxupc = (cexp * crus + (ctdn - cexp) * crud) * crden
    fluxdnc = cexp + (ctdn - cexp + cexp * crus * crdn) * crden

    solin = solcon * eccf * mu_raw * day                      # (nC,)
    solflx = solin[None] * cst["frcsol"]                      # (19,nC)

    def spectral_sum(fup, fdn):
        up = torch.sum(solflx[..., None] * fup, 0)            # (nC, L+1)
        dn = torch.sum(solflx[..., None] * fdn, 0)
        return up, dn

    fswup, fswdn = spectral_sum(fluxup, fluxdn)
    fswupc, fswdnc = spectral_sum(fluxupc, fluxdnc)

    net = fswdn - fswup                                       # (nC, L+1)
    netc = fswdnc - fswupc
    # heating for the nz model layers (interfaces 1..L)
    flxdiv = net[:, 1:-1] - net[:, 2:]                        # (nC, nz)
    qrs = flxdiv * GRAV_SI / (CP * (pint[:, 1:] - pint[:, :-1]))

    sols = torch.sum(torch.where(vis, wexptdn * solflx, 0.0), 0)
    soll = torch.sum(torch.where(~vis, wexptdn * solflx, 0.0), 0)
    solsd = torch.sum(torch.where(vis, (fluxdn[..., -1] - wexptdn)
                                  * solflx, 0.0), 0)
    solld = torch.sum(torch.where(~vis, (fluxdn[..., -1] - wexptdn)
                                  * solflx, 0.0), 0)
    fsnirtoa = torch.sum(cst["nirwgt"] * solflx
                         * (fluxdn[..., 0] - fluxup[..., 0]), 0)

    return {
        "qrs": qrs,
        "solin": solin,
        "fsns": net[:, -1], "fsnsc": netc[:, -1],
        "fsnt": net[:, 1], "fsntc": netc[:, 1],
        "fsntoa": net[:, 0], "fsntoac": netc[:, 0],
        "fsds": fswdn[:, -1], "fsdsc": fswdnc[:, -1],
        "sols": sols, "soll": soll, "solsd": solsd, "solld": solld,
        "fsnirtoa": fsnirtoa,
        "fswdn": fswdn, "fswup": fswup,
    }


# ==========================================================================
# longwave: radclwmx with analytic band models
# ==========================================================================

def _fh2oself(t):
    """Self-continuum temperature scaling; support.F:2743-2771."""
    return 2.0727484 ** ((296.0 - t) / 36.0)


def _pairdiff(x):
    """|x[..., i] - x[..., j]| -> (..., P, P)."""
    return torch.abs(x[..., :, None] - x[..., None, :])


def radclwmx(pint, pmid, t, qv, o3mmr, cld, cwp_gm2, fice, rei, lwups,
             co2vmr=3.55e-4, n2ovmr=0.311e-6, ch4vmr=1.714e-6,
             cfc11vmr=0.280e-9, cfc12vmr=0.503e-9, emis_sfc=1.0):
    """Longwave; all arrays TOP-DOWN. pint (nC, nz+1) Pa, lwups = surface
    upward LW flux (W/m2, = emis*sigma*Tsk^4 + refl). Returns dict with
    qrl (K/s), flns/flnt/flut/flwds and clear-sky variants, top-down."""
    dtype, device = t.dtype, t.device
    cst = _consts(device, dtype)
    nC, nz = pmid.shape
    P = nz + 1                                                # interfaces
    g = D.GRAVIT_CGS
    rga = 1.0 / g
    sslp = D.SSLP_CGS
    rgsslp = 0.5 / (g * sslp)
    stebol = D.STEBOL_CGS
    diff = D.LW_DIFF

    pnm = pint * 10.0                                         # dyn/cm2
    lwup_cgs = lwups * 1.0e3                                  # erg/cm2/s

    # ---- radtpl: path quantities at interfaces -------------------------
    dpnm = pnm[:, 1:] - pnm[:, :-1]                           # (nC, nz)
    dpnmsq = pnm[:, 1:] ** 2 - pnm[:, :-1] ** 2
    dw = rga * qv * dpnm

    def cumint(first, incr):
        return torch.cat([first[:, None],
                          first[:, None] + torch.cumsum(incr, -1)], -1)

    plh2o = cumint(rgsslp * qv[:, 0] * pnm[:, 0] ** 2, rgsslp * dpnmsq * qv)
    w = cumint(sslp * plh2o[:, 0] * 2.0 / pnm[:, 0], dw)
    tcg = cumint(rga * qv[:, 0] * pnm[:, 0] * t[:, 0], dw * t)
    s2c = cumint(plh2o[:, 0] * _fh2oself(t[:, 0]) * qv[:, 0] / D.EPSILO,
                 rgsslp * dpnmsq * qv ** 2 * _fh2oself(t) / D.EPSILO)
    pbar = 0.5 * (pnm[:, 1:] + pnm[:, :-1]) / sslp
    dpnm_g = dpnm * rga
    uptype = cumint(
        diff * qv[:, 0] * pnm[:, 0] ** 2
        * torch.exp(1800.0 * (1.0 / t[:, 0] - 1.0 / 296.0)) * rga / sslp,
        diff * qv * torch.exp(1800.0 * (1.0 / t - 1.0 / 296.0))
        * pbar * dpnm_g)
    cpwpl = D.AMCO2 / D.AMD * 0.5 / (g * sslp)
    plco2 = co2vmr * cpwpl * pnm ** 2                         # (nC, P)
    plos = cumint(o3mmr[:, 0] * pnm[:, 0] * rga, o3mmr * dpnm_g)
    plol = cumint(o3mmr[:, 0] * pnm[:, 0] ** 2 * rgsslp,
                  o3mmr * dpnmsq * rgsslp)

    # interface temperatures (radtpl :4436-4460)
    piln = torch.log(torch.clamp(pnm, min=1.0))
    pmln = torch.log(pmid * 10.0)
    tint_sfc = (lwup_cgs / stebol) ** 0.25
    dy = (piln[:, 1:-1] - pmln[:, 1:]) / (pmln[:, :-1] - pmln[:, 1:])
    tint_mid = t[:, 1:] - dy * (t[:, 1:] - t[:, :-1])
    tint = torch.cat([t[:, :1], tint_mid, tint_sfc[:, None]], -1)
    tint4 = tint ** 4
    tlayr = torch.cat([tint[:, :1], t], -1)                   # (nC, P)
    tplnka = torch.cat([t[:, :1], 0.5 * (tint[:, 1:] + tint[:, :-1])], -1)
    tplnke = tplnka[:, 0]
    # Curtis-Godson pressure-weighted temperature for CO2/O3
    co2t_sum = cumint(tplnke * pnm[:, 0], tlayr[:, 1:] * dpnm)
    co2t = co2t_sum / pnm

    # trace-gas paths (trcpth :1518-1668); vmr -> mmr internally via the
    # published per-gas path constants (they absorb the mass conversion)
    n2o = n2ovmr * 44.0128 / D.AMD * torch.ones_like(qv)
    ch4 = ch4vmr * 16.043 / D.AMD * torch.ones_like(qv)
    cfc11 = cfc11vmr * 137.3686 / D.AMD * torch.ones_like(qv)
    cfc12 = cfc12vmr * 120.9140 / D.AMD * torch.ones_like(qv)
    co2mmr = co2vmr * D.AMCO2 / D.AMD
    rsq = 1.0 / torch.sqrt(t)
    a1 = diff * rsq * (1.0 - torch.exp(-1540.0 / t)) ** 3
    a2 = diff * rsq * (1.0 - torch.exp(-1360.0 / t)) ** 3
    t0 = t[:, 0]
    p0 = pnm[:, 0]
    ucfc11 = cumint(1.8 * cfc11[:, 0] * p0 * rga, 1.8 * cfc11 * dpnm_g)
    ucfc12 = cumint(1.8 * cfc12[:, 0] * p0 * rga, 1.8 * cfc12 * dpnm_g)
    un2o0 = cumint(diff * 1.02346e5 * n2o[:, 0] * p0 * rga / torch.sqrt(t0),
                   diff * 1.02346e5 * n2o * rsq * dpnm_g)
    un2o1 = cumint(diff * 2.01909 * (diff * 1.02346e5 * n2o[:, 0] * p0
                                     * rga / torch.sqrt(t0))
                   * torch.exp(-847.36 / t0),
                   diff * 2.06646e5 * n2o * rsq
                   * torch.exp(-847.36 / t) * dpnm_g)
    uch4 = cumint(diff * 8.60957e4 * ch4[:, 0] * p0 * rga / torch.sqrt(t0),
                  diff * 8.60957e4 * ch4 * rsq * dpnm_g)
    co2fac0 = diff * co2mmr * p0 * rga
    a10 = (1.0 - torch.exp(-1540.0 / t0)) ** 3 / torch.sqrt(t0)
    a20 = (1.0 - torch.exp(-1360.0 / t0)) ** 3 / torch.sqrt(t0)

    def co2minor(c, texp, alpha, alpha0):
        return cumint(c * co2fac0 * alpha0 * torch.exp(-texp / t0),
                      1.15 * c * alpha * co2mmr
                      * torch.exp(-texp / t) * dpnm_g)

    uco211 = co2minor(3.42217e3, 1849.7, a1, a10)
    uco212 = co2minor(6.02454e3, 2782.1, a1, a10)
    uco213 = co2minor(5.53143e3, 3723.2, a1, a10)
    uco221 = co2minor(3.88984e3, 1997.6, a2, a20)
    uco222 = co2minor(3.67108e3, 3843.8, a2, a20)
    uco223 = co2minor(6.50642e3, 2989.7, a2, a20)
    bn2o0 = cumint(diff * 19.399 * p0 ** 2 * n2o[:, 0] * 1.02346e5
                   * rga / (sslp * t0),
                   diff * 19.399 * pbar / t * 1.02346e5 * n2o * dpnm_g)
    # top term uses the increment-consistent 2.06646e5/1.02346e5 ratio,
    # as the reference does
    bn2o1 = cumint(diff * 19.399 * p0 ** 2 * n2o[:, 0] * 2.06646e5
                   * rga / (sslp * t0) * torch.exp(-847.36 / t0),
                   diff * 19.399 * pbar / t * 2.06646e5
                   * torch.exp(-847.36 / t) * n2o * dpnm_g)
    bch4 = cumint(diff * 2.94449 * ch4[:, 0] * p0 ** 2 * rga
                  * 8.60957e4 / (sslp * t0),
                  diff * 2.94449 / t * pbar * 8.60957e4 * ch4 * dpnm_g)

    # Planck factors (trcplk :1426-1516); CGS, normalized for the
    # absorptivity exchange integral
    tint_b = tint[:, :, None]                                 # (nC,P,1)
    ex_b = torch.exp(cst["TG_F3"] / tint_b)
    abplnk1 = (cst["TG_F2"] * ex_b) \
        / (tint_b ** 5 * (ex_b - 1.0) ** 2)                   # (nC,P,14)

    # CO2 15um Planck factor (radabs :4332-4334)
    ex960 = torch.exp(960.0 / tint)
    co2em = 1.2e11 * ex960 / (tint * tint4 * (ex960 - 1.0) ** 2)
    # O3 9.6um Planck derivative factor (dbvt, radabs :2407)
    dbvtit = ((-2.8911366682e-4 + (2.3771251896e-6
                                   + 1.1305188929e-10 * tint) * tint)
              / (1.0 + (-6.1364820707e-3
                        + 1.5550319767e-5 * tint) * tint))
    h2otr_if = torch.exp(-12.0 * s2c)                         # (nC, P)

    # ---- pairwise path differences (nC, P, P) --------------------------
    du_pl = _pairdiff(plh2o)
    du_w = torch.clamp(_pairdiff(w), min=1e-12)
    du_s2c = _pairdiff(s2c)
    du_upt = _pairdiff(uptype)
    du_tcg = _pairdiff(tcg)
    du_plos = torch.clamp(_pairdiff(plos), min=1e-20)
    du_plol = torch.clamp(_pairdiff(plol), min=1e-24)
    du_plco2 = _pairdiff(plco2)
    dpnm_pair = torch.clamp(_pairdiff(pnm), min=1.0)

    # absorbing-level quantities: index j = emitting/receiving column k2
    tpl_j = tplnka[:, None, :]                                # Planck T
    dtx = tpl_j - 250.0
    # Curtis-Godson path temperature between the pair
    tpath = du_tcg / du_w
    dty = tpath - 250.0
    u = torch.clamp(du_pl, min=1e-12)
    sqrtu = torch.sqrt(u)
    fwk = D.FWCOEF + D.FWC1 / (1.0 + D.FWC2 * u)
    fwku = fwk * u
    pnew = u / du_w

    # H2O 500-800 cm-1 line transmissions (radabs :2865-2889)
    cj, ck, ch = D.COEFJ.tolist(), D.COEFK.tolist(), D.COEFH.tolist()
    c16, c17, c26, c27 = (float(D.C16), float(D.C17), float(D.C26),
                          float(D.C27))
    t7_1 = cj[0][0] + cj[0][1] * dty * (1.0 + c16 * dty)
    t8_1 = ck[0][0] + ck[0][1] * dty * (1.0 + c17 * dty)
    t7_2 = cj[1][0] + cj[1][1] * dty * (1.0 + c26 * dty)
    t8_2 = ck[1][0] + ck[1][1] * dty * (1.0 + c27 * dty)
    k21 = t7_1 + t8_1 / (1.0 + (D.C30 + D.C31 * (dty - 10.0) ** 2) * sqrtu)
    k22 = t7_2 + t8_2 / (1.0 + (D.C28 + D.C29 * (dty - 10.0)) * sqrtu)
    tr1 = torch.exp(-torch.clamp(k21 * (sqrtu + D.FC1 * fwku), max=60.0))
    tr2 = torch.exp(-torch.clamp(k22 * (sqrtu + D.FC1 * fwku), max=60.0))
    uc1 = (du_s2c + 1.7e-3 * u) * (1.0 + 2.0 * du_s2c) \
        / (1.0 + 15.0 * du_s2c)
    tr5 = torch.exp(-torch.clamp((ch[2][0] + ch[2][1] * dtx) * uc1,
                                 max=60.0))
    tr6 = torch.exp(-torch.clamp((ch[3][0] + ch[3][1] * dtx) * uc1,
                                 max=60.0))
    tr9 = tr1 * tr5
    tr10 = tr2 * tr6
    th2o = tr10
    trab2 = 0.65 * tr9 + 0.35 * tr10

    # window sub-band transmissions tw_l (trcab :556-567)
    ds2c_b = du_s2c[..., None]
    dupt_b = du_upt[..., None]
    dty_b = dty[..., None]
    psi1 = torch.exp(cst["TG_ABP"] * torch.abs(dty_b)
                     + cst["TG_BBP"] * dty_b ** 2)
    phi1 = torch.exp(cst["TG_AB"] * torch.abs(dty_b)
                     + cst["TG_BB"] * dty_b ** 2)
    p1w = pnew[..., None] * (psi1 / phi1) / sslp
    w1w = du_w[..., None] * phi1
    tw = torch.exp(-cst["TG_G1"] * p1w
                   * (torch.sqrt(1.0 + cst["TG_G2"]
                                 * (w1w / torch.clamp(p1w, min=1e-12)))
                      - 1.0)
                   - cst["TG_G3"] * ds2c_b
                   - cst["TG_G4"] * dupt_b)                   # (nC,P,P,6)
    del psi1, phi1, p1w, w1w, ds2c_b, dupt_b, dty_b

    # ---- H2O broadband absorptivity ------------------------------------
    # Planck band weights at the absorbing level (the fat polynomial,
    # support.F:161-168) split non-window/window; the non-window is
    # sub-weighted by Planck quadrature at T_e across its three regions.
    te = tpl_j
    powers = torch.stack([te ** i for i in range(6)], -1)
    f_nw = torch.clamp(powers @ cst["fat0"], 0.0, 1.0)
    f_w = torch.clamp(powers @ cst["fat1"], 0.0, 1.0)
    te_if = tplnka                                            # (nC, P)
    b_rot, b_56, b_12 = [_planck_frac(te_if, *b) for b in _PLANCK_BANDS]
    b_sum = torch.clamp(b_rot + b_56 + b_12, min=1e-6)
    w_rot = (b_rot / b_sum)[:, None, :]
    w_56 = (b_56 / b_sum)[:, None, :]
    w_12 = (b_12 / b_sum)[:, None, :]

    # rotation-band transmission: R&D-form sqrt growth with far-wing
    # correction
    K_ROT = 9.0
    t_rot = torch.exp(-K_ROT * (sqrtu + 0.8 * fwku))
    tlw = torch.exp(-torch.sqrt(du_pl))                       # 1200-2200
    t_nw = w_rot * t_rot + w_56 * 0.5 * (tr1 + tr2) + w_12 * tlw
    a_nw = f_nw * (1.0 - t_nw)

    # window: width-weighted tw sub-bands (820-1170) + continuum wings
    t_win = torch.sum(tw * cst["ww"], -1)
    a_w = f_w * (1.0 - t_win)
    abs_h2o = a_nw + a_w

    # ---- CO2 15um (Kiehl-Briegleb 1991; radabs :2924-2966) -------------
    dp_signed = pnm[:, :, None] - pnm[:, None, :]
    degen = torch.abs(dp_signed) < 1e-6
    to3co2 = (pnm[:, :, None] * co2t[:, :, None]
              - pnm[:, None, :] * co2t[:, None, :]) \
        / torch.where(degen, 1.0, dp_signed)
    to3co2 = torch.where(degen, co2t[:, None, :]
                         * torch.ones_like(to3co2), to3co2)
    sqwp = torch.sqrt(du_plco2)
    et = torch.exp(-480.0 / to3co2)
    sqti = torch.sqrt(to3co2)
    rsqti = 1.0 / sqti
    et2 = et * et
    et4 = et2 * et2
    omet = 1.0 - 1.5 * et2
    f1co2 = 899.70 * omet * (1.0 + 1.94774 * et + 4.73486 * et2) * rsqti
    f1sqwp = f1co2 * sqwp
    t1co2 = 1.0 / (1.0 + 245.18 * omet * sqwp * rsqti)
    oneme = 1.0 - et2
    alphat = oneme ** 3 * rsqti
    wco2 = 2.5221 * co2vmr * dpnm_pair * rga
    u7 = 4.9411e4 * alphat * et2 * wco2
    u8 = 3.9744e4 * alphat * et4 * wco2
    u9 = 1.0447e5 * alphat * et4 * et2 * wco2
    u13 = 2.8388e3 * alphat * et4 * wco2
    tlocal = tint[:, None, :]
    tcrfac = torch.sqrt(tlocal * (1.0 / 250.0) * to3co2 * (1.0 / 300.0))
    posqt = ((pnm[:, :, None] + pnm[:, None, :]) * (0.5 / sslp)
             + 5.0e-3 * tcrfac) * rsqti
    rbeta7 = 1.0 / (5.3228 * posqt)
    rbeta8 = 1.0 / (10.6576 * posqt)

    def kbfunc(uu, rb):
        return uu / torch.sqrt(4.0 + uu * (1.0 + rb))

    f2co2 = (kbfunc(u7, rbeta7) + kbfunc(u8, rbeta8)
             + kbfunc(u9, rbeta7))
    f3co2 = kbfunc(u13, rbeta7)
    # sqti in absbnd: sqrt(tlayr(k2)) for downward pairs, else the
    # path temperature (radabs :2956-2960)
    ii_ = torch.arange(P, device=device)[None, :, None]
    jj_ = torch.arange(P, device=device)[None, None, :]
    sqti_abs = torch.where(jj_ >= ii_,
                           torch.sqrt(tlayr[:, None, :])
                           * torch.ones_like(to3co2), sqti)
    absbnd = (torch.log1p(f1sqwp) + 2.0 * t1co2 * torch.log1p(f2co2)
              + 2.0 * torch.log1p(f3co2)) * sqti_abs
    abs_co2 = trab2 * co2em[:, None, :] * absbnd
    tco2 = 1.0 / (1.0 + 10.0 * kbfunc(u7, rbeta7))

    # ---- O3 9.6um (Ramanathan-Dickinson 1979; radabs :2905-2922) -------
    te_o3 = (to3co2 / 293.0) ** 0.7
    u1 = 18.29 * du_plos / te_o3
    u2 = 0.5649 * du_plos / te_o3
    rphat = du_plol / du_plos
    tcrfac_o3 = torch.sqrt(tlocal / 250.0) * te_o3
    beta = (1.0 / 0.3205) * (rphat + 2.5e-3 * tcrfac_o3)
    realnu = te_o3 / beta
    o3tmp1 = u1 / torch.sqrt(4.0 + u1 * (1.0 + realnu))
    o3tmp2 = u2 / torch.sqrt(4.0 + u2 * (1.0 + realnu))
    o3bndi = 74.0 * te_o3 * torch.log1p(o3tmp1 + o3tmp2)
    # the h2otr ratio ordered by pair direction, so that it is the
    # transmission (<= 1) either way (radabs :2895-2903)
    r_ab = h2otr_if[:, :, None] / torch.clamp(h2otr_if[:, None, :],
                                              min=1e-12)
    to3h2o = torch.minimum(r_ab, 1.0 / torch.clamp(r_ab, min=1e-12))
    abs_o3 = o3bndi * to3h2o * dbvtit[:, None, :]
    to3 = 1.0 / (1.0 + 0.1 * o3tmp1 + 0.1 * o3tmp2)

    # ---- trace gases (trcab :600-717) ----------------------------------
    pd = _pairdiff
    du1 = pd(ucfc11)
    du2 = pd(ucfc12)
    tcfc3 = torch.exp(-175.005 * du1)
    tcfc4 = torch.exp(-1202.18 * du1)
    tcfc6 = torch.exp(-5786.73 * du2)
    tcfc7 = torch.exp(-2873.51 * du2)
    tcfc8 = torch.exp(-2085.59 * du2)
    ab1 = abplnk1[:, None, :, :]                              # (nC,1,P,14)

    def abp(i):                                               # 1-based
        return ab1[..., i - 1]

    def twl(i):
        return tw[..., i - 1]

    acfc1 = 50.0 * (1.0 - torch.exp(-54.09 * du1)) * twl(1) * abp(7)
    acfc2 = 60.0 * (1.0 - torch.exp(-5130.03 * du1)) * twl(2) * abp(8)
    acfc3 = 60.0 * (1.0 - tcfc3) * twl(4) * tcfc6 * abp(9)
    acfc4 = 100.0 * (1.0 - tcfc4) * twl(5) * abp(10)
    acfc5 = 45.0 * (1.0 - torch.exp(-1272.35 * du2)) * twl(3) * abp(11)
    acfc6 = 50.0 * (1.0 - tcfc6) * twl(4) * abp(12)
    acfc7 = 80.0 * (1.0 - tcfc7) * twl(5) * tcfc4 * abp(13)
    acfc8 = 70.0 * (1.0 - tcfc8) * twl(6) * abp(14)
    tlw_tr = torch.exp(-torch.sqrt(du_pl))
    duch4 = torch.clamp(pd(uch4), min=1e-20)
    dbetac = pd(bch4) / duch4
    sqti_tr = torch.sqrt(to3co2)

    def func(uu, b):
        return uu / torch.sqrt(4.0 + uu * (1.0 + 1.0
                                           / torch.clamp(b, min=1e-12)))

    ach4 = 6.00444 * sqti_tr * torch.log1p(func(duch4, dbetac)) \
        * tlw_tr * abp(3)
    tch4 = 1.0 / (1.0 + 0.02 * func(duch4, dbetac))
    du01 = torch.clamp(pd(un2o0), min=1e-20)
    du11 = torch.clamp(pd(un2o1), min=1e-20)
    dbeta01 = pd(bn2o0) / du01
    dbeta11 = pd(bn2o1) / du11
    an2o1 = 2.35558 * sqti_tr * torch.log1p(
        func(du01, dbeta01) + func(du11, dbeta11)) * tlw_tr * tch4 * abp(4)
    du02 = 0.100090 * du01
    du12 = 0.0992746 * du11
    dbeta02 = 0.964282 * dbeta01
    an2o2 = 2.65581 * sqti_tr * torch.log1p(
        func(du02, dbeta02) + func(du12, dbeta02)) * th2o * tco2 * abp(5)
    du03 = 0.0333767 * du01
    dbeta03 = 0.982143 * dbeta01
    an2o3 = 2.54034 * sqti_tr * torch.log1p(func(du03, dbeta03)) \
        * twl(6) * tcfc8 * abp(6)
    du11c = pd(uco211)
    du12c = pd(uco212)
    du13c = pd(uco213)
    dbetc1 = 2.97558 * (pnm[:, :, None] + pnm[:, None, :]) \
        / (2.0 * sslp * sqti_tr)
    dbetc2 = 2.0 * dbetc1
    aco21 = 3.7571 * sqti_tr * torch.log1p(
        func(du11c, dbetc1) + func(du12c, dbetc2) + func(du13c, dbetc2)) \
        * to3 * twl(5) * tcfc4 * tcfc7 * abp(2)
    du21 = pd(uco221)
    du22 = pd(uco222)
    du23 = pd(uco223)
    aco22 = 3.8443 * sqti_tr * torch.log1p(
        func(du21, dbetc1) + func(du22, dbetc1) + func(du23, dbetc2)) \
        * twl(4) * tcfc3 * tcfc6 * abp(1)
    abs_trc = (acfc1 + acfc2 + acfc3 + acfc4 + acfc5 + acfc6 + acfc7
               + acfc8 + an2o1 + an2o2 + an2o3 + ach4 + aco21 + aco22)

    abs_clr = torch.clamp(abs_h2o + abs_co2 + abs_o3 + abs_trc, 0.0, 1.0)
    eye = torch.eye(P, dtype=torch.bool, device=device)[None]
    abs_clr = torch.where(eye, 0.0, abs_clr)

    # ---- clouds: random-overlap transmission products ------------------
    emis = cldems(cwp_gm2, fice, rei) * torch.clamp(cld, 0.0, 1.0)
    logt = torch.log(torch.clamp(1.0 - emis, min=1e-12))
    clog = torch.cat([torch.zeros((nC, 1), dtype=dtype, device=device),
                      torch.cumsum(logt, -1)], -1)            # (nC, P)
    tcld = torch.exp(-_pairdiff(clog))
    abs_all = 1.0 - (1.0 - abs_clr) * tcld
    abs_all = torch.where(eye, 0.0, abs_all)

    # ---- exchange integral ---------------------------------------------
    b_lay = stebol * t ** 4                                   # (nC, nz)
    ii = torch.arange(P, device=device)[None, :, None]
    jj = torch.arange(nz, device=device)[None, None, :]
    above = jj < ii                                           # layer above i

    def fluxes(A):
        # dA(i, layer j) = A(i, j+1) - A(i, j) (interface pair columns);
        # emission of layer j reaching interface i is B_j times the
        # differential absorptivity of the path, A(i, far) - A(i, near):
        # for layers above, interface j is the far side (-dA); below, j+1
        dA = A[:, :, 1:] - A[:, :, :-1]                       # (nC,P,nz)
        fdn = torch.sum(torch.where(above, -dA, 0.0)
                        * b_lay[:, None, :], 2)               # (nC, P)
        fup = lwup_cgs[:, None] * (1.0 - A[:, :, -1]) \
            + torch.sum(torch.where(~above, dA, 0.0) * b_lay[:, None, :], 2)
        return fup * 1.0e-3, fdn * 1.0e-3                     # W/m2

    ful, fdl = fluxes(abs_all)
    fulc, fdlc = fluxes(abs_clr)

    net = ful - fdl                                           # (nC, P)
    netc = fulc - fdlc
    # absorbed by layer k = net upward in at bottom - out at top
    dp_si = pint[:, 1:] - pint[:, :-1]
    qrl = (net[:, 1:] - net[:, :-1]) * GRAV_SI / (CP * dp_si)
    qrlc = (netc[:, 1:] - netc[:, :-1]) * GRAV_SI / (CP * dp_si)

    return {
        "qrl": qrl, "qrlc": qrlc,
        "flnt": net[:, 0], "flntc": netc[:, 0],
        "flut": ful[:, 0], "flutc": fulc[:, 0],
        "flns": net[:, -1], "flnsc": netc[:, -1],
        "flwds": fdl[:, -1], "flwdsc": fdlc[:, -1],
        "ful": ful, "fdl": fdl,
    }
