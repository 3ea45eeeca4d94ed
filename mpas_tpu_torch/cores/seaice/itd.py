"""Linear-remapping ice-thickness-distribution transport (Lipscomb 2001)
(port of mpas_tpu/cores/seaice/itd.py).

ref capability: src/core_seaice/column/ice_itd.F90 (linear_itd /
fit_line / shift_ice). After the vertical thermodynamics changes each
category's mean thickness, the thickness distribution g(h) is advected in
thickness space: category boundaries are displaced with the ice, a linear
g(h) is fit inside each category from its area and mean thickness, and
the area/volume lying beyond the ORIGINAL boundaries moves to the
adjacent category. Transfers are adjacent-only: two boundary sweeps over
(nCells, nCat).

Tracers ride along: area-type tracers (surface temperature, pond area,
level-ice area, age) in proportion to the transferred area; ice-volume
tracers (enthalpy) in proportion to the transferred volume; snow volume
with the area fraction, as the reference does (ice_itd.F90 shift_ice
moves vsnon/esnon by donor area fraction).
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.cores.seaice.state import const_tensor


def _displaced_boundaries(hb, h_old, h_new, a, puny):
    """New positions of the interior category boundaries.

    ref: ice_itd.F90 linear_itd: boundary n moves by dh interpolated
    between the thickness changes of categories n and n+1, weighted by
    each category's distance from the boundary; an empty neighbour
    contributes its partner's dh.
    hb: (nB,) interior bounds; h_old/h_new/a: (nC, nCat)."""
    dh = h_new - h_old
    dh_lo, dh_hi = dh[:, :-1], dh[:, 1:]     # categories n, n+1 a boundary
    h_lo, h_hi = h_old[:, :-1], h_old[:, 1:]
    has_lo = a[:, :-1] > puny
    has_hi = a[:, 1:] > puny
    # inverse-distance interpolation of dh to the boundary position
    w_lo = torch.where(has_lo, (hb - h_lo).clamp(min=0.0), 0.0)
    w_hi = torch.where(has_hi, (h_hi - hb).clamp(min=0.0), 0.0)
    denom = w_lo + w_hi
    dhb = torch.where(
        has_lo & has_hi,
        (w_hi * dh_lo + w_lo * dh_hi) / denom.clamp(min=puny),
        torch.where(has_lo, dh_lo, torch.where(has_hi, dh_hi, 0.0)))
    return hb + dhb                          # (nC, nB)


def _fit_line(a, h, hl, hr, puny):
    """Linear g(eta) = g0 + g1*eta on [0, hr-hl] with integral a and mean
    thickness h, clipped so that g >= 0 (ref: ice_itd.F90 fit_line).
    Returns (g0, g1, etamin, etamax, width)."""
    w = (hr - hl).clamp(min=puny)
    eta_bar = ((h - hl) / w).clamp(0.0, 1.0)    # normalized mean
    # unclipped fit on [0,1]: g0 = a(4 - 6 etabar), g1 = a(12 etabar - 6);
    # if etabar < 1/3 the support shrinks to [0, 3 etabar], if etabar >
    # 2/3 to [3 etabar - 2, 1]
    low = eta_bar < 1.0 / 3.0
    high = eta_bar > 2.0 / 3.0
    zero = torch.zeros_like(eta_bar)
    one = torch.ones_like(eta_bar)
    lo = torch.where(low, zero, torch.where(high, 3.0 * eta_bar - 2.0,
                                            zero))
    hi = torch.where(low, 3.0 * eta_bar, one)
    span = (hi - lo).clamp(min=puny)
    ebar_loc = (eta_bar - lo) / span             # in [1/3, 2/3]
    g0 = a / span * (4.0 - 6.0 * ebar_loc)
    g1 = a / span ** 2 * (12.0 * ebar_loc - 6.0)
    return g0, g1, lo * w, hi * w, w


def _segment(g0, g1, e0, e1, hl):
    """(area, volume) of the fitted g over eta in [e0, e1]."""
    e0 = e0.clamp(min=0.0)
    e1 = torch.maximum(e1, e0)
    da = g0 * (e1 - e0) + 0.5 * g1 * (e1 ** 2 - e0 ** 2)
    dm1 = 0.5 * g0 * (e1 ** 2 - e0 ** 2) + g1 * (e1 ** 3 - e0 ** 3) / 3.0
    dv = hl * da + dm1                         # h = hl + eta
    return da.clamp(min=0.0), dv.clamp(min=0.0)


def _fraction(moved, donor, puny):
    """The donor's share that moves, capped at 0.9."""
    return torch.where(donor > puny, moved / donor.clamp(min=puny),
                       0.0).clamp(max=0.9)


def _shift(x, f_up, f_dn):
    """Move fraction f_up of each donor category 0..n-2 up a category and
    f_dn of each of 1..n-1 down one."""
    pad = torch.zeros_like(x[:, :1])
    out_up = x * torch.cat([f_up, torch.zeros_like(f_up[:, :1])], 1)
    out_dn = x * torch.cat([torch.zeros_like(f_dn[:, :1]), f_dn], 1)
    gain_up = torch.cat([pad, out_up[:, :-1]], 1)
    gain_dn = torch.cat([out_dn[:, 1:], pad], 1)
    return x - out_up - out_dn + gain_up + gain_dn


def _shift_conserved(t, parent, parent2, fu, fd, puny):
    """A tracer carried as t * parent, back per unit of the new parent."""
    tp = _shift(t * parent, fu, fd)
    return torch.where(parent2 > puny, tp / parent2.clamp(min=puny), t)


def linear_remap(cfg, a, vi, vs, ts, q_ice=None, q_snow=None,
                 area_tracers=(), vol_tracers=()):
    """One linear-remapping sweep of the ITD (ref ice_itd.F90 linear_itd).

    a, vi, vs, ts: (nCells, nCat). h_old assumes the pre-thermodynamics
    ice sat inside its own bin (the column driver calls this right after
    the thermodynamics, so h_new - h_old is the growth/melt).
    Returns the updated (a, vi, vs, ts, q_ice, q_snow, area_tracers,
    vol_tracers)."""
    puny = cfg.puny
    bounds = const_tensor(tuple(cfg.config_itd_bounds), a.device, a.dtype)
    hb = bounds[1:-1]                         # (nB,) interior boundaries

    has = a > puny
    h_new = torch.where(has, vi / a.clamp(min=puny), 0.0)
    # pre-displacement thickness: the current mean clipped into its bin
    h_old = torch.minimum(
        torch.maximum(h_new, bounds[:-1] + puny),
        torch.minimum(bounds[1:], bounds[:-1] + 1.0e4) - puny)
    h_old = torch.where(has, h_old, 0.0)

    hb_new = _displaced_boundaries(hb, h_old, h_new, a, puny)  # (nC, nB)
    # keep displaced boundaries inside the union of the two bins
    hb_new = torch.minimum(torch.maximum(hb_new, bounds[:-2] + puny),
                           bounds[2:].clamp(max=1.0e4) - puny)

    # fit g(h) in each category on its displaced support
    left = torch.cat([torch.zeros_like(hb_new[:, :1]), hb_new], 1)
    right = torch.cat([hb_new, torch.full_like(hb_new[:, :1], 1.0e4)], 1)
    g0, g1, elo, ehi, _w = _fit_line(a, h_new, left, right, puny)

    # transfer UP across boundary n (cat n -> n+1): the part of cat n
    # above H_n; DOWN (cat n+1 -> n): the part of n+1 below H_n
    moved_up = hb_new > hb
    da_up, dv_up = _segment(g0[:, :-1], g1[:, :-1],
                            torch.maximum(hb - left[:, :-1], elo[:, :-1]),
                            ehi[:, :-1], left[:, :-1])
    da_dn, dv_dn = _segment(g0[:, 1:], g1[:, 1:], elo[:, 1:],
                            torch.minimum(hb - left[:, 1:], ehi[:, 1:]),
                            left[:, 1:])
    da_up = torch.where(moved_up, da_up, 0.0)
    dv_up = torch.where(moved_up, dv_up, 0.0)
    da_dn = torch.where(~moved_up, da_dn, 0.0)
    dv_dn = torch.where(~moved_up, dv_dn, 0.0)

    # cap transfers at the donor's content
    f_up = _fraction(da_up, a[:, :-1], puny)
    fv_up = _fraction(dv_up, vi[:, :-1], puny)
    f_dn = _fraction(da_dn, a[:, 1:], puny)
    fv_dn = _fraction(dv_dn, vi[:, 1:], puny)

    a2 = _shift(a, f_up, f_dn)
    vi2 = _shift(vi, fv_up, fv_dn)
    vs2 = _shift(vs, f_up, f_dn)                # snow rides on area fraction

    ts2 = _shift_conserved(ts, a, a2, f_up, f_dn, puny)
    q_ice2 = q_snow2 = None
    if q_ice is not None:
        q_ice2 = _shift_conserved(q_ice, vi[..., None], vi2[..., None],
                                  fv_up[..., None], fv_dn[..., None], puny)
    if q_snow is not None:
        q_snow2 = _shift_conserved(q_snow, vs[..., None], vs2[..., None],
                                   f_up[..., None], f_dn[..., None], puny)
    at2 = tuple(_shift_conserved(t, a, a2, f_up, f_dn, puny)
                for t in area_tracers)
    vt2 = tuple(_shift_conserved(t, vi, vi2, fv_up, fv_dn, puny)
                for t in vol_tracers)
    return a2, vi2, vs2, ts2, q_ice2, q_snow2, at2, vt2
