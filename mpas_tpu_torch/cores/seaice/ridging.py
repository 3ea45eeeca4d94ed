"""Mechanical redistribution (ridging) of the ice thickness distribution
(port of mpas_tpu/cores/seaice/ridging.py).

ref: src/core_seaice/column/ice_mechred.F90:
  ridge_ice  (:80)   iteration until the total area constraint is met
  ridge_prep (:637)  closing/opening rates
  ridge_itd  (:738)  participation function + ridge-thickness distribution
  ridge_shift(:1027) conservative transfer between categories

The exponential participation function (krdg_partic=1,
apartic_n = [exp(-G_{n-1}/a*) - exp(-G_n/a*)] / [1 - exp(-1/a*)], ref
:851-870) and the exponential redistribution (krdg_redist=1: ridged ice
from thickness hi spreads as g(h) ~ exp(-(h-hrmin)/hrexp) with
hrmin = min(2 hi, hi + maxraft), hrexp = mu_rdg sqrt(hi), so the mean
ridge thickness multiplier is krdg = (hrmin + hrexp)/hi, ref :900-930).
ridge_shift's category placement integrals are closed-form exponential
bin integrals, batched over cells with categories last.

Ice volume and ice enthalpy are conserved exactly; area shrinks by
closing; a fraction (1 - fsnowrdg) of the ridged snow volume is lost to
the ocean (ref: fsnowrdg in ridge_shift).
"""

from __future__ import annotations

import math

import torch

from mpas_tpu_torch.cores.seaice.state import const_tensor

ASTAR = 0.05        # e-folding of the participation function (ref astari)
MU_RDG = 3.0        # sqrt(m) e-folding scale of ridged ice (ref mu_rdg)
MAXRAFT = 1.0       # m, maximum thickness of rafted ice
FSNOWRDG = 0.5      # snow fraction that survives ridging
N_ITER = 3          # ridge_ice convergence iterations (ref niterate)


def _participation(a_cat, a_open, puny):
    """Exponential participation function (ref ridge_itd :851-870).
    Returns (apartic0, apartic (nC, ncat))."""
    asum = a_open[:, None] + torch.cumsum(a_cat, -1)   # G at category tops
    total = asum[:, -1:].clamp(min=puny)
    g0 = a_open[:, None] / total
    g = asum / total
    norm = 1.0 / (1.0 - math.exp(-1.0 / ASTAR))

    def e(x):
        return torch.exp(-x / ASTAR) * norm
    apartic0 = (e(torch.zeros_like(g0)) - e(g0))[:, 0]
    gprev = torch.cat([g0, g[:, :-1]], -1)
    return apartic0, e(gprev) - e(g)


def _ridge_thickness_params(a_cat, v_cat, puny):
    """(hrmin, hrexp, krdg) per category (ref ridge_itd :900-930)."""
    hi = torch.where(a_cat > puny, v_cat / a_cat.clamp(min=puny),
                     torch.full_like(a_cat, puny)).clamp(min=puny)
    hrmin = torch.minimum(2.0 * hi, hi + MAXRAFT)
    hrexp = MU_RDG * torch.sqrt(hi)
    krdg = (hrmin + hrexp) / hi
    return hrmin, hrexp, krdg.clamp(min=1.0 + puny)


def _placement_fractions(hrmin, hrexp, bounds):
    """Exponential-bin integrals of ridge_shift: the fraction of ridged
    AREA and VOLUME from each source category landing in each destination
    category. bounds: (ncat+1,) category edges, the last = +inf.

    g(h) = exp(-(h - hrmin)/hrexp)/hrexp on [hrmin, inf):
      area cdf tail  E(x) = exp(-(max(x,hrmin)-hrmin)/hrexp)
      volume tail    V(x) = (max(x,hrmin)+hrexp) E(x) / (hrmin+hrexp)
    """
    x_lo = torch.maximum(bounds[:-1], hrmin[..., None])   # (nC,ncat,ncat)
    x_hi = torch.maximum(bounds[1:], hrmin[..., None])
    lam = hrexp[..., None]
    hm = hrmin[..., None]

    def E(x):
        return torch.exp(-(x - hm) / lam)

    def V(x):
        return (x + lam) * E(x) / (hm + lam)
    top = torch.isinf(bounds[1:])
    f_area = E(x_lo) - torch.where(top, 0.0, E(x_hi))
    f_vol = V(x_lo) - torch.where(top, 0.0, V(x_hi))
    # numerical safety: renormalize to exactly 1 over destinations
    f_area = f_area / f_area.sum(-1, keepdim=True).clamp(min=1e-12)
    f_vol = f_vol / f_vol.sum(-1, keepdim=True).clamp(min=1e-12)
    return f_area, f_vol


def ridge_step(cfg, a_cat, v_cat, vs_cat, ts_cat, dt,
               q_ice=None, q_snow=None, closing_rate=None):
    """One ridging adjustment (ref ridge_ice :80-594), N_ITER passes.

    closing_rate: optional dynamics-supplied net closing (1/s, >= 0,
    ref ridge_prep from divergence/shear). Independently, any total-area
    excess over 1 is closed within the call. Returns the updated
    (a_cat, v_cat, vs_cat, ts_cat, q_ice, q_snow, a_open).
    """
    puny = cfg.puny
    ncat = a_cat.shape[-1]
    bounds = const_tensor(tuple(cfg.config_itd_bounds[:ncat])
                          + (math.inf,), a_cat.device, a_cat.dtype)

    ex = torch.zeros_like(a_cat[:, 0]) if closing_rate is None \
        else closing_rate.clamp(min=0.0)
    a, v, vs, ts, qi, qs = a_cat, v_cat, vs_cat, ts_cat, q_ice, q_snow
    for it in range(N_ITER):           # ref niterate loop
        asum = a.sum(-1)
        a_open = (1.0 - asum).clamp(0.0, 1.0)
        # net closing needed: area excess + dynamics closing (ref
        # ridge_prep :690-710 asum correction); the dynamics closing acts
        # on the first pass only
        closing_net = (asum - 1.0).clamp(min=0.0) / dt
        if it == 0:
            closing_net = closing_net + ex
        apartic0, apartic = _participation(a, a_open, puny)
        hrmin, hrexp, krdg = _ridge_thickness_params(a, v, puny)
        aksum = apartic0 + (apartic * (1.0 - 1.0 / krdg)).sum(-1)
        closing_gross = closing_net / aksum.clamp(min=puny)
        # cap so that no category loses more than 90% of its area a pass
        # (ref ridge_ice reduces closing_gross on overshoot)
        ara_want = apartic * (closing_gross * dt)[:, None]
        cap = torch.where(apartic > puny,
                          0.9 * a / ara_want.clamp(min=puny),
                          math.inf).amin(-1)
        ara = ara_want * cap.clamp(max=1.0)[:, None]
        ara = torch.where(a > puny, torch.minimum(ara, a), 0.0)

        frac = torch.where(a > puny, ara / a.clamp(min=puny), 0.0)
        vrdg = v * frac                    # ice volume ridged (conserved)
        vsr = vs * frac                    # snow volume ridged
        ard = ara / krdg                   # post-ridging area

        f_area, f_vol = _placement_fractions(hrmin, hrexp, bounds)
        add_a = torch.einsum("cn,cnm->cm", ard, f_area)
        add_v = torch.einsum("cn,cnm->cm", vrdg, f_vol)
        add_vs = torch.einsum("cn,cnm->cm", vsr * FSNOWRDG, f_area)

        a2 = a - ara + add_a
        v2 = v - vrdg + add_v
        vs2 = vs - vsr + add_vs
        # surface temperature rides on area
        aT = a * ts - ara * ts + torch.einsum("cn,cnm->cm", ard * ts, f_area)
        ts2 = torch.where(a2 > puny, aT / a2.clamp(min=puny), ts)
        # layer enthalpies ride on their carrier volume's placement: ice
        # enthalpy with the ridged-ice volume fractions, snow enthalpy with
        # the (area-placed) surviving snow volume; `kept` of the moved
        # enthalpy arrives, the rest leaves with the snow lost to the ocean
        qs_out = []
        for q, vol, vol2, moved_out, kept, f_place in (
                (qi, v, v2, vrdg, 1.0, f_vol),
                (qs, vs, vs2, vsr, FSNOWRDG, f_area)):
            if q is None:
                qs_out.append(None)
                continue
            qv = q * vol[..., None]
            qmoved = torch.where(vol[..., None] > puny,
                                 q * moved_out[..., None], 0.0)
            qadd = torch.einsum("cnl,cnm->cml", qmoved * kept, f_place)
            qv2 = qv - qmoved + qadd
            qs_out.append(torch.where(vol2[..., None] > puny,
                                      qv2 / vol2[..., None].clamp(min=puny),
                                      q))
        a, v, vs, ts = a2, v2, vs2, ts2
        qi, qs = qs_out
    a_open = (1.0 - a.sum(-1)).clamp(0.0, 1.0)
    return a, v, vs, ts, qi, qs, a_open
