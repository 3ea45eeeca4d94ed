"""Thompson-companion cloud fraction (cal_cldfra3) for the radiation path
(port of mpas_tpu/cores/atmosphere/physics/cldfra3.py).

ref: src/core_atmosphere/physics/physics_wrf/module_mp_thompson_cldfra3.F
  cal_cldfra3      (:44)  RH-based fraction with mixed-phase blending and
                          grid-size-dependent RH_00 thresholds
  find_cloudLayers (:191) tropopause / stable-surface-layer trimming and
                          per-cloud-deck hydrometeor seeding
  adjust_cloudIce  (:384) / adjust_cloudH2O (:429) deck seeding
  adjust_cloudFinal(:476) column LWP/IWP cap at 1 kg m^-2

The reference's per-column loops over cloud decks are run detection: a
deck is a contiguous run of cfr >= 0.01, labelled by a cumulative sum of
run starts, and its totals (thickness, water path, base and top levels)
are segment reductions over (column, run) ids with scatter_reduce. An empty
segment holds the reduction's identity; the non-cloudy levels share one
overflow segment, nc*nz.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.cores.atmosphere.physics.wsm6 import _qsat_ice, _qsat_liq

_ENTR = 0.5           # entrainment fraction (ref :147 entrmnt)
_CF_MIN = 0.01        # deck membership threshold (ref :283)


def _std_height(p):
    """Standard-atmosphere height used for deck geometry (ref :225)."""
    return 44307.692 * (1.0 - (p / 101325.0) ** 0.190)


def _deck_ids(cloudy):
    """Label contiguous cloudy runs per column: returns (seg_id, valid)
    where seg_id is a global segment index (col * nz + run_index) and the
    non-cloudy levels go to the overflow segment nc * nz."""
    nc, nz = cloudy.shape
    prev = torch.cat([torch.zeros_like(cloudy[:, :1]), cloudy[:, :-1]], 1)
    start = cloudy & ~prev
    run_idx = torch.cumsum(start.long(), dim=1) - 1
    run_idx = torch.clamp(run_idx, 0, nz - 1)
    col = torch.arange(nc, device=cloudy.device)[:, None]
    seg = col * nz + run_idx
    return torch.where(cloudy, seg, nc * nz), cloudy


_IDENTITY = {"sum": 0, "amin": float("inf"), "amax": float("-inf")}


def _seg(vals, seg, nseg, op="sum"):
    """Segment reduction of vals over ids seg into nseg + 1 segments; an
    empty segment holds the identity (0, +inf, -inf; the integer type's
    extremes for integer vals), as jax.ops.segment_* give."""
    init = _IDENTITY[op]
    if not vals.is_floating_point() and op != "sum":
        info = torch.iinfo(vals.dtype)
        init = info.max if op == "amin" else info.min
    out = torch.full((nseg + 1,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce(0, seg.reshape(-1), vals.reshape(-1), op,
                              include_self=False)


def _seed_decks(cfr, q_main, q_extra, qvs, t, rho, dz, region,
                t_floor, t_ceil, ice: bool):
    """Per-deck hydrometeor seeding (ref adjust_cloudIce/adjust_cloudH2O).
    region: (nC, nz) bool mask of the levels eligible for this pass.
    Returns the updated q_main."""
    nc, nz = cfr.shape
    nseg = nc * nz
    cloudy = region & (cfr >= _CF_MIN)
    seg, valid = _deck_ids(cloudy)
    karr = torch.arange(nz, device=cfr.device).expand(nc, nz)

    tdz = _seg(torch.where(valid, dz, 0.0), seg, nseg)[seg]
    k1 = _seg(torch.where(valid, karr, nz), seg, nseg, "amin")[seg]
    k2 = _seg(torch.where(valid, karr, -1), seg, nseg, "amax")[seg]
    wpath = q_main + q_extra
    wp_exists = _seg(torch.where(valid, wpath * rho * dz, 0.0), seg,
                     nseg)[seg]

    k1c = torch.clamp(k1, 0, nz - 1)
    k2c = torch.clamp(k2, 0, nz - 1)
    # max water content from the qvs drop across the deck (ref :399)
    qvs_k1 = torch.gather(qvs, 1, k1c)
    qvs_k2m = torch.gather(qvs, 1, torch.clamp(k2c - 1, min=0))
    max_wc = torch.abs(qvs_k2m - qvs_k1)

    # cumulative deck thickness to level k with the half-bottom-layer
    # rule (ref :404-410): 0.5 dz(k1) + sum_{k1<j<=k} dz(j)
    cum = torch.cumsum(torch.where(valid, dz, 0.0), dim=1)
    cum_k1 = torch.gather(cum, 1, k1c)
    this_dz = cum - cum_k1 + 0.5 * torch.gather(dz, 1, k1c)
    wc = torch.clamp(max_wc * this_dz / torch.clamp(tdz, min=1e-3)
                     * (1.0 - _ENTR), min=1e-6)

    multi = (k2 - k1 + 1) >= 2
    ok_t = (t >= t_floor) & (t < t_ceil)
    partly = valid & multi & (cfr > _CF_MIN) & (cfr < 0.99) & ok_t \
        & (wp_exists <= 1.0)
    full = valid & multi & (cfr >= 0.99) & (q_main < 1e-5) & ok_t \
        & (wp_exists <= 1.0)
    if ice:
        add = torch.where(partly, 0.1 * cfr * wc,
                          torch.where(full, 0.01 * wc, 0.0))
    else:
        add = torch.where(partly, cfr * cfr * wc,
                          torch.where(full, 0.1 * wc, 0.0))
    # single-level decks get the minimal seeding (ref :300-302, :333-335)
    single = valid & ~multi & (cfr > 0.0) & (q_main < 1e-6)
    add = add + torch.where(single, 1e-5 * cfr, 0.0)
    return q_main + add


def cal_cldfra3(qv, qc, qi, qs, p, t, rho, dz, xland, gridkm):
    """Cloud fraction + radiation-visible hydrometeor seeding.

    3-D fields (nC, nz), level 0 lowest; xland (nC,) 1 = land, 2 = water;
    gridkm (nC,) grid length in km. Returns (cldfra, qc_out, qi_out) (ref
    cal_cldfra3 in/out contract; qs is read only)."""
    # --- RH-based fraction (ref :151-186) --------------------------------
    rh_00l = 0.781 + torch.sqrt(1.0 / (35.0 + gridkm ** 3 * 0.5))
    rh_00o = 0.831 + torch.sqrt(1.0 / (70.0 + gridkm ** 3 * 0.5))
    tc = t - 273.16
    qvsw = _qsat_liq(t, p)
    qvsi = _qsat_ice(t, p)
    blend = torch.clamp((-12.0 - tc) / 8.0, 0.0, 1.0)
    qvsat = torch.where(tc >= -12.0, qvsw,
                        torch.where(tc < -20.0, qvsi,
                                    qvsw - (qvsw - qvsi) * blend))
    rhum = torch.clamp(qv / torch.clamp(qvsat, min=1e-12), 0.01, 0.9999)
    rh_00 = torch.where(xland > 1.5, rh_00o, rh_00l)[:, None]

    warm = torch.clamp(
        1.0 - torch.sqrt(torch.clamp(
            (1.0 - torch.clamp(rhum, max=0.999)) / (1.0 - rh_00), min=0.0)),
        min=0.0)
    ratio_ws = qvsw / torch.clamp(qvsi, min=1e-12)
    rhum_i = torch.minimum(
        torch.clamp(qv / torch.clamp(qvsat, min=1e-12), min=0.01),
        ratio_ws - 1e-6)
    rhi_max = torch.maximum(rhum_i + 1e-6, ratio_ws)
    cold = torch.clamp(
        1.0 - torch.sqrt(torch.clamp(
            (rhi_max - rhum_i) / (rhi_max - rh_00o[:, None]), min=0.0)),
        min=0.0)
    cold = torch.where((tc < -12.0) & (tc > -70.0)
                       & (rhum_i > rh_00o[:, None]), cold, 0.0)
    cfr = torch.clamp(torch.where(tc >= -12.0, warm, cold), max=0.90)
    already = (qc > 1e-6) | (qi >= 1e-7) | (qs > 1e-5)
    cfr = torch.where(already, 1.0, cfr)
    qvsat = torch.where(already, qv, qvsat)

    # --- tropopause via weak theta lapse (ref :232-245) ------------------
    nc, nz = t.shape
    theta = t * (1.0e5 / p) ** (287.05 / 1004.0)
    ht = _std_height(p)
    lapse = torch.cat([(theta[:, 2:] - theta[:, :-2])
                       / torch.clamp(ht[:, 2:] - ht[:, :-2], min=1.0),
                       torch.zeros_like(t[:, :2])], dim=1)
    karr = torch.arange(nz, device=t.device)[None, :]
    weak = (lapse < 10.0 / 1500.0) & (ht < 19000.0) & (ht > 4000.0) \
        & (karr < nz - 2)
    kfound = torch.amax(torch.where(weak, karr, 0), dim=1)  # highest weak k
    k_tropo = torch.clamp(kfound + 2, min=2)

    # freezing-region indices (ref :219-222): highest k with T > -40/-12 C
    k_m12 = torch.clamp(torch.amax(torch.where(tc > -12.0, karr, 0), 1),
                        min=0)

    # clear partly-cloudy fractions above the tropopause (ref :249-253)
    partly = (cfr > 0.0) & (cfr < 0.999)
    cfr = torch.where((karr > k_tropo[:, None]) & partly, 0.0, cfr)

    # stable surface layer kbot (ref :257-264): first k (from 2) where the
    # theta jump exceeds 0.05e-3 * dz
    dtheta = torch.cat([torch.zeros_like(t[:, :1]),
                        theta[:, 1:] - theta[:, :-1]], dim=1)
    stable = (dtheta > 0.05e-3 * dz) & (karr >= 2) \
        & (karr <= k_m12[:, None])
    # CUDA's argmax takes no bool; both libraries give the first maximum
    ks = torch.where(torch.any(stable, 1), torch.argmax(stable.long(), 1),
                     k_m12 + 1)
    kbot = torch.clamp(ks - 2, min=1)
    cfr = torch.where((karr <= kbot[:, None]) & partly, 0.0, cfr)

    # --- deck seeding (ref :268-341) --------------------------------------
    ice_region = (karr > k_m12[:, None]) & (karr <= k_tropo[:, None])
    wat_region = (karr > kbot[:, None]) & (karr <= k_m12[:, None])
    qi_out = _seed_decks(cfr, qi, qs, qvsat, t, rho, dz, ice_region,
                         203.16, float("inf"), ice=True)
    qc_out = _seed_decks(cfr, qc, torch.zeros_like(qc), qvsat, t, rho, dz,
                         wat_region, 253.16, 298.16, ice=False)

    # --- final column LWP/IWP cap (ref adjust_cloudFinal :476) -----------
    incl = (cfr > 0.01) & (cfr < 0.99) & (karr <= k_tropo[:, None])
    lwp = torch.sum(torch.where(incl, qc_out * rho * dz, 0.0), 1)
    iwp = torch.sum(torch.where(incl, qi_out * rho * dz, 0.0), 1)
    xfac_l = torch.where(lwp > 1.0, 1.0 / torch.clamp(lwp, min=1e-12), 1.0)
    xfac_i = torch.where(iwp > 1.0, 1.0 / torch.clamp(iwp, min=1e-12), 1.0)
    qc_out = torch.where(incl, qc_out * xfac_l[:, None], qc_out)
    qi_out = torch.where(incl, qi_out * xfac_i[:, None], qi_out)
    return cfr, qc_out, qi_out
