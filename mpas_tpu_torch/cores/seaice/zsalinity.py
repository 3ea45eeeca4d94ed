"""Vertical (z-level) prognostic ice salinity: gravity drainage, growth
entrapment and surface flushing (port of
mpas_tpu/cores/seaice/zsalinity.py).

ref capability: src/core_seaice/column/ice_zsalinity.F90 (zsalinity /
solve_zsalinity / solve_S_dt) and the mushy-layer gravity drainage of
ice_therm_mushy.F90 (Turner, Hunke & Jeffery 2013), in compressed form:

  - growth entrapment: new bottom ice traps a keff fraction of seawater
    salinity;
  - gravity drainage, fast mode: layers whose local Rayleigh number
    Ra(k) = g beta (S(k) - S_bot_ref) (h - z_k) Pi / (kappa nu) exceeds
    Ra_c drain toward the stable profile at rate_fast;
  - slow mode: relaxation toward the BL99 stable shape everywhere;
  - flushing: surface meltwater percolates through permeable ice
    (phi^3 permeability), desalinating the column top-down;
  - the min_salin floor, and the salt flux to the ocean from every
    removal (ref: fzsal/fzsal_g).

Arrays are (nCells, nCat, nIceLayers) with layers last.
"""

from __future__ import annotations

import numpy as np
import torch

from mpas_tpu_torch.cores.seaice.config import SeaiceConfig
from mpas_tpu_torch.cores.seaice.state import const_tensor

MIN_SALIN = 0.1          # ref: min_salin, ice_colpkg_shared.F90
KEFF_GROWTH = 0.26       # effective segregation coefficient (Cox & Weeks)
RA_C = 10.0              # critical mush Rayleigh number (Turner 2013)
RATE_FAST = 1.0e-3       # 1/s fast-drainage relaxation when Ra > Ra_c
RATE_SLOW = 1.0e-7       # 1/s slow mode
KAPPA_NU = 6.8e-3        # thermal diffusivity x kinematic viscosity scale
BETA_S = 0.8             # kg/m3 per psu haline density coefficient
PERM0 = 3.0e-8           # m2 permeability scale (phi^3 law)


def stable_profile(nilyr: int) -> np.ndarray:
    """BL99/CICE stable bulk-salinity shape (psu) at layer midpoints."""
    z = (np.arange(nilyr) + 0.5) / nilyr
    return 1.6 * (1.0 - np.cos(np.pi * z ** (0.407 / (z + 0.573))))


def local_rayleigh(S, h_ice, sss):
    """Mush Rayleigh number per layer (compressed Turner 2013 form): the
    density contrast of the layer's brine against the basal brine times
    the distance to the bottom, over the dissipative scale."""
    nilyr = S.shape[-1]
    z_above = const_tensor(tuple((np.arange(nilyr) + 0.5) / nilyr),
                           S.device, S.dtype)        # 0 top -> 1 bottom
    dist_bot = h_ice[..., None] * (1.0 - z_above)
    drho = BETA_S * (S - MIN_SALIN).clamp(min=0.0)
    perm = PERM0 * (S / sss[..., None, None].clamp(min=1.0)).clamp(
        0.0, 1.0) ** 3
    return 9.81 * drho * dist_bot * perm / KAPPA_NU


def zsalinity_step(cfg: SeaiceConfig, S, h_ice, growth_b, melt_s,
                   sss, dt):
    """One salinity step. S: (nC, nCat, nilyr) psu; h_ice (nC, nCat) m;
    growth_b (nC, nCat) basal growth rate m/s; melt_s (nC, nCat) m of
    surface (snow+ice) melt this step; sss (nC,) ocean salinity.

    Returns (S_new, fzsal), fzsal (nC,) the salt flux to the ocean in
    kg/m2 of salt over the step (positive into the ocean): drainage,
    flushing and growth-entrapment rejection (the reference's fzsal +
    fzsal_g pair)."""
    nilyr = S.shape[-1]
    has = (h_ice > 1.0e-3)[..., None]

    # --- growth entrapment at the bottom layer --------------------------
    dh_new = growth_b * dt                               # (nC, nCat)
    layer_h = h_ice.clamp(min=1e-6) / nilyr
    f_new = (dh_new / layer_h.clamp(min=1e-9)).clamp(0.0, 1.0)
    S_entrap = KEFF_GROWTH * sss[:, None]
    S_bot = S[..., -1] * (1.0 - f_new) + S_entrap * f_new
    S1 = torch.cat([S[..., :-1], torch.where(has[..., 0], S_bot,
                                             S[..., -1])[..., None]], -1)
    # salt rejected by the growth (the (1-keff) fraction of seawater salt)
    rej = (1.0 - KEFF_GROWTH) * sss[:, None] * dh_new * 0.917  # kg-scaled

    # --- gravity drainage: fast mode where Ra > Ra_c --------------------
    ra = local_rayleigh(S1, h_ice, sss)
    stable = const_tensor(tuple(stable_profile(nilyr)), S.device, S.dtype)
    excess = (S1 - stable).clamp(min=0.0)
    fast = torch.where(ra > RA_C, torch.full_like(ra, RATE_FAST), 0.0)
    dS_drain = torch.minimum((fast + RATE_SLOW) * dt * excess,
                             (S1 - MIN_SALIN).clamp(min=0.0))
    S2 = S1 - torch.where(has, dS_drain, 0.0)

    # --- flushing: surface melt through permeable ice -------------------
    perm = (S2.mean(-1) / sss[:, None].clamp(min=1.0)).clamp(0.0, 1.0) ** 3
    flush = (melt_s * perm * 5.0).clamp(0.0, 0.5)        # fraction
    dS_flush = flush[..., None] * (S2 - MIN_SALIN).clamp(min=0.0)
    S3 = (S2 - torch.where(has, dS_flush, 0.0)).clamp(MIN_SALIN, 35.0)

    # --- salt flux to the ocean (kg salt / m2): rho_i h_layer dS / 1000 --
    dS_tot = torch.where(has, dS_drain + dS_flush, 0.0)
    fz_cat = cfg.rho_ice * layer_h[..., None] * dS_tot / 1000.0
    fzsal = fz_cat.sum((-1, -2)) + (rej / 1000.0).sum(-1)
    return S3, fzsal


def mushy_liquid_fraction(S, T):
    """Mush liquid fraction phi = S / S_br(T) with the liquidus
    S_br = -T/mu (ref: ice_mushy_physics.F90 liquid_fraction)."""
    s_br = (-T / 0.054).clamp(min=MIN_SALIN)
    return (S / s_br).clamp(0.0, 1.0)
