"""Delta-Eddington multiple-scattering shortwave for snow and sea ice
(port of mpas_tpu/cores/seaice/shortwave_dedd.py).

ref capability: src/core_seaice/column/ice_shortwave.F90
(`config_shortwave_type = 'dEdd'`: compute_dEdd / solution_dEdd):
two-stream delta-Eddington radiative transfer through the snow + ice
column with per-layer inherent optical properties (IOPs), combined by the
adding method, in a visible and a near-IR band.

The adding recursion over layers is a Python loop (nslyr + nilyr + 1
layers); everything is elementwise over (nCells, nCat) columns. Outputs
are the broadband surface albedo, the shortwave absorbed in each ice layer
and the transmission to the ocean, per unit incident flux: what the
vertical thermodynamic solve consumes.

IOPs follow the dEdd table structure (Briegleb & Light 2007): per medium
(snow / sea ice; ponded ice approximated as bare ice) extinction k,
single-scattering albedo w0 and asymmetry g per band, delta-scaled with
f = g^2.
"""

from __future__ import annotations

import torch

# bands: [visible (<700nm), near-IR]; incident split for an overcast sky
BAND_SPLIT = (0.52, 0.48)

# IOPs per medium and band: (k [1/m], w0, g)
IOP_SNOW = ((40.0, 0.9995, 0.89), (30.0, 0.970, 0.89))
IOP_ICE = ((1.4, 0.9993, 0.94), (9.0, 0.975, 0.94))
# thin surface scattering layer of ice ("SSL"), more scattering
IOP_SSL = ((4.0, 0.9997, 0.94), (25.0, 0.990, 0.94))
SSL_THICKNESS = 0.05


def _delta_scale(k, w0, g):
    f = g * g
    k_s = (1.0 - w0 * f) * k
    w_s = (1.0 - f) * w0 / (1.0 - w0 * f)
    g_s = (g - f) / (1.0 - f)
    return k_s, w_s, g_s


def _layer_rt(tau, w0, g, mu0=0.6):
    """Two-stream delta-Eddington reflectance/transmittance of one layer
    for diffuse incidence (hemispheric-mean closure).
    ref: ice_shortwave.F90 solution_dEdd two-stream coefficients."""
    # Eddington closure gamma coefficients
    g1 = 0.25 * (7.0 - w0 * (4.0 + 3.0 * g))
    g2 = (-0.25 * (1.0 - w0 * (4.0 - 3.0 * g))).clamp(min=1e-6)
    lam = torch.sqrt((g1 * g1 - g2 * g2).clamp(min=1e-12))
    expp = torch.exp((lam * tau).clamp(max=40.0))
    expm = 1.0 / expp
    denom = (lam + g1 + (lam - g1) * expm * expm).clamp(min=1e-12)
    R = g2 * (1.0 - expm * expm) / denom
    T = 2.0 * lam * expm / denom
    return R, T


def _add_layers(R1, T1, R2, T2):
    """Adding method: combine layer 1 (top) with layer/stack 2 (below).
    Returns the stack's (R, T) for diffuse flux (overcast approximation)."""
    inv = 1.0 / (1.0 - R1 * R2).clamp(min=1e-12)
    R = R1 + T1 * R2 * T1 * inv
    T = T1 * T2 * inv
    return R, T


def dedd_shortwave(cfg, h_i, h_s, nilyr: int, ocean_albedo: float = 0.06):
    """Delta-Eddington shortwave through snow + SSL + nilyr ice layers.

    h_i, h_s: per-column total ice/snow thickness. Returns
    (albedo_broadband, frac_abs_ice_layers (.., nilyr),
    frac_through_ocean), all per unit incident shortwave."""
    h_i_ = h_i.clamp(min=1e-4)
    zeros = torch.zeros_like(h_i)

    alb_b, thru_b, abs_lyr_b = [], [], []
    for band in range(2):
        ks, ws, gs = _delta_scale(*IOP_SNOW[band])
        kssl, wssl, gssl = _delta_scale(*IOP_SSL[band])
        ki, wi, gi = _delta_scale(*IOP_ICE[band])

        # layers top -> bottom: snow, SSL, ice layers
        h_ssl = (0.5 * h_i_).clamp(max=SSL_THICKNESS)
        h_int = (h_i_ - h_ssl).clamp(min=1e-6) / nilyr

        taus = [ks * h_s.clamp(min=0.0), kssl * h_ssl] \
            + [ki * h_int] * nilyr
        iops = [(ws, gs), (wssl, gssl)] + [(wi, gi)] * nilyr
        n_lay = len(taus)
        Rl, Tl = [], []
        for tau, (w0, g0) in zip(taus, iops):
            R, T = _layer_rt(tau, torch.full_like(h_i, w0),
                             torch.full_like(h_i, g0))
            Rl.append(R)
            Tl.append(T)

        # downward adding: Rdn[j], Tdn[j] of layers 0..j-1 combined
        Rdn = [zeros]
        Tdn = [torch.ones_like(h_i)]
        for j in range(n_lay):
            R, T = _add_layers(Rdn[-1], Tdn[-1], Rl[j], Tl[j])
            Rdn.append(R)
            Tdn.append(T)
        # upward adding from the ocean: Rup[j], the reflectance of
        # everything below interface j
        Rup = [torch.full_like(h_i, ocean_albedo)]
        for j in range(n_lay - 1, -1, -1):
            R, _ = _add_layers(Rl[j], Tl[j], Rup[0], zeros)
            Rup.insert(0, R)

        # net downward flux at interface j, with the multiple reflections
        # between the stacks above and below it
        Fnet = []
        for j in range(n_lay + 1):
            inv = 1.0 / (1.0 - Rdn[j] * Rup[j]).clamp(min=1e-12)
            Fdn = Tdn[j] * inv
            Fup = Tdn[j] * Rup[j] * inv
            Fnet.append(Fdn - Fup)

        # absorption per layer = flux divergence across it; the SSL's is
        # folded into the first ice layer
        abs_layers = [Fnet[j] - Fnet[j + 1] for j in range(n_lay)]
        abs_ice = [abs_layers[1] + abs_layers[2]] + abs_layers[3:]
        alb_b.append(1.0 - Fnet[0])
        thru_b.append(Fnet[n_lay])
        abs_lyr_b.append(torch.stack(abs_ice, -1))

    w0, w1 = BAND_SPLIT
    return (w0 * alb_b[0] + w1 * alb_b[1],
            w0 * abs_lyr_b[0] + w1 * abs_lyr_b[1],
            w0 * thru_b[0] + w1 * thru_b[1])
