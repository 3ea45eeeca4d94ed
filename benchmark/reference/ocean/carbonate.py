# Frozen copy of mpas_tpu_torch/cores/ocean/carbonate.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Seawater carbonate system: pH and pCO2 from DIC and alkalinity, and
the air-sea CO2 flux (port of mpas_tpu/cores/ocean/carbonate.py).

ref capability: the carbonate-chemistry block of the reference's ecosys
tracer module (mpas_ocn_tracer_ecosys.F drives the DIC/ALK carbon pools
and the surface CO2 gas exchange). Constants are the published fits:
Lueker et al. (2000) K1/K2 on the total scale, Dickson (1990) K_B,
Weiss (1974) CO2 solubility, Wanninkhof (2014) gas transfer.

Elementwise over (nC,) or (nC, nz) tensors; the [H+] solve is a fixed
20-iteration Newton loop (no data-dependent control flow, no host read).
"""

from __future__ import annotations

import torch


def k_carbonic(t_c, s):
    """(K1, K2, K_B, K_W) in mol/kg: carbonic acid (Lueker et al. 2000,
    total scale), boric acid (Dickson 1990) and water."""
    tk = t_c + 273.15
    lntk = torch.log(tk)
    pk1 = 3633.86 / tk - 61.2172 + 9.6777 * lntk \
        - 0.011555 * s + 0.0001152 * s * s
    pk2 = 471.78 / tk + 25.929 - 3.16967 * lntk \
        - 0.01781 * s + 0.0001122 * s * s
    k1 = 10.0 ** (-pk1)
    k2 = 10.0 ** (-pk2)
    sq = torch.sqrt(s)
    lnkb = (-8966.90 - 2890.53 * sq - 77.942 * s
            + 1.728 * s * sq - 0.0996 * s * s) / tk \
        + 148.0248 + 137.1942 * sq + 1.62142 * s \
        - (24.4344 + 25.085 * sq + 0.2474 * s) * lntk + 0.053105 * sq * tk
    kb = torch.exp(lnkb)
    lnkw = 148.9652 - 13847.26 / tk - 23.6521 * lntk \
        + (118.67 / tk - 5.977 + 1.0495 * lntk) * sq - 0.01615 * s
    kw = torch.exp(lnkw)
    return k1, k2, kb, kw


def co2_solubility(t_c, s):
    """K0 (mol/kg/atm), Weiss (1974)."""
    tk100 = (t_c + 273.15) / 100.0
    lnk0 = -60.2409 + 93.4517 / tk100 + 23.3585 * torch.log(tk100) \
        + s * (0.023517 - 0.023656 * tk100 + 0.0047036 * tk100 * tk100)
    return torch.exp(lnk0)


def carbonate_equilibrium(dic, alk, t_c, s, n_iter: int = 20):
    """[H+] from DIC and total alkalinity (mol/kg) with carbonate, borate
    and water contributions, by Newton iteration from pH 8 with a
    numerical derivative. Returns (ph, pco2_uatm, co3, hco3)."""
    k1, k2, kb, kw = k_carbonic(t_c, s)
    bt = 4.16e-4 * s / 35.0          # total boron (Uppstrom)
    h = torch.full_like(dic, 10.0 ** -8.0)

    def alk_of_h(h):
        d = h * h + k1 * h + k1 * k2
        hco3 = dic * k1 * h / d
        co3 = dic * k1 * k2 / d
        boh4 = bt * kb / (kb + h)
        oh = kw / h
        return hco3 + 2.0 * co3 + boh4 + oh - h, hco3, co3

    for _ in range(n_iter):
        f = alk_of_h(h)[0]
        eps = 1e-3 * h
        dfdh = (alk_of_h(h + eps)[0] - f) / eps
        dfdh = torch.where(dfdh.abs() > 1e-30, dfdh,
                           torch.full_like(dfdh, -1.0))
        h = torch.clamp(h - (f - alk) / dfdh, 1e-12, 1e-4)
    _, hco3, co3 = alk_of_h(h)
    co2aq = dic - hco3 - co3
    pco2 = torch.clamp(co2aq, min=0.0) / co2_solubility(t_c, s) * 1.0e6
    return -torch.log10(h), pco2, co3, hco3


def air_sea_co2_flux(dic, alk, t_c, s, wind10, pco2_atm_uatm=420.0,
                     ice_frac=0.0):
    """Air-to-sea CO2 flux (mol C/m2/s, positive into the ocean) with the
    Wanninkhof (2014) quadratic transfer velocity
    k = 0.251 u10^2 (Sc/660)^-1/2 cm/hr. Returns (flux, pco2, ph)."""
    ph, pco2_oce, _, _ = carbonate_equilibrium(dic, alk, t_c, s)
    sc = 2116.8 - 136.25 * t_c + 4.7353 * t_c ** 2 \
        - 0.092307 * t_c ** 3 + 0.0007555 * t_c ** 4   # CO2 Schmidt
    k_cmhr = 0.251 * wind10 ** 2 * torch.sqrt(660.0 / torch.clamp(sc,
                                                                  min=1.0))
    k_ms = k_cmhr / 100.0 / 3600.0
    k0 = co2_solubility(t_c, s) * 1030.0               # mol/m3/atm
    flux = (1.0 - ice_frac) * k_ms * k0 \
        * (pco2_atm_uatm - pco2_oce) * 1.0e-6
    return flux, pco2_oce, ph
