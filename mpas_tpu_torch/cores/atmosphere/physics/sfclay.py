"""Monin-Obukhov surface layer (port of
mpas_tpu/cores/atmosphere/physics/sfclay.py).

ref: src/core_atmosphere/physics/mpas_atmphys_driver_sfclayer.F +
physics_wrf/module_sf_sfclay.F (revised MM5 scheme): bulk Richardson
number -> stability regime -> similarity functions -> u*, t*, q* and the
surface exchange coefficients and fluxes. A fixed number of fixed-point
iterations, Dyer-Businger psi functions with the Paulson unstable and Webb
stable branches.
"""

from __future__ import annotations

import math

import torch

from mpas_tpu_torch.constants import cp, gravity

_KARMAN = 0.4
_LV = 2.5e6


def _psi_m(zeta):
    """Momentum stability function (Paulson unstable / Webb stable)."""
    x = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** 0.25
    psi_u = (2.0 * torch.log(0.5 * (1.0 + x))
             + torch.log(0.5 * (1.0 + x * x))
             - 2.0 * torch.atan(x) + 0.5 * math.pi)
    psi_s = -5.0 * torch.clamp(zeta, min=0.0)
    return torch.where(zeta < 0.0, psi_u, psi_s)


def _psi_h(zeta):
    x = (1.0 - 16.0 * torch.clamp(zeta, max=0.0)) ** 0.25
    psi_u = 2.0 * torch.log(0.5 * (1.0 + x * x))
    psi_s = -5.0 * torch.clamp(zeta, min=0.0)
    return torch.where(zeta < 0.0, psi_u, psi_s)


def sfclay(u1, v1, th1, qv1, p1, rho1, z1, tsk, qsfc, z0, n_iter: int = 3):
    """Surface-layer similarity solve.

    Inputs at the lowest model level (suffix 1), the skin temperature tsk,
    the surface saturation mixing ratio qsfc (all (nCells,)) and the
    roughness z0. Returns a dict with ust, hfx (W/m2), qfx (kg/m2/s), lh,
    cd, zeta, tst, qst, the fluxes the PBL scheme applies (ref: sfclay
    outputs consumed by YSU, module_bl_ysu.F)."""
    spd = torch.clamp(torch.sqrt(u1 * u1 + v1 * v1), min=0.1)
    thg = tsk * (1.0e5 / torch.clamp(p1, min=1.0)) ** (287.0 / cp)
    dth = th1 - thg
    thv1 = th1 * (1.0 + 0.61 * qv1)

    lnz = torch.log(z1 / z0)
    zeta = torch.zeros_like(spd)                 # neutral start
    for _ in range(n_iter):
        psim = _psi_m(zeta)
        psih = _psi_h(zeta)
        ust = _KARMAN * spd / torch.clamp(lnz - psim, min=1.0)
        tst = _KARMAN * dth / torch.clamp(lnz - psih, min=1.0)
        qst = _KARMAN * (qv1 - qsfc) / torch.clamp(lnz - psih, min=1.0)
        # Obukhov length: L = ust^2 thv / (k g tst_v)
        tstv = tst * (1.0 + 0.61 * qv1) + 0.61 * th1 * qst
        l_inv = _KARMAN * gravity * tstv \
            / torch.clamp(ust * ust, min=1e-6) / thv1
        zeta = torch.clamp(z1 * l_inv, -10.0, 2.0)

    ust = torch.clamp(ust, min=0.01)
    hfx = -rho1 * cp * ust * tst         # positive upward when surface warm
    qfx = -rho1 * ust * qst
    cd = (ust / spd) ** 2
    return {"ust": ust, "hfx": hfx, "qfx": qfx, "lh": _LV * qfx,
            "cd": cd, "zeta": zeta, "tst": tst, "qst": qst}
