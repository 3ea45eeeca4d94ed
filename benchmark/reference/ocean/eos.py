# Frozen copy of mpas_tpu_torch/cores/ocean/eos.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Ocean equations of state: linear and Jackett-McDougall (1995) (port of
mpas_tpu/cores/ocean/eos.py).

ref: src/core_ocean/shared/mpas_ocn_equation_of_state.F (dispatcher),
mpas_ocn_equation_of_state_linear.F, mpas_ocn_equation_of_state_jm.F
(UNESCO surface density + JMcD bulk modulus, :140-380).
"""

from __future__ import annotations

import torch

# valid ranges (ref: mpas_ocn_equation_of_state_jm.F:232-235)
_TMIN, _TMAX = -2.0, 40.0
_SMIN, _SMAX = 0.0, 42.0

# fresh-water density, UNESCO (ref :158-165)
_UNT = (999.842594, 6.793952e-2, -9.095290e-3, 1.001685e-4,
        -1.120083e-6, 6.536332e-9)
# salinity dependence of surface density (ref :169-177)
_UNS1 = (0.824493, -4.0899e-3, 7.6438e-5, -8.2467e-7, 5.3875e-9)
_UNSQ = (-5.72466e-3, 1.0227e-4, -1.6546e-6)
_UNS2T0 = 4.8314e-4
# JMcD bulk modulus (ref :181-217)
_BUP0S0 = (1.965933e4, 1.444304e2, -1.706103, 9.648704e-3, -4.190253e-5)
_BUP0S1 = (5.284855e1, -3.101089e-1, 6.283263e-3, -5.084188e-5)
_BUP0SQ = (3.886640e-1, 9.085835e-3, -4.619924e-4)
_BUP1S0 = (3.186519, 2.212276e-2, -2.984642e-4, 1.956415e-6)
_BUP1S1 = (6.704388e-3, -1.847318e-4, 2.059331e-7)
_BUP1SQT0 = 1.480266e-4
_BUP2S0 = (2.102898e-4, -1.202016e-5, 1.394680e-7)
_BUP2S1 = (-2.040237e-6, 6.128773e-8, 6.207323e-10)


def pressure_from_depth(depth_m):
    """Reference pressure (bars) at depth (m).
    ref: pRefEOS fit, mpas_ocn_equation_of_state_jm.F:252-258."""
    d = depth_m
    return 0.059808 * (torch.exp(-0.025 * d) - 1.0) \
        + 0.100766 * d + 2.28405e-7 * d * d


def density_jm(T, S, p_bars):
    """JM95 in-situ density (kg/m3) at pressure p (bars); p_bars = 0 gives
    the surface-referenced potential density.
    ref: mpas_ocn_equation_of_state_jm.F:326-372."""
    TQ = torch.clamp(T, _TMIN, _TMAX)
    SQ = torch.clamp(S, _SMIN, _SMAX)
    SQR = torch.sqrt(SQ)
    T2 = TQ * TQ
    p = p_bars
    p2 = p * p

    work1 = (_UNS1[0] + _UNS1[1] * TQ
             + (_UNS1[2] + _UNS1[3] * TQ + _UNS1[4] * T2) * T2)
    work2 = SQR * (_UNSQ[0] + _UNSQ[1] * TQ + _UNSQ[2] * T2)
    rho_s = (_UNT[1] * TQ
             + (_UNT[2] + _UNT[3] * TQ + (_UNT[4] + _UNT[5] * TQ) * T2) * T2
             + (_UNS2T0 * SQ + work1 + work2) * SQ)

    work3 = (_BUP0S1[0] + _BUP0S1[1] * TQ
             + (_BUP0S1[2] + _BUP0S1[3] * TQ) * T2
             + p * (_BUP1S1[0] + _BUP1S1[1] * TQ + _BUP1S1[2] * T2)
             + p2 * (_BUP2S1[0] + _BUP2S1[1] * TQ + _BUP2S1[2] * T2))
    work4 = SQR * (_BUP0SQ[0] + _BUP0SQ[1] * TQ + _BUP0SQ[2] * T2
                   + _BUP1SQT0 * p)
    bulk = (_BUP0S0[0] + _BUP0S0[1] * TQ
            + (_BUP0S0[2] + _BUP0S0[3] * TQ + _BUP0S0[4] * T2) * T2
            + p * (_BUP1S0[0] + _BUP1S0[1] * TQ
                   + (_BUP1S0[2] + _BUP1S0[3] * TQ) * T2)
            + p2 * (_BUP2S0[0] + _BUP2S0[1] * TQ + _BUP2S0[2] * T2)
            + SQ * (work3 + work4))

    return (_UNT[0] + rho_s) * bulk / (bulk - p)


def density_linear(cfg, T, S):
    """ref: mpas_ocn_equation_of_state_linear.F."""
    return (cfg.config_eos_linear_densityref
            - cfg.config_eos_linear_alpha * (T - cfg.config_eos_linear_Tref)
            + cfg.config_eos_linear_beta * (S - cfg.config_eos_linear_Sref))


def density(cfg, T, S, p_bars=0.0):
    """EOS dispatcher (ref: ocn_equation_of_state_density)."""
    if cfg.config_eos_type == "jm":
        return density_jm(T, S, p_bars)
    return density_linear(cfg, T, S)
