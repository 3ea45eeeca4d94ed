"""Isobaric diagnostics: interpolate model-level fields to pressure levels
(port of mpas_tpu/cores/atmosphere/diagnostics/isobaric.py).

ref: src/core_atmosphere/diagnostics/isobaric_diagnostics.F:
temperature/height/wind/RH at the standard isobaric levels, plus mean
sea-level pressure (the reference's surface-pressure extrapolation).

Log-pressure linear interpolation as a vectorized masked gather: the
first level above each target is an argmax over comparisons.
"""

from __future__ import annotations

import functools
import math

import torch

from mpas_tpu_torch.constants import cp, gravity, p0, rgas

# standard levels (Pa), ref: isobaric_diagnostics.F level list
ISOBARIC_LEVELS = (92500.0, 85000.0, 70000.0, 50000.0, 30000.0,
                   25000.0, 20000.0, 10000.0)


@functools.cache
def _levels(levels, device, dtype):
    """The target levels and their logs on (device, dtype), copied once."""
    lv = torch.as_tensor(levels, dtype=dtype, device=device)
    return lv, torch.log(lv)


def interp_to_pressure(p_col, f_col, levels):
    """Interpolate f(p) to target levels in log-p.

    p_col: (nCells, nz) decreasing with k (k=0 near surface);
    f_col: (nCells, nz); levels: a tuple of pressures (Pa). Returns
    (nCells, nL), NaN where a level is below the surface or above the top
    (the reference marks these with special values)."""
    _, lt = _levels(tuple(map(float, levels)), p_col.device, p_col.dtype)
    lp = torch.log(p_col)                     # decreasing in k
    nz = p_col.shape[1]
    # index of the first model level with p < target (above the target);
    # CUDA's argmax takes no bool: both libraries give the first maximum
    above = lp[:, None, :] < lt[None, :, None]         # (nC, nL, nz)
    k_up = torch.argmax(above.to(torch.int32), dim=-1)
    has_up = torch.any(above, dim=-1)
    k_up = torch.clamp(k_up, 1, nz - 1)
    k_dn = k_up - 1
    lp_dn = torch.gather(lp, 1, k_dn)
    lp_up = torch.gather(lp, 1, k_up)
    w = (lt[None, :] - lp_dn) / torch.where(
        torch.abs(lp_up - lp_dn) > 1e-12, lp_up - lp_dn, 1e-12)
    w = torch.clamp(w, 0.0, 1.0)
    f = (1.0 - w) * torch.gather(f_col, 1, k_dn) \
        + w * torch.gather(f_col, 1, k_up)
    below_sfc = lt[None, :] > lp[:, :1]
    valid = has_up & ~below_sfc
    return torch.where(valid, f, math.nan)


def mslp(p_sfc, t_sfc, z_sfc):
    """Mean sea-level pressure by the standard-lapse reduction
    (ref: isobaric_diagnostics.F mslp computation)."""
    lapse = 0.0065
    t0 = t_sfc + lapse * z_sfc          # extrapolated sea-level temperature
    return p_sfc * (t0 / t_sfc) ** (gravity / (rgas * lapse))


def compute_isobaric(grid, state, diag, levels=ISOBARIC_LEVELS):
    """Returns dict of isobaric fields + mslp."""
    if state.scalars.shape[-1] > 0:
        qv = torch.clamp(state.scalars[..., 0], min=0.0)
        th = state.theta_m / (1.0 + 1.608 * qv)
    else:
        th = state.theta_m
    t = th * diag.exner
    p = p0 * diag.exner ** (cp / rgas)
    z_mid = 0.5 * (grid.zgrid[:, 1:] + grid.zgrid[:, :-1])

    return {
        "temperature_isobaric": interp_to_pressure(p, t, levels),
        "height_isobaric": interp_to_pressure(p, z_mid, levels),
        "theta_isobaric": interp_to_pressure(p, th, levels),
        "mslp": mslp(p[:, 0], t[:, 0], z_mid[:, 0]),
        "levels": _levels(tuple(map(float, levels)), p.device, p.dtype)[0],
    }
