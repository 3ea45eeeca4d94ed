"""Vertical interpolation for first-guess met data.

Port of mpas_tpu/cores/init_atmosphere/vinterp.py: numpy only, the same
arithmetic; the port keeps its own copy so that it imports nothing of the
JAX package.

ref: src/core_init_atmosphere/mpas_init_atm_vinterp.F (111 LoC):
vertical_interp — monotone-ordered column interpolation with optional
extrapolation clamping, used to move met fields from source levels
(pressure or height) onto the MPAS vertical grid.
"""

from __future__ import annotations

import numpy as np


def vertical_interp(target_levels, src_levels, src_vals, extrap="const"):
    """Interpolate columns: src (nCol, nSrc) sampled at src_levels
    (nCol, nSrc) -> values at target_levels (nCol, nTgt). Levels must be
    monotone increasing along the axis (callers pass -p for pressure
    coordinates, like the reference's order_mono handling).

    extrap: 'const' clamps to the end values; 'linear' extrapolates.
    """
    tgt = np.asarray(target_levels, dtype=np.float64)
    src = np.asarray(src_levels, dtype=np.float64)
    val = np.asarray(src_vals, dtype=np.float64)
    n_col, n_src = src.shape
    out = np.empty((n_col, tgt.shape[1]))
    for c in range(n_col):
        out[c] = np.interp(tgt[c], src[c], val[c])
        if extrap == "linear":
            lo = tgt[c] < src[c, 0]
            hi = tgt[c] > src[c, -1]
            s0 = (val[c, 1] - val[c, 0]) / max(src[c, 1] - src[c, 0], 1e-30)
            s1 = (val[c, -1] - val[c, -2]) \
                / max(src[c, -1] - src[c, -2], 1e-30)
            out[c][lo] = val[c, 0] + s0 * (tgt[c][lo] - src[c, 0])
            out[c][hi] = val[c, -1] + s1 * (tgt[c][hi] - src[c, -1])
    return out
