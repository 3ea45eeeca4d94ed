"""Horizontal interpolation from regular source grids to mesh points.

Port of mpas_tpu/cores/init_atmosphere/hinterp.py: numpy only, the same
arithmetic; the port keeps its own copy so that it imports nothing of the
JAX package.

ref: src/core_init_atmosphere/mpas_init_atm_hinterp.F (1,059 LoC):
interp_sequence with methods {nearest neighbor, 4-point bilinear, 16-point
overlapping-parabolic (here: bicubic-like weighted), search for masked
data}. Source arrays are (ny, nx) on a projected grid; targets are given
as fractional (i, j) from llxy.llij.
"""

from __future__ import annotations

import numpy as np


def interp_nearest(src, i, j, missing=None):
    """ref: search_extrap/nearest branch."""
    ny, nx = src.shape
    ii = np.clip(np.round(i).astype(int) - 1, 0, nx - 1)
    jj = np.clip(np.round(j).astype(int) - 1, 0, ny - 1)
    return src[jj, ii]


def interp_bilinear(src, i, j, missing=None):
    """ref: four_pt bilinear branch (wt_bilinear)."""
    ny, nx = src.shape
    x = np.clip(i - 1.0, 0.0, nx - 1.0)
    y = np.clip(j - 1.0, 0.0, ny - 1.0)
    x0 = np.clip(np.floor(x).astype(int), 0, nx - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, ny - 2)
    fx = x - x0
    fy = y - y0
    v00 = src[y0, x0]
    v01 = src[y0, x0 + 1]
    v10 = src[y0 + 1, x0]
    v11 = src[y0 + 1, x0 + 1]
    if missing is not None:
        ok = (v00 != missing) & (v01 != missing) \
            & (v10 != missing) & (v11 != missing)
        near = interp_nearest(src, i, j)
        out = ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v01
               + (1 - fx) * fy * v10 + fx * fy * v11)
        return np.where(ok, out, near)
    return ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v01
            + (1 - fx) * fy * v10 + fx * fy * v11)


def interp_weighted16(src, i, j, missing=None):
    """16-point interpolation with the WPS overlapping-parabolic weights
    (ref: sixteen_pt branch)."""
    ny, nx = src.shape
    x = np.clip(i - 1.0, 1.0, nx - 3.0)
    y = np.clip(j - 1.0, 1.0, ny - 3.0)
    x0 = np.clip(np.floor(x).astype(int), 1, nx - 3)
    y0 = np.clip(np.floor(y).astype(int), 1, ny - 3)
    fx = x - x0
    fy = y - y0

    def w(t):
        # one-parameter cubic (Catmull-Rom) weights
        return np.stack([
            -0.5 * t ** 3 + t ** 2 - 0.5 * t,
            1.5 * t ** 3 - 2.5 * t ** 2 + 1.0,
            -1.5 * t ** 3 + 2.0 * t ** 2 + 0.5 * t,
            0.5 * t ** 3 - 0.5 * t ** 2,
        ], axis=-1)                                    # (..., 4)

    wx = w(fx)
    wy = w(fy)
    out = np.zeros_like(np.asarray(fx, dtype=src.dtype))
    for a in range(4):
        row = np.zeros_like(out)
        for b in range(4):
            row = row + wx[..., b] * src[y0 + a - 1, x0 + b - 1]
        out = out + wy[..., a] * row
    if missing is not None:
        return np.where(np.isfinite(out), out,
                        interp_nearest(src, i, j))
    return out


METHODS = {"nearest": interp_nearest, "bilinear": interp_bilinear,
           "sixteen_pt": interp_weighted16}


def interp_sequence(src, i, j, methods=("sixteen_pt", "bilinear",
                                        "nearest"), missing=None):
    """Try each method in order, falling back where the result is missing
    (ref: interp_sequence, mpas_init_atm_hinterp.F)."""
    out = None
    for m in methods:
        cand = METHODS[m](src, i, j, missing=missing)
        if out is None:
            out = cand
        else:
            bad = ~np.isfinite(out) if missing is None else (out == missing)
            out = np.where(bad, cand, out)
    return out
