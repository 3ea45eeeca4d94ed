"""Static/terrain field interpolation from geogrid tiles (port of
mpas_tpu/cores/init_atmosphere/static.py).

ref: src/core_init_atmosphere/mpas_init_atm_static.F (1,473 LoC) +
read_geogrid.c: read WPS geographical tiles (terrain, land use, soil
category, ...) and interpolate them onto mesh cells.

The tile reader and writer are numpy, where the reference package calls
its C++ library (tools/geogrid) through ctypes and runs `make` when the
library is missing. Numpy needs no compiler at import, runs wherever the
tests run, and does not depend on a shared library built on another
machine. The format is read_geogrid.c's: raw fixed-width integers of 1-4
bytes (3-byte words unpacked by hand), big- (endian=0) or little-endian,
signed or unsigned, scaled by `scalefactor` in float32. A tile that
cannot be read raises.
"""

from __future__ import annotations

import numpy as np


def _check_wordsize(wordsize):
    if wordsize not in (1, 2, 3, 4):
        raise ValueError(f"geogrid word size must be 1-4 bytes, not "
                         f"{wordsize}")


def read_geogrid_tile(path, nx, ny, nz=1, isigned=1, endian=0,
                      scalefactor=1.0, wordsize=2):
    """Read one tile -> (nz, ny, nx) float32 array.
    ref: read_geogrid.c contract (big-endian scaled ints)."""
    _check_wordsize(wordsize)
    n = nx * ny * nz
    with open(path, "rb") as fh:
        raw = np.frombuffer(fh.read(n * wordsize), dtype=np.uint8)
    if raw.size != n * wordsize:
        raise IOError(f"geogrid tile {path}: {raw.size} bytes, expected "
                      f"{n * wordsize}")
    b = raw.reshape(n, wordsize).astype(np.uint32)
    if endian != 0:                       # little-endian: reverse bytes
        b = b[:, ::-1]
    u = np.zeros(n, dtype=np.uint32)
    for k in range(wordsize):             # most significant byte first
        u = (u << np.uint32(8)) | b[:, k]
    v = u.astype(np.int64)
    if isigned:                           # sign-extend
        half = np.int64(1) << np.int64(8 * wordsize - 1)
        v = np.where(v >= half, v - 2 * half, v)
    out = v.astype(np.float32) * np.float32(scalefactor)
    return out.reshape(nz, ny, nx)


def write_geogrid_tile(path, arr, isigned=1, endian=0, scalefactor=1.0,
                       wordsize=2):
    """Inverse of read_geogrid_tile: value / scalefactor in float32,
    truncated toward zero, wrapped to the word size."""
    _check_wordsize(wordsize)
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    v = (arr.ravel() / np.float32(scalefactor)).astype(np.int64)
    u = v.astype(np.uint32)               # two's complement, mod 2^32
    shifts = np.arange(wordsize - 1, -1, -1, dtype=np.uint32) * 8
    b = ((u[:, None] >> shifts[None, :]) & np.uint32(0xFF)).astype(np.uint8)
    if endian != 0:
        b = b[:, ::-1]
    with open(path, "wb") as fh:
        fh.write(np.ascontiguousarray(b).tobytes())


def interp_static_to_cells(tile, proj, lat_cell_deg, lon_cell_deg,
                           method="bilinear"):
    """Interpolate a (ny, nx) tile to mesh cells through its projection.
    ref: mpas_init_atm_static.F interp loops."""
    from mpas_tpu_torch.cores.init_atmosphere.hinterp import METHODS
    from mpas_tpu_torch.cores.init_atmosphere.llxy import llij
    i, j = llij(proj, lat_cell_deg, lon_cell_deg)
    return METHODS[method](tile, i, j)


# --------------------------------------------------------------------------
# pixel-push aggregation (the static-field interpolation method of
# mpas_init_atm_static.F: every high-res source pixel is assigned to its
# nearest cell and aggregated — mean for terrain (:320-369), dominant
# category for land use / soil category (:420-555))
# --------------------------------------------------------------------------

def _cell_xyz(lat_cell, lon_cell):
    lat = np.asarray(lat_cell)
    lon = np.asarray(lon_cell)
    return np.stack([np.cos(lon) * np.cos(lat),
                     np.sin(lon) * np.cos(lat),
                     np.sin(lat)], axis=-1)


def nearest_cells(lat_pts, lon_pts, lat_cell, lon_cell):
    """Containing cell for each (lat, lon) point (radians).

    The reference walks the cell graph per pixel (nearest_cell,
    mpas_init_atm_static.F); for a Voronoi mesh the containing cell IS
    the nearest generator, so a KD-tree query on the unit sphere is
    exact and vectorizes over all pixels at once.
    """
    from scipy.spatial import cKDTree
    tree = cKDTree(_cell_xyz(lat_cell, lon_cell))
    _, idx = tree.query(_cell_xyz(lat_pts, lon_pts))
    return idx


def pixel_push_mean(lat_pts, lon_pts, values, lat_cell, lon_cell,
                    fill=0.0):
    """Per-cell mean of all source pixels landing in the cell (the TER
    aggregation, mpas_init_atm_static.F:320-369). Points/cells in
    radians; returns (nCells,) and the per-cell hit count."""
    idx = nearest_cells(lat_pts, lon_pts, lat_cell, lon_cell)
    n = len(np.asarray(lat_cell))
    acc = np.bincount(idx, weights=np.asarray(values, np.float64),
                      minlength=n)
    cnt = np.bincount(idx, minlength=n)
    out = np.where(cnt > 0, acc / np.maximum(cnt, 1), fill)
    return out, cnt


def pixel_push_dominant(lat_pts, lon_pts, category, lat_cell, lon_cell,
                        ncat, skip_zero=True, default=1):
    """Dominant (modal) category per cell (the LU_INDEX / SOILCAT_TOP
    aggregation, mpas_init_atm_static.F:420-555). Categories are
    1-based; zero pixels are skipped as in the reference (:418)."""
    cat = np.asarray(category).astype(np.int64)
    lat_pts = np.asarray(lat_pts)
    lon_pts = np.asarray(lon_pts)
    if skip_zero:
        keep = cat > 0
        cat = cat[keep]
        lat_pts = lat_pts[keep]
        lon_pts = lon_pts[keep]
    idx = nearest_cells(lat_pts, lon_pts, lat_cell, lon_cell)
    n = len(np.asarray(lat_cell))
    hist = np.bincount(idx * (ncat + 1) + np.clip(cat, 1, ncat),
                       minlength=n * (ncat + 1)).reshape(n, ncat + 1)
    hist[:, 0] = -1                        # category 0 never wins
    dom = hist.argmax(axis=1)
    dom = np.where(hist.max(axis=1) <= 0, default, dom)
    return dom, hist[:, 1:]


def landuse_consistency(lu_index, soilcat_top, iswater_lu=16,
                        isice_lu=24, iswater_soil=14, isice_soil=16):
    """Water/ice cross-consistency fixups between the dominant land-use
    and soil categories (mpas_init_atm_static.F:561-588): land ice
    forces the ice soil category; a cell that is water in exactly one of
    the two datasets becomes water in both; landmask = not-water.
    Returns (lu_index, soilcat_top, landmask)."""
    lu = np.asarray(lu_index).copy()
    sc = np.asarray(soilcat_top).copy()
    sc = np.where(lu == isice_lu, isice_soil, sc)
    water_mismatch = (lu == iswater_lu) != (sc == iswater_soil)
    lu = np.where(water_mismatch & (lu != iswater_lu), iswater_lu, lu)
    sc = np.where(water_mismatch & (sc != iswater_soil), iswater_soil, sc)
    landmask = (lu != iswater_lu).astype(np.int32)
    return lu, sc, landmask


def soiltemp_adjust(soiltemp, ter, landmask):
    """Deep soil temperature reduced to terrain elevation with the
    standard 6.5 K/km lapse (the reference applies it after the 1-degree
    pull interpolation; water cells stay 0)."""
    out = np.where(np.asarray(landmask) == 1,
                   np.asarray(soiltemp) - 0.0065 * np.asarray(ter), 0.0)
    return out


def monthly_climatology_to_cells(tile, proj, lat_cell_deg, lon_cell_deg,
                                 missing=None):
    """Interpolate a (12, ny, nx) monthly climatology (GREENFRAC /
    ALBEDO12M) to cells with the reference's method fallback sequence
    (FOUR_POINT -> W_AVERAGE16 -> SEARCH; mpas_init_atm_static.F:
    1000-1055). Returns (nCells, 12)."""
    from mpas_tpu_torch.cores.init_atmosphere.hinterp import (
        interp_sequence)
    from mpas_tpu_torch.cores.init_atmosphere.llxy import llij
    i, j = llij(proj, lat_cell_deg, lon_cell_deg)
    months = [interp_sequence(np.asarray(tile)[k], i, j, missing=missing)
              for k in range(np.asarray(tile).shape[0])]
    return np.stack(months, axis=-1)


def shd_min_max(greenfrac12):
    """shdmin/shdmax from the monthly green fraction (the Noah
    vegetation-fraction bounds the reference derives)."""
    g = np.asarray(greenfrac12)
    return g.min(axis=-1), g.max(axis=-1)
