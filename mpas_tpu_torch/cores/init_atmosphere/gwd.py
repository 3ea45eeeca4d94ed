"""GWDO static fields from high-resolution topography.

Port of mpas_tpu/cores/init_atmosphere/gwd.py: numpy only, the same
arithmetic; the port keeps its own copy so that it imports nothing of the
JAX package.

ref: src/core_init_atmosphere/mpas_init_atm_gwd.F (1,196 LoC) — computes
the subgrid orography statistics consumed by the gravity-wave-drag scheme
(module_bl_gwdo), exactly as compute_gwd_fields:

  var2d : standard deviation of the subgrid terrain (get_var :615-632)
  con   : convexity — 4th moment about the dominant-surface mean over
          var^2, zeroed over water-dominated or flat boxes
          (get_con :~470-530, WATER landuse logic)
  oa1-4 : orographic asymmetry = (nu - nd)/(nu + nd) of above-box-mean
          counts between half-boxes split W|E, S|N and the two diagonals
          (get_oa1..4). Sign convention: positive when the high ground
          lies in the first (west / south / SW-of-diagonal) half — the
          reference's nu half.
  ol1-4 : effective orographic length = fraction of points above the
          critical height hc = 1116.2 - 0.878 * var2d, over the middle
          rows (ol1), middle columns (ol2), and the two quadrant pairs
          (ol3: SW+NE, ol4: NW+SE) (get_ol1..4, hc at :268).

The full-globe driver mirrors get_box (:~640-700): per-cell boxes sized
by the mean cell-edge distance (nx latitude-corrected and capped at half
the zonal dimension), longitude-periodic, pole crossings reflected with
a 180-degree zonal shift (ii + topo_y == ii + topo_x/2). Cells are
processed grouped by box shape so each group is one vectorized numpy
pass (init-time, host-side — the same role as the reference's serial
loop on the master task).
"""

from __future__ import annotations

import numpy as np

RE = 6371229.0          # MPAS-Atmosphere Earth radius (gwd.F:41)
WATER = 16              # USGS water landuse category (gwd.F:67)


# --------------------------------------------------------------------------
# per-box statistics (exact get_var/get_con/get_oa*/get_ol* forms)
# --------------------------------------------------------------------------

def _box_stats(box, box_landuse=None):
    """The 10 GWD statistics for a batch of boxes.

    box: (nB, ny, nx); box_landuse optional (all-land assumed if None).
    Index convention matches the reference: i (last axis) = west->east,
    j = south->north.
    """
    box = np.asarray(box, dtype=np.float64)
    nB, ny, nx = box.shape
    npts = nx * ny
    mean = box.mean(axis=(1, 2))
    anom = box - mean[:, None, None]
    var = (anom ** 2).mean(axis=(1, 2))
    var2d = np.sqrt(np.maximum(var, 0.0))

    # --- con (get_con): 4th moment about the dominant-surface mean -----
    if box_landuse is None:
        land = np.ones_like(box, dtype=bool)
    else:
        land = np.asarray(box_landuse) != WATER
    nland = land.sum(axis=(1, 2)).astype(np.float64)
    mean_land = np.where(nland > 0,
                         (box * land).sum(axis=(1, 2))
                         / np.maximum(nland, 1.0), 0.0)
    nwater = npts - nland
    mean_water = np.where(nwater > 0,
                          (box * ~land).sum(axis=(1, 2))
                          / np.maximum(nwater, 1.0), 0.0)
    xland = nland / npts
    oro = np.where(xland >= 0.5, mean_land, mean_water)
    s4 = ((box - oro[:, None, None]) ** 4).mean(axis=(1, 2))
    con = np.where((var2d >= 1.0) & (xland >= 0.5),
                   s4 / np.maximum(var ** 2, 1e-30), 0.0)

    # --- oa1..4 (get_oa1..4): above-box-mean count asymmetries ----------
    above = anom > 0.0
    ii = np.arange(nx)[None, None, :]
    jj = np.arange(ny)[None, :, None]
    ratio = ny / nx

    def oa(first_mask):
        nu = (above & first_mask).sum(axis=(1, 2)).astype(np.float64)
        nd = (above & ~first_mask).sum(axis=(1, 2)).astype(np.float64)
        tot = nu + nd
        return np.where(tot > 0, (nu - nd) / np.maximum(tot, 1.0), 0.0)

    west = ii < nx // 2                       # i = 1..nx/2 (1-based)
    south = jj < ny // 2
    # diagonals exactly as the reference's integer test
    # nint(i*ny/nx) < (ny - j)  with 1-based i,j
    i1 = ii + 1.0
    j1 = jj + 1.0
    diag3 = np.rint(i1 * ratio) < (ny - j1)
    diag4 = np.rint(i1 * ratio) < j1
    oa1 = oa(np.broadcast_to(west, box.shape))
    oa2 = oa(np.broadcast_to(south, box.shape))
    oa3 = oa(np.broadcast_to(diag3, box.shape))
    oa4 = oa(np.broadcast_to(diag4, box.shape))

    # --- ol1..4 (get_ol1..4): fraction above hc over sub-regions --------
    hc = 1116.2 - 0.878 * var2d
    high = box > hc[:, None, None]
    # ol1: rows ny/4..3ny/4 (all columns)
    r0, r1 = ny // 4, 3 * ny // 4
    ol1 = high[:, max(r0 - 1, 0):r1, :].mean(axis=(1, 2))
    c0, c1 = nx // 4, 3 * nx // 4
    ol2 = high[:, :, max(c0 - 1, 0):c1].mean(axis=(1, 2))
    hx, hy = nx // 2, ny // 2
    ol3 = (high[:, :hy, :hx].sum(axis=(1, 2))
           + high[:, hy:, hx:].sum(axis=(1, 2))) \
        / (hy * hx + (ny - hy) * (nx - hx))
    ol4 = (high[:, hy:, :hx].sum(axis=(1, 2))
           + high[:, :hy, hx:].sum(axis=(1, 2))) \
        / ((ny - hy) * hx + hy * (nx - hx))

    return {"var2d": var2d, "con": con,
            "oa1": oa1, "oa2": oa2, "oa3": oa3, "oa4": oa4,
            "ol1": ol1, "ol2": ol2, "ol3": ol3, "ol4": ol4}


# --------------------------------------------------------------------------
# fixed-box API (regional/test use)
# --------------------------------------------------------------------------

def _box_samples(topo, i_c, j_c, half):
    """Gather (2*half)^2 samples around fractional centers (clamped)."""
    ny, nx = topo.shape
    di = np.arange(-half, half)
    jj = np.clip(np.asarray(j_c)[:, None] + di[None, :],
                 0, ny - 1).astype(int)
    ii = np.clip(np.asarray(i_c)[:, None] + di[None, :],
                 0, nx - 1).astype(int)
    return topo[jj[:, :, None], ii[:, None, :]]


def gwd_statics(topo, i_c, j_c, half: int = 8, landuse=None):
    """GWD statistics with a fixed sampling box (2*half)^2 around
    fractional grid centers — the regional/test entry; statistics are
    the exact reference forms (_box_stats)."""
    topo = np.asarray(topo, dtype=np.float64)
    boxes = _box_samples(topo, i_c, j_c, half)
    lu = None
    if landuse is not None:
        lu = _box_samples(np.asarray(landuse), i_c, j_c, half)
    return _box_stats(boxes, lu)


# --------------------------------------------------------------------------
# full-globe driver (get_box + compute_gwd_fields)
# --------------------------------------------------------------------------

def compute_gwd_fields(topo, landuse, lat_deg, lon_deg, dc_m,
                       start_lat=-90.0, start_lon=-180.0,
                       cell_scaling=1.0):
    """Per-cell GWD statics from a global lat-lon terrain grid.

    topo/landuse: (topo_y, topo_x) global grids (row 0 at start_lat);
    lat_deg/lon_deg (nCells,) cell centers; dc_m (nCells,) mean
    cell-edge distance (the reference's mean dcEdge, scaled by
    config_gwd_cell_scaling). Boxes follow get_box exactly: nx is
    latitude-corrected and capped at topo_x/2, longitude wraps, pole
    rows reflect with a 180-degree zonal shift.
    """
    topo = np.asarray(topo)
    topo_y, topo_x = topo.shape
    pts_per_degree = topo_x / 360.0
    lat = np.asarray(lat_deg, dtype=np.float64)
    lon = np.asarray(lon_deg, dtype=np.float64)
    dc = np.asarray(dc_m, dtype=np.float64) * cell_scaling
    nC = lat.shape[0]

    coslat = np.cos(np.deg2rad(lat))
    nx_full = np.ceil((180.0 * dc * pts_per_degree)
                      / (np.pi * RE * np.maximum(coslat, 1e-12)))
    cap_ok = coslat > (2.0 * pts_per_degree * dc * 180.0) \
        / (topo_x * np.pi * RE)
    nx_box = np.where(cap_ok, nx_full, topo_x // 2).astype(int)
    nx_box = np.maximum(nx_box, 2)
    ny_box = np.maximum(np.ceil((180.0 * dc * pts_per_degree)
                                / (np.pi * RE)).astype(int), 2)

    ic = (np.rint((lon - start_lon) * pts_per_degree).astype(int)) % topo_x
    jc = np.rint((lat - start_lat) * pts_per_degree).astype(int)

    out = {k: np.zeros(nC) for k in
           ("var2d", "con", "oa1", "oa2", "oa3", "oa4",
            "ol1", "ol2", "ol3", "ol4")}

    # group cells by (nx, ny) so each group is one vectorized gather
    keys = nx_box.astype(np.int64) * 1000000 + ny_box.astype(np.int64)
    for key in np.unique(keys):
        sel = np.nonzero(keys == key)[0]
        bx, by = int(nx_box[sel[0]]), int(ny_box[sel[0]])
        di = np.arange(bx) - bx // 2
        dj = np.arange(by) - by // 2
        ii = ic[sel][:, None, None] + di[None, None, :]   # (nSel,1,bx)
        jj = jc[sel][:, None, None] + dj[None, :, None]   # (nSel,by,1)
        ii = np.broadcast_to(ii, (len(sel), by, bx)).copy()
        jj = np.broadcast_to(jj, (len(sel), by, bx)).copy()
        # pole reflections with 180-degree zonal shift (get_box :662-672)
        below = jj < 0
        ii = np.where(below, ii + topo_x // 2, ii)
        jj = np.where(below, -jj - 1, jj)
        over = jj >= topo_y
        ii = np.where(over, ii + topo_x // 2, ii)
        jj = np.where(over, 2 * topo_y - jj - 1, jj)
        ii = ii % topo_x
        boxes = topo[jj, ii]
        lu = None if landuse is None else np.asarray(landuse)[jj, ii]
        stats = _box_stats(boxes, lu)
        for k, v in stats.items():
            out[k][sel] = v
    return out


def mean_cell_diameter(mesh):
    """Mean dcEdge over each cell's edges (compute_gwd_fields :247-254)."""
    import numpy as _np
    dc_edge = _np.asarray(mesh.dcEdge)
    eoc = _np.asarray(mesh.edgesOnCell)
    neoc = _np.asarray(mesh.nEdgesOnCell)
    n = eoc.shape[0]
    out = _np.zeros(n)
    for i in range(eoc.shape[1]):
        valid = i < neoc
        out += _np.where(valid, dc_edge[_np.clip(eoc[:, i], 0,
                                                 len(dc_edge) - 1)], 0.0)
    return out / _np.maximum(neoc, 1)
