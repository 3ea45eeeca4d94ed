"""Real-data initial conditions, init case 7 with a GFS first guess (port
of mpas_tpu/cores/init_atmosphere/real_case.py).

ref: src/core_init_atmosphere/mpas_init_atm_cases.F:2526+
(init_atm_case_gfs): read the WPS-intermediate first guess, horizontally
interpolate pressure-level fields to cells/edges, build the
terrain-following vertical grid over the first-guess terrain, vertically
interpolate to model levels using the first-guess geopotential heights,
hydrostatically balance, and produce the full dycore state.

Pipeline (all host-side numpy in float64; the result is CPU tensors that
the caller moves with .to(device, dtype), as for the idealized cases):
  met_reader.read_met_file -> fields        (mpas_init_atm_read_met.F)
  llxy/hinterp              -> cell/edge columns (mpas_init_atm_hinterp.F)
  vinterp.vertical_interp   -> model levels (mpas_init_atm_vinterp.F)
  hydrostatic pi integration -> rho/exner   (init_atm_case_gfs balance)

The grid carries the factored advection tensors (d2_bmat, d2w, the
per-cell d2w_own/d2w_opp/adv_sside/dv_cell), the only advection path of
the port's dycore, where the reference's init_real fills the indexed
advCellsForEdge/adv_coefs stencil. setup.build_adv_coefs builds that
stencil when a caller wants it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpas_tpu_torch.constants import a as EARTH_RADIUS
from mpas_tpu_torch.constants import cp, cv, gravity, omega, p0, rgas, rvord
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.setup import (AtmGrid,
                                                   build_adv_cell_tensors,
                                                   build_adv_factored,
                                                   build_cell_fit_matrices,
                                                   build_deformation_weights,
                                                   build_deriv_two, build_dss,
                                                   build_reconstruct_weights,
                                                   build_vertical_grid,
                                                   build_zb)
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.cores.init_atmosphere import hinterp, vinterp
from mpas_tpu_torch.cores.init_atmosphere.met_reader import (fields_by_level,
                                                             surface_field)

RCV = rgas / (cp - rgas)


def _latlon_ij(fld, lat_deg, lon_deg):
    """Fractional (i, j) into a cylindrical-equidistant slab (iproj 0).
    ref: the latlon branch of llxy (mpas_init_atm_llxy.F)."""
    lon = np.where(lon_deg < fld.startlon, lon_deg + 360.0, lon_deg)
    i = (lon - fld.startlon) / fld.deltalon
    j = (lat_deg - fld.startlat) / fld.deltalat
    i = np.clip(i, 0.0, fld.nx - 1.001)
    j = np.clip(j, 0.0, fld.ny - 1.001)
    return i, j


def _interp_levels(fields, name, lat_deg, lon_deg):
    """All pressure levels of `name`, bilinearly interpolated to points.
    Returns (levels_pa (nlev,), values (npts, nlev))."""
    levels, slabs = fields_by_level(fields, name)
    if slabs is None:
        raise ValueError(f"met file lacks field {name!r}")
    meta = next(f for f in fields if f.field == name and f.xlvl < 2.0e5)
    i, j = _latlon_ij(meta, lat_deg, lon_deg)
    vals = np.stack(
        [hinterp.interp_bilinear(slabs[k], i, j)
         for k in range(slabs.shape[0])], axis=1)
    return levels, vals


_REQUIRED = object()


def _interp_surface(fields, name, lat_deg, lon_deg, default=_REQUIRED):
    """default=None returns None when the field is absent (optional
    fields: soil layers, SST, SEAICE); omitting default raises."""
    slab = surface_field(fields, name)
    if slab is None:
        if default is _REQUIRED:
            raise ValueError(f"met file lacks surface field {name!r}")
        if default is None:
            return None
        return np.full(lat_deg.shape, default)
    meta = next(f for f in fields if f.field == name and f.xlvl >= 2.0e5)
    i, j = _latlon_ij(meta, lat_deg, lon_deg)
    return hinterp.interp_bilinear(slab, i, j)


def init_real(mesh, cfg: AtmConfig, met_fields, zt: float = 30000.0,
              timings: dict = None):
    """Build (AtmGrid, AtmState, AtmDiag, extras) from first-guess met
    fields, as CPU float64 tensors (extras: numpy surface fields).

    met_fields: list[MetField] from met_reader (lat/lon projection).
    Required fields: TT, UU, VV, RH or SPECHUMD, GHT at pressure levels;
    PSFC, SKINTEMP and SOILHGT at the surface. timings: a dict that, where
    given, receives the host seconds of the vertical interpolation under
    "vertical_interp_s".
    """
    nz1 = cfg.config_nvertlevels
    nz = nz1 + 1
    if mesh.on_sphere and float(mesh.sphere_radius) < 1.0e6:
        # unit-sphere meshes are scaled to Earth here, like the idealized
        # cases (ref: each init case's sphere rescale)
        mesh = mesh.scaled(EARTH_RADIUS)
    nC = mesh.nCells
    lat_c = np.degrees(np.asarray(mesh.latCell))
    lon_c = np.degrees(np.asarray(mesh.lonCell))
    lat_e = np.degrees(np.asarray(mesh.latEdge))
    lon_e = np.degrees(np.asarray(mesh.lonEdge))
    t_vi = [0.0]

    def vertical_interp(*args):
        t0 = time.perf_counter()
        out = vinterp.vertical_interp(*args)
        t_vi[0] += time.perf_counter() - t0
        return out

    # ---- first-guess columns at cells (ref :2560-2800) -------------------
    plev, t_cols = _interp_levels(met_fields, "TT", lat_c, lon_c)
    _, ght_cols = _interp_levels(met_fields, "GHT", lat_c, lon_c)
    try:
        _, q_cols = _interp_levels(met_fields, "SPECHUMD", lat_c, lon_c)
    except ValueError:
        _, rh_cols = _interp_levels(met_fields, "RH", lat_c, lon_c)
        es = 611.2 * np.exp(17.67 * (t_cols - 273.15) / (t_cols - 29.65))
        qsat = 0.622 * es / np.maximum(plev[None, :] - es, 100.0)
        q_cols = np.clip(rh_cols / 100.0, 0.0, 1.0) * qsat
    _, u_cols_e = _interp_levels(met_fields, "UU", lat_e, lon_e)
    _, v_cols_e = _interp_levels(met_fields, "VV", lat_e, lon_e)

    ter = _interp_surface(met_fields, "SOILHGT", lat_c, lon_c, default=0.0)
    psfc = _interp_surface(met_fields, "PSFC", lat_c, lon_c,
                           default=101325.0)
    tsk = _interp_surface(met_fields, "SKINTEMP", lat_c, lon_c,
                          default=288.0)

    # ---- terrain-following vertical grid (ref :2095-2210 genre) ----------
    vg, _, _ = build_vertical_grid(nz1, zt=zt, stretch=1.0)
    zw, dzw = vg.zw.numpy(), vg.dzw.numpy()
    dzu = np.concatenate([[0.0], 0.5 * (dzw[1:] + dzw[:-1]), [0.0]])
    hx = np.maximum(ter, 0.0)
    zgrid = zw[None, :] * (1.0 - hx[:, None] / zt) + hx[:, None]
    zz = dzw[None, :] / (zgrid[:, 1:] - zgrid[:, :-1])
    coe = np.asarray(mesh.cellsOnEdge)
    c1, c2 = coe[:, 0], coe[:, 1]
    zxu = 0.5 * ((zgrid[c2, :-1] - zgrid[c1, :-1])
                 + (zgrid[c2, 1:] - zgrid[c1, 1:])) \
        * np.asarray(mesh.invDcEdge)[:, None] \
        * (1.0 - np.asarray(mesh.boundaryEdge))[:, None]
    zmid = 0.5 * (zgrid[:, :-1] + zgrid[:, 1:])

    # ---- vertical interpolation to model levels (ref vinterp) ------------
    # first-guess heights increase with decreasing pressure; interp in z
    kappa = rgas / cp
    theta_cols = t_cols * (p0 / plev[None, :]) ** kappa
    t_full = vertical_interp(zmid, ght_cols, theta_cols)
    qv = np.maximum(vertical_interp(zmid, ght_cols, q_cols), 0.0)
    # relative humidity on model levels, for the moisture rebalance below
    t_abs0 = vertical_interp(zmid, ght_cols, t_cols)
    es0 = 611.2 * np.exp(17.67 * (t_abs0 - 273.15) / (t_abs0 - 29.65))
    p_guess = np.exp(vertical_interp(zmid, ght_cols,
                                     np.log(plev)[None, :]
                                     * np.ones_like(ght_cols)))
    rh_model = np.clip(qv * np.maximum(p_guess - es0, 100.0)
                       / (0.622 * es0), 0.0, 1.0)
    theta_m = t_full * (1.0 + rvord * qv)

    # edge winds -> normal velocity
    zmid_e = 0.5 * (zmid[c1] + zmid[c2])
    _, ght_e = _interp_levels(met_fields, "GHT", lat_e, lon_e)
    u_e = vertical_interp(zmid_e, ght_e, u_cols_e)
    v_e = vertical_interp(zmid_e, ght_e, v_cols_e)
    ang = np.asarray(mesh.angleEdge)[:, None]
    u = (u_e * np.cos(ang) + v_e * np.sin(ang)) \
        * (1.0 - np.asarray(mesh.boundaryEdge))[:, None]

    # ---- hydrostatic balance (ref :2277-2301 genre, on theta_m) -----------
    def pi_columns(theta):
        """Integrate exner hydrostatically UPWARD per column from each
        column's own interpolated surface pressure, so the horizontal PSFC
        structure constrains the 3-D mass field."""
        pi = np.zeros((nC, nz1))
        pi_sfc = (psfc / p0) ** (rgas / cp)
        pi[:, 0] = pi_sfc - 0.5 * dzw[0] * gravity \
            / (cp * theta[:, 0] * zz[:, 0])
        for k in range(1, nz1):
            pi[:, k] = pi[:, k - 1] - dzu[k] * gravity \
                / (cp * 0.5 * (theta[:, k - 1] + theta[:, k])
                   * 0.5 * (zz[:, k - 1] + zz[:, k]))
        return pi

    # ---- iterative moisture/hydrostatic rebalance: the column pressure
    # depends on theta_m, and qv depends on the model-level pressure
    # through RH; iterate both to a joint fixed point.
    for _ in range(10):
        p = pi_columns(theta_m)
        p_model = p0 * p ** (cp / rgas)
        t_abs = t_full * p
        es = 611.2 * np.exp(17.67 * (t_abs - 273.15) / (t_abs - 29.65))
        qv = np.clip(rh_model * 0.622 * es
                     / np.maximum(p_model - es, 100.0), 0.0, 0.04)
        theta_m = t_full * (1.0 + rvord * qv)

    # base state: dry isothermal-lapse reference column (t_init genre)
    tb = np.broadcast_to(t_full.mean(axis=0)[None, :], t_full.shape).copy()
    pb = pi_columns(tb)
    p = pi_columns(theta_m)
    rb = pb ** (1.0 / RCV) / ((rgas / p0) * tb * zz)
    rtb = rb * tb
    rho_zz = p ** (1.0 / RCV) / ((rgas / p0) * theta_m * zz)
    rr = rho_zz - rb
    rt = rho_zz * theta_m - rtb

    # Coriolis from latitude (ref: f = 2 Omega sin(lat) in the real case)
    t = torch.from_numpy
    mesh = dataclasses.replace(
        mesh,
        fEdge=t(2.0 * omega * np.sin(np.asarray(mesh.latEdge))),
        fVertex=t(2.0 * omega * np.sin(np.asarray(mesh.latVertex))),
        fCell=t(2.0 * omega * np.sin(np.asarray(mesh.latCell))))

    # ---- coefficient fields ----------------------------------------------
    bmats = build_cell_fit_matrices(mesh)
    deriv_two = build_deriv_two(mesh, bmats)
    d2_bmat, d2w = build_adv_factored(mesh, bmats)
    d2w_own, d2w_opp, s_cp, dv_cell = build_adv_cell_tensors(mesh)
    defc_a, defc_b = build_deformation_weights(mesh)
    recon_zonal, recon_merid = build_reconstruct_weights(mesh)
    zb_cell, zb3_cell = build_zb(mesh, vg, zgrid, deriv_two,
                                 cfg.config_theta_adv_order,
                                 cfg.config_coef_3rd_order)
    dss = build_dss(mesh, zgrid, cfg.config_zd, cfg.config_xnutr)

    ru = 0.5 * (rho_zz[c1] + rho_zz[c2]) * u
    pressure_b = p0 * (zz * rgas * rtb / p0) ** (cp / cv)
    pressure_p = zz * rgas * (p * rt + rtb * (p - pb))

    def r(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))

    grid = AtmGrid(
        mesh=mesh, vert=vg,
        zgrid=r(zgrid), zz=r(zz), zxu=r(zxu), dss=r(dss),
        zb_cell=r(zb_cell), zb3_cell=r(zb3_cell),
        defc_a=r(defc_a), defc_b=r(defc_b),
        recon_zonal=r(recon_zonal), recon_merid=r(recon_merid),
        rho_base=r(rb), rtheta_base=r(rtb), exner_base=r(pb),
        pressure_base=r(pressure_b),
        d2_bmat=r(d2_bmat), d2w=r(d2w),
        adv_beta=float(cfg.config_coef_3rd_order),
        d2w_own=r(d2w_own), d2w_opp=r(d2w_opp), adv_sside=r(s_cp),
        dv_cell=r(dv_cell))

    n_scalars = max(getattr(cfg, "config_n_scalars", 1), 1)
    scalars = np.zeros((nC, nz1, n_scalars))
    scalars[..., 0] = qv
    state = AtmState(u=r(u), w=r(np.zeros((nC, nz))), theta_m=r(theta_m),
                     rho_zz=r(rho_zz), scalars=r(scalars))
    diag = AtmDiag(ru=r(ru), rw=r(np.zeros((nC, nz))), rho_p=r(rr),
                   rtheta_p=r(rt), exner=r(p),
                   pressure_p=r(pressure_p),
                   ruAvg=r(np.zeros_like(ru)),
                   wwAvg=r(np.zeros((nC, nz))))
    extras = {"skintemp": tsk, "psfc": psfc, "ter": ter}
    extras.update(init_soil_layers(met_fields, lat_c, lon_c, tsk))
    extras.update(init_sst_seaice(met_fields, lat_c, lon_c, tsk))
    if timings is not None:
        timings["vertical_interp_s"] = t_vi[0]
    return grid, state, diag, extras


# first-guess soil layer names and their (top_cm, bottom_cm) extents —
# GFS (0-10/10-40/40-100/100-200) and ECMWF (0-7/7-28/28-100/100-255)
# conventions, exactly the field list the reference accepts
# (ref: mpas_init_atm_cases.F:3409-3456)
_SOIL_LAYERS = {
    "000010": (0.0, 10.0), "010040": (10.0, 40.0),
    "040100": (40.0, 100.0), "100200": (100.0, 200.0),
    "010200": (10.0, 200.0),
    "000007": (0.0, 7.0), "007028": (7.0, 28.0),
    "028100": (28.0, 100.0), "100255": (100.0, 255.0),
    "100289": (100.0, 289.0),
}
# Noah layer extents (cm): 0-10, 10-40, 40-100, 100-200
NOAH_LAYERS = ((0.0, 10.0), (10.0, 40.0), (40.0, 100.0), (100.0, 200.0))


def init_soil_layers(met_fields, lat_deg, lon_deg, tsk):
    """Interpolate first-guess soil temperature/moisture layers onto the
    Noah 4-layer grid by depth-overlap weighting (ref: the
    ST*/SM* blocks of mpas_init_atm_cases.F:3409-3456 + the vertical
    soil blending of the physics init). Missing layers fall back to
    skin temperature / 0.2 volumetric moisture."""
    nC = lat_deg.shape[0]
    found_t, found_m = [], []
    for code, (za, zb) in _SOIL_LAYERS.items():
        st = _interp_surface(met_fields, f"ST{code}", lat_deg, lon_deg,
                             default=None)
        if st is not None:
            found_t.append((za, zb, st))
        sm = _interp_surface(met_fields, f"SM{code}", lat_deg, lon_deg,
                             default=None)
        if sm is not None:
            found_m.append((za, zb, sm))

    def blend(found, default):
        out = np.empty((nC, len(NOAH_LAYERS)))
        for k, (na, nb) in enumerate(NOAH_LAYERS):
            wsum = np.zeros(nC)
            acc = np.zeros(nC)
            for (za, zb, v) in found:
                ov = max(0.0, min(nb, zb) - max(na, za))
                if ov > 0:
                    acc += ov * v
                    wsum += ov
            out[:, k] = np.where(wsum > 0, acc / np.maximum(wsum, 1e-9),
                                 default)
        return out
    tslb = blend(found_t, np.asarray(tsk))
    smois = blend(found_m, 0.2)
    return {"tslb": tslb, "smois": np.clip(smois, 0.02, 0.48)}


def init_sst_seaice(met_fields, lat_deg, lon_deg, tsk):
    """SST and fractional sea ice (ref: mpas_init_atm_cases.F:4270-4330:
    SST falls back to SKINTEMP when absent; SEAICE clamped to [0,1] and
    thresholded into the xice mask)."""
    sst = _interp_surface(met_fields, "SST", lat_deg, lon_deg,
                          default=None)
    if sst is None:
        sst = np.asarray(tsk).copy()
    xice = _interp_surface(met_fields, "SEAICE", lat_deg, lon_deg,
                           default=0.0)
    xice = np.clip(xice, 0.0, 1.0)
    return {"sst": sst, "xice": xice,
            "seaice_mask": (xice >= 0.5).astype(np.float64)}


def build_sfc_update(mesh, met_fields):
    """Surface-update stream contents (init case 8: SST/seaice update
    files consumed by the model's surface stream during long runs;
    ref: init_atm_case_sfc, mpas_init_atm_cases.F:266-276). Returns the
    dict of (dims, variables) for framework.streams to write."""
    lat_c = np.degrees(np.asarray(mesh.latCell))
    lon_c = np.degrees(np.asarray(mesh.lonCell))
    tsk = _interp_surface(met_fields, "SKINTEMP", lat_c, lon_c,
                          default=288.0)
    out = init_sst_seaice(met_fields, lat_c, lon_c, tsk)
    dims = {"nCells": mesh.nCells, "Time": None}
    variables = {
        "sst": (("Time", "nCells"), out["sst"][None]),
        "xice": (("Time", "nCells"), out["xice"][None]),
    }
    return dims, variables
