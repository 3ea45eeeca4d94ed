"""Physics suite manager: suites, the physics state, driver ordering and
the coupling to the dynamics (port of
mpas_tpu/cores/atmosphere/physics/manager.py).

ref: src/core_atmosphere/physics/mpas_atmphys_manager.F (alarms and
intervals), mpas_atmphys_driver.F:106 (ordering: cloudiness -> radiation
LW/SW -> surface layer -> LSM -> PBL -> GWDO -> convection, all before the
dynamics; microphysics runs inside the RK3 step) and
mpas_atmphys_todynamics.F (cell wind tendencies -> edge normal-velocity
tendencies).

physics_step is one pass over (nCells, nz) columns. Radiation is computed
at every call and its tendencies kept where the alarm is not due, with a
device-side select on time_since_rad (a 0-d tensor): the step reads
nothing back from the device. Cell winds come from the RBF reconstruction;
wind tendencies return to the edges by projecting the two adjacent cells'
(du, dv) onto the edge normal.

Ported: the mesoscale_reference suite (WSM6 in the dycore, new Tiedtke,
YSU, GWDO, RRTMG-class k-distribution radiation, cldfra3, the MM5 surface
layer, Noah), the convection_permitting suite (Thompson in the dycore,
Grell-Freitas, the MYNN PBL and surface layer, with the same radiation,
cldfra3, GWDO and Noah), Kain-Fritsch, and the broadband radiation and
slab LSM branches, and CAM radiation (config_radiation_scheme="cam").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from mpas_tpu_torch.constants import cp, p0, rgas, rvord
from mpas_tpu_torch.containers import resolve_device, to_device
from mpas_tpu_torch.cores.atmosphere.physics import (cam_radiation,
                                                     cldfra3, convection,
                                                     gf, gwdo, lsm, mynn,
                                                     mynn_sfc, noah,
                                                     radiation, rrtmg,
                                                     sfclay, tiedtke, ysu)
from mpas_tpu_torch.ops import reconstruct as recon


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """ref: the config_*_scheme namelist options + suite defaults
    (Registry.xml:378-392, 'suites')."""
    config_physics_suite: str = "mesoscale_reference"
    config_radt_interval_s: float = 1800.0   # radiation alarm
    config_conv_interval_s: float = 0.0      # 0 = every step
    config_microp_scheme: str = "wsm6"       # used by the dycore coupling
    config_pbl_scheme: str = "ysu"           # "ysu" | "mynn"
    config_conv_scheme: str = "kf"           # "kf" | "tiedtke" | "grell_freitas"
    config_lsm_scheme: str = "slab"          # "slab" | "noah"
    # "broadband" (gray) | "kdist" (RRTMG-class correlated-k) | "cam"
    config_radiation_scheme: str = "broadband"
    config_gwdo_scheme: str = "off"
    config_cldfra_scheme: str = "off"        # "off" | "cldfra3"
    config_sfclay_scheme: str = "mm5"        # "mm5" | "mynn"
    roughness_m: float = 0.1
    albedo: float = 0.2
    gwdo_var2d: float = 100.0


# suite -> per-scheme defaults for fields left at the 'suite' sentinel
# (ref: mpas_atmphys_control.F:120-160 — mesoscale_reference resolves to
# wsm6/ntiedtke/ysu/ysu_gwdo/rrtmg/cld_fraction/monin_obukhov/noah;
# convection_permitting to thompson/grell_freitas/mynn/.../sf_mynn/noah)
_SUITES = {
    "mesoscale_reference": dict(
        config_microp_scheme="wsm6", config_conv_scheme="tiedtke",
        config_pbl_scheme="ysu", config_gwdo_scheme="on",
        config_radiation_scheme="kdist", config_cldfra_scheme="cldfra3",
        config_sfclay_scheme="mm5", config_lsm_scheme="noah"),
    "convection_permitting": dict(
        config_microp_scheme="thompson",
        config_conv_scheme="grell_freitas",
        config_pbl_scheme="mynn", config_gwdo_scheme="on",
        config_radiation_scheme="kdist", config_cldfra_scheme="cldfra3",
        config_sfclay_scheme="mynn", config_lsm_scheme="noah"),
    "none": dict(
        config_microp_scheme="off", config_conv_scheme="off",
        config_pbl_scheme="off", config_gwdo_scheme="off",
        config_radiation_scheme="off", config_cldfra_scheme="off",
        config_sfclay_scheme="off", config_lsm_scheme="off"),
}
# the scheme fields every suite sets: PhysicsConfig(config_physics_suite=s,
# **{k: "suite" for k in SCHEME_FIELDS}) leaves all of them to suite s
SCHEME_FIELDS = tuple(_SUITES["mesoscale_reference"])


def resolve_suite(cfg: PhysicsConfig) -> PhysicsConfig:
    """Resolve 'suite'-sentinel scheme choices from config_physics_suite
    (ref: mpas_atmphys_control.F physics_namelist_check — explicit
    per-scheme settings win over the suite default; an unknown suite is
    fatal)."""
    suite = cfg.config_physics_suite
    if suite not in _SUITES:
        raise ValueError(
            f"Unrecognized choice of physics suite: "
            f"config_physics_suite = '{suite}'")
    updates = {k: v for k, v in _SUITES[suite].items()
               if getattr(cfg, k) == "suite"}
    return dataclasses.replace(cfg, **updates) if updates else cfg


@dataclasses.dataclass(frozen=True)
class PhysicsState:
    """Per-cell surface/physics state carried between steps
    (ref: diag_physics + sfc_input pools)."""
    tsk: Any          # (nCells,) skin temperature K
    t_deep: Any       # (nCells,) deep reservoir temperature
    rainc: Any        # (nCells,) accumulated convective precip (m)
    hpbl: Any         # (nCells,)
    glw: Any          # (nCells,) last LW down at surface
    gsw: Any          # (nCells,) last SW absorbed at surface
    rad_tend: Any     # (nCells, nz) cached radiative dT/dt (K/s)
    time_since_rad: Any   # 0-d tensor: seconds since the last radiation
    # Noah LSM soil column (None in slab mode; ref sfc_input TSLB/SMOIS)
    tslb: Any = None      # (nCells, 4) soil temperature
    smois: Any = None     # (nCells, 4) volumetric soil moisture
    swe: Any = None       # (nCells,) snow water equivalent (m)
    # MYNN prognostic TKE (None in YSU mode; ref qke diag_physics field)
    qke: Any = None       # (nCells, nz)
    # surface-type masks (ref sfc_input XICE/landuse ISICE/glacier):
    # fractional sea ice and permanent-ice (glacial) flags; None = open
    # land everywhere
    xice: Any = None      # (nCells,) sea-ice fraction [0, 1]
    isice: Any = None     # (nCells,) 1.0 on glacial landuse

    def to(self, device, dtype) -> "PhysicsState":
        return to_device(self, device, dtype)


def init_physics_state(n_cells, nz, tsk0=288.0, dtype=torch.float64,
                       lsm_scheme="slab", pbl_scheme="ysu", device=None):
    """The physics state at rest, on `device` (None: cuda:0, and an error
    where there is no CUDA device; pass device="cpu" for the CPU)."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    z = torch.zeros(n_cells, **kw)
    st = PhysicsState(
        tsk=z + tsk0, t_deep=z + tsk0, rainc=z, hpbl=z + 100.0,
        glw=z, gsw=z, rad_tend=torch.zeros((n_cells, nz), **kw),
        time_since_rad=torch.tensor(1.0e30, **kw))
    if lsm_scheme == "noah":
        st = dataclasses.replace(
            st, tslb=torch.full((n_cells, 4), tsk0, **kw),
            smois=torch.full((n_cells, 4), 0.25, **kw), swe=z)
    if pbl_scheme == "mynn":
        st = dataclasses.replace(st, qke=torch.full((n_cells, nz), 1.0e-4,
                                                    **kw))
    return st


def _edge_wind_tendency(mesh, du_cell, dv_cell):
    """Map cell (du, dv) to edge normal-velocity increments.
    ref: mpas_atmphys_todynamics.F (tend_u from u/v tendencies)."""
    coe = mesh.cellsOnEdge
    du_e = 0.5 * (du_cell[coe[:, 0]] + du_cell[coe[:, 1]])
    dv_e = 0.5 * (dv_cell[coe[:, 0]] + dv_cell[coe[:, 1]])
    ne = torch.cos(mesh.angleEdge)[:, None]
    nn = torch.sin(mesh.angleEdge)[:, None]
    return du_e * ne + dv_e * nn


def physics_step(grid, cfg: PhysicsConfig, mesh, recon_coeffs,
                 state, diag, phys: PhysicsState, dt,
                 gmt_hours=12.0, julian_day=172.0, gwd_statics=None):
    """Run the suite once before the dynamics; returns the new dycore
    fields (theta_m, scalars, u) and the new PhysicsState. recon_coeffs:
    build_reconstruct_coeffs(mesh) as a tensor on the state's device.

    Ordering ref: physics_driver (mpas_atmphys_driver.F:208-330)."""
    cfg = resolve_suite(cfg)
    m = mesh
    nsc = state.scalars.shape[-1]
    qv = torch.clamp(state.scalars[..., 0], min=0.0)
    qc = torch.clamp(state.scalars[..., 1], min=0.0) if nsc > 1 \
        else torch.zeros_like(qv)
    th = state.theta_m / (1.0 + rvord * qv)
    exner = diag.exner
    t = th * exner
    rho = grid.zz * state.rho_zz
    p = p0 * exner ** (cp / rgas)
    dz = grid.zgrid[:, 1:] - grid.zgrid[:, :-1]
    z_mid = 0.5 * (grid.zgrid[:, 1:] + grid.zgrid[:, :-1]) \
        - grid.zgrid[:, :1]
    # the cell's equivalent diameter, the grid spacing the schemes see
    dx_cell = 2.0 * torch.sqrt(m.areaCell / math.pi)

    # cell-centred winds (ref: uReconstruct{Zonal,Meridional})
    _vx, _vy, _vz, u_c, v_c = recon.reconstruct(m, recon_coeffs, state.u)

    # --- cloudiness before radiation (ref: driver_cloudiness ->
    # module_mp_thompson_cldfra3.F cal_cldfra3): the RH-based fraction
    # seeds radiation-visible condensate in partly-cloudy decks
    if cfg.config_cldfra_scheme == "cldfra3":
        qi_s = torch.clamp(state.scalars[..., 3], min=0.0) if nsc > 3 \
            else torch.zeros_like(qv)
        qs_s = torch.clamp(state.scalars[..., 4], min=0.0) if nsc > 4 \
            else torch.zeros_like(qv)
        xland = torch.ones_like(phys.tsk)
        _cldfra, qc_rad, qi_rad = cldfra3.cal_cldfra3(
            qv, qc, qi_s, qs_s, p, t, rho, dz, xland, dx_cell * 1e-3)
        qc = qc_rad + qi_rad      # radiation sees the seeded condensate

    # --- radiation on its alarm (held constant in between) ---
    lat = m.latCell if m.on_sphere else torch.zeros_like(m.xCell)
    lon = m.lonCell if m.on_sphere else torch.zeros_like(m.xCell)
    mu = radiation.cos_zenith(lat, lon, gmt_hours, julian_day)
    due = phys.time_since_rad >= cfg.config_radt_interval_s

    if cfg.config_radiation_scheme == "kdist":
        lw_tend, glw, _olr = rrtmg.rrtmg_lw(t, qv, qc, rho, dz, phys.tsk)
        sw_tend, gsw = rrtmg.rrtmg_sw(qv, qc, rho, dz, mu, cfg.albedo)
    elif cfg.config_radiation_scheme == "cam":
        lw_tend, glw, _olr = cam_radiation.cam_lw(t, qv, qc, rho, dz,
                                                  phys.tsk)
        sw_tend, gsw = cam_radiation.cam_sw(qv, qc, rho, dz, mu, cfg.albedo,
                                            t=t)
    else:
        lw_tend, glw, _olr = radiation.radiation_lw(t, qv, qc, rho, dz,
                                                    phys.tsk)
        sw_tend, gsw = radiation.radiation_sw(qv, qc, rho, dz, mu,
                                              cfg.albedo)
    rad_tend = torch.where(due, lw_tend + sw_tend, phys.rad_tend)
    glw = torch.where(due, glw, phys.glw)
    gsw = torch.where(due, gsw, phys.gsw)
    t_rad = t + dt * rad_tend

    # --- surface layer (ref: driver_sfclayer) ---
    if cfg.config_lsm_scheme == "noah":
        root = (phys.smois[:, 0] * 0.1 + phys.smois[:, 1] * 0.3
                + phys.smois[:, 2] * 0.6)
        beta0 = torch.clamp((root - noah.SMCWLT)
                            / (noah.SMCREF - noah.SMCWLT), 0.0, 1.0)
        qsfc = noah.noah_surface_moisture(phys.tsk, p[:, 0], beta0)
    else:
        qsfc = lsm.surface_moisture(phys.tsk, p[:, 0])
    if cfg.config_sfclay_scheme == "mynn":
        sfc = mynn_sfc.mynn_sfclay(
            u_c[:, 0], v_c[:, 0], t_rad[:, 0] / exner[:, 0], qv[:, 0],
            p[:, 0], rho[:, 0], z_mid[:, 0], phys.tsk, qsfc,
            z0_land=cfg.roughness_m)
    else:
        sfc = sfclay.sfclay(u_c[:, 0], v_c[:, 0], t_rad[:, 0] / exner[:, 0],
                            qv[:, 0], p[:, 0], rho[:, 0], z_mid[:, 0],
                            phys.tsk, qsfc, cfg.roughness_m)

    # --- LSM: advance the skin temperature (ref: driver_lsm; the
    # seaice/glacial variants dispatch per point as
    # module_sf_noah_seaice_drv.F / the glacial branch of
    # module_sf_noahdrv.F select on XICE and the ISICE landuse) ---
    if cfg.config_lsm_scheme == "noah":
        out = noah.noah_lsm(phys.tsk, phys.tslb, phys.smois, phys.swe,
                            gsw, glw, sfc["hfx"], sfc["lh"],
                            torch.zeros_like(phys.tsk), dt)
        tsk_new, tslb_new, swe_new = out["tsk"], out["tslb"], out["swe"]
        if phys.isice is not None:
            gl = noah.noah_glacial(phys.tsk, phys.tslb, phys.swe,
                                   gsw, glw, sfc["hfx"], sfc["lh"], dt)
            glacial = phys.isice > 0.5
            tsk_new = torch.where(glacial, gl["tsk"], tsk_new)
            tslb_new = torch.where(glacial[:, None], gl["tslb"], tslb_new)
            swe_new = torch.where(glacial, gl["swe"], swe_new)
        if phys.xice is not None:
            si = noah.noah_seaice(phys.tsk, phys.tslb, phys.swe,
                                  gsw, glw, sfc["hfx"], sfc["lh"], dt)
            # fractional blend on the ice fraction (ref: the XICE
            # fractional treatment of module_sf_noah_seaice_drv.F)
            xi = torch.clamp(phys.xice, 0.0, 1.0)
            tsk_new = xi * si["tsk"] + (1.0 - xi) * tsk_new
            tslb_new = xi[:, None] * si["tslb"] \
                + (1.0 - xi[:, None]) * tslb_new
            swe_new = xi * si["swe"] + (1.0 - xi) * swe_new
        phys = dataclasses.replace(phys, tslb=tslb_new, smois=out["smois"],
                                   swe=swe_new)
    else:
        tsk_new, _g = lsm.slab_lsm(phys.tsk, phys.t_deep, gsw, glw,
                                   sfc["hfx"], sfc["lh"], dt)

    # --- PBL (ref: driver_pbl) ---
    th_in = t_rad / exner
    if cfg.config_pbl_scheme == "mynn":
        u_pbl, v_pbl, th_pbl, qv_pbl, hpbl, qke_new = mynn.mynn(
            u_c, v_c, th_in, qv, rho, z_mid, dz, sfc, phys.qke, dt)
        phys = dataclasses.replace(phys, qke=qke_new)
    else:
        u_pbl, v_pbl, th_pbl, qv_pbl, hpbl = ysu.ysu(
            u_c, v_c, th_in, qv, rho, z_mid, dz, sfc, dt)

    # --- GWDO (ref: driver_gwdo -> module_bl_gwdo.F gwdo2d) ---
    if cfg.config_gwdo_scheme == "on":
        if gwd_statics is not None:
            var2d = gwd_statics["var2d"]
            oc1 = gwd_statics["con"]
            oa4 = torch.stack([gwd_statics[f"oa{i}"] for i in (1, 2, 3, 4)],
                              dim=1)
            ol4 = torch.stack([gwd_statics[f"ol{i}"] for i in (1, 2, 3, 4)],
                              dim=1)
        else:
            # uniform-statistics fallback (isotropic hills of height
            # sigma = cfg.gwdo_var2d, convexity 1)
            ones = torch.ones_like(phys.tsk)
            var2d = cfg.gwdo_var2d * ones
            oc1 = ones
            oa4 = torch.zeros_like(ones)[:, None].expand(-1, 4)
            ol4 = torch.full_like(ones, 0.5)[:, None].expand(-1, 4)
        dudt, dvdt, _dusfc, _dvsfc = gwdo.gwdo(
            u_pbl, v_pbl, t_rad, qv_pbl, p, z_mid, dz,
            var2d, oc1, oa4, ol4, dx_cell, dt)
        u_pbl = u_pbl + dt * dudt
        v_pbl = v_pbl + dt * dvdt

    # --- convection (ref: driver_convection; every scheme other than
    # tiedtke and grell_freitas runs Kain-Fritsch, as the reference's) ---
    qc_detr = None
    if cfg.config_conv_scheme == "tiedtke":
        th_cu, qv_cu, rain_c, _cape = tiedtke.tiedtke(
            th_pbl, qv_pbl, p, rho, z_mid, dz, exner, dt)
    elif cfg.config_conv_scheme == "grell_freitas":
        th_cu, qv_cu, qc_detr, rain_c, _cape = gf.gf_convection(
            th_pbl, qv_pbl, p, rho, z_mid, dz, exner, dt, dx=dx_cell)
    else:
        # grid-scale w at layer midpoints feeds the KF trigger (ref:
        # W0AVG, module_cu_kfeta.F:740-760); dx sets the 25-km-equivalent
        # w scaling and the advective timescale
        w_mid = 0.5 * (state.w[:, 1:] + state.w[:, :-1])
        kf = convection.kf_convection_full(
            th_pbl, qv_pbl, p, rho, z_mid, dz, exner, dt,
            w0avg=w_mid, u=u_c, v=v_c, dx=dx_cell)
        th_cu, qv_cu, rain_c = kf["th"], kf["qv"], kf["raincv_m"]
        qc_detr = kf["qc_detr"]

    # --- couple back to the dycore variables ---
    theta_m_new = th_cu * (1.0 + rvord * qv_cu)
    rest = state.scalars[..., 1:]
    if qc_detr is not None and nsc > 1:
        # detrained non-precipitated condensate goes to the cloud water
        rest = torch.cat([(rest[..., 0] + qc_detr)[..., None],
                          rest[..., 1:]], dim=-1)
    scalars_new = torch.cat([qv_cu[..., None], rest], dim=-1)
    du_e = _edge_wind_tendency(m, u_pbl - u_c, v_pbl - v_c)
    u_new = (state.u + du_e) * (1.0 - m.boundaryEdge)[:, None]

    tsr = phys.time_since_rad
    phys_new = dataclasses.replace(
        phys, tsk=tsk_new, rainc=phys.rainc + rain_c, hpbl=hpbl,
        glw=glw, gsw=gsw, rad_tend=rad_tend,
        time_since_rad=torch.where(due, torch.full_like(tsr, dt), tsr + dt))
    return theta_m_new, scalars_new, u_new, phys_new
