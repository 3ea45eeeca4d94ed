"""The land-ice core of the PyTorch port, module by module, against the JAX
package.

Two seeded setups, each built in both packages from the same numpy
arrays, in float64 on the CPU: the small Halfar dome of the reference's
tests (box_hex_mesh(20, 20, 3 km), h0 500 m, r0 25 km, 5 levels) with
seeded temperatures on both sides of PB1982's 263.15 K switch, and a
marine strip (box_hex_mesh(16, 12, 2 km): grounded ice, a floating shelf,
open ocean; the bed and thickness seeded around the reference test's
tests/test_landice_calving.py). Every ported function is held to its JAX
twin at 1e-11 x max|ref|. The FO solve is held at 2 Picard x 5 CG
(FO_COUNTS): at more iterations its CG, which does not converge on this
dome, amplifies the rounding difference of two summation orders (on the
seeded PB1982 flow factor, 1.2e-10 x max at 2 x 10;
test_fo_solve_rounding_amplification measures the amplification in the
reference alone). The external solver is built from tools/velocity_solver's
source into build/ and held to the reference's wrapper on the 14 x 14
box, and to the committed tests/golden/landice_external_box14.npz (the
library's output on a CPU build host, which chip_smoke.py compares the
card host's build with), written by

    python -m tests.test_torch_landice
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.landice import advection_ir as jir
from mpas_tpu.cores.landice import calving as jcalv
from mpas_tpu.cores.landice import config as jconf
from mpas_tpu.cores.landice import core as jcore
from mpas_tpu.cores.landice import fo_stokes as jfo
from mpas_tpu.cores.landice import hydro as jhydro
from mpas_tpu.cores.landice import init_dome as jinit
from mpas_tpu.cores.landice import statistics as jstats
from mpas_tpu.cores.landice import thermal_enthalpy as jte
from mpas_tpu.mesh.planar import box_hex_mesh as j_box_hex_mesh
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.landice import advection_ir as tir
from mpas_tpu_torch.cores.landice import calving as tcalv
from mpas_tpu_torch.cores.landice import config as tconf
from mpas_tpu_torch.cores.landice import core as tcore
from mpas_tpu_torch.cores.landice import external as text
from mpas_tpu_torch.cores.landice import fo_stokes as tfo
from mpas_tpu_torch.cores.landice import hydro as thydro
from mpas_tpu_torch.cores.landice import init_dome as tinit
from mpas_tpu_torch.cores.landice import statistics as tstats
from mpas_tpu_torch.cores.landice import thermal_enthalpy as tte
from tests.test_torch_ocean import assert_close, flatten

torch.set_num_threads(1)

REL = 1e-11
EXTERNAL_GOLDEN = Path(__file__).resolve().parent / "golden" \
    / "landice_external_box14.npz"
YR = jconf.SECONDS_PER_YEAR
H0, R0, NZ = 500.0, 25000.0, 5
FO_COUNTS = dict(picard_iters=2, cg_iters=5)


def cfgs(**kw):
    """The same configuration in both packages."""
    return jconf.LiConfig(**kw), tconf.LiConfig(**kw)


def j(a):
    return jnp.asarray(a)


def t(a):
    return torch.from_numpy(np.array(a))


def close_dict(got, ref, rel=REL):
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k], ref[k], k, rel)


class Dome:
    """The seeded dome in both packages (`j*` reference, `t*` port, `a`
    the numpy arrays)."""

    def __init__(self):
        self.jmesh = j_box_hex_mesh(20, 20, 3000.0)
        self.tmesh = convert.mesh_from_arrays(flatten(self.jmesh))
        self.jcfg, self.tcfg = cfgs(config_nvertlevels=NZ)
        self.jgrid, self.jstate, self.t0 = jinit.init_halfar(
            self.jmesh, self.jcfg, h0=H0, r0=R0)
        self.tgrid, self.tstate, _ = tinit.init_halfar(
            self.tmesh, self.tcfg, h0=H0, r0=R0, device="cpu")
        rng = np.random.default_rng(14)
        nC = self.jmesh.nCells
        h = np.asarray(self.jstate.thickness)
        self.a = dict(
            h=h,
            temp=np.where(h[:, None] > 1.0,
                          rng.uniform(245.0, 272.0, (nC, NZ)), 268.15),
            water=rng.uniform(0.0, 0.004, (nC, NZ)),
            u_edge=rng.normal(0.0, 3e-6, self.jmesh.nEdges),
            melt=np.where(h > 1.0, rng.uniform(1e-10, 5e-9, nC), 0.0),
            speed=np.where(h > 1.0, rng.uniform(0.0, 2e-6, nC), 0.0),
            fric=rng.uniform(0.0, 0.05, nC),
            t_ocn=rng.uniform(271.0, 275.0, nC))


@pytest.fixture(scope="module")
def dome():
    return Dome()


@pytest.fixture(scope="module")
def shelf():
    """A marine strip: grounded on the left, a floating shelf in the
    middle, open ocean on the right, seeded bumps on bed and ice."""
    jm = j_box_hex_mesh(16, 12, 2000.0)
    tm = convert.mesh_from_arrays(flatten(jm))
    rng = np.random.default_rng(7)
    x = np.asarray(jm.xCell)
    xn = (x - x.min()) / (x.max() - x.min())
    bed = np.where(xn < 0.3, -50.0, -800.0) + rng.uniform(-20, 20, x.size)
    h = np.where(xn < 0.3, 900.0, np.where(xn < 0.7, 400.0, 0.0))
    h = np.where(h > 0, h + rng.uniform(-30, 30, x.size), 0.0)
    h[(xn > 0.6) & (xn < 0.7)] *= 0.02          # thin floating front ice
    jcfg, tcfg = cfgs(config_nvertlevels=4, config_calving_thickness=50.0,
                      config_calving_eigencalving_k=1e19)
    jg = jcore.make_grid(jm, jcfg, bed=j(bed))
    tg = tcore.make_grid(tm, tcfg, bed=bed)
    # a diverging flow over the shelf: stretching in x and y
    xe = np.asarray(jm.xEdge) - x.min()
    ye = np.asarray(jm.yEdge) - np.asarray(jm.yCell).mean()
    ang = np.asarray(jm.angleEdge)
    ux, uy = 3e-10 * xe, 2e-10 * ye
    u_edge = ux * np.cos(ang) + uy * np.sin(ang)
    u_edge = u_edge + rng.normal(0.0, 1e-7, u_edge.size)
    return dict(jmesh=jm, tmesh=tm, jcfg=jcfg, tcfg=tcfg, jgrid=jg,
                tgrid=tg, h=h, bed=bed, xn=xn, u_edge=u_edge)


# ---------------------------------------------------------------- config

def test_config_matches_the_reference():
    assert dataclasses.asdict(tconf.LiConfig()) \
        == dataclasses.asdict(jconf.LiConfig())
    assert tconf.SECONDS_PER_YEAR == jconf.SECONDS_PER_YEAR
    assert tfo.N_GLEN == jfo.N_GLEN and tfo.EPS_REG == jfo.EPS_REG


# ------------------------------------------------------------------ core

def test_init_halfar_bit_for_bit(dome):
    assert np.array_equal(dome.tstate.thickness.numpy(),
                          np.asarray(dome.jstate.thickness))
    assert dome.tstate.thickness.dtype == torch.float64
    assert_close(dome.tgrid.layerInterfaceSigma,
                 dome.jgrid.layerInterfaceSigma, "sigma", 1e-15)
    assert_close(dome.tgrid.layerSigmaFraction,
                 dome.jgrid.layerSigmaFraction, "frac", 0.0)
    assert tinit.halfar_t0(dome.tcfg, H0, R0) == dome.t0
    r = np.linspace(0.0, 30000.0, 17)
    assert np.array_equal(
        tinit.halfar_thickness(dome.tcfg, r, 3.0 * dome.t0, H0, R0),
        jinit.halfar_thickness(dome.jcfg, r, 3.0 * dome.t0, H0, R0))


def test_zero_state_and_total_volume(dome):
    zs = tcore.zero_state(dome.tmesh, dome.tcfg, device="cpu")
    assert_close(zs, jcore.zero_state(dome.jmesh, dome.jcfg), "zero", 0.0)
    assert_close(tcore.total_volume(dome.tgrid, dome.tstate),
                 jcore.total_volume(dome.jgrid, dome.jstate), "vol", REL)


def test_convert_landice_containers(dome):
    jcfg, _ = cfgs(config_nvertlevels=NZ, config_velocity_solver="FO")
    jg = jcore.make_grid(dome.jmesh, jcfg, bed=j(dome.a["h"] * 0.01))
    d = flatten(jg.replace(fo_geom=None))
    d["fo_geom"] = jg.fo_geom._asdict()
    tg = convert.landice_grid_from_arrays(d)
    assert_close(tg.bedTopography, jg.bedTopography, "bed", 0.0)
    for k, v in jg.fo_geom._asdict().items():
        assert np.array_equal(getattr(tg.fo_geom, k).numpy(),
                              np.asarray(v, dtype=np.float64)
                              if k == "nbr_mask" else np.asarray(v)), k
    js = jcore.run_steps(dome.jgrid, jconf.LiConfig(
        config_nvertlevels=NZ, config_thermal_solver="enthalpy"),
        dome.jstate, 1)
    ts = convert.landice_state_from_arrays(flatten(js))
    assert_close(ts, js, "state", 0.0)
    jh = jhydro.zero_hydro(dome.jmesh.nCells, n_edges=dome.jmesh.nEdges)
    assert_close(convert.hydro_state_from_arrays(flatten(jh)), jh, "hydro",
                 0.0)


@pytest.mark.parametrize("calc", ["constant", "PB1982"])
def test_flow_param_a(dome, calc):
    jc, tc = cfgs(config_flowParamA_calculation=calc)
    got = tcore.flow_param_a(tc, t(dome.a["temp"]))
    assert got.dtype == torch.float64
    assert_close(got, jcore.flow_param_a(jc, j(dome.a["temp"])), calc, REL)


def test_sia_velocity(dome):
    for calc in ("constant", "PB1982"):
        jc, tc = cfgs(config_nvertlevels=NZ,
                      config_flowParamA_calculation=calc)
        assert_close(
            tcore.sia_velocity(dome.tgrid, tc, t(dome.a["h"]),
                               t(dome.a["temp"])),
            jcore.sia_velocity(dome.jgrid, jc, j(dome.a["h"]),
                               j(dome.a["temp"])), calc, REL)


@pytest.mark.parametrize("scheme", ["fo", "centered"])
def test_advect_thickness_fo(dome, scheme):
    u_int = jcore.sia_velocity(dome.jgrid, dome.jcfg, j(dome.a["h"]),
                               j(dome.a["temp"])) * 1e3
    assert_close(
        tcore.advect_thickness_fo(dome.tgrid, dome.tcfg, t(dome.a["h"]),
                                  t(u_int), 0.25 * YR, scheme),
        jcore.advect_thickness_fo(dome.jgrid, dome.jcfg, j(dome.a["h"]),
                                  u_int, 0.25 * YR, scheme), scheme, REL)


def test_thermal_solve(dome):
    assert_close(
        tcore.thermal_solve(dome.tgrid, dome.tcfg, t(dome.a["h"]),
                            t(dome.a["temp"]), 10.0 * YR),
        jcore.thermal_solve(dome.jgrid, dome.jcfg, j(dome.a["h"]),
                            j(dome.a["temp"]), 10.0 * YR), "T", REL)


@pytest.mark.parametrize("option", ["none", "floating", "thickness_threshold",
                                    "topographic_threshold",
                                    "eigencalving"])
def test_calve(shelf, option):
    jc, tc = cfgs(config_nvertlevels=4, config_calving=option,
                  config_calving_thickness=50.0,
                  config_calving_topography=-700.0,
                  config_calving_eigencalving_k=1e19)
    cf = np.linspace(0.0, 1.0, shelf["h"].size)
    u_int = np.repeat(shelf["u_edge"][:, None], 5, axis=1)
    got = tcore.calve(shelf["tgrid"], tc, t(shelf["h"]), t(cf), t(u_int),
                      YR)
    ref = jcore.calve(shelf["jgrid"], jc, j(shelf["h"]), j(cf), j(u_int),
                      YR)
    assert_close(got, ref, option, REL)


# ------------------------------------------------------------- FO Stokes

def test_build_fo_geom(dome):
    got = tfo.build_fo_geom(dome.tmesh)
    ref = jfo.build_fo_geom(dome.jmesh)
    for k in ("gradx_w", "grady_w", "area"):
        assert_close(getattr(got, k), getattr(ref, k), k, 0.0)
    assert np.array_equal(got.nbr.numpy(), np.asarray(ref.nbr))
    assert np.array_equal(got.nbr_mask.numpy() > 0, np.asarray(ref.nbr_mask))


def test_box_boundary_cells_take_cell_0_as_a_neighbour(dome):
    """A fault of the reference (ROADMAP §3), kept by the port: a box
    mesh gives a boundary cell's missing neighbours as cell 0 with a
    valid edge (edgesOnCellMask 1), so build_fo_geom's least-squares
    gradient of every boundary cell takes the far corner cell 0 as a
    neighbour with a nonzero weight."""
    ref = jfo.build_fo_geom(dome.jmesh)
    got = tfo.build_fo_geom(dome.tmesh)
    bnd = np.nonzero(np.asarray(dome.jmesh.boundaryCell) > 0)[0]
    c = int(bnd[bnd > 0][0])
    nbr = np.asarray(ref.nbr)[c]
    assert (nbr == 0).any() and c not in (0,)
    far = nbr == 0
    assert np.abs(np.asarray(ref.gradx_w)[c, 1:][far]).max() > 0.0
    assert np.array_equal(got.nbr[c].numpy(), nbr)


def fo_inputs(dome, seed=3):
    rng = np.random.default_rng(seed)
    nC = dome.jmesh.nCells
    h = dome.a["h"]
    return dict(u=rng.normal(0.0, 1e-6, (nC, NZ)),
                v=rng.normal(0.0, 1e-6, (nC, NZ)),
                nu=rng.uniform(1e13, 1e14, (nC, NZ)),
                dz=np.repeat((np.maximum(h, 1.0) / NZ)[:, None], NZ, 1),
                a=rng.uniform(1e-25, 1e-23, (nC, NZ)),
                f=rng.normal(0.0, 1.0, (nC, NZ)))


def test_fo_operators(dome):
    jg, tg = jfo.build_fo_geom(dome.jmesh), tfo.build_fo_geom(dome.tmesh)
    x = fo_inputs(dome)
    assert_close(tfo._hgrad(tg, t(x["f"])), jfo._hgrad(jg, j(x["f"])),
                 "hgrad", REL)
    assert_close(tfo._hdiv(tg, t(x["f"]), t(x["u"])),
                 jfo._hdiv(jg, j(x["f"]), j(x["u"])), "hdiv", REL)
    assert_close(tfo._dz_center(t(x["f"]), t(x["dz"])),
                 jfo._dz_center(j(x["f"]), j(x["dz"])), "dz", REL)
    assert_close(tfo._vert_visc_apply(t(x["f"]), t(x["nu"]), t(x["dz"]),
                                      1e12),
                 jfo._vert_visc_apply(j(x["f"]), j(x["nu"]), j(x["dz"]),
                                      1e12), "vvisc", REL)
    assert_close(tfo.effective_viscosity(tg, t(x["u"]), t(x["v"]),
                                         t(x["dz"]), t(x["a"])),
                 jfo.effective_viscosity(jg, j(x["u"]), j(x["v"]),
                                         j(x["dz"]), j(x["a"])), "nu", REL)
    assert_close(tfo.fo_operator(tg, t(x["nu"]), t(x["dz"]), 1e12,
                                 t(x["u"]), t(x["v"])),
                 jfo.fo_operator(jg, j(x["nu"]), j(x["dz"]), 1e12,
                                 j(x["u"]), j(x["v"])), "op", REL)


def test_solve_fo_stokes(dome):
    jg, tg = jfo.build_fo_geom(dome.jmesh), tfo.build_fo_geom(dome.tmesh)
    h = dome.a["h"]
    args = (3.17e-24, 1e12, 910.0 * 9.81)
    got = tfo.solve_fo_stokes(tg, t(h), t(h), *args, nz=NZ, **FO_COUNTS)
    ref = jfo.solve_fo_stokes(jg, j(h), j(h), *args, nz=NZ, **FO_COUNTS)
    assert_close(got, ref, "fo", REL)
    # a prescribed slope (the ISMIP-HOM genre) and a per-level A
    x = fo_inputs(dome)
    got = tfo.solve_fo_stokes(tg, t(h), t(h * 0), t(x["a"]), 5e9, args[2],
                              nz=NZ, slope=(-0.01, 0.002), **FO_COUNTS)
    ref = jfo.solve_fo_stokes(jg, j(h), j(h * 0), j(x["a"]), 5e9, args[2],
                              nz=NZ, slope=(j(-0.01), j(0.002)),
                              **FO_COUNTS)
    assert_close(got, ref, "fo slope", REL)


def test_fo_velocity_and_residuals(dome):
    jc, tc = cfgs(config_nvertlevels=NZ, config_velocity_solver="FO",
                  config_fo_picard_iters=FO_COUNTS["picard_iters"],
                  config_fo_cg_iters=FO_COUNTS["cg_iters"],
                  config_flowParamA_calculation="PB1982")
    jg = jcore.make_grid(dome.jmesh, jc)
    tg = tcore.make_grid(dome.tmesh, tc)
    resid = []
    got = tcore.fo_velocity(tg, tc, t(dome.a["h"]), t(dome.a["temp"]),
                            resid_out=resid)
    ref = jcore.fo_velocity(jg, jc, j(dome.a["h"]), j(dome.a["temp"]))
    assert_close(got, ref, "fo_velocity", REL)
    assert len(resid) == FO_COUNTS["picard_iters"]
    assert all(r.dim() == 0 for r in resid)


def test_fo_solve_rounding_amplification(dome):
    """A fault of the reference (ROADMAP §3): on this dome the CG does not
    converge at the default 10 Picard x 120 CG (its residual stays above
    the right-hand side's norm), and a rounding-level change of the input
    (one ulp of one cell's thickness) moves the reference's own solution
    by more than 1e-9 x max|u| (2.8e-8 measured), over 100 times what it
    moves it at FO_COUNTS, where it stays below 1e-11 x max. The port's FO
    tests therefore hold the solve at FO_COUNTS."""
    jg = jfo.build_fo_geom(dome.jmesh)
    h = dome.a["h"]
    h2 = h.copy()
    c = int(np.argmax(h))
    h2[c] = np.nextafter(h2[c], np.inf)
    args = (3.17e-24, 1e12, 910.0 * 9.81)
    dep = {}
    for p, k in ((FO_COUNTS["picard_iters"], FO_COUNTS["cg_iters"]),
                 (10, 120)):
        a = jfo.solve_fo_stokes(jg, j(h), j(h), *args, nz=NZ,
                                picard_iters=p, cg_iters=k)
        b = jfo.solve_fo_stokes(jg, j(h2), j(h2), *args, nz=NZ,
                                picard_iters=p, cg_iters=k)
        dep[k] = float(np.abs(np.asarray(a[0]) - np.asarray(b[0])).max()
                       / np.abs(np.asarray(a[0])).max())
        assert float(a[2]) > 1e3       # the CG residual, far from 0
    small = dep[FO_COUNTS["cg_iters"]]
    assert small < 1e-11
    assert dep[120] > 1e-9 and dep[120] > 100.0 * small


def test_cg_guard_underflows_in_float32(dome):
    """A fault of the reference (ROADMAP §3), kept by the port: the CG
    guards its divisions with max(denom, 1e-300); in float32 1e-300 is 0,
    so a system whose residual is exactly 0 (flat ice: no driving stress)
    divides 0 by 0 and the velocity is NaN. In float64 the same solve
    gives 0."""
    jg = jfo.FoGeom(*(a.astype(jnp.float32) if a.dtype == jnp.float64
                      else a for a in jfo.build_fo_geom(dome.jmesh)))
    tg32 = tfo.build_fo_geom(dome.tmesh.to("cpu", torch.float32))
    h = np.full(dome.jmesh.nCells, 800.0)
    args = (3.17e-24, 1e12, 910.0 * 9.81)
    h32, a32 = h.astype(np.float32), np.float32(args[0])
    s32 = np.zeros_like(h32)            # a flat surface at sea level
    ref = jfo.solve_fo_stokes(jg, j(h32), j(s32), j(a32), *args[1:],
                              nz=NZ, picard_iters=1, cg_iters=2)
    got = tfo.solve_fo_stokes(tg32, t(h32), t(s32), t(a32), *args[1:],
                              nz=NZ, picard_iters=1, cg_iters=2)
    assert np.isnan(np.asarray(ref[0])).all()
    assert torch.isnan(got[0]).all()
    ok = tfo.solve_fo_stokes(tfo.build_fo_geom(dome.tmesh), t(h),
                             t(h * 0.0), *args, nz=NZ, picard_iters=1,
                             cg_iters=2)
    assert float(ok[0].abs().max()) == 0.0


# ------------------------------------------------------------- enthalpy

def test_enthalpy_functions(dome):
    sig = 0.5 * (np.linspace(0, 1, NZ + 1)[:-1] + np.linspace(0, 1, NZ + 1)
                 [1:])
    a = dome.a
    assert_close(tte.pmp_temperature(dome.tcfg, t(a["h"]), t(sig)),
                 jte.pmp_temperature(dome.jcfg, j(a["h"]), j(sig)), "pmp",
                 REL)
    e_t = tte.enthalpy_from_tw(t(a["temp"]), t(a["water"]))
    e_j = jte.enthalpy_from_tw(j(a["temp"]), j(a["water"]))
    assert_close(e_t, e_j, "E", REL)
    # both sides of the pressure-melting enthalpy
    e_mix = np.asarray(e_j) + np.where(np.arange(NZ) % 2, 3e4, 0.0)
    assert_close(tte.tw_from_enthalpy(dome.tcfg, t(e_mix), t(a["h"]),
                                      t(sig)),
                 jte.tw_from_enthalpy(dome.jcfg, j(e_mix), j(a["h"]),
                                      j(sig)), "tw", REL)
    for calc in ("constant", "PB1982"):
        jc, tc = cfgs(config_nvertlevels=NZ,
                      config_flowParamA_calculation=calc)
        assert_close(tte.strain_heating(dome.tgrid, tc, t(a["h"]),
                                        t(a["temp"])),
                     jte.strain_heating(dome.jgrid, jc, j(a["h"]),
                                        j(a["temp"])), "phi " + calc, REL)


@pytest.mark.parametrize("friction", [False, True])
def test_thermal_solve_enthalpy(dome, friction):
    a = dome.a
    # warm columns: some layers temperate, some water to drain
    temp = np.where(np.arange(NZ) >= NZ - 2, 273.1, a["temp"])
    fric = a["fric"] if friction else None
    got = tte.thermal_solve_enthalpy(
        dome.tgrid, dome.tcfg, t(a["h"]), t(temp), t(a["water"] * 3),
        YR, None if fric is None else t(fric))
    ref = jte.thermal_solve_enthalpy(
        dome.jgrid, dome.jcfg, j(a["h"]), j(temp), j(a["water"] * 3), YR,
        None if fric is None else j(fric))
    assert_close(got, ref, "enthalpy", REL)
    got0 = tte.thermal_solve_enthalpy(dome.tgrid, dome.tcfg, t(a["h"]),
                                      t(temp), None, YR)
    ref0 = jte.thermal_solve_enthalpy(dome.jgrid, dome.jcfg, j(a["h"]),
                                      j(temp), None, YR)
    assert_close(got0, ref0, "enthalpy w=None", REL)


def test_basal_energy_balance_and_floating_melt(dome, shelf):
    a = dome.a
    temp = np.where(np.arange(NZ) == NZ - 1, 273.1, a["temp"])
    bw = np.where(np.arange(a["h"].size) % 3 == 0, 0.0, 0.1)
    assert_close(
        tte.basal_energy_balance(dome.tcfg, t(a["h"]), t(temp),
                                 t(a["water"]), t(a["fric"]), t(bw), YR),
        jte.basal_energy_balance(dome.jcfg, j(a["h"]), j(temp),
                                 j(a["water"]), j(a["fric"]), j(bw), YR),
        "bmb", REL)
    t_ocn = np.linspace(270.0, 276.0, shelf["h"].size)
    assert_close(
        tte.basal_melt_floating(shelf["tcfg"], t(shelf["h"]),
                                t(shelf["bed"]), t(t_ocn)),
        jte.basal_melt_floating(shelf["jcfg"], j(shelf["h"]),
                                j(shelf["bed"]), j(t_ocn)), "melt", REL)


# ------------------------------------------------------------------- IR

def test_vertex_velocity_and_ir(dome):
    a = dome.a
    assert_close(tir.vertex_velocity_from_edges(dome.tmesh,
                                                t(a["u_edge"])),
                 jir.vertex_velocity_from_edges(dome.jmesh,
                                                j(a["u_edge"])), "uv", REL)
    u_int = np.repeat(a["u_edge"][:, None], NZ + 1, 1) \
        * np.linspace(1.0, 0.2, NZ + 1)[None, :] * 50.0
    assert_close(
        tir.advect_thickness_ir(dome.tgrid, dome.tcfg, t(a["h"]),
                                t(a["temp"]), t(u_int), YR),
        jir.advect_thickness_ir(dome.jgrid, dome.jcfg, j(a["h"]),
                                j(a["temp"]), j(u_int), YR), "ir", REL)


# -------------------------------------------------------------- calving

def test_calving_masks_and_strain(shelf):
    jg, tg = shelf["jgrid"], shelf["tgrid"]
    jc, tc = shelf["jcfg"], shelf["tcfg"]
    h = shelf["h"]
    tm, jm = tcalv.cell_masks(tg, tc, t(h)), jcalv.cell_masks(jg, jc, j(h))
    for k in jm:
        assert np.array_equal(tm[k].numpy(), np.asarray(jm[k])), k
    assert jm["floating"].any() and jm["margin"].any()
    front_t = tcalv.calving_front_mask(tg, tc, t(h), tm)
    front_j = jcalv.calving_front_mask(jg, jc, j(h), jm)
    assert np.array_equal(front_t.numpy(), np.asarray(front_j))
    assert np.asarray(front_j).any()
    ue = shelf["u_edge"]
    uv_t = tcalv.cell_velocity_from_edges(tg, t(ue))
    uv_j = jcalv.cell_velocity_from_edges(jg, j(ue))
    assert_close(uv_t, uv_j, "cell uv", REL)
    assert_close(tcalv.principal_strain_rates(tg, *uv_t),
                 jcalv.principal_strain_rates(jg, *uv_j), "e1e2", REL)


def test_calving_schemes(shelf):
    jg, tg = shelf["jgrid"], shelf["tgrid"]
    jc, tc = shelf["jcfg"], shelf["tcfg"]
    h, ue = shelf["h"], shelf["u_edge"]
    cf = np.zeros_like(h)
    got = tcalv.eigencalving(tg, tc, t(h), t(ue), YR, t(cf), k_eigen=1e19)
    ref = jcalv.eigencalving(jg, jc, j(h), j(ue), YR, j(cf), k_eigen=1e19)
    assert_close(got, ref, "eigen", REL)
    assert float(np.asarray(ref[1]).sum()) > 0.0      # something calved
    assert_close(tcalv.topographic_calving(tg, tc, t(h), t(cf), -700.0),
                 jcalv.topographic_calving(jg, jc, j(h), j(cf), -700.0),
                 "topo", REL)
    extent = shelf["xn"] < 0.5
    assert_close(tcalv.restore_calving_front(tg, tc, t(h), t(cf),
                                             torch.from_numpy(extent)),
                 jcalv.restore_calving_front(jg, jc, j(h), j(cf),
                                             j(extent)), "restore", REL)


# ---------------------------------------------------------------- hydro

def test_hydro_sheet(dome):
    a = dome.a
    assert_close(thydro.hydraulic_potential(dome.tgrid, dome.tcfg,
                                            t(a["h"])),
                 jhydro.hydraulic_potential(dome.jgrid, dome.jcfg,
                                            j(a["h"])), "phi", REL)
    w0 = np.where(a["h"] > 400.0, 0.5, 0.01)
    jh = jhydro.HydroState(waterThickness=j(w0),
                           tillWater=j(np.full(w0.size, 1.5)))
    th = thydro.HydroState(waterThickness=t(w0),
                           tillWater=t(np.full(w0.size, 1.5)))
    assert_close(thydro.sgh_step(dome.tgrid, dome.tcfg, th, t(a["h"]),
                                 t(a["melt"]), 86400.0, n_sub=5),
                 jhydro.sgh_step(dome.jgrid, dome.jcfg, jh, j(a["h"]),
                                 j(a["melt"]), 86400.0, n_sub=5), "sgh",
                 REL)
    temp = np.where(np.arange(NZ) == NZ - 1, 273.15, a["temp"])
    assert_close(thydro.basal_melt_from_thermal(dome.tgrid, dome.tcfg,
                                                t(a["h"]), t(temp)),
                 jhydro.basal_melt_from_thermal(dome.jgrid, dome.jcfg,
                                                j(a["h"]), j(temp)),
                 "melt", REL)


@pytest.mark.parametrize("channels", [True, False])
def test_sgh_step_full(dome, channels):
    a = dome.a
    n = dome.jmesh
    jh = jhydro.zero_hydro(n.nCells, n_edges=n.nEdges)
    th = thydro.zero_hydro(n.nCells, n_edges=n.nEdges, device="cpu")
    dt = 0.05 * YR
    for _ in range(3):
        jh = jhydro.sgh_step_full(dome.jgrid, dome.jcfg, jh, j(a["h"]),
                                  j(a["melt"]), j(a["speed"]), dt,
                                  n_sub=10, channels=channels)
        th = thydro.sgh_step_full(dome.tgrid, dome.tcfg, th, t(a["h"]),
                                  t(a["melt"]), t(a["speed"]), dt,
                                  n_sub=10, channels=channels)
    assert_close(th, jh, f"sgh_full channels={channels}", REL)
    assert float(np.abs(np.asarray(jh.waterPressure)).max()) > 0.0
    assert_close(thydro.effective_pressure(dome.tcfg, th, t(a["h"])),
                 jhydro.effective_pressure(dome.jcfg, jh, j(a["h"])), "N",
                 REL)
    # from the reference's default start (no pressure or channels yet)
    js = jhydro.zero_hydro(n.nCells)
    ts = thydro.zero_hydro(n.nCells, device="cpu")
    assert_close(thydro.sgh_step_full(dome.tgrid, dome.tcfg, ts, t(a["h"]),
                                      t(a["melt"]), t(a["speed"]), dt,
                                      n_sub=4, channels=channels),
                 jhydro.sgh_step_full(dome.jgrid, dome.jcfg, js, j(a["h"]),
                                      j(a["melt"]), j(a["speed"]), dt,
                                      n_sub=4, channels=channels),
                 "sgh_full from zero", REL)


# ----------------------------------------------------------- statistics

def test_global_and_regional_stats(shelf):
    jg, tg = shelf["jgrid"], shelf["tgrid"]
    jc, tc = shelf["jcfg"], shelf["tcfg"]
    rng = np.random.default_rng(5)
    nE = shelf["jmesh"].nEdges
    u = rng.normal(0.0, 1e-5, (nE, 5))
    cf = rng.uniform(0.0, 3.0, shelf["h"].size)
    z = np.zeros((shelf["h"].size, 4))
    js = jcore.LiState(thickness=j(shelf["h"]), temperature=j(z + 260.0),
                       normalVelocity=j(u), calvingFlux=j(cf))
    ts = tcore.LiState(thickness=t(shelf["h"]), temperature=t(z + 260.0),
                       normalVelocity=t(u), calvingFlux=t(cf))
    got = tstats.global_stats(tg, tc, ts)
    ref = jstats.global_stats(jg, jc, js)
    assert all(v.dim() == 0 for v in got.values())
    close_dict(got, ref)
    x = shelf["xn"]
    masks = np.stack([x < 0.3, (x >= 0.3) & (x < 0.7), x >= 0.5], 1)
    smb = rng.normal(0.0, 1e-8, x.size)
    bmb = rng.normal(0.0, 1e-9, x.size)
    close_dict(tstats.regional_stats(tg, tc, ts, masks, t(smb), t(bmb)),
               jstats.regional_stats(jg, jc, js, masks, j(smb), j(bmb)))
    close_dict(tstats.regional_stats(tg, tc, ts, masks),
               jstats.regional_stats(jg, jc, js, masks))


# ------------------------------------------------------------- external

@pytest.fixture(scope="module")
def box14():
    jm = j_box_hex_mesh(14, 14, 4000.0)
    tm = convert.mesh_from_arrays(flatten(jm))
    jc, tc = cfgs(config_nvertlevels=4)
    _g, js, _ = jinit.init_halfar(jm, jc, h0=500.0, r0=20000.0)
    return jm, tm, jc, tc, np.asarray(js.thickness)


def test_external_solver_builds_from_source():
    path = text.build_library()
    assert path.parent == text.BUILD_DIR
    assert path.name.startswith("libvelocitysolver-")
    assert path.resolve() != (text.REPO / "tools" / "velocity_solver"
                              / "libvelocitysolver.so").resolve()
    assert text.SOURCE.name == "interface_velocity_solver.cpp"


def test_external_solver_matches_the_reference(box14):
    from mpas_tpu.cores.landice.external import ExternalVelocitySolver
    jm, tm, jc, tc, th = box14
    bed = np.zeros(jm.nCells)
    # the two libraries share no state: each wrapper's calls run in turn
    js = ExternalVelocitySolver(jm, n_layers=4, cfg=jc)
    ref = {"n": js.compute_2d_grid(np.ones(jm.nVertices, np.int32))}
    ref["tri"] = js.triangles()
    ref["fo"] = js.solve_fo(th, bed)
    js.set_fo_options(1e12, 4, 40)
    ref["stokes"] = js.solve_fo_stokes(th, bed)
    js.finalize()
    ts = text.ExternalVelocitySolver(tm, n_layers=4, cfg=tc)
    got = {"n": ts.compute_2d_grid(torch.ones(tm.nVertices,
                                              dtype=torch.int32))}
    got["tri"] = ts.triangles()
    got["fo"] = ts.solve_fo(t(th), t(bed))
    ts.set_fo_options(1e12, 4, 40)
    got["stokes"] = ts.solve_fo_stokes(th, bed)
    assert got["n"] == ref["n"] > 0
    assert all(np.array_equal(a, b) for a, b in zip(got["tri"],
                                                     ref["tri"]))
    assert got["fo"].shape == (jm.nEdges, 5)
    assert np.array_equal(got["fo"], ref["fo"])
    assert np.array_equal(got["stokes"], ref["stokes"])
    assert np.abs(got["stokes"]).max() > 0.0
    ts.finalize()
    ts2 = text.ExternalVelocitySolver(tm, n_layers=4, cfg=tc)
    assert ts2.compute_2d_grid(np.zeros(tm.nVertices, np.int32)) == 0
    ts2.finalize()


def external_outputs(mesh, cfg):
    """The external solver's outputs on the 14 x 14 box's dome (4 layers,
    h0 500 m, r0 20 km, flat bed): {"solve_fo", "solve_fo_stokes" (1e12,
    4 Picard x 40 CG)}, host numpy."""
    _g, st, _t0 = tinit.init_halfar(mesh, cfg, h0=500.0, r0=20000.0,
                                    device="cpu")
    th = st.thickness.numpy()
    bed = np.zeros(mesh.nCells)
    sv = text.ExternalVelocitySolver(mesh, n_layers=4, cfg=cfg)
    try:
        out = {"solve_fo": sv.solve_fo(th, bed)}
        sv.set_fo_options(1e12, 4, 40)
        out["solve_fo_stokes"] = sv.solve_fo_stokes(th, bed)
    finally:
        sv.finalize()
    return out


def test_external_solver_golden(box14):
    _jm, tm, _jc, tc, _th = box14
    golden = np.load(EXTERNAL_GOLDEN)
    for k, v in external_outputs(tm, tc).items():
        assert_close(v, golden[k], k, 1e-12)


if __name__ == "__main__":
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    np.savez_compressed(EXTERNAL_GOLDEN, **external_outputs(
        box_hex_mesh(14, 14, 4000.0), tconf.LiConfig(config_nvertlevels=4)))
    print(f"wrote {EXTERNAL_GOLDEN}")
