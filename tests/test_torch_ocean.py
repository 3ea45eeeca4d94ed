"""The ocean core of the PyTorch port against the JAX package.

The baroclinic channel (channel_hex_mesh(8, 26, 10 km), 10 levels, the
mesh of tests/test_ocean_core.py) is carried into the port through
convert.py in float64, with u, ubtr, the thicknesses and both tracers
perturbed from a numpy seed so that every term is non-trivial. Every
ported function is held to its JAX twin at 1e-11 x max|ref| (sums in
another order), on the full-depth grid and on a grid with level masks
from a seeded maxLevelCell (plus a surface pressure and a tidal energy
flux); the initial condition is the reference's bit for bit; 3
split-explicit steps (dt 300 s) and 4 RK4 steps (dt 30 s) through
run_steps are held at 1e-9 x max|ref|, and conserve volume and heat to
1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.ocean import core as jcore
from mpas_tpu.cores.ocean import eos as jeos
from mpas_tpu.cores.ocean import forcing as jforcing
from mpas_tpu.cores.ocean import gm as jgm
from mpas_tpu.cores.ocean import kpp as jkpp
from mpas_tpu.cores.ocean import tracer_extras as jtx
from mpas_tpu.cores.ocean import vmix as jvmix
from mpas_tpu.cores.ocean import ztilde as jzt
from mpas_tpu.cores.ocean.init_channel import \
    init_baroclinic_channel as j_init_channel
from mpas_tpu.mesh.planar import channel_hex_mesh as j_channel_hex_mesh
from mpas_tpu.ops import matrix as jmatrix
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.ocean import core as tcore
from mpas_tpu_torch.cores.ocean import eos as teos
from mpas_tpu_torch.cores.ocean import forcing as tforcing
from mpas_tpu_torch.cores.ocean import gm as tgm
from mpas_tpu_torch.cores.ocean import kpp as tkpp
from mpas_tpu_torch.cores.ocean import tracer_extras as ttx
from mpas_tpu_torch.cores.ocean import vmix as tvmix
from mpas_tpu_torch.cores.ocean import ztilde as tzt
from mpas_tpu_torch.cores.ocean.init_channel import \
    init_baroclinic_channel as t_init_channel
from mpas_tpu_torch.mesh.planar import channel_hex_mesh as t_channel_hex_mesh
from mpas_tpu_torch.ops import matrix as tmatrix
from mpas_tpu_torch.ops import stencils

torch.set_num_threads(1)

REL = 1e-11
STEP_REL = 1e-9
NZ = 10
GRIDS = ["full", "masked"]


def flatten(obj):
    """A reference (flax) container -> nested dict of numpy arrays/statics."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = flatten(v)
        elif v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def assert_close(got, ref, name="", rel=REL):
    """got (port: tensors, tuples, containers) against ref (reference) at
    rel x max|ref|, field by field."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_close(getattr(got, f.name), getattr(ref, f.name),
                         f"{name}.{f.name}", rel)
        return
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref), name
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, f"{name}[{i}]", rel)
        return
    if got is None or ref is None:
        assert got is None and ref is None, name
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all() == np.isfinite(ref).all(), name
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{name}: {err:.3e} > {rel:g} x {scale:.3e}"


def pair(a):
    """numpy array -> (jax array, torch tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


class Case:
    """The perturbed channel in both packages: `j*` reference objects,
    `t*` port objects, `a` the numpy arrays behind them."""

    def __init__(self):
        jmesh = j_channel_hex_mesh(8, 26, 10000.0)
        jgrid, jstate = j_init_channel(jmesh, nz=NZ)
        rng = np.random.default_rng(0)
        m = flatten(jgrid.mesh)
        nC, nE = m["nCells"], m["nEdges"]
        not_bnd = 1.0 - m["boundaryEdge"]
        s = flatten(jstate)
        tr = s["tracers"].copy()
        tr[..., 0] += 0.3 * rng.standard_normal(tr.shape[:2])
        tr[..., 1] += 0.05 * rng.standard_normal(tr.shape[:2])
        self.a = dict(
            u=0.1 * rng.standard_normal((nE, NZ)) * not_bnd[:, None],
            layerThickness=s["layerThickness"]
            * (1.0 + 0.02 * rng.standard_normal((nC, NZ))),
            tracers=tr,
            ubtr=0.01 * rng.standard_normal(nE) * not_bnd,
            lowFreqDivergence=1e-6 * rng.standard_normal((nC, NZ)),
            highFreqThickness=0.5 * rng.standard_normal((nC, NZ)))
        mlc = rng.integers(NZ // 2, NZ + 1, nC).astype(np.int32)
        cell_mask, edge_mask = jcore.build_level_masks(jgrid.mesh, mlc, NZ)
        extras = dict(maxLevelCell=mlc, cellMask=cell_mask,
                      edgeMask=edge_mask,
                      surfacePressure=100.0 * rng.uniform(size=nC),
                      tidalEnergyFlux=1e-3 * (1.0 + rng.uniform(size=nC)))
        self.mlc = mlc
        self.jgrid = {"full": jax.tree.map(jnp.asarray, jgrid),
                      "masked": jax.tree.map(jnp.asarray,
                                             jgrid.replace(**extras))}
        self.tgrid = {k: convert.ocn_grid_from_arrays(flatten(g))
                      for k, g in self.jgrid.items()}
        keys = ("u", "layerThickness", "tracers", "ubtr")
        self.jstate = jcore.OcnState(**{k: jnp.asarray(self.a[k])
                                        for k in keys})
        self.tstate = convert.ocn_state_from_arrays(
            flatten(self.jstate))
        self.jstate_zt = self.jstate.replace(
            lowFreqDivergence=jnp.asarray(self.a["lowFreqDivergence"]),
            highFreqThickness=jnp.asarray(self.a["highFreqThickness"]))
        self.tstate_zt = convert.ocn_state_from_arrays(
            flatten(self.jstate_zt))
        f = dict(windStressZonal=0.1 * rng.standard_normal(nC),
                 windStressMeridional=0.1 * rng.standard_normal(nC),
                 sensibleHeatFlux=-100.0 + 50.0 * rng.standard_normal(nC),
                 shortwaveFlux=100.0 * rng.uniform(size=nC),
                 freshwaterFlux=1e-5 * rng.standard_normal(nC),
                 sstRestore=tr[:, 0, 0] + rng.standard_normal(nC),
                 sssRestore=35.0 + 0.1 * rng.standard_normal(nC))
        self.jforcing = jforcing.OcnSurfaceForcing(
            **{k: jnp.asarray(v) for k, v in f.items()})
        self.tforcing = convert.ocn_forcing_from_arrays(
            flatten(self.jforcing))

    def field(self, where, trailing=(), seed=0, scale=1.0):
        n = {"edge": self.tgrid["full"].mesh.nEdges,
             "cell": self.tgrid["full"].mesh.nCells}[where]
        return pair(scale * np.random.default_rng(seed).standard_normal(
            (n,) + trailing))


@pytest.fixture(scope="module")
def case():
    return Case()


CFGS = {
    "default": {},
    "apvm_rayleigh_jm": dict(config_apvm_upwinding=0.5,
                             config_rayleigh_friction=1e-5,
                             config_eos_type="jm"),
}


def cfgs(name, **kw):
    """The same configuration in both packages."""
    kw = {**CFGS.get(name, {}), **kw}
    return jcore.OcnConfig(**kw), tcore.OcnConfig(**kw)


def w_top_pair(case, seed=3):
    w = 1e-4 * np.random.default_rng(seed).standard_normal(
        (case.tgrid["full"].mesh.nCells, NZ + 1))
    w[:, NZ] = 0.0
    return pair(w)


# ---------------------------------------------------------------------------
# set-up: the mesh's Coriolis, the initial condition, masks, conversion
# ---------------------------------------------------------------------------

def test_init_baroclinic_channel_bit_for_bit():
    jgrid, jstate = j_init_channel(j_channel_hex_mesh(8, 26, 10000.0),
                                   nz=NZ)
    tgrid, tstate = t_init_channel(t_channel_hex_mesh(8, 26, 10000.0),
                                   nz=NZ)
    for got, ref in ((tgrid, jgrid), (tstate, jstate)):
        ref = flatten(ref)
        for f in dataclasses.fields(got):
            v = getattr(got, f.name)
            if f.name == "mesh":
                for k in ("fEdge", "fVertex", "fCell", "xCell", "areaCell"):
                    assert np.array_equal(getattr(v, k).numpy(),
                                          ref["mesh"][k]), k
            elif isinstance(v, torch.Tensor):
                assert v.dtype == torch.from_numpy(ref[f.name]).dtype, \
                    f.name
                assert np.array_equal(v.numpy(), ref[f.name]), f.name
            else:
                assert v == ref[f.name], f.name


def test_build_level_masks(case):
    cm, em = tcore.build_level_masks(case.tgrid["full"].mesh, case.mlc, NZ)
    jcm, jem = jcore.build_level_masks(case.jgrid["full"].mesh, case.mlc, NZ)
    assert np.array_equal(cm.numpy(), jcm)
    assert np.array_equal(em.numpy(), jem)
    assert 0.0 < float(cm.mean()) < 1.0


def test_grid_moves_with_to(case):
    g = case.tgrid["masked"].to(torch.device("cpu"), torch.float32)
    assert g.restingThickness.dtype == torch.float32
    assert g.cellMask.dtype == torch.float32
    assert g.maxLevelCell.dtype == torch.int64
    assert g.mesh.edgesOnCell.dtype == torch.int64
    assert g.nz == NZ and case.tgrid["full"].cellMask is None
    s = case.tstate.to(torch.device("cpu"), torch.float32)
    assert s.ubtr.dtype == torch.float32 and s.highFreqThickness is None


# ---------------------------------------------------------------------------
# small-matrix utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, NZ])
def test_tridiagonal_solve(n):
    rng = np.random.default_rng(n)
    a, c = rng.uniform(-1, 0, (2, 7, 5, n))
    b = 2.5 + rng.uniform(size=(7, 5, n))
    d = rng.standard_normal((7, 5, n))
    got = tmatrix.tridiagonal_solve(*(torch.from_numpy(x)
                                      for x in (a, b, c, d)))
    assert_close(got, jmatrix.tridiagonal_solve(a, b, c, d))


@pytest.mark.parametrize("fn,args", [
    ("rotation_matrix_2d", (0.3,)),
    ("rotation_about_axis_3d", (np.array([1.0, -2.0, 0.5]), 0.7)),
    ("solve_linear", (np.eye(4) * 3.0 + np.arange(16.0).reshape(4, 4) / 20,
                      np.arange(8.0).reshape(4, 2))),
])
def test_matrix_helpers(fn, args):
    targs = [torch.as_tensor(x, dtype=torch.float64) for x in args]
    jargs = [jnp.asarray(x) for x in args]
    assert_close(getattr(tmatrix, fn)(*targs), getattr(jmatrix, fn)(*jargs))


# ---------------------------------------------------------------------------
# equations of state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", ["surface", "scalar", "field"])
def test_density_jm(case, p):
    jT, tT = case.field("cell", (NZ,), seed=4, scale=8.0)
    jS, tS = pair(35.0 + 3.0 * np.random.default_rng(5).standard_normal(
        tT.shape))
    if p == "field":
        jp, tp = pair(jeos.pressure_from_depth(
            np.linspace(0.0, 4000.0, NZ)) * np.ones(tT.shape))
    else:
        jp = tp = 0.0 if p == "surface" else 120.0
    assert_close(teos.density_jm(tT + 10.0, tS, tp),
                 jeos.density_jm(jT + 10.0, jS, jp))


def test_equations_of_state(case):
    jT, tT = case.field("cell", (NZ,), seed=4, scale=8.0)
    jS, tS = case.field("cell", (NZ,), seed=5, scale=1.0)
    d = np.linspace(0.0, 5000.0, 11)
    assert_close(teos.pressure_from_depth(torch.from_numpy(d)),
                 jeos.pressure_from_depth(jnp.asarray(d)))
    for eos in ("linear", "jm"):
        jc, tc = cfgs("default", config_eos_type=eos)
        assert_close(tcore.equation_of_state(tc, tT, tS + 35.0),
                     jcore.equation_of_state(jc, jT, jS + 35.0), eos)
        assert_close(teos.density(tc, tT, tS + 35.0),
                     jeos.density(jc, jT, jS + 35.0), eos)
    jc, tc = cfgs("default")
    assert_close(tcore.equation_of_state_linear(tc, tT, tS),
                 jcore.equation_of_state_linear(jc, jT, jS))


# ---------------------------------------------------------------------------
# tendencies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("planetary", [True, False])
def test_vel_tendency(case, grid, cfg, planetary):
    jc, tc = cfgs(cfg)
    jw, tw = w_top_pair(case)
    s, js = case.tstate, case.jstate
    got = tcore.vel_tendency(case.tgrid[grid], tc, s.u, s.layerThickness,
                             s.tracers, tw, 300.0, planetary=planetary)
    want = jcore.vel_tendency(case.jgrid[grid], jc, js.u, js.layerThickness,
                              js.tracers, jw, 300.0, planetary=planetary)
    assert_close(got, want)


@pytest.mark.parametrize("grid", GRIDS)
def test_tracer_and_thickness_tendency(case, grid):
    jc, tc = cfgs("default")
    jw, tw = w_top_pair(case)
    juh, tuh = case.field("edge", (NZ,), seed=6, scale=10.0)
    s, js = case.tstate, case.jstate
    assert_close(tcore.tracer_tendency(case.tgrid[grid], tc, tuh, tw,
                                       s.layerThickness, s.tracers),
                 jcore.tracer_tendency(case.jgrid[grid], jc, juh, jw,
                                       js.layerThickness, js.tracers))
    assert_close(tcore.thickness_tendency(case.tgrid[grid], tuh),
                 jcore.thickness_tendency(case.jgrid[grid], juh))
    jd, td = case.field("cell", (NZ,), seed=7, scale=1e-4)
    assert_close(tcore._ale_thickness_tend(case.tgrid[grid], td),
                 jcore._ale_thickness_tend(case.jgrid[grid], jd))


TEND_CFGS = {
    "default": {},
    "gm_jm": dict(config_use_gm=True, config_eos_type="jm"),
    "ztilde": dict(config_use_freq_filtered_thickness=True,
                   config_highFreqThick_del2=100.0),
}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("cfg", list(TEND_CFGS))
def test_tendencies(case, grid, cfg):
    jc, tc = cfgs(cfg, **TEND_CFGS[cfg])
    zt = cfg == "ztilde"
    got = tcore.tendencies(case.tgrid[grid], tc,
                           case.tstate_zt if zt else case.tstate, 30.0)
    want = jcore.tendencies(case.jgrid[grid], jc,
                            case.jstate_zt if zt else case.jstate, 30.0)
    assert len(got) == (5 if zt else 3)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# vertical mixing
# ---------------------------------------------------------------------------

VMIX = {
    "const": {},
    "rich": dict(config_vert_mix_scheme="rich"),
    "tanh": dict(config_vert_mix_scheme="tanh"),
    "cvmix": dict(config_vert_mix_scheme="cvmix"),
    "cvmix_shear_kpp_tidal": dict(config_vert_mix_scheme="cvmix",
                                  config_use_cvmix_shear=True,
                                  config_use_cvmix_tidal_mixing=True),
    "cvmix_shear_pp_ddiff": dict(config_vert_mix_scheme="cvmix",
                                 config_use_cvmix_shear=True,
                                 config_cvmix_shear_mixing_scheme="PP",
                                 config_use_cvmix_double_diffusion=True,
                                 config_use_cvmix_convection=False),
    "kpp": dict(config_vert_mix_scheme="kpp"),
    "redi_jm": dict(config_use_redi=True, config_eos_type="jm"),
}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("scheme", list(VMIX))
@pytest.mark.parametrize("forced", [False, True])
def test_implicit_vertical_mix(case, grid, scheme, forced):
    jc, tc = cfgs("default", **VMIX[scheme])
    got = tcore.implicit_vertical_mix(
        case.tgrid[grid], tc, case.tstate, 300.0,
        case.tforcing if forced else None)
    want = jcore.implicit_vertical_mix(
        case.jgrid[grid], jc, case.jstate, 300.0,
        case.jforcing if forced else None)
    assert_close(got, want)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("scheme", list(VMIX))
def test_build_coefs(case, grid, scheme):
    jc, tc = cfgs("default", **VMIX[scheme])
    s, js = case.tstate, case.jstate
    rho = tcore.equation_of_state(tc, s.tracers[..., 0], s.tracers[..., 1])
    jrho = jcore.equation_of_state(jc, js.tracers[..., 0],
                                   js.tracers[..., 1])
    got = tvmix.build_coefs(case.tgrid[grid], tc, s.u, s.layerThickness,
                            rho, forcing=case.tforcing, tracers=s.tracers)
    want = jvmix.build_coefs(case.jgrid[grid], jc, js.u, js.layerThickness,
                             jrho, forcing=case.jforcing, tracers=js.tracers)
    assert_close(got, want)


@pytest.mark.parametrize("fn", ["richardson_number", "coefs_const",
                                "coefs_rich", "coefs_tanh",
                                "coefs_cvmix_convection", "coefs_cvmix_shear",
                                "coefs_cvmix_tidal"])
def test_vmix_coefficients(case, fn):
    jc, tc = cfgs("default")
    s, js = case.tstate, case.jstate
    rho = tcore.equation_of_state(tc, s.tracers[..., 0], s.tracers[..., 1])
    jrho = jcore.equation_of_state(jc, js.tracers[..., 0],
                                   js.tracers[..., 1])
    for grid in GRIDS:
        assert_close(getattr(tvmix, fn)(case.tgrid[grid], tc, s.u,
                                        s.layerThickness, rho),
                     getattr(jvmix, fn)(case.jgrid[grid], jc, js.u,
                                        js.layerThickness, jrho), grid)
    assert_close(
        tvmix.coefs_cvmix_double_diffusion(case.tgrid["full"], tc,
                                           s.tracers, s.layerThickness),
        jvmix.coefs_cvmix_double_diffusion(case.jgrid["full"], jc,
                                           js.tracers, js.layerThickness))


# ---------------------------------------------------------------------------
# KPP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("forced", [False, True])
def test_coefs_kpp(case, forced):
    jc, tc = cfgs("default", config_vert_mix_scheme="kpp")
    s, js = case.tstate, case.jstate
    rho = tcore.equation_of_state(tc, s.tracers[..., 0], s.tracers[..., 1])
    jrho = jcore.equation_of_state(jc, js.tracers[..., 0],
                                   js.tracers[..., 1])
    got = tkpp.coefs_kpp(case.tgrid["full"], tc, s.u, s.layerThickness, rho,
                         forcing=case.tforcing if forced else None,
                         tracers=s.tracers)
    want = jkpp.coefs_kpp(case.jgrid["full"], jc, js.u, js.layerThickness,
                          jrho, forcing=case.jforcing if forced else None,
                          tracers=js.tracers)
    assert_close(got, want)
    if forced:      # the forcing makes part of the surface unstable
        assert 0.0 < float((got[2] > 0).double().mean()) < 1.0


def test_kpp_scales_and_depth(case):
    jc, tc = cfgs("default")
    s, js = case.tstate, case.jstate
    rho = tcore.equation_of_state(tc, s.tracers[..., 0], s.tracers[..., 1])
    jrho = jcore.equation_of_state(jc, js.tracers[..., 0],
                                   js.tracers[..., 1])
    ustar, bflux = tkpp.surface_forcing_scales(tc, case.tforcing, rho,
                                               s.tracers)
    jus, jbf = jkpp.surface_forcing_scales(jc, case.jforcing, jrho,
                                           js.tracers)
    assert_close((ustar, bflux), (jus, jbf))
    assert_close(tkpp.boundary_layer_depth(case.tgrid["full"], tc, s.u,
                                           s.layerThickness, rho, ustar,
                                           bflux),
                 jkpp.boundary_layer_depth(case.jgrid["full"], jc, js.u,
                                           js.layerThickness, jrho, jus,
                                           jbf))
    jsig, tsig = pair(np.random.default_rng(8).uniform(
        size=(ustar.shape[0], NZ - 1)))
    jh, th = pair(50.0 + 100.0 * np.random.default_rng(9).uniform(
        size=ustar.shape[0]))
    assert_close(tkpp._w_scales(tsig, th, ustar, bflux),
                 jkpp._w_scales(jsig, jh, jus, jbf))


# ---------------------------------------------------------------------------
# GM / Redi, z-tilde, tracer groups, surface forcing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("fn", ["isoneutral_slope", "bolus_velocity",
                                "redi_vertical_enhancement"])
def test_gm(case, grid, fn):
    jc, tc = cfgs("default", config_use_gm=True)
    s, js = case.tstate, case.jstate
    rho = tcore.equation_of_state(tc, s.tracers[..., 0], s.tracers[..., 1])
    jrho = jcore.equation_of_state(jc, js.tracers[..., 0],
                                   js.tracers[..., 1])
    assert_close(getattr(tgm, fn)(case.tgrid[grid], tc, rho,
                                  s.layerThickness),
                 getattr(jgm, fn)(case.jgrid[grid], jc, jrho,
                                  js.layerThickness))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("restore,del2", [(True, 0.0), (False, 50.0)])
def test_ztilde_tendencies(case, grid, restore, del2):
    kw = dict(config_use_highFreqThick_restore=restore,
              config_highFreqThick_del2=del2)
    jc, tc = cfgs("default", **kw)
    jd, td = case.field("cell", (NZ,), seed=10, scale=1e-4)
    s, js = case.tstate_zt, case.jstate_zt
    got = tzt.freq_filtered_tends(case.tgrid[grid], tc, td,
                                  s.layerThickness, s.lowFreqDivergence,
                                  s.highFreqThickness)
    want = jzt.freq_filtered_tends(case.jgrid[grid], jc, jd,
                                   js.layerThickness, js.lowFreqDivergence,
                                   js.highFreqThickness)
    assert_close(got, want)
    assert_close(tzt.ale_tends_ztilde(case.tgrid[grid], td, got[1]),
                 jzt.ale_tends_ztilde(case.jgrid[grid], jd, want[1]))
    assert_close(tzt.hhf_del2(case.tgrid[grid].mesh, s.highFreqThickness,
                              del2 + 1.0),
                 jzt.hhf_del2(case.jgrid[grid].mesh, js.highFreqThickness,
                              del2 + 1.0))


@pytest.mark.parametrize("grid", GRIDS)
def test_min_max_thickness_filter(case, grid):
    jc, tc = cfgs("default", config_use_min_max_thickness=True)
    rest = np.asarray(case.jgrid["full"].restingThickness)
    # layers both under the 1 m minimum and over 6x their resting value
    jh, th = pair(rest * np.random.default_rng(11).uniform(0.0, 8.0,
                                                            rest.shape))
    got = tzt.min_max_thickness_filter(case.tgrid[grid], tc, th)
    assert_close(got, jzt.min_max_thickness_filter(case.jgrid[grid], jc, jh))
    assert_close(got.sum(-1), th.sum(-1).numpy())      # columns conserved


def test_tracer_groups(case):
    jc, tc = cfgs("default")
    rng = np.random.default_rng(12)
    tr = np.concatenate([case.a["tracers"],
                         rng.uniform(size=case.a["tracers"].shape[:2]
                                     + (1,))], axis=-1)
    tr[:20, :, 0] = -3.0 + rng.uniform(size=(20, NZ))    # below freezing
    jtr, ttr = pair(tr)
    assert_close(ttx.freezing_temperature(ttr[..., 1]),
                 jtx.freezing_temperature(jtr[..., 1]))
    assert_close(ttx.ideal_age_step(ttr, 2, 300.0),
                 jtx.ideal_age_step(jtr, 2, 300.0))
    assert_close(ttx.exponential_decay_step(ttr, 2, 300.0, 86400.0),
                 jtx.exponential_decay_step(jtr, 2, 300.0, 86400.0))
    s = dataclasses.replace(case.tstate, tracers=ttr)
    got = ttx.frazil_adjustment(tc, s, 300.0)
    want = jtx.frazil_adjustment(jc, case.jstate.replace(tracers=jtr), 300.0)
    assert_close(got, want)
    assert float(got[1].max()) > 0.0
    assert np.array_equal(ttr.numpy(), tr)              # input untouched


@pytest.mark.parametrize("fn", ["surface_stress_tend", "surface_tracer_tend",
                                "shortwave_heating"])
def test_surface_forcing_terms(case, fn):
    jc, tc = cfgs("default")
    s, js = case.tstate, case.jstate
    if fn == "shortwave_heating":
        got = tforcing.shortwave_heating(tc, case.tforcing, s.layerThickness)
        want = jforcing.shortwave_heating(jc, case.jforcing,
                                          js.layerThickness)
    else:
        targs = (s.layerThickness,) + ((s.tracers,) if "tracer" in fn
                                       else ())
        jargs = (js.layerThickness,) + ((js.tracers,) if "tracer" in fn
                                        else ())
        got = getattr(tforcing, fn)(case.tgrid["full"], tc, case.tforcing,
                                    *targs)
        want = getattr(jforcing, fn)(case.jgrid["full"], jc, case.jforcing,
                                     *jargs)
    assert_close(got, want)


def test_zero_forcing_and_apply(case):
    z = tforcing.zero_forcing(7)
    assert all(float(getattr(z, k).abs().max()) == 0.0
               for k in ("windStressZonal", "sensibleHeatFlux"))
    assert z.latentHeatFlux is None and z.windStressZonal.shape == (7,)
    jc, tc = cfgs("default")
    got = tcore.apply_surface_forcing(case.tgrid["full"], tc, case.tstate,
                                      case.tforcing, 300.0)
    want = jcore.apply_surface_forcing(case.jgrid["full"], jc, case.jstate,
                                       case.jforcing, 300.0)
    assert_close(got, want)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("integrator,dt", [("split_explicit", 300.0),
                                           ("RK4", 30.0)])
def test_one_step(case, grid, integrator, dt):
    """One step of each integrator, forced, with GM on the split path and
    z-tilde plus the min/max thickness filter on the RK4 path."""
    if integrator == "split_explicit":
        kw, js, ts = dict(config_use_gm=True), case.jstate, case.tstate
    else:
        kw = dict(config_use_freq_filtered_thickness=True,
                  config_use_min_max_thickness=True)
        js, ts = case.jstate_zt, case.tstate_zt
    jc, tc = cfgs("default", config_dt=dt, config_time_integrator=integrator,
                  **kw)
    step_t = tcore.split_step if integrator == "split_explicit" \
        else tcore.rk4_step
    step_j = jcore.split_step if integrator == "split_explicit" \
        else jcore.rk4_step
    got = step_t(case.tgrid[grid], tc, ts, dt, case.tforcing)
    assert_close(got, step_j(case.jgrid[grid], jc, js, dt, case.jforcing),
                 rel=STEP_REL)


@pytest.mark.parametrize("integrator,dt", [("split_explicit", 300.0),
                                           ("RK4", 30.0)])
def test_ocn_timestep_with_forcing_and_tracer_groups(case, integrator, dt):
    kw = dict(config_dt=dt, config_time_integrator=integrator,
              config_use_ideal_age=True, config_use_exponential_decay=True,
              config_use_frazil=True)
    jc, tc = cfgs("default", **kw)
    tr = np.concatenate([case.a["tracers"],
                         np.ones(case.a["tracers"].shape[:2] + (1,))], -1)
    tr[:10, 0, 0] = -2.5                        # frazil forms at the top
    jtr, ttr = pair(tr)
    got = tcore.ocn_timestep(case.tgrid["full"], tc,
                             dataclasses.replace(case.tstate, tracers=ttr),
                             dt, case.tforcing)
    want = jcore.ocn_timestep(case.jgrid["full"], jc,
                              case.jstate.replace(tracers=jtr), dt,
                              case.jforcing)
    assert_close(got, want, rel=STEP_REL)


@pytest.fixture(scope="module")
def trajectories(case):
    """3 split-explicit steps at dt = 300 s and 4 RK4 steps at dt = 30 s
    through run_steps, in both packages."""
    out = {}
    for integrator, dt, n in (("split_explicit", 300.0, 3), ("RK4", 30.0, 4)):
        jc, tc = cfgs("default", config_dt=dt,
                      config_time_integrator=integrator)
        out[integrator] = (
            tcore.run_steps(case.tgrid["full"], tc, case.tstate, n),
            jcore.run_steps(case.jgrid["full"], jc, case.jstate, n))
    return out


@pytest.mark.parametrize("integrator", ["split_explicit", "RK4"])
@pytest.mark.parametrize("field", ["u", "layerThickness", "tracers", "ubtr"])
def test_run_steps_match_reference(trajectories, integrator, field):
    got, want = trajectories[integrator]
    assert_close(getattr(got, field), getattr(want, field), field,
                 rel=STEP_REL)


@pytest.mark.parametrize("integrator", ["split_explicit", "RK4"])
def test_run_steps_conserve_volume_and_heat(case, trajectories, integrator):
    area = case.tgrid["full"].mesh.areaCell[:, None]
    got, _ = trajectories[integrator]

    def volume_heat(s):
        h = s.layerThickness * area
        return float(h.sum()), float((h * s.tracers[..., 0]).sum())

    (vol0, heat0), (vol1, heat1) = volume_heat(case.tstate), volume_heat(got)
    assert abs(vol1 - vol0) / vol0 < 1e-12
    assert abs(heat1 - heat0) / abs(heat0) < 1e-12
    bnd = case.tgrid["full"].mesh.boundaryEdge > 0
    assert float(got.u[bnd].abs().max()) == 0.0


def test_unknown_integrator_raises(case):
    cfg = tcore.OcnConfig(config_time_integrator="leapfrog")
    with pytest.raises(ValueError, match="config_time_integrator"):
        tcore.run_steps(case.tgrid["full"], cfg, case.tstate, 1)


@pytest.mark.parametrize("step", ["split_step", "rk4_step"])
def test_exchange_hooks_are_not_ported(case, step):
    """The exchange hooks are ported now (the sharded runner,
    tests/test_torch_distributed.py): identity hooks are called and leave
    the step bit for bit as it is without them."""
    calls = []

    class Identity:
        def cell(self, x, depth=None):
            calls.append(("cell", depth))
            return x

        def edge(self, x, depth=None):
            calls.append(("edge", depth))
            return x

    fn = getattr(tcore, step)
    args = (case.tgrid["full"], tcore.OcnConfig(), case.tstate, 30.0)
    a, b = fn(*args, xch=Identity()), fn(*args)
    assert calls
    for k in ("u", "layerThickness", "tracers"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("kw", [{}, dict(config_dt=600.0),
                                dict(config_apvm_upwinding=0.5,
                                     config_n_ts_iter=3,
                                     config_n_btr_cor_iter=1)])
def test_split_step_contractions_per_step(case, monkeypatch, kw):
    """Every TRiSK contraction of split_step goes through the K2 wrapper,
    as often as tinydot_launches_per_split_step says (245 for the
    channel's defaults)."""
    calls = []
    real = stencils.tinydot

    def counting(w, x):
        calls.append(x.shape[-1])
        return real(w, x)

    monkeypatch.setattr(stencils, "tinydot", counting)
    cfg = tcore.OcnConfig(**kw)
    tcore.split_step(case.tgrid["full"], cfg, case.tstate, cfg.config_dt)
    assert len(calls) == tcore.tinydot_launches_per_split_step(cfg)
    if not kw:
        assert len(calls) == 245
        assert sorted(set(calls)) == [1, NZ, 2 * NZ]
        assert (calls.count(1), calls.count(NZ), calls.count(2 * NZ)) \
            == (240, 3, 2)
