"""The port's physics suite (mesoscale_reference) against the JAX package,
function by function, in float64 on the CPU.

Inputs are made with numpy from seeds and handed to both packages: columns
of 24 cells x 16 levels (a 16-km sounding with warm and frozen levels,
cloud decks, hydrometeors and winds) and the 144-cell, 16-level supercell
grid of tests/test_torch_supercell.py with six moisture species. Each JAX
function is jitted once. Bounds:
- every physics function: 1e-11 x max|ref| per output (float64 with sums
  taken in another order: RRTMG sums all bands' g-points at once);
- the reconstruction coefficients: 1e-13 x max|ref| (the same numpy
  algorithm on the host).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere.config import AtmConfig as JaxAtmConfig
from mpas_tpu.cores.atmosphere.init_supercell import \
    init_supercell as jax_init_supercell
from mpas_tpu.cores.atmosphere.physics import cldfra3 as jcld
from mpas_tpu.cores.atmosphere.physics import driver as jdriver
from mpas_tpu.cores.atmosphere.physics import gf as jgf
from mpas_tpu.cores.atmosphere.physics import gwdo as jgwdo
from mpas_tpu.cores.atmosphere.physics import lsm as jlsm
from mpas_tpu.cores.atmosphere.physics import manager as jman
from mpas_tpu.cores.atmosphere.physics import mynn as jmynn
from mpas_tpu.cores.atmosphere.physics import mynn_sfc as jmynn_sfc
from mpas_tpu.cores.atmosphere.physics import noah as jnoah
from mpas_tpu.cores.atmosphere.physics import radiation as jrad
from mpas_tpu.cores.atmosphere.physics import rrtmg as jrrtmg
from mpas_tpu.cores.atmosphere.physics import sfclay as jsfclay
from mpas_tpu.cores.atmosphere.physics import tiedtke as jtiedtke
from mpas_tpu.cores.atmosphere.physics import wsm6 as jwsm6
from mpas_tpu.cores.atmosphere.physics import ysu as jysu
from mpas_tpu.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu.mesh.planar import planar_hex_mesh as jax_planar_hex_mesh
from mpas_tpu.mesh.sphere import icosahedral_mesh as jax_icosahedral_mesh
from mpas_tpu.ops import reconstruct as jrecon
from mpas_tpu_torch import convert
from mpas_tpu_torch.constants import cp, rvord
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
from mpas_tpu_torch.cores.atmosphere.physics import cam_radiation as tcam
from mpas_tpu_torch.cores.atmosphere.physics import cldfra3 as tcld
from mpas_tpu_torch.cores.atmosphere.physics import convection as tconv
from mpas_tpu_torch.cores.atmosphere.physics import driver as tdriver
from mpas_tpu_torch.cores.atmosphere.physics import gf as tgf
from mpas_tpu_torch.cores.atmosphere.physics import gwdo as tgwdo
from mpas_tpu_torch.cores.atmosphere.physics import lsm as tlsm
from mpas_tpu_torch.cores.atmosphere.physics import manager as tman
from mpas_tpu_torch.cores.atmosphere.physics import mynn as tmynn
from mpas_tpu_torch.cores.atmosphere.physics import mynn_sfc as tmynn_sfc
from mpas_tpu_torch.cores.atmosphere.physics import noah as tnoah
from mpas_tpu_torch.cores.atmosphere.physics import radiation as trad
from mpas_tpu_torch.cores.atmosphere.physics import rrtmg as trrtmg
from mpas_tpu_torch.cores.atmosphere.physics import sfclay as tsfclay
from mpas_tpu_torch.cores.atmosphere.physics import tiedtke as ttiedtke
from mpas_tpu_torch.cores.atmosphere.physics import wsm6 as twsm6
from mpas_tpu_torch.cores.atmosphere.physics import ysu as tysu
from mpas_tpu_torch.cores.atmosphere.time_integration import (init_carry,
                                                              srk3_step)
from mpas_tpu_torch.ops import reconstruct as trecon
from mpas_tpu_torch.tools import op_count

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REL_FN = 1e-11
REL_COEF = 1e-13
NC, NZ = 24, 16
DT = 60.0


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


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(x)


def assert_close(got, ref, names=None, rel=REL_FN):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        name = names[i] if names else i
        assert g.shape == r.shape, name
        scale = max(float(np.abs(r).max()), 1e-300)
        assert np.abs(g - r).max() <= rel * scale, name


def assert_dict_close(got, ref):
    assert sorted(got) == sorted(ref)
    keys = sorted(ref)
    assert_close([got[k] for k in keys], [ref[k] for k in keys], keys)


def both(jfn, tfn, args, **static):
    """(port result, reference result) of the same numpy args; the JAX
    function is jitted with `static` closed over."""
    ref = jax.jit(lambda *a: jfn(*a, **static))(*[J(a) for a in args])
    got = tfn(*[T(a) for a in args], **static)
    return got, ref


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _sounding(rng, nc=NC, nz=NZ, t_sfc=300.0, lapse=0.0065, rh=None):
    """Columns to ~16 km: random layer depths, a lapse-rate sounding with
    noise, hydrostatic-like pressure; rh (nc, nz) sets the vapour."""
    dz = rng.uniform(600.0, 1400.0, (nc, nz))
    zgrid = np.concatenate([np.zeros((nc, 1)), np.cumsum(dz, 1)], 1)
    z_mid = 0.5 * (zgrid[:, 1:] + zgrid[:, :-1])
    t = t_sfc + rng.uniform(-3.0, 3.0, (nc, 1)) - lapse * z_mid \
        + 0.3 * rng.standard_normal((nc, nz))
    p = 1.0e5 * np.exp(-z_mid / 8000.0)
    rho = p / (287.0 * t)
    exner = (p / 1.0e5) ** (287.0 / cp)
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    qsat = 0.622 * es / np.maximum(p - es, 100.0)
    if rh is None:
        rh = rng.uniform(0.5, 1.15, (nc, nz))
    return dict(dz=dz, z_mid=z_mid, t=t, p=p, rho=rho, exner=exner,
                th=t / exner, qv=rh * qsat, qsat=qsat,
                u=5.0 + 3.0 * rng.standard_normal((nc, nz)),
                v=2.0 * rng.standard_normal((nc, nz)))


def _species(rng, shape, scale, frac=0.6):
    """Non-negative mixing ratios: a share `frac` of the points hold up to
    `scale`, the rest exactly zero."""
    return np.where(rng.uniform(size=shape) < frac,
                    scale * rng.uniform(size=shape), 0.0)


@pytest.fixture(scope="module")
def cols():
    rng = np.random.default_rng(11)
    c = _sounding(rng)
    shape = (NC, NZ)
    c.update(qc=_species(rng, shape, 2e-3), qr=_species(rng, shape, 2e-3),
             qi=_species(rng, shape, 3e-4), qs=_species(rng, shape, 1e-3),
             qg=_species(rng, shape, 1e-3),
             tsk=c["t"][:, 0] + rng.uniform(-6.0, 6.0, NC))
    # the columns hold warm, frozen and below -40 C levels
    assert (c["t"] > 280.0).any() and (c["t"] < 233.15).any()
    return c


@pytest.fixture(scope="module")
def sfc_in(cols):
    """Inputs of the surface layer at the lowest level; half the columns
    with a warmer, half with a colder surface."""
    c = cols
    return [c["u"][:, 0], c["v"][:, 0], c["th"][:, 0], c["qv"][:, 0],
            c["p"][:, 0], c["rho"][:, 0], c["z_mid"][:, 0], c["tsk"],
            0.8 * c["qsat"][:, 0]]


# ---------------------------------------------------------------------------
# WSM6
# ---------------------------------------------------------------------------

WSM6_OUT = ["th", "qv", "qc", "qr", "qi", "qs", "qg", "rain"]


def test_wsm6(cols):
    c = cols
    args = [c[k] for k in ("th", "qv", "qc", "qr", "qi", "qs", "qg", "rho",
                           "exner", "p", "dz")]
    got, ref = both(jwsm6.wsm6, twsm6.wsm6, args, dt=DT)
    assert_close(got, ref, WSM6_OUT)
    # every species moved and rain reached the ground
    for i in range(2, 7):
        assert not np.array_equal(got[i].numpy(), args[i]), WSM6_OUT[i]
    assert float(got[7].max()) > 0.0


def test_qsat_functions(cols):
    c = cols
    for name in ("_qsat_liq", "_qsat_ice"):
        got, ref = both(getattr(jwsm6, name), getattr(twsm6, name),
                        [c["t"], c["p"]])
        assert_close([got], [ref], [name])


def test_sediment(cols):
    c = cols
    vfall = np.random.default_rng(3).uniform(0.0, 12.0, (NC, NZ))
    got, ref = both(jwsm6._sediment, twsm6._sediment,
                    [c["qr"], c["rho"], c["dz"], vfall], dt=DT)
    assert_close(got, ref, ["q", "sfc"])
    # column mass of the species plus fallout is conserved
    m0 = (c["qr"] * c["rho"] * c["dz"]).sum(1)
    m1 = (got[0].numpy() * c["rho"] * c["dz"]).sum(1) + got[1].numpy()
    assert np.abs(m1 - m0).max() <= 1e-13 * m0.max()


@pytest.fixture(scope="module")
def supercell():
    """The 12x12, 16-level supercell grid and state of both packages with
    six species: seeded cloud and rain, and ice, snow and graupel drawn
    from a seed; u perturbed."""
    cfg = JaxAtmConfig(config_dt=12.0, config_nvertlevels=16,
                       config_len_disp=2000.0, config_xnutr=0.0,
                       config_microp_scheme="mp_wsm6", config_monotonic=True)
    jgrid, jstate, jdiag = jax_init_supercell(
        jax_planar_hex_mesh(12, 12, 2000.0), cfg, case=5)
    rng = np.random.default_rng(5)
    sc = seeded_moisture(jgrid.mesh, jstate.scalars, 7).numpy()
    shape = sc.shape[:2]
    sc6 = np.concatenate([sc, _species(rng, shape, 2e-4)[..., None],
                          _species(rng, shape, 5e-4)[..., None],
                          _species(rng, shape, 5e-4)[..., None]], -1)
    s, d = flatten(jstate), flatten(jdiag)
    s.update(scalars=sc6, u=s["u"] + rng.standard_normal(s["u"].shape))
    return dict(jgrid=jax.tree.map(jnp.asarray, jgrid),
                tgrid=convert.grid_from_arrays(flatten(jgrid)), s=s, d=d,
                jcfg=cfg)


def test_microphysics_step_wsm6(supercell):
    x = supercell
    keys = ("theta_m", "rho_zz", "scalars")
    args = [x["s"][k] for k in keys] + [x["d"]["exner"]]
    ref = jax.jit(lambda *a: jdriver.microphysics_step_wsm6(
        x["jgrid"], *a, DT))(*[J(a) for a in args])
    got = tdriver.microphysics_step_wsm6(x["tgrid"], *[T(a) for a in args],
                                         DT)
    assert_close(got, ref, ["theta_m", "scalars", "rtheta_p", "exner",
                            "pressure_p", "rt_diabatic_tend", "rain"])
    assert float(got[6].max()) > 0.0


# ---------------------------------------------------------------------------
# cloud fraction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cloud_cols():
    """Columns for cal_cldfra3: dry ones without any deck, and moist ones
    whose relative humidity alternates in bands, giving several decks."""
    rng = np.random.default_rng(21)
    lev = np.arange(NZ)[None, :]
    band = (lev // 3) % 2 == 0
    rh = np.where(band, rng.uniform(0.9, 1.02, (NC, NZ)),
                  rng.uniform(0.3, 0.6, (NC, NZ)))
    rh[:6] = rng.uniform(0.1, 0.3, (6, NZ))               # no deck
    c = _sounding(rng, rh=rh)
    shape = (NC, NZ)
    qc = np.where(band & (rng.uniform(size=shape) < 0.2), 2e-6, 0.0)
    qc[:6] = 0.0
    qi = np.where(band & (c["t"] < 250.0)
                  & (rng.uniform(size=shape) < 0.2), 2e-7, 0.0)
    qi[:6] = 0.0
    return dict(c, qc=qc, qi=qi, qs=np.zeros(shape),
                xland=np.where(rng.uniform(size=NC) < 0.5, 1.0, 2.0),
                gridkm=rng.uniform(2.0, 30.0, NC))


def test_cal_cldfra3(cloud_cols):
    c = cloud_cols
    args = [c[k] for k in ("qv", "qc", "qi", "qs", "p", "t", "rho", "dz",
                           "xland", "gridkm")]
    got, ref = both(jcld.cal_cldfra3, tcld.cal_cldfra3, args)
    assert_close(got, ref, ["cldfra", "qc", "qi"])
    cfr = got[0]
    decks = ((cfr >= 0.01) & ~torch.cat([torch.zeros_like(cfr[:, :1],
                                                          dtype=bool),
                                         cfr[:, :-1] >= 0.01], 1)).sum(1)
    assert int(decks[:6].max()) == 0                   # no deck
    assert int(decks.max()) >= 2                       # several decks
    # the seeding added condensate
    assert float((got[1] - T(c["qc"])).max()) > 0.0


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_reductions_keep_identities(op):
    """An empty segment holds the reduction's identity, as JAX's."""
    rng = np.random.default_rng(4)
    seg = np.array([0, 0, 2, 2, 2, 5, 6, 6])
    vals = rng.standard_normal(seg.size)
    jop = {"sum": jax.ops.segment_sum, "min": jax.ops.segment_min,
           "max": jax.ops.segment_max}[op]
    ref = np.asarray(jop(J(vals), J(seg), num_segments=7))
    got = tcld._seg(T(vals), T(seg), 6, {"sum": "sum", "min": "amin",
                                         "max": "amax"}[op]).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert np.abs(got[fin] - ref[fin]).max() <= 1e-15


# ---------------------------------------------------------------------------
# radiation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gmt,day", [(12.0, 172.0), (0.0, 80.0),
                                     (18.5, 355.0)])
def test_cos_zenith(gmt, day):
    rng = np.random.default_rng(6)
    lat = rng.uniform(-1.5, 1.5, 50)
    lon = rng.uniform(0.0, 2 * np.pi, 50)
    got, ref = both(jrad.cos_zenith, trad.cos_zenith, [lat, lon],
                    gmt_hours=gmt, julian_day=day)
    assert_close([got], [ref], ["mu"])


def test_radiation_lw(cols):
    c = cols
    args = [c[k] for k in ("t", "qv", "qc", "rho", "dz", "tsk")]
    got, ref = both(jrad.radiation_lw, trad.radiation_lw, args)
    assert_close(got, ref, ["dtdt", "glw", "olr"])


def test_radiation_sw(cols):
    c = cols
    mu = np.linspace(0.0, 1.0, NC)
    got, ref = both(jrad.radiation_sw, trad.radiation_sw,
                    [c["qv"], c["qc"], c["rho"], c["dz"], mu], albedo=0.25)
    assert_close(got, ref, ["dtdt", "gsw"])


def test_rrtmg_lw(cols):
    c = cols
    args = [c[k] for k in ("t", "qv", "qc", "rho", "dz", "tsk")]
    got, ref = both(jrrtmg.rrtmg_lw, trrtmg.rrtmg_lw, args)
    assert_close(got, ref, ["dtdt", "glw", "olr"])
    assert float(got[1].min()) > 0.0 and float(got[2].min()) > 50.0


@pytest.mark.parametrize("with_t", [False, True])
def test_rrtmg_sw(cols, with_t):
    c = cols
    mu = np.linspace(0.0, 1.0, NC)              # night to overhead sun
    kw = {"t": T(c["t"])} if with_t else {}
    ref = jax.jit(lambda *a: jrrtmg.rrtmg_sw(
        *a[:5], albedo=0.2, t=a[5] if with_t else None))(
        *[J(c[k]) for k in ("qv", "qc", "rho", "dz")], J(mu), J(c["t"]))
    got = trrtmg.rrtmg_sw(*[T(c[k]) for k in ("qv", "qc", "rho", "dz")],
                          T(mu), albedo=0.2, **kw)
    assert_close(got, ref, ["dtdt", "gsw"])
    assert float(got[1][0]) == 0.0 and float(got[1][-1]) > 0.0


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_rrtmg_scaled_tau_per_band(cols, kind):
    """The batched g-points' optical depth equals the reference's band by
    band: _scaled_tau of every band, and the concatenation the scheme
    uses."""
    c = cols
    jt = jrrtmg._tables()
    tt = trrtmg._tables()
    t_exp = f"t_exp_{kind}"
    jpaths, jp = jrrtmg._gas_paths(J(c["t"]), J(c["qv"]), J(c["rho"]),
                                   J(c["dz"]), jrrtmg.CO2_PPV, None)
    tpaths, tp = trrtmg._gas_paths(T(c["t"]), T(c["qv"]), T(c["rho"]),
                                   T(c["dz"]), trrtmg.CO2_PPV, None)
    assert_close([tpaths[k] for k in sorted(jpaths)] + [tp],
                 [jpaths[k] for k in sorted(jpaths)] + [jp])
    refs = []
    for band in jt[kind]:
        k = band["k"]
        gases = trrtmg.gases_present(k)
        got = trrtmg._scaled_tau(tt, tpaths, tp, T(c["t"]), tt[t_exp],
                                 T(k[:, list(gases)]), gases)
        ref = jrrtmg._scaled_tau(jt, jpaths, jp, J(c["t"]), jt[t_exp], k)
        assert_close([got], [ref])
        refs.append(np.asarray(ref))
    gp = trrtmg._g_points(kind, torch.device("cpu"), torch.float64)
    got = trrtmg._scaled_tau(tt, tpaths, tp, T(c["t"]), tt[t_exp], gp["k"],
                             gp["gases"])
    assert_close([got], [np.concatenate(refs, axis=1)])


def test_rrtmg_planck_fractions(cols):
    c = cols
    gp = trrtmg._g_points("lw", torch.device("cpu"), torch.float64)
    got = trrtmg._planck_band_fraction(T(c["t"]), gp["nu_nodes"],
                                       gp["nu_dnu"], gp["nu_w"])
    ref = [jrrtmg._planck_band_fraction(J(c["t"]), *band["nu"])
           for band in jrrtmg._tables()["lw"]]
    assert_close([got], [np.stack(ref, -1)])
    # the bands hold almost all of sigma T^4
    assert 0.9 < float(got.sum(-1).min()) and float(got.sum(-1).max()) < 1.01


def test_rrtmg_table_is_the_reference_copy():
    port = REPO / "mpas_tpu_torch/cores/atmosphere/physics/data/rrtmg_k.npz"
    ref = REPO / "mpas_tpu/cores/atmosphere/physics/data/rrtmg_k.npz"
    assert port.read_bytes() == ref.read_bytes()


# ---------------------------------------------------------------------------
# surface layer, land surface
# ---------------------------------------------------------------------------

def test_sfclay(sfc_in):
    got, ref = both(jsfclay.sfclay, tsfclay.sfclay, sfc_in, z0=0.1)
    assert_dict_close(got, ref)
    zeta = got["zeta"].numpy()
    assert (zeta < 0.0).any() and (zeta > 0.0).any()   # both regimes


def test_surface_moisture_and_slab_lsm(cols):
    c = cols
    got, ref = both(jlsm.surface_moisture, tlsm.surface_moisture,
                    [c["tsk"], c["p"][:, 0]])
    assert_close([got], [ref], ["qsfc"])
    rng = np.random.default_rng(8)
    args = [c["tsk"], c["t"][:, 0], rng.uniform(0.0, 800.0, NC),
            rng.uniform(250.0, 400.0, NC), rng.uniform(-50.0, 200.0, NC),
            rng.uniform(0.0, 300.0, NC)]
    got, ref = both(jlsm.slab_lsm, tlsm.slab_lsm, args, dt=DT)
    assert_close(got, ref, ["tsk", "g_flux"])


def test_lsm_gwdo(cols):
    c = cols
    rng = np.random.default_rng(9)
    args = [c["u"], c["v"], c["rho"], c["dz"], rng.uniform(0.005, 0.02, NC),
            rng.uniform(0.0, 400.0, NC)]
    got, ref = both(jlsm.gwdo, tlsm.gwdo, args, dt=DT)
    assert_close(got, ref, ["u", "v"])


@pytest.fixture(scope="module")
def land(cols):
    """Noah inputs: soil columns, snow on a third of the cells, surface
    fluxes and radiation."""
    rng = np.random.default_rng(10)
    swe = np.where(rng.uniform(size=NC) < 0.33, rng.uniform(0.0, 0.05, NC),
                   0.0)
    return dict(tsk=cols["tsk"],
                tslb=cols["tsk"][:, None] + rng.uniform(-4, 4, (NC, 4)),
                smois=rng.uniform(0.05, 0.42, (NC, 4)), swe=swe,
                gsw=rng.uniform(0.0, 800.0, NC),
                glw=rng.uniform(250.0, 400.0, NC),
                hfx=rng.uniform(-50.0, 200.0, NC),
                lh=rng.uniform(-20.0, 300.0, NC),
                precip=rng.uniform(0.0, 1e-5, NC),
                isltyp=rng.integers(1, 20, NC),
                ivgtyp=rng.integers(1, 25, NC))


@pytest.mark.parametrize("tables", ["defaults", "soil", "soil_and_veg"])
def test_noah_lsm(land, tables):
    x = land
    args = [x[k] for k in ("tsk", "tslb", "smois", "swe", "gsw", "glw",
                           "hfx", "lh", "precip")]
    kw = {}
    if tables != "defaults":
        kw["isltyp"] = x["isltyp"]
    if tables == "soil_and_veg":
        kw["ivgtyp"] = x["ivgtyp"]
    ref = jax.jit(lambda *a: jnoah.noah_lsm(*a, DT, **{
        k: J(v) for k, v in kw.items()}))(*[J(a) for a in args])
    got = tnoah.noah_lsm(*[T(a) for a in args], DT,
                         **{k: T(v) for k, v in kw.items()})
    assert_dict_close(got, ref)


@pytest.mark.parametrize("which", ["noah_seaice", "noah_glacial"])
def test_noah_ice_surfaces(land, which):
    x = land
    args = [x[k] for k in ("tsk", "tslb", "swe", "gsw", "glw", "hfx", "lh")]
    got, ref = both(getattr(jnoah, which), getattr(tnoah, which), args,
                    dt=DT)
    assert_dict_close(got, ref)


def test_noah_surface_moisture(land, cols):
    beta = np.linspace(0.0, 1.0, NC)
    got, ref = both(jnoah.noah_surface_moisture, tnoah.noah_surface_moisture,
                    [land["tsk"], cols["p"][:, 0], beta])
    assert_close([got], [ref])


# ---------------------------------------------------------------------------
# PBL, orographic drag, convection
# ---------------------------------------------------------------------------

def test_ysu(cols, sfc_in):
    c = cols
    sfc = {k: np.asarray(v) for k, v in jax.jit(
        lambda *a: jsfclay.sfclay(*a, 0.1))(*[J(a) for a in sfc_in]).items()}
    args = [c[k] for k in ("u", "v", "th", "qv", "rho", "z_mid", "dz")]
    ref = jax.jit(lambda s, *a: jysu.ysu(*a, s, DT))(
        {k: J(v) for k, v in sfc.items()}, *[J(a) for a in args])
    got = tysu.ysu(*[T(a) for a in args], {k: T(v) for k, v in sfc.items()},
                   DT)
    assert_close(got, ref, ["u", "v", "th", "qv", "hpbl"])


@pytest.mark.parametrize("statics", ["fallback", "given"])
def test_gwdo(cols, statics):
    c = cols
    rng = np.random.default_rng(12)
    if statics == "fallback":
        var2d = np.full(NC, 100.0)
        oc1 = np.ones(NC)
        oa4 = np.zeros((NC, 4))
        ol4 = np.full((NC, 4), 0.5)
    else:
        var2d = rng.uniform(0.0, 600.0, NC)
        oc1 = rng.uniform(0.0, 3.0, NC)
        oa4 = rng.uniform(-1.0, 1.0, (NC, 4))
        ol4 = rng.uniform(0.0, 1.0, (NC, 4))
    dx = rng.uniform(2000.0, 30000.0, NC)
    args = [c[k] for k in ("u", "v", "t", "qv", "p", "z_mid", "dz")] \
        + [var2d, oc1, oa4, ol4, dx]
    got, ref = both(jgwdo.gwdo, tgwdo.gwdo, args, dt=DT)
    assert_close(got, ref, ["dudt", "dvdt", "dusfc", "dvsfc"])
    assert float(got[0].abs().max()) > 0.0           # the drag acts


@pytest.mark.parametrize("regime", ["convecting", "stable"])
def test_tiedtke(regime):
    rng = np.random.default_rng(13)
    if regime == "convecting":
        c = _sounding(rng, t_sfc=303.0, lapse=0.0085,
                      rh=rng.uniform(0.85, 1.0, (NC, NZ)))
    else:
        c = _sounding(rng, t_sfc=285.0, lapse=0.003,
                      rh=rng.uniform(0.2, 0.4, (NC, NZ)))
    args = [c[k] for k in ("th", "qv", "p", "rho", "z_mid", "dz", "exner")]
    got, ref = both(jtiedtke.tiedtke, ttiedtke.tiedtke, args, dt=DT)
    assert_close(got, ref, ["th", "qv", "rain", "cape"])
    rain = got[2].numpy()
    if regime == "convecting":
        assert (rain > 0.0).all()
    else:
        assert (rain == 0.0).all()


# ---------------------------------------------------------------------------
# wind reconstruction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["plane", "sphere"])
def recon_mesh(request):
    if request.param == "plane":
        jm = jax_planar_hex_mesh(12, 12, 2000.0)
    else:
        jm = jax_icosahedral_mesh(4, lloyd_iters=1)
    return jm, convert.mesh_from_arrays(flatten(jm))


def test_build_reconstruct_coeffs(recon_mesh):
    jm, tm = recon_mesh
    ref = jrecon.build_reconstruct_coeffs(jm)
    got = trecon.build_reconstruct_coeffs(tm)
    assert_close([got], [ref], rel=REL_COEF)


def test_reconstruct(recon_mesh):
    jm, tm = recon_mesh
    coeffs = jrecon.build_reconstruct_coeffs(jm)
    u = np.random.default_rng(14).standard_normal((jm.nEdges, 5))
    ref = jrecon.reconstruct(jm, J(coeffs), J(u))
    got = trecon.reconstruct(tm, T(coeffs), T(u))
    assert_close(got, ref, ["vx", "vy", "vz", "zonal", "meridional"])


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", [
    dict(), dict(lsm_scheme="noah"), dict(pbl_scheme="mynn"),
    dict(tsk0=300.0, lsm_scheme="noah", pbl_scheme="mynn")])
def test_init_physics_state(variant):
    ref = flatten(jman.init_physics_state(30, 7, **variant))
    got = tman.init_physics_state(30, 7, device="cpu", **variant)
    for f in dataclasses.fields(got):
        v, r = getattr(got, f.name), ref[f.name]
        assert (v is None) == (r is None), f.name
        if v is not None:
            assert v.dtype == torch.float64, f.name
            assert np.array_equal(v.numpy(), r), f.name


RESOLVE_CASES = {
    "mesoscale_reference": dict(config_physics_suite="mesoscale_reference",
                                **{k: "suite" for k in tman.SCHEME_FIELDS}),
    "convection_permitting": dict(
        config_physics_suite="convection_permitting",
        config_microp_scheme="suite", config_conv_scheme="suite",
        config_pbl_scheme="suite", config_sfclay_scheme="suite"),
    "explicit_wins": dict(config_physics_suite="mesoscale_reference",
                          config_microp_scheme="thompson",
                          config_conv_scheme="suite"),
    "none": dict(config_physics_suite="none", config_microp_scheme="suite",
                 config_pbl_scheme="suite"),
    "idempotent": dict(config_physics_suite="mesoscale_reference",
                       config_microp_scheme="suite"),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES) + ["unknown"])
def test_resolve_suite(case):
    """The cases of tests/test_physics_suite.py."""
    if case == "unknown":
        with pytest.raises(ValueError, match="Unrecognized"):
            tman.resolve_suite(tman.PhysicsConfig(
                config_physics_suite="cloud_resolving_2099"))
        return
    kw = RESOLVE_CASES[case]
    got = tman.resolve_suite(tman.PhysicsConfig(**kw))
    ref = jman.resolve_suite(jman.PhysicsConfig(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tman.resolve_suite(got)) \
        == dataclasses.asdict(got)
    if case == "mesoscale_reference":
        assert (got.config_microp_scheme, got.config_conv_scheme,
                got.config_pbl_scheme, got.config_gwdo_scheme,
                got.config_radiation_scheme, got.config_cldfra_scheme,
                got.config_sfclay_scheme, got.config_lsm_scheme) == (
            "wsm6", "tiedtke", "ysu", "on", "kdist", "cldfra3", "mm5",
            "noah")


MESOREF = dict(config_physics_suite="mesoscale_reference",
               **{k: "suite" for k in tman.SCHEME_FIELDS})
STEP_CASES = {
    "mesoscale_reference": (MESOREF, dict(lsm_scheme="noah"), None),
    "tiedtke_broadband_slab": (dict(config_conv_scheme="tiedtke"), {},
                               None),
    "ice_surfaces": (MESOREF, dict(lsm_scheme="noah"), "ice"),
    "radiation_not_due": (MESOREF, dict(lsm_scheme="noah"), "not_due"),
}


def _physics_states(nc, nz, init_kw, extra):
    """The same PhysicsState for both packages: init_physics_state, then
    a perturbed surface, and the variant's sea ice / glaciers or a recent
    radiation call (cached tendencies, time_since_rad < the interval)."""
    ph = flatten(jman.init_physics_state(nc, nz, **init_kw))
    rng = np.random.default_rng(15)
    ph["tsk"] = ph["tsk"] + rng.uniform(-5.0, 5.0, nc)
    if ph["smois"] is not None:
        ph["smois"] = rng.uniform(0.05, 0.42, (nc, 4))
        ph["swe"] = np.where(rng.uniform(size=nc) < 0.3, 0.01, 0.0)
    if extra == "ice":
        ph["xice"] = np.where(rng.uniform(size=nc) < 0.4,
                              rng.uniform(0.0, 1.0, nc), 0.0)
        ph["isice"] = np.where(rng.uniform(size=nc) < 0.3, 1.0, 0.0)
    if extra == "not_due":
        ph["time_since_rad"] = np.asarray(600.0)
        ph["rad_tend"] = 1e-5 * rng.standard_normal((nc, nz))
        ph["glw"] = rng.uniform(250.0, 400.0, nc)
        ph["gsw"] = rng.uniform(0.0, 800.0, nc)
    jph = jman.PhysicsState(**{k: None if v is None else J(v)
                               for k, v in ph.items()})
    return jph, convert.physics_state_from_arrays(ph)


_JAX_STEPS = {}


def _jax_physics_step(grid, cfg):
    """The reference's physics_step jitted once per config (the radiation
    alarm's two cases share one compile)."""
    if cfg not in _JAX_STEPS:
        _JAX_STEPS[cfg] = jax.jit(lambda s, d, ph, coeffs: jman.physics_step(
            grid, cfg, grid.mesh, coeffs, s, d, ph, 12.0))
    return _JAX_STEPS[cfg]


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_physics_step(supercell, case):
    x = supercell
    kw, init_kw, extra = STEP_CASES[case]
    jp = jman.PhysicsConfig(**kw)
    tp = tman.PhysicsConfig(**kw)
    nc, nz = x["s"]["theta_m"].shape
    jph, tph = _physics_states(nc, nz, init_kw, extra)
    coeffs = jrecon.build_reconstruct_coeffs(x["jgrid"].mesh)
    js = jax.tree.map(J, x["s"])
    jd = jax.tree.map(J, x["d"])
    ref = _jax_physics_step(x["jgrid"], jp)(
        AtmState(**js), AtmDiag(**jd), jph, J(coeffs))
    got = tman.physics_step(
        x["tgrid"], tp, x["tgrid"].mesh, T(coeffs),
        convert.state_from_arrays(x["s"]), convert.diag_from_arrays(x["d"]),
        tph, 12.0)
    assert_close(got[:3], ref[:3], ["theta_m", "scalars", "u"])
    rp = flatten(ref[3])
    for f in dataclasses.fields(got[3]):
        v = getattr(got[3], f.name)
        assert (v is None) == (rp[f.name] is None), f.name
        if v is not None:
            assert_close([v], [rp[f.name]], [f.name])
    tsr = float(got[3].time_since_rad)
    assert tsr == (612.0 if case == "radiation_not_due" else 12.0)
    if case == "radiation_not_due":
        assert torch.equal(got[3].rad_tend, tph.rad_tend)
    else:
        assert float(got[3].glw.min()) > 0.0


# the swapped scheme's module of the port, its function called by
# physics_step, and the reference's module (None: not compiled here)
SWAPPED = {"kfeta.py": (tconv, "kf_convection_full", None),
           "gf.py": (tgf, "gf_convection", jgf),
           "mynn.py": (tmynn, "mynn", jmynn),
           "mynn_sfc.py": (tmynn_sfc, "mynn_sfclay", jmynn_sfc)}


def _reference_on(jfn, args, kwargs):
    """jfn jitted on the tensors of a recorded port call (args, kwargs),
    its Python numbers closed over."""
    leaves, tree = jax.tree.flatten((args, kwargs))
    is_t = [isinstance(v, torch.Tensor) for v in leaves]

    def call(*arrays):
        it = iter(arrays)
        a, k = jax.tree.unflatten(tree, [next(it) if t else v
                                         for v, t in zip(leaves, is_t)])
        return jfn(*a, **k)
    return jax.jit(call)(*[J(v.numpy()) for v, t in zip(leaves, is_t) if t])


@pytest.mark.parametrize("field,value,module", [
    ("config_radiation_scheme", "cam", "cam_radiation.py"),
    ("config_conv_scheme", "kf", "kfeta.py"),
    ("config_conv_scheme", "grell_freitas", "gf.py"),
    ("config_pbl_scheme", "mynn", "mynn.py"),
    ("config_sfclay_scheme", "mynn", "mynn_sfc.py")])
def test_physics_step_refuses_unported_schemes(supercell, field, value,
                                               module):
    """The mesoscale_reference suite with one scheme swapped; every scheme
    is ported and runs. CAM radiation gets the inputs RRTMG gets in the
    suite, and its tendencies and surface fluxes are what physics_step
    keeps (CAM against its JAX twin, alone and within the reference's
    physics_step: tests/test_torch_cam.py, test_torch_cam_slice.py). For
    the other schemes (Kain-Fritsch, Grell-Freitas, the MYNN PBL and
    surface layer) radiation, which comes before each, is the suite's bit
    for bit, and the swapped scheme's call inside physics_step matches its
    JAX twin on the same inputs. Kain-Fritsch's twin (a ~25-s compile) is
    held in tests/test_torch_kf.py and test_torch_kf_slice.py; here its
    inputs and its coupling back are checked. Each scheme within the
    reference's physics_step: tests/test_torch_convperm.py and
    test_torch_kf_slice.py."""
    x = supercell
    kw = dict(MESOREF, **{field: value})
    init_kw = dict(lsm_scheme="noah")
    if kw["config_pbl_scheme"] == "mynn":
        init_kw["pbl_scheme"] = "mynn"
    _, tph = _physics_states(144, 16, init_kw, None)
    # resolved w from a seed (the start is at rest), zero at the ground
    # and the lid, so that Kain-Fritsch triggers
    w = np.random.default_rng(16).uniform(-1.0, 3.0, x["s"]["w"].shape)
    w[:, [0, -1]] = 0.0
    state = dataclasses.replace(convert.state_from_arrays(x["s"]), w=T(w))
    coeffs = T(jrecon.build_reconstruct_coeffs(x["jgrid"].mesh))

    def step(**swap):
        return tman.physics_step(
            x["tgrid"], tman.PhysicsConfig(**dict(MESOREF, **swap)),
            x["tgrid"].mesh, coeffs, state, convert.diag_from_arrays(x["d"]),
            tph, 12.0)
    if value == "cam":
        calls = {}

        def record(mod, name):
            fn = getattr(mod, name)

            def recorded(*a, **k):
                calls[name] = (a, k, fn(*a, **k))
                return calls[name][2]
            return mock.patch.object(mod, name, recorded)
        with record(tcam, "cam_lw"), record(tcam, "cam_sw"):
            got = step(**{field: value})
        with record(trrtmg, "rrtmg_lw"), record(trrtmg, "rrtmg_sw"):
            step()
        for cam, rrtmg in (("cam_lw", "rrtmg_lw"), ("cam_sw", "rrtmg_sw")):
            a, b = calls[cam][0], calls[rrtmg][0]
            assert len(a) == len(b)
            for x_, y_ in zip(a, b):
                assert x_ == y_ if isinstance(y_, float) \
                    else torch.equal(x_, y_)
        (lw, glw, _), (sw, gsw) = calls["cam_lw"][2], calls["cam_sw"][2]
        assert torch.equal(calls["cam_sw"][1]["t"], calls["cam_lw"][0][0])
        assert torch.equal(got[3].rad_tend, lw + sw)
        assert torch.equal(got[3].glw, glw) and torch.equal(got[3].gsw, gsw)
        assert float(glw.min()) > 0.0
        return
    mod, name, jmod = SWAPPED[module]
    fn = getattr(mod, name)
    calls = []

    def recorded(*a, **k):
        calls.append((a, k, fn(*a, **k)))
        return calls[-1][2]
    with mock.patch.object(mod, name, recorded):
        got = step(**{field: value})
    base = step()
    assert len(calls) == 1
    for f in ("glw", "gsw", "rad_tend", "time_since_rad"):
        assert torch.equal(getattr(got[3], f), getattr(base[3], f)), f
    for v in (*got[:3], *dataclasses.astuple(got[3])):
        assert v is None or bool(torch.isfinite(v).all())
    a, k, out = calls[0]
    if jmod is not None:
        ref = _reference_on(getattr(jmod, name), a, k)
        if isinstance(ref, dict):
            assert sorted(out) == sorted({*ref, "cd"} if name == "mynn_sfclay"
                                         else ref)
            out, ref = [out[n] for n in sorted(ref)], \
                [ref[n] for n in sorted(ref)]
        assert_close(list(out), list(ref))
        return
    # Kain-Fritsch: fed as op_count.kf_eta_inputs derives its inputs from
    # the state (w at the layer midpoints, the cell winds, dx), but th and
    # qv, handed on after radiation and the PBL; th and qv, the detrained
    # cloud water and the rain coupled back as the reference couples them
    a2, k2 = op_count.kf_eta_inputs(x["tgrid"], state,
                                    convert.diag_from_arrays(x["d"]), coeffs)
    for i, (g, w) in enumerate(zip(
            (*a[2:7], *[k[n] for n in ("w0avg", "u", "v", "dx")]),
            (*a2[2:], *[k2[n] for n in ("w0avg", "u", "v", "dx")]))):
        assert torch.equal(g, w), i
    assert float(out["ainc"].max()) > 0.0
    assert float(out["qc_detr"].max()) > 0.0
    assert torch.equal(got[0], out["th"] * (1.0 + rvord * out["qv"]))
    assert torch.equal(got[1][..., 0], out["qv"])
    assert torch.equal(got[1][..., 1], state.scalars[..., 1] + out["qc_detr"])
    assert torch.equal(got[3].rainc, tph.rainc + out["raincv_m"])


def test_rrtmg_refuses_an_ozone_profile(cols):
    """An ozone profile (o3_vmr) replaces the fixed column proxy with its
    path (physics/o3.py), as in the reference; with the o3 climatology:
    tests/test_torch_cam.py."""
    c = cols
    args = [c[k] for k in ("t", "qv", "qc", "rho", "dz", "tsk")] + [
        np.full((NC, NZ), 1e-7)]
    ref = jax.jit(lambda *a: jrrtmg.rrtmg_lw(*a[:6], o3_vmr=a[6]))(
        *[J(a) for a in args])
    got = trrtmg.rrtmg_lw(*[T(a) for a in args[:6]], o3_vmr=T(args[6]))
    assert_close(got, ref, ["dtdt", "glw", "olr"])


@pytest.mark.parametrize("scheme,nsc,error", [
    ("mp_wsm6", 3, ValueError), ("mp_thompson", 6, ValueError),
    ("mp_thompson", 8, None)])
def test_srk3_step_scalar_checks(supercell, scheme, nsc, error):
    """The reference's scalar-count ValueErrors; Thompson with its eight
    scalars runs (against the reference in tests/test_torch_convperm.py),
    its numbers kept in [1e-2, 1e8]."""
    x = supercell
    cfg = AtmConfig(config_dt=12.0, config_nvertlevels=16,
                    config_len_disp=2000.0, config_xnutr=0.0,
                    config_microp_scheme=scheme)
    sc = x["s"]["scalars"]
    sc = np.concatenate([sc, np.zeros(sc.shape[:2] + (2,))], -1)[..., :nsc]
    state = dataclasses.replace(convert.state_from_arrays(x["s"]),
                                scalars=T(sc))
    carry = init_carry(x["tgrid"], cfg, state,
                       convert.diag_from_arrays(x["d"]), 12.0)
    if error is None:
        out = srk3_step(x["tgrid"], cfg, carry, 12.0)
        sc = out.state.scalars
        assert bool(torch.isfinite(sc).all())
        assert float(sc[..., 6:].min()) >= 1e-2
        assert float(sc[..., 6:].max()) <= 1e8
        assert float(out.rainnc.min()) >= 0.0
        return
    with pytest.raises(error):
        srk3_step(x["tgrid"], cfg, carry, 12.0)


def test_manager_does_not_load_the_distributed_runner():
    """The column physics takes its default device from containers, not
    from the sharded runner."""
    code = ("import sys\n"
            "import mpas_tpu_torch.cores.atmosphere.hooks\n"
            "sys.exit('mpas_tpu_torch.parallel.runner' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
