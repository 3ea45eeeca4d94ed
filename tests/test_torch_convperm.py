"""The port's convection_permitting suite (Thompson in the dycore, the MYNN
surface layer and PBL, Grell-Freitas) against the JAX package, in float64
on the CPU.

Inputs are made with numpy from seeds and handed to both packages: columns
of 24 cells x 16 levels (a 16-km sounding with warm and frozen levels,
hydrometeors, rain and ice numbers across their bounds, winds) and the
144-cell, 16-level supercell grid of tests/test_torch_mesoref_slice.py with
eight species (qv, qc, qr seeded, seed 7; qi, qs, qg drawn from a seed; nr
and ni at 1e-2 as tests/test_atm_scheme_variants.py widens the state).

The reference's MYNN PBL reads the drag coefficient sfc["cd"], which its
MYNN surface layer does not return, so its physics_step raises KeyError
under the convection_permitting suite. The port's mynn_sfclay adds
cd = (ust / wspd)^2; here the reference's mynn_sfclay is wrapped to add
the same, so that the two packages' suites can be compared at all.

Bounds:
- every function: 1e-11 x max|ref| per output;
- physics_step: 1e-11 x max|ref| per field.
tests/test_torch_convperm_slice.py couples the suite to the dycore.
"""

import contextlib
import dataclasses
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import time_integration as jti
from mpas_tpu.cores.atmosphere.config import AtmConfig as JaxAtmConfig
from mpas_tpu.cores.atmosphere.init_supercell import \
    init_supercell as jax_init_supercell
from mpas_tpu.cores.atmosphere.physics import driver as jdriver
from mpas_tpu.cores.atmosphere.physics import gf as jgf
from mpas_tpu.cores.atmosphere.physics import manager as jman
from mpas_tpu.cores.atmosphere.physics import mynn as jmynn
from mpas_tpu.cores.atmosphere.physics import mynn_sfc as jmynn_sfc
from mpas_tpu.cores.atmosphere.physics import thompson as jthompson
from mpas_tpu.mesh.planar import planar_hex_mesh as jax_planar_hex_mesh
from mpas_tpu.ops import reconstruct as jrecon
from mpas_tpu_torch import convert
from mpas_tpu_torch.constants import cp
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
from mpas_tpu_torch.cores.atmosphere.physics import driver as tdriver
from mpas_tpu_torch.cores.atmosphere.physics import gf as tgf
from mpas_tpu_torch.cores.atmosphere.physics import manager as tman
from mpas_tpu_torch.cores.atmosphere.physics import mynn as tmynn
from mpas_tpu_torch.cores.atmosphere.physics import mynn_sfc as tmynn_sfc
from mpas_tpu_torch.cores.atmosphere.physics import thompson as tthompson

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REL_FN = 1e-11
NC, NZ = 24, 16
DT = 60.0
DT_DYN = 12.0
GMT = 7.0          # chip_smoke.py's MESOREF_GMT: the Noah surface settles
CFG = dict(config_dt=DT_DYN, config_nvertlevels=16, config_len_disp=2000.0,
           config_xnutr=0.0, config_microp_scheme="mp_thompson",
           config_monotonic=True)
CONVPERM = dict(config_physics_suite="convection_permitting",
                **{k: "suite" for k in tman.SCHEME_FIELDS})
THOMPSON_OUT = ["th", "qv", "qc", "qr", "qi", "qs", "qg", "nr", "ni",
                "rain"]


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
    """Each output to rel x max|ref|; the eight scalars as the six species
    and the two numbers, each part at its own scale."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        name = names[i] if names else i
        assert g.shape == r.shape, name
        parts = [(name, g, r)]
        if name == "scalars":
            parts = [("species", g[..., :6], r[..., :6]),
                     ("numbers", g[..., 6:], r[..., 6:])]
        for part, gp, rp in parts:
            scale = max(float(np.abs(rp).max()), 1e-300)
            assert np.abs(gp - rp).max() <= rel * scale, part


def both(jfn, tfn, args, **static):
    """(port result, reference result) of the same numpy args; the JAX
    function is jitted with `static` closed over."""
    ref = jax.jit(lambda *a: jfn(*a, **static))(*[J(a) for a in args])
    got = tfn(*[T(a) for a in args], **static)
    return got, ref


def with_cd(out):
    """A surface-layer dict with the drag coefficient the MYNN PBL reads."""
    return dict(out, cd=(out["ust"] / out["wspd"]) ** 2)


@contextlib.contextmanager
def reference_mynn_sfclay_with_cd():
    """The reference's mynn_sfclay, wrapped to return cd as the port's
    does, while a reference physics_step is traced."""
    fn = jmynn_sfc.mynn_sfclay
    with mock.patch.object(jmynn_sfc, "mynn_sfclay",
                           lambda *a, **k: with_cd(fn(*a, **k))):
        yield


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
    rng = np.random.default_rng(31)
    c = _sounding(rng)
    shape = (NC, NZ)
    c.update(qc=_species(rng, shape, 2e-3), qr=_species(rng, shape, 2e-3),
             qi=_species(rng, shape, 3e-4), qs=_species(rng, shape, 1e-3),
             qg=_species(rng, shape, 1e-3),
             # numbers from below to above their [1e-2, 1e8] bounds
             nr=10.0 ** rng.uniform(-3.0, 8.5, shape),
             ni=10.0 ** rng.uniform(-3.0, 8.5, shape),
             tsk=c["t"][:, 0] + rng.uniform(-6.0, 6.0, NC),
             qke=rng.uniform(1e-4, 3.0, shape))
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
# Thompson
# ---------------------------------------------------------------------------

def test_thompson(cols):
    c = cols
    args = [c[k] for k in ("th", "qv", "qc", "qr", "qi", "qs", "qg", "nr",
                           "ni", "rho", "exner", "p", "dz")]
    got, ref = both(jthompson.thompson, tthompson.thompson, args, dt=DT)
    assert_close(got, ref, THOMPSON_OUT)
    # every species and number moved, the numbers are back in bounds and
    # precipitation reached the ground
    for i in range(2, 9):
        assert not np.array_equal(got[i].numpy(), args[i]), THOMPSON_OUT[i]
    for i in (7, 8):
        assert float(got[i].min()) >= 1e-2 and float(got[i].max()) <= 1e8
    assert float(got[9].max()) > 0.0


@pytest.mark.parametrize("where", ["inside", "below", "above", "nodes"])
def test_interp_matches_jnp_interp(where):
    """The port's interpolation on torch.searchsorted against jnp.interp,
    between the nodes, outside the grid (the end values) and on them."""
    rng = np.random.default_rng(32)
    xp = np.cumsum(rng.uniform(0.1, 1.0, 40))
    fp = rng.standard_normal(40)
    x = {"inside": rng.uniform(xp[0], xp[-1], 500),
         "below": xp[0] - rng.uniform(0.0, 5.0, 50),
         "above": xp[-1] + rng.uniform(0.0, 5.0, 50),
         "nodes": xp}[where]
    got = tthompson._interp(T(x), T(xp), T(fp)).numpy()
    ref = np.asarray(jnp.interp(J(x), J(xp), J(fp)))
    assert np.abs(got - ref).max() <= 1e-15 * np.abs(fp).max()


def test_thompson_table_is_the_reference_copy():
    port = REPO / "mpas_tpu_torch/cores/atmosphere/physics/data/thompson_k.npz"
    ref = REPO / "mpas_tpu/cores/atmosphere/physics/data/thompson_k.npz"
    assert port.read_bytes() == ref.read_bytes()


def test_thompson_tables_are_cached_per_device_and_dtype():
    a = tthompson._tables(torch.device("cpu"), torch.float64)
    assert tthompson._tables(torch.device("cpu"), torch.float64) is a
    b = tthompson._tables(torch.device("cpu"), torch.float32)
    assert b["vr_mass"][1].dtype == torch.float32


# ---------------------------------------------------------------------------
# the supercell with eight species
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def supercell():
    """Both packages' 12x12, 16-level supercell with eight species: the
    seeded cloud and rain, qi/qs/qg from a seed, nr and ni at 1e-2; u
    perturbed. Also the reference's initial carry."""
    jcfg = JaxAtmConfig(**CFG)
    jgrid, jstate, jdiag = jax_init_supercell(
        jax_planar_hex_mesh(12, 12, 2000.0), jcfg, case=5)
    rng = np.random.default_rng(33)
    sc = seeded_moisture(jgrid.mesh, jstate.scalars, 7).numpy()
    shape = sc.shape[:2]
    sc8 = np.concatenate([sc, _species(rng, shape, 2e-4)[..., None],
                          _species(rng, shape, 5e-4)[..., None],
                          _species(rng, shape, 5e-4)[..., None],
                          np.full(shape + (2,), 1e-2)], -1)
    s, d = flatten(jstate), flatten(jdiag)
    s.update(scalars=sc8, u=s["u"] + rng.standard_normal(s["u"].shape))
    gj = jax.tree.map(jnp.asarray, jgrid)
    jcarry = jti.init_carry(gj, jcfg, jstate.replace(**{
        k: J(v) for k, v in s.items()}), jax.tree.map(J, jdiag), DT_DYN)
    return dict(gj=gj, jcfg=jcfg, jcarry=jcarry, s=s, d=d,
                tgrid=convert.grid_from_arrays(flatten(jgrid)),
                carry=convert.carry_from_arrays(flatten(jcarry)),
                cfg=AtmConfig(**CFG),
                coeffs=jrecon.build_reconstruct_coeffs(gj.mesh))


def test_microphysics_step_thompson(supercell):
    x = supercell
    args = [x["s"][k] for k in ("theta_m", "rho_zz", "scalars")] \
        + [x["d"]["exner"]]
    ref = jax.jit(lambda *a: jdriver.microphysics_step_thompson(
        x["gj"], *a, DT))(*[J(a) for a in args])
    got = tdriver.microphysics_step_thompson(x["tgrid"],
                                             *[T(a) for a in args], DT)
    assert_close(got, ref, ["theta_m", "scalars", "rtheta_p", "exner",
                            "pressure_p", "rt_diabatic_tend", "rain"])
    assert float(got[6].max()) > 0.0


# ---------------------------------------------------------------------------
# MYNN surface layer and PBL, Grell-Freitas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("surface", ["land", "water", "mixed_ice"])
def test_mynn_sfclay(sfc_in, surface):
    """Land, water, and land, water and snow/ice columns mixed: every
    roughness closure. The port's extra cd is (ust / wspd)^2."""
    rng = np.random.default_rng(34)
    kw = {}
    if surface == "water":
        kw["xland"] = np.full(NC, 2.0)
    elif surface == "mixed_ice":
        kw["xland"] = np.where(rng.uniform(size=NC) < 0.5, 1.0, 2.0)
        kw["snowice"] = rng.uniform(size=NC) < 0.4
    ref = jax.jit(lambda *a, **k: jmynn_sfc.mynn_sfclay(*a, **k))(
        *[J(a) for a in sfc_in], **{k: J(v) for k, v in kw.items()})
    got = tmynn_sfc.mynn_sfclay(*[T(a) for a in sfc_in],
                                **{k: T(v) for k, v in kw.items()})
    assert sorted(got) == sorted([*ref, "cd"])
    keys = sorted(ref)
    assert_close([got[k] for k in keys], [ref[k] for k in keys], keys)
    assert torch.equal(got["cd"], (got["ust"] / got["wspd"]) ** 2)
    br = got["br"].numpy()
    assert (br < 0.0).any() and (br > 0.0).any()     # both regimes


def test_mynn(cols, sfc_in):
    c = cols
    sfc = with_cd({k: np.asarray(v) for k, v in jax.jit(
        jmynn_sfc.mynn_sfclay)(*[J(a) for a in sfc_in]).items()})
    args = [c[k] for k in ("u", "v", "th", "qv", "rho", "z_mid", "dz")]
    ref = jax.jit(lambda s, q, *a: jmynn.mynn(*a, s, q, DT))(
        {k: J(v) for k, v in sfc.items()}, J(c["qke"]),
        *[J(a) for a in args])
    got = tmynn.mynn(*[T(a) for a in args], {k: T(v) for k, v in sfc.items()},
                     T(c["qke"]), DT)
    assert_close(got, ref, ["u", "v", "th", "qv", "hpbl", "qke"])
    qke = got[5].numpy()
    assert qke.min() >= 1e-4 and qke.max() <= 150.0
    assert not np.array_equal(qke, c["qke"])


@pytest.mark.parametrize("variant", ["convecting", "stable", "dx_cells",
                                     "w_star_ccn"])
def test_gf_convection(variant):
    """Deep and shallow convection in a moist unstable sounding, none in a
    dry stable one; per-cell dx, and the optional w* and CCN inputs."""
    rng = np.random.default_rng(35)
    if variant == "stable":
        c = _sounding(rng, t_sfc=285.0, lapse=0.003,
                      rh=rng.uniform(0.2, 0.4, (NC, NZ)))
    else:
        c = _sounding(rng, t_sfc=303.0, lapse=0.0085,
                      rh=rng.uniform(0.85, 1.0, (NC, NZ)))
    args = [c[k] for k in ("th", "qv", "p", "rho", "z_mid", "dz", "exner")]
    kw = {}
    if variant == "dx_cells":
        kw["dx"] = rng.uniform(2000.0, 30000.0, NC)
    elif variant == "w_star_ccn":
        kw["w_star"] = rng.uniform(0.0, 3.0, NC)
        kw["ccn"] = rng.uniform(5.0, 2000.0, NC)
    ref = jax.jit(lambda *a, **k: jgf.gf_convection(*a, DT, **k))(
        *[J(a) for a in args], **{k: J(v) for k, v in kw.items()})
    got = tgf.gf_convection(*[T(a) for a in args], DT,
                            **{k: T(v) for k, v in kw.items()})
    assert_close(got, ref, ["th", "qv", "qc_detr", "rain", "cape"])
    rain = got[3].numpy()
    if variant == "stable":
        assert (rain == 0.0).all()
    else:
        assert (rain > 0.0).sum() >= NC // 2
        assert float(got[2].max()) > 0.0


# ---------------------------------------------------------------------------
# physics_step and the coupled loop
# ---------------------------------------------------------------------------

def _physics_states(nc, nz, init_kw):
    """The same PhysicsState for both packages: init_physics_state with a
    perturbed skin temperature and soil moisture."""
    ph = flatten(jman.init_physics_state(nc, nz, **init_kw))
    rng = np.random.default_rng(36)
    ph["tsk"] = ph["tsk"] + rng.uniform(-5.0, 5.0, nc)
    if ph["smois"] is not None:
        ph["smois"] = rng.uniform(0.05, 0.42, (nc, 4))
    jph = jman.PhysicsState(**{k: None if v is None else J(v)
                               for k, v in ph.items()})
    return jph, convert.physics_state_from_arrays(ph)


_JAX_STEPS = {}


def _jax_physics_step(x, cfg):
    """The reference's physics_step jitted once per config, the solar hour
    an argument; traced with the reference's mynn_sfclay returning cd."""
    if cfg not in _JAX_STEPS:
        jit = jax.jit(lambda s, d, ph, gmt: jman.physics_step(
            x["gj"], cfg, x["gj"].mesh, J(x["coeffs"]), s, d, ph, DT_DYN,
            gmt_hours=gmt))

        def step(*a):
            with reference_mynn_sfclay_with_cd():
                return jit(*a)
        _JAX_STEPS[cfg] = step
    return _JAX_STEPS[cfg]


STEP_CASES = {
    "convection_permitting": (CONVPERM, dict(lsm_scheme="noah",
                                             pbl_scheme="mynn")),
    "mynn_pbl_mm5_gf": (dict(config_pbl_scheme="mynn",
                             config_conv_scheme="grell_freitas"),
                        dict(pbl_scheme="mynn")),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_physics_step(supercell, case):
    """The resolved suite, and the MYNN PBL on the MM5 surface layer
    (whose cd the reference's MYNN PBL reads as it is) with Grell-Freitas
    and the default slab LSM and broadband radiation."""
    x = supercell
    kw, init_kw = STEP_CASES[case]
    jp = jman.resolve_suite(jman.PhysicsConfig(**kw))
    tp = tman.resolve_suite(tman.PhysicsConfig(**kw))
    jph, tph = _physics_states(144, 16, init_kw)
    js = x["jcarry"].state
    ref = _jax_physics_step(x, jp)(js, x["jcarry"].diag, jph, GMT)
    got = tman.physics_step(x["tgrid"], tp, x["tgrid"].mesh,
                            T(x["coeffs"]), x["carry"].state,
                            x["carry"].diag, tph, DT_DYN, gmt_hours=GMT)
    assert_close(got[:3], ref[:3], ["theta_m", "scalars", "u"])
    rp = flatten(ref[3])
    for f in dataclasses.fields(got[3]):
        v = getattr(got[3], f.name)
        assert (v is None) == (rp[f.name] is None), f.name
        if v is not None:
            assert_close([v], [rp[f.name]], [f.name])
    # qke moved; Grell-Freitas detrained cloud water into scalars[..., 1]
    assert not torch.equal(got[3].qke, tph.qke)
    assert float((got[1][..., 1] - x["carry"].state.scalars[..., 1])
                 .max()) > 0.0
