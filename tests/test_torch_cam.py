"""The port's CAM radiation, its tables and the ozone climatology against
the JAX package, function by function, in float64 on the CPU.

Inputs are made with numpy from seeds and handed to both packages: 24
columns x 16 levels of the sounding of tests/test_torch_physics.py, eight
of them clear, eight cloudy by day (warm and frozen cloud) and eight at
night (half of them cloudy). Each JAX function is jitted once. Every output
is held to 1e-11 x max|ref|; the tables array by array, exactly.
"""

import jax
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere.physics import cam3 as jcam3
from mpas_tpu.cores.atmosphere.physics import cam3_data as jdata
from mpas_tpu.cores.atmosphere.physics import cam_radiation as jcam
from mpas_tpu.cores.atmosphere.physics import o3 as jo3
from mpas_tpu.cores.atmosphere.physics import rrtmg as jrrtmg
from mpas_tpu_torch.cores.atmosphere.physics import cam3 as tcam3
from mpas_tpu_torch.cores.atmosphere.physics import cam3_data as tdata
from mpas_tpu_torch.cores.atmosphere.physics import cam_radiation as tcam
from mpas_tpu_torch.cores.atmosphere.physics import o3 as to3
from mpas_tpu_torch.cores.atmosphere.physics import rrtmg as trrtmg
from tests.test_torch_physics import (NC, NZ, J, T, _sounding, _species,
                                      assert_close, both)

torch.set_num_threads(1)

CLEAR, DAY, NIGHT = slice(0, 8), slice(8, 16), slice(16, 24)


@pytest.fixture(scope="module")
def cam_cols():
    """The sounding with cloud water in the day columns and in half of the
    night ones; cos(zenith) 0 at night; a surface warmer or colder than
    the air."""
    rng = np.random.default_rng(31)
    c = _sounding(rng)
    qc = _species(rng, (NC, NZ), 5e-4, frac=0.4)
    qc[CLEAR] = 0.0
    qc[20:] = 0.0
    mu = np.concatenate([rng.uniform(0.05, 1.0, 16), np.zeros(8)])
    c.update(qc=qc, mu=mu, tsk=c["t"][:, 0] + rng.uniform(-6.0, 6.0, NC),
             lat=rng.uniform(-1.5, 1.5, NC))
    # cloud at warm and at frozen levels in the day columns
    assert (qc[DAY][c["t"][DAY] > 273.16] > 0).any()
    assert (qc[DAY][c["t"][DAY] < 253.16] > 0).any()
    return c


@pytest.fixture(scope="module")
def engine_in(cam_cols):
    """The engine's top-down inputs, from the reference's adapter."""
    c = cam_cols
    cols = jcam._columns_from_rho_dz(*[J(c[k]) for k in ("t", "qv", "qc",
                                                         "rho", "dz")])
    names = ("pint", "pmid", "t", "qv", "o3", "cld", "cliqwp", "cicewp",
             "fice", "rel", "rei")
    e = {n: np.asarray(v) for n, v in zip(names, cols)}
    e["lwups"] = 0.985 * 5.670374e-8 * c["tsk"] ** 4
    return e


def test_cam3_data_is_the_reference_copy():
    names = [n for n in dir(jdata) if n.isupper()]
    assert names == [n for n in dir(tdata) if n.isupper()]
    for n in names:
        a, b = getattr(tdata, n), getattr(jdata, n)
        assert type(a) is type(b), n
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), n
        else:
            assert a == b, n


# ---------------------------------------------------------------------------
# engine helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("surface", ["defaults", "given"])
def test_reltab(cam_cols, surface):
    c = cam_cols
    rng = np.random.default_rng(2)
    kw = {} if surface == "defaults" else dict(
        landfrac=rng.uniform(0, 1, NC), icefrac=rng.uniform(0, 1, NC),
        snowh=rng.uniform(0, 0.2, NC), landm=rng.uniform(0, 1, NC))
    ref = jcam3.reltab(J(c["t"]), **{k: J(v) for k, v in kw.items()})
    got = tcam3.reltab(T(c["t"]), **{k: T(v) for k, v in kw.items()})
    assert_close([got], [ref])


@pytest.mark.parametrize("name", ["reitab", "_fh2oself"])
def test_temperature_functions(name):
    t = np.linspace(150.0, 320.0, 341).reshape(11, 31)  # past both ends
    got, ref = both(getattr(jcam3, name), getattr(tcam3, name), [t])
    assert_close([got], [ref], [name])


def test_cldems(engine_in):
    e = engine_in
    cwp = e["cliqwp"] + e["cicewp"]
    got, ref = both(jcam3.cldems, tcam3.cldems, [cwp, e["fice"], e["rei"]])
    assert_close([got], [ref])
    assert 0.0 < float(got.max()) <= 1.0


@pytest.mark.parametrize("band", [(10.0, 500.0), (500.0, 800.0),
                                  (1200.0, 2200.0), (800.0, 1200.0)])
def test_planck_frac(cam_cols, band):
    t = cam_cols["t"]
    got, ref = both(jcam3._planck_frac, tcam3._planck_frac, [t],
                    nu1=band[0], nu2=band[1])
    assert_close([got], [ref])


def test_max_overlap_configs():
    """Ties (the adapter's 0.99 everywhere it is cloudy), cloud below the
    threshold, random fractions and clear columns."""
    rng = np.random.default_rng(8)
    cld = np.where(rng.uniform(size=(12, NZ)) < 0.5,
                   rng.uniform(0.0, 1.0, (12, NZ)), 0.0)
    cld[:3] = np.where(rng.uniform(size=(3, NZ)) < 0.5, 0.99, 0.0)
    cld[3, :] = 5e-4
    cld[4] = 0.0
    ref = jcam3._max_overlap_configs(J(cld))
    got = tcam3._max_overlap_configs(T(cld))
    assert torch.equal(got[0], T(ref[0]))
    assert_close([got[1]], [ref[1]])
    # the weights of a column sum to one
    assert float((got[1].sum(1) - 1.0).abs().max()) < 1e-14


def _layer_inputs(rng, shape):
    tau = rng.uniform(0.0, 30.0, shape)
    tau[..., ::3] = rng.uniform(0.0, 1e-3, tau[..., ::3].shape)
    w0 = rng.uniform(0.0, 0.999999, shape)
    g = rng.uniform(0.0, 0.9, shape)
    return tau, w0, g, g ** 2


def test_sw_layer_props():
    rng = np.random.default_rng(9)
    tau, w0, g, f = _layer_inputs(rng, (5, 7, 11))
    mu = rng.uniform(0.01, 1.0, (1, 7, 1))
    got, ref = both(jcam3._sw_layer_props, tcam3._sw_layer_props,
                    [tau, w0, g, f, mu])
    assert_close(got, ref, ["rdir", "tdir", "rdif", "tdif", "explay"])
    got2, ref2 = both(jcam._delta_eddington, tcam._delta_eddington,
                      [tau, w0, g, mu])
    assert_close(got2, ref2)


@pytest.mark.parametrize("batch", ["(19, nC)", "(19, nC, NCFG)"])
def test_adding(batch):
    """The two scans: the downward pass from the top interface, the upward
    pass from the surface albedo, each interface in its place."""
    rng = np.random.default_rng(10)
    shape = (4, 6, 9) if batch == "(19, nC)" else (4, 6, 5, 9)
    tau, w0, g, f = _layer_inputs(rng, shape)
    mu = rng.uniform(0.05, 1.0, (1, 6) + (1,) * (len(shape) - 2))
    props = [np.asarray(p) for p in jcam3._sw_layer_props(
        *[J(a) for a in (tau, w0, g, f, mu)])]
    alb = rng.uniform(0.05, 0.6, (2, 4, 6) + (1,) * (len(shape) - 3))
    got, ref = both(jcam3._adding, tcam3._adding, props + [alb[0], alb[1]])
    assert_close(got, ref, ["exptdn", "rdndif", "tdntot", "rupdir",
                            "rupdif"])
    assert np.all(got[0][..., 0].numpy() == 1.0)
    assert np.allclose(got[3][..., -1].numpy(),
                       np.broadcast_to(alb[0], shape[:-1]), 0.0, 0.0)


def test_pairdiff():
    x = np.random.default_rng(12).standard_normal((3, 4, 9))
    got, ref = both(jcam3._pairdiff, tcam3._pairdiff, [x])
    assert_close([got], [ref])


# ---------------------------------------------------------------------------
# the engine and the adapters
# ---------------------------------------------------------------------------

SW_KEYS = ("pint", "pmid", "t", "qv", "o3", "cld", "cliqwp", "cicewp",
           "rel", "rei")


def test_radcswmx(engine_in, cam_cols):
    e = engine_in
    rng = np.random.default_rng(13)
    alb = [rng.uniform(0.05, 0.5, NC) for _ in range(4)]
    args = [e[k] for k in SW_KEYS] + [cam_cols["mu"]] + alb
    got, ref = both(jcam3.radcswmx, tcam3.radcswmx, args)
    assert_close([got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)],
                 sorted(ref))
    assert sorted(got) == sorted(ref)
    fsns = got["fsns"].numpy()
    assert np.all(fsns[NIGHT] == 0.0) and np.all(fsns[:16] > 0.0)
    # cloud cuts the surface flux against the clear-sky pass
    assert np.all(fsns[DAY] < got["fsnsc"].numpy()[DAY])


def test_radclwmx(engine_in):
    e = engine_in
    args = [e[k] for k in ("pint", "pmid", "t", "qv", "o3", "cld")] + [
        e["cliqwp"] + e["cicewp"], e["fice"], e["rei"], e["lwups"]]
    got, ref = both(jcam3.radclwmx, tcam3.radclwmx, args)
    assert sorted(got) == sorted(ref)
    assert_close([got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)],
                 sorted(ref))
    assert float(got["flwds"].min()) > 0.0


def test_o3_profile_and_columns(cam_cols):
    c = cam_cols
    got, ref = both(jcam._o3_profile, tcam._o3_profile, [c["p"]])
    assert_close([got], [ref])
    got, ref = both(jcam._columns_from_rho_dz, tcam._columns_from_rho_dz,
                    [c[k] for k in ("t", "qv", "qc", "rho", "dz")])
    assert_close(got, ref, ["pint", "pmid", "t", "qv", "o3", "cld",
                            "cliqwp", "cicewp", "fice", "rel", "rei"])


def test_cam_lw(cam_cols):
    c = cam_cols
    got, ref = both(jcam.cam_lw, tcam.cam_lw,
                    [c[k] for k in ("t", "qv", "qc", "rho", "dz", "tsk")])
    assert_close(got, ref, ["tend", "glw", "olr"])


@pytest.mark.parametrize("with_t", [True, False])
def test_cam_sw(cam_cols, with_t):
    c = cam_cols
    args = [c[k] for k in ("qv", "qc", "rho", "dz", "mu")]
    if with_t:
        ref = jax.jit(lambda *a: jcam.cam_sw(*a[:5], 0.2, t=a[5]))(
            *[J(a) for a in args + [c["t"]]])
        got = tcam.cam_sw(*[T(a) for a in args], 0.2, t=T(c["t"]))
    else:
        got, ref = both(jcam.cam_sw, tcam.cam_sw, args, albedo=0.2)
    assert_close(got, ref, ["tend", "gsw"])
    assert np.all(got[1].numpy()[NIGHT] == 0.0)


# ---------------------------------------------------------------------------
# ozone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("day", [15.0, 172.0, 300.0])
def test_o3_climatology(cam_cols, day):
    c = cam_cols
    got, ref = both(jo3.o3_climatology, to3.o3_climatology,
                    [c["lat"], c["p"]], julian_day=day)
    assert_close([got], [ref])
    assert float(got.max()) > 0.0
    got, ref = both(jo3.o3_column_du, to3.o3_column_du, [c["lat"]],
                    julian_day=day)
    assert_close([got], [ref])
    got, ref = both(jo3.o3_peak_pressure, to3.o3_peak_pressure, [c["lat"]])
    assert_close([got], [ref])


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_rrtmg_with_o3_climatology(cam_cols, kind):
    c = cam_cols
    vmr = np.asarray(jo3.o3_climatology(J(c["lat"]), J(c["p"])))
    got, ref = both(jo3.o3_path, to3.o3_path, [c["rho"], c["dz"], vmr])
    assert_close([got], [ref])
    if kind == "lw":
        args = [c[k] for k in ("t", "qv", "qc", "rho", "dz", "tsk")] + [vmr]
        ref = jax.jit(lambda *a: jrrtmg.rrtmg_lw(*a[:6], o3_vmr=a[6]))(
            *[J(a) for a in args])
        got = trrtmg.rrtmg_lw(*[T(a) for a in args[:6]], o3_vmr=T(vmr))
        base = trrtmg.rrtmg_lw(*[T(a) for a in args[:6]])
        names = ["dtdt", "glw", "olr"]
    else:
        args = [c[k] for k in ("qv", "qc", "rho", "dz", "mu")] + [vmr]
        ref = jax.jit(lambda *a: jrrtmg.rrtmg_sw(*a[:5], o3_vmr=a[5]))(
            *[J(a) for a in args])
        got = trrtmg.rrtmg_sw(*[T(a) for a in args[:5]], o3_vmr=T(vmr))
        base = trrtmg.rrtmg_sw(*[T(a) for a in args[:5]])
        names = ["dtdt", "gsw"]
    assert_close(got, ref, names)
    # the profile changes the heating against the fixed column proxy
    assert not torch.equal(got[0], base[0])

