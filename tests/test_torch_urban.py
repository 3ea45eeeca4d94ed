"""The port's urban canopy (SLUCM + BEM + BEP) and slab ocean mixed layer
against the JAX package, in float64 on the CPU.

Forcing for 32 urban columns is made with numpy from a seed: day and night
sun, calm and windy air, dry and raining columns, and a surface warmer or
colder than the air. The JAX state is carried across with
convert.urban_state_from_arrays. Each JAX function is jitted once; every
output is held to 1e-11 x max|ref| (10 chained SLUCM steps likewise).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere.physics import oml as joml
from mpas_tpu.cores.atmosphere.physics import urban as jurban
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere.physics import oml as toml
from mpas_tpu_torch.cores.atmosphere.physics import urban as turban
from tests.test_torch_physics import J, T, assert_close, both, flatten

torch.set_num_threads(1)

NCOL = 32
DT = 60.0


@pytest.fixture(scope="module")
def forcing():
    rng = np.random.default_rng(41)
    mu = np.where(np.arange(NCOL) < 20, rng.uniform(0.05, 1.0, NCOL), 0.0)
    return dict(
        t_air=rng.uniform(280.0, 305.0, NCOL),
        wind=np.where(np.arange(NCOL) % 4 == 0, 0.2,
                      rng.uniform(0.5, 12.0, NCOL)),
        swdown=900.0 * mu * rng.uniform(0.6, 1.0, NCOL),
        lwdown=rng.uniform(280.0, 420.0, NCOL), mu=mu,
        qa=rng.uniform(0.003, 0.015, NCOL),
        rain=np.where(np.arange(NCOL) % 3 == 0, 4.0, 0.0),
        sin_az=rng.uniform(-np.pi, np.pi, NCOL))


def _states(rng):
    """The same perturbed UrbanState for both packages."""
    st = flatten(jurban.init_urban_state(NCOL))
    for k, v in st.items():
        st[k] = v + rng.uniform(-4.0, 4.0, v.shape) if k != "qc_canyon" \
            else v * rng.uniform(0.5, 1.5, v.shape)
    return (jurban.UrbanState(**{k: J(v) for k, v in st.items()}),
            convert.urban_state_from_arrays(st))


def _close_state(got, ref):
    rf = flatten(ref)
    names = [f.name for f in dataclasses.fields(got)]
    assert names == sorted(rf, key=names.index)
    assert_close([getattr(got, n) for n in names], [rf[n] for n in names],
                 names)


def test_init_urban_state():
    ref = jurban.init_urban_state(NCOL, t0=285.0)
    got = turban.init_urban_state(NCOL, t0=285.0, device="cpu")
    _close_state(got, ref)
    assert got.t_roof.dtype == torch.float64


FLUXES = ("hfx_urban", "lh_urban", "h_roof", "h_wall", "h_road",
          "le_roof", "q_ac", "ah")
CASES = {
    "default": (1, {}),
    "commercial_rain_azimuth": (3, {"rain": True, "sin_az": True}),
    "high_intensity_split_sun": (2, {"split": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slucm_step(forcing, case):
    cls, opt = CASES[case]
    f = forcing
    params = jurban.URBPARM_TABLE[cls]
    tparams = turban.URBPARM_TABLE[cls]
    assert tuple(tparams) == tuple(params)
    jst, tst = _states(np.random.default_rng(42))
    arrays = {k: f[k] for k in ("t_air", "wind", "swdown", "lwdown", "mu")}
    kw = {"qa": f["qa"]}
    if opt.get("rain"):
        kw["rain_mmh"] = f["rain"]
    if opt.get("sin_az"):
        kw["sin_az"] = f["sin_az"]
    if opt.get("split"):
        kw["swddir"] = 0.7 * f["swdown"]
        kw["swddif"] = 0.3 * f["swdown"]
    names = list(arrays) + list(kw)

    def jstep(st, *a):
        d = dict(zip(names, a))
        return jurban.slucm_step(st, *[d[k] for k in arrays], DT,
                                 hour_utc=15.5, params=params,
                                 **{k: d[k] for k in kw})
    jstep = jax.jit(jstep)
    vals = [*arrays.values(), *kw.values()]
    for _ in range(10 if case == "default" else 1):
        jst, jdiag = jstep(jst, *[J(v) for v in vals])
        d = dict(zip(names, [T(v) for v in vals]))
        tst, tdiag = turban.slucm_step(
            tst, *[d[k] for k in arrays], DT, hour_utc=15.5, params=tparams,
            **{k: d[k] for k in kw})
    _close_state(tst, jst)
    assert sorted(tdiag) == sorted(jdiag)
    temps = [k for k in sorted(jdiag) if k not in FLUXES]
    assert_close([tdiag[k] for k in temps], [jdiag[k] for k in temps], temps)
    # the fluxes (W/m2) at 1e-11 of the largest: the dry canyon's latent
    # flux is a difference of equal terms, rounding noise in both packages
    scale = max(float(np.abs(np.asarray(jdiag[k])).max()) for k in FLUXES)
    for k in FLUXES:
        err = np.abs(tdiag[k].numpy() - np.asarray(jdiag[k])).max()
        assert err <= 1e-11 * scale, k
    assert np.isfinite(tdiag["hfx_urban"].numpy()).all()


def test_geometry_and_exchange_helpers(forcing):
    f = forcing
    for hw in (0.5, 1.0, 2.0):
        got, ref = both(jurban.sky_view_factors, turban.sky_view_factors,
                        [np.float64(hw)])
        assert_close(got, ref)
    got, ref = both(jurban._shadow_fraction, turban._shadow_fraction,
                    [np.float64(1.4), f["mu"]])
    assert_close([got], [ref])
    rib = np.linspace(-20.0, 1.0, 57)
    got, ref = both(lambda r: jurban._louis79(r, 12.5, 0.15),
                    lambda r: turban._louis79(r, 12.5, 0.15), [rib])
    assert_close([got], [ref])
    for name in ("_qsat", "_dqsat_dt"):
        got, ref = both(getattr(jurban, name), getattr(turban, name),
                        [f["t_air"]], p_hpa=1000.0)
        assert_close([got], [ref], [name])


@pytest.mark.parametrize("bound", [1, 2])
def test_facet_substrate(bound):
    rng = np.random.default_rng(43)
    t_layers = rng.uniform(285.0, 300.0, (NCOL, 4))
    g = rng.uniform(-200.0, 300.0, NCOL)
    t_end = rng.uniform(290.0, 296.0, NCOL)
    ref = jurban._facet_substrate(J(t_layers), J(g), DT, 1.4e6, 0.4,
                                  (0.05, 0.05, 0.1, 0.2), bound, J(t_end))
    got = turban._facet_substrate(T(t_layers), T(g), DT, 1.4e6, 0.4,
                                  (0.05, 0.05, 0.1, 0.2), bound, T(t_end))
    assert_close([got], [ref])


@pytest.fixture(scope="module")
def column():
    rng = np.random.default_rng(44)
    dz = rng.uniform(3.0, 9.0, (NCOL, 12))
    z_int = np.concatenate([np.zeros((NCOL, 1)), np.cumsum(dz, 1)], 1)
    return dict(z_int=z_int, z_mid=0.5 * (z_int[:, 1:] + z_int[:, :-1]),
                u=rng.uniform(-8.0, 12.0, (NCOL, 12)),
                v=rng.uniform(-6.0, 6.0, (NCOL, 12)),
                t=rng.uniform(285.0, 300.0, (NCOL, 12)),
                ts=rng.uniform(285.0, 320.0, (3, NCOL)))


@pytest.mark.parametrize("morphology", ["single_height", "height_bins"])
def test_bep_column_drag(column, morphology):
    c = column
    kw = {} if morphology == "single_height" else dict(
        height_bins=(6.0, 12.0, 24.0, 40.0),
        height_fractions=(0.4, 0.3, 0.2, 0.1))
    got, ref = both(jurban.bep_column_drag, turban.bep_column_drag,
                    [c["u"], c["v"], c["z_mid"]], dt=DT, **kw)
    assert_close(got, ref, ["u", "v", "tke"])
    assert float(got[2].max()) > 0.0


def test_bep_heat_sources(column):
    c = column
    got, ref = both(jurban.bep_heat_sources, turban.bep_heat_sources,
                    [c["z_int"], *c["ts"], c["t"]], uc=2.5)
    assert_close([got], [ref])
    assert float(got[:, 0].abs().min()) > 0.0


def test_oml_step():
    rng = np.random.default_rng(45)
    n = 64
    args = [rng.uniform(285.0, 302.0, n), rng.uniform(3.0, 80.0, n),
            rng.uniform(-50.0, 150.0, n), rng.uniform(0.0, 300.0, n),
            rng.uniform(0.0, 900.0, n), rng.uniform(300.0, 420.0, n),
            rng.uniform(0.0, 0.8, n)]
    got, ref = both(joml.oml_step, toml.oml_step, args, dt=600.0)
    assert_close(got, ref, ["tml", "h_ml"])
    assert float(got[1].min()) >= 5.0 and float(got[1].max()) <= 500.0


def test_cloud_fraction_rh():
    rng = np.random.default_rng(46)
    shape = (24, 16)
    t = rng.uniform(220.0, 305.0, shape)
    p = rng.uniform(2.0e4, 1.0e5, shape)
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    qv = rng.uniform(0.3, 1.1, shape) * 0.622 * es / (p - es)
    qc = np.where(rng.uniform(size=shape) < 0.2, 1e-5, 0.0)
    qi = np.where(rng.uniform(size=shape) < 0.1, 1e-5, 0.0)
    got, ref = both(joml.cloud_fraction_rh, toml.cloud_fraction_rh,
                    [qv, qc, qi, p, t])
    assert_close([got], [ref])
    assert float(got.min()) == 0.0 and float(got.max()) == 1.0
