"""The port's atmosphere diagnostics (isobaric, convective, PV, radar
reflectivity), their manager and the sounding against the JAX package, in
float64 on the CPU.

Two states go through both packages: the JW wave on the 642-cell sphere
(10 levels, one scalar, u perturbed from a seed) and the 144-cell,
16-level supercell of tests/test_torch_physics.py with six species. Each
field is held to 1e-11 x max|ref| over its finite values, and its NaN
positions (a pressure level below the ground or above the top, a column
that never reaches 2 PVU) must be the reference's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere.config import AtmConfig as JaxAtmConfig
from mpas_tpu.cores.atmosphere.diagnostics import convective as jconv
from mpas_tpu.cores.atmosphere.diagnostics import isobaric as jiso
from mpas_tpu.cores.atmosphere.diagnostics import manager as jman
from mpas_tpu.cores.atmosphere.diagnostics import pv as jpv
from mpas_tpu.cores.atmosphere.init_jw import init_jw
from mpas_tpu.cores.atmosphere.physics import convection as jcnv
from mpas_tpu.cores.atmosphere.physics import radar as jradar
from mpas_tpu.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere.diagnostics import convective as tconv
from mpas_tpu_torch.cores.atmosphere.diagnostics import isobaric as tiso
from mpas_tpu_torch.cores.atmosphere.diagnostics import manager as tman
from mpas_tpu_torch.cores.atmosphere.diagnostics import pv as tpv
from mpas_tpu_torch.cores.atmosphere.physics import convection as tcnv
from mpas_tpu_torch.cores.atmosphere.physics import radar as tradar
from tests.test_torch_physics import J, T, both, flatten, supercell  # noqa

torch.set_num_threads(1)

REL = 1e-11
CUSTOM_LEVELS = (105000.0, 85000.0, 50000.0, 20000.0, 5000.0, 1.0)


def assert_nan_close(got, ref, name=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, name
    assert np.array_equal(np.isnan(g), np.isnan(r)), name
    fin = ~np.isnan(r)
    if fin.any():
        scale = max(float(np.abs(r[fin]).max()), 1e-300)
        assert np.abs(g[fin] - r[fin]).max() <= REL * scale, name


def _states(jgrid, s, d):
    """(jax grid, jax state, jax diag), (port grid, state, diag)."""
    return ((jgrid, AtmState(**jax.tree.map(J, s)),
             AtmDiag(**jax.tree.map(J, d))),
            (convert.grid_from_arrays(flatten(jgrid)),
             convert.state_from_arrays(s), convert.diag_from_arrays(d)))


@pytest.fixture(scope="module")
def jw(sphere_mesh_small):
    cfg = JaxAtmConfig(config_nvertlevels=10, config_len_disp=960000.0,
                       config_dt=1200.0)
    jgrid, jstate, jdiag = init_jw(sphere_mesh_small, cfg, case=2)
    s, d = flatten(jstate), flatten(jdiag)
    s["u"] = s["u"] + np.random.default_rng(51).standard_normal(
        s["u"].shape)
    return _states(jax.tree.map(jnp.asarray, jgrid), s, d)


@pytest.fixture(scope="module")
def sc(supercell):  # noqa: F811
    x = supercell
    return _states(x["jgrid"], x["s"], x["d"])


@pytest.fixture(scope="module", params=["jw", "supercell"])
def states(request, jw, sc):
    return jw if request.param == "jw" else sc


@pytest.mark.parametrize("levels", ["standard", "custom"])
def test_isobaric(states, levels):
    (jg, js, jd), (tg, ts, td) = states
    kw = {} if levels == "standard" else {"levels": CUSTOM_LEVELS}
    ref = jiso.compute_isobaric(jg, js, jd, **kw)
    got = tiso.compute_isobaric(tg, ts, td, **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert_nan_close(got[k], ref[k], k)
    if levels == "custom":
        # below the ground and above the top: missing everywhere
        t = got["temperature_isobaric"].numpy()
        assert np.isnan(t[:, 0]).all() and np.isnan(t[:, -1]).all()
        assert not np.isnan(t[:, 2]).any()


def test_convective(states):
    (jg, js, jd), (tg, ts, td) = states
    ref = jconv.compute_convective(jg, js, jd)
    got = tconv.compute_convective(tg, ts, td)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert_nan_close(got[k], ref[k], k)


def test_pv(states):
    (jg, js, jd), (tg, ts, td) = states
    ref = jpv.ertel_pv(jg, jg.mesh, js, jd)
    got = tpv.ertel_pv(tg, tg.mesh, ts, td)
    assert_nan_close(got, ref, "ertel_pv")
    th = js.theta_m / (1.0 + 1.608 * jnp.maximum(js.scalars[..., 0], 0.0))
    for target in (2.0, 0.5 * float(jnp.abs(ref).max())):
        r = jpv.theta_on_pv_surface(ref, th, target=target)
        g = tpv.theta_on_pv_surface(T(ref), T(th), target=target)
        assert_nan_close(g, r, "theta_pv")
    # at the second target some columns reach it and some do not
    assert np.isnan(g.numpy()).any() and not np.isnan(g.numpy()).all()


def test_column_diagnostics():
    """SRH, updraft helicity, LCL and the parcel on columns from a seed."""
    rng = np.random.default_rng(52)
    nc, nz = 20, 24
    z = np.cumsum(rng.uniform(300.0, 700.0, (nc, nz)), 1)
    u = rng.uniform(-5.0, 25.0, (nc, nz))
    v = rng.uniform(-10.0, 10.0, (nc, nz))
    got, ref = both(jconv.storm_relative_helicity,
                    tconv.storm_relative_helicity, [u, v, z])
    assert_nan_close(got, ref, "srh")
    w = rng.uniform(-3.0, 20.0, (nc, nz))
    zeta = rng.standard_normal((nc, nz)) * 1e-2
    got, ref = both(jconv.updraft_helicity, tconv.updraft_helicity,
                    [w, zeta, z])
    assert_nan_close(got, ref, "uh")
    t = 300.0 - 0.0065 * z + rng.standard_normal((nc, nz))
    p = 1.0e5 * np.exp(-z / 8000.0)
    qv = 0.016 * np.exp(-z / 2500.0)
    got, ref = both(jcnv.parcel_cape, tcnv.parcel_cape, [t, qv, p, z])
    assert_nan_close(got[0], ref[0], "cape")
    assert_nan_close(got[1], ref[1], "buoyancy")
    assert float(got[0].max()) > 0.0
    got, ref = both(jconv.lcl_height, tconv.lcl_height,
                    [t[:, 0], qv[:, 0], p[:, 0]])
    assert_nan_close(got, ref, "lcl")


@pytest.mark.parametrize("with_t", [False, True])
def test_reflectivity(sc, with_t):
    (_, js, _), _ = sc
    rng = np.random.default_rng(53)
    sh = js.theta_m.shape
    rho = rng.uniform(0.3, 1.2, sh)
    q = [np.where(rng.uniform(size=sh) < 0.5, 3e-3 * rng.uniform(size=sh),
                  0.0) for _ in range(3)]
    t = rng.uniform(250.0, 300.0, sh)
    kw = dict(t=t) if with_t else {}
    ref = jradar.refl_10cm(J(rho), J(q[0]), qs=J(q[1]), qg=J(q[2]),
                           **{k: J(v) for k, v in kw.items()})
    got = tradar.refl_10cm(T(rho), T(q[0]), qs=T(q[1]), qg=T(q[2]),
                           **{k: T(v) for k, v in kw.items()})
    assert_nan_close(got, ref, "dbz")
    assert_nan_close(tradar.composite_reflectivity(got),
                     jradar.composite_reflectivity(ref), "composite")
    assert float(got.min()) == -30.0 and float(got.max()) > 40.0


MEMBERS = {"isobaric": 3600.0, "convective": 1800.0, "pv": 7200.0,
           "reflectivity": 600.0}


def test_manager_alarms_and_history(sc):
    (jg, js, jd), (tg, ts, td) = sc
    jm = jman.DiagnosticsManager(dict(MEMBERS))
    tm = tman.DiagnosticsManager(dict(MEMBERS))
    jm.init()
    tm.init()
    for t_s in (0.0, 600.0, 1200.0, 1799.0, 1800.0, 3600.0, 7300.0):
        jm.compute_due(jg, jg.mesh, js, jd, t_s)
        tm.compute_due(tg, tg.mesh, ts, td, t_s)
    jm.compute_all(jg, jg.mesh, js, jd, 9000.0)
    tm.compute_all(tg, tg.mesh, ts, td, 9000.0)
    assert tm._next_due == jm._next_due
    for name in MEMBERS:
        assert [h[0] for h in tm.history[name]] == \
            [h[0] for h in jm.history[name]], name
        for (_, g), (_, r) in zip(tm.history[name], jm.history[name]):
            assert sorted(g) == sorted(r)
            for k in r:
                assert isinstance(g[k], np.ndarray), k
                assert_nan_close(g[k], r[k], f"{name}.{k}")
    assert [h[0] for h in tm.history["reflectivity"]] == \
        [0.0, 600.0, 1200.0, 1800.0, 3600.0, 7300.0, 9000.0]
    with pytest.raises(ValueError, match="unknown diagnostic"):
        tman.DiagnosticsManager({"skewt": 60.0}).init()


@pytest.mark.parametrize("where", ["jw", "supercell"])
def test_sounding(jw, sc, where):
    (jg, js, jd), (tg, ts, td) = jw if where == "jw" else sc
    point = (0.7, 2.0) if where == "jw" else (9000.0, 13000.0)
    ref = jman.sounding(jg, jg.mesh, js, jd, point)
    got = tman.sounding(tg, tg.mesh, ts, td, point)
    assert sorted(got) == sorted(ref) and got["cell"] == ref["cell"]
    for k in ("pressure_hpa", "temperature_c", "qv", "height_m"):
        assert_nan_close(got[k], ref[k], k)
