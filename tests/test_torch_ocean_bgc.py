"""Ocean biogeochemistry, carbonate chemistry and the land-ice melt
fluxes of the PyTorch port against the JAX package.

Seeded numpy inputs on 24 columns x 16 levels (and the ecosys column and
ISOMIP+ inits) go through each function in both packages in float64 and
are held at 1e-11 x max|ref|: the carbonate constants and the 20-step
Newton solve, the NPZD and DMS tendencies, detritus sinking, bgc_step,
the 8-pool ecosys tendencies and step, carbon_step, the three-equation
melt and apply_land_ice_fluxes. Chained steps (ecosys and carbon on the
column, land-ice fluxes between split steps on ISOMIP+) are held at
1e-9. Every step leaves the caller's tensors as they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.ocean import bgc as jbgc
from mpas_tpu.cores.ocean import carbonate as jcarb
from mpas_tpu.cores.ocean import core as jcore
from mpas_tpu.cores.ocean import init_configs as jinit
from mpas_tpu.cores.ocean import land_ice_flux as jlif
from mpas_tpu.mesh import planar as jplanar
from mpas_tpu_torch.cores.ocean import bgc as tbgc
from mpas_tpu_torch.cores.ocean import carbonate as tcarb
from mpas_tpu_torch.cores.ocean import core as tcore
from mpas_tpu_torch.cores.ocean import init_configs as tinit
from mpas_tpu_torch.cores.ocean import land_ice_flux as tlif
from mpas_tpu_torch.mesh import planar as tplanar

torch.set_num_threads(1)

REL = 1e-11
STEP_REL = 1e-9
NC, NZ = 24, 16


def assert_close(got, ref, name="", rel=REL):
    """Tensors, tuples, NamedTuples, dicts and states against the
    reference's at rel x max|ref|, with the same non-finite positions."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_close(getattr(got, f.name), getattr(ref, f.name),
                         f"{name}.{f.name}", rel)
        return
    if isinstance(got, dict):
        assert sorted(got) == sorted(ref), name
        for k in got:
            assert_close(got[k], ref[k], f"{name}.{k}", rel)
        return
    if isinstance(got, tuple):
        assert len(got) == len(ref), name
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, f"{name}[{i}]", rel)
        return
    if got is None or ref is None:
        assert got is None and ref is None, name
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, name
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r), name)
    fin = np.isfinite(r)
    scale = max(float(np.abs(r[fin]).max()), 1e-300)
    err = float(np.abs(g[fin] - r[fin]).max())
    assert err <= rel * scale, f"{name}: {err:.3e} > {rel:g} x {scale:.3e}"


def pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def cols():
    """Seeded surface-ocean columns: T, S, DIC, ALK (mol/kg), wind, h,
    shortwave and NPZD(+DMS) / ecosys pools."""
    rng = np.random.default_rng(7)
    d = dict(
        t=rng.uniform(-1.5, 30.0, (NC, NZ)), s=rng.uniform(32.0, 37.5,
                                                           (NC, NZ)),
        dic=rng.uniform(1.85e-3, 2.25e-3, (NC, NZ)),
        alk=rng.uniform(2.2e-3, 2.45e-3, (NC, NZ)),
        wind=rng.uniform(0.0, 15.0, NC), ice=rng.uniform(0.0, 1.0, NC),
        h=rng.uniform(2.0, 40.0, (NC, NZ)), sw=rng.uniform(0.0, 400.0, NC),
        npzd=rng.uniform(-0.05, 3.0, (5, NC, NZ)),
        eco=rng.uniform(-1e-4, 1.0, (NC, NZ, 8)) * np.array(
            [30.0, 60.0, 6e-4, 1.0, 1.0, 0.5, 0.1, 0.1]))
    return d


def test_k_carbonic_and_solubility(cols):
    (jt, tt), (js, ts) = pair(cols["t"]), pair(cols["s"])
    assert_close(tcarb.k_carbonic(tt, ts), jcarb.k_carbonic(jt, js), "K")
    assert_close(tcarb.co2_solubility(tt, ts),
                 jcarb.co2_solubility(jt, js), "K0")


@pytest.mark.parametrize("n_iter", [20, 3])
def test_carbonate_equilibrium(cols, n_iter):
    args = [pair(cols[k]) for k in ("dic", "alk", "t", "s")]
    got = tcarb.carbonate_equilibrium(*[a[1] for a in args], n_iter=n_iter)
    assert_close(got, jcarb.carbonate_equilibrium(*[a[0] for a in args],
                                                  n_iter=n_iter), "eq")


def test_carbonate_anchor():
    """TestCarbonateSystem's anchor (tests/test_ocean_fidelity.py:183-196):
    DIC 2.0e-3, ALK 2.3e-3 mol/kg at 20 C and S 35."""
    ph, pco2, co3, hco3 = tcarb.carbonate_equilibrium(
        *[torch.tensor([v], dtype=torch.float64)
          for v in (2.0e-3, 2.3e-3, 20.0, 35.0)])
    assert 8.0 < float(ph[0]) < 8.25 and 250.0 < float(pco2[0]) < 430.0
    assert float(hco3[0]) > 0.8 * 2.0e-3


@pytest.mark.parametrize("ice", [False, True])
def test_air_sea_co2_flux(cols, ice):
    args = [pair(cols[k][:, 0]) for k in ("dic", "alk", "t", "s")]
    jw, tw = pair(cols["wind"])
    ji, ti = pair(cols["ice"]) if ice else (0.0, 0.0)
    assert_close(tcarb.air_sea_co2_flux(*[a[1] for a in args], tw,
                                        pco2_atm_uatm=400.0, ice_frac=ti),
                 jcarb.air_sea_co2_flux(*[a[0] for a in args], jw,
                                        pco2_atm_uatm=400.0, ice_frac=ji),
                 "flux")


@pytest.mark.parametrize("dms", [False, True])
def test_bgc_tendencies(cols, dms):
    (jh, th), (jsw, tsw) = pair(cols["h"]), pair(cols["sw"])
    pools = [pair(p) for p in cols["npzd"]]
    kw_j = dict(dms=pools[4][0] if dms else None)
    kw_t = dict(dms=pools[4][1] if dms else None)
    assert_close(tbgc.bgc_tendencies(th, tsw, *[p[1] for p in pools[:4]],
                                     tbgc.BgcParams(), **kw_t),
                 jbgc.bgc_tendencies(jh, jsw, *[p[0] for p in pools[:4]],
                                     jbgc.BgcParams(), **kw_j), "tend")


def test_sink_detritus(cols):
    (jh, th), (jd, td) = pair(cols["h"]), pair(np.abs(cols["npzd"][3]))
    for w in (5.0 / 86400.0, 1e-2):          # the second one hits 0.9 CFL
        assert_close(tbgc.sink_detritus(td, th, w, 1800.0),
                     jbgc.sink_detritus(jd, jh, w, 1800.0), "sink")


def states(tracers, h):
    """The same OcnState in both packages (u and ubtr zero)."""
    nE = 1
    j = jcore.OcnState(u=jnp.zeros((nE, h.shape[1])),
                       layerThickness=jnp.asarray(h),
                       tracers=jnp.asarray(tracers), ubtr=jnp.zeros(nE))
    t = tcore.OcnState(u=torch.zeros((nE, h.shape[1]), dtype=torch.float64),
                       layerThickness=torch.from_numpy(h.copy()),
                       tracers=torch.from_numpy(tracers.copy()),
                       ubtr=torch.zeros(nE, dtype=torch.float64))
    return j, t


@pytest.mark.parametrize("with_dms", [False, True])
def test_bgc_step(cols, with_dms):
    tr = np.concatenate([np.stack([cols["t"], cols["s"]], -1),
                         np.moveaxis(cols["npzd"], 0, -1)], -1)
    js, ts = states(tr, cols["h"])
    before = ts.tracers.clone()
    jsw, tsw = pair(cols["sw"])
    got = tbgc.bgc_step(ts, None, 1800.0, tsw, with_dms=with_dms)
    assert_close(got.tracers, jbgc.bgc_step(js, None, 1800.0, jsw,
                                            with_dms=with_dms).tracers,
                 "tracers")
    assert torch.equal(ts.tracers, before)          # out of place
    assert (got.tracers[..., 2:6 + with_dms] >= 0).all()


def test_ecosys_tendencies(cols):
    (jh, th), (jsw, tsw) = pair(cols["h"]), pair(cols["sw"])
    je, te = pair(cols["eco"])
    assert_close(tbgc.ecosys_tendencies(th, tsw, te, tbgc.EcosysParams()),
                 jbgc.ecosys_tendencies(jh, jsw, je, jbgc.EcosysParams()),
                 "eco")


@pytest.fixture(scope="module")
def column():
    """init_ecosys_column on the 24-cell plane, with DIC and ALK appended
    (TestCarbonateSystem's anchor values), in both packages."""
    jg, js = jinit.init_ecosys_column(jplanar.planar_hex_mesh(4, 6, 5000.0),
                                      nz=NZ)
    tg, ts = tinit.init_ecosys_column(tplanar.planar_hex_mesh(4, 6, 5000.0),
                                      nz=NZ)
    tr = np.asarray(js.tracers)
    carbon = np.broadcast_to(np.array([2.0e-3, 2.3e-3]), tr.shape[:2] + (2,))
    tr = np.concatenate([tr, carbon], -1)
    js = js.replace(tracers=jnp.asarray(tr),
                    layerThickness=jnp.asarray(js.layerThickness))
    ts = dataclasses.replace(ts, tracers=torch.from_numpy(tr.copy()))
    return js, ts


def test_ecosys_and_carbon_steps(column, cols):
    js, ts = column
    before = ts.tracers.clone()
    jsw, tsw = pair(cols["sw"])
    jw, tw = pair(cols["wind"])
    for i in range(3):
        js = jbgc.ecosys_step(js, None, 1800.0, jsw)
        ts = tbgc.ecosys_step(ts, None, 1800.0, tsw)
        js, jd = jbgc.carbon_step(js, None, 1800.0, js.tracers[:, 0, 0],
                                  js.tracers[:, 0, 1], jw, 10, 11)
        ts, td = tbgc.carbon_step(ts, None, 1800.0, ts.tracers[:, 0, 0],
                                  ts.tracers[:, 0, 1], tw, 10, 11)
        assert_close(td, jd, f"diag {i}", STEP_REL)
        assert_close(ts.tracers, js.tracers, f"tracers {i}", STEP_REL)
    assert torch.equal(column[1].tracers, before)
    assert (ts.tracers[..., 2:] >= 0).all()
    # only the top layer's DIC moved
    assert torch.equal(ts.tracers[:, 1:, 10:], before[:, 1:, 10:])
    assert not torch.equal(ts.tracers[:, 0, 10], before[:, 0, 10])


def test_three_equation_melt(cols):
    rng = np.random.default_rng(3)
    jt, tt = pair(rng.uniform(-2.5, 3.0, NC))
    js, ts = pair(rng.uniform(33.0, 35.0, NC))
    jp, tp = pair(rng.uniform(0.0, 7e6, NC))
    mask = rng.uniform(size=NC) < 0.7
    assert_close(tlif.three_equation_melt(tt, ts, tp, torch.from_numpy(mask)),
                 jlif.three_equation_melt(jt, js, jp, jnp.asarray(mask)),
                 "melt")


def test_land_ice_fluxes_between_steps():
    """init_isomip_plus, warmed by 2.5 C, then 3 x (one split step of 60
    s, apply_land_ice_fluxes) in both packages (the loop of
    tests/test_ocean_land_ice_flux.py on ISOMIP+)."""
    jg, js, jx = jinit.init_isomip_plus(jplanar.box_hex_mesh(6, 12, 2000.0),
                                        nz=8)
    tg, ts, tx = tinit.init_isomip_plus(tplanar.box_hex_mesh(6, 12, 2000.0),
                                        nz=8)
    jg = jax.tree.map(jnp.asarray, jg)
    js = jax.tree.map(jnp.asarray, js)
    js = js.replace(tracers=js.tracers.at[..., 0].add(2.5))
    f64 = torch.float64
    tg, ts = tg.to("cpu", f64), ts.to("cpu", f64)
    ts = dataclasses.replace(ts, tracers=ts.tracers + torch.tensor(
        [2.5, 0.0], dtype=f64))
    kw = dict(config_dt=60.0)
    jcfg, tcfg = jcore.OcnConfig(**kw), tcore.OcnConfig(**kw)
    for i in range(3):
        js = jcore.run_steps(jg, jcfg, js, 1)
        ts = tcore.run_steps(tg, tcfg, ts, 1)
        before = ts.tracers.clone()
        js, jfx = jlif.apply_land_ice_fluxes(
            jg, jcfg, js, jnp.asarray(jx["landIcePressure"]),
            jnp.asarray(jx["landIceDraft"]), 60.0)
        ts, tfx = tlif.apply_land_ice_fluxes(
            tg, tcfg, ts, tx["landIcePressure"], tx["landIceDraft"], 60.0)
        assert_close(tfx, jfx, f"fluxes {i}", STEP_REL)
        assert_close(ts, js, f"state {i}", STEP_REL)
    assert float(tfx.melt_rate.sum()) > 0.0
    assert torch.equal(before[:, 1:], ts.tracers[:, 1:])   # top layer only
