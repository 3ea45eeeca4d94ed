"""The ocean's analysis members, the analysis driver and the Lagrangian
particles of the PyTorch port against the JAX package.

The state is init_global_ocean's on the 642-cell sphere (10 levels, land
columns, varying depth) with u, h and T/S perturbed from a numpy seed.
Every member of available_members() runs through an AnalysisDriver in
both packages at three model times (the alarms, the running filters and
the counters included) and each output is held at 1e-11 x max|ref| with
the same non-finite positions; the port's outputs are tensors. Beside
them: members with their options (MOC regions, census regions, RPN
expressions), TimeSeriesStats windows and climatology buckets,
GlobalStats over 4 loopback shards against the unsharded state, and
ParticleTracker under its four vertical treatments (3 RK2 steps, the
samples) held at 1e-9. Three faults of the reference that the port
shares are shown here (ROADMAP §3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.ocean import analysis as janalysis
from mpas_tpu.cores.ocean import core as jcore
from mpas_tpu.cores.ocean import init_global_ocean as jglobal
from mpas_tpu.cores.ocean.analysis import extra_members as jextra
from mpas_tpu.cores.ocean.analysis import moc as jmoc
from mpas_tpu.cores.ocean.analysis import particles as jparticles
from mpas_tpu.cores.ocean.analysis import time_series_stats as jtss
from mpas_tpu.mesh import planar as jplanar
from mpas_tpu.mesh import sphere as jsphere
from mpas_tpu_torch.cores.ocean import analysis as tanalysis
from mpas_tpu_torch.cores.ocean import core as tcore
from mpas_tpu_torch.cores.ocean import init_global_ocean as tglobal
from mpas_tpu_torch.cores.ocean.analysis import extra_members as textra
from mpas_tpu_torch.cores.ocean.analysis import global_stats as tgs
from mpas_tpu_torch.cores.ocean.analysis import moc as tmoc
from mpas_tpu_torch.cores.ocean.analysis import particles as tparticles
from mpas_tpu_torch.cores.ocean.analysis import time_series_stats as ttss
from mpas_tpu_torch.cores.ocean.distributed import (shard_ocn_grid,
                                                    shard_ocn_state)
from mpas_tpu_torch.mesh import planar as tplanar
from mpas_tpu_torch.mesh import sphere as tsphere
from mpas_tpu_torch.parallel.partition import sfc_partition
from mpas_tpu_torch.parallel.runner import device_mesh, place

torch.set_num_threads(1)

REL = 1e-11
STEP_REL = 1e-9
NZ = 10
F64 = torch.float64


def assert_close(got, ref, name="", rel=REL, atol=0.0):
    """The port's (tensors, dicts, lists, states) against the reference's
    (floats, numpy, jax arrays) at rel x max|ref| (or atol, where larger),
    with the same non-finite positions; ints and strings equal."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            assert_close(getattr(got, f.name), getattr(ref, f.name),
                         f"{name}.{f.name}", rel, atol)
        return
    if isinstance(got, dict):
        assert sorted(got) == sorted(ref), (name, set(got) ^ set(ref))
        for k in got:
            assert_close(got[k], ref[k], f"{name}.{k}", rel, atol)
        return
    if isinstance(got, (list, tuple)) and not (
            got and isinstance(got[0], str)):
        assert len(got) == len(ref), name
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, f"{name}[{i}]", rel, atol)
        return
    if isinstance(ref, (int, str, list)) and not isinstance(ref, bool):
        g = got.item() if isinstance(got, torch.Tensor) else got
        assert g == ref, (name, got, ref)
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, (name, g.shape, r.shape)
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r), name)
    fin = np.isfinite(r)
    if not fin.any():
        return
    scale = max(float(np.abs(r[fin]).max()), 1e-300)
    err = float(np.abs(g[fin] - r[fin]).max())
    assert err <= max(rel * scale, atol), \
        f"{name}: {err:.3e} > {rel:g} x {scale:.3e} (atol {atol:.3e})"


class Case:
    """The perturbed global ocean in both packages."""

    def __init__(self):
        jm = jsphere.icosahedral_mesh(8, lloyd_iters=2)
        tm = tsphere.icosahedral_mesh(8, lloyd_iters=2)
        ds = jglobal.synthetic_woa_dataset()
        jg, js, jf = jglobal.init_global_ocean(jm, ds, nz=NZ)
        tg, ts, tf = tglobal.init_global_ocean(tm, ds, nz=NZ)
        rng = np.random.default_rng(11)
        nC, nE = tm.nCells, tm.nEdges
        emask = np.asarray(jg.edgeMask)
        h = np.asarray(js.layerThickness) * (
            1.0 + 0.05 * rng.standard_normal((nC, NZ)))
        tr = np.asarray(js.tracers).copy()
        tr[..., 0] += 0.5 * rng.standard_normal((nC, NZ))
        tr[..., 1] += 0.05 * rng.standard_normal((nC, NZ))
        self.arrays = dict(u=0.2 * rng.standard_normal((nE, NZ)) * emask,
                           layerThickness=h, tracers=tr,
                           ubtr=np.zeros(nE))
        forcing = dict(sensibleHeatFlux=rng.normal(-50.0, 30.0, nC),
                       shortwaveFlux=rng.uniform(0.0, 300.0, nC),
                       freshwaterFlux=1e-5 * rng.standard_normal(nC),
                       windStressMeridional=0.05 * rng.standard_normal(nC))
        self.jgrid = jax.tree.map(jnp.asarray, jg)
        self.tgrid = tg.to("cpu", F64)
        self.jforcing = jax.tree.map(jnp.asarray, jf).replace(
            **{k: jnp.asarray(v) for k, v in forcing.items()})
        self.tforcing = dataclasses.replace(
            tf, **{k: torch.from_numpy(v) for k, v in forcing.items()}
        ).to("cpu", F64)
        self.jstate = self.jstate_at(0)
        self.tstate = self.tstate_at(0)

    def state_arrays(self, i):
        """The state at the i-th model time: the perturbation rotated."""
        a = {k: v.copy() for k, v in self.arrays.items()}
        a["u"] = a["u"] * (1.0 + 0.3 * i)
        a["tracers"][..., 0] += 0.1 * i
        return a

    def jstate_at(self, i):
        return jcore.OcnState(**{k: jnp.asarray(v) for k, v in
                                 self.state_arrays(i).items()})

    def tstate_at(self, i):
        return tcore.OcnState(**{k: torch.from_numpy(v) for k, v in
                                 self.state_arrays(i).items()})


@pytest.fixture(scope="module")
def case():
    return Case()


def cfgs(**kw):
    return jcore.OcnConfig(**kw), tcore.OcnConfig(**kw)


def test_registry_matches():
    assert tanalysis.available_members() == janalysis.available_members()
    assert len(tanalysis.available_members()) == 19


@pytest.fixture(scope="module")
def driver_histories(case):
    """Every member through both drivers at t = 0, 1,800 and 3,600 s
    (interval 1,800 s; the state changes between calls)."""
    jcfg, tcfg = cfgs(config_dt=1800.0)
    members = {n: 1800.0 for n in janalysis.available_members()}
    jd = janalysis.AnalysisDriver(dict(members))
    td = tanalysis.AnalysisDriver(dict(members))
    jd.init(case.jgrid, jcfg)
    td.init(case.tgrid, tcfg)
    for i, t in enumerate((0.0, 1800.0, 3600.0)):
        jd.compute_due(case.jgrid, jcfg, case.jstate_at(i), t,
                       forcing=case.jforcing)
        td.compute_due(case.tgrid, tcfg, case.tstate_at(i), t,
                       forcing=case.tforcing)
    return jd.history, td.history


@pytest.mark.parametrize("name", janalysis.available_members())
def test_member_through_driver(driver_histories, name):
    jh, th = driver_histories
    assert len(th[name]) == len(jh[name]) == 3
    for (tt, got), (tj, ref) in zip(th[name], jh[name]):
        assert tt == tj
        assert_close(got, ref, name)
        for v in got.values():     # device results, no host copies
            assert isinstance(v, (torch.Tensor, int, list)), (name, type(v))


def test_driver_alarms_and_unknown_member(case):
    jcfg, tcfg = cfgs()
    td = tanalysis.AnalysisDriver({"testComputeInterval": 3600.0,
                                   "globalStats": 1800.0})
    td.init(case.tgrid, tcfg)
    for t in np.arange(0.0, 7201.0, 900.0):
        td.compute_due(case.tgrid, tcfg, case.tstate, float(t))
    assert [t for t, _ in td.history["testComputeInterval"]] \
        == [0.0, 3600.0, 7200.0]
    assert len(td.history["globalStats"]) == 5
    assert int(td.history["testComputeInterval"][-1][1]["computeCount"]) \
        == 3
    td.compute_all(case.tgrid, tcfg, case.tstate, 7300.0)
    assert len(td.history["globalStats"]) == 6
    with pytest.raises(ValueError):
        tanalysis.AnalysisDriver({"noSuchMember": 1.0}).init(case.tgrid,
                                                             tcfg)


def test_moc_regions(case):
    jcfg, tcfg = cfgs()
    lat = np.asarray(case.jgrid.mesh.latCell)
    regions = {"east": np.asarray(case.jgrid.mesh.lonCell) < np.pi,
               "tropics": np.abs(lat) < 0.5}
    j = jmoc.MocStreamfunction(n_bins=9, regions=regions)
    t = tmoc.MocStreamfunction(n_bins=9, regions=regions)
    j.init(case.jgrid, jcfg)
    t.init(case.tgrid, tcfg)
    assert_close(t.compute(case.tgrid, tcfg, case.tstate),
                 j.compute(case.jgrid, jcfg, case.jstate), "moc")


def test_member_options(case):
    """Census regions of the caller, an RPN expression with literals and
    all four operators, a jm EOS."""
    jcfg, tcfg = cfgs(config_eos_type="jm")
    lon = np.asarray(case.jgrid.mesh.lonCell)
    for cls, attrs in (
            ("WaterMassCensus", dict(region_masks={"a": lon < 2.0,
                                                   "b": lon >= 2.0})),
            ("RpnCalculator", dict(expression="temperature 2 * salinity "
                                   "/ 1.5 - layerThickness *")),
            ("RpnCalculator", dict(expression="ssh 2 + ssh *")),
            ("RpnCalculator", dict(expression="2 3 *")),
            ("RpnCalculator", dict(expression="temperature salinity "
                                   "sigma")),
            ("RegionalStats", dict(region_masks={
                "all": np.ones_like(lon, bool),
                "none": np.zeros_like(lon, bool)}))):
        j, t = getattr(jextra, cls)(), getattr(textra, cls)()
        for k, v in attrs.items():
            setattr(j, k, v)
            setattr(t, k, v)
        j.init(case.jgrid, jcfg)
        t.init(case.tgrid, tcfg)
        assert_close(t.compute(case.tgrid, tcfg, case.tstate),
                     j.compute(case.jgrid, jcfg, case.jstate), cls)
    t = textra.RpnCalculator()
    t.expression = "temperature salinity"
    with pytest.raises(ValueError):
        t.compute(case.tgrid, tcfg, case.tstate)


def test_debug_diagnostics_counts_nans(case):
    jcfg, tcfg = cfgs()
    u = case.arrays["u"].copy()
    u[3, 2] = np.nan
    jst = case.jstate.replace(u=jnp.asarray(u))
    tst = dataclasses.replace(case.tstate, u=torch.from_numpy(u))
    assert_close(textra.DebugDiagnostics().compute(case.tgrid, tcfg, tst),
                 jextra.DebugDiagnostics().compute(case.jgrid, jcfg, jst),
                 "debug")


@pytest.mark.parametrize("n_buckets", [1, 3])
def test_time_series_stats(case, n_buckets):
    jcfg, tcfg = cfgs()
    fields = ("ssh", "temperatureSurface", "kineticEnergyColumn")
    j = jtss.TimeSeriesStats(window_seconds=3600.0, fields=fields,
                             n_buckets=n_buckets)
    t = ttss.TimeSeriesStats(window_seconds=3600.0, fields=fields,
                             n_buckets=n_buckets)
    j.init(case.jgrid, jcfg)
    t.init(case.tgrid, tcfg)
    for i in range(10):
        j.accumulate(case.jgrid, jcfg, case.jstate_at(i % 4), 1800.0 * i)
        t.accumulate(case.tgrid, tcfg, case.tstate_at(i % 4), 1800.0 * i)
    assert len(t.records) == len(j.records) == 4
    for (tt, tb, trec), (jt, jb, jrec) in zip(t.records, j.records):
        assert (tt, tb) == (jt, jb)
        assert_close(trec, jrec, f"record {tt}")
    for b in range(n_buckets):
        if j.climatology(b) is None:
            assert t.climatology(b) is None
        else:
            assert_close(t.climatology(b), j.climatology(b), f"bucket {b}")
    with pytest.raises(ValueError):
        ttss.TimeSeriesStats(3600.0, fields=("nope",)).init(case.tgrid,
                                                             tcfg)


def test_global_stats_sharded(case):
    """GlobalStats over 4 loopback shards (owned entities only, through
    psum_owned / pmin_owned / pmax_owned) against the unsharded state."""
    _, tcfg = cfgs(config_dt=1800.0)
    ref = tgs.GlobalStats()
    ref.init(case.tgrid, tcfg)
    want = ref.compute(case.tgrid, tcfg, case.tstate)
    socn = shard_ocn_grid(case.tgrid, sfc_partition(case.tgrid.mesh, 4))
    group = device_mesh(4, "cpu")
    grid_l = socn.local(group, F64)
    state_l = place(shard_ocn_state(socn, case.tstate), group, F64)
    stats = tgs.GlobalStats(group, socn.smesh)
    stats.init(grid_l, tcfg)
    got = stats.compute(grid_l, tcfg, state_l)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], k)
    with pytest.raises(ValueError):
        tgs.GlobalStats(group)


# ---------------------------------------------------------------------------
# particles
# ---------------------------------------------------------------------------

MODES = ("indexLevel", "fixedZLevel", "passiveFloat", "isopycnal")


def seed_kw(mesh, cells, mode):
    """One particle at the centre of each of `cells` (numpy), with the
    vertical state of `mode`."""
    n = len(cells)
    kw = dict(x0=np.asarray(mesh.xCell)[cells],
              y0=np.asarray(mesh.yCell)[cells],
              z0=np.asarray(mesh.zCell)[cells], layer=1,
              vertical_mode=mode)
    if mode in ("fixedZLevel", "passiveFloat"):
        kw["depth"] = np.linspace(5.0, 400.0, n)
    if mode == "isopycnal":
        kw["target_rho"] = np.linspace(1024.0, 1028.0, n)
    return kw


def w_top(core, grid, state, mesh):
    """The vertical transport w_top (nCells, nz + 1) of `state`: the
    masked thickness flux through thickness_tendency (either package)."""
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    h = state.layerThickness
    uh = state.u * 0.5 * (h[c1] + h[c2]) * grid.edgeMask
    return core.thickness_tendency(grid, uh)[2]


@pytest.mark.parametrize("mode", MODES)
def test_particles(case, mode):
    jcfg, tcfg = cfgs()
    jm, tm = case.jgrid.mesh, case.tgrid.mesh
    ocean = np.nonzero(np.asarray(case.jgrid.tidalEnergyFlux) > 0)[0]
    jp = jparticles.ParticleTracker(jm, **seed_kw(jm, ocean, mode))
    tp = tparticles.ParticleTracker(tm, **seed_kw(jm, ocean, mode))
    assert_close(tp.state, jp.state, "seeded")
    np.testing.assert_array_equal(tp.state.cell.numpy(), ocean)
    for i in range(3):
        js, ts = case.jstate_at(i), case.tstate_at(i)
        jrho = jcore.equation_of_state(jcfg, js.tracers[..., 0],
                                       js.tracers[..., 1])
        trho = tcore.equation_of_state(tcfg, ts.tracers[..., 0],
                                       ts.tracers[..., 1])
        jp.step(js.u, 1800.0, layer_thickness=js.layerThickness,
                w_vert=w_top(jcore, case.jgrid, js, jm), density=jrho)
        tp.step(ts.u, 1800.0, layer_thickness=ts.layerThickness,
                w_vert=w_top(tcore, case.tgrid, ts, tm), density=trho)
        assert_close(tp.state, jp.state, f"step {i}", STEP_REL)
    for f in (case.tstate.tracers[..., 0], case.tstate.layerThickness[:, 0]):
        jf = jnp.asarray(f.numpy())
        assert_close(tp.sample(f), jp.sample(jf), "sample", STEP_REL)
        assert_close(tp.sample_interp(f), jp.sample_interp(jf),
                     "sample_interp", STEP_REL)


def test_particles_on_a_periodic_plane():
    """The planar branch: periodic wrap of positions and displacements."""
    jm = jplanar.planar_hex_mesh(12, 16, 10000.0)
    tm = tplanar.planar_hex_mesh(12, 16, 10000.0).to("cpu", F64)
    rng = np.random.default_rng(2)
    x0 = rng.uniform(0.0, jm.x_period, 40)
    y0 = rng.uniform(0.0, jm.y_period, 40)
    u = 5.0 * rng.standard_normal((jm.nEdges, 3))
    jp = jparticles.ParticleTracker(jm, x0, y0, layer=2)
    tp = tparticles.ParticleTracker(tm, x0, y0, layer=2)
    for _ in range(4):
        jp.step(jnp.asarray(u), 3000.0)
        tp.step(torch.from_numpy(u), 3000.0)
    assert_close(tp.state, jp.state, "plane", STEP_REL)
    with pytest.raises(ValueError):
        tparticles.ParticleTracker(tsphere.icosahedral_mesh(4).to("cpu",
                                                                  F64),
                                   x0, y0)


# ---------------------------------------------------------------------------
# faults of the reference, shared by the port (ROADMAP §3)
# ---------------------------------------------------------------------------

def test_regional_stats_bottom_is_level_nz_minus_1(case):
    """RegionalStats' bottomTemperature is the temperature at level nz-1
    (extra_members.py:387-388), not at maxLevelCell-1: on the global
    ocean's shallow and land columns it reports an inactive layer. Both
    packages agree with each other and differ from the active bottom."""
    jcfg, tcfg = cfgs()
    j, t = jextra.RegionalStats(), textra.RegionalStats()
    j.init(case.jgrid, jcfg)
    t.init(case.tgrid, tcfg)
    jout = j.compute(case.jgrid, jcfg, case.jstate)
    tout = t.compute(case.tgrid, tcfg, case.tstate)
    T = case.arrays["tracers"][..., 0]
    mlc = np.asarray(case.jgrid.maxLevelCell)
    active_bottom = T[np.arange(len(mlc)), mlc - 1]
    assert (mlc < NZ).sum() > 50                    # varying depth
    area = np.asarray(case.jgrid.mesh.areaCell)
    for region, mask in j.region_masks.items():
        w = area[mask] / area[mask].sum()
        key = f"{region}AvgbottomTemperature"
        assert abs(float(tout[key]) - jout[key]) <= REL * abs(jout[key])
        assert abs(jout[key] - (T[mask, NZ - 1] * w).sum()) <= 1e-12
        # the active bottom's average differs by tenths of a degree
        assert abs(jout[key] - (active_bottom[mask] * w).sum()) > 0.05


def test_particle_start_walk_reaches_60_cells():
    """ParticleTracker walks every particle from cell 0 for 60 steps
    (particles.py:117-118): on a channel 200 cells long the far end is
    never reached, in either package; a starting cell (cell0, the port's
    addition) reaches it."""
    jm = jplanar.channel_hex_mesh(4, 200, 1000.0)
    tm = tplanar.channel_hex_mesh(4, 200, 1000.0).to("cpu", F64)
    far = np.array([jm.nCells - 1, jm.nCells - 3])
    xy = (np.asarray(jm.xCell)[far], np.asarray(jm.yCell)[far])
    jcell = np.asarray(jparticles.ParticleTracker(jm, *xy).state.cell)
    tcell = tparticles.ParticleTracker(tm, *xy).state.cell.numpy()
    np.testing.assert_array_equal(tcell, jcell)
    assert (jcell != far).all()
    hinted = tparticles.ParticleTracker(tm, *xy, cell0=far - 40)
    np.testing.assert_array_equal(hinted.state.cell.numpy(), far)


def test_climatology_overwrites_first_record(case):
    """TimeSeriesStats' climatology bucket holds the first window's record
    dict itself (time_series_stats.py:85), so every repeat of the bucket
    rewrites that record in `records` with the running mean, in both
    packages: the first window's surface temperature reads as the mean of
    windows 0, 2 and 4 (0.2 C warmer)."""
    t0 = case.arrays["tracers"][:, 0, 0]
    for mod, grid, cfg, at in (
            (jtss, case.jgrid, jcore.OcnConfig(), case.jstate_at),
            (ttss, case.tgrid, tcore.OcnConfig(), case.tstate_at)):
        s = mod.TimeSeriesStats(window_seconds=1800.0,
                                fields=("temperatureSurface",), n_buckets=2)
        s.init(grid, cfg)
        for i in range(5):
            s.accumulate(grid, cfg, at(i), 1800.0 * (i + 1))
        first = s.records[0][2]["temperatureSurface_avg"]
        assert s.climatology(0)["temperatureSurface_avg"] is first
        np.testing.assert_allclose(np.asarray(first), t0 + 0.2, rtol=0,
                                   atol=1e-12)
