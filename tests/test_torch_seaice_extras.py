"""The sea-ice core's sharded runner, forcing adapter and analysis members
in the PyTorch port, against the JAX package and the port's own
unsharded runs.

- cores/seaice/distributed.py on 4 loopback shards of box_hex_mesh(12,
  12, 20 km), float64: SeaiceConfig() (weak EVP) and the E3SM options of
  tools/seaice_box.py (variational EVP, incremental remapping, mushy
  column physics, ...), 3 steps of 600 s with 5 elastic subcycles, held
  to the port's unsharded run at 1e-11 x max (it is bit for bit), tracers
  as contents; the per-shard variational basis against the reference's
  per-shard build (nan-cleaned), and the flat loopback build against the
  per-shard ones;
- cores/seaice/forcing_adapter.py over a classic netCDF file written
  here: linear in time, cyclic, the defaults, restart times, against the
  reference's manager;
- cores/seaice/analysis.py: every member through both packages'
  SeaiceAnalysisDriver on the seeded 100-cell box of test_torch_seaice.py
  (both thermodynamics), twice (the deltas and accumulators), at 1e-11 x
  max; the alarm semantics; the member list.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.seaice import analysis as janalysis
from mpas_tpu.cores.seaice import forcing_adapter as jforcing
from mpas_tpu.framework.timekeeping import Time as JTime
from mpas_tpu.framework.timekeeping import TimeInterval as JInterval
from mpas_tpu.parallel.partition import sfc_partition as j_sfc_partition
from mpas_tpu_torch.cores.seaice import analysis as tanalysis
from mpas_tpu_torch.cores.seaice import core as tcore
from mpas_tpu_torch.cores.seaice import distributed as tdist
from mpas_tpu_torch.cores.seaice import forcing_adapter as tforcing
from mpas_tpu_torch.cores.seaice.init_square import init_square
from mpas_tpu_torch.cores.seaice.state import make_grid
from mpas_tpu_torch.cores.seaice.variational import build_variational_coeffs
from mpas_tpu_torch.framework.timekeeping import Time as TTime
from mpas_tpu_torch.framework.timekeeping import TimeInterval as TInterval
from mpas_tpu_torch.io.netcdf import write_netcdf
from mpas_tpu_torch.mesh.planar import box_hex_mesh
from mpas_tpu_torch.parallel.partition import sfc_partition
from mpas_tpu_torch.parallel.runner import device_mesh, gather_field, place
from mpas_tpu_torch.tools import seaice_box as sb
from tests.test_torch_ocean import assert_close
from tests.test_torch_seaice import NILYR, Case, cfgs

torch.set_num_threads(1)

REL = 1e-11
F64 = torch.float64
SHARD_KW = dict(config_dt=600.0, config_elastic_subcycle_number=5)


# ---------------------------------------------------------------- sharded

@pytest.fixture(scope="module")
def box20():
    return box_hex_mesh(12, 12, 20000.0)


def sharded_pair(mesh, name, n_parts, n_steps):
    """(unsharded final state, sharded final state gathered as a dict of
    global numpy fields, its ShardedSeaice)."""
    cfg = sb.config(name, **SHARD_KW)
    grid, state, forcing, _ = sb.setup(name, mesh, cfg, F64, "cpu")
    ref = tcore.run_steps(grid, cfg, state, forcing, n_steps)
    ssi = tdist.shard_seaice_grid(grid, sfc_partition(mesh, n_parts))
    group = device_mesh(n_parts, "cpu")
    out = tdist.make_run_steps_seaice(ssi, cfg, group)(
        ssi.local(group, F64),
        place(tdist.shard_seaice_state(ssi, state), group, F64),
        place(tdist.shard_seaice_forcing(ssi, forcing), group, F64),
        n_steps)
    got = {}
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        if v is None:
            continue
        kind = "vertex" if f.name in ("uVelocity", "vVelocity") else "cell"
        got[f.name] = torch.from_numpy(gather_field(
            ssi.smesh, group.stack(v), kind,
            mesh.nVertices if kind == "vertex" else mesh.nCells))
    return ref, dataclasses.replace(ref, **got), ssi


@pytest.mark.parametrize("name", sb.PATHS)
def test_sharded_matches_unsharded(box20, name):
    ref, got, _ssi = sharded_pair(box20, name, 4, 3)
    held_ref, held_got = sb.held_fields(ref), sb.held_fields(got)
    for k, v in held_ref.items():
        assert_close(held_got[k], v.numpy(), k, REL)
    assert float(ref.uVelocity.abs().max()) > 1e-4


def test_one_shard_bit_for_bit(box20):
    ref, got, _ssi = sharded_pair(box20, "seaice_box_10km", 1, 2)
    for k, v in sb.held_fields(ref).items():
        assert torch.equal(sb.held_fields(got)[k], v), k


def test_elastic_subcycle_exchanges_vertices(box20):
    """The elastic subcycle refreshes u and v at every iteration: two
    vertex exchanges per subcycle, plus the step entry's."""
    cfg = sb.config("seaice_box_10km_default", **SHARD_KW)
    grid, state, forcing, _ = sb.setup("seaice_box_10km_default", box20, cfg,
                                       F64, "cpu")
    ssi = tdist.shard_seaice_grid(grid, sfc_partition(box20, 4))
    group = device_mesh(4, "cpu")
    run = tdist.make_run_steps_seaice(ssi, cfg, group)
    calls = []
    xch_cls = tdist.ShardExchange
    orig = xch_cls.vertex

    def counting(self, x, depth=None):
        calls.append(depth)
        return orig(self, x, depth)
    xch_cls.vertex = counting
    try:
        run(ssi.local(group, F64),
            place(tdist.shard_seaice_state(ssi, state), group, F64),
            place(tdist.shard_seaice_forcing(ssi, forcing), group, F64), 1)
    finally:
        xch_cls.vertex = orig
    n_sub = cfg.config_elastic_subcycle_number
    assert calls.count(2) == 2 * n_sub
    assert calls.count(None) == 2


def test_per_shard_variational_basis(box20):
    """The port's vectorised build on each padded local mesh, dead slots
    included, against the reference's per-cell build with nan_to_num (its
    shard_seaice_grid), and the loopback layout's flat build against the
    per-shard ones (vertex stencils offset into the flat layout)."""
    from mpas_tpu.cores.seaice.variational import (
        build_variational_coeffs as j_build)
    from mpas_tpu.mesh.planar import box_hex_mesh as j_box
    from mpas_tpu.parallel.layout import build_sharded_mesh as j_sharded
    jm = j_box(12, 12, 20000.0)
    jsm = j_sharded(jm, j_sfc_partition(jm, 4), halo_depth=3)
    grid = make_grid(box20, variational=True)
    ssi = tdist.shard_seaice_grid(grid, sfc_partition(box20, 4))
    assert np.array_equal(ssi.smesh.cell_global, np.asarray(jsm.cell_global))
    dead = 0
    for p in range(4):
        jmp = jax.tree.map(lambda a, p=p: np.asarray(a)[p], jsm.mesh)
        with np.errstate(all="ignore"):
            ref = j_build(jmp)
        got = tdist.local_variational_coeffs(ssi.smesh.shard(p))
        for f in dataclasses.fields(got):
            r = np.nan_to_num(np.asarray(getattr(ref, f.name)), nan=0.0,
                              posinf=0.0, neginf=0.0)
            assert_close(getattr(got, f.name), r, f.name, REL)
        dead += int((np.asarray(jsm.cell_global)[p] < 0).sum())
    assert dead > 0                       # the shards carry dead slots
    flat = ssi.local(device_mesh(4, "cpu"), F64).variational
    n = ssi.smesh.mesh.nCells
    nv = ssi.smesh.mesh.nVertices
    on_v = ("cell_on_v", "corner_on_v", "valid_on_v", "area_v")
    for p in range(4):
        own = tdist.local_variational_coeffs(ssi.smesh.shard(p))
        valid = own.valid_on_v > 0
        for f in dataclasses.fields(own):
            k = nv if f.name in on_v else n
            got = getattr(flat, f.name)[p * k:(p + 1) * k]
            want = getattr(own, f.name)
            if f.name == "cell_on_v":
                # a stencil slot that is no slot (valid_on_v 0) points at
                # cell 0 of the layout in either build
                got = torch.where(valid, got, 0)
                want = torch.where(valid, want + p * n, 0)
            assert torch.equal(got, want), f.name


def test_vectorised_build_on_a_padded_mesh_is_finite(box20):
    grid = make_grid(box20)
    ssi = tdist.shard_seaice_grid(grid, sfc_partition(box20, 4))
    vc = build_variational_coeffs(ssi.smesh.shard(0))
    assert all(bool(torch.isfinite(getattr(vc, f.name).double()).all())
               for f in dataclasses.fields(vc))


# ---------------------------------------------------------------- forcing

def _write(path, times, fields, n):
    xt = np.zeros((len(times), 64), dtype="S1")
    for i, s in enumerate(times):
        xt[i, :len(s)] = [c.encode() for c in s]
    variables = {"xtime": (("Time", "StrLen"), xt)}
    for name, vals in fields.items():
        variables[name] = (("Time", "nCells"),
                           np.asarray(vals, dtype=np.float64))
    write_netcdf(str(path), {"Time": len(times), "StrLen": 64, "nCells": n},
                 variables)


@pytest.fixture(scope="module")
def forcing_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("seaice_forcing")
    rng = np.random.default_rng(11)
    n = 7
    atm_t = ["0000-01-01_00:00:00", "0000-01-01_06:00:00",
             "0000-01-01_12:00:00", "0000-01-01_18:00:00"]
    atm = {f: rng.normal(0.0, 5.0, (4, n)) for f in jforcing.ATM_FIELDS}
    ocn_t = ["0000-01-01_00:00:00", "0000-01-16_00:00:00"]
    ocn = {f: rng.normal(0.0, 1.0, (2, n)) for f in jforcing.OCN_FIELDS}
    _write(d / "atm.nc", atm_t, atm, n)
    _write(d / "ocn.nc", ocn_t, ocn, n)
    return str(d / "atm.nc"), str(d / "ocn.nc"), n


@pytest.mark.parametrize("which", ["atm", "both", "none", "cyclic"])
def test_forcing_manager(forcing_files, which):
    atm, ocn, n = forcing_files
    kw_j, kw_t = {}, {}
    if which in ("atm", "both", "cyclic"):
        kw_j["atm_file"] = kw_t["atm_file"] = atm
    if which in ("both", "cyclic"):
        kw_j["ocn_file"] = kw_t["ocn_file"] = ocn
    if which == "cyclic":
        kw_j.update(cycle_start=JTime.from_string("0000-01-01_00:00:00"),
                    cycle_duration=JInterval.from_seconds(86400.0))
        kw_t.update(cycle_start=TTime.from_string("0000-01-01_00:00:00"),
                    cycle_duration=TInterval.from_seconds(86400.0))
    jm = jforcing.SeaiceForcingManager(**kw_j)
    tm = tforcing.SeaiceForcingManager(device="cpu", **kw_t)
    for when in ("0000-01-01_03:00:00", "0000-01-01_07:30:00",
                 "0000-01-05_09:00:00", "0000-01-01_18:00:00"):
        if which != "cyclic" and when.startswith("0000-01-05") \
                and which != "none":
            continue
        ref = jm.get(JTime.from_string(when), n, 11)
        got = tm.get(TTime.from_string(when), n, 11)
        assert_close(got, ref, f"{which} {when}", 1e-15)
        assert got.uAirVelocity.dtype == F64
    when = "0000-01-01_07:00:00"
    assert tm.restart_times(TTime.from_string(when)) \
        == jm.restart_times(JTime.from_string(when))


def test_forcing_feeds_a_timestep(tmp_path):
    mesh = box_hex_mesh(8, 8, 10000.0)
    cfg = sb.config("seaice_box_10km_default", config_dt=3600.0,
                    config_elastic_subcycle_number=30)
    grid, state, _f = init_square(mesh, cfg, F64, "cpu")
    n = mesh.nCells
    _write(tmp_path / "atm.nc", ["0000-01-01_00:00:00",
                                 "0000-01-02_00:00:00"],
           {"uAirVelocity": [np.full(n, 8.0)] * 2,
            "vAirVelocity": [np.zeros(n)] * 2,
            "airTemperature": [np.full(n, -15.0)] * 2,
            "shortwaveDown": [np.zeros(n)] * 2,
            "longwaveDown": [np.full(n, 230.0)] * 2}, n)
    mgr = tforcing.SeaiceForcingManager(atm_file=str(tmp_path / "atm.nc"),
                                        device="cpu")
    frc = mgr.get(TTime.from_string("0000-01-01_06:00:00"), n,
                  mesh.nVertices)
    out, _ = tcore.seaice_timestep(grid, cfg, state, frc, cfg.config_dt)
    assert bool(torch.isfinite(out.uVelocity).all())
    assert float(out.uVelocity.mean()) > 0.0     # wind from +x


# --------------------------------------------------------------- analysis

@pytest.fixture(scope="module")
def case():
    return Case()


def test_available_members():
    assert tanalysis.available_members() == janalysis.available_members()
    assert len(tanalysis.available_members()) == 16
    with pytest.raises(ValueError):
        tanalysis.SeaiceAnalysisDriver({"noSuchMember": 1.0}).init(None,
                                                                   None)


@pytest.mark.parametrize("thermo", ["mushy", "bl99"])
def test_every_member(case, thermo):
    jc, tc = cfgs(config_thermo_type=thermo, config_n_ice_layers=NILYR)
    members = {k: 1.0 for k in janalysis.available_members()}
    jd = janalysis.SeaiceAnalysisDriver(dict(members))
    td = tanalysis.SeaiceAnalysisDriver(dict(members))
    jd.init(case.jgrid, jc)
    td.init(case.tgrid, tc)
    # a second state: the first with the volumes and velocities moved
    a = dict(case.a)
    a2 = {**a, "iceVolumeCategory": a["iceVolumeCategory"] * 1.1,
          "snowVolumeCategory": a["snowVolumeCategory"] * 0.9,
          "iceAreaCategory": a["iceAreaCategory"] * 0.95,
          "uVelocity": -a["uVelocity"]}
    js2 = case.jstate.replace(**{k: jnp.asarray(v) for k, v in a2.items()})
    ts2 = dataclasses.replace(case.tstate, **{
        k: torch.from_numpy(np.array(v)) for k, v in a2.items()})
    for t, (js, ts) in enumerate(((case.jstate, case.tstate), (js2, ts2),
                                  (case.jstate, case.tstate))):
        jd.compute_all(case.jgrid, jc, js, 3600.0 * t)
        td.compute_all(case.tgrid, tc, ts, 3600.0 * t)
    for name in members:
        assert len(td.history[name]) == 3
        for (tt, got), (jt, ref) in zip(td.history[name], jd.history[name]):
            assert tt == jt
            assert set(got) == set(ref), name
            for k, v in ref.items():
                assert_close(got[k], np.asarray(v), f"{name}.{k}", REL)
                assert isinstance(got[k], torch.Tensor), f"{name}.{k}"


def test_members_without_tracers(case):
    """The zero-layer state (no enthalpies, ponds or level ice)."""
    jc, tc = cfgs()
    nil = dict(iceEnthalpy=None, snowEnthalpy=None, pondArea=None,
               pondDepth=None, pondLid=None, levelIceArea=None,
               levelIceVolume=None)
    js = case.jstate.replace(**nil)
    ts = dataclasses.replace(case.tstate, **nil)
    names = ("conservationCheck", "pondDiagnostics", "ridgingDiagnostics",
             "temperatures")
    jd = janalysis.SeaiceAnalysisDriver({k: 1.0 for k in names})
    td = tanalysis.SeaiceAnalysisDriver({k: 1.0 for k in names})
    jd.init(case.jgrid, jc)
    td.init(case.tgrid, tc)
    jd.compute_all(case.jgrid, jc, js)
    td.compute_all(case.tgrid, tc, ts)
    for name in names:
        got, ref = td.history[name][0][1], jd.history[name][0][1]
        for k, v in ref.items():
            assert_close(got[k], np.asarray(v), f"{name}.{k}", REL)


def test_member_options(case):
    jc, tc = cfgs()
    mask = (np.arange(case.jmesh.nCells) % 3 == 0).astype(float)
    regions = {"west": (np.arange(case.jmesh.nCells) < 50).astype(float),
               "east": (np.arange(case.jmesh.nCells) >= 50).astype(float)}
    for jmem, tmem in (
            (janalysis.IceShelves(mask), tanalysis.IceShelves(mask)),
            (janalysis.RegionalStatistics(dict(regions)),
             tanalysis.RegionalStatistics(dict(regions))),
            (janalysis.PointwiseStats((3, 17, 42)),
             tanalysis.PointwiseStats((3, 17, 42)))):
        jmem.init(case.jgrid, jc)
        tmem.init(case.tgrid, tc)
        ref = jmem.compute(case.jgrid, jc, case.jstate)
        got = tmem.compute(case.tgrid, tc, case.tstate)
        for k, v in ref.items():
            assert_close(got[k], np.asarray(v), k, REL)


def test_alarm_semantics(case):
    jc, tc = cfgs()
    members = {"unitConversion": 1200.0, "loadBalance": 1800.0}
    jd = janalysis.SeaiceAnalysisDriver(dict(members))
    td = tanalysis.SeaiceAnalysisDriver(dict(members))
    jd.init(case.jgrid, jc)
    td.init(case.tgrid, tc)
    for t in (0.0, 600.0, 1200.0, 1800.0, 2400.0, 3600.0):
        jd.compute_due(case.jgrid, jc, case.jstate, t)
        td.compute_due(case.tgrid, tc, case.tstate, t)
    for name in members:
        assert [t for t, _ in td.history[name]] \
            == [t for t, _ in jd.history[name]]
    assert [t for t, _ in td.history["unitConversion"]] \
        == [0.0, 1200.0, 2400.0, 3600.0]
