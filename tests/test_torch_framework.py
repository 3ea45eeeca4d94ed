"""The port's framework layer against the JAX package's, on the CPU:
timekeeping (the strings of both packages equal, across the three
calendars), namelists into each core's config, streams (the XML parser
and the clobber, package and regex behaviour of tests/test_framework.py),
NetCDF files read across the packages bit for bit, timers and the log,
the mesh cache, ops/geometry.py (1e-12 x max), the test core's self-tests,
and init case 6 (init_mtn_wave: 1e-12 x max at the start, 1e-9 after 5
steps, float64). Both packages' mesh caches point at a temporary
directory.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import time_integration as jti
from mpas_tpu.cores.atmosphere.config import AtmConfig as JAtmConfig
from mpas_tpu.cores.atmosphere.init_mtn_wave import \
    init_mtn_wave as jax_init_mtn_wave
from mpas_tpu.cores.ocean.core import OcnConfig as JOcnConfig
from mpas_tpu.cores.sw.config import SWConfig as JSWConfig
from mpas_tpu.framework import namelist as jnml
from mpas_tpu.framework import streams as jstreams
from mpas_tpu.framework import timekeeping as jtk
from mpas_tpu.io import netcdf as jnc
from mpas_tpu.mesh.planar import planar_hex_mesh as jax_planar_hex_mesh
from mpas_tpu.ops import geometry as jgeo
from mpas_tpu_torch.cores.atmosphere import time_integration as tti
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_mtn_wave import init_mtn_wave
from mpas_tpu_torch.cores.ocean.config import OcnConfig
from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.cores.sw.hooks import parse_mesh_spec
from mpas_tpu_torch.cores.test_core import core as test_core
from mpas_tpu_torch.framework import namelist as tnml
from mpas_tpu_torch.framework import streams as tstreams
from mpas_tpu_torch.framework import timekeeping as ttk
from mpas_tpu_torch.framework.log import LogManager, MPASLogError
from mpas_tpu_torch.framework.timers import TimerManager
from mpas_tpu_torch.io import netcdf as tnc
from mpas_tpu_torch.mesh import cache as tcache
from mpas_tpu_torch.mesh.planar import planar_hex_mesh
from mpas_tpu_torch.ops import geometry as tgeo

torch.set_num_threads(1)

CALENDARS = ("gregorian", "gregorian_noleap", "360day")


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' mesh caches in the test's temporary directory."""
    monkeypatch.setenv("MPAS_TPU_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.setenv("MPAS_TPU_TORCH_CACHE", str(tmp_path / "torch_cache"))


# ---------------------------------------------------------------------------
# timekeeping
# ---------------------------------------------------------------------------

TIMES = ("0000-01-01_00:00:00", "2000-02-28_23:59:59",
         "1999-12-31_12:30:00", "2000-02-29_06:00:00",
         "2100-03-01_00:00:00.25", "0001-11-30_18:00:00")
INTERVALS = ("1_00:00:00", "6:00:00", "0_01:30:00", "12:00:00",
             "400_00:00:00", "0:00:00.5", "0000-01-00_00:00:00",
             "0001-02-03_04:05:06")


def times_of(cal):
    """TIMES that exist in the calendar (no 29 February in noleap)."""
    return [s for s in TIMES
            if not (cal == "gregorian_noleap" and s.startswith("2000-02-29"))]


@pytest.mark.parametrize("cal,s", [(c, s) for c in CALENDARS
                                   for s in times_of(c)])
def test_time_parse_and_format_match(cal, s):
    got = ttk.Time.from_string(s, cal)
    ref = jtk.Time.from_string(s, cal)
    assert got.us == ref.us and got.to_string() == ref.to_string()


@pytest.mark.parametrize("cal", CALENDARS)
@pytest.mark.parametrize("iv", INTERVALS)
def test_interval_arithmetic_matches(cal, iv):
    for s in times_of(cal):
        got, ref = ttk.Time.from_string(s, cal), jtk.Time.from_string(s, cal)
        gi, ri = ttk.TimeInterval.from_string(iv), \
            jtk.TimeInterval.from_string(iv)
        assert (gi.months, gi.us) == (ri.months, ri.us)
        for k in (1, 3, -2):
            assert (got + gi * k).to_string() == (ref + ri * k).to_string()
        assert (got - gi).to_string() == (ref - ri).to_string()
    dt = ttk.TimeInterval.from_seconds(172.8)
    t0 = ttk.Time.from_string("0000-01-01_00:00:00", cal)
    assert (t0 + dt * 500).to_string() == "0000-01-02_00:00:00"


def ring_sequence(tk, cal, dt_s, interval, steps, one_shot=None):
    start = tk.Time.from_string("2000-01-30_00:00:00", cal)
    clock = tk.Clock(start, tk.TimeInterval.from_seconds(dt_s),
                     run_duration=tk.TimeInterval.from_seconds(
                         dt_s * steps))
    clock.add_alarm(tk.Alarm("a", interval=tk.TimeInterval.from_string(
        interval), reference=start))
    if one_shot:
        clock.add_alarm(tk.Alarm("once", ring_time=start + tk.TimeInterval
                                 .from_string(one_shot)))
    rings = []
    while not clock.is_stop_time():
        for name in clock.alarms:
            if clock.is_ringing(name):
                rings.append((name, clock.now.to_string()))
                clock.reset_alarm(name)
        clock.advance()
    return rings, clock.steps_until_stop()


@pytest.mark.parametrize("cal", CALENDARS)
@pytest.mark.parametrize("dt_s,interval,steps,one_shot", [
    (3600.0, "6:00:00", 25, None),
    (1800.0, "1:00:00", 9, "2:30:00"),
    (720.0, "1:00:00", 30, None),
    (86400.0, "0000-01-00_00:00:00", 70, "10_00:00:00"),
])
def test_alarm_ring_sequences_match(cal, dt_s, interval, steps, one_shot):
    got = ring_sequence(ttk, cal, dt_s, interval, steps, one_shot)
    assert got == ring_sequence(jtk, cal, dt_s, interval, steps, one_shot)
    assert got[0]


# ---------------------------------------------------------------------------
# namelists
# ---------------------------------------------------------------------------

NAMELIST = """&nhyd_model
   config_dt = 150.0d0
   config_start_time = '2000-01-01_00:00:00'
   config_run_duration = '5_00:00:00'
   config_monotonic = .false.
   config_do_restart = .true.   ! a comment
   config_nvertlevels = 41,
   config_time_integrator = 'RK4'
   config_test_case = 2
   config_unknown_option = 3
/
&damping
   config_zd = 2.2e4
   config_physics_suite = 'mesoscale_reference'
   config_calendar_type = 'gregorian'
   config_vert_visc = 2.5D-4
/
"""


@pytest.mark.parametrize("port_cls,jax_cls", [
    (AtmConfig, JAtmConfig), (SWConfig, JSWConfig), (OcnConfig, JOcnConfig)])
def test_namelist_into_each_config_matches(tmp_path, port_cls, jax_cls):
    path = tmp_path / "namelist"
    path.write_text(NAMELIST)
    got = dataclasses.asdict(tnml.from_namelist_file(port_cls, str(path)))
    ref = dataclasses.asdict(jnml.from_namelist_file(jax_cls, str(path)))
    assert got == ref
    assert got["config_dt"] == 150.0 and got["config_do_restart"] is True
    assert got["config_run_duration"] == "5_00:00:00"
    assert tnml.parse_namelist_file(str(path)) \
        == jnml.parse_namelist_file(str(path))


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

STREAMS_XML = """<streams>
<immutable_stream name="restart" type="input;output"
   filename_template="restart.$Y-$M-$D_$h.$m.$s.nc"
   input_interval="initial_only" output_interval="1_00:00:00"/>
<stream name="output" type="output" filename_template="output.nc"
   output_interval="6:00:00" clobber_mode="append" packages="pkgA;pkgB">
   <var name="h"/> <var name="u"/> <var_array name="tracers"/>
</stream>
<stream name="diag" filename_template="diag.$Y.nc"/>
</streams>"""


def test_parse_streams_xml_matches(tmp_path):
    path = tmp_path / "streams.sw"
    path.write_text(STREAMS_XML)
    got = [dataclasses.asdict(s)
           for s in tstreams.parse_streams_xml(str(path))]
    ref = [{k: v for k, v in dataclasses.asdict(s).items() if k in got[0]}
           for s in jstreams.parse_streams_xml(str(path))]
    assert got == ref
    assert [s["name"] for s in got] == ["restart", "output", "diag"]
    assert got[1]["fields"] == ["h", "u", "tracers"]


def test_filename_template_matches():
    for cal in CALENDARS:
        t = "2000-02-28_06:30:15.5"
        assert tstreams.expand_filename_template(
            "out.$Y-$M-$D_$h.$m.$s.nc", ttk.Time.from_string(t, cal)) \
            == jstreams.expand_filename_template(
                "out.$Y-$M-$D_$h.$m.$s.nc", jtk.Time.from_string(t, cal)) \
            == "out.2000-02-28_06.30.15.nc"


def stream_manager(tmp_path, active=None, clobber="overwrite"):
    """tests/test_framework.py:275-293 against the port."""
    clock = ttk.Clock(ttk.Time.from_string("0001-01-01_00:00:00",
                                           "gregorian"),
                      ttk.TimeInterval.from_string("01:00:00"))
    mgr = tstreams.StreamManager(clock, run_dir=str(tmp_path),
                                 active_packages=active)
    mgr.add_stream(tstreams.Stream(
        name="output", direction="output", filename_template="out.nc",
        fields=["h", "extraB"], output_interval="01:00:00",
        clobber_mode=clobber, field_packages={"extraB": ("pkgB",)}))
    for name in ("block_1", "block_2"):
        mgr.add_stream(tstreams.Stream(
            name=name, direction="output", filename_template=f"{name}.nc",
            fields=["h"], output_interval="01:00:00"))
    return mgr, clock


def provider(f):
    return ("nCells",), np.arange(4.0)


def test_inactive_package_field_vanishes_from_output(tmp_path):
    mgr, _ = stream_manager(tmp_path, active={"pkgA"})
    data, _, _ = tnc.read_netcdf(mgr.write("output", provider, {"nCells": 4},
                                           force=True))
    assert "h" in data and "extraB" not in data
    mgr2, _ = stream_manager(tmp_path, active={"pkgA", "pkgB"})
    data2, _, _ = tnc.read_netcdf(mgr2.write("output", provider,
                                             {"nCells": 4}, force=True))
    assert "extraB" in data2


def test_stream_of_inactive_packages_is_skipped(tmp_path):
    mgr, _ = stream_manager(tmp_path, active={"pkgA"})
    mgr.streams["block_1"].packages = ("pkgC",)
    assert mgr.write("block_1", provider, {"nCells": 4}, force=True) is None
    assert not (tmp_path / "block_1.nc").exists()


def test_regex_stream_ids(tmp_path):
    mgr, _ = stream_manager(tmp_path)
    assert sorted(mgr.streams_matching("block_.*")) == ["block_1", "block_2"]
    assert mgr.streams_matching("output") == ["output"]
    assert mgr.streams_matching("block_") == []
    out = mgr.write_matching("block_.*", provider, {"nCells": 4}, force=True)
    assert len(out) == 2 and all(o is not None for o in out)


def test_clobber_never_modify_protects_the_file(tmp_path):
    mgr, _ = stream_manager(tmp_path, clobber="never_modify")
    mgr.write("output", provider, {"nCells": 4}, force=True)
    with pytest.raises(FileExistsError):
        mgr.write("output", provider, {"nCells": 4}, force=True)


def test_clobber_append_accumulates_records(tmp_path):
    mgr, _ = stream_manager(tmp_path, clobber="append")
    fn = mgr.write("output", provider, {"nCells": 4}, force=True)
    mgr.write("output", provider, {"nCells": 4}, force=True)
    data, _, _ = tnc.read_netcdf(fn)
    assert data["h"].shape[0] == 2 and data["xtime"].shape == (2, 64)


def test_alarm_gates_writes_and_read_back(tmp_path):
    """A 6-hourly stream writes at 0, 6 and 12 h of 13 hourly steps; the
    last file reads back through the stream."""
    clock = ttk.Clock(ttk.Time.from_string("0000-01-01_00:00:00"),
                      ttk.TimeInterval.from_seconds(3600.0))
    mgr = tstreams.StreamManager(clock, run_dir=str(tmp_path))
    mgr.add_stream(tstreams.Stream(
        name="output", direction="output",
        filename_template="output.$Y-$M-$D_$h.$m.$s.nc", fields=["h"],
        output_interval="6:00:00"))
    h = np.linspace(0.0, 1.0, 4)
    written = []
    for _ in range(13):
        fn = mgr.write("output", lambda f: (("nCells",), h), {"nCells": 4})
        if fn:
            written.append(os.path.basename(fn))
        clock.advance()
    assert written == ["output.0000-01-01_00.00.00.nc",
                       "output.0000-01-01_06.00.00.nc",
                       "output.0000-01-01_12.00.00.nc"]
    data, _, _ = mgr.read("output", at_time=ttk.Time.from_string(
        "0000-01-01_12:00:00"))
    assert np.array_equal(data["h"], h)


# ---------------------------------------------------------------------------
# NetCDF across the packages
# ---------------------------------------------------------------------------

def netcdf_case():
    rng = np.random.default_rng(3)
    dims = {"Time": None, "StrLen": 64, "nCells": 7, "nVertLevels": 3}
    xtime = np.frombuffer("0000-01-01_00:00:00".ljust(64).encode(),
                          dtype="S1").reshape(1, 64)
    variables = {
        "xtime": (("Time", "StrLen"), xtime),
        "theta": (("Time", "nCells", "nVertLevels"),
                  rng.standard_normal((1, 7, 3))),
        "h32": (("nCells",), rng.standard_normal(7).astype(np.float32)),
        "idx": (("nCells",), np.arange(7, dtype=np.int64) * 3),
    }
    return dims, variables, {"model_name": "x", "core_name": "sw"}


@pytest.mark.parametrize("writer,reader", [(tnc, jnc), (jnc, tnc)],
                         ids=["port_to_jax", "jax_to_port"])
def test_netcdf_reads_across_packages_bit_for_bit(tmp_path, writer, reader):
    dims, variables, attrs = netcdf_case()
    path = str(tmp_path / "f.nc")
    writer.write_netcdf(path, dims, variables, attrs=attrs)
    data, rdims, rattrs = reader.read_netcdf(path)
    assert rdims == {"Time": None, "StrLen": 64, "nCells": 7,
                     "nVertLevels": 3}
    assert {k: v.decode() for k, v in rattrs.items()} == attrs
    for k, (_, arr) in variables.items():
        want = arr.astype(np.int32) if arr.dtype == np.int64 else arr
        assert data[k].dtype == want.dtype and np.array_equal(data[k], want)


def test_hdf5_input_is_refused(tmp_path):
    """netCDF4/HDF5 input goes to io/hdf5.py (no longer refused as such):
    a truncated file is refused with its HDF5Error, a zero-filled
    superblock reads as empty in both packages, and a netCDF4 file reads
    back."""
    from mpas_tpu_torch.io.hdf5 import HDF5Error
    from mpas_tpu_torch.io.hdf5_write import write_hdf5
    path = tmp_path / "grid.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n")
    with pytest.raises(HDF5Error):
        tnc.read_netcdf(str(path))
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    assert tnc.read_netcdf(str(path)) == jnc.read_netcdf(str(path)) \
        == ({}, {}, {"__vardims__": {}})
    write_hdf5(str(path), {"n": 3}, {"y": (("n",), np.arange(3.0))})
    v, d, _ = tnc.read_netcdf(str(path))
    assert d == {"n": 3} and np.array_equal(v["y"], np.arange(3.0))


# ---------------------------------------------------------------------------
# timers and log
# ---------------------------------------------------------------------------

def test_timer_nesting_and_sync(monkeypatch):
    """The event-based timers on a stand-in card whose events complete
    when marked or synchronised (1 ms between records): nesting, counts,
    pairs resolved at a timer's exit once complete, a table row of
    calls, host and device seconds per timer, and no synchronise but the
    table's."""
    events, syncs = [], []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.done = False

        def record(self, stream=None):
            self.ms = float(len(events))
            events.append(self)

        def query(self):
            return self.done

        def elapsed_time(self, end):
            assert self.done and end.done
            return end.ms - self.ms

    def synchronize(device=None):
        syncs.append(device)
        for e in events:
            e.done = True

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    tm = TimerManager("cuda")
    with tm.timer("outer"):          # events at 0 ms and 5 ms
        with tm.timer("inner"):      # 1-2 ms
            pass
        with tm.timer("inner"):      # 3-4 ms
            pass
    outer = tm.root.children["outer"]
    inner = outer.children["inner"]
    assert (outer.count, inner.count) == (1, 2)
    assert len(inner.pending) == 2 and inner.device == 0.0
    for e in events:                 # the card catches up
        e.done = True
    with tm.timer("outer"):          # 6-7 ms; its exit resolves the
        pass                         # first pair, its own still runs
    assert outer.count == 2 and len(outer.pending) == 1
    assert outer.device == pytest.approx(0.005)
    assert len(inner.pending) == 2 and not syncs
    lines = tm.table().splitlines()
    assert len(syncs) == 1 and not inner.pending and not outer.pending
    assert float(lines[1].split()[-1]) == pytest.approx(0.006)
    assert lines[0].split()[-4:] == ["host", "(s)", "device", "(s)"]
    assert lines[1].split()[:2] == ["outer", "2"]
    assert lines[2].startswith("  inner")
    assert float(lines[2].split()[-1]) == pytest.approx(0.002)
    assert inner.host >= 0.0 and outer.host >= inner.host
    # off a card: host seconds only, and nothing synchronised
    cpu = TimerManager("cpu")
    with cpu.timer("step"):
        pass
    row = cpu.table().splitlines()[1].split()
    assert row[:2] == ["step", "1"] and row[-1] == "-"
    assert len(syncs) == 1 and len(events) == 8


def test_log_crit_raises(tmp_path):
    log = LogManager("sw", run_dir=str(tmp_path))
    log.write("hello {x}", x=42)
    log.write("careful", message_type="WARN")
    with pytest.raises(MPASLogError, match="boom"):
        log.write("boom", message_type="CRIT")
    with pytest.raises(ValueError):
        log.write("?", message_type="DEBUG")
    log.close()
    text = (tmp_path / "log.sw.0000.out").read_text()
    assert text.splitlines() == ["hello 42", "WARNING: careful",
                                 "CRITICAL ERROR: boom"]


# ---------------------------------------------------------------------------
# mesh cache, mesh specs
# ---------------------------------------------------------------------------

def assert_meshes_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y and type(x) is type(y), f.name


@pytest.mark.parametrize("build", [
    lambda: planar_hex_mesh(6, 4, 1000.0),
    lambda: parse_mesh_spec("icos:4")], ids=["hex", "icos"])
def test_cached_mesh_equals_the_built_one(tmp_path, build):
    mesh = build()
    built = []
    got = tcache.cached("m", lambda: built.append(1) or mesh)
    again = tcache.cached("m", lambda: built.append(1) or mesh)
    assert built == [1]
    assert_meshes_equal(got, mesh)
    assert_meshes_equal(again, mesh)
    assert os.path.dirname(tcache.cache_dir()) == str(tmp_path)
    assert "m.npz" in os.listdir(tcache.cache_dir())


def test_mesh_specs(tmp_path):
    """The generated specs, and grid files (file:PATH or PATH.nc): a
    missing file raises, a written one reads back."""
    from mpas_tpu_torch.mesh.gridfile import mesh_to_netcdf
    assert parse_mesh_spec("channel:8,26,10000").nCells == 192
    hexm = parse_mesh_spec("hex:12,12,2000")
    assert hexm.nCells == 144
    for spec in ("file:" + str(tmp_path / "grid.nc"),
                 str(tmp_path / "x1.2562.grid.nc")):
        with pytest.raises(FileNotFoundError):
            parse_mesh_spec(spec)
    mesh_to_netcdf(hexm, str(tmp_path / "x1.144.grid.nc"), fmt="netcdf4")
    for spec in ("file:" + str(tmp_path / "x1.144.grid.nc"),
                 str(tmp_path / "x1.144.grid.nc")):
        m = parse_mesh_spec(spec)
        assert m.nCells == 144 and torch.equal(m.areaCell, hexm.areaCell)
    with pytest.raises(ValueError):
        parse_mesh_spec("cube:4")


# ---------------------------------------------------------------------------
# ops/geometry.py
# ---------------------------------------------------------------------------

def unit(rng, n):
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["sphere_distance", "arc_length",
                                  "sphere_angle",
                                  "triangle_signed_area_sphere",
                                  "wachspress_coordinates"])
def test_geometry_matches_reference(name):
    rng = np.random.default_rng(11)
    if name == "sphere_distance":
        args = (rng.uniform(-1.5, 1.5, 50), rng.uniform(0, 6, 50),
                rng.uniform(-1.5, 1.5, 50), rng.uniform(0, 6, 50))
    elif name == "arc_length":
        args = (unit(rng, 50), unit(rng, 50))
    elif name == "wachspress_coordinates":
        ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
        args = (np.stack([np.cos(ang), np.sin(ang)], -1) * 3.0,
                np.array([0.2, -0.4]))
    else:
        args = (unit(rng, 50), unit(rng, 50), unit(rng, 50))
    got = getattr(tgeo, name)(*[torch.from_numpy(a) for a in args])
    ref = np.asarray(getattr(jgeo, name)(*[jnp.asarray(a) for a in args]))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_point_in_cell_walk_matches_reference():
    mesh = parse_mesh_spec("icos:4")
    jmesh = {k: getattr(mesh, k).numpy() for k in
             ("xCell", "yCell", "zCell", "cellsOnCell", "nEdgesOnCell")}
    jmesh = type("M", (), jmesh)
    for p in unit(np.random.default_rng(5), 20):
        assert tgeo.point_in_cell_walk(mesh, p) \
            == jgeo.point_in_cell_walk(jmesh, p)


# ---------------------------------------------------------------------------
# the test core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(test_core.ALL_TESTS))
def test_self_test_succeeds(name, dtype):
    ok, detail = test_core.ALL_TESTS[name](torch.device("cpu"), dtype)
    assert ok, detail


def test_self_test_failure_is_reported():
    """A failing self-test logs FAILURE and run_all goes on."""
    lines = []
    saved = dict(test_core.ALL_TESTS)
    try:
        test_core.ALL_TESTS["boom"] = lambda d, t: 1 / 0
        results = test_core.run_all("cpu", torch.float64, log=lines.append)
    finally:
        test_core.ALL_TESTS.clear()
        test_core.ALL_TESTS.update(saved)
    assert not results["boom"][0] and "ZeroDivisionError" in lines[-1]
    assert all(results[n][0] for n in saved)


# ---------------------------------------------------------------------------
# init case 6: the mountain wave
# ---------------------------------------------------------------------------

MTN_CFG = dict(config_dt=10.0, config_nvertlevels=20, config_len_disp=2000.0,
               config_zd=14000.0, config_xnutr=0.1)
MTN_STEPS = 5


@pytest.fixture(scope="module")
def mtn():
    """tests/test_atm_mtn_wave.py:24-31 in both packages, and 5 steps."""
    kw = dict(xa=10000.0, xla=16000.0)
    jcfg = JAtmConfig(**MTN_CFG)
    jgrid, jstate, jdiag = jax.tree.map(
        jnp.asarray, jax_init_mtn_wave(jax_planar_hex_mesh(32, 8, 2000.0),
                                       jcfg, **kw))
    jout = jti.run_steps(jgrid, jcfg, jti.init_carry(
        jgrid, jcfg, jstate, jdiag, jcfg.config_dt),
        jnp.asarray(jcfg.config_dt), MTN_STEPS)
    cfg = AtmConfig(**MTN_CFG)
    grid, state, diag = init_mtn_wave(planar_hex_mesh(32, 8, 2000.0), cfg,
                                      **kw)
    out = tti.run_steps(grid, cfg, tti.init_carry(grid, cfg, state, diag,
                                                  cfg.config_dt),
                        cfg.config_dt, MTN_STEPS)
    return (grid, state, diag, out), (jgrid, jstate, jdiag, jout)


def assert_close(got, ref, rel, name):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-300), \
        name


GRID_FIELDS = ("zgrid", "zz", "zxu", "dss", "zb_cell", "zb3_cell", "defc_a",
               "defc_b", "recon_zonal", "recon_merid", "rho_base",
               "rtheta_base", "exner_base", "pressure_base", "d2_bmat", "d2w",
               "d2w_own", "d2w_opp", "adv_sside", "dv_cell")


@pytest.mark.parametrize("part", ["grid", "vert", "state", "diag", "mesh"])
def test_init_mtn_wave_matches_reference(mtn, part):
    (grid, state, diag, _), (jgrid, jstate, jdiag, _) = mtn
    if part == "grid":
        pairs = [(getattr(grid, k), getattr(jgrid, k), k)
                 for k in GRID_FIELDS]
        assert grid.adv_beta == jgrid.adv_beta
    elif part == "vert":
        pairs = [(getattr(grid.vert, k), getattr(jgrid.vert, k), k)
                 for k in ("zw", "dzw", "rdzw", "rdzu", "fzm", "fzp")]
    elif part == "mesh":
        pairs = [(getattr(grid.mesh, k), getattr(jgrid.mesh, k), k)
                 for k in ("fEdge", "fVertex", "fCell", "angleEdge")]
    else:
        ours, ref = (state, jstate) if part == "state" else (diag, jdiag)
        pairs = [(getattr(ours, f.name), getattr(ref, f.name), f.name)
                 for f in dataclasses.fields(ours)]
    for got, ref, name in pairs:
        assert_close(got, ref, 1e-12, name)


@pytest.mark.parametrize("field", ["u", "w", "theta_m", "rho_zz"])
def test_mtn_wave_steps_match_reference(mtn, field):
    (*_, out), (*_, jout) = mtn
    assert_close(getattr(out.state, field), getattr(jout.state, field),
                 1e-9, field)
    if field == "w":
        assert float(out.state.w.abs().max()) > 0.0
