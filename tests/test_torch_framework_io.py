"""The framework's forcing streams, the sharded restart I/O and the
registry interface of the PyTorch port against the JAX package.

- Forcing: a 3-record classic NetCDF file the test writes; constant and
  linear interpolation, the forcing-clock offset, the cyclic wrap both
  sides of the record range, the acyclic clamps, restart_times; the
  port's tensors equal the reference's numpy. A netCDF4 forcing file is
  refused by both (its xtime is not read).
- Sharded restart: shards written by either package read back in the
  other bit for bit (cell, edge and vertex fields, group sizes 1, 2, 3);
  and the 642-cell JW on 4 loopback shards written from its carry after
  3 steps, read back, re-sharded and stepped twice, bit for bit with 2
  steps of the carry in memory.
- Registry: a Registry.xml the test writes through the repository's
  registry compiler: the schema, the config class, the default namelist
  and streams, and build_state_pytree with package gating.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.framework import forcing as jforcing
from mpas_tpu.framework import registry as jregistry
from mpas_tpu.io import sharded as jsharded
from mpas_tpu.mesh import sphere as jsphere
from mpas_tpu.parallel import layout as jlayout
from mpas_tpu.parallel import partition as jpart
from mpas_tpu_torch.cores.atmosphere import distributed as adist
from mpas_tpu_torch.cores.atmosphere import time_integration as ti
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
from mpas_tpu_torch.framework import forcing as tforcing
from mpas_tpu_torch.framework import registry as tregistry
from mpas_tpu_torch.framework.timekeeping import Time, TimeInterval
from mpas_tpu_torch.io import sharded as tsharded
from mpas_tpu_torch.io.hdf5_write import write_hdf5
from mpas_tpu_torch.io.netcdf import write_netcdf
from mpas_tpu_torch.mesh import sphere as tsphere
from mpas_tpu_torch.parallel.layout import build_sharded_mesh
from mpas_tpu_torch.parallel.partition import sfc_partition
from mpas_tpu_torch.parallel.runner import device_mesh, gather_field, place

torch.set_num_threads(1)

F64 = torch.float64
TIMES = ["0001-03-01_00:00:00", "0001-03-01_06:00:00",
         "0001-03-01_18:00:00"]


# ---------------------------------------------------------------------------
# forcing
# ---------------------------------------------------------------------------

def write_forcing(path, writer=write_netcdf):
    """3 records of windStressZonal (nCells = 5) and airTemperature
    (nCells x 2), unevenly spaced in time."""
    rng = np.random.default_rng(4)
    xt = np.zeros((3, 64), dtype="S1")
    for i, t in enumerate(TIMES):
        xt[i, :len(t)] = [c.encode() for c in t]
    writer(path, {"Time": 3, "StrLen": 64, "nCells": 5, "two": 2},
           {"xtime": (("Time", "StrLen"), xt),
            "windStressZonal": (("Time", "nCells"),
                                rng.standard_normal((3, 5))),
            "airTemperature": (("Time", "nCells", "two"),
                               280.0 + rng.standard_normal((3, 5, 2)))})
    return path


@pytest.fixture(scope="module")
def forcing_file(tmp_path_factory):
    return write_forcing(str(tmp_path_factory.mktemp("forcing") / "f.nc"))


GROUPS = {
    "linear": dict(),
    "constant": dict(interp="constant"),
    "offset": dict(offset=3 * 3600 + 17),
    "cyclic": dict(cycle=("0001-03-01_00:00:00", 86400)),
    "cyclic_offset": dict(cycle=("0001-03-01_00:00:00", 86400),
                          offset=-5 * 3600),
}


def groups(path, kind):
    """The same ForcingGroup in both packages."""
    kw = GROUPS[kind]
    out = []
    for mod in (jforcing, tforcing):
        tk = (Time, TimeInterval) if mod is tforcing else \
            (mod.Time, mod.TimeInterval)
        args = dict(forcing_offset=tk[1].from_seconds(kw.get("offset", 0)))
        if "cycle" in kw:
            args.update(cycle_start=tk[0].from_string(kw["cycle"][0]),
                        cycle_duration=tk[1].from_seconds(kw["cycle"][1]))
        if mod is tforcing:
            args["device"] = "cpu"
        g = mod.ForcingGroup("atm", **args)
        s = mod.ForcingStream(path, ["windStressZonal", "airTemperature"])
        for name in ("windStressZonal", "airTemperature"):
            g.add_field(s, name, interpolation=kw.get("interp", "linear"))
        out.append(g)
    return out


@pytest.mark.parametrize("kind", sorted(GROUPS))
def test_forcing_group(forcing_file, kind):
    jg, tg = groups(forcing_file, kind)
    hours = [-30.0, -1.0, 0.0, 2.5, 6.0, 11.0, 18.0, 20.0, 23.9, 30.0, 47.0]
    for h in hours:
        t = Time.from_string("0001-03-01_00:00:00") \
            + TimeInterval.from_seconds(h * 3600.0)
        jt = jforcing.Time(t.us, t.calendar)
        got, ref = tg.get_forcing(t), jg.get_forcing(jt)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                          err_msg=f"{kind} {h} h {k}")
        assert tg.restart_times(t) == jg.restart_times(jt)


def test_forcing_refusals(forcing_file):
    g = tforcing.ForcingGroup("atm", device="cpu")
    s = tforcing.ForcingStream(forcing_file, ["windStressZonal"])
    g.add_field(s, "windStressZonal")
    with pytest.raises(ValueError):
        g.add_field(s, "windStressZonal", interpolation="cubic")
    with pytest.raises(ValueError):
        g.add_field(s, "airTemperature")          # not a stream variable
    with pytest.raises(ValueError):
        tforcing.ForcingGroup("x", cycle_start=Time.from_string(TIMES[0]),
                              device="cpu")
    with pytest.raises(ValueError):
        tforcing.ForcingGroup("x", cycle_start=Time.from_string(TIMES[0]),
                              cycle_duration=TimeInterval(months=1),
                              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tforcing.ForcingGroup("x")            # cuda:0 by default


def test_netcdf4_forcing_file_has_no_xtime(tmp_path):
    """Both packages' netCDF4 reader (io/hdf5.py) skips string variables,
    so a netCDF4 forcing file's xtime is not read and its stream refuses
    the file (ROADMAP §3)."""
    path = write_forcing(str(tmp_path / "f4.nc"), write_hdf5)
    for mod in (jforcing, tforcing):
        with pytest.raises(ValueError, match="no xtime"):
            mod.ForcingStream(path, ["windStressZonal"]).times


def test_forcing_file_needs_xtime(tmp_path):
    path = str(tmp_path / "noxtime.nc")
    write_netcdf(path, {"nCells": 2}, {"a": (("nCells",), np.zeros(2))})
    with pytest.raises(ValueError):
        tforcing.ForcingStream(path, ["a"]).times


# ---------------------------------------------------------------------------
# sharded restart I/O
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layouts():
    """The 642-cell sphere in 4 shards, in both packages."""
    jm = jsphere.icosahedral_mesh(8, lloyd_iters=2)
    tm = tsphere.icosahedral_mesh(8, lloyd_iters=2)
    return (jlayout.build_sharded_mesh(jm, jpart.sfc_partition(jm, 4), 2),
            build_sharded_mesh(tm, sfc_partition(tm, 4), 2), tm)


def global_fields(mesh):
    rng = np.random.default_rng(9)
    return ({"h": rng.standard_normal((mesh.nCells, 3)),
             "u": rng.standard_normal(mesh.nEdges),
             "vort": rng.standard_normal((mesh.nVertices, 2)).astype(
                 np.float32),
             "mlc": rng.integers(0, 9, mesh.nCells).astype(np.int32)},
            {"h": "cell", "u": "edge", "vort": "vertex", "mlc": "cell"})


@pytest.mark.parametrize("group_size", [1, 2, 3])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sharded_restart_across_packages(tmp_path, layouts, writer,
                                         group_size):
    jsm, tsm, mesh = layouts
    from mpas_tpu_torch.parallel.runner import scatter_field
    glob, kinds = global_fields(mesh)
    stacked = {k: scatter_field(tsm, v, kinds[k]) for k, v in glob.items()}
    n_global = {"cell": mesh.nCells, "edge": mesh.nEdges,
                "vertex": mesh.nVertices}
    w, r = (jsharded, tsharded) if writer == "jax" else (tsharded, jsharded)
    sm = jsm if writer == "jax" else tsm
    w.write_sharded(str(tmp_path), sm, stacked, kinds, n_global,
                    group_size=group_size, attrs={"step": 3})
    assert len(list(tmp_path.glob("restart_shard_*.npz"))) \
        == -(-4 // group_size)
    for reader in (r, w):
        fields, attrs = reader.read_sharded(str(tmp_path))
        assert attrs == {"step": 3}
        for k, v in glob.items():
            assert fields[k].dtype == v.dtype
            np.testing.assert_array_equal(fields[k], v, err_msg=k)


def test_sharded_restart_of_the_jw_carry(tmp_path):
    """The 642-cell JW on 4 loopback shards, 3 steps, written from its
    carry (group_size 2), read back and re-sharded: the reassembled
    fields equal the gathered ones, and 2 steps from the restart equal 2
    steps from the carry in memory, bit for bit."""
    cfg = AtmConfig(config_nvertlevels=10, config_len_disp=960000.0,
                    config_dt=1800.0)
    mesh = tsphere.icosahedral_mesh(8, lloyd_iters=2)
    grid, state, diag = init_jw(mesh, cfg, case=2)
    carry0 = ti.init_carry(grid, cfg, state, diag, cfg.config_dt)
    satm = adist.shard_atm_grid(grid, sfc_partition(mesh, 4))
    group = device_mesh(4, "cpu")
    grid_l = satm.local(group, F64)
    run = adist.make_run_steps_atm(satm, cfg, group)
    carry_l = run(grid_l, place(adist.shard_atm_carry(satm, carry0), group,
                                F64), 3)
    sm = satm.smesh
    fields, kinds = adist.carry_restart_fields(carry_l, group)
    n_global = {"cell": mesh.nCells, "edge": mesh.nEdges,
                "vertex": mesh.nVertices}
    tsharded.write_sharded(str(tmp_path), sm, fields, kinds, n_global,
                           group_size=2)
    back, _ = tsharded.read_sharded(str(tmp_path))
    assert sorted(back) == sorted(fields)
    for k in fields:
        np.testing.assert_array_equal(
            back[k], gather_field(sm, fields[k], kinds[k],
                                  n_global[kinds[k]]), err_msg=k)
    restarted = place(adist.shard_atm_carry(
        satm, adist.carry_from_restart_fields(back)), group, F64)
    a, b = run(grid_l, carry_l, 2), run(grid_l, restarted, 2)
    fa, _ = adist.carry_restart_fields(a, group)
    fb, _ = adist.carry_restart_fields(b, group)
    for k in fa:
        np.testing.assert_array_equal(
            gather_field(sm, fb[k], kinds[k], n_global[kinds[k]]),
            gather_field(sm, fa[k], kinds[k], n_global[kinds[k]]),
            err_msg=k)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

REGISTRY_XML = """<?xml version="1.0"?>
<registry model="mpas" core="ocean" core_abbrev="ocn" version="8.0">
  <dims>
    <dim name="nCells" units="unitless" definition="file"/>
    <dim name="nEdges" definition="file"/>
    <dim name="nVertLevels" definition="namelist:config_nz"/>
  </dims>
  <!-- a comment the parser skips -->
  <nml_record name="time_management">
    <nml_option name="config_dt" type="real" default_value="300.0"/>
    <nml_option name="config_run_duration" type="character"
                default_value="0001_00:00:00"/>
    <nml_option name="config_do_restart" type="logical"
                default_value=".false."/>
    <nml_option name="config_nz" type="integer" default_value="20"/>
  </nml_record>
  <nml_record name="bgc">
    <nml_option name="config_use_ecosys" type="logical"
                default_value=".true."/>
    <nml_option name="config_hidden" type="real" default_value="1e-3"
                in_defaults="false"/>
  </nml_record>
  <packages>
    <package name="ecosysPKG" description="ecosys tracers"/>
    <package name="gmPKG" description="GM bolus"/>
  </packages>
  <streams>
    <stream name="restart" type="input;output"
            filename_template="restarts/rst.$Y-$M-$D.nc"
            input_interval="initial_only" output_interval="1_00:00:00"/>
    <stream name="output" type="output" filename_template="out.nc"
            output_interval="0_06:00:00"/>
  </streams>
  <var_struct name="state" time_levs="2">
    <var name="layerThickness" type="real" dimensions="nVertLevels nCells"/>
    <var name="normalVelocity" type="real" dimensions="nVertLevels nEdges"/>
    <var name="maxLevelCell" type="integer" dimensions="nCells"/>
    <var name="landMask" type="logical" dimensions="nCells"/>
    <var_array name="ecosysTracers" type="real"
               dimensions="nVertLevels nCells" packages="ecosysPKG">
      <var name="NO3" array_group="ecosys"/>
    </var_array>
    <var name="bolusVelocity" type="real" dimensions="nVertLevels nEdges"
         packages="gmPKG;ecosysPKG"/>
  </var_struct>
  <var_struct name="mesh">
    <var name="areaCell" type="real" dimensions="nCells"/>
  </var_struct>
</registry>
"""


@pytest.fixture(scope="module")
def registry_xml(tmp_path_factory):
    path = tmp_path_factory.mktemp("registry") / "Registry.xml"
    path.write_text(REGISTRY_XML)
    return str(path)


def test_registry_outputs(registry_xml):
    assert tregistry.load_schema(registry_xml) \
        == jregistry.load_schema(registry_xml)
    assert tregistry.generate_default_namelist(registry_xml) \
        == jregistry.generate_default_namelist(registry_xml)
    assert tregistry.generate_default_streams(registry_xml) \
        == jregistry.generate_default_streams(registry_xml)
    tcfg = tregistry.generate_config_class(registry_xml)()
    jcfg = jregistry.generate_config_class(registry_xml)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.config_dt == 300.0 and tcfg.config_nz == 20


@pytest.mark.parametrize("active", [None, [], ["gmPKG"], ["ecosysPKG"]])
def test_build_state_pytree(registry_xml, active):
    schema = tregistry.load_schema(registry_xml)
    dims = {"nCells": 7, "nEdges": 11, "nVertLevels": 3}
    got = tregistry.build_state_pytree(schema, dims, active_packages=active,
                                       device="cpu")
    ref = jregistry.build_state_pytree(schema, dims, active_packages=active)
    assert sorted(got) == sorted(ref)
    dtypes = {np.float64: torch.float64, np.int32: torch.int32,
              np.bool_: torch.bool}
    for s in ref:
        assert sorted(got[s]) == sorted(ref[s]), (s, active)
        for k, v in ref[s].items():
            assert tuple(got[s][k].shape) == v.shape
            assert got[s][k].dtype == dtypes[v.dtype.type]
            assert not got[s][k].any()
    f32 = tregistry.build_state_pytree(schema, dims, dtype=torch.float32,
                                       device="cpu")
    assert f32["state"]["layerThickness"].dtype == torch.float32
    with pytest.raises(KeyError):
        tregistry.build_state_pytree(schema, {"nCells": 7}, device="cpu")
