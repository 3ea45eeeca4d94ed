"""The port's command line (python -m mpas_tpu_torch) against the JAX
package's run driver, in float64 on the CPU.

Each core runs twice in each package, in one run directory per package:
a first leg that writes output and restart at its end, then a restart leg
of the same length from the first leg's restart_timestamp. The port runs
through `main([... "--cpu", "--x64"])`, the JAX package through its
`Driver` with the same namelist and streams files. Both must write the
same files (names and restart_timestamp), and every field of every file
must agree at max|a-b| <= 1e-9 x max|b|. The shallow-water legs must also
equal a fresh run of both legs' length bit for bit (tests/test_driver.py's
restart test). Cases: sw (TC5 on icos:4, dt 600 s), atmosphere (dry JW on
icos:4, 10 levels, dt 1800 s) and ocean (the 192-cell baroclinic channel,
20 levels, dt 300 s); tests/test_torch_driver_physics.py adds the
atmosphere with the physics suite. Both packages' mesh caches point at a
temporary directory.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mpas_tpu.framework.driver import Driver as JaxDriver
from mpas_tpu.framework.namelist import from_namelist_file as jax_namelist
from mpas_tpu.framework.streams import parse_streams_xml as jax_streams_xml
from mpas_tpu.io.netcdf import read_netcdf as jax_read_netcdf
from mpas_tpu_torch import __main__ as cli
from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.cores.sw.hooks import HOOKS as SW_HOOKS
from mpas_tpu_torch.framework.driver import Driver
from mpas_tpu_torch.framework.log import MPASLogError
from mpas_tpu_torch.io.netcdf import read_netcdf

torch.set_num_threads(1)

REL = 1e-9

# core -> (mesh spec, namelist lines, length of one leg)
CASES = {
    "sw": ("icos:4", ["config_dt = 600.0", "config_test_case = 5"],
           "0:30:00"),
    "atmosphere": ("icos:4", ["config_dt = 1800.0",
                              "config_nvertlevels = 10"], "1:00:00"),
    "ocean": ("channel:8,26,10000", ["config_dt = 300.0"], "0:10:00"),
}


def jax_hooks(core):
    if core == "sw":
        from mpas_tpu.cores.sw.hooks import HOOKS
    elif core == "atmosphere":
        from mpas_tpu.cores.atmosphere.hooks import HOOKS
    else:
        from mpas_tpu.cores.ocean.hooks import HOOKS
    return HOOKS


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """Both packages' mesh caches in a temporary directory."""
    d = tmp_path_factory.mktemp("mesh_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPAS_TPU_CACHE", str(d / "jax"))
        mp.setenv("MPAS_TPU_TORCH_CACHE", str(d / "torch"))
        yield d


def write_inputs(d, core, leg, lines, start=None):
    """A namelist of one leg (a restart leg where `start` is given) and a
    streams file with output and restart at the end of every leg."""
    nml = [f"   {ln}" for ln in lines + [f"config_run_duration = '{leg}'"]]
    if start is not None:
        nml += [f"   config_start_time = '{start}'",
                "   config_do_restart = .true."]
    path_nml = d / f"namelist.{core}"
    path_nml.write_text("&model\n" + "\n".join(nml) + "\n/\n")
    path_xml = d / f"streams.{core}"
    path_xml.write_text(f"""<streams>
<immutable_stream name="restart" type="input;output"
    filename_template="restart.{core}.$Y-$M-$D_$h.$m.$s.nc"
    output_interval="{leg}"/>
<stream name="output" type="output"
    filename_template="output.{core}.$Y-$M-$D_$h.$m.$s.nc"
    output_interval="{leg}"/>
</streams>
""")
    return str(path_nml), str(path_xml)


def run_port(core, d, mesh, nml, xml):
    return cli.main([core, "--cpu", "--x64", "--mesh", mesh, "-n", nml,
                     "-s", xml, "--run-dir", str(d)])


# the run driver's own fields, which no step reads
DRIVER_FIELDS = ("config_run_duration", "config_start_time",
                 "config_stop_time", "config_do_restart")


def run_jax(core, d, mesh, nml, xml):
    """The JAX Driver with the namelist's config. Its hooks get the config
    with the driver's own fields at their defaults, so that the restart
    leg reuses the first leg's compiled steps (the config is a static
    argument of the JAX run_steps)."""
    hooks = jax_hooks(core)
    canon = {f: getattr(hooks.config_cls(), f) for f in DRIVER_FIELDS}
    setup = hooks.setup
    hooks = dataclasses.replace(hooks, setup=lambda cfg, spec: setup(
        dataclasses.replace(cfg, **canon), spec))
    JaxDriver(hooks, jax_namelist(hooks.config_cls, nml), run_dir=str(d),
              streams=jax_streams_xml(xml),
              mesh_spec=mesh).init().run().finalize()


def run_legs(core, root, runner, case=None):
    """Both legs of `core` in root (the first, then the restart from its
    restart_timestamp); returns root."""
    mesh, lines, leg = case or CASES[core]
    root.mkdir()
    nml, xml = write_inputs(root, core, leg, lines)
    runner(core, root, mesh, nml, xml)
    start = (root / "restart_timestamp").read_text().strip()
    nml, xml = write_inputs(root, core, leg, lines, start=start)
    runner(core, root, mesh, nml, xml)
    return root


def port_runner(core, d, mesh, nml, xml):
    assert run_port(core, d, mesh, nml, xml) == 0


@pytest.fixture(scope="module")
def legs(caches, tmp_path_factory):
    """{core: (port run dir, JAX run dir)}, run on first use."""
    out = {}

    def get(core):
        if core not in out:
            root = tmp_path_factory.mktemp(core)
            out[core] = (run_legs(core, root / "port", port_runner),
                         run_legs(core, root / "jax", run_jax))
        return out[core]
    return get


def nc_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".nc"))


# the two reconstructed wind components are held to the wind's scale: a
# flow along one axis (the supercell's) leaves the other at roundoff
SCALE_OF = {"uReconstructZonal": ("uReconstructZonal",
                                  "uReconstructMeridional"),
            "uReconstructMeridional": ("uReconstructZonal",
                                       "uReconstructMeridional")}


def assert_same_files(port_dir, jax_dir):
    """The same file names and restart_timestamp; every field of every
    file within REL x max|ref| (SCALE_OF: the max over a group)."""
    names = nc_files(port_dir)
    assert names == nc_files(jax_dir) and names
    assert (port_dir / "restart_timestamp").read_text() \
        == (jax_dir / "restart_timestamp").read_text()
    for name in names:
        got, _, _ = read_netcdf(str(port_dir / name))
        ref, _, _ = jax_read_netcdf(str(jax_dir / name))
        assert sorted(got) == sorted(ref), name
        for k, r in ref.items():
            g = got[k]
            assert g.shape == r.shape and g.dtype == r.dtype, (name, k)
            if r.dtype.kind == "S":
                assert np.array_equal(g, r), (name, k)
            else:
                scale = max(max(float(np.abs(ref[f]).max())
                                for f in SCALE_OF.get(k, (k,))), 1e-300)
                assert float(np.abs(g - r).max()) <= REL * scale, (name, k)


@pytest.mark.parametrize("core", list(CASES))
def test_cli_matches_jax_driver(legs, core):
    port_dir, jax_dir = legs(core)
    assert_same_files(port_dir, jax_dir)


@pytest.mark.parametrize("core", list(CASES))
def test_cli_writes_each_leg_and_restarts(legs, core):
    """Output at 0, one and two leg lengths, restarts at one and two; the
    restart leg logs its restart and its steps."""
    port_dir, _ = legs(core)
    names = nc_files(port_dir)
    assert [n.split(".")[0] for n in names] \
        == ["output"] * 3 + ["restart"] * 2, names
    log = (port_dir / f"log.{core}.0000.out").read_text()
    assert "Restarted from restart stream at" in log
    assert log.count("timer table:") == 2
    assert "time integration" in log and "stream output" in log


def test_sw_restart_equals_a_fresh_run_bit_for_bit(legs, tmp_path):
    """30 min, then a restart of 30 min, equals a fresh 1 h run bit for
    bit (tests/test_driver.py:28-68, against the port)."""
    port_dir, _ = legs("sw")
    mesh, lines, _ = CASES["sw"]
    nml, xml = write_inputs(tmp_path, "sw", "1:00:00", lines)
    assert run_port("sw", tmp_path, mesh, nml, xml) == 0
    last = "output.sw.0000-01-01_01.00.00.nc"
    a, _, _ = read_netcdf(str(port_dir / last))
    b, _, _ = read_netcdf(str(tmp_path / last))
    for k in ("u", "h", "tracers", "uReconstructZonal",
              "uReconstructMeridional"):
        assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# debug checks, device choice, the test core
# ---------------------------------------------------------------------------

def sw_driver(tmp_path, hooks=SW_HOOKS):
    cfg = SWConfig(config_dt=600.0, config_test_case=5,
                   config_run_duration="0:30:00", config_debug_checks=True)
    return Driver(hooks, cfg, run_dir=str(tmp_path), mesh_spec="icos:4",
                  device="cpu", dtype=torch.float64)


def test_debug_checks_pass_a_clean_run(caches, tmp_path):
    sw_driver(tmp_path).init().run().finalize()
    log = (tmp_path / "log.sw.0000.out").read_text()
    assert "debug checks" in log and "completed step 3/3" in log


def test_debug_checks_abort_a_nan_state(caches, tmp_path):
    """A NaN-poisoned step_chunk aborts through the CRIT path, naming the
    leaf (ref: MPAS_DEBUG / -ffpe-trap debug builds)."""
    def poison(run, n):
        run = SW_HOOKS.step_chunk(run, n)
        run.state = dataclasses.replace(run.state, h=run.state.h * np.nan)
        return run

    d = sw_driver(tmp_path, dataclasses.replace(SW_HOOKS, step_chunk=poison))
    d.init()
    with pytest.raises(MPASLogError, match="non-finite") as e:
        d.run()
    assert "state.state.h" in str(e.value)
    d.log.close()


@pytest.mark.parametrize("core", ["sw", "atmosphere", "ocean", "test"])
def test_no_silent_cpu(monkeypatch, tmp_path, capsys, core):
    """Without --cpu and without CUDA the command line exits nonzero with
    resolve_device's message, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([core, "--run-dir", str(tmp_path / "run")]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "run").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Driver(SW_HOOKS, SWConfig(), run_dir=str(tmp_path / "d"))
    assert not (tmp_path / "d").exists()


@pytest.mark.parametrize("x64", [False, True])
def test_test_core_runs_every_self_test(capsys, x64):
    """python -m mpas_tpu_torch test: every self-test a SUCCESS, the halo
    exchange run on 4 loopback shards and not skipped."""
    assert cli.main(["test", "--cpu"] + (["--x64"] if x64 else [])) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7
    assert all(": SUCCESS - " in ln for ln in lines), lines
    assert " * halo_exchange: SUCCESS - halo exchange ok (4 shards, " \
        "loopback)" in lines
