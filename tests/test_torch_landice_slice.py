"""The two land-ice paths of tools/landice_dome.py at small size, through
both packages, and the sharded land-ice runner.

The paths' own configurations on the small dome of the reference's tests
(box_hex_mesh(20, 20, 3 km), h0 500 m, r0 25 km, 10 levels, dt 0.05 yr),
float64 on the CPU:

- landice_dome_4km: 3 steps of the tool's step against the reference's
  run_steps and global_stats, at 1e-9 x max;
- landice_dome_4km_fo at 3 Picard x 10 CG (at more iterations the CG,
  which does not converge, amplifies rounding: 6.6e-9 x max after 2 steps
  at 3 x 30; test_torch_landice.py): 3 steps of the ice state against
  the reference's fe_step at 1e-9 x max, and the port's hydrology step
  on the reference's ice state against its sgh_step_full at 1e-11.
  The coupled hydrology is not held: the reference's full GlaDS step
  amplifies a one-ulp change of its input to ~10% of max|P| in two steps
  on this dome (test_hydrology_amplifies_rounding; ROADMAP §3).

The sharded runner (cores/landice/distributed.py) on 4 loopback shards
against the port's unsharded run: SIA and IR bit for bit, FO within the
reference test's 1e-6 x max (its psum'd CG dots reassociate).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.landice import config as jconf
from mpas_tpu.cores.landice import core as jcore
from mpas_tpu.cores.landice import hydro as jhydro
from mpas_tpu.cores.landice import init_dome as jinit
from mpas_tpu.cores.landice import statistics as jstats
from mpas_tpu.mesh.planar import box_hex_mesh as j_box_hex_mesh
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.landice import core as tcore
from mpas_tpu_torch.cores.landice import distributed as tdist
from mpas_tpu_torch.cores.landice import hydro as thydro
from mpas_tpu_torch.cores.landice.fo_stokes import build_fo_geom
from mpas_tpu_torch.cores.landice.hydro import effective_pressure
from mpas_tpu_torch.cores.landice.init_dome import init_halfar
from mpas_tpu_torch.ops import stencils
from mpas_tpu_torch.parallel.partition import sfc_partition
from mpas_tpu_torch.parallel.runner import device_mesh, gather_field, place
from mpas_tpu_torch.tools import landice_dome as ld
from tests.test_torch_ocean import assert_close, flatten

torch.set_num_threads(1)

SLICE_REL = 1e-9
REL = 1e-11
DOME = (500.0, 25000.0)
FO_SLICE = dict(config_fo_picard_iters=3, config_fo_cg_iters=10)
F64 = torch.float64


@pytest.fixture(scope="module")
def meshes():
    jm = j_box_hex_mesh(20, 20, 3000.0)
    return jm, convert.mesh_from_arrays(flatten(jm))


def jax_start(jm, jcfg):
    _g, js, _ = jinit.init_halfar(jm, jcfg, h0=DOME[0], r0=DOME[1])
    if jcfg.config_thermal_solver == "enthalpy":
        js = js.replace(waterFrac=jnp.zeros_like(js.temperature),
                        basalMeltRate=jnp.zeros_like(js.thickness))
    return jcore.make_grid(jm, jcfg), js


def test_path_configs():
    sia = ld.config("landice_dome_4km")
    assert sia == tcore.LiConfig(config_nvertlevels=10)
    fo = ld.config("landice_dome_4km_fo")
    assert (fo.config_velocity_solver, fo.config_thermal_solver,
            fo.config_flowParamA_calculation,
            fo.config_thickness_advection, fo.config_calving) == (
        "FO", "enthalpy", "PB1982", "incremental_remapping",
        "eigencalving")
    assert (fo.config_fo_picard_iters, fo.config_fo_cg_iters,
            fo.config_fo_basal_friction) == (10, 120, 1.0e12)
    assert ld.MESH == (302, 348, 4000.0) and ld.DOME == (3000.0, 550.0e3)


def test_sia_path_three_steps(meshes):
    jm, tm = meshes
    tcfg = ld.config("landice_dome_4km")
    jcfg = jconf.LiConfig(**dataclasses.asdict(tcfg))
    grid, state, hydro, _ = ld.setup("landice_dome_4km", tm, tcfg, DOME,
                                     F64, "cpu")
    assert hydro is None
    for _ in range(3):
        state, hydro, stats = ld.step(grid, tcfg, state, hydro)
    jg, js = jax_start(jm, jcfg)
    ref = jcore.run_steps(jg, jcfg, js, 3)
    assert_close(state, ref, "sia", SLICE_REL)
    ref_stats = jstats.global_stats(jg, jcfg, ref)
    for k, v in ref_stats.items():
        assert_close(stats[k], np.asarray(v), k, SLICE_REL)


@pytest.fixture(scope="module")
def fo_runs(meshes):
    """3 steps of the FO path in both packages: [(port state, port hydro
    stepped from the reference's ice state, port stats)], [(reference
    state, reference hydro, reference stats)]."""
    jm, tm = meshes
    tcfg = ld.config("landice_dome_4km_fo", **FO_SLICE)
    jcfg = jconf.LiConfig(**dataclasses.asdict(tcfg))
    grid, state, hydro, _ = ld.setup("landice_dome_4km_fo", tm, tcfg, DOME,
                                     F64, "cpu")
    jg, js = jax_start(jm, jcfg)
    jh = jhydro.zero_hydro(jm.nCells, n_edges=jm.nEdges)
    dt = jcfg.config_dt
    got, ref = [], []
    for _ in range(3):
        th = convert.hydro_state_from_arrays(flatten(jh))
        state, _h, stats = ld.step(grid, tcfg, state, hydro)
        js = jcore.fe_step(jg, jcfg, js, dt)
        # the port's hydrology from the reference's ice state and water,
        # as ld.step drives it
        ice = convert.landice_state_from_arrays(flatten(js))
        th = thydro.sgh_step_full(
            grid, tcfg, th, ice.thickness, ice.basalMeltRate,
            ld.sliding_speed(ice.thickness), dt,
            n_sub=ld.HYDRO_SUBSTEPS, channels=True)
        speed = jnp.where(js.thickness > 1.0, ld.SLIDING_SPEED, 0.0)
        jh = jhydro.sgh_step_full(jg, jcfg, jh, js.thickness,
                                  js.basalMeltRate, speed, dt,
                                  n_sub=ld.HYDRO_SUBSTEPS, channels=True)
        got.append((state, th, stats))
        ref.append((js, jh, jstats.global_stats(jg, jcfg, js)))
        hydro = _h
    return tcfg, grid, got, ref


def test_fo_path_ice_three_steps(fo_runs):
    _cfg, _grid, got, ref = fo_runs
    for i, ((s, _h, stats), (js, _jh, jstats_)) in enumerate(zip(got, ref)):
        assert_close(s, js, f"fo step {i + 1}", SLICE_REL)
        for k, v in jstats_.items():
            assert_close(stats[k], np.asarray(v), k, SLICE_REL)
    assert float(got[-1][0].normalVelocity.abs().max()) > 0.0


def test_max_surface_speed_reads_every_interface(fo_runs):
    """A fault of the reference (ROADMAP §3), kept by the port:
    global_stats' maxSurfaceSpeed is the max over every interface
    (statistics.py:30), the bed's included; on the FO path the largest
    lies below the surface."""
    _cfg, _grid, _got, ref = fo_runs
    js, _jh, stats = ref[-1]
    u = np.abs(np.asarray(js.normalVelocity))
    assert stats["maxSurfaceSpeed"] == u.max() > u[:, 0].max()


def test_fo_path_hydrology(fo_runs):
    _cfg, _grid, got, ref = fo_runs
    for i, ((_s, th, _st), (_js, jh, _jst)) in enumerate(zip(got, ref)):
        assert_close(th, jh, f"hydro step {i + 1}", REL)
    assert float(got[-1][1].waterPressure.max()) > 0.0


def test_hydrology_amplifies_rounding(meshes):
    """A fault of the reference (ROADMAP §3): sgh_step_full at dt 0.05 yr
    and 10 substeps, from a dry bed with cavity opening only, amplifies a
    one-ulp change of the sliding speed to more than 1% of max|P| in two
    steps (11% measured), where one step keeps it at rounding level."""
    jm, _tm = meshes
    cfg = jconf.LiConfig(config_nvertlevels=10)
    jg, js = jax_start(jm, cfg)
    h = js.thickness
    zero = jnp.zeros_like(h)
    dep = []
    for n in (1, 2):
        out = []
        for speed in (1.0e-6, np.nextafter(1.0e-6, 1.0)):
            s = jhydro.zero_hydro(jm.nCells, n_edges=jm.nEdges)
            sp = jnp.where(h > 1.0, speed, 0.0)
            for _ in range(n):
                s = jhydro.sgh_step_full(jg, cfg, s, h, zero, sp,
                                         cfg.config_dt, n_sub=10)
            out.append(np.asarray(s.waterPressure))
        dep.append(np.abs(out[0] - out[1]).max() / np.abs(out[0]).max())
    assert dep[0] < 1e-12
    assert dep[1] > 1e-2


def test_path_gates_small(meshes):
    """Phase 5's gates on the small dome: finite fields, thickness >= 0,
    temperature <= 273.15 K, surface speed > 0 and basal speed 0 (on the
    FO path below the surface speed), the thickest cell thins; on the SIA
    path the volume over 11 steps within 1e-10; on the FO path no
    calving, water pressure in [0, overburden] and effective pressure
    >= 0."""
    _jm, tm = meshes
    for name, steps, kw in (("landice_dome_4km", 11, {}),
                            ("landice_dome_4km_fo", 2, FO_SLICE)):
        cfg = ld.config(name, **kw)
        grid, state, hydro, _ = ld.setup(name, tm, cfg, DOME, F64, "cpu")
        h0 = state.thickness.clone()
        v0 = float(tcore.total_volume(grid, state))
        for _ in range(steps):
            state, hydro, stats = ld.step(grid, cfg, state, hydro)
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            assert v is None or bool(torch.isfinite(v).all()), f.name
        assert float(state.thickness.min()) >= 0.0
        assert float(state.temperature.max()) <= 273.15
        u = state.normalVelocity
        surface = float(u[:, 0].abs().max())
        basal = float(u[:, -1].abs().max())
        assert surface > 0.0
        if hydro is None:
            assert basal == 0.0
        else:
            # the reference's fo_velocity copies the lowest layer's
            # velocity to the bed interface (ROADMAP §3)
            assert basal < surface
        c = int(torch.argmax(h0))
        assert float(state.thickness[c]) < float(h0[c])
        if hydro is None:
            v1 = float(stats["totalIceVolume"])
            assert abs(v1 - v0) / v0 <= 1e-10
        else:
            assert float(stats["totalCalvingFlux"]) == 0.0
            ovb = cfg.rho_ice * cfg.gravity * state.thickness
            P = hydro.waterPressure
            assert float(P.min()) >= 0.0
            assert bool((P <= ovb + 1e-6).all())
            n = effective_pressure(cfg, hydro, state.thickness)
            assert float(n.min()) >= 0.0


def test_no_kernel_on_the_landice_paths(meshes, monkeypatch):
    """Neither K1 nor K2 is on the land-ice paths: their wrappers and the
    stencils that reach K2 are never called."""
    from mpas_tpu_torch.kernels import acoustic, tinydot

    def forbidden(*_a, **_k):
        raise AssertionError("a kernel wrapper on the land-ice path")
    for mod, name in ((stencils, "tinydot"),
                      (stencils, "tangential_cell_assembled"),
                      (stencils, "trisk_q_cell_assembled"),
                      (tinydot, "tinydot"),
                      (acoustic, "acoustic_cell_update")):
        monkeypatch.setattr(mod, name, forbidden)
    _jm, tm = meshes
    for name in ld.PATHS:
        cfg = ld.config(name, config_fo_picard_iters=1,
                        config_fo_cg_iters=2)
        grid, state, hydro, _ = ld.setup(name, tm, cfg, DOME, F64, "cpu")
        ld.step(grid, cfg, state, hydro)


# ---------------------------------------------------------------- sharded

SHARD_CASES = {
    "sia": dict(config_calving="thickness_threshold",
                config_calving_thickness=50.0),
    "ir": dict(config_thickness_advection="incremental_remapping"),
    "fo": dict(config_velocity_solver="FO", config_fo_picard_iters=3,
               config_fo_cg_iters=30, config_nvertlevels=4),
}


@pytest.fixture(scope="module")
def shard_dome():
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    return box_hex_mesh(20, 20, 4000.0)


def sharded_run(mesh, cfg, n_parts, n_steps):
    """(unsharded final state, {field: gathered global numpy}, owned
    volume of the sharded run)."""
    grid, state, _ = init_halfar(mesh, cfg, h0=500.0, r0=30000.0,
                                    device="cpu")
    ref = tcore.run_steps(grid, cfg, state, n_steps)
    sli = tdist.shard_li_grid(grid, cfg, sfc_partition(mesh, n_parts))
    group = device_mesh(n_parts, "cpu")
    out = tdist.make_run_steps_li(sli, cfg, group)(
        sli.local(group, F64), place(tdist.shard_li_state(sli, state),
                                     group, F64), n_steps)
    got = {f: gather_field(sli.smesh, group.stack(getattr(out, f)), kind,
                           mesh.nCells if kind == "cell" else mesh.nEdges)
           for f, kind in (("thickness", "cell"), ("temperature", "cell"),
                           ("calvingFlux", "cell"),
                           ("normalVelocity", "edge"))}
    return ref, got


@pytest.mark.parametrize("case", ["sia", "ir", "fo"])
def test_sharded_matches_unsharded(shard_dome, case):
    cfg = tcore.LiConfig(config_dt=0.25 * tcore.SECONDS_PER_YEAR,
                         **SHARD_CASES[case])
    ref, got = sharded_run(shard_dome, cfg, 4, 3)
    rel = 1e-6 if case == "fo" else 0.0
    for f in ("thickness", "temperature", "calvingFlux"):
        r = getattr(ref, f).numpy()
        err = float(np.abs(got[f] - r).max())
        assert err <= rel * float(np.abs(r).max()), f"{case} {f}: {err}"


@pytest.mark.parametrize("case", ["sia", "ir"])
def test_one_shard_bit_for_bit(shard_dome, case):
    cfg = tcore.LiConfig(config_dt=0.25 * tcore.SECONDS_PER_YEAR,
                         **SHARD_CASES[case])
    ref, got = sharded_run(shard_dome, cfg, 1, 2)
    assert np.array_equal(got["thickness"], ref.thickness.numpy())
    assert np.array_equal(got["normalVelocity"],
                          ref.normalVelocity.numpy())


def test_fo_bed_interface_carries_the_lowest_layer(meshes):
    """A fault of the reference (ROADMAP §3): fo_velocity's comment puts
    "zero at the bed contact", but its code copies the lowest layer's
    midpoint velocity to the bed interface, so the FO path's basal
    speed is that layer's, not 0, under no-slip friction too."""
    jm, _tm = meshes
    jcfg = jconf.LiConfig(config_nvertlevels=10, config_velocity_solver="FO",
                          config_fo_picard_iters=2, config_fo_cg_iters=5)
    jg, js = jax_start(jm, jcfg)
    u = np.asarray(jcore.fo_velocity(jg, jcfg, js.thickness,
                                     js.temperature))
    assert np.abs(u[:, -1]).max() > 0.0
    grid = tcore.make_grid(convert.mesh_from_arrays(flatten(jm)),
                           tcore.LiConfig(**dataclasses.asdict(jcfg)))
    got = tcore.fo_velocity(grid, tcore.LiConfig(**dataclasses.asdict(jcfg)),
                            torch.from_numpy(np.asarray(js.thickness)),
                            torch.from_numpy(np.asarray(js.temperature)))
    assert_close(got[:, -1], u[:, -1], "bed", REL)


def test_sharded_volume_conservation(shard_dome):
    cfg = tcore.LiConfig(config_dt=0.25 * tcore.SECONDS_PER_YEAR,
                         **SHARD_CASES["sia"])
    grid, state, _ = init_halfar(shard_dome, cfg, h0=500.0, r0=30000.0,
                                    device="cpu")
    _ref, got = sharded_run(shard_dome, cfg, 4, 8)
    area = grid.mesh.areaCell.numpy()
    v0 = float((state.thickness.numpy() * area).sum())
    v1 = float((got["thickness"] * area).sum())
    vc = float((got["calvingFlux"] * area).sum())
    assert abs((v1 + vc) - v0) / v0 < 1e-10


def test_flat_fo_geometry_is_each_shards_build(shard_dome):
    """The loopback layout builds the FO geometry once over its
    block-diagonal mesh: each shard's rows equal that shard's own build
    (the reference builds it per shard, distributed.py:61-72), with the
    neighbour indices offset into the flat layout."""
    cfg = tcore.LiConfig(**SHARD_CASES["fo"])
    grid = tcore.make_grid(shard_dome, cfg)
    sli = tdist.shard_li_grid(grid, cfg, sfc_partition(shard_dome, 4))
    flat = sli.local(device_mesh(4, "cpu"), F64).fo_geom
    n = sli.smesh.mesh.nCells
    for p in range(4):
        own = build_fo_geom(sli.smesh.shard(p))
        rows = slice(p * n, (p + 1) * n)
        for k in ("gradx_w", "grady_w", "area", "nbr_mask"):
            assert torch.equal(getattr(flat, k)[rows], getattr(own, k)), k
        assert torch.equal(flat.nbr[rows], own.nbr + p * n)
