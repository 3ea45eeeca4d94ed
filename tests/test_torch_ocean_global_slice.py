"""The ocean_global_120km slice of the PyTorch port against the same loop
of JAX calls, on the CPU in float64.

chip_smoke.py's path (mpas_tpu_torch.tools.ocean_global) at small size:
init_global_ocean on the 642-cell sphere from synthetic_woa_dataset() at
10 levels, the 8 ecosys pools, DIC and ALK (12 tracers), then 3 steps of
split_step (dt 900 s, btr 60 s) with the init's wind forcing,
ecosys_step and carbon_step; every analysis member through an
AnalysisDriver at a 2-step interval (t = 0 and 1,800 s) and four
ParticleTrackers, one per vertical treatment, one particle per ocean
cell, stepping every step. The reference runs the same loop of its own
functions. State, member histories and particles are held at 1e-9 x
max|ref|. Also: every TRiSK contraction of the step goes through the K2
wrapper, 185 a step; the BGC tracers stay >= 0 and volume is conserved;
land edges move in both packages (ROADMAP §3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.ocean import analysis as janalysis
from mpas_tpu.cores.ocean import bgc as jbgc
from mpas_tpu.cores.ocean import core as jcore
from mpas_tpu.cores.ocean import init_global_ocean as jglobal
from mpas_tpu.cores.ocean.analysis import particles as jparticles
from mpas_tpu.mesh import sphere as jsphere
from mpas_tpu_torch.cores.ocean import core as tcore
from mpas_tpu_torch.mesh import sphere as tsphere
from mpas_tpu_torch.ops import stencils
from mpas_tpu_torch.tools import ocean_global as og
from tests.test_torch_ocean_analysis import assert_close

torch.set_num_threads(1)

STEP_REL = 1e-9
NZ = 10
STEPS = 3
F64 = torch.float64


class Slice:
    """Both packages' runs of the slice, with their analysis histories
    and particles."""

    def __init__(self):
        ds = jglobal.synthetic_woa_dataset()
        tmesh = tsphere.icosahedral_mesh(8, lloyd_iters=2)
        cfg, grid, state, forcing = og.setup(tmesh, NZ, dataset=ds)
        self.cfg = cfg
        self.grid = grid.to("cpu", F64)
        self.state0 = state.to("cpu", F64)
        self.forcing = forcing.to("cpu", F64)
        jg, js, jf = jglobal.init_global_ocean(
            jsphere.icosahedral_mesh(8, lloyd_iters=2), ds, nz=NZ)
        self.jgrid = jax.tree.map(jnp.asarray, jg)
        self.jstate0 = jax.tree.map(jnp.asarray, js).replace(
            tracers=jnp.asarray(self.state0.tracers.numpy()))
        self.jforcing = jax.tree.map(jnp.asarray, jf)
        self.jcfg = jcore.OcnConfig(**dataclasses.asdict(cfg))
        self.run_port()
        self.run_reference()

    def run_port(self):
        grid, cfg, dt = self.grid, self.cfg, self.cfg.config_dt
        state = self.state0
        sw = og.shortwave(grid)
        driver = og.analysis_driver(grid, cfg, 2 * dt)
        trackers = og.trackers(grid, cfg, state)
        og.analysis(driver, grid, cfg, state, 0.0, self.forcing)
        self.volumes = [og.volume(grid, state)]
        for i in range(STEPS):
            state = og.dynamics(grid, cfg, state, self.forcing)
            state = og.bgc(grid, state, dt, sw)
            og.analysis(driver, grid, cfg, state, (i + 1) * dt,
                        self.forcing)
            og.particles(trackers, grid, cfg, state, dt)
            self.volumes.append(og.volume(grid, state))
        self.state, self.history = state, driver.history
        self.particles = [t.state for t in trackers]

    def run_reference(self):
        grid, cfg, dt = self.jgrid, self.jcfg, self.jcfg.config_dt
        m = grid.mesh
        state = self.jstate0
        sw = og.SW_PEAK * jnp.maximum(jnp.cos(m.latCell), 0.0)
        wind = jnp.full_like(sw, og.WIND10)
        driver = janalysis.AnalysisDriver(
            {n: 2 * dt for n in janalysis.available_members()})
        driver.init(grid, cfg)
        cells = og.ocean_cells(self.grid).numpy()
        rho = jcore.equation_of_state(cfg, state.tracers[..., 0],
                                      state.tracers[..., 1])
        depth = np.full(len(cells), og.PARTICLE_DEPTH)
        extra = {"indexLevel": {}, "fixedZLevel": {"depth": depth},
                 "passiveFloat": {"depth": depth},
                 "isopycnal": {"target_rho": np.asarray(
                     rho)[cells, og.ISOPYCNAL_LAYER]}}
        trackers = [jparticles.ParticleTracker(
            m, np.asarray(m.xCell)[cells], np.asarray(m.yCell)[cells],
            layer=og.PARTICLE_LAYER, z0=np.asarray(m.zCell)[cells],
            vertical_mode=mode, **extra[mode]) for mode in og.VERTICAL_MODES]
        driver.compute_due(grid, cfg, state, 0.0, forcing=self.jforcing)
        for i in range(STEPS):
            state = jcore.run_steps(grid, cfg, state, 1, self.jforcing)
            state = jbgc.ecosys_step(state, grid, dt, sw,
                                     index0=og.ECOSYS_INDEX0)
            state, _ = jbgc.carbon_step(
                state, grid, dt, state.tracers[:, 0, 0],
                state.tracers[:, 0, 1], wind, og.DIC_INDEX, og.ALK_INDEX)
            driver.compute_due(grid, cfg, state, (i + 1) * dt,
                               forcing=self.jforcing)
            rho = jcore.equation_of_state(cfg, state.tracers[..., 0],
                                          state.tracers[..., 1])
            c1, c2 = m.cellsOnEdge[:, 0], m.cellsOnEdge[:, 1]
            h = state.layerThickness
            uh = state.u * 0.5 * (h[c1] + h[c2]) * grid.edgeMask
            w = jcore.thickness_tendency(grid, uh)[2]
            for t in trackers:
                t.step(state.u, dt, layer_thickness=h, w_vert=w,
                       density=rho)
        self.jstate, self.jhistory = state, driver.history
        self.jparticles = [t.state for t in trackers]


@pytest.fixture(scope="module")
def run():
    return Slice()


def test_slice_sizes(run):
    assert run.state.tracers.shape == (642, NZ, 12)
    assert run.cfg.config_dt == 900.0 and run.cfg.config_btr_dt == 60.0
    assert len(run.particles[0].x) == len(og.ocean_cells(run.grid)) > 500


@pytest.mark.parametrize("field", ["u", "layerThickness", "tracers",
                                   "ubtr"])
def test_state_matches_reference(run, field):
    assert_close(getattr(run.state, field), getattr(run.jstate, field),
                 field, STEP_REL)


@pytest.mark.parametrize("name", janalysis.available_members())
def test_member_history_matches_reference(run, name):
    """Each output at STEP_REL x max|ref|; outputs of the sea-surface
    height, rounding noise at rest (t = 0), at STEP_REL x the deepest
    column (the terms whose difference they are)."""
    depth = float(run.grid.bottomDepth.max())
    assert [t for t, _ in run.history[name]] == [0.0, 1800.0]
    for (_, got), (_, ref) in zip(run.history[name], run.jhistory[name]):
        assert sorted(got) == sorted(ref)
        for k in got:
            atol = STEP_REL * depth if "ssh" in k.lower() else 0.0
            assert_close(got[k], ref[k], f"{name}.{k}", STEP_REL, atol)


@pytest.mark.parametrize("i", range(len(og.VERTICAL_MODES)))
def test_particles_match_reference(run, i):
    assert_close(run.particles[i], run.jparticles[i],
                 og.VERTICAL_MODES[i], STEP_REL)
    land = (run.grid.tidalEnergyFlux == 0).numpy()
    assert not land[run.particles[i].cell.numpy()].any()


def test_gates(run):
    """The chip path's gates at small size: BGC tracers >= 0, volume
    conserved, max |u| < 5 m/s, all finite."""
    st = run.state
    assert (st.tracers[..., 2:] >= 0).all()
    assert max(abs(v - run.volumes[0]) / run.volumes[0]
               for v in run.volumes) < 1e-13
    assert float(st.u.abs().max()) < og.MAX_U
    for k in ("u", "layerThickness", "tracers", "ubtr"):
        assert torch.isfinite(getattr(st, k)).all()


def test_land_edges_move_in_both_packages(run):
    """init_global_ocean's land columns keep 2 active levels
    (init_global_ocean.py:133-137 through _pbc_grid), so the flow between
    two land cells is not held at 0: a fault of the reference the port
    shares (ROADMAP §3)."""
    land = (run.grid.tidalEnergyFlux == 0).numpy()
    coe = run.grid.mesh.cellsOnEdge.numpy()
    land_edges = land[coe[:, 0]] & land[coe[:, 1]]
    assert land_edges.sum() > 10
    ju = np.abs(np.asarray(run.jstate.u)[land_edges]).max()
    tu = float(run.state.u[torch.from_numpy(land_edges)].abs().max())
    assert ju > 1e-3 and abs(tu - ju) <= STEP_REL * ju


def test_k2_calls_per_step(run, monkeypatch):
    """Every TRiSK contraction of the path's dynamics goes through the K2
    wrapper, tinydot_launches_per_split_step(cfg) = 185 times a step at
    dt 900 s (365 at 1,800 s)."""
    calls = []
    real = stencils.tinydot

    def counting(w, x):
        calls.append(x.shape[-1])
        return real(w, x)

    monkeypatch.setattr(stencils, "tinydot", counting)
    og.dynamics(run.grid, run.cfg, run.state0, run.forcing)
    assert len(calls) == tcore.tinydot_launches_per_split_step(run.cfg) \
        == 185
    assert (calls.count(1), calls.count(NZ), calls.count(2 * NZ)) \
        == (180, 3, 2)


def test_init_forcing_restores_toward_zero(run):
    """init_global_ocean's forcing is zero_forcing with the wind set
    (init_global_ocean.py:165-170), and surface_tracer_tend restores SST
    and SSS toward its zero sstRestore/sssRestore (forcing.py:99-122): a
    fault of the reference the port shares (ROADMAP §3). The surface
    tendencies equal the piston velocities times -T and -S in both
    packages."""
    from mpas_tpu.cores.ocean import forcing as jforcing
    from mpas_tpu_torch.cores.ocean import forcing as tforcing
    f, st = run.forcing, run.state0
    assert not f.sstRestore.any() and not f.sssRestore.any()
    got = tforcing.surface_tracer_tend(run.grid, run.cfg, f,
                                       st.layerThickness, st.tracers)
    ref = jforcing.surface_tracer_tend(run.jgrid, run.jcfg, run.jforcing,
                                       run.jstate0.layerThickness,
                                       run.jstate0.tracers)
    assert_close(got, ref, "surface tendency", 1e-11)
    T, S = st.tracers[:, 0, 0], st.tracers[:, 0, 1]
    assert torch.allclose(got[:, 0, 0], -4.0e-5 * T, rtol=1e-12, atol=0)
    assert torch.allclose(got[:, 0, 1], -4.0e-6 * S, rtol=1e-12, atol=0)
