"""The port's sharded runners on the CPU (float64): decomposition
invariance of the atmosphere, shallow-water and ocean cores.

Every sharded run is held to the port's single-device run of the same
steps on owned entities, at the bounds of the JAX package's own
decomposition tests: the JW case 2 (642 cells, 10 levels, 3 steps of
1,800 s; tests/test_atm_distributed.py:25-64) at 1e-11 x max|ref|, P = 1
bit for bit; the moist supercell with Kessler on the 144-cell plane
(2 steps, :159-167) at 1e-10; shallow-water TC5 (5 steps;
tests/test_distributed.py:53-61); the baroclinic channel (8 x 26 cells,
10 levels, 12 steps of 60 s, split-explicit and RK4;
tests/test_ocean_distributed.py:72-83). The loopback transport runs all
shards in one process; two gloo ranks spawned by runner.spawn_ranks run
the process-group transport, held to loopback at 1e-12 with the owned
reductions psum_owned/pmax_owned.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.mesh.mesh import Mesh as JMesh
from mpas_tpu.parallel import layout as jlayout
from mpas_tpu.parallel import partition as jpart
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere import distributed as adist
from mpas_tpu_torch.cores.atmosphere import time_integration as ti
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
from mpas_tpu_torch.cores.ocean import core as ocore
from mpas_tpu_torch.cores.ocean import distributed as odist
from mpas_tpu_torch.cores.ocean.config import OcnConfig
from mpas_tpu_torch.cores.ocean.init_channel import init_baroclinic_channel
from mpas_tpu_torch.cores.sw import distributed as sdist
from mpas_tpu_torch.cores.sw import test_cases
from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.cores.sw.state import SWState
from mpas_tpu_torch.cores.sw.time_integration import run_steps as sw_run_steps
from mpas_tpu_torch.mesh.planar import channel_hex_mesh, planar_hex_mesh
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
from mpas_tpu_torch.parallel.layout import build_sharded_mesh
from mpas_tpu_torch.parallel.partition import sfc_partition
from mpas_tpu_torch.parallel.runner import (ShardExchange, device_mesh,
                                            gather_field, place,
                                            scatter_field, spawn_ranks)

torch.set_num_threads(1)

F64 = torch.float64
ATM_FIELDS = (("u", "edge"), ("w", "cell"), ("theta_m", "cell"),
              ("rho_zz", "cell"))


def rel_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def n_of(mesh, kind):
    return mesh.nCells if kind == "cell" else mesh.nEdges


# --- the atmosphere -------------------------------------------------------------

class JW:
    """JW case 2 on the 642-cell sphere, 10 levels, and its single-device
    3-step run."""
    STEPS = 3

    def __init__(self):
        self.cfg = AtmConfig(config_nvertlevels=10, config_len_disp=960000.0,
                             config_dt=1800.0)
        self.grid, state, diag = init_jw(icosahedral_mesh(8, lloyd_iters=2),
                                         self.cfg, case=2)
        self.carry0 = ti.init_carry(self.grid, self.cfg, state, diag,
                                    self.cfg.config_dt)
        self.ref = ti.run_steps(self.grid, self.cfg, self.carry0,
                                self.cfg.config_dt, self.STEPS)
        self.sharded = {}

    def shard(self, n_parts):
        if n_parts not in self.sharded:
            satm = adist.shard_atm_grid(
                self.grid, sfc_partition(self.grid.mesh, n_parts))
            self.sharded[n_parts] = (satm,
                                     adist.shard_atm_carry(satm, self.carry0))
        return self.sharded[n_parts]

    def loopback(self, n_parts, xch=None):
        """(sharded layout, group, final carry) of a loopback run; xch
        replaces the runner's exchange hooks where given."""
        satm, carry_st = self.shard(n_parts)
        group = device_mesh(n_parts, "cpu")
        grid_l = satm.local(group, F64)
        carry_l = place(carry_st, group, F64)
        if xch is None:
            out = adist.make_run_steps_atm(satm, self.cfg, group)(
                grid_l, carry_l, self.STEPS)
        else:
            out = ti.run_steps_xch(grid_l, self.cfg, carry_l,
                                   self.cfg.config_dt, self.STEPS,
                                   xch(ShardExchange(satm.smesh, group)))
        return satm, group, out

    def gathered(self, n_parts, xch=None):
        satm, group, out = self.loopback(n_parts, xch)
        return {k: gather_field(satm.smesh, group.stack(getattr(out.state, k)),
                                kind, n_of(self.grid.mesh, kind))
                for k, kind in ATM_FIELDS}


@pytest.fixture(scope="module")
def jw():
    return JW()


@pytest.fixture(scope="module")
def jw_runs(jw):
    return {P: jw.gathered(P) for P in (1, 2, 4)}


def test_one_shard_is_the_single_device_run_bit_for_bit(jw, jw_runs):
    for k, _ in ATM_FIELDS:
        assert np.array_equal(jw_runs[1][k],
                              getattr(jw.ref.state, k).numpy()), k


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("field", [k for k, _ in ATM_FIELDS])
def test_atm_decomp_invariance(jw, jw_runs, n_parts, field):
    err = rel_err(jw_runs[n_parts][field], getattr(jw.ref.state, field))
    print(f"JW P={n_parts} {field}: {err:.3e} x max|ref|")
    assert err < 1e-11, (field, err)


@pytest.mark.parametrize("field", [k for k, _ in ATM_FIELDS])
def test_atm_two_against_four_shards(jw_runs, field):
    assert rel_err(jw_runs[2][field], jw_runs[4][field]) < 1e-11


class _Counting:
    """Exchange hooks that count their calls by (kind, depth) and leave
    out those of `drop`."""

    def __init__(self, real, drop=()):
        self.real, self.drop, self.calls = real, drop, {}

    def _hook(self, kind, x, depth):
        self.calls[(kind, depth)] = self.calls.get((kind, depth), 0) + 1
        if (kind, depth) in self.drop:
            return x
        return getattr(self.real, kind)(x, depth)

    def cell(self, x, depth=None):
        return self._hook("cell", x, depth)

    def edge(self, x, depth=None):
        return self._hook("edge", x, depth)


def test_exchange_points_per_step(jw):
    """119 exchanges a step at the reference's points and depths: 11 at
    step start (9 cell, 2 edge fields); in each of the 3 dynamics
    substeps, 2 per acoustic iteration (4: rtheta_pp and rho_pp, depth 1)
    and, in each of the 3 RK stages, tend_u (depth 1), 6 before the
    recovery (4 at depth 2, ruAvg and wwAvg full) and u2, w2 after it;
    one per transport stage (3)."""
    hooks = []

    def counting(real):
        hooks.append(_Counting(real))
        return hooks[0]
    jw.loopback(2, counting)
    per_step = {k: v / JW.STEPS for k, v in hooks[0].calls.items()}
    assert per_step == {("cell", None): 9 + 3 * 3 * 2 + 3,
                        ("edge", None): 2 + 3 * 3 * 2,
                        ("edge", 1): 3 * 3, ("cell", 1): 3 * 2 * 4,
                        ("cell", 2): 3 * 3 * 3, ("edge", 2): 3 * 3}
    assert sum(per_step.values()) == 119


@pytest.mark.parametrize("drop", [(("cell", 1),), (("cell", 2),),
                                  (("edge", 2),), (("edge", None),)])
def test_a_missing_exchange_is_seen(jw, drop):
    """Leaving out one group of exchanges moves the owned cells by far
    more than the bound: the invariance tests see every exchange."""
    got = jw.gathered(4, lambda real: _Counting(real, drop))
    assert max(rel_err(got[k], getattr(jw.ref.state, k))
               for k, _ in ATM_FIELDS) > 1e-6


def test_xch_none_is_the_unhooked_step(jw):
    """xch=None is the identity: one step equals the step with identity
    hooks that count their calls."""
    cfg, dt = jw.cfg, jw.cfg.config_dt
    ident = _Counting(ti.NO_XCH)
    a = ti.srk3_step(jw.grid, cfg, jw.carry0, dt)
    b = ti.srk3_step(jw.grid, cfg, jw.carry0, dt, xch=ident)
    for k, _ in ATM_FIELDS:
        assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
    assert sum(ident.calls.values()) == 119


def test_atm_process_group_matches_loopback(jw, tmp_path):
    """Two gloo ranks against the loopback run at 1e-12, with the owned
    dry-air mass (psum_owned) and max w (pmax_owned)."""
    satm, carry_st = jw.shard(2)
    loop = adist.run_on_rank(device_mesh(2, "cpu"), satm, jw.cfg, carry_st,
                             JW.STEPS)
    ranks = spawn_ranks(adist.run_on_rank, 2, tmp_path / "store",
                        args=(satm, jw.cfg, carry_st, JW.STEPS),
                        devices=["cpu", "cpu"])
    for k, _ in ATM_FIELDS:
        for r in ranks:          # every rank gathers every shard
            assert rel_err(r[k], loop[k]) <= 1e-12, k
    for r in ranks:
        assert abs(r["dry_mass"] - loop["dry_mass"]) \
            <= 1e-12 * loop["dry_mass"]
        assert r["w_max"] == loop["w_max"]
    # the owned mass is the global mass of the single-device run
    ref = (jw.ref.state.rho_zz * jw.grid.vert.dzw
           * jw.grid.mesh.areaCell[:, None]).sum()
    assert abs(loop["dry_mass"] - float(ref)) <= 1e-12 * float(ref)


def test_moist_kessler_decomp_invariance():
    """The supercell with Kessler and monotonic transport of three
    scalars, seeded with cloud and rain, 2 steps on 2 shards."""
    cfg = AtmConfig(config_nvertlevels=20, config_len_disp=4000.0,
                    config_dt=8.0, config_microp_scheme="mp_kessler",
                    config_scalar_advection=True, config_monotonic=True)
    grid, state, diag = init_supercell(planar_hex_mesh(12, 12, 2000.0), cfg,
                                       case=5)
    state = dataclasses.replace(
        state, scalars=seeded_moisture(grid.mesh, state.scalars, seed=7))
    carry0 = ti.init_carry(grid, cfg, state, diag, cfg.config_dt)
    ref = ti.run_steps(grid, cfg, carry0, cfg.config_dt, 2)
    satm = adist.shard_atm_grid(grid, sfc_partition(grid.mesh, 2))
    group = device_mesh(2, "cpu")
    out = adist.make_run_steps_atm(satm, cfg, group)(
        satm.local(group, F64),
        place(adist.shard_atm_carry(satm, carry0), group, F64), 2)
    assert float(ref.rainnc.max()) > 0.0
    for name, mine, r in (("theta_m", out.state.theta_m, ref.state.theta_m),
                          ("scalars", out.state.scalars, ref.state.scalars),
                          ("rainnc", out.rainnc, ref.rainnc)):
        got = gather_field(satm.smesh, group.stack(mine), "cell",
                           grid.mesh.nCells)
        err = rel_err(got, r.numpy())
        print(f"moist P=2 {name}: {err:.3e}")
        assert err < 1e-10, (name, err)


def test_dead_slot_guards():
    """Dead padded slots carry the divisor guards: zz, the base state,
    rho_zz and exner 1, theta_m 300."""
    cfg = AtmConfig(config_nvertlevels=4, config_len_disp=960000.0,
                    config_dt=1800.0)
    grid, state, diag = init_jw(icosahedral_mesh(4, lloyd_iters=1), cfg,
                                case=2)
    satm = adist.shard_atm_grid(grid, sfc_partition(grid.mesh, 4))
    dead = torch.from_numpy(satm.smesh.cell_global < 0)
    assert bool(dead.any())
    for k in ("zz", "rho_base", "rtheta_base", "exner_base"):
        assert bool((getattr(satm.grid, k)[dead] == 1.0).all()), k
    st, dg = adist.shard_atm_state(satm, state, diag)
    assert bool((st.rho_zz[dead] == 1.0).all())
    assert bool((dg.exner[dead] == 1.0).all())
    assert bool((st.theta_m[dead] == 300.0).all())


# --- shallow water ------------------------------------------------------------

@pytest.fixture(scope="module")
def tc5():
    mesh, state, h_s = test_cases.test_case_5(icosahedral_mesh(
        8, lloyd_iters=2))
    cfg = SWConfig(config_dt=900.0, config_test_case=5)
    return mesh, state, h_s, cfg, sw_run_steps(mesh, cfg, state, h_s, 5)


def sw_sharded(mesh, state, h_s, cfg, smesh, n_steps=5):
    group = device_mesh(smesh.n_parts, "cpu")
    st = SWState(u=scatter_field(smesh, state.u, "edge"),
                 h=scatter_field(smesh, state.h, "cell"),
                 tracers=scatter_field(smesh, state.tracers, "cell"))
    out = sdist.make_run_steps(smesh, cfg, group)(
        smesh.local(group, F64), place(st, group, F64),
        group.local(scatter_field(smesh, h_s, "cell"), F64), n_steps)
    return {k: gather_field(smesh, group.stack(getattr(out, k)), kind,
                            n_of(mesh, kind))
            for k, kind in (("h", "cell"), ("u", "edge"),
                            ("tracers", "cell"))}


@pytest.mark.parametrize("n_parts", [2, 4])
def test_sw_decomp_invariance(tc5, n_parts):
    mesh, state, h_s, cfg, ref = tc5
    sm = build_sharded_mesh(mesh, sfc_partition(mesh, n_parts),
                            halo_depth=sdist.SW_HALO_DEPTH)
    got = sw_sharded(mesh, state, h_s, cfg, sm)
    assert rel_err(got["h"], ref.h.numpy()) < 1e-13
    assert rel_err(got["u"], ref.u.numpy()) < 1e-12
    assert float(np.abs(got["tracers"] - ref.tracers.numpy()).max()) < 1e-12


def test_sw_runner_on_the_reference_layout(tc5):
    """The port's runner on the JAX-built layout (carried over by
    convert.sharded_mesh_from_arrays) gives what it gives on its own."""
    mesh, state, h_s, cfg, _ = tc5
    jm = JMesh(**convert.to_arrays(mesh))
    jsm = jlayout.build_sharded_mesh(jm, jpart.sfc_partition(jm, 4),
                                     halo_depth=sdist.SW_HALO_DEPTH)
    carried = convert.sharded_mesh_from_arrays(flatten(jsm))
    own = build_sharded_mesh(mesh, sfc_partition(mesh, 4),
                             halo_depth=sdist.SW_HALO_DEPTH)
    a = sw_sharded(mesh, state, h_s, cfg, carried)
    b = sw_sharded(mesh, state, h_s, cfg, own)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def flatten(obj):
    """A reference (flax) container -> nested dicts of numpy arrays and
    statics; dicts and tuples of containers recurse."""
    if dataclasses.is_dataclass(obj):
        return {f.name: flatten(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: flatten(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and obj and not isinstance(
            obj[0], (int, tuple)):
        return tuple(flatten(v) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str, tuple)):
        return obj
    return np.asarray(obj)


# --- the ocean ------------------------------------------------------------------

@pytest.fixture(scope="module")
def channel():
    m = channel_hex_mesh(8, 26, 10000.0)
    grid, state = init_baroclinic_channel(m, nz=10)
    return grid, dataclasses.replace(
        state, ubtr=torch.zeros(m.nEdges, dtype=state.u.dtype))


OCN_FIELDS = (("u", "edge"), ("layerThickness", "cell"), ("tracers", "cell"))


def ocn_loopback(grid, state, cfg, n_parts, n_steps):
    socn = odist.shard_ocn_grid(grid, sfc_partition(grid.mesh, n_parts))
    group = device_mesh(n_parts, "cpu")
    out = odist.make_run_steps_ocn(socn, cfg, group)(
        socn.local(group, F64),
        place(odist.shard_ocn_state(socn, state), group, F64), n_steps)
    return {k: gather_field(socn.smesh, group.stack(getattr(out, k)), kind,
                            n_of(grid.mesh, kind))
            for k, kind in OCN_FIELDS}


@pytest.mark.parametrize("integrator", ["split_explicit", "RK4"])
def test_ocean_decomp_invariance(channel, integrator):
    grid, state = channel
    cfg = OcnConfig(config_dt=60.0, config_time_integrator=integrator)
    ref = ocore.run_steps(grid, cfg, state, 12)
    got = ocn_loopback(grid, state, cfg, 4, 12)
    for k, _ in OCN_FIELDS:
        r = getattr(ref, k).numpy()
        print(f"ocean {integrator} P=4 {k}: max abs err "
              f"{float(np.abs(got[k] - r).max()):.3e}, "
              f"{rel_err(got[k], r):.3e} x max|ref|")
    np.testing.assert_allclose(got["u"], ref.u.numpy(), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(got["layerThickness"],
                               ref.layerThickness.numpy(), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got["tracers"], ref.tracers.numpy(),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("cor_iter", [0, 1, 2])
def test_ocean_split_subcycle_halo_is_deep_enough(channel, cor_iter):
    """3 split steps of 300 s on 4 shards at 1e-11 x max|ref|: the
    barotropic subcycle refreshes 2 + config_n_btr_cor_iter rings."""
    grid, state = channel
    cfg = OcnConfig(config_dt=300.0, config_n_btr_cor_iter=cor_iter)
    ref = ocore.run_steps(grid, cfg, state, 3)
    got = ocn_loopback(grid, state, cfg, 4, 3)
    for k, _ in OCN_FIELDS:
        err = rel_err(got[k], getattr(ref, k).numpy())
        print(f"ocean split cor_iter={cor_iter} P=4 {k}: {err:.3e}")
        assert err < 1e-11, (k, err)


@pytest.mark.parametrize("integrator", ["split_explicit", "RK4"])
def test_ocean_one_shard_bit_for_bit(channel, integrator):
    grid, state = channel
    cfg = OcnConfig(config_dt=60.0, config_time_integrator=integrator)
    ref = ocore.run_steps(grid, cfg, state, 2)
    got = ocn_loopback(grid, state, cfg, 1, 2)
    for k, _ in OCN_FIELDS:
        assert np.array_equal(got[k], getattr(ref, k).numpy()), k


def test_ocean_subcycle_exchange_is_depth_restricted(channel):
    """The barotropic subcycle exchanges the depth-2 schedule, which
    moves strictly less than the full one (ref: haloLayers-restricted
    subcycleFields, mpas_ocn_time_integration_split.F:771)."""
    grid, _ = channel
    sm = odist.shard_ocn_grid(grid, sfc_partition(grid.mesh, 4)).smesh
    assert sm.cell_nx[2].volume < sm.cell_nx[odist.OCN_HALO_DEPTH].volume
    assert sm.edge_nx[2].volume < sm.edge_nx[odist.OCN_HALO_DEPTH].volume


def test_ocean_process_group_matches_loopback(channel, tmp_path):
    grid, state = channel
    cfg = OcnConfig(config_dt=60.0, config_time_integrator="split_explicit")
    socn = odist.shard_ocn_grid(grid, sfc_partition(grid.mesh, 2))
    state_st = odist.shard_ocn_state(socn, state)
    loop = odist.run_on_rank(device_mesh(2, "cpu"), socn, cfg, state_st, 3)
    ranks = spawn_ranks(odist.run_on_rank, 2, tmp_path / "store",
                        args=(socn, cfg, state_st, 3),
                        devices=["cpu", "cpu"])
    for k, _ in OCN_FIELDS:
        for r in ranks:          # every rank gathers every shard
            assert rel_err(r[k], loop[k]) <= 1e-12, k
    for r in ranks:
        for k in ("volume", "heat"):
            assert abs(r[k] - loop[k]) <= 1e-12 * abs(loop[k]), k
    area = grid.mesh.areaCell[:, None]
    assert abs(loop["volume"] - float((state.layerThickness * area).sum())) \
        <= 1e-10 * loop["volume"]
