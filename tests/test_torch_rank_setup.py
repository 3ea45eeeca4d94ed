"""A shard's set-up from the global mesh and partition alone
(cores/atmosphere/distributed.py: shard_atm_local, then start_carry, as
benchmark/configs/jw_15km.py makes it) against the global cut
(shard_atm_grid and shard_atm_carry of the global init and carry), on the
CPU in float64 at 2,562 cells over 4 shards: every owned, halo and dead
row of the grid, the state and the carry equal bit for bit, in loopback
and over 4 gloo ranks; no rank makes the global init, grid or carry; and
three steps of each equal; init_jw's blocks of columns change no bit."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from mpas_tpu_torch.constants import a
from mpas_tpu_torch.cores.atmosphere import distributed as adist
from mpas_tpu_torch.cores.atmosphere import time_integration as ti
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
from mpas_tpu_torch.cores.atmosphere.state import AtmState
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
from mpas_tpu_torch.parallel.layout import shard_layout
from mpas_tpu_torch.parallel.partition import sfc_partition
from mpas_tpu_torch.parallel.runner import (ShardExchange, ShardGroup,
                                            place, spawn_ranks)

torch.set_num_threads(1)

P, DT = 4, 1200.0
CFG = AtmConfig(config_nvertlevels=6, config_len_disp=960000.0,
                config_dt=DT)
STEPS = 3


def init(mesh):
    return init_jw(mesh, CFG, case=2, n_scalars=1, radius=a)


def perturb(grid, state, diag):
    """A change of the initial state as a benchmark makes one: u and ru
    moved on every edge, the scalar drawn on every cell."""
    du = 0.5 * torch.cos(3.0 * grid.mesh.lonEdge)[:, None]
    c = grid.mesh.cellsOnEdge
    rho_edge = 0.5 * (state.rho_zz[c[:, 0]] + state.rho_zz[c[:, 1]])
    q = (1.0 + 0.25 * torch.sin(2.0 * grid.mesh.latCell))[:, None, None] \
        .expand_as(state.scalars).contiguous()
    return (dataclasses.replace(state, u=state.u + du, scalars=q),
            dataclasses.replace(diag, ru=diag.ru + rho_edge * du))


def set_up(mesh, part, group, init_fn=init, layout=None):
    """(grid, carry, xch) of `group`'s shards: shard_atm_local, the state
    changed by perturb, start_carry; layout: the partition's, made here
    where not given."""
    layout = layout or shard_layout(mesh, part, adist.ATM_HALO_DEPTH)
    grid, state, diag = adist.shard_atm_local(mesh, part, layout, group,
                                              torch.float64, init_fn)
    state, diag = perturb(grid, state, diag)
    carry, xch = adist.start_carry(grid, CFG, state, diag, DT, layout,
                                   group)
    return grid, carry, xch


@pytest.fixture(scope="module")
def globe():
    mesh = icosahedral_mesh(16, lloyd_iters=1)
    part = sfc_partition(mesh, P)
    grid, state, diag = init(mesh)
    state, diag = perturb(grid, state, diag)
    carry = ti.init_carry(grid, CFG, state, diag, DT)
    satm = adist.shard_atm_grid(grid, part)
    return Cut(mesh, part, satm, adist.shard_atm_carry(satm, carry))


@dataclasses.dataclass
class Cut:
    mesh: object
    part: object
    satm: object
    carry: object       # stacked (P, ...) carry of the global cut


def flat(obj, prefix=""):
    """{dotted name: field} of a dataclass, nested ones by their fields."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def assert_same(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], torch.Tensor):
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            assert torch.equal(g[k], w[k]), k
        else:
            assert g[k] == w[k], k


def stepped(grid, carry, xch):
    for _ in range(STEPS):
        carry = ti.srk3_step(grid, CFG, carry, DT, xch=xch)
    return carry


def test_loopback_setup_is_the_global_cut(globe):
    group = ShardGroup(P, torch.device("cpu"))
    grid, carry, xch = set_up(globe.mesh, globe.part, group)
    want_grid = globe.satm.local(group, torch.float64)
    want_carry = place(globe.carry, group, torch.float64)
    assert_same(grid, want_grid)
    assert_same(carry, want_carry)
    want_xch = ShardExchange(globe.satm.smesh, group)
    assert_same(stepped(grid, carry, xch),
                stepped(want_grid, want_carry, want_xch))


def _on_rank(group, mesh, part):
    """A rank's set-up with a count of what it calls: (its grid and carry
    as numpy, the state after STEPS steps, the nCells of each mesh init
    ran on, the calls of the global cut's functions)."""
    calls = {"shard_atm_grid": 0, "shard_atm_carry": 0, "init_carry": []}
    meshes = []

    def counted(name):
        fn = getattr(adist, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        setattr(adist, name, call)
    counted("shard_atm_grid")
    counted("shard_atm_carry")
    carry_fn = adist.init_carry

    def carry_call(grid, *args, **kw):
        calls["init_carry"].append(grid.mesh.nCells)
        return carry_fn(grid, *args, **kw)
    adist.init_carry = carry_call

    def watched_init(m):
        meshes.append(m.nCells)
        return init(m)
    grid, carry, xch = set_up(mesh, part, group, watched_init)
    state = stepped(grid, carry, xch).state
    numpy = {k: v.numpy() for k, v in {**flat(grid, "grid."),
                                       **flat(carry, "carry.")}.items()
             if isinstance(v, torch.Tensor)}
    return (numpy, {k: v.numpy() for k, v in flat(state).items()},
            meshes, calls)


def test_gloo_ranks_set_up_their_own_shards(globe, tmp_path):
    ranks = spawn_ranks(_on_rank, P, tmp_path / "store",
                        args=(globe.mesh, globe.part),
                        devices=["cpu"] * P, timeout=120.0, deadline=600.0)
    group = ShardGroup(P, torch.device("cpu"))
    want_grid = flat(globe.satm.grid, "grid.")
    want_carry = flat(globe.carry, "carry.")
    want_state = AtmState(**{
        k: torch.from_numpy(v) for k, v in zip(
            ("u", "w", "theta_m", "rho_zz", "scalars"),
            [np.stack(x) for x in zip(*(
                [r[1][k] for k in ("u", "w", "theta_m", "rho_zz",
                                   "scalars")] for r in ranks))])})
    lay = shard_layout(globe.mesh, globe.part, adist.ATM_HALO_DEPTH)
    for r, (numpy, _, meshes, calls) in enumerate(ranks):
        # one init, on this shard's entities alone; the global cut never
        assert meshes == [len(np.asarray(adist.halo_mesh(
            globe.mesh, globe.part, r, lay.halo_depth
            + adist.INIT_REACH)[1]["cell"]))]
        assert meshes[0] < globe.mesh.nCells
        assert calls["shard_atm_grid"] == calls["shard_atm_carry"] == 0
        assert calls["init_carry"] == [lay.n_local("cell")]
        for k, v in numpy.items():
            name = k.split(".", 1)[1]
            if k.startswith("grid.mesh."):
                want = globe.satm.smesh.mesh
                want = getattr(want, name.split(".", 1)[1])[r]
            elif k.startswith("grid.vert."):
                want = want_grid[k]             # the same on every shard
            elif k.startswith("grid."):
                want = want_grid[k][r]
            else:
                want = want_carry[k][r]
            np.testing.assert_array_equal(v, want.numpy(), err_msg=k)
    # three steps over the gloo ranks equal three loopback steps
    want = stepped(globe.satm.local(group, torch.float64),
                   place(globe.carry, group, torch.float64),
                   ShardExchange(globe.satm.smesh, group)).state
    got = place(want_state, group, torch.float64)
    for f in ("u", "w", "theta_m", "rho_zz", "scalars"):
        x, y = getattr(got, f), getattr(want, f)
        assert float((x - y).abs().max()) <= 1e-11 * float(y.abs().max()), f


def test_setup_reads_the_layout_it_is_given(globe):
    """A layout read back from its pickle (as a benchmark caches it)
    gives the same grid and carry as the one made afresh."""
    group = ShardGroup(P, torch.device("cpu"))
    lay = shard_layout(globe.mesh, globe.part, adist.ATM_HALO_DEPTH)
    kept = pickle.loads(pickle.dumps(lay, protocol=pickle.HIGHEST_PROTOCOL))
    got = set_up(globe.mesh, globe.part, group, layout=kept)
    want = set_up(globe.mesh, globe.part, group, layout=lay)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


def test_init_blocks_change_no_bit(monkeypatch):
    """init_jw's column work on blocks of rows (setup.by_blocks) equals
    the work on the whole mesh at once, bit for bit, blocks ragged."""
    from mpas_tpu_torch.cores.atmosphere import setup
    mesh = icosahedral_mesh(8, lloyd_iters=1)
    monkeypatch.setattr(setup, "BLOCK", 10 ** 9)
    whole = init(mesh)
    monkeypatch.setattr(setup, "BLOCK", 37)
    for got, want in zip(init(mesh), whole):
        assert_same(got, want)
