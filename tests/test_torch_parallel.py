"""The port's partitions, shard layouts and halo exchanges against the
JAX package's (mpas_tpu/parallel).

Meshes: the 642-cell sphere (icosahedral_mesh(8, lloyd_iters=2)) and the
192-cell planar channel (channel_hex_mesh(8, 26, 10 km)), built by the
JAX package and carried into the port through convert.py, so that both
packages partition and lay out the same float64 mesh. Partitions and
layouts must be equal bit for bit, every array and static. The exchanges
run on halos corrupted to -99 and must give bit for bit what JAX's
neighbor_halo_exchange gives under shard_map on the virtual 8-device CPU
mesh (tests/conftest.py): the loopback transport, a round-by-round
simulation of the schedule, and the gloo process-group transport in four
spawned ranks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from mpas_tpu.mesh.planar import channel_hex_mesh as j_channel_hex_mesh
from mpas_tpu.parallel import layout as jlayout
from mpas_tpu.parallel import partition as jpart
from mpas_tpu.parallel import runner as jrunner
from mpas_tpu_torch import convert
from mpas_tpu_torch.parallel import layout as tlayout
from mpas_tpu_torch.parallel import partition as tpart
from mpas_tpu_torch.parallel import runner as trunner

torch.set_num_threads(1)

KINDS = ("cell", "edge", "vertex")
# trailing dims of the exchanged field per kind: every exchange indexes
# dim 0 only
TRAILING = {"cell": (3,), "edge": (), "vertex": (2, 2)}


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


@pytest.fixture(scope="module")
def meshes(sphere_mesh_small):
    """{name: (JAX mesh, port mesh)}, the port's carried over bit for bit."""
    out = {}
    for name, jm in (("sphere", sphere_mesh_small),
                     ("channel", j_channel_hex_mesh(8, 26, 10000.0))):
        out[name] = (jm, convert.mesh_from_arrays(flatten(jm)))
    return out


MESHES = ["sphere", "channel"]


def assert_equal(a, b, name):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, name
    assert np.array_equal(a, b), name
    if a.dtype.kind == "f":
        assert b.dtype == a.dtype, name


# --- partitions --------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("n_parts", [2, 3, 4, 8])
def test_sfc_partition_matches_reference(meshes, mesh_name, n_parts):
    jm, tm = meshes[mesh_name]
    assert_equal(jpart.sfc_partition(jm, n_parts),
                 tpart.sfc_partition(tm, n_parts), "part")


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("n_parts", [2, 4])
def test_weighted_sfc_partition_matches_reference(meshes, mesh_name,
                                                  n_parts):
    jm, tm = meshes[mesh_name]
    w = np.random.default_rng(n_parts).uniform(0.5, 4.0, jm.nCells)
    assert_equal(jpart.sfc_partition(jm, n_parts, weights=w),
                 tpart.sfc_partition(tm, n_parts, weights=w), "part")


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("hosts,chips", [(2, 2), (2, 4)])
@pytest.mark.parametrize("weighted", [False, True])
def test_hierarchical_partition_and_cuts_match_reference(
        meshes, mesh_name, hosts, chips, weighted):
    jm, tm = meshes[mesh_name]
    w = np.random.default_rng(1).uniform(0.5, 4.0, jm.nCells) \
        if weighted else None
    jp = jpart.hierarchical_sfc_partition(jm, hosts, chips, weights=w)
    tp = tpart.hierarchical_sfc_partition(tm, hosts, chips, weights=w)
    assert_equal(jp, tp, "part")
    assert jpart.inter_host_edge_cut(jm, jp, hosts, chips) \
        == tpart.inter_host_edge_cut(tm, tp, hosts, chips)
    assert jpart.partition_stats(jm, jp) == tpart.partition_stats(tm, tp)


def test_read_metis_partition_matches_reference(tmp_path, meshes):
    jm, _ = meshes["sphere"]
    part = jpart.sfc_partition(jm, 4)
    path = tmp_path / "graph.info.part.4"
    np.savetxt(path, part, fmt="%d")
    assert_equal(jpart.read_metis_partition(str(path), jm.nCells),
                 tpart.read_metis_partition(str(path), jm.nCells), "part")
    for read in (jpart.read_metis_partition, tpart.read_metis_partition):
        with pytest.raises(ValueError, match="entries"):
            read(str(path), jm.nCells + 1)


# --- layouts -------------------------------------------------------------------

@pytest.fixture(scope="module")
def layouts(meshes):
    """{(mesh, P, depth): (JAX ShardedMesh, port ShardedMesh)}."""
    out = {}
    for name in MESHES:
        jm, tm = meshes[name]
        for P in (2, 4):
            jp, tp = jpart.sfc_partition(jm, P), tpart.sfc_partition(tm, P)
            for depth in (2, 4):
                out[(name, P, depth)] = (
                    jlayout.build_sharded_mesh(jm, jp, halo_depth=depth),
                    tlayout.build_sharded_mesh(tm, tp, halo_depth=depth))
    return out


def assert_layouts_equal(js, ts):
    for f in dataclasses.fields(js.mesh):
        assert_equal(getattr(js.mesh, f.name), getattr(ts.mesh, f.name),
                     f"mesh.{f.name}")
    for k in ("owned_cell_mask", "owned_edge_mask", "owned_vertex_mask",
              "cell_global", "edge_global", "vertex_global"):
        assert_equal(getattr(js, k), getattr(ts, k), k)
    assert (js.n_parts, js.halo_depth) == (ts.n_parts, ts.halo_depth)
    for k in ("cell_xch", "edge_xch"):
        a, b = getattr(js, k), getattr(ts, k)
        assert_equal(a.send_idx, b.send_idx, f"{k}.send_idx")
        assert_equal(a.perm, b.perm, f"{k}.perm")
        assert (a.owned_pad, a.msg_size) == (b.owned_pad, b.msg_size), k
    for k in ("cell_nx", "edge_nx", "vertex_nx"):
        ja, ta = getattr(js, k), getattr(ts, k)
        assert sorted(ja) == sorted(ta), k
        for d in ja:
            a, b = ja[d], ta[d]
            assert (a.perms, a.sizes, a.volume) == (b.perms, b.sizes,
                                                    b.volume), (k, d)
            assert_equal(a.splice, b.splice, f"{k}[{d}].splice")
            assert len(a.send_idx) == len(b.send_idx), (k, d)
            for r, (x, y) in enumerate(zip(a.send_idx, b.send_idx)):
                assert_equal(x, y, f"{k}[{d}].send_idx[{r}]")


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("depth", [2, 4])
def test_layout_matches_reference_bit_for_bit(layouts, mesh_name, n_parts,
                                              depth):
    assert_layouts_equal(*layouts[(mesh_name, n_parts, depth)])


def test_layout_from_reference_arrays_is_the_port_layout(layouts):
    """convert.sharded_mesh_from_arrays carries the JAX layout into the
    port's ShardedMesh: equal to the one the port builds."""
    js, ts = layouts[("sphere", 4, 4)]
    carried = convert.sharded_mesh_from_arrays(flatten(js))
    assert_layouts_equal(js, carried)
    for k in ("owned_cell_mask", "cell_global"):
        assert type(getattr(carried, k)) is type(getattr(ts, k)), k


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_flat_mesh_is_block_diagonal(meshes, mesh_name, n_parts):
    """The loopback layout: flat connectivity stays inside each shard's
    block, and on owned rows it names the global mesh's neighbours (or a
    missing one, which the layout maps to the shard's slot 0)."""
    _, tm = meshes[mesh_name]
    sm = tlayout.build_sharded_mesh(tm, tpart.sfc_partition(tm, n_parts),
                                    halo_depth=2)
    flat = sm.flat()
    assert flat.nCells == n_parts * sm.mesh.nCells
    glob = {"cell": sm.cell_global.ravel(), "edge": sm.edge_global.ravel(),
            "vertex": sm.vertex_global.ravel()}
    owned = {"cell": sm.owned_cell_mask.ravel() > 0,
             "edge": sm.owned_edge_mask.ravel() > 0,
             "vertex": sm.owned_vertex_mask.ravel() > 0}
    rows_of = {"cellsOnEdge": "edge", "verticesOnEdge": "edge",
               "edgesOnCell": "cell", "cellsOnCell": "cell",
               "verticesOnCell": "cell", "cellsOnVertex": "vertex",
               "edgesOnVertex": "vertex", "edgesOnEdge": "edge"}
    for name, target in tlayout.CONN_TARGET.items():
        f = getattr(flat, name).numpy()
        n_t = sm.n_local(target)
        block = np.arange(f.shape[0]) // sm.n_local(rows_of[name])
        assert ((f // n_t) == block[:, None]).all(), name
        g = getattr(tm, name).numpy()
        rows = owned[rows_of[name]]
        got = glob[target][f[rows]]
        want = g[glob[rows_of[name]][rows]]
        hit = (got >= 0) & (f[rows] % n_t != 0)
        assert np.array_equal(got[hit], want[hit]), name
    if n_parts == 1:
        for fl in dataclasses.fields(flat):
            v = getattr(flat, fl.name)
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, getattr(sm.mesh, fl.name)[0]), fl.name


# --- exchanges -----------------------------------------------------------------

def corrupted_field(sm, kind, n_global, seed=7):
    """A seeded global field scattered to the shards, halos set to -99."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_global,) + TRAILING[kind])
    stacked = trunner.scatter_field(sm, g, kind)
    owned = getattr(sm, f"owned_{kind}_mask") > 0
    return np.where(owned.reshape(owned.shape + (1,) * len(TRAILING[kind])),
                    stacked, -99.0)


def jax_neighbor_exchange(nx, stacked, n_parts):
    spec = JP(jrunner.AXIS)

    def fn(x_st, nx_st):
        return jrunner.neighbor_halo_exchange(
            jrunner.shard_leaves(nx_st), jrunner.shard_leaves(x_st))[None]
    out = jax.jit(jax.shard_map(
        fn, mesh=jrunner.device_mesh(n_parts),
        in_specs=(spec, jax.tree.map(lambda _: spec, nx)),
        out_specs=spec))(jnp.asarray(stacked), jax.tree.map(jnp.asarray, nx))
    return np.asarray(out)


def simulate_rounds(nx, stacked):
    """The schedule round by round on stacked (P, n, ...) tensors, as the
    process-group transport runs it: every round a zero buffer per shard,
    filled where the shard is a destination, then the splice gather."""
    x = torch.from_numpy(stacked)
    P = x.shape[0]
    parts = [x]
    for r, perm in enumerate(nx.perms):
        recv = torch.zeros((P, nx.sizes[r]) + x.shape[2:], dtype=x.dtype)
        for q, p in perm:
            recv[p] = x[q][torch.from_numpy(nx.send_idx[r][q].astype(
                np.int64))]
        parts.append(recv)
    comb = torch.cat(parts, dim=1)
    return torch.stack([comb[p][torch.from_numpy(
        nx.splice[p].astype(np.int64))] for p in range(P)]).numpy()


def n_global(mesh, kind):
    return {"cell": mesh.nCells, "edge": mesh.nEdges,
            "vertex": mesh.nVertices}[kind]


@pytest.fixture(scope="module")
def exchange_cases(meshes, layouts):
    """{(mesh, kind, depth): (port layout, corrupted field, JAX result)}
    at P = 4, halo depth 4; depth 4 is the full refresh."""
    out = {}
    for name in MESHES:
        js, ts = layouts[(name, 4, 4)]
        for kind in KINDS:
            stacked = corrupted_field(ts, kind, n_global(meshes[name][0],
                                                         kind))
            for depth in (1, 2, 4):
                nx = getattr(js, f"{kind}_nx")[depth]
                out[(name, kind, depth)] = (
                    ts, stacked, jax_neighbor_exchange(nx, stacked, 4))
    return out


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_loopback_exchange_matches_jax_bit_for_bit(exchange_cases, mesh_name,
                                                   kind, depth):
    ts, stacked, ref = exchange_cases[(mesh_name, kind, depth)]
    group = trunner.device_mesh(4, "cpu")
    xch = trunner.ShardExchange(ts, group)
    got = group.stack(getattr(xch, kind)(group.local(stacked), depth))
    assert np.array_equal(got, ref)
    # the exchange did work: the halos are refreshed
    assert (ref != -99.0).sum() > (stacked != -99.0).sum()


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_round_by_round_schedule_matches_jax_bit_for_bit(
        exchange_cases, mesh_name, kind, depth):
    ts, stacked, ref = exchange_cases[(mesh_name, kind, depth)]
    nx = getattr(ts, f"{kind}_nx")[depth]
    assert np.array_equal(simulate_rounds(nx, stacked), ref)


def test_process_group_exchange_matches_jax_bit_for_bit(exchange_cases,
                                                        tmp_path):
    """The gloo transport in 4 spawned ranks, every case of the sphere."""
    keys = [k for k in exchange_cases if k[0] == "sphere"]
    ts = exchange_cases[keys[0]][0]
    fields = [(kind, depth, exchange_cases[(m, kind, depth)][1])
              for m, kind, depth in keys]
    res = trunner.spawn_ranks(trunner.exchanges_on_rank, 4,
                              tmp_path / "store", args=(ts, fields),
                              devices=["cpu"] * 4)
    for i, key in enumerate(keys):
        got = np.stack([r[i] for r in res])
        assert np.array_equal(got, exchange_cases[key][2]), key


def test_depth_selection_follows_the_reference_rule():
    """ShardExchange._pick: depth None is the full halo, a depth above it
    is clipped, one between two schedules takes the deeper one."""
    pick = trunner.ShardExchange._pick
    table = {1: "d1", 2: "d2", 4: "d4"}
    depths = (None, 1, 2, 3, 4, 9)
    assert [pick(table, d, 4) for d in depths] == \
        ["d4", "d1", "d2", "d4", "d4", "d4"]
    assert [pick(table, d, 4) for d in depths] == \
        [jrunner.ShardExchange._pick(table, d, 4) for d in depths]


def test_halo_exchange_unit(meshes):
    """The all-to-all exchange alone reproduces owner values in halos
    (halo-exch test core parity; ref: mpas_test_core_halo_exch.F)."""
    _, tm = meshes["sphere"]
    sm = tlayout.build_sharded_mesh(tm, tpart.sfc_partition(tm, 4),
                                    halo_depth=2)
    group = trunner.device_mesh(4, "cpu")
    glob = np.arange(tm.nCells, dtype=np.float64)
    stacked = trunner.scatter_field(sm, glob, "cell")
    corrupted = np.where(sm.owned_cell_mask > 0, stacked, -1.0)
    out = group.stack(trunner.halo_exchange(sm.cell_xch,
                                            group.local(corrupted), group))
    slots = sm.cell_global
    valid = slots >= 0
    assert np.array_equal(out[valid], glob[slots[valid]])


def test_neighbor_exchange_matches_all_to_all(meshes):
    """Both exchange forms give identical owned + halo values for a
    full-depth refresh of a global field."""
    _, tm = meshes["sphere"]
    sm = tlayout.build_sharded_mesh(tm, tpart.sfc_partition(tm, 4),
                                    halo_depth=4)
    group = trunner.device_mesh(4, "cpu")
    rng = np.random.default_rng(7)
    stacked = trunner.scatter_field(sm, rng.standard_normal((tm.nCells, 3)),
                                    "cell")
    corrupted = group.local(np.where(sm.owned_cell_mask[..., None] > 0,
                                     stacked, -99.0))
    a2a = group.stack(trunner.halo_exchange(sm.cell_xch, corrupted, group))
    nx = group.stack(trunner.ShardExchange(sm, group).cell(corrupted))
    live = sm.cell_global >= 0
    assert np.array_equal(a2a[live], nx[live])


def test_owned_reductions_count_each_entity_once(meshes):
    """psum_owned / pmax_owned over the flat layout equal the global sum
    and max: halo rows, present on several shards, count once."""
    _, tm = meshes["sphere"]
    sm = tlayout.build_sharded_mesh(tm, tpart.sfc_partition(tm, 4),
                                    halo_depth=4)
    group = trunner.device_mesh(4, "cpu")
    g = np.random.default_rng(3).standard_normal((tm.nCells, 2))
    x = group.local(trunner.scatter_field(sm, g, "cell"))
    mask = group.local(sm.owned_cell_mask)
    assert abs(float(trunner.psum_owned(x, mask, group)) - g.sum()) \
        <= 1e-12 * np.abs(g).sum()
    assert float(trunner.pmax_owned(x, mask, group)) == g.max()
    assert float((x * mask[:, None]).sum()) != float(x.sum())


def test_no_cpu_fallback_without_cuda(monkeypatch):
    """A group left at device None means cuda:0 and raises without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.device_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trunner.spawn_ranks(trunner.exchanges_on_rank, 2, "unused")
    assert trunner.device_mesh(2, "cpu").device == torch.device("cpu")


def test_hierarchical_group_is_host_major():
    """device_mesh_hierarchical: n_hosts x chips_per_host shards, loopback
    where no rank is given; a rank needs the process group."""
    group = trunner.device_mesh_hierarchical(2, 2, "cpu")
    assert (group.n_parts, group.loopback) == (4, True)
    with pytest.raises(RuntimeError, match="initialised process group"):
        trunner.device_mesh_hierarchical(2, 2, "cpu", rank=3)


def test_process_group_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        trunner.ShardGroup(2, "cpu", rank=0)
