"""Shard layout construction: global mesh + partition -> per-shard local
meshes with halos and static exchange schedules (port of
mpas_tpu/parallel/layout.py; every output equal to its one bit for bit).

Equivalent of the reference block creator + multihalo exchange list
machinery (ref: src/framework/mpas_block_creator.F:52-1376 builds
nHalos-deep cell halos, edge/vertex halos, send/recv/copy lists and
reindexes global->local connectivity; src/framework/mpas_dmpar.F:2065
turns exchange lists into per-neighbor buffers):

- Every shard gets identically *padded* local arrays: the layout per
  entity kind is [owned .. pad][halo .. pad], with one guaranteed dead
  slot at the end of the owned region.
- A halo exchange is a gather of the slots to send, the transport, and a
  gather that splices the received values into the halo slots
  (runner.ShardExchange), so no scatter and no dynamic shape.
- Connectivity referencing entities outside a shard's local set is
  remapped to slot 0 with zeroed weights/signs: values computed at such
  outermost halo entities are garbage, as the reference's halo values are
  between exchanges; owned entities are exact provided halo_depth covers
  the stencil radius.

shard_layout gives the integer part alone (slots, owned masks,
schedules: ShardLayout), whose shard_mesh cuts one shard's local mesh,
so that a rank can set up its own shard without the others' arrays;
halo_mesh gives a shard's entities to any depth, unpadded.

All of this runs once on the host in numpy, like the reference bootstrap.
The per-entity maps are dense arrays over the global ids; the stacked
local mesh holds CPU tensors (index tables int64), the schedules numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.parallel.partition import _np

_CELL_FIELDS = ["xCell", "yCell", "zCell", "latCell", "lonCell", "areaCell",
                "invAreaCell", "meshDensity", "fCell", "boundaryCell"]
_EDGE_FIELDS = ["xEdge", "yEdge", "zEdge", "latEdge", "lonEdge", "dvEdge",
                "dcEdge", "invDvEdge", "invDcEdge", "angleEdge", "fEdge",
                "boundaryEdge", "meshScalingDel2", "meshScalingDel4"]
_VERTEX_FIELDS = ["xVertex", "yVertex", "zVertex", "latVertex", "lonVertex",
                  "areaTriangle", "invAreaTriangle", "fVertex",
                  "boundaryVertex"]
_INT_FIELDS = {"cellsOnEdge", "verticesOnEdge", "edgesOnCell",
               "nEdgesOnCell", "cellsOnCell", "verticesOnCell",
               "cellsOnVertex", "edgesOnVertex", "edgesOnEdge",
               "nEdgesOnEdge", "edgeSlotOnCell"}
# connectivity tables and the entity kind their values index; the flat
# loopback layout offsets each shard's values by p * n_local of that kind
# (nEdgesOnCell/nEdgesOnEdge are counts, edgeSlotOnCell slot positions)
CONN_TARGET = {"cellsOnEdge": "cell", "verticesOnEdge": "vertex",
               "edgesOnCell": "edge", "cellsOnCell": "cell",
               "verticesOnCell": "vertex", "cellsOnVertex": "cell",
               "edgesOnVertex": "edge", "edgesOnEdge": "edge"}
# the entity kind of each connectivity table's rows
_CONN_ROWS = {"cellsOnEdge": "edge", "verticesOnEdge": "edge",
              "edgesOnCell": "cell", "cellsOnCell": "cell",
              "verticesOnCell": "cell", "cellsOnVertex": "vertex",
              "edgesOnVertex": "vertex", "edgesOnEdge": "edge"}


# the local mesh's weight fields whose entries are zeroed where the entity
# they weigh is not shard-local: field -> the connectivity table whose
# missing entries zero it (triskM, the cell-assembled TRiSK matrix, both
# its rows and its columns by edgesOnCell's)
_ZEROED_BY = {"edgesOnCellMask": "edgesOnCell", "divW": "edgesOnCell",
              "keW": "edgesOnCell", "edgeSignOnCell": "edgesOnCell",
              "kiteAreasOnCell": "verticesOnCell",
              "curlW": "edgesOnVertex", "edgeSignOnVertex": "edgesOnVertex",
              "cellsOnVertexMask": "cellsOnVertex",
              "kiteAreasOnVertex": "cellsOnVertex",
              "weightsOnEdge": "edgesOnEdge"}
ZEROED_FIELDS = frozenset(_ZEROED_BY) | {"triskM"}


@dataclasses.dataclass(frozen=True)
class HaloExchange:
    """Static all-to-all exchange schedule for one entity kind."""
    send_idx: Any    # (P, P, S) local indices to send: [me, dest, slot]
    perm: Any        # (P, n_local) gather permutation over
    #                  concat(local[:owned_pad], recv_flat)
    owned_pad: int   # owned-region size
    msg_size: int    # S


@dataclasses.dataclass(frozen=True)
class NeighborExchange:
    """Static neighbor-schedule exchange: R rounds, each moving one
    exact-size message between matched (src, dst) pairs (ref: the
    per-neighbor irecv/pack/isend halo exchange, mpas_dmpar.F:5263-5301,
    with the haloLayers depth restriction of the acoustic loop,
    mpas_atm_time_integration.F:792,845). Traffic goes only to mesh
    neighbours and only for the requested halo layers."""
    send_idx: Any    # tuple of R arrays (P, S_r): local slots to send
    splice: Any      # (P, n_local) gather over concat(field, recv_0..R-1)
    perms: Any       # R tuples of (src, dst)
    sizes: Any       # (S_0, ..., S_{R-1})
    volume: int      # total real slots moved


@dataclasses.dataclass(frozen=True)
class ShardedMesh:
    """Per-shard local meshes (stacked on a leading shard axis) +
    schedules."""
    mesh: Mesh                  # every tensor field has leading dim P
    cell_xch: HaloExchange
    edge_xch: HaloExchange
    owned_cell_mask: Any        # (P, nCellsLocal) 1.0 on owned, 0 elsewhere
    owned_edge_mask: Any
    owned_vertex_mask: Any
    cell_global: Any            # (P, nCellsLocal) int32 global ids (pad -1)
    edge_global: Any
    vertex_global: Any
    n_parts: int
    halo_depth: int
    # depth -> neighbor-schedule exchange (keys: 1, 2, halo_depth)
    cell_nx: Any = None
    edge_nx: Any = None
    vertex_nx: Any = None

    def n_local(self, kind: str) -> int:
        return {"cell": self.mesh.nCells, "edge": self.mesh.nEdges,
                "vertex": self.mesh.nVertices}[kind]

    def flat(self) -> Mesh:
        """The block-diagonal flat Mesh of all P shards (the loopback
        layout): every (P, n_local, ...) field becomes (P * n_local, ...)
        and shard p's connectivity is offset by p * n_local of its target
        kind; a missing neighbour (local slot 0) becomes p * n_local.
        CPU tensors, as the stacked mesh."""
        m, P = self.mesh, self.n_parts
        changes = {}
        for f in dataclasses.fields(m):
            v = getattr(m, f.name)
            if not isinstance(v, torch.Tensor):
                continue
            if f.name in CONN_TARGET:
                n = self.n_local(CONN_TARGET[f.name])
                off = (torch.arange(P, dtype=v.dtype) * n).reshape(
                    (P,) + (1,) * (v.dim() - 1))
                v = v + off
                if int(v.min()) < 0 or int(v.max()) >= P * n:
                    raise ValueError(f"{f.name}: flat index outside "
                                     f"[0, {P * n})")
            changes[f.name] = v.reshape((P * v.shape[1],) + v.shape[2:])
        return dataclasses.replace(m, nCells=P * m.nCells,
                                   nEdges=P * m.nEdges,
                                   nVertices=P * m.nVertices, **changes)

    def shard(self, p: int) -> Mesh:
        """Shard p's local Mesh (CPU tensors)."""
        return dataclasses.replace(self.mesh, **{
            f.name: getattr(self.mesh, f.name)[p]
            for f in dataclasses.fields(self.mesh)
            if isinstance(getattr(self.mesh, f.name), torch.Tensor)})

    def local(self, group, dtype) -> Mesh:
        """The mesh `group` holds (runner.ShardGroup), on its device."""
        m = self.flat() if group.loopback else self.shard(group.rank)
        return m.to(group.device, dtype)


def _halo_layers(mesh, part, p, depth):
    """Owned cells + halo layers for part p via cellsOnCell adjacency."""
    coc = _np(mesh.cellsOnCell)
    mask = _np(mesh.edgesOnCellMask) > 0
    owned = np.where(part == p)[0]
    local = np.zeros(len(part), dtype=bool)
    local[owned] = True
    layers = [owned]
    frontier = owned
    for _ in range(depth):
        cand = np.unique(coc[frontier][mask[frontier]])
        nxt = cand[~local[cand]].astype(np.int64)
        layers.append(nxt)
        local[nxt] = True
        frontier = nxt
    return layers


def _greedy_rounds(edges):
    """Decompose directed (src, dst) message edges into rounds: each round
    is a partial permutation (<=1 outgoing and <=1 incoming per shard).
    Greedy largest-message-first matching; R ~ max degree."""
    remaining = sorted(edges.items(), key=lambda kv: -len(kv[1][0]))
    rounds = []
    while remaining:
        used_src, used_dst, this, rest = set(), set(), [], []
        for (q, p), msg in remaining:
            if q not in used_src and p not in used_dst:
                used_src.add(q)
                used_dst.add(p)
                this.append(((q, p), msg))
            else:
                rest.append(((q, p), msg))
        rounds.append(this)
        remaining = rest
    return rounds


def _messages(p, slots_p, owners, keep):
    """The (q, live slots of p owned by q) groups of shard p's slots where
    `keep`, foreign owners only, q in order of first appearance and the
    slots in slot order."""
    li = np.nonzero((slots_p >= 0) & keep)[0]
    q = owners[slots_p[li]]
    foreign = q != p
    li, q = li[foreign], q[foreign]
    uq, first = np.unique(q, return_index=True)
    return [(int(qq), li[q == qq]) for qq in uq[np.argsort(first)]]


def _build_neighbor_xch(P, slots, g2l_list, owners, slot_layer, depth,
                        n_local):
    """Build a NeighborExchange refreshing halo slots with layer <= depth.
    g2l_list[q]: dense global -> local slot map of shard q (-1 absent)."""
    edges = {}
    for p in range(P):
        lay = slot_layer[p]
        for q, dests in _messages(p, slots[p], owners,
                                  (lay >= 0) & (lay <= depth)):
            sends = g2l_list[q][slots[p][dests]]
            if (sends < 0).any():
                raise ValueError(f"shard {q} lacks a slot it owns")
            edges[(q, p)] = (sends, dests)

    rounds = _greedy_rounds(edges)
    sizes = tuple(max(len(m[0]) for _, m in rnd) for rnd in rounds)
    send_idx = []
    splice = np.tile(np.arange(n_local, dtype=np.int32), (P, 1))
    offset = n_local
    volume = 0
    for r, rnd in enumerate(rounds):
        S = sizes[r]
        si = np.zeros((P, S), dtype=np.int32)
        for (q, p), (sends, dests) in rnd:
            si[q, :len(sends)] = sends
            splice[p, dests] = offset + np.arange(len(dests), dtype=np.int64)
            volume += len(sends)
        send_idx.append(si)
        offset += S
    perms = tuple(tuple(qp for qp, _ in rnd) for rnd in rounds)
    return NeighborExchange(send_idx=tuple(send_idx), splice=splice,
                            perms=perms, sizes=sizes, volume=volume)


def _min_layer(cells, valid, cell_layer, halo_depth):
    """Per row of `cells` (n, k): the least halo layer of its valid local
    cells, halo_depth where it has none."""
    lay = np.where(valid, cell_layer[np.maximum(cells, 0)], -1)
    big = np.iinfo(np.int64).max
    m = np.where(lay >= 0, lay, big).min(axis=1)
    return np.where(m == big, halo_depth, m)


def _shard_sets(mesh, part, p, depth, owners, conn):
    """Shard p's entities within `depth` halo layers: per kind (cell,
    edge, vertex) its global ids, owned first (in global order) and then
    the halo by (owner, global id), the owned count, and the dense map of
    every global entity to its halo layer (-1 absent)."""
    coe, voe, eoc, eocm, cov, covm = (conn[k] for k in (
        "cellsOnEdge", "verticesOnEdge", "edgesOnCell", "edgesOnCellMask",
        "cellsOnVertex", "cellsOnVertexMask"))
    layers = _halo_layers(mesh, part, p, depth)
    owned_cells = layers[0]
    halo_cells = np.concatenate(layers[1:]) if depth else \
        np.array([], dtype=np.int64)
    clay = np.full(len(part), -1, dtype=np.int64)
    for li, lay in enumerate(layers):
        clay[lay] = li
    # canonical halo order: by (owner part, global id)
    halo_cells = halo_cells[np.lexsort((halo_cells, part[halo_cells]))]
    cells = np.concatenate([owned_cells, halo_cells])

    # edges/vertices adjacent to any local cell
    es = np.unique(eoc[cells][eocm[cells]])
    # edge halo layer = min layer of its locally-present cells (ref:
    # block creator builds nHalos+1 edge halo layers keyed off the
    # cell layers, mpas_block_creator.F:734)
    elay = np.full(len(coe), -1, dtype=np.int64)
    elay[es] = _min_layer(coe[es], coe[es] >= 0, clay, depth)
    own_e = es[owners["edge"][es] == p]
    halo_e = es[owners["edge"][es] != p]
    halo_e = halo_e[np.lexsort((halo_e, owners["edge"][halo_e]))]
    edges = np.concatenate([own_e, halo_e])

    vs = np.unique(voe[edges])
    # vertex halo layer = min layer of its locally-present cells (the
    # edge-layer rule applied to the vertex's cell fan)
    vlay = np.full(len(cov), -1, dtype=np.int64)
    vlay[vs] = _min_layer(cov[vs], covm[vs], clay, depth)
    own_v = vs[owners["vertex"][vs] == p]
    halo_v = vs[owners["vertex"][vs] != p]
    halo_v = halo_v[np.lexsort((halo_v, owners["vertex"][halo_v]))]
    verts = np.concatenate([own_v, halo_v])
    return {"cell": (cells, len(owned_cells), clay),
            "edge": (edges, len(own_e), elay),
            "vertex": (verts, len(own_v), vlay)}


def _conn_and_owners(mesh, part):
    conn = {k: _np(getattr(mesh, k)) for k in (
        "cellsOnEdge", "verticesOnEdge", "edgesOnCell", "cellsOnVertex")}
    conn["edgesOnCellMask"] = _np(mesh.edgesOnCellMask) > 0
    conn["cellsOnVertexMask"] = _np(mesh.cellsOnVertexMask) > 0
    # entity owners: edge/vertex owned by the part of its first cell
    first_cell = np.where(conn["cellsOnVertexMask"][:, 0],
                          conn["cellsOnVertex"][:, 0], 0)
    owners = {"cell": part, "edge": part[conn["cellsOnEdge"][:, 0]],
              "vertex": part[first_cell]}
    return conn, owners


def _g2l(slots_p, n_global):
    out = np.full(n_global, -1, dtype=np.int64)
    live = np.nonzero(slots_p >= 0)[0]
    out[slots_p[live]] = live
    return out


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """The integer part of a ShardedMesh, every shard's: which global
    entity each local slot holds, the owned masks and the exchange
    schedules, without the local meshes' arrays (shard_mesh makes one
    shard's). What ShardExchange, scatter_field and gather_field read."""
    cell_xch: HaloExchange
    edge_xch: HaloExchange
    owned_cell_mask: Any
    owned_edge_mask: Any
    owned_vertex_mask: Any
    cell_global: Any
    edge_global: Any
    vertex_global: Any
    n_parts: int
    halo_depth: int
    cell_nx: Any
    edge_nx: Any
    vertex_nx: Any
    sizes: Any                  # {kind: local slots (padded)}

    def n_local(self, kind: str) -> int:
        return self.sizes[kind]

    def slots(self, kind: str, p: int) -> np.ndarray:
        """Shard p's global id of each local slot of `kind` (-1 dead)."""
        return np.asarray(getattr(self, f"{kind}_global")[p], dtype=np.int64)

    def shard_mesh(self, mesh: Mesh, p: int) -> Mesh:
        """Shard p's local Mesh (CPU tensors) cut from the global `mesh`:
        equal to build_sharded_mesh(mesh, ...).shard(p)."""
        return _local_mesh(mesh, {k: self.slots(k, p) for k in
                                  ("cell", "edge", "vertex")})


def _local_mesh(mesh: Mesh, slots) -> Mesh:
    """The local Mesh of one shard: slots {kind: global id of each local
    slot, -1 dead}; connectivity to entities outside it remapped to slot
    0 with zeroed weights/signs (module docstring)."""
    nC, nE, nV = mesh.nCells, mesh.nEdges, mesh.nVertices
    cell_s, edge_s, vert_s = slots["cell"], slots["edge"], slots["vertex"]
    g2l = {"cell": _g2l(cell_s, nC), "edge": _g2l(edge_s, nE),
           "vertex": _g2l(vert_s, nV)}
    dtype = _np(mesh.areaCell).dtype
    fields = {}

    def take1(global_arr, s, fill=0.0):
        g = _np(global_arr)
        live = s >= 0
        return np.where(live.reshape(live.shape + (1,) * (g.ndim - 1)),
                        g[np.maximum(s, 0)], fill)

    for name in _CELL_FIELDS:
        fields[name] = take1(getattr(mesh, name), cell_s)
    for name in _EDGE_FIELDS:
        fields[name] = take1(getattr(mesh, name), edge_s)
    for name in _VERTEX_FIELDS:
        fields[name] = take1(getattr(mesh, name), vert_s)
    # avoid 1/0 explosions on dead slots
    for name in ("invAreaCell", "invAreaTriangle", "invDvEdge", "invDcEdge"):
        fields[name] = np.nan_to_num(fields[name], posinf=0.0, neginf=0.0)

    def remap_conn(global_conn, rs, col_g2l):
        """Remap a (n_row_global, k) index array to local, flagging the
        entries whose target is not shard-local (their weights are
        zeroed)."""
        sub = _np(global_conn)[np.maximum(rs, 0)]
        lf = np.where(sub >= 0, col_g2l[np.maximum(sub, 0)], -1)
        dead = (rs < 0)[:, None] | (lf < 0)
        return np.where(dead, 0, lf).astype(np.int32), dead

    # connectivity + weight zeroing
    rows_of = {"cell": cell_s, "edge": edge_s, "vertex": vert_s}
    miss = {}
    for name, target in CONN_TARGET.items():
        rows = rows_of[_CONN_ROWS[name]]
        fields[name], miss[name] = remap_conn(getattr(mesh, name), rows,
                                              g2l[target])
    fields["nEdgesOnCell"] = take1(mesh.nEdgesOnCell, cell_s, 0)
    fields["nEdgesOnEdge"] = take1(mesh.nEdgesOnEdge, edge_s, 0)
    for name, conn in _ZEROED_BY.items():
        fields[name] = np.where(miss[conn], 0.0, take1(
            getattr(mesh, name), rows_of[_CONN_ROWS[conn]]))
    # cell-assembled TRiSK: the per-cell matrix rides cell rows (its
    # indices are slot positions, unaffected by reindexing); zero rows and
    # columns of deep-halo cells with missing edges so that their
    # contraction contributes nothing
    eoc_miss = miss["edgesOnCell"]
    triskM_l = take1(mesh.triskM, cell_s)
    triskM_l = np.where(eoc_miss[..., :, None], 0.0, triskM_l)
    triskM_l = np.where(eoc_miss[..., None, :], 0.0, triskM_l)
    fields["triskM"] = triskM_l
    # slot positions are invariant under remapping (edge order within a
    # cell's edgesOnCell row is preserved)
    fields["edgeSlotOnCell"] = take1(mesh.edgeSlotOnCell, edge_s)

    tensors = {k: torch.from_numpy(v.astype(np.int64 if k in _INT_FIELDS
                                            else dtype))
               for k, v in fields.items()}
    return Mesh(
        nCells=len(cell_s), nEdges=len(edge_s), nVertices=len(vert_s),
        maxEdges=mesh.maxEdges, maxEdges2=mesh.maxEdges2,
        vertexDegree=mesh.vertexDegree, on_sphere=mesh.on_sphere,
        sphere_radius=mesh.sphere_radius, x_period=mesh.x_period,
        y_period=mesh.y_period, **tensors)


def shard_layout(mesh: Mesh, part, halo_depth: int = 3) -> ShardLayout:
    """The ShardLayout of a partition of a global Mesh: integer arrays
    and the owned masks, no local mesh array."""
    part = np.asarray(part)
    P = int(part.max()) + 1
    n_global = {"cell": mesh.nCells, "edge": mesh.nEdges,
                "vertex": mesh.nVertices}
    conn, owners = _conn_and_owners(mesh, part)

    # --- local entity sets per part, and each entity's halo layer --------
    sets = [_shard_sets(mesh, part, p, halo_depth, owners, conn)
            for p in range(P)]

    # --- padded sizes (uniform across shards; +1 dead slot in owned) ------
    # and the slotted local id lists: [owned .. pad][halo .. pad]
    slots, own_pad, sizes = {}, {}, {}
    for kind in ("cell", "edge", "vertex"):
        locs = [s[kind][0] for s in sets]
        owned_n = [s[kind][1] for s in sets]
        OWN = max(owned_n) + 1
        NL = OWN + max(len(x) - o for x, o in zip(locs, owned_n))
        out = np.full((P, NL), -1, dtype=np.int64)
        for p in range(P):
            out[p, :owned_n[p]] = locs[p][:owned_n[p]]
            out[p, OWN:OWN + len(locs[p]) - owned_n[p]] = \
                locs[p][owned_n[p]:]
        slots[kind], own_pad[kind], sizes[kind] = list(out), OWN, NL
    g2l = {k: [_g2l(s, n_global[k]) for s in slots[k]] for k in slots}

    # --- exchanges (slot-ordered locs) ------------------------------------
    def build_xch(kind):
        sl, gl, own = slots[kind], g2l[kind], owners[kind]
        OWN, NL = own_pad[kind], sizes[kind]
        send_lists = [[[] for _ in range(P)] for _ in range(P)]
        dest_lists = [[[] for _ in range(P)] for _ in range(P)]
        for p in range(P):
            for q, dests in _messages(p, sl[p], own, True):
                send_lists[q][p] = gl[q][sl[p][dests]]
                dest_lists[p][q] = dests
        S = max(1, max(len(send_lists[q][p]) for q in range(P)
                       for p in range(P)))
        send_idx = np.zeros((P, P, S), dtype=np.int32)
        perm = np.zeros((P, NL), dtype=np.int32)
        for p in range(P):
            perm[p, :] = np.minimum(np.arange(NL), OWN - 1)
            for q in range(P):
                s = send_lists[p][q]
                send_idx[p, q, :len(s)] = s
                dl = dest_lists[p][q]
                perm[p, dl] = OWN + q * S + np.arange(len(dl))
        return HaloExchange(send_idx=send_idx, perm=perm, owned_pad=OWN,
                            msg_size=S)

    # --- per-depth neighbor-schedule exchanges ----------------------------
    depths = sorted({1, min(2, halo_depth), halo_depth})
    nx = {}
    for kind in ("cell", "edge", "vertex"):
        slot_layer = [np.where(s >= 0, st[kind][2][np.maximum(s, 0)], -1)
                      .astype(np.int32) for s, st in zip(slots[kind], sets)]
        nx[kind] = {d: _build_neighbor_xch(P, slots[kind], g2l[kind],
                                           owners[kind], slot_layer, d,
                                           sizes[kind])
                    for d in depths}

    dtype = _np(mesh.areaCell).dtype

    def owned_mask(kind):
        out = np.zeros((P, sizes[kind]), dtype=dtype)
        for p in range(P):
            out[p, :sets[p][kind][1]] = 1.0
        return out

    return ShardLayout(
        cell_xch=build_xch("cell"), edge_xch=build_xch("edge"),
        cell_nx=nx["cell"], edge_nx=nx["edge"], vertex_nx=nx["vertex"],
        owned_cell_mask=owned_mask("cell"),
        owned_edge_mask=owned_mask("edge"),
        owned_vertex_mask=owned_mask("vertex"),
        cell_global=np.stack(slots["cell"]).astype(np.int32),
        edge_global=np.stack(slots["edge"]).astype(np.int32),
        vertex_global=np.stack(slots["vertex"]).astype(np.int32),
        n_parts=P, halo_depth=halo_depth, sizes=sizes)


def build_sharded_mesh(mesh: Mesh, part, halo_depth: int = 3) -> ShardedMesh:
    """Partition a global Mesh into P padded local meshes + exchanges."""
    lay = shard_layout(mesh, part, halo_depth)
    return sharded_mesh(lay, [lay.shard_mesh(mesh, p)
                              for p in range(lay.n_parts)])


def sharded_mesh(lay: ShardLayout, shards) -> ShardedMesh:
    """The ShardedMesh of a layout and its P local meshes (in order)."""
    stacked = dataclasses.replace(shards[0], **{
        f.name: torch.stack([getattr(m, f.name) for m in shards])
        for f in dataclasses.fields(shards[0])
        if isinstance(getattr(shards[0], f.name), torch.Tensor)})
    return ShardedMesh(
        mesh=stacked, cell_xch=lay.cell_xch, edge_xch=lay.edge_xch,
        cell_nx=lay.cell_nx, edge_nx=lay.edge_nx, vertex_nx=lay.vertex_nx,
        owned_cell_mask=lay.owned_cell_mask,
        owned_edge_mask=lay.owned_edge_mask,
        owned_vertex_mask=lay.owned_vertex_mask,
        cell_global=lay.cell_global, edge_global=lay.edge_global,
        vertex_global=lay.vertex_global, n_parts=lay.n_parts,
        halo_depth=lay.halo_depth)


def halo_mesh(mesh: Mesh, part, p: int, depth: int):
    """(local Mesh, {kind: global ids}) of shard p's entities within
    `depth` halo layers, unpadded, owned first: a mesh on which a
    computation of shard p whose stencils reach r layers is exact on the
    entities of the first depth - r layers."""
    part = np.asarray(part)
    conn, owners = _conn_and_owners(mesh, part)
    sets = _shard_sets(mesh, part, p, depth, owners, conn)
    ids = {k: v[0] for k, v in sets.items()}
    return _local_mesh(mesh, ids), ids
