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


def build_sharded_mesh(mesh: Mesh, part, halo_depth: int = 3) -> ShardedMesh:
    """Partition a global Mesh into P padded local meshes + exchanges."""
    part = np.asarray(part)
    P = int(part.max()) + 1
    nC, nE, nV = mesh.nCells, mesh.nEdges, mesh.nVertices
    coe = _np(mesh.cellsOnEdge)
    voe = _np(mesh.verticesOnEdge)
    eoc = _np(mesh.edgesOnCell)
    eocm = _np(mesh.edgesOnCellMask) > 0

    # entity owners: edge/vertex owned by the part of its first cell
    edge_owner = part[coe[:, 0]]
    cov = _np(mesh.cellsOnVertex)
    covm = _np(mesh.cellsOnVertexMask) > 0
    first_cell = np.where(covm[:, 0], cov[:, 0], 0)
    vertex_owner = part[first_cell]

    # --- local entity sets per part, and each entity's halo layer --------
    cell_locs, edge_locs, vert_locs = [], [], []
    cell_layers, edge_layers, vert_layers = [], [], []   # dense, -1 absent
    owned_counts = {"cell": [], "edge": [], "vertex": []}
    for p in range(P):
        layers = _halo_layers(mesh, part, p, halo_depth)
        owned_cells = layers[0]
        halo_cells = np.concatenate(layers[1:]) if halo_depth else \
            np.array([], dtype=np.int64)
        clay = np.full(nC, -1, dtype=np.int64)
        for li, lay in enumerate(layers):
            clay[lay] = li
        cell_layers.append(clay)
        # canonical halo order: by (owner part, global id)
        halo_cells = halo_cells[np.lexsort((halo_cells,
                                            part[halo_cells]))]
        cells = np.concatenate([owned_cells, halo_cells])
        cell_locs.append(cells)
        owned_counts["cell"].append(len(owned_cells))

        # edges/vertices adjacent to any local cell
        es = np.unique(eoc[cells][eocm[cells]])
        # edge halo layer = min layer of its locally-present cells (ref:
        # block creator builds nHalos+1 edge halo layers keyed off the
        # cell layers, mpas_block_creator.F:734)
        elay = np.full(nE, -1, dtype=np.int64)
        elay[es] = _min_layer(coe[es], coe[es] >= 0, clay, halo_depth)
        edge_layers.append(elay)
        own_e = es[edge_owner[es] == p]
        halo_e = es[edge_owner[es] != p]
        halo_e = halo_e[np.lexsort((halo_e, edge_owner[halo_e]))]
        edge_locs.append(np.concatenate([own_e, halo_e]))
        owned_counts["edge"].append(len(own_e))

        vs = np.unique(voe[edge_locs[p]])
        # vertex halo layer = min layer of its locally-present cells (the
        # edge-layer rule applied to the vertex's cell fan)
        vlay = np.full(nV, -1, dtype=np.int64)
        vlay[vs] = _min_layer(cov[vs], covm[vs], clay, halo_depth)
        vert_layers.append(vlay)
        own_v = vs[vertex_owner[vs] == p]
        halo_v = vs[vertex_owner[vs] != p]
        halo_v = halo_v[np.lexsort((halo_v, vertex_owner[halo_v]))]
        vert_locs.append(np.concatenate([own_v, halo_v]))
        owned_counts["vertex"].append(len(own_v))

    # --- padded sizes (uniform across shards; +1 dead slot in owned) ------
    OWN_C = max(owned_counts["cell"]) + 1
    OWN_E = max(owned_counts["edge"]) + 1
    OWN_V = max(owned_counts["vertex"]) + 1
    HALO_C = max(len(c) - o for c, o in zip(cell_locs, owned_counts["cell"]))
    HALO_E = max(len(e) - o for e, o in zip(edge_locs, owned_counts["edge"]))
    HALO_V = max(len(v) - o for v, o in zip(vert_locs, owned_counts["vertex"]))
    NCL, NEL, NVL = OWN_C + HALO_C, OWN_E + HALO_E, OWN_V + HALO_V

    # --- slotted local id lists + global->local maps ----------------------
    def slot(locs_p, owned_n, OWN, NL):
        """Return padded local list (global ids, -1 for dead slots)."""
        out = np.full(NL, -1, dtype=np.int64)
        out[:owned_n] = locs_p[:owned_n]
        out[OWN:OWN + (len(locs_p) - owned_n)] = locs_p[owned_n:]
        return out

    cell_slots = [slot(cell_locs[p], owned_counts["cell"][p], OWN_C, NCL)
                  for p in range(P)]
    edge_slots = [slot(edge_locs[p], owned_counts["edge"][p], OWN_E, NEL)
                  for p in range(P)]
    vert_slots = [slot(vert_locs[p], owned_counts["vertex"][p], OWN_V, NVL)
                  for p in range(P)]

    def g2l(slots_p, n_global):
        out = np.full(n_global, -1, dtype=np.int64)
        live = np.nonzero(slots_p >= 0)[0]
        out[slots_p[live]] = live
        return out

    cell_g2l = [g2l(s, nC) for s in cell_slots]
    edge_g2l = [g2l(s, nE) for s in edge_slots]
    vert_g2l = [g2l(s, nV) for s in vert_slots]

    # --- exchanges (slot-ordered locs) ------------------------------------
    def build_xch(slots, g2l_list, owners, OWN, NL):
        send_lists = [[[] for _ in range(P)] for _ in range(P)]
        dest_lists = [[[] for _ in range(P)] for _ in range(P)]
        for p in range(P):
            for q, dests in _messages(p, slots[p], owners, True):
                send_lists[q][p] = g2l_list[q][slots[p][dests]]
                dest_lists[p][q] = dests
        S = max(1, max(len(send_lists[q][p]) for q in range(P)
                       for p in range(P)))
        send_idx = np.zeros((P, P, S), dtype=np.int32)
        perm = np.zeros((P, NL), dtype=np.int32)
        for p in range(P):
            perm[p, :] = np.minimum(np.arange(NL), OWN - 1)
            for q in range(P):
                sl = send_lists[p][q]
                send_idx[p, q, :len(sl)] = sl
                dl = dest_lists[p][q]
                perm[p, dl] = OWN + q * S + np.arange(len(dl))
        return HaloExchange(send_idx=send_idx, perm=perm, owned_pad=OWN,
                            msg_size=S)

    cell_xch = build_xch(cell_slots, cell_g2l, part, OWN_C, NCL)
    edge_xch = build_xch(edge_slots, edge_g2l, edge_owner, OWN_E, NEL)

    # --- per-depth neighbor-schedule exchanges ----------------------------
    def slot_layers(slots, layers):
        return [np.where(s >= 0, lay[np.maximum(s, 0)], -1).astype(np.int32)
                for s, lay in zip(slots, layers)]

    cell_slot_layer = slot_layers(cell_slots, cell_layers)
    edge_slot_layer = slot_layers(edge_slots, edge_layers)
    vert_slot_layer = slot_layers(vert_slots, vert_layers)
    depths = sorted({1, min(2, halo_depth), halo_depth})
    cell_nx = {d: _build_neighbor_xch(P, cell_slots, cell_g2l, part,
                                      cell_slot_layer, d, NCL)
               for d in depths}
    edge_nx = {d: _build_neighbor_xch(P, edge_slots, edge_g2l, edge_owner,
                                      edge_slot_layer, d, NEL)
               for d in depths}
    vertex_nx = {d: _build_neighbor_xch(P, vert_slots, vert_g2l,
                                        vertex_owner, vert_slot_layer, d,
                                        NVL)
                 for d in depths}

    # --- local mesh arrays -------------------------------------------------
    dtype = _np(mesh.areaCell).dtype
    fields = {}

    def take1(global_arr, slots, fill=0.0):
        g = _np(global_arr)
        out = np.stack([np.where((s >= 0)[(...,) + (None,) * (g.ndim - 1)]
                                 if g.ndim > 1 else (s >= 0),
                                 g[np.maximum(s, 0)], fill)
                        for s in slots])
        return out

    for name in _CELL_FIELDS:
        fields[name] = take1(getattr(mesh, name), cell_slots)
    for name in _EDGE_FIELDS:
        fields[name] = take1(getattr(mesh, name), edge_slots)
    for name in _VERTEX_FIELDS:
        fields[name] = take1(getattr(mesh, name), vert_slots)
    # avoid 1/0 explosions on dead slots
    for name in ("invAreaCell", "invAreaTriangle", "invDvEdge", "invDcEdge"):
        fields[name] = np.nan_to_num(fields[name], posinf=0.0, neginf=0.0)

    def remap_conn(global_conn, row_slots, col_g2l):
        """Remap a (n_row_global, k) index array to local, flagging the
        entries whose target is not shard-local (their weights are
        zeroed)."""
        conn = _np(global_conn)
        out = np.zeros((P,) + (len(row_slots[0]),) + conn.shape[1:],
                       dtype=np.int32)
        miss = np.zeros(out.shape, dtype=bool)
        for p in range(P):
            rs = row_slots[p]
            sub = conn[np.maximum(rs, 0)]
            lf = np.where(sub >= 0, col_g2l[p][np.maximum(sub, 0)], -1)
            dead = (rs < 0)[:, None] | (lf < 0)
            out[p] = np.where(dead, 0, lf)
            miss[p] = dead
        return out, miss

    # connectivity + weight zeroing
    eoc_l, eoc_miss = remap_conn(mesh.edgesOnCell, cell_slots, edge_g2l)
    coc_l, coc_miss = remap_conn(mesh.cellsOnCell, cell_slots, cell_g2l)
    voc_l, voc_miss = remap_conn(mesh.verticesOnCell, cell_slots, vert_g2l)
    coe_l, coe_miss = remap_conn(mesh.cellsOnEdge, edge_slots, cell_g2l)
    voe_l, voe_miss = remap_conn(mesh.verticesOnEdge, edge_slots, vert_g2l)
    eoe_l, eoe_miss = remap_conn(mesh.edgesOnEdge, edge_slots, edge_g2l)
    cov_l, cov_miss = remap_conn(mesh.cellsOnVertex, vert_slots, cell_g2l)
    eov_l, eov_miss = remap_conn(mesh.edgesOnVertex, vert_slots, edge_g2l)

    def local_rows(arr2d, row_slots, miss):
        return np.where(miss, 0.0, take1(arr2d, row_slots))

    fields["edgesOnCell"] = eoc_l
    fields["cellsOnCell"] = coc_l
    fields["verticesOnCell"] = voc_l
    fields["cellsOnEdge"] = coe_l
    fields["verticesOnEdge"] = voe_l
    fields["edgesOnEdge"] = eoe_l
    fields["cellsOnVertex"] = cov_l
    fields["edgesOnVertex"] = eov_l
    fields["nEdgesOnCell"] = take1(mesh.nEdgesOnCell, cell_slots, 0)
    fields["nEdgesOnEdge"] = take1(mesh.nEdgesOnEdge, edge_slots, 0)

    fields["edgesOnCellMask"] = local_rows(mesh.edgesOnCellMask, cell_slots,
                                           eoc_miss)
    fields["divW"] = local_rows(mesh.divW, cell_slots, eoc_miss)
    fields["keW"] = local_rows(mesh.keW, cell_slots, eoc_miss)
    fields["curlW"] = local_rows(mesh.curlW, vert_slots, eov_miss)
    fields["edgeSignOnCell"] = local_rows(mesh.edgeSignOnCell, cell_slots,
                                          eoc_miss)
    fields["kiteAreasOnCell"] = local_rows(mesh.kiteAreasOnCell, cell_slots,
                                           voc_miss)
    fields["edgeSignOnVertex"] = local_rows(mesh.edgeSignOnVertex, vert_slots,
                                            eov_miss)
    fields["cellsOnVertexMask"] = local_rows(mesh.cellsOnVertexMask,
                                             vert_slots, cov_miss)
    fields["kiteAreasOnVertex"] = local_rows(mesh.kiteAreasOnVertex,
                                             vert_slots, cov_miss)
    fields["weightsOnEdge"] = local_rows(mesh.weightsOnEdge, edge_slots,
                                         eoe_miss)
    # cell-assembled TRiSK: the per-cell matrix rides cell rows (its
    # indices are slot positions, unaffected by reindexing); zero rows and
    # columns of deep-halo cells with missing edges so that their
    # contraction contributes nothing
    triskM_l = take1(mesh.triskM, cell_slots)
    triskM_l = np.where(eoc_miss[..., :, None], 0.0, triskM_l)
    triskM_l = np.where(eoc_miss[..., None, :], 0.0, triskM_l)
    fields["triskM"] = triskM_l
    # slot positions are invariant under remapping (edge order within a
    # cell's edgesOnCell row is preserved)
    fields["edgeSlotOnCell"] = take1(mesh.edgeSlotOnCell, edge_slots)

    tensors = {}
    for k, v in fields.items():
        v = v.astype(np.int64 if k in _INT_FIELDS else dtype)
        tensors[k] = torch.from_numpy(v)

    local_mesh = Mesh(
        nCells=NCL, nEdges=NEL, nVertices=NVL,
        maxEdges=mesh.maxEdges, maxEdges2=mesh.maxEdges2,
        vertexDegree=mesh.vertexDegree, on_sphere=mesh.on_sphere,
        sphere_radius=mesh.sphere_radius, x_period=mesh.x_period,
        y_period=mesh.y_period, **tensors)

    def owned_mask(slots, owned_n):
        out = np.zeros((P, len(slots[0])), dtype=dtype)
        for p in range(P):
            out[p, :owned_n[p]] = 1.0
        return out

    return ShardedMesh(
        mesh=local_mesh, cell_xch=cell_xch, edge_xch=edge_xch,
        cell_nx=cell_nx, edge_nx=edge_nx, vertex_nx=vertex_nx,
        owned_cell_mask=owned_mask(cell_slots, owned_counts["cell"]),
        owned_edge_mask=owned_mask(edge_slots, owned_counts["edge"]),
        owned_vertex_mask=owned_mask(vert_slots, owned_counts["vertex"]),
        cell_global=np.stack(cell_slots).astype(np.int32),
        edge_global=np.stack(edge_slots).astype(np.int32),
        vertex_global=np.stack(vert_slots).astype(np.int32),
        n_parts=P, halo_depth=halo_depth)
