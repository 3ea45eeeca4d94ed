"""Space-filling-curve renumbering of a Mesh, ordering normalization (port
of mpas_tpu/mesh/reorder.py).

Every stencil op reads rows like ``psi[cellsOnCell]`` or ``u[edgesOnCell]``
whose memory addresses are as scattered as the mesh numbering.
Renumbering all three entity sets along one Morton curve bounds the index
span between stencil neighbors regardless of how the mesh arrived — the
analogue of the contiguous per-block ownership the reference gets from its
decomposition (`mpas_block_decomp.F:101-120`). The capability matters for
*ingested* meshes (`mesh/gridfile.py`): a grid.nc produced by an
arbitrary tool chain can arrive in near-random order, where normalization
restores the bounded neighbor span.

Renumbering is slot-order preserving: each entity's per-row neighbor lists
keep their cyclic (ccw) order and their slot positions, only the stored
global indices are remapped. Every mesh operator in the tree is row-local
over those slots, so a reordered run matches the original per entity to
reduction-reassociation tolerance. PAD slots (index 0, zero weight) map to
the relabeled entity 0's new index, still valid, still zero-weighted.
The permutation is host numpy; the mesh keeps its device and dtypes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.containers import to_host
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.parallel.partition import _morton_key

# Mesh fields whose leading axis is the entity set (row permutation)...
_CELL_ROW = {
    "edgesOnCell", "nEdgesOnCell", "cellsOnCell", "verticesOnCell",
    "edgesOnCellMask", "edgeSignOnCell", "boundaryCell",
    "xCell", "yCell", "zCell", "latCell", "lonCell",
    "areaCell", "invAreaCell", "kiteAreasOnCell", "fCell",
    "meshDensity", "triskM", "divW", "keW",
}
_EDGE_ROW = {
    "cellsOnEdge", "verticesOnEdge", "edgesOnEdge", "nEdgesOnEdge",
    "boundaryEdge", "xEdge", "yEdge", "zEdge", "latEdge", "lonEdge",
    "dvEdge", "dcEdge", "invDvEdge", "invDcEdge", "angleEdge",
    "weightsOnEdge", "fEdge", "edgeSlotOnCell",
    "meshScalingDel2", "meshScalingDel4",
}
_VERTEX_ROW = {
    "cellsOnVertex", "edgesOnVertex", "edgeSignOnVertex",
    "cellsOnVertexMask", "boundaryVertex",
    "xVertex", "yVertex", "zVertex", "latVertex", "lonVertex",
    "areaTriangle", "invAreaTriangle", "kiteAreasOnVertex", "curlW",
    "fVertex",
}
# ...and fields whose *values* are indices into an entity set (value remap).
_CELL_VALUED = {"cellsOnEdge", "cellsOnCell", "cellsOnVertex"}
_EDGE_VALUED = {"edgesOnCell", "edgesOnEdge", "edgesOnVertex"}
_VERTEX_VALUED = {"verticesOnEdge", "verticesOnCell"}


def _entity_order(x, y, z, bits=21):
    """new-order list of old indices along the Morton curve."""
    pts = np.stack([to_host(x), to_host(y), to_host(z)], axis=1)
    return np.argsort(_morton_key(pts, bits), kind="stable")


def apply_permutations(mesh: Mesh, pc, pe, pv) -> Mesh:
    """Relabel mesh entities: old cell i becomes new cell ``pc[i]`` (and
    likewise edges/vertices). Slot orderings inside every per-row neighbor
    list are preserved; only stored global indices are remapped."""
    pc, pe, pv = (np.asarray(p, dtype=np.int64) for p in (pc, pe, pv))
    order_c = np.argsort(pc, kind="stable")
    order_e = np.argsort(pe, kind="stable")
    order_v = np.argsort(pv, kind="stable")
    updates = {}
    classified = _CELL_ROW | _EDGE_ROW | _VERTEX_ROW
    for f in dataclasses.fields(mesh):
        name = f.name
        row = (order_c if name in _CELL_ROW else
               order_e if name in _EDGE_ROW else
               order_v if name in _VERTEX_ROW else None)
        v = getattr(mesh, name)
        if row is None:
            # coverage guard: any per-entity array field MUST be in one of
            # the row sets or it would silently keep the old ordering —
            # fail loudly on unclassified fields instead
            if isinstance(v, torch.Tensor) and v.dim() > 0 \
                    and v.shape[0] in (mesh.nCells, mesh.nEdges,
                                       mesh.nVertices) \
                    and name not in classified:
                raise AssertionError(
                    f"Mesh field {name!r} has a per-entity leading "
                    "axis but is not classified in reorder.py's "
                    "_CELL_ROW/_EDGE_ROW/_VERTEX_ROW sets")
            continue
        if v is None:
            continue
        a = to_host(v)[row]
        if name in _CELL_VALUED:
            a = pc[a]
        elif name in _EDGE_VALUED:
            a = pe[a]
        elif name in _VERTEX_VALUED:
            a = pv[a]
        updates[name] = torch.as_tensor(a, dtype=v.dtype, device=v.device)
    return dataclasses.replace(mesh, **updates)


def sfc_reorder_mesh(mesh: Mesh, bits: int = 21):
    """Returns (reordered Mesh, perms) with ``perms = {"cell": pc, "edge":
    pe, "vertex": pv}`` mapping old index -> new index along the Morton
    curve. Fields built on the old mesh move to the new numbering as
    ``new = old[np.argsort(pc)]`` (cell-rowed; likewise edge/vertex)."""
    order_c = _entity_order(mesh.xCell, mesh.yCell, mesh.zCell, bits)
    order_e = _entity_order(mesh.xEdge, mesh.yEdge, mesh.zEdge, bits)
    order_v = _entity_order(mesh.xVertex, mesh.yVertex, mesh.zVertex, bits)
    pc = np.empty(mesh.nCells, dtype=np.int64)
    pe = np.empty(mesh.nEdges, dtype=np.int64)
    pv = np.empty(mesh.nVertices, dtype=np.int64)
    pc[order_c] = np.arange(mesh.nCells)
    pe[order_e] = np.arange(mesh.nEdges)
    pv[order_v] = np.arange(mesh.nVertices)
    perms = {"cell": pc, "edge": pe, "vertex": pv}
    return apply_permutations(mesh, pc, pe, pv), perms
