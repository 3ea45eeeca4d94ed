"""Patches of a spherical mesh: where the whole globe's float64 reference
fits on no card, the check runs it on a few caps of the mesh.

A patch is the cells within `compared` layers of a centre cell (the
compared cells: layer 0 is the centre, layer k the cells k steps away
along cellsOnCell), the `halo` layers beyond them, every edge of those
cells and every vertex of those edges, each kind in order of the least
layer of its cells, then of global id, and then one ghost row of each
kind. A table entry that names a cell, edge or vertex outside the patch
names the ghost of its kind; a padded slot names row 0 (a centre's), as
padded slots do in the whole mesh. Every other row is a copy of the
whole mesh's row, so a computation on the patch equals the globe's
wherever its domain of dependence stays inside the patch.

The ghost rows start as copies of row 0 of their kind, connectivity too,
so that an init on the patch stays finite; `poison` then fills them, and
every row a computation of `reach` layers of cells leaves wrong at the
patch's edge (bad_rows), with NaN. What depends on the outside then
reads NaN, so a halo too thin for the steps that follow shows as NaN in
a compared cell, never as a plausible number. Several centres make one
patch (the layers count from the nearest centre).

numpy and torch on the host; nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# entity kind each connectivity table indexes, and which of its slots
# are real: "cell" rows count nEdgesOnCell, "edge" rows nEdgesOnEdge,
# "vertex" rows cellsOnVertexMask; None: every slot
_CONN = {"cellsOnEdge": ("cell", None), "verticesOnEdge": ("vertex", None),
         "edgesOnCell": ("edge", "cell"), "cellsOnCell": ("cell", "cell"),
         "verticesOnCell": ("vertex", "cell"),
         "cellsOnVertex": ("cell", "vertex"),
         "edgesOnVertex": ("edge", "vertex"),
         "edgesOnEdge": ("edge", "edge")}


@dataclasses.dataclass(frozen=True)
class Patch:
    mesh: object          # the patch's Mesh (reference class), ghosts last
    cells: np.ndarray     # global ids of the patch's cells (no ghost)
    edges: np.ndarray
    vertices: np.ndarray
    cell_layer: np.ndarray   # layer of each patch cell
    compared: int         # cells of layer <= compared are compared
    halo: int

    @property
    def compared_cells(self) -> np.ndarray:
        """Patch rows of the compared cells."""
        return np.nonzero(self.cell_layer <= self.compared)[0]

    @property
    def compared_edges(self) -> np.ndarray:
        """Patch rows of the edges between two compared cells."""
        coe = self.mesh.cellsOnEdge.numpy()[:len(self.edges)]
        inner = np.zeros(self.mesh.nCells, dtype=bool)
        inner[self.compared_cells] = True
        return np.nonzero(inner[coe[:, 0]] & inner[coe[:, 1]])[0]

    def rows(self, kind: str) -> np.ndarray:
        """Global ids of the patch's entities of `kind`, patch order."""
        return {"cell": self.cells, "edge": self.edges,
                "vertex": self.vertices}[kind]


def cell_layers(mesh, centres, depth: int) -> list[np.ndarray]:
    """Global cell ids by layer, layer 0 the centres, up to `depth`."""
    coc = mesh.cellsOnCell.numpy()
    real = np.arange(coc.shape[1])[None, :] \
        < mesh.nEdgesOnCell.numpy()[:, None]
    seen = np.zeros(mesh.nCells, dtype=bool)
    layer = np.unique(np.asarray(centres, dtype=np.int64))
    seen[layer] = True
    layers = [layer]
    for _ in range(depth):
        nxt = np.unique(coc[layer][real[layer]])
        layer = nxt[~seen[nxt]]
        seen[layer] = True
        layers.append(layer)
    return layers


def _real_slots(mesh, name, rows):
    """(rows, k) flags: slot j of each row is a real one."""
    conn = getattr(mesh, name).numpy()
    how = _CONN[name][1]
    k = conn.shape[1]
    if how is None:
        return np.ones((len(rows), k), dtype=bool)
    if how == "vertex":
        return mesh.cellsOnVertexMask.numpy()[rows] > 0
    count = {"cell": mesh.nEdgesOnCell,
             "edge": mesh.nEdgesOnEdge}[how].numpy()[rows]
    return np.arange(k)[None, :] < count[:, None]


def patch_entities(mesh, centres, compared: int, halo: int):
    """(cells, their layers, edges, vertices): the global ids of the
    patch's entities in patch order (module docstring), the ghosts left
    out. Reads the connectivity alone."""
    layers = cell_layers(mesh, centres, compared + halo)
    cells = np.concatenate(layers)
    layer_of = np.concatenate([np.full(len(x), i) for i, x in
                               enumerate(layers)])
    eoc = mesh.edgesOnCell.numpy()
    real = _real_slots(mesh, "edgesOnCell", cells)
    edges = np.unique(eoc[cells][real])
    vertices = np.unique(mesh.verticesOnEdge.numpy()[edges])
    # edges and vertices by the least layer of their cells: row 0 of each
    # kind, which padded slots name, lies at a centre
    cell_layer = np.full(mesh.nCells + 1, len(layers), dtype=np.int64)
    cell_layer[cells] = layer_of
    coe = mesh.cellsOnEdge.numpy()
    cov = np.where(mesh.cellsOnVertexMask.numpy() > 0,
                   mesh.cellsOnVertex.numpy(), mesh.nCells)
    edges = edges[np.lexsort((edges, cell_layer[coe[edges]].min(1)))]
    vertices = vertices[np.lexsort((vertices,
                                    cell_layer[cov[vertices]].min(1)))]
    return cells, layer_of, edges, vertices


def seeded_centres(mesh, part, seed: int, compared: int,
                   band) -> list[int]:
    """Centres, drawn from `seed`, of patches whose compared cells hold
    cells of every part of `part` (a partition of the cells) and cross
    its boundaries: one cell on a boundary with every part within
    `compared` layers, where there is one; else a cell where three or
    more parts meet (the cell and its neighbours), or else a cell on a
    boundary, and then, while a part has no compared cell, a cell of
    that part on its boundary; then, while a part has no compared cell
    within `band`, (lo, hi) |latitude| in radians, a cell of that part
    on its boundary within the band, one that reaches another such part
    where there is one."""
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    coc = mesh.cellsOnCell.numpy()
    real = np.arange(coc.shape[1])[None, :] \
        < mesh.nEdgesOnCell.numpy()[:, None]
    around = np.where(real, part[coc], part[:, None])
    ring = np.concatenate([part[:, None], around], axis=1)
    ring.sort(axis=1)
    meet = 1 + (np.diff(ring, axis=1) != 0).sum(axis=1)
    seen = np.left_shift(1, part.astype(np.int64))     # parts in reach
    for _ in range(compared):
        seen = seen | np.bitwise_or.reduce(np.where(real, seen[coc], 0),
                                           axis=1)
    every = np.bitwise_or.reduce(seen)
    first = np.nonzero((seen == every) & (meet >= 2))[0]
    if len(first) == 0:
        first = np.nonzero(meet >= 3)[0]
    if len(first) == 0:
        first = np.nonzero(meet >= 2)[0]
    centres = [int(rng.choice(first))]
    lat = np.abs(mesh.latCell.numpy())
    for inside in (np.ones(mesh.nCells, dtype=bool),
                   (lat >= band[0]) & (lat <= band[1])):
        while True:
            cells = np.concatenate(cell_layers(mesh, centres, compared))
            cells = cells[inside[cells]]
            missing = np.setdiff1d(np.unique(part), part[cells])
            if len(missing) == 0:
                break
            edge = (part == missing[0]) & (meet >= 2) & inside
            if not edge.any():
                raise ValueError(f"part {missing[0]} has no boundary cell "
                                 "in the band")
            others = np.bitwise_or.reduce(np.left_shift(1, missing[1:]))
            both = edge & ((seen & others) != 0)
            centres.append(int(rng.choice(np.nonzero(
                both if both.any() else edge)[0])))
    return centres


def build_patch(mesh, centres, compared: int, halo: int) -> Patch:
    """The patch of `mesh` (the reference's Mesh, CPU tensors) around
    `centres`: the cells within `compared` + `halo` layers (module
    docstring)."""
    cells, layer_of, edges, vertices = patch_entities(mesh, centres,
                                                      compared, halo)
    ids = {"cell": cells, "edge": edges, "vertex": vertices}
    n = {"cell": mesh.nCells, "edge": mesh.nEdges,
         "vertex": mesh.nVertices}
    local = {}
    for kind, g in ids.items():
        m = np.full(n[kind], len(g), dtype=np.int64)    # outside: ghost
        m[g] = np.arange(len(g))
        local[kind] = m
    count = {"nCells": "cell", "nEdges": "edge", "nVertices": "vertex"}
    kinds = _field_kinds(mesh)
    changes = {k: len(ids[v]) + 1 for k, v in count.items()}
    for f in dataclasses.fields(mesh):
        v = getattr(mesh, f.name)
        if not isinstance(v, torch.Tensor):
            continue
        rows = ids[kinds[f.name]]
        x = v.numpy()[rows]
        if f.name in _CONN:
            target = _CONN[f.name][0]
            real = _real_slots(mesh, f.name, rows)
            x = np.where(real, local[target][x], 0)
        x = np.concatenate([x, x[:1]])             # the ghost: row 0
        changes[f.name] = torch.from_numpy(np.ascontiguousarray(x))
    return Patch(mesh=dataclasses.replace(mesh, **changes), cells=cells,
                 edges=edges, vertices=vertices, cell_layer=layer_of,
                 compared=compared, halo=halo)


def _field_kinds(mesh) -> dict:
    """{tensor field: the entity kind its rows are}, by the row count."""
    by_len = {mesh.nCells: "cell", mesh.nEdges: "edge",
              mesh.nVertices: "vertex"}
    if len(by_len) != 3:
        raise ValueError("the mesh's entity counts must differ")
    return {f.name: by_len[getattr(mesh, f.name).shape[0]]
            for f in dataclasses.fields(mesh)
            if isinstance(getattr(mesh, f.name), torch.Tensor)}


def bad_rows(patch: Patch, reach: int) -> dict:
    """{kind: patch rows (ghost included) that a computation of `reach`
    layers of cells leaves wrong}: the cells of the outermost `reach`
    layers, the edges and vertices that touch the ghost cell."""
    m = patch.mesh
    n_c = len(patch.cells)
    cells = np.concatenate([np.nonzero(patch.cell_layer > patch.compared
                                       + patch.halo - reach)[0], [n_c]])
    coe = m.cellsOnEdge.numpy()
    cov = m.cellsOnVertex.numpy()
    edges = np.nonzero((coe == n_c).any(axis=1))[0]
    vertices = np.nonzero((cov == n_c).any(axis=1))[0]
    return {"cell": cells,
            "edge": np.union1d(edges, [len(patch.edges)]),
            "vertex": np.union1d(vertices, [len(patch.vertices)])}


def poison(obj, kinds: dict, rows: dict, axes: dict | None = None):
    """A copy of dataclass `obj` with the rows `rows[kind]` of every
    floating tensor field NaN; kinds: {field: entity kind}, fields not
    named are kept; axes: {field: the axis of its rows} where not 0.
    Nested dataclasses are poisoned with the same tables."""
    axes = axes or {}
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            changes[f.name] = poison(v, kinds, rows, axes)
        elif isinstance(v, torch.Tensor) and v.is_floating_point() \
                and f.name in kinds:
            idx = torch.as_tensor(rows[kinds[f.name]], device=v.device)
            v = v.clone()
            v.index_fill_(axes.get(f.name, 0), idx, float("nan"))
            changes[f.name] = v
    return dataclasses.replace(obj, **changes)
