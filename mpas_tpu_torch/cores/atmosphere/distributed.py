"""Sharded atmosphere stepping (port of
mpas_tpu/cores/atmosphere/distributed.py).

The srk3 step exposes exchange hooks at exactly the reference's
halo-exchange points (ref: the ~15 mpas_dmpar_exch_halo_field calls per
dynamics substep, mpas_atm_time_integration.F:666-1288); here those hooks
become neighbor-schedule halo refreshes (parallel.runner.ShardExchange),
with the acoustic-loop exchanges restricted to halo layer 1 (ref:
mpas_atm_time_integration.F:792,845). Cell columns stay shard-local, so
every exchange moves whole columns, the decomposition the reference uses.

The sharded grid, state and carry are host-stacked (P, ...) CPU tensors;
`ShardedAtm.local` and runner.place turn them into what a ShardGroup
holds: all shards as one flat layout (loopback) or one rank's shard.
Where the globe's fields do not fit a host, shard_atm_local gives a rank
its own shard's grid, state and diagnostics from the mesh and the
partition alone, and start_carry its carry, equal on every row to the
cut of the global ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.setup import AtmGrid
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.cores.atmosphere.time_integration import (AtmCarry,
                                                              init_carry,
                                                              run_steps_xch)
from mpas_tpu_torch.mesh.mesh import Mesh
from mpas_tpu_torch.parallel.layout import (ZEROED_FIELDS, ShardedMesh,
                                            ShardLayout, build_sharded_mesh,
                                            halo_mesh, sharded_mesh)
from mpas_tpu_torch.parallel.partition import _np
from mpas_tpu_torch.parallel.runner import (ShardExchange, ShardGroup,
                                            place, pmax_owned, psum_owned,
                                            scatter_field)

ATM_HALO_DEPTH = 4
# slot-major (maxEdges, nCells, nz+1) grid fields: the cell axis is axis 1
_SLOT_MAJOR = ("zb_cell", "zb3_cell")


@dataclasses.dataclass(frozen=True)
class ShardedAtm:
    grid: AtmGrid          # stacked (P, ...) local grids; vert replicated
    smesh: ShardedMesh

    def local(self, group: ShardGroup, dtype) -> AtmGrid:
        """The grid `group` holds, on its device."""
        g = self.grid
        changes = {"mesh": self.smesh.local(group, dtype),
                   "vert": g.vert.to(group.device, dtype)}
        for f in dataclasses.fields(g):
            v = getattr(g, f.name)
            if f.name in changes or not isinstance(v, torch.Tensor):
                continue
            if f.name in _SLOT_MAJOR:       # (P, mE, n, K): entity-major
                changes[f.name] = group.local(v.transpose(1, 2), dtype) \
                    .transpose(0, 1).contiguous()
            else:
                changes[f.name] = group.local(v, dtype)
        return dataclasses.replace(g, **changes)


def _missing(slots, conn, g2l):
    """(rows, k) flags: the row slot is dead or conn's entry is not local."""
    sub = conn[np.maximum(slots, 0)]
    local = np.where(sub >= 0, g2l[np.maximum(sub, 0)], -1)
    return (slots < 0)[:, None] | (local < 0)


def _d2_masks(mesh, cell_slots, edge_slots):
    """One shard's d2 masks: (cells, maxEdges+1) for the cell stencil
    columns (the cell itself, then cellsOnCell) and (edges, 2) for the
    per-side edge weights, True where the cell is not shard-local."""
    g2l = np.full(mesh.nCells, -1, dtype=np.int64)
    live = np.nonzero(cell_slots >= 0)[0]
    g2l[cell_slots[live]] = live
    cell = np.concatenate([(cell_slots < 0)[:, None],
                           _missing(cell_slots, _np(mesh.cellsOnCell), g2l)],
                          axis=1)
    return cell, _missing(edge_slots, _np(mesh.cellsOnEdge), g2l)


def _cut_grid(grid: AtmGrid, take, d2_masks) -> dict:
    """{field: local array} of grid's fields but mesh and vert: take(x,
    kind) gives a field's local rows (dead slots 0); d2_masks () -> the
    (cell, edge) masks of _d2_masks, stacked or not as take's rows."""
    # the factored advection's second-derivative fits: zero the cell
    # stencil columns and the per-side edge weights whose cell is not
    # shard-local (the deep-halo rows would read a wrong neighbour)
    d2_bmat_l = d2w_l = None
    if grid.d2_bmat is not None:
        d2_cell_mask, d2w_mask = d2_masks()
        d2_bmat_l = np.where(d2_cell_mask[..., None, :], 0.0,
                             take(grid.d2_bmat, "cell"))
        d2w_l = np.where(d2w_mask[..., None], 0.0, take(grid.d2w, "edge"))

    n_eoc = take(grid.mesh.nEdgesOnCell, "cell")
    padded = np.arange(grid.mesh.maxEdges) >= n_eoc[..., None]

    def opt_cell(x):
        """zero in the padded slots, which hold edge 0's values"""
        if x is None:
            return None
        x = take(x, "cell")
        return np.where(padded.reshape(padded.shape + (1,) * (
            x.ndim - padded.ndim)), 0.0, x)

    def one(x):
        """dead slots: 1.0, so that the divisions by it stay finite"""
        x = take(x, "cell")
        return np.where(x == 0.0, 1.0, x)

    def slot_major(x):
        x = take(np.moveaxis(_np(x), 0, 1), "cell")
        return np.moveaxis(x, -3, -2)

    fields = dict(
        zgrid=take(grid.zgrid, "cell"), zz=one(grid.zz),
        zxu=take(grid.zxu, "edge"), dss=take(grid.dss, "cell"),
        zb_cell=slot_major(grid.zb_cell), zb3_cell=slot_major(grid.zb3_cell),
        defc_a=take(grid.defc_a, "cell"), defc_b=take(grid.defc_b, "cell"),
        recon_zonal=take(grid.recon_zonal, "cell"),
        recon_merid=take(grid.recon_merid, "cell"),
        rho_base=one(grid.rho_base), rtheta_base=one(grid.rtheta_base),
        exner_base=one(grid.exner_base),
        pressure_base=take(grid.pressure_base, "cell"),
        d2_bmat=d2_bmat_l, d2w=d2w_l,
        # edge-valued content on cell rows: row reorder only; dead and
        # missing slots are killed by the masked edgeSignOnCell of the
        # sharded mesh
        d2w_own=opt_cell(grid.d2w_own), d2w_opp=opt_cell(grid.d2w_opp),
        adv_sside=opt_cell(grid.adv_sside), dv_cell=opt_cell(grid.dv_cell))
    return {k: None if v is None
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in fields.items()}


def shard_atm_grid(grid: AtmGrid, part, halo_depth: int = ATM_HALO_DEPTH
                   ) -> ShardedAtm:
    """Per-shard local AtmGrids from a global one (host, once)."""
    smesh = build_sharded_mesh(grid.mesh, part, halo_depth=halo_depth)
    cell_slots = np.asarray(smesh.cell_global)
    edge_slots = np.asarray(smesh.edge_global)

    def take(x, kind):
        return scatter_field(smesh, _np(x), kind)

    def d2_masks():
        masks = [_d2_masks(grid.mesh, c, e)
                 for c, e in zip(cell_slots, edge_slots)]
        return tuple(np.stack(m) for m in zip(*masks))

    local = dataclasses.replace(grid, mesh=smesh.mesh,
                                **_cut_grid(grid, take, d2_masks))
    return ShardedAtm(grid=local, smesh=smesh)


# the mesh entity of every field of AtmState, AtmDiag and AtmCarry, and
# the value a dead cell keeps where there is one (exner 1, rho_zz 1 and
# theta_m 300, so that 0**x and 0/0 do not occur there): shard_atm_state,
# shard_atm_carry and carry_restart_fields all read this one table
_FIELDS = {
    # AtmState
    "u": ("edge", None), "w": ("cell", None), "theta_m": ("cell", 300.0),
    "rho_zz": ("cell", 1.0), "scalars": ("cell", None),
    # AtmDiag
    "ru": ("edge", None), "rw": ("cell", None), "rho_p": ("cell", None),
    "rtheta_p": ("cell", None), "exner": ("cell", 1.0),
    "pressure_p": ("cell", None), "ruAvg": ("edge", None),
    "wwAvg": ("cell", None),
    # the rest of AtmCarry
    "v": ("edge", None), "sdiag_ke": ("cell", None),
    "sdiag_div": ("cell", None), "sdiag_vort": ("vertex", None),
    "sdiag_pv_edge": ("edge", None), "sdiag_rho_edge": ("edge", None),
    "ur_cell": ("cell", None), "vr_cell": ("cell", None),
    "rt_diabatic_tend": ("cell", None), "rainnc": ("cell", None),
}


def _fill_dead(name, x):
    """x with its zeros (its dead slots) at the value _FIELDS gives."""
    dead = _FIELDS[name][1]
    return x if dead is None else np.where(x == 0.0, dead, x)


def _scatter(sm, name, x):
    """The stacked (P, ...) CPU tensor of one global field, by _FIELDS."""
    return torch.from_numpy(_fill_dead(name, scatter_field(
        sm, x, _FIELDS[name][0])))


def _scatter_all(sm, obj, skip=()):
    """{name: stacked field} of a dataclass's fields, by _FIELDS."""
    return {f.name: _scatter(sm, f.name, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in skip}


def shard_atm_state(satm: ShardedAtm, state: AtmState, diag: AtmDiag):
    """Stacked (P, ...) AtmState and AtmDiag of CPU tensors; dead cells
    keep exner 1, rho_zz 1 and theta_m 300 (_FIELDS)."""
    sm = satm.smesh
    return AtmState(**_scatter_all(sm, state)), AtmDiag(**_scatter_all(sm,
                                                                      diag))


def shard_atm_carry(satm: ShardedAtm, carry: AtmCarry) -> AtmCarry:
    """A global AtmCarry (CPU) -> the stacked (P, ...) carry, the state
    and diagnostics through shard_atm_state."""
    st, dg = shard_atm_state(satm, carry.state, carry.diag)
    return AtmCarry(state=st, diag=dg, **_scatter_all(
        satm.smesh, carry, skip=("state", "diag")))


def carry_restart_fields(carry_l: AtmCarry, group: ShardGroup):
    """({name: stacked (P, n, ...) numpy}, {name: kind}) of every field of
    a placed carry, named state.u, diag.ru, v, ...: what
    io.sharded.write_sharded writes."""
    fields, kinds = {}, {}
    for f in dataclasses.fields(carry_l):
        v = getattr(carry_l, f.name)
        items = ((f"{f.name}.{g.name}", g.name, getattr(v, g.name))
                 for g in dataclasses.fields(v)) \
            if dataclasses.is_dataclass(v) else ((f.name, f.name, v),)
        for path, name, x in items:
            fields[path] = group.stack(x)
            kinds[path] = _FIELDS[name][0]
    return fields, kinds


def carry_from_restart_fields(fields) -> AtmCarry:
    """The global AtmCarry (CPU tensors) of io.sharded.read_sharded's
    fields: the inverse of carry_restart_fields over gathered fields."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in fields.items()}

    def sub(cls, prefix):
        return cls(**{f.name: t[f"{prefix}.{f.name}"]
                      for f in dataclasses.fields(cls)})

    return AtmCarry(state=sub(AtmState, "state"), diag=sub(AtmDiag, "diag"),
                    **{f.name: t[f.name] for f in dataclasses.fields(AtmCarry)
                       if f.name not in ("state", "diag")})


# cell layers that init_jw's stencils reach beyond a cell: the omega
# metric of a cell reads the fits and heights of its edges' far cells'
# neighbours (setup.build_zb)
INIT_REACH = 2
_KINDS = ("cell", "edge", "vertex")


def shard_atm_init(mesh: Mesh, part, layout: ShardLayout, p: int, init):
    """Shard p's (AtmGrid, AtmState, AtmDiag), float64 CPU tensors, equal
    to shard p of shard_atm_grid(grid, part) and of shard_atm_state(...,
    state, diag) for (grid, state, diag) = init(mesh), without a global
    field: init (a mesh -> (grid, state, diag) map such as init_jw, its
    stencils INIT_REACH cell layers deep) runs on halo_mesh's entities of
    shard p within layout.halo_depth + INIT_REACH layers, exact on those
    of the layout's halo_depth, whose rows are then cut from it. The
    mesh's fields that init rescales or sets (radius, Coriolis) are its
    rows too, zeroed where layout.shard_mesh zeroes a weight."""
    big, ids = halo_mesh(mesh, part, p, layout.halo_depth + INIT_REACH)
    grid, state, diag = init(big)
    n_global = {"cell": mesh.nCells, "edge": mesh.nEdges,
                "vertex": mesh.nVertices}
    rows = {}
    for kind in _KINDS:
        slots = layout.slots(kind, p)
        at = np.full(n_global[kind], -1, dtype=np.int64)
        at[ids[kind]] = np.arange(len(ids[kind]))
        rows[kind] = np.where(slots >= 0, at[np.maximum(slots, 0)], -1)
        if (rows[kind][slots >= 0] < 0).any():
            raise ValueError(f"shard {p}: a {kind} of the layout lies "
                             "outside its halo mesh")

    def take(x, kind):
        x, r = _np(x), rows[kind]
        dead = (r < 0).reshape(r.shape + (1,) * (x.ndim - 1))
        return np.where(dead, 0, x[np.maximum(r, 0)])

    by_rows = {big.nCells: "cell", big.nEdges: "edge",
               big.nVertices: "vertex"}
    mesh_l = layout.shard_mesh(mesh, p)
    changes = {}
    for f in dataclasses.fields(big):
        v = getattr(grid.mesh, f.name)
        if isinstance(v, torch.Tensor) and v is not getattr(big, f.name):
            x = take(v, by_rows[v.shape[0]])
            if f.name in ZEROED_FIELDS:
                x = np.where(_np(getattr(mesh_l, f.name)) == 0.0, 0.0, x)
            changes[f.name] = torch.from_numpy(x)
    counts = ("nCells", "nEdges", "nVertices")
    mesh_l = dataclasses.replace(grid.mesh, **{
        f.name: changes.get(f.name, getattr(mesh_l, f.name))
        for f in dataclasses.fields(mesh_l)
        if f.name in counts or isinstance(getattr(mesh_l, f.name),
                                          torch.Tensor)})
    grid_l = dataclasses.replace(grid, mesh=mesh_l, **_cut_grid(
        grid, take, lambda: _d2_masks(mesh, layout.slots("cell", p),
                                      layout.slots("edge", p))))

    def cut(obj):
        return type(obj)(**{f.name: torch.from_numpy(_fill_dead(
            f.name, take(getattr(obj, f.name), _FIELDS[f.name][0])))
            for f in dataclasses.fields(obj)})
    return grid_l, cut(state), cut(diag)


def _stack(objs):
    """One dataclass of the tensors of `objs` stacked on a new axis 0."""
    first = objs[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(o, f.name) for o in objs])
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), torch.Tensor)})


def shard_atm_local(mesh: Mesh, part, layout: ShardLayout,
                    group: ShardGroup, dtype, init):
    """(grid_l, state_l, diag_l): `group`'s shards' grid, state and
    diagnostics by shard_atm_init (init: mesh -> (grid, state, diag)), on
    the group's device in `dtype`. A rank (group.rank r) builds shard r
    alone, loopback every shard."""
    shards = range(layout.n_parts) if group.loopback else (group.rank,)
    made = [shard_atm_init(mesh, part, layout, p, init) for p in shards]
    if not group.loopback:
        return tuple(x.to(group.device, dtype) for x in made[0])
    grids, states, diags = zip(*made)
    satm = ShardedAtm(grid=_stack(grids), smesh=sharded_mesh(
        layout, [g.mesh for g in grids]))
    return (satm.local(group, dtype), place(_stack(states), group, dtype),
            place(_stack(diags), group, dtype))


def start_carry(grid_l: AtmGrid, cfg: AtmConfig, state_l: AtmState,
                diag_l: AtmDiag, dt, layout: ShardLayout,
                group: ShardGroup):
    """(carry_l, xch): init_carry on `group`'s shards (shard_atm_local's
    grid, state and diagnostics, the state changed as the caller wants),
    then every field's halo refreshed from its owners through xch, the
    group's ShardExchange, and its dead slots set to _FIELDS' values.
    Equal on every row to place(shard_atm_carry(satm, carry)) of the
    global carry made from the same state, satm = shard_atm_grid(grid,
    part)."""
    xch = ShardExchange(layout, group)
    carry_l = init_carry(grid_l, cfg, state_l, diag_l, dt)
    dead = {}
    for kind in _KINDS:
        d = np.asarray(getattr(layout, f"{kind}_global")) < 0
        dead[kind] = torch.from_numpy(
            d.reshape(-1) if group.loopback else d[group.rank]).to(
                group.device)

    def fix(name, x):
        kind, fill = _FIELDS[name]
        x = getattr(xch, kind)(x)
        m = dead[kind].reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(m, torch.full_like(x, fill or 0.0), x)

    def each(obj):
        return dataclasses.replace(obj, **{
            f.name: each(v) if dataclasses.is_dataclass(v) else fix(f.name, v)
            for f in dataclasses.fields(obj)
            for v in (getattr(obj, f.name),)})
    return each(carry_l), xch


def make_run_steps_atm(satm: ShardedAtm, cfg: AtmConfig, group: ShardGroup):
    """The sharded runner: (grid_l, carry_l, n_steps) -> carry_l, where
    grid_l = satm.local(group, dtype) and carry_l = runner.place(stacked
    carry, group, dtype)."""
    xch = ShardExchange(satm.smesh, group)

    def run(grid_l: AtmGrid, carry_l: AtmCarry, n_steps: int) -> AtmCarry:
        return run_steps_xch(grid_l, cfg, carry_l, cfg.config_dt, n_steps,
                             xch)
    return run


def dry_mass(grid_l: AtmGrid, carry_l: AtmCarry, owned_cell_mask,
             group: ShardGroup):
    """Dry-air mass sum(rho_zz dzw area) over owned cells only (halo rows
    carry real geometry and would count up to P times), in float64."""
    air = (carry_l.state.rho_zz.double() * grid_l.vert.dzw.double()
           * grid_l.mesh.areaCell.double()[:, None])
    return float(psum_owned(air, owned_cell_mask.double(), group))


def run_on_rank(group: ShardGroup, satm: ShardedAtm, cfg: AtmConfig,
                carry_st: AtmCarry, n_steps: int, dtype=torch.float64):
    """Process-group worker (runner.spawn_ranks), or a loopback run: the
    stacked carry stepped n_steps on `group`. Returns u, w, theta_m and
    rho_zz stacked (P, n, ...) from every shard (group.stack), the owned
    dry-air mass (psum_owned) and max w (pmax_owned)."""
    grid_l = satm.local(group, dtype)
    out = make_run_steps_atm(satm, cfg, group)(
        grid_l, place(carry_st, group, dtype), n_steps)
    mask = group.local(satm.smesh.owned_cell_mask, dtype)
    res = {k: group.stack(getattr(out.state, k))
           for k in ("u", "w", "theta_m", "rho_zz")}
    res["dry_mass"] = dry_mass(grid_l, out, mask, group)
    res["w_max"] = float(pmax_owned(out.state.w, mask, group))
    return res
