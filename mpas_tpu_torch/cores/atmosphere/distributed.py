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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.setup import AtmGrid
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.cores.atmosphere.time_integration import (AtmCarry,
                                                              run_steps_xch)
from mpas_tpu_torch.parallel.layout import ShardedMesh, build_sharded_mesh
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


def shard_atm_grid(grid: AtmGrid, part, halo_depth: int = ATM_HALO_DEPTH
                   ) -> ShardedAtm:
    """Per-shard local AtmGrids from a global one (host, once)."""
    smesh = build_sharded_mesh(grid.mesh, part, halo_depth=halo_depth)
    P = smesh.n_parts
    cell_slots = np.asarray(smesh.cell_global)
    edge_slots = np.asarray(smesh.edge_global)

    def sc(x, kind):
        return scatter_field(smesh, _np(x), kind)

    # the factored advection's second-derivative fits: zero the cell
    # stencil columns and the per-side edge weights whose cell is not
    # shard-local (the deep-halo rows would read a wrong neighbour)
    d2_bmat_l = d2w_l = None
    if grid.d2_bmat is not None:
        coc = _np(grid.mesh.cellsOnCell)
        coe = _np(grid.mesh.cellsOnEdge)
        d2_cell_mask = np.zeros((P, cell_slots.shape[1], coc.shape[1] + 1),
                                dtype=bool)
        d2w_mask = np.zeros((P, edge_slots.shape[1], 2), dtype=bool)
        for p in range(P):
            g2l = np.full(grid.mesh.nCells, -1, dtype=np.int64)
            live = np.nonzero(cell_slots[p] >= 0)[0]
            g2l[cell_slots[p, live]] = live
            crows = cell_slots[p]
            d2_cell_mask[p] = np.concatenate(
                [(crows < 0)[:, None], _missing(crows, coc, g2l)], axis=1)
            d2w_mask[p] = _missing(edge_slots[p], coe, g2l)
        d2_bmat_l = np.where(d2_cell_mask[:, :, None, :], 0.0,
                             sc(grid.d2_bmat, "cell"))
        d2w_l = np.where(d2w_mask[..., None], 0.0, sc(grid.d2w, "edge"))

    def opt_cell(x):
        return None if x is None else sc(x, "cell")

    def one(x):
        """dead slots: 1.0, so that the divisions by it stay finite"""
        x = sc(x, "cell")
        return np.where(x == 0.0, 1.0, x)

    def slot_major(x):
        return sc(_np(x).transpose(1, 0, 2), "cell").transpose(0, 2, 1, 3)

    fields = dict(
        zgrid=sc(grid.zgrid, "cell"), zz=one(grid.zz),
        zxu=sc(grid.zxu, "edge"), dss=sc(grid.dss, "cell"),
        zb_cell=slot_major(grid.zb_cell), zb3_cell=slot_major(grid.zb3_cell),
        defc_a=sc(grid.defc_a, "cell"), defc_b=sc(grid.defc_b, "cell"),
        recon_zonal=sc(grid.recon_zonal, "cell"),
        recon_merid=sc(grid.recon_merid, "cell"),
        rho_base=one(grid.rho_base), rtheta_base=one(grid.rtheta_base),
        exner_base=one(grid.exner_base),
        pressure_base=sc(grid.pressure_base, "cell"),
        d2_bmat=d2_bmat_l, d2w=d2w_l,
        # edge-valued content on cell rows: row reorder only; dead slots
        # are killed by the masked edgeSignOnCell of the sharded mesh
        d2w_own=opt_cell(grid.d2w_own), d2w_opp=opt_cell(grid.d2w_opp),
        adv_sside=opt_cell(grid.adv_sside), dv_cell=opt_cell(grid.dv_cell))
    fields = {k: None if v is None
              else torch.from_numpy(np.ascontiguousarray(v))
              for k, v in fields.items()}
    local = dataclasses.replace(grid, mesh=smesh.mesh, **fields)
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


def _scatter(sm, name, x):
    """The stacked (P, ...) CPU tensor of one global field, by _FIELDS."""
    kind, dead = _FIELDS[name]
    x = scatter_field(sm, x, kind)
    if dead is not None:
        x = np.where(x == 0.0, dead, x)
    return torch.from_numpy(x)


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
