"""jw_15km: MPAS-A's dry nonhydrostatic dycore on the Jablonowski-
Williamson baroclinic wave (case 2) on the 2,621,442-cell 15-km mesh
(x1.2621442), one rank a card over the configuration's partition.

The program's path is the port's sharded one, set up by each rank for its
own shard from the mesh file and the partition alone
(cores/atmosphere/distributed.py: shard_atm_local runs init_jw on the
shard's entities two layers beyond its halo and cuts the shard's rows,
float32 on its card; then start_carry: init_carry and one halo refresh),
and stepped by time_integration.srk3_step with the halo exchanges of
ShardExchange over the process group (NCCL on the cards). The seeded inputs are
jw_120km's (its make_inputs), drawn from the globe's lat/lon on the host
and cut to the shard by the port's scatter_field. prepare() builds the
mesh file and the partition's ShardLayout once a checkout
(benchmark/.cache/jw_15km); group None runs every shard in one process
on one device (the port's loopback).

The check. The globe's float64 reference fits on no card, so it runs on
patches (benchmark/reference/mesh/patch.py, seeded_centres): seeded caps
of compared cells, the first on a shard boundary with every shard within
its compared layers, more until every rank owns a compared cell, then
more on shard boundaries under JW's jet (the configuration's band of
latitude) until every rank owns a compared cell there, each
with a halo as deep as the domain of dependence of
the reference's init and start_at steps (patch_halo: measured with NaN
ghosts, 34 layers the first step from the init's 2-layer band, 30 each
step after it). Each rank's snapshot is its owned rows of the patch
entities, copied on its card; gather brings them to rank 0 in patch
order, the ghosts NaN. The numbers and their names are jw_120km's:
start_<field> and step_<field> over the compared cells (u: the edges
between two of them), max |program - reference| / max |reference|, and
step_k2 over the compared cells' rows of the sampled step's K2 calls.
u's largest lies under the jet, so a wind moved on one rank shows
there, well above the float32 rounding of the weak winds where the
shards meet on the equator.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import pickle
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import common, window
from benchmark.harness.calls import k2_gap
from benchmark.harness.dataclasses_io import convert
from benchmark.harness.meshfile import mesh_path
from benchmark.harness.setup_parts import Parts
from benchmark.reference.mesh import patch as patches

JW = common.config_module("jw_120km")
FIELDS, COMPARED = JW.FIELDS, JW.COMPARED
program_impl, reference_impl = JW.program_impl, JW.reference_impl
host_init, bytes_per_step = JW.host_init, JW.bytes_per_step
# the layers of cells the reference's init leaves wrong at a patch's edge
INIT_REACH = 2
# the port's files the cached layout is made by
LAYOUT_SOURCES = ("mpas_tpu_torch/parallel/layout.py",
                  "mpas_tpu_torch/parallel/partition.py")


def centres_of(params, mesh, part, seed):
    """The seed's patch centres (patch.seeded_centres)."""
    p = params["patch"]
    band = tuple(np.radians(p["band_lat_deg"]))
    return patches.seeded_centres(mesh, part, seed, p["compared_layers"],
                                  band)


def start_at(traffic):
    """The steps made when the start snapshot is taken."""
    return traffic["warm_steps"] + window.START_STEPS


def patch_halo(params, steps: int) -> int:
    """Halo layers a patch needs for `steps` steps of the reference from
    its init on the patch (at least one: the sampled step from the
    program's state)."""
    h = params["patch"]["halo_layers"]
    return h["init"] + h["first_step"] + h["step"] * (max(steps, 1) - 1)


def layout_of(params, mesh=None):
    """(partition, ShardLayout) of the configuration's mesh, made once and
    kept under benchmark/.cache/jw_15km (named by the mesh, the parts, the
    halo and the port's layout code); mesh: the program's, where the
    caller has it read."""
    from mpas_tpu_torch.parallel.layout import shard_layout
    from mpas_tpu_torch.parallel.partition import sfc_partition
    p = params["partition"]
    path = mesh_path(params)
    h = hashlib.sha256(f"{path.name} {p}".encode())
    for f in LAYOUT_SOURCES:
        h.update((common.ROOT / f).read_bytes())
    cached = common.CACHE_DIR / "jw_15km" / f"layout-{h.hexdigest()[:16]}.pkl"
    if cached.exists():
        with open(cached, "rb") as f:
            return pickle.load(f)
    if mesh is None:
        mesh = program_impl().load_mesh(str(path))
    part = sfc_partition(mesh, p["parts"])
    out = (part, shard_layout(mesh, part, p["halo_layers"]))
    cached.parent.mkdir(parents=True, exist_ok=True)
    tmp = cached.with_suffix(".partial")
    with open(tmp, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(cached)
    return out


def prepare(params, traffic):
    """What the ranks read, made once before they start: the mesh file
    and the layout. A program without the per-rank set-up fails here, at
    once."""
    from mpas_tpu_torch.cores.atmosphere.distributed import (  # noqa: F401
        shard_atm_local)
    layout_of(params)


def make_inputs(params, seed, mesh):
    """jw_120km's seeded inputs (du, q), float64 on the host, drawn from
    `mesh`, the mesh file as read already, in place of a second read."""
    saved = JW.load_reference
    JW.load_reference = lambda path: mesh
    try:
        return JW.make_inputs(params, seed, torch.device("cpu"))
    finally:
        JW.load_reference = saved


def make_cfg(impl, params, traffic):
    return impl.AtmConfig(
        config_nvertlevels=traffic["levels"],
        config_len_disp=params["len_disp_m"], config_dt=params["dt_s"],
        config_number_of_sub_steps=params["acoustic_substeps"],
        config_dynamics_split_steps=params["dynamics_split_steps"])


def host_setup(params, traffic, device, group, parts):
    """What a process keeps whatever the seed: the mesh, the layout and
    its shards' grid, state and diagnostics on `device`."""
    from mpas_tpu_torch.cores.atmosphere import distributed as adist
    from mpas_tpu_torch.parallel.runner import ShardGroup
    impl = program_impl()
    path = mesh_path(params)
    parts.mark("mesh_file")
    mesh = impl.load_mesh(str(path))
    parts.mark("mesh_load")
    part, layout = layout_of(params, mesh)
    parts.mark("layout")
    n = params["partition"]["parts"]
    if group is not None and group.size != n:
        raise ValueError(f"the partition has {n} parts; {group.size} ranks")
    sg = ShardGroup(n, device, None if group is None else group.rank)
    cfg = make_cfg(impl, params, traffic)
    init = functools.partial(impl.init_jw, cfg=cfg, case=params["init_case"],
                             n_scalars=traffic["scalars"], radius=impl.radius)
    dtype = getattr(torch, params["dtype"])
    grid, state, diag = adist.shard_atm_local(mesh, part, layout, sg, dtype,
                                              init)
    parts.mark("shard_init")
    return SimpleNamespace(impl=impl, mesh=mesh, part=part, layout=layout,
                           group=sg, cfg=cfg, dtype=dtype, grid=grid,
                           state=state, diag=diag,
                           host=getattr(group, "host", None))


class _Keep:
    """carry_restart_fields' group that keeps each field as it is."""

    @staticmethod
    def stack(x):
        return x


class ShardedPatchCase:
    """The program's shards in this process (host_setup's), the seeded
    inputs added and the carry made (init_carry, one halo refresh);
    step() is one srk3_step with the exchanges. snapshot() copies this
    process's owned rows of the seed's patches on the device; gather()
    returns the patches' carry (patch order, ghost rows NaN) on rank 0,
    None elsewhere. The sampled step's K2 calls (between the second and
    the third snapshot) are kept at the owned compared cells' rows."""

    def __init__(self, params, traffic, seed, device, host, parts):
        from mpas_tpu_torch.cores.atmosphere import distributed as adist
        from mpas_tpu_torch.parallel.runner import scatter_field
        self.device, self.host = device, host
        self.group, self.layout = host.group, host.layout
        self.dtype, self.host_group = host.dtype, host.host
        self.part = host.part
        self.dt = params["dt_s"]
        self.ti = host.impl.ti
        self.k2_sites = ()              # kept by the case itself (module doc)
        g, dtype = self.group, host.dtype
        inputs = make_inputs(params, seed, host.mesh)
        du = g.local(scatter_field(self.layout, inputs["du"].numpy(),
                                   "edge"), dtype)
        q = g.local(scatter_field(self.layout, inputs["q"].numpy(), "cell"),
                    dtype)
        parts.mark("inputs")
        nz, ns = traffic["levels"], traffic["scalars"]
        state, diag = host.state, host.diag
        c = host.grid.mesh.cellsOnEdge
        rho_edge = 0.5 * (state.rho_zz[c[:, 0]] + state.rho_zz[c[:, 1]])
        state = dataclasses.replace(
            state, u=state.u + du[:, None],
            scalars=q[:, :, None].expand(-1, nz, ns).contiguous())
        diag = dataclasses.replace(diag, ru=diag.ru + rho_edge * du[:, None])
        self.carry, self.xch = adist.start_carry(
            host.grid, host.cfg, state, diag, self.dt, self.layout, g)
        self.grid, self.cfg = host.grid, host.cfg
        self.steps_done = 0
        # the patches, and this process's owned rows of them
        p = params["patch"]
        self.centres = centres_of(params, host.mesh, host.part, seed)
        self.halo = patch_halo(params, start_at(traffic))
        cells, layer, edges, verts = patches.patch_entities(
            host.mesh, self.centres, p["compared_layers"], self.halo)
        self.n_patch = {"cell": len(cells), "edge": len(edges),
                        "vertex": len(verts)}
        n_compared = int((layer <= p["compared_layers"]).sum())
        self.rows, self.pos = {}, {}
        for kind, ids in (("cell", cells), ("edge", edges),
                          ("vertex", verts)):
            rows, pos = self._owned_rows(kind, ids)
            self.rows[kind] = torch.from_numpy(rows).to(device)
            self.pos[kind] = pos
            if kind == "cell":
                self.k2_rows = torch.from_numpy(rows[pos < n_compared]).to(
                    device)
        if self.group.loopback:
            for kind, n in self.n_patch.items():
                _cover(self.pos[kind], n, kind)
        self.pos_dev = {k: torch.from_numpy(v).to(device)
                        for k, v in self.pos.items()}
        self.inputs = {"du": inputs["du"], "q": inputs["q"],
                       "mesh": reference_mesh(host.mesh)}
        self._snaps, self._k2, self._saved = 0, None, []
        for module_name, name in host.impl.k2_sites:
            self._probe(module_name, name)

    def _owned_rows(self, kind, ids):
        """(local rows, patch positions) of the owned slots of this
        process's shards that hold an entity of `ids`."""
        n_global = {"cell": self.host.mesh.nCells,
                    "edge": self.host.mesh.nEdges,
                    "vertex": self.host.mesh.nVertices}[kind]
        at = np.full(n_global, -1, dtype=np.int64)
        at[ids] = np.arange(len(ids))
        lay, g = self.layout, self.group
        owned = np.asarray(getattr(lay, f"owned_{kind}_mask")) > 0
        shards = range(lay.n_parts) if g.loopback else (g.rank,)
        rows, pos = [], []
        for i, p in enumerate(shards):
            slots = lay.slots(kind, p)
            where = np.nonzero(owned[p] & (slots >= 0))[0]
            where = where[at[slots[where]] >= 0]
            rows.append(i * lay.n_local(kind) + where)
            pos.append(at[slots[where]])
        return np.concatenate(rows), np.concatenate(pos)

    def _probe(self, module_name, name):
        """Wrap the program's K2 at a site: the calls made while armed keep
        their compared rows."""
        import importlib
        mod = importlib.import_module(module_name)
        fn = getattr(mod, name)
        rows = self.k2_rows

        def probe(w, x):
            out = fn(w, x)
            if self._k2 is not None:
                self._k2.append((w[rows].clone(), x[rows].clone(),
                                 out[rows].clone()))
            return out
        self._saved.append((mod, name, fn))
        setattr(mod, name, probe)

    def step(self):
        self.carry = self.ti.srk3_step(self.grid, self.cfg, self.carry,
                                       self.dt, xch=self.xch)
        self.steps_done += 1

    def checkable(self):
        return True

    def snapshot(self):
        """This process's owned rows of the patches, copied on the device
        (ranks: gather() assembles them on rank 0; loopback: assembled
        here, on the device)."""
        from mpas_tpu_torch.cores.atmosphere import distributed as adist
        self._snaps += 1
        k2 = []
        if self._snaps == 2:            # before the sampled step
            self._k2 = []
        elif self._snaps == 3:          # after it
            k2, self._k2 = self._k2, None
        by_rows = {self.layout.n_local(k) * (self.layout.n_parts if
                                             self.group.loopback else 1):
                   self.rows[k] for k in self.rows}
        fields, kinds = adist.carry_restart_fields(self.carry, _Keep)
        mine = ({k: v[by_rows[v.shape[0]]].clone()
                 for k, v in fields.items()}, k2)
        if self.group.loopback:
            return self._assemble([(mine, self.pos_dev)], kinds)
        return SimpleNamespace(mine=mine, kinds=kinds)

    def gather(self, snap):
        """The patches' carry on rank 0 (every rank takes this after the
        window), None elsewhere: SimpleNamespace(carry, k2, centres,
        halo)."""
        import torch.distributed as dist
        if self.group.loopback:
            return snap
        values, k2 = snap.mine
        mine = ({k: v.cpu().numpy() for k, v in values.items()},
                [tuple(t.cpu().numpy() for t in c) for c in k2])
        got = [None] * self.group.n_parts if self.group.rank == 0 else None
        dist.gather_object((mine, self.pos), got, dst=0,
                           group=self.host_group)
        if self.group.rank != 0:
            return None
        for kind in self.n_patch:
            _cover(np.concatenate([pos[kind] for _, pos in got]),
                   self.n_patch[kind], kind)
        return self._assemble(got, snap.kinds)

    def _assemble(self, got, kinds):
        """The patches' carry from [((values, k2 calls), positions)], each
        process's owned patch rows and their places in the patches, on
        the device in the program's dtype: patch order, ghost rows NaN."""
        dev = self.device
        whole = {}
        for k, kind in kinds.items():
            first = got[0][0][0][k]
            arr = torch.full((self.n_patch[kind] + 1,) + tuple(
                first.shape[1:]), float("nan"), dtype=self.dtype, device=dev)
            for (values, _), pos in got:
                arr[torch.as_tensor(pos[kind], device=dev)] = \
                    torch.as_tensor(values[k], device=dev).to(self.dtype)
            whole[k] = arr
        k2 = [tuple(torch.as_tensor(t, device=dev) for t in c)
              for (_, calls), _ in got for c in calls]
        return SimpleNamespace(carry=_carry_of(whole), k2=k2,
                               centres=self.centres, halo=self.halo)

    def finite(self):
        return all(bool(torch.isfinite(getattr(self.carry.state, k)).all())
                   for k in FIELDS)

    def release(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []
        self.grid = self.carry = self.xch = self.host = None


def _cover(pos, n, kind):
    """Raise unless the positions name each of the n patch rows once."""
    if not np.array_equal(np.bincount(pos, minlength=n), np.ones(n, int)):
        raise RuntimeError(f"a patch {kind} held by no shard, or by two")


def _carry_of(whole):
    """The program's AtmCarry of {"state.u": tensor, ..., "v": ...}, the
    names of adist.carry_restart_fields."""
    from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
    AtmCarry = program_impl().ti.AtmCarry

    def sub(cls, prefix):
        return cls(**{f.name: whole[f"{prefix}.{f.name}"]
                      for f in dataclasses.fields(cls)})
    return AtmCarry(state=sub(AtmState, "state"), diag=sub(AtmDiag, "diag"),
                    **{f.name: whole[f.name]
                       for f in dataclasses.fields(AtmCarry)
                       if f.name not in ("state", "diag")})


def reference_mesh(mesh):
    """The program's mesh as the reference's Mesh: the same arrays."""
    from benchmark.reference.mesh.mesh import Mesh
    return Mesh(**{f.name: getattr(mesh, f.name)
                   for f in dataclasses.fields(Mesh)})


class ControlCase:
    """The control in the program's place on the whole mesh in one
    process (where the globe fits, as at the tests' size): jw_120km's
    JwCase of the reference in float32 with its K2 in TF32; snapshot()
    gives the seed's patches' rows as gather() does, the K2 calls kept
    by the window (k2_sites)."""

    def __init__(self, params, traffic, seed, device):
        from benchmark.harness.meshfile import load_reference
        impl = reference_impl()
        mesh = load_reference(mesh_path(params))
        part, _ = layout_of(params)
        self.inputs = dict(make_inputs(params, seed, mesh), mesh=mesh)
        self.case = JW.JwCase(impl, params, traffic, self.inputs, device,
                              torch.float32, tf32=True,
                              host=host_init(impl, params, traffic, mesh))
        self.device, self.dt, self.k2_sites = device, self.case.dt, \
            impl.k2_sites
        self.centres = centres_of(params, mesh, part, seed)
        self.halo = patch_halo(params, start_at(traffic))
        cells, _, edges, verts = patches.patch_entities(
            mesh, self.centres, params["patch"]["compared_layers"],
            self.halo)
        self.ids = {mesh.nCells: cells, mesh.nEdges: edges,
                    mesh.nVertices: verts}
        for _ in range(traffic["warm_steps"]):
            self.step()

    @property
    def steps_done(self):
        return self.case.steps_done

    def step(self):
        self.case.step()

    def checkable(self):
        return True

    def snapshot(self):
        def rows(obj):
            out = {}
            for f in dataclasses.fields(obj):
                v = getattr(obj, f.name)
                if dataclasses.is_dataclass(v):
                    out[f.name] = rows(v)
                else:
                    ids = torch.from_numpy(self.ids[v.shape[0]]).to(v.device)
                    out[f.name] = torch.cat([v[ids], torch.full_like(
                        v[:1], float("nan"))])
            return dataclasses.replace(obj, **out)
        return SimpleNamespace(carry=rows(self.case.carry), k2=[],
                               centres=self.centres, halo=self.halo)

    def finite(self):
        return self.case.finite()

    def release(self):
        self.case.release()


def build(params, traffic, seed, device, group=None, host=None,
          control=False):
    """The run's case: this rank's shard (group: its place in the run over
    several cards; None: every shard in this process); host: host_setup's
    result where the caller keeps it from an earlier seed; control: the
    ControlCase in the program's place."""
    if control:
        return ControlCase(params, traffic, seed, device)
    parts = Parts(device)
    if host is None:
        host = host_setup(params, traffic, device, group, parts)
    case = ShardedPatchCase(params, traffic, seed, device, host, parts)
    parts.mark("carry")
    for _ in range(traffic["warm_steps"]):
        case.step()
    parts.mark("warm_steps")
    case.setup_parts = parts.seconds
    return case


def _row_kinds(obj, counts, out=None):
    """({field: kind}, {field: axis}) of a dataclass's tensors (nested
    too) whose rows are cells, edges or vertices, by their length."""
    out = out if out is not None else ({}, {})
    by_len = {n: k for k, n in counts.items()}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            _row_kinds(v, counts, out)
        elif isinstance(v, torch.Tensor) and v.dim() > 0:
            axis = 1 if f.name in ("zb_cell", "zb3_cell") else 0
            if v.shape[axis] in by_len:
                out[0][f.name] = by_len[v.shape[axis]]
                out[1][f.name] = axis
    return out


def on_patch(impl, params, traffic, inputs, patch, device, dtype,
             tf32=False, host=None):
    """JwCase of impl (the reference's or the program's) on `patch` in
    `dtype` (impl's own init, the seeded inputs' patch rows), NaN where
    the init is wrong: the ghosts, the outermost INIT_REACH layers of
    cells and the edges to a ghost; host: impl's host_init on the patch,
    where the caller has it."""
    m = patch.mesh
    if impl.name == "program":
        from mpas_tpu_torch.mesh.mesh import Mesh
        m = Mesh(**{f.name: getattr(m, f.name)
                    for f in dataclasses.fields(Mesh)})
    counts = {"cell": m.nCells, "edge": m.nEdges, "vertex": m.nVertices}
    cfg, grid, state, diag = host or host_init(impl, params, traffic, mesh=m)
    band = patches.bad_rows(patch, INIT_REACH)
    ghost = {k: np.array([n - 1]) for k, n in counts.items()}
    mesh_kinds, _ = _row_kinds(grid.mesh, counts)
    kinds, axes = _row_kinds(grid, counts)
    grid = patches.poison(grid, {k: v for k, v in kinds.items()
                                 if k not in mesh_kinds}, band, axes)
    grid = dataclasses.replace(grid, mesh=patches.poison(grid.mesh,
                                                         mesh_kinds, ghost))

    def rows(x, ids):
        return torch.cat([x[torch.from_numpy(ids)], x[:1]]).to(device)
    pin = {"du": rows(inputs["du"], patch.edges),
           "q": rows(inputs["q"], patch.cells)}
    ref = JW.JwCase(impl, params, traffic, pin, device, dtype, tf32=tf32,
                    host=(cfg, grid, state, diag))
    carry_kinds, _ = _row_kinds(ref.carry, counts)
    ref.carry = patches.poison(ref.carry, carry_kinds, band)
    return ref


def patch_gaps(prefix, got, ref, patch):
    """{prefix_field: max |got - ref| / max |ref|} over COMPARED at the
    compared cells (u: the edges between them); NaN where the reference
    read a ghost."""
    out = {}
    for k in COMPARED:
        rows = torch.from_numpy(patch.compared_edges if k == "u"
                                else patch.compared_cells)
        r = getattr(ref, k).double()[rows.to(getattr(ref, k).device)]
        g = getattr(got, k).double()[rows.to(getattr(got, k).device)]
        out[f"{prefix}_{k}"] = float((g - r).abs().max() / r.abs().max())
    return out


def _ref_carry(carry):
    """A program or control carry as the reference's, in float64."""
    from benchmark.reference.atmosphere import state as ref_state
    classes = {"AtmCarry": reference_impl().ti.AtmCarry,
               "AtmState": ref_state.AtmState, "AtmDiag": ref_state.AtmDiag}
    return convert(carry, classes, torch.float64)


def check(params, traffic, inputs, rec, device):
    """{name: value} of the numbers compared (module docstring)."""
    if rec.start_at != start_at(traffic):
        raise ValueError(f"the start snapshot after {rec.start_at} steps, "
                         f"not {start_at(traffic)}: the patches' halo")
    patch = patches.build_patch(inputs["mesh"], rec.start.centres,
                                params["patch"]["compared_layers"],
                                rec.start.halo)
    ref = on_patch(reference_impl(), params, traffic, inputs, patch,
                   device, torch.float64)
    for _ in range(rec.start_at):
        ref.step()
    out = patch_gaps("start", rec.start.carry.state, ref.carry.state, patch)
    ref.carry = _ref_carry(rec.pre.carry)
    ref.step()
    out.update(patch_gaps("step", rec.post.carry.state, ref.carry.state,
                          patch))
    out["step_k2"] = k2_gap(rec.post.k2 + rec.k2_calls)
    return out


@functools.lru_cache(maxsize=1)
def _mesh_file(path):
    """The mesh file as the reference reads it, kept from seed to seed."""
    from benchmark.harness.meshfile import load_reference
    return load_reference(path)


def readings(params, traffic, seed, device, program):
    """The numbers of check() for the limits (benchmark/limits.py's rule),
    on one device, on the seed's patches with a halo for one step more:
    program, the port's one-card path (jw_120km's JwCase of the program)
    on the patches in the configuration's dtype, the row-wise arithmetic
    of the cell's shards; else the control, the reference in float32
    with its K2 in TF32. start_* after start_at steps from the side's
    own init; step_* one step from its state there, the float64
    reference from the same state; step_k2 that step's K2 calls at the
    compared cells' rows."""
    from benchmark.harness.calls import recording
    mesh = _mesh_file(str(mesh_path(params)))
    part, _ = layout_of(params)
    inputs = make_inputs(params, seed, mesh)
    n = start_at(traffic)
    patch = patches.build_patch(mesh, centres_of(params, mesh, part, seed),
                                params["patch"]["compared_layers"],
                                patch_halo(params, n + 1))
    host = host_init(reference_impl(), params, traffic, mesh=patch.mesh)
    ref = on_patch(reference_impl(), params, traffic, inputs, patch, device,
                   torch.float64, host=host)
    if program:
        side = on_patch(program_impl(), params, traffic, inputs, patch,
                        device, getattr(torch, params["dtype"]))
    else:
        side = on_patch(reference_impl(), params, traffic, inputs, patch,
                        device, torch.float32, tf32=True, host=host)
    for _ in range(n):
        side.step()
        ref.step()
    out = patch_gaps("start", side.carry.state, ref.carry.state, patch)
    ref.carry = _ref_carry(side.carry)
    calls = []
    with recording(side.k2_sites, calls):
        side.step()
    ref.step()
    out.update(patch_gaps("step", side.carry.state, ref.carry.state, patch))
    rows = torch.from_numpy(patch.compared_cells).to(device)
    out["step_k2"] = k2_gap([tuple(t[rows] for t in c) for c in calls])
    return out
