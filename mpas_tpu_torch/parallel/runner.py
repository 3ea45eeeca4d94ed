"""Halo exchange, scatter/gather and reductions of sharded runs (port of
mpas_tpu/parallel/runner.py).

The reference's runtime surface (ref: src/framework/mpas_dmpar.F): halo
exchanges (:4666+) and global reductions over owned entities (:730-1371).
The exchange schedule is layout.NeighborExchange, host numpy built once;
the port runs it over two transports, chosen by the ShardGroup:

- loopback: all P shards in this process on one device. Every stacked
  (P, n_local, ...) field is one flat (P * n_local, ...) block-diagonal
  array (layout.ShardedMesh.flat), and the rounds of a schedule are
  composed on the host into one flat source index, so an exchange is one
  gather, x[src], equal bit for bit to the rounds;
- process group: one shard per rank of torch.distributed (gloo on the
  CPU, NCCL on GPUs). Each round posts an isend of the rank's send slots
  where it is a source and an irecv of the round's message size where it
  is a destination, all rounds in one batch_isend_irecv; a rank that is
  no destination of a round gets zeros, then the concatenation is
  spliced into place by one gather.

Entry points take an explicit device; None means cuda:0 and raises where
there is no CUDA device. Nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue as queue_mod
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from mpas_tpu_torch.containers import resolve_device
from mpas_tpu_torch.parallel.layout import (HaloExchange, NeighborExchange,
                                            ShardedMesh)
from mpas_tpu_torch.parallel.partition import _np


class ShardGroup:
    """Where the P shards of a run live.

    rank None (loopback): all P shards in this process on `device`, as the
    flat block-diagonal layout. rank r: shard r of a process group, the
    initialised default torch.distributed group of world size P; ranks are
    host-major (rank = host * chips_per_host + chip), the device order of
    partition.hierarchical_sfc_partition."""

    def __init__(self, n_parts: int, device=None, rank: int | None = None):
        self.n_parts = n_parts
        self.device = resolve_device(device)
        self.rank = rank
        if rank is not None and not (
                dist.is_initialized() and dist.get_world_size() == n_parts
                and dist.get_rank() == rank):
            raise RuntimeError(f"rank {rank} of {n_parts} needs an "
                               "initialised process group of that size")

    @property
    def loopback(self) -> bool:
        return self.rank is None

    def local(self, stacked, dtype=None):
        """A stacked (P, n, ...) host array or tensor -> the part this group
        holds, on its device: the flat (P * n, ...) block in loopback, the
        rank's (n, ...) slice else. Floats are cast to `dtype` (kept where
        None), integers become int64."""
        t = torch.as_tensor(stacked)
        t = t.reshape((-1,) + t.shape[2:]) if self.loopback else t[self.rank]
        if t.is_floating_point():
            return t.to(self.device, dtype or t.dtype)
        return t.to(self.device, torch.int64)

    def stack(self, local) -> np.ndarray:
        """Inverse of local(): -> (P, n, ...) numpy on the host, every
        rank's part (all_gather under a process group)."""
        if self.loopback:
            x = local.detach().cpu().numpy()
            return x.reshape((self.n_parts, -1) + x.shape[1:])
        parts = [torch.empty_like(local) for _ in range(self.n_parts)]
        dist.all_gather(parts, local.contiguous())
        return torch.stack(parts).cpu().numpy()


def device_mesh(n_parts: int, device=None) -> ShardGroup:
    """All n_parts shards in this process on one device (loopback)."""
    return ShardGroup(n_parts, device)


def device_mesh_hierarchical(n_hosts: int, chips_per_host: int,
                             device=None, rank: int | None = None
                             ) -> ShardGroup:
    """n_hosts x chips_per_host shards, host-major, to pair with
    partition.hierarchical_sfc_partition: loopback where rank is None,
    else this rank of the initialised process group."""
    return ShardGroup(n_hosts * chips_per_host, device, rank)


def place(obj, group: ShardGroup, dtype=None):
    """A container of stacked (P, n, ...) fields (AtmState, AtmCarry,
    OcnState, SWState) -> the same container of group.local() tensors;
    nested containers recurse, None fields stay None."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (torch.Tensor, np.ndarray)):
            changes[f.name] = group.local(v, dtype)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = place(v, group, dtype)
    return dataclasses.replace(obj, **changes)


def compose_neighbor_exchange(nx: NeighborExchange, n_local: int):
    """The rounds of `nx` as one flat source index over the loopback
    layout: slot li of shard p reads q * n_local + send_idx[r][q, s] where
    its splice points at offset s of round r's receive block and (q, p) is
    a pair of round r, and itself elsewhere. (P * n_local,) int64."""
    splice = nx.splice.astype(np.int64)
    P = splice.shape[0]
    base = (np.arange(P, dtype=np.int64) * n_local)[:, None]
    src = np.where(splice < n_local, base + splice, -1)
    offset = n_local
    for r, perm in enumerate(nx.perms):
        size = nx.sizes[r]
        for q, p in perm:
            at = (splice[p] >= offset) & (splice[p] < offset + size)
            src[p, at] = q * n_local + nx.send_idx[r][q, splice[p, at]
                                                      - offset]
        offset += size
    if src.min() < 0 or src.max() >= P * n_local:
        raise ValueError("the schedule reads a slot outside the layout")
    return src.ravel()


class _LoopbackExchange:
    def __init__(self, nx, n_local, group):
        self.src = torch.from_numpy(
            compose_neighbor_exchange(nx, n_local)).to(group.device)

    def __call__(self, x):
        return x[self.src]


class _RankExchange:
    """One rank's part of a NeighborExchange over the process group."""

    def __init__(self, nx, n_local, group):
        r, dev = group.rank, group.device
        self.splice = torch.from_numpy(nx.splice[r].astype(np.int64)).to(dev)
        self.rounds = []     # (size, send slots or None, dst, src)
        for k, perm in enumerate(nx.perms):
            dst = [p for q, p in perm if q == r]
            src = [q for q, p in perm if p == r]
            idx = torch.from_numpy(nx.send_idx[k][r].astype(np.int64)).to(
                dev) if dst else None
            self.rounds.append((nx.sizes[k], idx, dst[0] if dst else None,
                                src[0] if src else None))

    def __call__(self, x):
        if not self.rounds:
            return x
        ops, bufs = [], []
        for size, idx, dst, src in self.rounds:
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, x[idx].contiguous(), dst))
            buf = torch.zeros((size,) + x.shape[1:], dtype=x.dtype,
                              device=x.device)
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, buf, src))
            bufs.append(buf)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return torch.cat([x] + bufs)[self.splice]


class ShardExchange:
    """Depth-selectable neighbor-schedule exchanges of a sharded mesh over
    `group`'s transport (ref: the haloLayers argument of
    mpas_dmpar_exch_halo_field*; e.g. layer-1-only exchanges inside the
    atmosphere's acoustic loop, mpas_atm_time_integration.F:792,845, and
    the ocean barotropic subcycle's restricted 'subcycleFields' group,
    mpas_ocn_time_integration_split.F:771). Each exchange indexes dim 0
    only, whatever the trailing dims."""

    def __init__(self, smesh: ShardedMesh, group: ShardGroup):
        make = _LoopbackExchange if group.loopback else _RankExchange
        self._full = smesh.halo_depth
        self._c, self._e, self._v = (
            {d: make(nx, smesh.n_local(kind), group)
             for d, nx in table.items()}
            for kind, table in (("cell", smesh.cell_nx),
                                ("edge", smesh.edge_nx),
                                ("vertex", smesh.vertex_nx)))

    @staticmethod
    def _pick(table, depth, full):
        d = full if depth is None else min(depth, full)
        if d in table:
            return table[d]
        for k in sorted(table):
            if k >= d:
                return table[k]
        return table[max(table)]

    def cell(self, x, depth=None):
        return self._pick(self._c, depth, self._full)(x)

    def edge(self, x, depth=None):
        return self._pick(self._e, depth, self._full)(x)

    def vertex(self, x, depth=None):
        return self._pick(self._v, depth, self._full)(x)


def halo_exchange(xch: HaloExchange, field, group: ShardGroup):
    """Refresh halo slots from their owners through the all-to-all
    schedule (loopback only): shard p's slot li reads its own slot
    perm[p, li] below owned_pad, else slot s of the message from shard q,
    send_idx[q, p, s], with perm[p, li] = owned_pad + q * S + s."""
    if not group.loopback:
        raise NotImplementedError("the all-to-all exchange runs in "
                                  "loopback only; use ShardExchange")
    perm = xch.perm.astype(np.int64)
    P, n = perm.shape
    k = perm - xch.owned_pad
    q, s = k // xch.msg_size, k % xch.msg_size
    p = np.arange(P)[:, None]
    src = np.where(k < 0, p * n + perm,
                   q * n + xch.send_idx[np.clip(q, 0, P - 1), p,
                                        np.clip(s, 0, None)])
    return field[torch.from_numpy(src.ravel()).to(field.device)]


def _owned(owned_mask, ndim):
    return owned_mask.reshape(owned_mask.shape + (1,) * (ndim - 1))


def psum_owned(local_vals, owned_mask, group: ShardGroup):
    """Global sum of a per-entity local field over owned entities."""
    s = (local_vals * _owned(owned_mask, local_vals.dim())).sum()
    if not group.loopback:
        dist.all_reduce(s, op=dist.ReduceOp.SUM)
    return s


def pmax_owned(local_vals, owned_mask, group: ShardGroup):
    """Global max of a per-entity local field over owned entities."""
    m = _owned(owned_mask, local_vals.dim())
    s = torch.where(m > 0, local_vals, -torch.inf).max()
    if not group.loopback:
        dist.all_reduce(s, op=dist.ReduceOp.MAX)
    return s


def pmin_owned(local_vals, owned_mask, group: ShardGroup):
    """Global min of a per-entity local field over owned entities."""
    m = _owned(owned_mask, local_vals.dim())
    s = torch.where(m > 0, local_vals, torch.inf).min()
    if not group.loopback:
        dist.all_reduce(s, op=dist.ReduceOp.MIN)
    return s


# ---------------------------------------------------------------------------
# host-side scatter/gather between global and stacked-local fields
# ---------------------------------------------------------------------------

_KIND_SLOTS = {"cell": "cell_global", "edge": "edge_global",
               "vertex": "vertex_global"}


def scatter_field(smesh: ShardedMesh, global_field, kind: str):
    """Global (n, ...) -> stacked local (P, n_local, ...)."""
    slots = np.asarray(getattr(smesh, _KIND_SLOTS[kind]))
    g = _np(global_field)
    out = g[np.maximum(slots, 0)]
    dead = (slots < 0).reshape(slots.shape + (1,) * (g.ndim - 1))
    return np.where(dead, 0, out)


def gather_field(smesh: ShardedMesh, stacked, kind: str, n_global: int):
    """Stacked local (P, n_local, ...) -> global (n, ...) from owned slots."""
    slots = np.asarray(getattr(smesh, _KIND_SLOTS[kind]))
    mask = np.asarray({"cell": smesh.owned_cell_mask,
                       "edge": smesh.owned_edge_mask,
                       "vertex": smesh.owned_vertex_mask}[kind]) > 0
    stacked = _np(stacked)
    out = np.zeros((n_global,) + stacked.shape[2:], dtype=stacked.dtype)
    for p in range(smesh.n_parts):
        sel = mask[p]
        out[slots[p, sel]] = stacked[p, sel]
    return out


# ---------------------------------------------------------------------------
# rank workers
# ---------------------------------------------------------------------------

def exchanges_on_rank(group: ShardGroup, smesh: ShardedMesh, fields):
    """Process-group worker (spawn_ranks): each (kind, depth, stacked
    field) of `fields` through this rank's ShardExchange; returns the
    rank's results as numpy."""
    xch = ShardExchange(smesh, group)
    return [getattr(xch, kind)(group.local(x), depth).cpu().numpy()
            for kind, depth, x in fields]


def _rank_main(worker, rank, n_ranks, init_method, backend, device, timeout,
               args, results):
    """Body of one spawned rank: join the group, run worker(group, *args),
    report (rank, ok, result or traceback)."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)      # the ranks share the host's cores
        dist.init_process_group(
            backend, init_method=init_method, world_size=n_ranks, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = worker(ShardGroup(n_ranks, dev, rank), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:                      # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(worker, n_ranks: int, init_file, args=(), devices=None,
                timeout: float = 60.0, deadline: float = 300.0):
    """Run worker(group, *args) in n_ranks spawned processes joined in one
    torch.distributed group (rank r holds shard r) and return the results
    by rank. `worker` must be importable by the children (a module-level
    function of this package); `init_file` is a path that does not exist
    yet, the rendezvous of init_method "file://". devices: one per rank,
    cuda:r by default; the backend is NCCL on CUDA devices, gloo on the
    CPU. The group's operations time out after `timeout` seconds and the
    whole call after `deadline`: a rank that fails, dies or hangs fails
    the call, and no child outlives it."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{r}" for r in range(n_ranks)]
    backend = "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(worker, r, n_ranks, f"file://{init_file}",
                               backend, devices[r], timeout, args, results))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    out, errors = {}, []
    end = time.monotonic() + deadline
    try:
        while len(out) + len(errors) < n_ranks:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode
                        not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died: exit codes "
                                       f"{[procs[r].exitcode for r in dead]}"
                                       f"; {errors}")
                if time.monotonic() > end:
                    raise TimeoutError(f"ranks did not finish within "
                                       f"{deadline} s; {errors}")
                continue
            if ok:
                out[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
    return [out[r] for r in range(n_ranks)]
