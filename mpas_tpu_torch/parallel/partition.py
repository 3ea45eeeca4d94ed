"""Cell-graph partitioning across devices (port of
mpas_tpu/parallel/partition.py).

Replacement for the reference's METIS-file-driven block decomposition
(ref: src/framework/mpas_block_decomp.F:51-160 reads `graph.info.part.N`
and assigns cells->blocks->procs). Two methods, both host numpy on the
port's Mesh (CPU tensors are read through np.asarray):

- a Morton space-filling-curve partition, the default: contiguous SFC
  chunks give compact shards with a small halo surface, and cell weights
  (e.g. from meshDensity on variable-resolution meshes) balance the load;
- a `graph.info.part.N` reader for runs set up for the reference.
"""

from __future__ import annotations

import numpy as np


def _np(x):
    """Host numpy view of a CPU tensor or array."""
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _morton_key(points, bits=21):
    """Interleave-bit Morton key of 3D points normalized to the unit cube."""
    p = np.asarray(points, dtype=np.float64)
    lo = p.min(axis=0)
    span = np.maximum(p.max(axis=0) - lo, 1e-300)
    q = np.clip(((p - lo) / span) * (2 ** bits - 1), 0,
                2 ** bits - 1).astype(np.uint64)
    key = np.zeros(p.shape[0], dtype=np.uint64)
    for b in range(bits):
        for d in range(3):
            key |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) \
                << np.uint64(3 * b + d)
    return key


def _cell_points(mesh):
    return np.stack([_np(mesh.xCell), _np(mesh.yCell), _np(mesh.zCell)],
                    axis=-1)


def sfc_partition(mesh, n_parts: int, weights=None):
    """Morton-SFC partition of cells into n_parts contiguous chunks.

    weights: optional per-cell cost (defaults to 1); chunk boundaries are
    placed on the cumulative weight so variable-resolution meshes balance.
    Returns int array (nCells,) of part ids.
    """
    order = np.argsort(_morton_key(_cell_points(mesh)), kind="stable")
    w = np.ones(mesh.nCells) if weights is None else np.asarray(weights)
    cw = np.cumsum(w[order])
    total = cw[-1]
    part_of_sorted = np.minimum(
        (cw / total * n_parts - 1e-12).astype(np.int64), n_parts - 1)
    part = np.empty(mesh.nCells, dtype=np.int64)
    part[order] = part_of_sorted
    return part


def read_metis_partition(path: str, n_cells: int):
    """Read a reference-format partition file: one part id per line
    (ref: mpas_block_decomp.F:101-120)."""
    part = np.loadtxt(path, dtype=np.int64)
    if part.shape[0] != n_cells:
        raise ValueError(
            f"partition file has {part.shape[0]} entries, mesh has {n_cells}")
    return part


def partition_stats(mesh, part):
    """Cut edges and balance of a partition."""
    coe = _np(mesh.cellsOnEdge)
    interior = _np(mesh.boundaryEdge) == 0
    cut = np.sum(part[coe[interior, 0]] != part[coe[interior, 1]])
    counts = np.bincount(part)
    return {"cut_edges": int(cut), "max_cells": int(counts.max()),
            "min_cells": int(counts.min()),
            "imbalance": float(counts.max() / counts.mean())}


def hierarchical_sfc_partition(mesh, n_hosts: int, chips_per_host: int,
                               weights=None):
    """Two-level SFC partition for several hosts: cells -> hosts, then
    each host's cells -> its devices. Device ids are host-major (device =
    host * chips_per_host + chip), the rank order of runner.ShardGroup, so
    the heavy nearest-neighbour halo traffic stays within a host and only
    the coarse host boundaries cross between hosts (the reference's
    analogue is the multi-block-per-rank proc map of
    mpas_block_decomp.F:643 mpas_build_block_proc_list).

    Returns int array (nCells,) of device ids in [0, n_hosts*chips_per_host).
    """
    host = sfc_partition(mesh, n_hosts, weights=weights)
    part = np.empty(mesh.nCells, dtype=np.int64)
    w = np.ones(mesh.nCells) if weights is None else np.asarray(weights)
    key = _morton_key(_cell_points(mesh))
    for h in range(n_hosts):
        sel = np.where(host == h)[0]
        order = sel[np.argsort(key[sel], kind="stable")]
        cw = np.cumsum(w[order])
        chip = np.minimum((cw / cw[-1] * chips_per_host - 1e-12)
                          .astype(np.int64), chips_per_host - 1)
        part[order] = h * chips_per_host + chip
    return part


def inter_host_edge_cut(mesh, part, n_hosts: int, chips_per_host: int):
    """Count mesh edges whose two cells live on different hosts (the
    traffic that crosses between hosts) against the total cut (all
    inter-device edges). Returns (inter_host_cut, total_cut)."""
    coe = _np(mesh.cellsOnEdge)
    interior = _np(mesh.boundaryEdge) == 0
    p1, p2 = part[coe[:, 0]], part[coe[:, 1]]
    cut = interior & (p1 != p2)
    h1, h2 = p1 // chips_per_host, p2 // chips_per_host
    dcn = cut & (h1 != h2)
    return int(dcn.sum()), int(cut.sum())
