"""Sharded checkpoint I/O: per-group restart shards (port of
mpas_tpu/io/sharded.py).

The reference aggregates parallel I/O through PIO io tasks and a stride
(mpas_framework.F:89-104) and the alltoall transposes between the I/O
and compute decompositions (mpas_dmpar.F:2260-4665). Here each file
covers a group of shards (group_size, the io-task stride) and holds only
owned entities with their global indices, so any reader reassembles the
global fields by indexed assignment. Format, shared with the JAX
package: one npz per group (`restart_shard_GGGG.npz`, `__idx_<kind>__`
index arrays beside the fields) and a json manifest.

Host-side: fields are stacked (P, n_local, ...) arrays or CPU tensors on
the layout of a parallel.layout.ShardedMesh (group.stack() gives them
from a run); read_sharded returns global numpy arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mpas_tpu_torch.parallel.partition import _np

_KIND_SLOTS = {"cell": "cell_global", "edge": "edge_global",
               "vertex": "vertex_global"}
_KIND_MASKS = {"cell": "owned_cell_mask", "edge": "owned_edge_mask",
               "vertex": "owned_vertex_mask"}


def write_sharded(dirpath: str, smesh, fields: dict, kinds: dict,
                  n_global: dict, group_size: int = 1, attrs: dict = None):
    """Write stacked-local fields as per-group restart shards.

    fields: {name: (P, n_local, ...)}; kinds: {name: 'cell' | 'edge' |
    'vertex'}; n_global: {'cell': nCells, ...}. group_size shards go into
    one file (P files at 1, P / g at g)."""
    os.makedirs(dirpath, exist_ok=True)
    P = smesh.n_parts
    manifest = {"n_parts": P, "group_size": group_size,
                "n_global": dict(n_global), "kinds": dict(kinds),
                "files": [], "attrs": attrs or {}}
    slots = {k: _np(getattr(smesh, _KIND_SLOTS[k]))
             for k in set(kinds.values())}
    owned = {k: _np(getattr(smesh, _KIND_MASKS[k])) > 0
             for k in set(kinds.values())}
    for g0 in range(0, P, group_size):
        members = range(g0, min(g0 + group_size, P))
        payload = {f"__idx_{kind}__": np.concatenate(
            [slots[kind][p][owned[kind][p]] for p in members]).astype(
                np.int64) for kind in slots}
        for name, arr in fields.items():
            mask = owned[kinds[name]]
            arr = _np(arr)
            payload[name] = np.concatenate([arr[p][mask[p]]
                                            for p in members], axis=0)
        fname = f"restart_shard_{g0:04d}.npz"
        np.savez_compressed(os.path.join(dirpath, fname), **payload)
        manifest["files"].append(fname)
    with open(os.path.join(dirpath, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def read_sharded(dirpath: str) -> tuple:
    """Reassemble the global fields of a sharded restart directory.
    Returns ({name: (n_global, ...) numpy}, attrs)."""
    with open(os.path.join(dirpath, "manifest.json")) as f:
        manifest = json.load(f)
    fields = {}
    for fname in manifest["files"]:
        with np.load(os.path.join(dirpath, fname)) as z:
            idx = {k[6:-2]: z[k] for k in z.files if k.startswith("__idx_")}
            for name in z.files:
                if name.startswith("__idx_"):
                    continue
                kind = manifest["kinds"][name]
                data = z[name]
                if name not in fields:
                    shape = (manifest["n_global"][kind],) + data.shape[1:]
                    fields[name] = np.zeros(shape, dtype=data.dtype)
                fields[name][idx[kind]] = data
    return fields, manifest["attrs"]
