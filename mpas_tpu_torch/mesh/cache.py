"""Disk cache of built meshes (port of mpas_tpu/mesh/cache.py): the host
build is the slow part of a run's setup (20-40 s for the 40,962-cell
icosahedral mesh).

The port keeps its own directory, $MPAS_TPU_TORCH_CACHE or
~/.cache/mpas_tpu_torch, and never reads the reference package's files,
whose layout is that of its own Mesh. A file holds every tensor field of
the port's Mesh as it was built (same dtypes) and the static fields as
JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from mpas_tpu_torch.mesh.mesh import Mesh


def cache_dir():
    d = os.environ.get("MPAS_TPU_TORCH_CACHE",
                       os.path.expanduser("~/.cache/mpas_tpu_torch"))
    os.makedirs(d, exist_ok=True)
    return d


def save_mesh(mesh: Mesh, path: str):
    arrays, meta = {}, {}
    for f in dataclasses.fields(mesh):
        v = getattr(mesh, f.name)
        if isinstance(v, torch.Tensor):
            arrays[f.name] = v.detach().cpu().numpy()
        else:
            meta[f.name] = v
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_mesh(path: str) -> Mesh:
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        kw = {k: torch.from_numpy(z[k]) for k in z.files if k != "__meta__"}
    return Mesh(**meta, **kw)


def cached(name: str, builder):
    """Build-or-load a mesh by cache key. The file is written under another
    name and renamed, so that a process never reads half of one."""
    path = os.path.join(cache_dir(), name + ".npz")
    if os.path.exists(path):
        return load_mesh(path)
    mesh = builder()
    tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
    save_mesh(mesh, tmp)
    os.replace(tmp, path)
    return mesh
