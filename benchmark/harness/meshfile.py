"""The mesh file both sides read: the benchmark builds the mesh with its
frozen copy of the mesh generator (benchmark/reference/mesh) once per
checkout and keeps it under benchmark/.cache/mesh in the port's mesh-cache
format (mpas_tpu_torch/mesh/cache.py: every tensor field as an array, the
static fields as JSON under __meta__), as a run of MPAS reads a grid file.
The program reads it with its own loader; the reference with its own."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from benchmark.harness.common import CACHE_DIR


def mesh_path(params):
    """The mesh file of a configuration's `mesh` entry."""
    m = params["mesh"]
    return icosahedral_mesh_file(m["n"], m["lloyd_iters"])


def icosahedral_mesh_file(n: int, lloyd_iters: int):
    """Path of the icosahedral SCVT mesh with 10 n^2 + 2 cells (unit
    sphere), built and written on first use."""
    path = CACHE_DIR / "mesh" / f"icos{n}_l{lloyd_iters}.npz"
    if not path.exists():
        from benchmark.reference.mesh.sphere import icosahedral_mesh
        save(icosahedral_mesh(n, lloyd_iters), path)
    return path


def save(mesh, path):
    arrays, meta = {}, {}
    for f in dataclasses.fields(mesh):
        v = getattr(mesh, f.name)
        if isinstance(v, torch.Tensor):
            arrays[f.name] = v.detach().cpu().numpy()
        else:
            meta[f.name] = v
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(path.stem + ".partial.npz")
    np.savez(part, __meta__=json.dumps(meta), **arrays)
    os.replace(part, path)


def load_reference(path):
    """The mesh as the reference's Mesh."""
    from benchmark.reference.mesh.mesh import Mesh
    with np.load(path) as z:
        meta = json.loads(str(z["__meta__"]))
        kw = {k: torch.from_numpy(z[k]) for k in z.files if k != "__meta__"}
    return Mesh(**meta, **kw)
