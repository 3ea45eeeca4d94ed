"""The frozen mesh generator, whose loops are array operations, gives the
mesh that its loop-by-loop form gave, bit for bit: the SHA-256 of every
array and of the static fields (__meta__) of the file that meshfile.save
writes for icosahedral_mesh(n, 4), n = 8, 16, 32 and 64, against the
digests recorded from the loop-by-loop generator (mesh_digests.json).
n = 64 is the 40,962-cell mesh that both configurations read."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import meshfile
from benchmark.reference.mesh.sphere import icosahedral_mesh

DIGESTS = json.loads(Path(__file__).with_name("mesh_digests.json")
                     .read_text())


def file_digests(path):
    """{array name: sha256 of its dtype, shape and bytes; "__meta__": sha256
    of the static fields' JSON} of a mesh file."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            if k == "__meta__":
                out[k] = hashlib.sha256(str(z[k]).encode()).hexdigest()
                continue
            a = np.ascontiguousarray(z[k])
            h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
            out[k] = h.hexdigest()
    return out


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_the_mesh_file_is_the_loops_bit_for_bit(n, tmp_path):
    path = tmp_path / f"icos{n}_l4.npz"
    meshfile.save(icosahedral_mesh(n, 4), path)
    got, want = file_digests(path), DIGESTS[str(n)]
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []
