"""Host setup of the PyTorch port against the JAX package.

The port's mesh construction, grid setup and JW initial state must give the
reference's arrays (642-cell mesh, 10 levels, float64), and convert.py
must carry the reference's containers across unchanged.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere.config import AtmConfig as JaxAtmConfig
from mpas_tpu.cores.atmosphere.init_jw import init_jw as jax_init_jw
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh

torch.set_num_threads(1)

CFG = dict(config_nvertlevels=10, config_len_disp=960000.0,
           config_dt=1200.0)
# same algorithm and operation order: equal except where numpy/scipy round
# differently, which the reference's own tolerances put at 1e-13 relative
REL = 1e-13


def flatten(obj):
    """A reference (flax) container -> nested dict of numpy arrays/statics."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = flatten(v)
        elif v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def assert_matches(port, ref, path=""):
    """Every field of the port container equals the reference's field."""
    for f in dataclasses.fields(port):
        v = getattr(port, f.name)
        r = ref[f.name]
        name = path + f.name
        if dataclasses.is_dataclass(v):
            assert_matches(v, r, name + ".")
        elif isinstance(v, torch.Tensor):
            a = v.numpy()
            assert a.shape == r.shape, name
            scale = max(float(np.abs(r).max()) if r.size else 0.0, 1e-300)
            assert np.abs(a - r).max(initial=0.0) <= REL * scale, name
        else:
            assert v == r, (name, v, r)


@pytest.fixture(scope="module")
def port_mesh():
    return icosahedral_mesh(8, lloyd_iters=2)


@pytest.fixture(scope="module")
def jax_setup(sphere_mesh_small):
    return jax_init_jw(sphere_mesh_small, JaxAtmConfig(**CFG), case=2)


def test_icosahedral_mesh_matches_reference(port_mesh, sphere_mesh_small):
    assert port_mesh.nCells == 642
    assert_matches(port_mesh, flatten(sphere_mesh_small))


@pytest.mark.parametrize("part", ["grid", "state", "diag"])
def test_init_jw_matches_reference(port_mesh, jax_setup, part):
    port = dict(zip(("grid", "state", "diag"),
                    init_jw(port_mesh, AtmConfig(**CFG), case=2)))
    ref = dict(zip(("grid", "state", "diag"), jax_setup))
    assert_matches(port[part], flatten(ref[part]))


@pytest.mark.parametrize("part", ["grid", "state", "diag"])
def test_convert_round_trips(jax_setup, part):
    build = {"grid": convert.grid_from_arrays,
             "state": convert.state_from_arrays,
             "diag": convert.diag_from_arrays}[part]
    ref = flatten(jax_setup[("grid", "state", "diag").index(part)])
    port = build(ref)
    assert_matches(port, ref)
    back = convert.to_arrays(port)
    assert_matches(build(back), ref)


def test_to_moves_floats_and_indices(jax_setup):
    grid = convert.grid_from_arrays(flatten(jax_setup[0]))
    g32 = grid.to(torch.device("cpu"), torch.float32)
    assert g32.zz.dtype == torch.float32
    assert g32.mesh.areaCell.dtype == torch.float32
    assert g32.mesh.edgesOnCell.dtype == torch.int64
    assert g32.vert.nz == grid.vert.nz and g32.adv_beta == grid.adv_beta
    assert torch.equal(g32.mesh.cellsOnEdge, grid.mesh.cellsOnEdge)


def test_scaled_rejects_planar(port_mesh):
    with pytest.raises(ValueError):
        dataclasses.replace(port_mesh, on_sphere=False).scaled(2.0)
