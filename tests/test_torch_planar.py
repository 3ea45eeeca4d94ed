"""Planar meshes and the planar grid setup of the PyTorch port against the
JAX package.

The port's periodic, channel and box hex meshes must equal the
reference's bit for bit (same numpy operations in the same order; integer
tables exactly), and the planar branches of the atmosphere grid setup must
give the reference's arrays to 1e-13 relative (the bound of
tests/test_torch_setup.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import setup as jsetup
from mpas_tpu.mesh import planar as jplanar
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere import setup as tsetup
from mpas_tpu_torch.mesh import planar as tplanar

torch.set_num_threads(1)

REL = 1e-13


def assert_mesh_equal(port, ref):
    for f in dataclasses.fields(port):
        v, r = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(v, torch.Tensor):
            r = np.asarray(r)
            a = v.numpy()
            assert a.shape == r.shape, f.name
            if np.issubdtype(r.dtype, np.integer):
                assert a.dtype == np.int64 and np.array_equal(a, r), f.name
            else:
                assert a.dtype == r.dtype, f.name
                assert np.array_equal(a, r), f.name
        else:
            assert v == r, (f.name, v, r)


def assert_close(got, ref, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert np.abs(got - ref).max() <= REL * scale, name


MESHES = [("planar_hex_mesh", (8, 8, 1000.0)),
          ("planar_hex_mesh", (12, 12, 2000.0)),
          ("channel_hex_mesh", (8, 10, 1000.0)),
          ("box_hex_mesh", (8, 10, 1000.0))]


@pytest.mark.parametrize("make,args", MESHES)
def test_mesh_matches_reference_bit_for_bit(make, args):
    port = getattr(tplanar, make)(*args)
    ref = getattr(jplanar, make)(*args)
    assert port.nCells == ref.nCells and not port.on_sphere
    assert_mesh_equal(port, ref)


def test_periods_and_walls():
    periodic = tplanar.planar_hex_mesh(12, 12, 2000.0)
    assert periodic.x_period == 24000.0
    assert periodic.y_period == pytest.approx(12 * 2000.0 * np.sqrt(3) / 2)
    assert float(periodic.boundaryEdge.sum()) == 0.0
    assert bool((periodic.nEdgesOnCell == 6).all())
    channel = tplanar.channel_hex_mesh(8, 10, 1000.0)
    assert channel.nCells == 8 * 8 and channel.y_period == 0.0
    assert float(channel.boundaryEdge.sum()) > 0.0
    with pytest.raises(ValueError):
        tplanar.hex_lattice_points(8, 7, 1000.0)


@pytest.fixture(scope="module")
def meshes():
    """(port mesh, reference mesh) of the 12x12 periodic plane."""
    return (tplanar.planar_hex_mesh(12, 12, 2000.0),
            jplanar.planar_hex_mesh(12, 12, 2000.0))


def test_tangent_coords_wrap_the_periods(meshes):
    port, ref = meshes
    cxyz = np.stack([ref.xCell, ref.yCell, ref.zCell], -1)
    coc = np.asarray(ref.cellsOnCell)
    got = tsetup._tangent_coords(port, cxyz[:, None, :], cxyz[coc])
    want = jsetup._tangent_coords(ref, cxyz[:, None, :], cxyz[coc])
    for g, w in zip(got, want):
        assert_close(g, w)
    # every neighbour sits one cell spacing away, across the seams too
    dist = np.hypot(*got)
    assert np.allclose(dist, 2000.0, rtol=1e-12)


@pytest.mark.parametrize("fn", [
    "build_cell_fit_matrices", "_edge_direction_weights",
    "build_deformation_weights", "build_reconstruct_weights",
    "build_adv_cell_tensors"])
def test_planar_grid_setup(meshes, fn):
    port, ref = meshes
    got = getattr(tsetup, fn)(port)
    want = getattr(jsetup, fn)(ref)
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"{fn}[{i}]")


def test_reconstruct_weights_recover_uniform_wind(meshes):
    port, _ = meshes
    wz, wm = tsetup.build_reconstruct_weights(port)
    ang = port.angleEdge.numpy()
    u = 3.0 * np.cos(ang) - 2.0 * np.sin(ang)      # V = (3, -2) m/s
    ue = u[port.edgesOnCell.numpy()]
    assert np.allclose((wz * ue).sum(1), 3.0, atol=1e-12)
    assert np.allclose((wm * ue).sum(1), -2.0, atol=1e-12)


@pytest.mark.parametrize("nz,stretch", [(16, 1.5), (40, 1.0)])
def test_build_vertical_grid(nz, stretch):
    """The port's uniform grid is the reference's uniform=True grid; the
    supercell takes (40, 1.0) with zt = 20 km."""
    got, gsh, gah = tsetup.build_vertical_grid(nz, zt=20000.0,
                                               stretch=stretch)
    ref, rsh, rah = jsetup.build_vertical_grid(nz, zt=20000.0,
                                               stretch=stretch, uniform=True)
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if isinstance(v, torch.Tensor):
            assert_close(v, getattr(ref, f.name), f.name)
        else:
            assert v == getattr(ref, f.name), f.name
    assert_close(gsh, rsh)
    assert_close(gah, rah)


def test_mesh_round_trips_through_convert(meshes):
    port, ref = meshes
    d = {f.name: (np.asarray(getattr(ref, f.name))
                  if isinstance(getattr(port, f.name), torch.Tensor)
                  else getattr(ref, f.name))
         for f in dataclasses.fields(port)}
    assert_mesh_equal(convert.mesh_from_arrays(d), ref)
