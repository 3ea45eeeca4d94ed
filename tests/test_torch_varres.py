"""Variable-resolution meshes and the varres JW path of the PyTorch port
against the JAX package.

The port's variable_res_mesh must equal the reference's bit for bit (same
seeded sampling, Lloyd iteration and vertex merge; integer tables
exactly), compute_mesh_scaling must follow the reference formula, init_jw
with config_h_ScaleWithMesh on a reduced-radius planet must give the
reference's arrays to 1e-13 relative (tests/test_torch_setup.py), and a
few steps of the dycore on that mesh must match the reference's run_steps
to 1e-9 x max|ref| (tests/test_torch_supercell.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import time_integration as jti
from mpas_tpu.cores.atmosphere.config import AtmConfig as JaxAtmConfig
from mpas_tpu.cores.atmosphere.init_jw import init_jw as jax_init_jw
from mpas_tpu.mesh import build as jbuild
from mpas_tpu.mesh import sphere as jsphere
from mpas_tpu.mesh import varres as jvarres
from mpas_tpu_torch import convert, kernels
from mpas_tpu_torch.constants import a as EARTH_RADIUS
from mpas_tpu_torch.cores.atmosphere import time_integration as tti
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
from mpas_tpu_torch.mesh import build as tbuild
from mpas_tpu_torch.mesh import sphere as tsphere
from mpas_tpu_torch.mesh import varres as tvarres

torch.set_num_threads(1)

N_POINTS, ITERATIONS, SEED = 1200, 20, 0
RADIUS = EARTH_RADIUS / 4.0
# the fine cells of this small mesh are ~65 km wide at a quarter radius
CFG = dict(config_nvertlevels=10, config_len_disp=60000.0, config_dt=300.0,
           config_h_ScaleWithMesh=True)
DT = 300.0
N_STEPS = 3
REL_INIT = 1e-13
REL_SLICE = 1e-9


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


def assert_mesh_equal(port, ref):
    for f in dataclasses.fields(port):
        v, r = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(v, torch.Tensor):
            r = np.asarray(r)
            a = v.numpy()
            assert a.shape == r.shape, f.name
            if np.issubdtype(r.dtype, np.integer):
                assert a.dtype == np.int64, f.name
            else:
                assert a.dtype == r.dtype, f.name
            assert np.array_equal(a, r), f.name
        else:
            assert v == r, (f.name, v, r)


def assert_matches(port, ref, rel, path=""):
    """Every field of the port container is within rel x max|ref| of the
    reference's field."""
    for f in dataclasses.fields(port):
        v, r = getattr(port, f.name), ref[f.name]
        name = path + f.name
        if dataclasses.is_dataclass(v):
            assert_matches(v, r, rel, name + ".")
        elif isinstance(v, torch.Tensor):
            a = v.numpy()
            assert a.shape == r.shape, name
            scale = max(float(np.abs(r).max()) if r.size else 0.0, 1e-300)
            assert np.abs(a - r).max(initial=0.0) <= rel * scale, name
        else:
            assert v == r, (name, v, r)


@pytest.fixture(scope="module")
def meshes():
    """(port mesh, reference mesh) of the small 4:1 refined SCVT."""
    return (tvarres.variable_res_mesh(N_POINTS, iterations=ITERATIONS,
                                      seed=SEED),
            jvarres.variable_res_mesh(N_POINTS, iterations=ITERATIONS,
                                      seed=SEED))


def test_variable_res_mesh_matches_reference_bit_for_bit(meshes):
    port, ref = meshes
    assert port.nCells == N_POINTS and port.maxEdges == 8
    assert_mesh_equal(port, ref)


@pytest.mark.parametrize("seed", [0, 3])
def test_sampling_and_lloyd_match_reference(seed):
    rho_t = tvarres.circular_refinement_density(0.3, 1.2, 0.4, 0.1, 3.0)
    rho_j = jvarres.circular_refinement_density(0.3, 1.2, 0.4, 0.1, 3.0)
    pts = tvarres.sample_points_by_density(300, rho_t, seed=seed)
    ref = jvarres.sample_points_by_density(300, rho_j, seed=seed)
    assert np.array_equal(pts, ref)
    assert np.array_equal(rho_t(pts), rho_j(ref))
    assert np.array_equal(tvarres.weighted_lloyd(pts, rho_t, 5),
                          jvarres.weighted_lloyd(ref, rho_j, 5))


@pytest.mark.parametrize("merge_tol", [0.0, 0.2])
def test_sphere_voronoi_merge_matches_reference(merge_tol):
    rho = tvarres.circular_refinement_density(0.5, 1.5, 0.5, 0.2)
    pts = tvarres.weighted_lloyd(
        tvarres.sample_points_by_density(400, rho, seed=1), rho, 3)
    port = tsphere.sphere_voronoi_mesh(pts, merge_tol=merge_tol)
    assert_mesh_equal(port, jsphere.sphere_voronoi_mesh(pts,
                                                        merge_tol=merge_tol))


def test_merge_removes_the_shortest_edges(meshes):
    """merge_tol folds the near-zero dvEdge edges of near-cocircular
    generators into one vertex; without it they stay."""
    port, _ = meshes
    rho = tvarres.circular_refinement_density(
        np.pi / 6.0, np.pi / 2.0, np.pi / 6.0, np.pi / 18.0)
    pts = tvarres.weighted_lloyd(tvarres.sample_points_by_density(
        N_POINTS, rho, seed=SEED), rho, ITERATIONS)
    raw = tsphere.sphere_voronoi_mesh(pts)
    assert port.nVertices < raw.nVertices
    assert float(port.dvEdge.min()) > float(raw.dvEdge.min())
    assert port.vertexDegree > raw.vertexDegree == 3


@pytest.mark.parametrize("scale_with_mesh", [True, False])
def test_compute_mesh_scaling(meshes, scale_with_mesh):
    port, ref = meshes
    got = tbuild.compute_mesh_scaling(port, scale_with_mesh)
    want = jbuild.compute_mesh_scaling(ref, scale_with_mesh)
    rho = port.meshDensity.numpy()
    coe = port.cellsOnEdge.numpy()
    rho_e = 0.5 * (rho[coe[:, 0]] + rho[coe[:, 1]])
    formula = (rho_e ** -0.25, rho_e ** -0.75) if scale_with_mesh \
        else (np.ones(port.nEdges), np.ones(port.nEdges))
    for name, f in zip(("meshScalingDel2", "meshScalingDel4"), formula):
        v = getattr(got, name).numpy()
        assert np.array_equal(v, np.asarray(getattr(want, name))), name
        assert np.array_equal(v, f), name
    if scale_with_mesh:
        # 4:1 refinement: del2 scale 1 in the fine cap, near 4 outside
        del2 = got.meshScalingDel2.numpy()
        assert 1.0 <= del2.min() and 3.9 < del2.max() <= 4.0 + 1e-12


@pytest.fixture(scope="module")
def jax_setup(meshes):
    cfg = JaxAtmConfig(**CFG)
    return cfg, jax_init_jw(meshes[1], cfg, case=2, radius=RADIUS)


@pytest.mark.parametrize("part", ["grid", "state", "diag"])
def test_init_jw_scale_with_mesh_matches_reference(meshes, jax_setup, part):
    port = dict(zip(("grid", "state", "diag"),
                    init_jw(meshes[0], AtmConfig(**CFG), case=2,
                            radius=RADIUS)))
    ref = dict(zip(("grid", "state", "diag"), jax_setup[1]))
    assert_matches(port[part], flatten(ref[part]), REL_INIT)
    if part == "grid":
        mesh = port["grid"].mesh
        assert mesh.sphere_radius == RADIUS
        assert float(mesh.meshScalingDel2.max()) > 3.9


@pytest.fixture(scope="module")
def slice_runs(jax_setup):
    jcfg, (jgrid, jstate, jdiag) = jax_setup
    # a smooth passive scalar, so that transport moves something
    lat = np.asarray(jgrid.mesh.latCell)[:, None, None]
    lon = np.asarray(jgrid.mesh.lonCell)[:, None, None]
    jstate = dataclasses.replace(
        jstate, scalars=(1.0 + np.sin(2.0 * lon) * np.cos(lat))
        * np.ones(np.shape(jstate.scalars)))
    gj = jax.tree.map(jnp.asarray, jgrid)
    carry0 = jti.init_carry(gj, jcfg, jax.tree.map(jnp.asarray, jstate),
                            jax.tree.map(jnp.asarray, jdiag), DT)
    ref = flatten(jti.run_steps(gj, jcfg, carry0, DT, N_STEPS))
    grid = convert.grid_from_arrays(flatten(jgrid))
    start = convert.carry_from_arrays(flatten(carry0))
    kernels.reset_launch_counts()
    out = tti.run_steps(grid, AtmConfig(**CFG), start, DT, N_STEPS)
    return grid, start, out, ref, dict(kernels.launch_counts)


@pytest.mark.parametrize("field", ["u", "w", "theta_m", "rho_zz", "scalars"])
def test_varres_steps_match_reference(slice_runs, field):
    _, _, out, ref, _ = slice_runs
    want = ref["state"][field]
    assert float(np.abs(want).max()) > 0.0
    got = getattr(out.state, field).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_SLICE * np.abs(want).max(), field


def test_varres_steps_conserve_dry_mass(slice_runs):
    grid, start, out, _, counts = slice_runs
    area = grid.mesh.areaCell[:, None] * grid.vert.dzw[None, :]
    m0 = float((start.state.rho_zz * area).sum())
    m1 = float((out.state.rho_zz * area).sum())
    assert abs(m1 - m0) <= 1e-12 * m0
    # CPU tensors take the plain versions: no kernel launch is counted
    assert counts == {"acoustic_cell_update": 0, "tinydot": 0,
                      "vmix_solve": 0}
