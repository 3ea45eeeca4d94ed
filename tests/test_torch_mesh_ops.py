"""The port's mesh renumbering (mesh/reorder.py) and the operator modules
ops/spline.py, ops/tensor.py and ops/rbf.py, against the JAX package.

- sfc_reorder_mesh on icosahedral_mesh(8, lloyd_iters=2): the same
  permutations as the reference's, exactly, and every field of the
  reordered mesh bit for bit; apply_permutations under seeded random
  permutations the same; JW (642 cells, 6 levels, 2 steps) in the
  generator's numbering, a random one and the Morton renumbering of that,
  each un-permuted equal to the generator's at 5e-13 (the reference's own
  bound: its IC builders reduce globally in numbering order);
- spline and tensor: every function at 1e-11 x max, float64, seeded
  inputs, on a doubly periodic plane and the 642-cell sphere;
- rbf: every routine, batched over destinations in one solve, against the
  reference's (its vmapped or single-point) calls. The interpolation
  matrices are ill-conditioned (their largest condition numbers on these
  inputs, numpy.linalg.cond, measured: 5.9e2 for the 2-D scalar systems,
  3.3e5 for the 3-D scalar ones, 2.8e2 for the vector ones, 21 for
  reconstruct_init's planar-projected stencils; RBF_CONDITION bounds
  them), so the coefficients carry the condition number times the
  rounding of two LU orders; the test holds what the coefficients
  reconstruct (the interpolated value, its derivatives, the reconstructed
  vectors) at RBF_REL = 1e-10 x max (the worst measured: 9.7e-13, the
  planar Neumann set).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.mesh import reorder as jreorder
from mpas_tpu.mesh.planar import planar_hex_mesh as j_planar_hex_mesh
from mpas_tpu.mesh.sphere import icosahedral_mesh as j_icosahedral_mesh
from mpas_tpu.ops import rbf as jrbf
from mpas_tpu.ops import spline as jspline
from mpas_tpu.ops import tensor as jtensor
from mpas_tpu_torch import convert
from mpas_tpu_torch.mesh import reorder as treorder
from mpas_tpu_torch.ops import rbf as trbf
from mpas_tpu_torch.ops import spline as tspline
from mpas_tpu_torch.ops import tensor as ttensor
from tests.test_torch_ocean import assert_close, flatten

torch.set_num_threads(1)

REL = 1e-11
RBF_REL = 1e-10
# bounds on the condition number of each family's matrices on the inputs
# below (numpy.linalg.cond; measured 5.9e2, 3.3e5, 2.8e2 and 21): RBF_REL
# holds values, not coefficients, because of these
RBF_CONDITION = {"loc_2d": 1e3, "func_3d": 1e6, "vector": 1e3,
                 "reconstruct": 1e2}


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


@pytest.fixture(scope="module")
def sphere():
    jm = j_icosahedral_mesh(8, lloyd_iters=2)
    return jm, convert.mesh_from_arrays(flatten(jm))


@pytest.fixture(scope="module")
def plane():
    jm = j_planar_hex_mesh(10, 10, 1000.0)
    return jm, convert.mesh_from_arrays(flatten(jm))


# ---------------------------------------------------------------- reorder

def mesh_equal(tm, jm):
    for f in dataclasses.fields(tm):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(a, torch.Tensor):
            assert np.array_equal(a.numpy(), np.asarray(b)), f.name
            assert a.dtype == convert.mesh_from_arrays(
                flatten(jm)).__getattribute__(f.name).dtype, f.name
        else:
            assert a == b, f.name


def test_sfc_reorder_matches_the_reference(sphere):
    jm, tm = sphere
    jr, jp = jreorder.sfc_reorder_mesh(jm)
    tr, tp = treorder.sfc_reorder_mesh(tm)
    for k in ("cell", "edge", "vertex"):
        assert np.array_equal(tp[k], jp[k]), k
    mesh_equal(tr, jr)
    tr.validate()


def random_perms(mesh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.permutation(mesh.nCells), rng.permutation(mesh.nEdges),
            rng.permutation(mesh.nVertices))


def test_apply_permutations_matches_the_reference(sphere):
    jm, tm = sphere
    perms = random_perms(jm)
    js = jreorder.apply_permutations(jm, *perms)
    ts = treorder.apply_permutations(tm, *perms)
    mesh_equal(ts, js)
    # Morton renumbering of the shuffled mesh, in both
    jn, jp = jreorder.sfc_reorder_mesh(js)
    tn, tp = treorder.sfc_reorder_mesh(ts)
    for k in ("cell", "edge", "vertex"):
        assert np.array_equal(tp[k], jp[k]), k
    mesh_equal(tn, jn)


def test_reorder_restores_locality(sphere):
    _jm, tm = sphere
    shuffled = treorder.apply_permutations(tm, *random_perms(tm))
    normalized, _ = treorder.sfc_reorder_mesh(shuffled)

    def span(m):
        coc = m.cellsOnCell.numpy()
        mask = m.edgesOnCellMask.numpy() > 0
        return np.abs(coc - np.arange(m.nCells)[:, None])[mask].mean()
    assert span(shuffled) > 0.25 * tm.nCells
    assert span(normalized) < 0.2 * span(shuffled)


def unpermute(obj, perms, mesh):
    """A container's cell- and edge-rowed tensors back in the original
    numbering (old i = new perms[i])."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            if v.shape[0] == mesh.nCells:
                v = v[torch.from_numpy(perms["cell"])]
            elif v.shape[0] == mesh.nEdges:
                v = v[torch.from_numpy(perms["edge"])]
        out[f.name] = v
    return dataclasses.replace(obj, **out)


def test_jw_in_three_numberings(sphere):
    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, run_steps)
    _jm, tm = sphere
    cfg = AtmConfig(config_nvertlevels=6, config_dt=4000.0,
                    config_len_disp=960000.0)
    pc, pe, pv = random_perms(tm, seed=3)
    shuffled = treorder.apply_permutations(tm, pc, pe, pv)
    normalized, p2 = treorder.sfc_reorder_mesh(shuffled)
    composed = {"cell": p2["cell"][pc], "edge": p2["edge"][pe]}

    def traj(m):
        grid, state, diag = init_jw(m, cfg, case=2)
        carry = init_carry(grid, cfg, state, diag, cfg.config_dt)
        return run_steps(grid, cfg, carry, cfg.config_dt, 2).state

    ref = traj(tm)
    for mesh, perms in ((shuffled, {"cell": pc, "edge": pe}),
                        (normalized, composed)):
        got = unpermute(traj(mesh), perms, tm)
        for k in ("u", "w", "theta_m", "rho_zz"):
            a, b = getattr(got, k).numpy(), getattr(ref, k).numpy()
            np.testing.assert_allclose(a, b, rtol=5e-13,
                                       atol=5e-13 * np.abs(b).max(),
                                       err_msg=k)


# ----------------------------------------------------------------- spline

def test_cubic_spline():
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.uniform(0.2, 1.0, 12))
    y = rng.normal(size=(4, 3, 12))
    xb = np.sort(rng.uniform(0.0, 1.0, (4, 3, 12)), -1) * 10.0 \
        + np.arange(12) * 1.0
    assert_close(tspline.cubic_spline_coefficients(t(x), t(y)),
                 jspline.cubic_spline_coefficients(j(x), j(y)), "y2", REL)
    assert_close(tspline.cubic_spline_coefficients(t(xb), t(y)),
                 jspline.cubic_spline_coefficients(j(xb), j(y)), "y2 b",
                 REL)
    y2 = np.asarray(jspline.cubic_spline_coefficients(j(x), j(y)))
    xe = np.concatenate([rng.uniform(x[0] - 0.5, x[-1] + 0.5, 17),
                         x[[0, 5, 11]]])
    assert_close(tspline.interpolate_cubic_spline(t(x), t(y), t(y2), t(xe)),
                 jspline.interpolate_cubic_spline(j(x), j(y), j(y2), j(xe)),
                 "spline", REL)
    assert_close(tspline.interpolate_linear(t(x), t(y[0, 0]), t(xe)),
                 jspline.interpolate_linear(j(x), j(y[0, 0]), j(xe)),
                 "linear", REL)


# ----------------------------------------------------------------- tensor

def test_sym6_conversions():
    rng = np.random.default_rng(2)
    t6 = rng.normal(size=(5, 4, 6))
    m = rng.normal(size=(5, 4, 3, 3))
    assert_close(ttensor.sym6_to_3x3(t(t6)), jtensor.sym6_to_3x3(j(t6)),
                 "3x3", 0.0)
    assert_close(ttensor.matrix_3x3_to_sym6(t(m)),
                 jtensor.matrix_3x3_to_sym6(j(m)), "sym6", 0.0)


@pytest.mark.parametrize("where", ["plane", "sphere"])
def test_tensor_mesh_operations(where, plane, sphere):
    jm, tm = plane if where == "plane" else sphere
    en, et, ev = ttensor.edge_basis_vectors(tm)
    ref = jtensor.edge_basis_vectors(jm)
    assert_close((en, et, ev), ref, "basis", REL)
    rng = np.random.default_rng(4)
    nz = 3
    un = rng.normal(size=(jm.nEdges, nz))
    ut = rng.normal(size=(jm.nEdges, nz))
    o_t = ttensor.outer_product_edge(t(un), t(ut), en, et)
    o_j = jtensor.outer_product_edge(j(un), j(ut), *map(j, ref[:2]))
    assert_close(o_t, o_j, "outer", REL)
    assert_close(ttensor.strain_rate_r3_cell(tm, o_t),
                 jtensor.strain_rate_r3_cell(jm, o_j), "strain", REL)
    t6 = rng.normal(size=(jm.nEdges, nz, 6))
    assert_close(ttensor.divergence_of_tensor_r3_cell(tm, t(t6), en),
                 jtensor.divergence_of_tensor_r3_cell(jm, j(t6), j(ref[0])),
                 "div", REL)
    r2 = ttensor.tensor_edge_r3_to_2d(t(t6), en, et)
    assert_close(r2, jtensor.tensor_edge_r3_to_2d(j(t6), *map(j, ref[:2])),
                 "r3->2d", REL)
    t3 = rng.normal(size=(jm.nEdges, nz, 3))
    assert_close(ttensor.tensor_edge_2d_to_r3(t(t3), en, et),
                 jtensor.tensor_edge_2d_to_r3(j(t3), *map(j, ref[:2])),
                 "2d->r3", REL)


def test_lonlat_rotations(sphere):
    jm, tm = sphere
    rng = np.random.default_rng(5)
    lon, lat = np.asarray(jm.lonCell), np.asarray(jm.latCell)
    assert_close(ttensor.zonal_meridional_vectors(t(lon), t(lat)),
                 jtensor.zonal_meridional_vectors(j(lon), j(lat)), "zmv",
                 REL)
    t3 = rng.normal(size=(jm.nCells, 3))
    t6 = rng.normal(size=(jm.nCells, 6))
    m = rng.normal(size=(jm.nCells, 3, 3))
    for name, args in (("tensor_lonlat_to_r3", (t3,)),
                       ("tensor_r3_to_lonlat", (t6,)),
                       ("tensor_lonlatr_to_r3", (m,)),
                       ("tensor_r3_to_lonlatr", (m,))):
        assert_close(getattr(ttensor, name)(*map(t, args), t(lon), t(lat)),
                     getattr(jtensor, name)(*map(j, args), j(lon), j(lat)),
                     name, REL)


# -------------------------------------------------------------------- rbf

def value_close(got, ref, name, rel=RBF_REL):
    assert_close(got, np.asarray(ref), name, rel)


@pytest.fixture
def conds(monkeypatch):
    """The condition numbers of every system the port's rbf solves."""
    out = []
    solve = trbf._masked_solve

    def recording(matrix, rhs, valid):
        eye = torch.eye(matrix.shape[-1], dtype=matrix.dtype)
        m = torch.where(valid[..., :, None] & valid[..., None, :], matrix,
                        eye)
        out.append(float(np.linalg.cond(m.numpy()).max()))
        return solve(matrix, rhs, valid)
    monkeypatch.setattr(trbf, "_masked_solve", recording)
    return out


def test_rbf_kernel():
    r2 = np.linspace(0.0, 9.0, 31)
    assert_close(trbf.rbf_derivs(t(r2)), jrbf.rbf_derivs(j(r2)), "derivs",
                 REL)


@pytest.mark.parametrize("kind", ["const", "lin"])
def test_loc_2d_scalar(kind, conds):
    """Batched over 5 stencils in one solve; each against the reference's
    single-point call. The values and derivatives the coefficients
    reconstruct are held."""
    rng = np.random.default_rng(6)
    pts = rng.standard_normal((5, 12, 2))
    vals = np.sin(pts[..., 0]) + pts[..., 1] ** 2
    valid = np.ones((5, 12), bool)
    valid[2, 9:] = False                   # a padded stencil
    ep = rng.uniform(-0.5, 0.5, (5, 2))
    coeffs_t = getattr(trbf, f"loc_2d_scalar_{kind}_coeffs")(
        t(pts), t(vals), 0.8, valid=t(valid))
    ev_t = getattr(trbf, f"loc_2d_scalar_{kind}_eval_with_derivs")(
        coeffs_t, t(ep), t(pts), 0.8)
    for b in range(5):
        c = getattr(jrbf, f"loc_2d_scalar_{kind}_coeffs")(
            j(pts[b]), j(vals[b]), 0.8, valid=j(valid[b]))
        ev = getattr(jrbf, f"loc_2d_scalar_{kind}_eval_with_derivs")(
            c, j(ep[b]), j(pts[b]), 0.8)
        for i, (g, r) in enumerate(zip(ev_t, ev)):
            value_close(g[b], r, f"{kind}[{b}][{i}]")
    assert 1.0 < max(conds) < RBF_CONDITION["loc_2d"]


@pytest.mark.parametrize("basis", ["const", "lin"])
def test_func_3d_scalar(basis, conds):
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (4, 16, 3))
    dest = rng.uniform(-0.3, 0.3, (4, 3))
    f = 1.0 + np.cos(pts[..., 0]) - 2.0 * pts[..., 1] * pts[..., 2]
    is_if = np.zeros((4, 16), bool)
    is_if[:, :4] = True
    nrm = rng.normal(size=(4, 16, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    plane = np.stack([np.eye(3)[:2]] * 4)
    c_t = trbf.func_3d_scalar_dir_coeffs(t(pts), t(dest), 1.0, basis)
    cd_t, cn_t = trbf.func_3d_scalar_dir_neu_coeffs(
        t(pts), t(is_if), t(nrm), t(dest), 1.0, basis)
    pc_t = trbf.func_3d_plane_scalar_dir_coeffs(t(pts), t(dest), t(plane),
                                                1.0, basis)
    pd_t, pn_t = trbf.func_3d_plane_scalar_dir_neu_coeffs(
        t(pts), t(is_if), t(nrm), t(dest), t(plane), 1.0, basis)
    for b in range(4):
        c = jrbf.func_3d_scalar_dir_coeffs(j(pts[b]), j(dest[b]), 1.0,
                                           basis)
        cd, cn = jrbf.func_3d_scalar_dir_neu_coeffs(
            j(pts[b]), j(is_if[b]), j(nrm[b]), j(dest[b]), 1.0, basis)
        pc = jrbf.func_3d_plane_scalar_dir_coeffs(
            j(pts[b]), j(dest[b]), j(plane[b]), 1.0, basis)
        pd, pn = jrbf.func_3d_plane_scalar_dir_neu_coeffs(
            j(pts[b]), j(is_if[b]), j(nrm[b]), j(dest[b]), j(plane[b]), 1.0,
            basis)
        for name, g, r in (("dir", c_t, c), ("dn d", cd_t, cd),
                           ("dn n", cn_t, cn), ("plane", pc_t, pc),
                           ("plane d", pd_t, pd), ("plane n", pn_t, pn)):
            value_close((g[b] * t(f[b])).sum(), np.sum(np.asarray(r) * f[b]),
                        f"{basis} {name}[{b}]")
    assert 1.0 < max(conds) < RBF_CONDITION["func_3d"]


def test_vector_coefficients(conds):
    """Dirichlet and free-slip vector coefficients, 3-D and planar: the
    vector each reconstructs from seeded normal components is held."""
    rng = np.random.default_rng(8)
    n = 9
    pts = rng.uniform(0, 2, (3, n, 3))
    ang = rng.uniform(0, 2 * np.pi, (3, n))
    uvs = np.stack([np.cos(ang), np.sin(ang), 0.3 * np.cos(2 * ang)], -1)
    uvs /= np.linalg.norm(uvs, axis=-1, keepdims=True)
    dest = rng.uniform(0.5, 1.5, (3, 3))
    tang = np.zeros((3, n), bool)
    tang[:, -2:] = True
    nidx = np.zeros((3, n), np.int64)
    nidx[:, -2:] = n - 3
    plane = np.stack([np.eye(3)[:2]] * 3)
    vals = rng.normal(size=(3, n))
    valid = np.ones((3, n), bool)
    valid[1, -1] = False
    cases = {
        "dir": (trbf.func_3d_vector_const_dir_coeffs(
            t(pts), t(uvs), t(dest), 0.9, valid=t(valid)),
            lambda b: jrbf.func_3d_vector_const_dir_coeffs(
                j(pts[b]), j(uvs[b]), j(dest[b]), 0.9, valid=j(valid[b]))),
        "plane dir": (trbf.func_3d_plane_vec_const_dir_coeffs(
            t(pts), t(uvs), t(dest), t(plane), 0.9),
            lambda b: jrbf.func_3d_plane_vec_const_dir_coeffs(
                j(pts[b]), j(uvs[b]), j(dest[b]), j(plane[b]), 0.9)),
        "free slip": (trbf.func_3d_vec_const_tan_neu_coeffs(
            t(pts), t(tang), t(nidx), t(uvs), t(dest), 0.9),
            lambda b: jrbf.func_3d_vec_const_tan_neu_coeffs(
                j(pts[b]), j(tang[b]), j(nidx[b]), j(uvs[b]), j(dest[b]),
                0.9)),
        "plane free slip": (trbf.func_3d_plane_vec_const_tan_neu_coeffs(
            t(pts), t(tang), t(nidx), t(uvs), t(dest), t(plane), 0.9),
            lambda b: jrbf.func_3d_plane_vec_const_tan_neu_coeffs(
                j(pts[b]), j(tang[b]), j(nidx[b]), j(uvs[b]), j(dest[b]),
                j(plane[b]), 0.9)),
    }
    for name, (got, ref_fn) in cases.items():
        for b in range(3):
            ref = np.asarray(ref_fn(b))
            value_close(got[b].T @ t(vals[b]), ref.T @ vals[b],
                        f"{name}[{b}]")
    assert 1.0 < max(conds) < RBF_CONDITION["vector"]


def test_interp_initialize(sphere, plane):
    for jm, tm in (sphere, plane):
        assert_close(trbf.interp_initialize(tm),
                     jrbf.interp_initialize(jm), "init", REL)


@pytest.mark.parametrize("where", ["sphere", "plane"])
def test_reconstruct(where, sphere, plane, conds):
    """reconstruct_init (one batched solve over every cell) and
    reconstruct: the vectors reconstructed from a seeded two-level edge
    field, against the reference's vmapped build."""
    jm, tm = sphere if where == "sphere" else plane
    coeffs_t = trbf.reconstruct_init(tm)
    coeffs_j = jrbf.reconstruct_init(jm)
    u = np.random.default_rng(9).standard_normal((jm.nEdges, 2))
    got = trbf.reconstruct(tm, coeffs_t, t(u))
    ref = jrbf.reconstruct(jm, coeffs_j, j(u))
    assert_close(got, ref, "reconstruct", RBF_REL)
    assert 1.0 < max(conds) < RBF_CONDITION["reconstruct"]
    # the same reconstruction from the reference's coefficients: the
    # gathers and sums alone, at rounding
    assert_close(trbf.reconstruct(tm, t(coeffs_j), t(u)), ref,
                 "reconstruct (ref coeffs)", REL)
