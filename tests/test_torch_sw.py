"""The shallow-water core of the PyTorch port against the JAX package.

Test case 5 on the 642-cell icosahedral mesh (float64) is carried into the
port through convert.py, and seeded perturbations make every term
non-trivial. Each ported stencil and SW function is held to its JAX twin
at 1e-11 x max|ref| (float64, sums in another order); the test cases are
the reference's bit for bit; the 48-step TC5 trajectory is held to the
frozen golden at the golden's own tolerances (tests/test_parity_dycore.py).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.sw import dynamics as jdyn
from mpas_tpu.cores.sw import fused as jfused
from mpas_tpu.cores.sw import global_diagnostics as jglobal
from mpas_tpu.cores.sw import test_cases as jtc
from mpas_tpu.cores.sw import time_integration as jti
from mpas_tpu.cores.sw.config import SWConfig as JSWConfig
from mpas_tpu.cores.sw.state import SWState as JSWState
from mpas_tpu.ops import stencils as jst
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.sw import dynamics as tdyn
from mpas_tpu_torch.cores.sw import fused as tfused
from mpas_tpu_torch.cores.sw import global_diagnostics as tglobal
from mpas_tpu_torch.cores.sw import test_cases as ttc
from mpas_tpu_torch.cores.sw import time_integration as tti
from mpas_tpu_torch.cores.sw.config import SWConfig
from mpas_tpu_torch.ops import stencils as tst

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden" / "sw_tc5.npz"
REL = 1e-11
RTOL, ATOL = 1e-9, 1e-11         # tests/test_parity_dycore.py:27-28
DT = 900.0
SW_STEPS = 48


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


def assert_close(got, ref, name="", rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert np.abs(got - ref).max() <= rel * scale, name


class Case:
    """TC5 on the 642-cell mesh with perturbed u, h and tracers, and
    random del2/del4 mesh scaling, in both packages (numpy in `a`)."""

    def __init__(self, jmesh_unit):
        jmesh, jstate, h_s = jtc.SETUPS[5](jmesh_unit)
        rng = np.random.default_rng(0)
        jmesh = jmesh.replace(
            meshScalingDel2=1.0 + rng.uniform(size=jmesh.nEdges),
            meshScalingDel4=1.0 + rng.uniform(size=jmesh.nEdges))
        s = flatten(jstate)
        self.a = dict(
            u=s["u"] + 2.0 * rng.standard_normal(s["u"].shape),
            h=s["h"] * (1.0 + 1e-2 * rng.standard_normal(s["h"].shape)),
            tracers=s["tracers"] + 0.1 * rng.standard_normal(
                s["tracers"].shape),
            h_s=np.asarray(h_s))
        self.jmesh = jax.tree.map(jnp.asarray, jmesh)
        self.tmesh = convert.mesh_from_arrays(flatten(jmesh))
        self.jstate = JSWState(*(jnp.asarray(self.a[k])
                                 for k in ("u", "h", "tracers")))
        self.tstate = convert.sw_state_from_arrays(self.a)
        self.jh_s = jnp.asarray(self.a["h_s"])
        self.th_s = torch.from_numpy(self.a["h_s"])


@pytest.fixture(scope="module")
def case(sphere_mesh_small):
    return Case(sphere_mesh_small)


# ---------------------------------------------------------------------------
# stencil operators
# ---------------------------------------------------------------------------

EDGE_OPS = ["edge_divergence", "edge_circulation", "edge_curl",
            "tangential_velocity", "kinetic_energy_cell", "edge_sum_on_cell",
            "tangential_cell_assembled"]
CELL_OPS = ["cell_gradient_n", "cell_to_edge_mean", "cell_to_vertex_kite"]
VERTEX_OPS = ["vertex_gradient_t", "vertex_to_edge_mean",
              "vertex_to_cell_kite"]


def _field(case, where, trailing):
    n = {"edge": case.tmesh.nEdges, "cell": case.tmesh.nCells,
         "vertex": case.tmesh.nVertices}[where]
    seed = {"edge": 1, "cell": 2, "vertex": 3}[where] + 10 * len(trailing)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + trailing)


@pytest.mark.parametrize("trailing", [(), (3,)], ids=["1d", "2d"])
@pytest.mark.parametrize("op,where",
                         [(o, "edge") for o in EDGE_OPS]
                         + [(o, "cell") for o in CELL_OPS]
                         + [(o, "vertex") for o in VERTEX_OPS])
def test_stencil_matches_reference(case, op, where, trailing):
    x = _field(case, where, trailing)
    got = getattr(tst, op)(case.tmesh, torch.from_numpy(x))
    assert_close(got, getattr(jst, op)(case.jmesh, jnp.asarray(x)), op)


@pytest.mark.parametrize("mask", [True, False])
def test_cell_gradient_mask_option(case, mask):
    x = _field(case, "cell", (2,))
    got = tst.cell_gradient_n(case.tmesh, torch.from_numpy(x), mask)
    assert_close(got, jst.cell_gradient_n(case.jmesh, jnp.asarray(x), mask))


def test_edge_sum_on_cell_weighted(case):
    x = _field(case, "edge", ())
    w = np.random.default_rng(5).standard_normal(
        (case.tmesh.nCells, case.tmesh.maxEdges))
    got = tst.edge_sum_on_cell(case.tmesh, torch.from_numpy(x),
                               torch.from_numpy(w))
    assert_close(got, jst.edge_sum_on_cell(case.jmesh, jnp.asarray(x),
                                           jnp.asarray(w)))


@pytest.mark.parametrize("trailing", [(), (4,)], ids=["1d", "2d"])
def test_trisk_q_matches_reference(case, trailing):
    u = _field(case, "edge", trailing)
    pv = np.random.default_rng(9).standard_normal(u.shape)
    got = tst.trisk_q_cell_assembled(case.tmesh, torch.from_numpy(u),
                                     torch.from_numpy(pv))
    want = jst.trisk_q_cell_assembled(case.jmesh, jnp.asarray(u),
                                      jnp.asarray(pv))
    assert_close(got, want)


def test_cell_assembled_equals_edges_on_edge_form(case):
    """The two forms of the TRiSK operator are the same operator."""
    u = torch.from_numpy(_field(case, "edge", ()))
    assert_close(tst.tangential_cell_assembled(case.tmesh, u),
                 tst.tangential_velocity(case.tmesh, u).numpy())


# ---------------------------------------------------------------------------
# test cases
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_unit_mesh(sphere_mesh_small):
    return convert.mesh_from_arrays(flatten(sphere_mesh_small))


@pytest.mark.parametrize("tc", [1, 2, 5, 6])
def test_test_case_matches_reference(port_unit_mesh, sphere_mesh_small, tc):
    mesh, state, h_s = ttc.SETUPS[tc](port_unit_mesh)
    jmesh, jstate, jh_s = jtc.SETUPS[tc](sphere_mesh_small)
    for k in ("u", "h", "tracers"):
        assert np.array_equal(getattr(state, k).numpy(),
                              np.asarray(getattr(jstate, k))), k
    assert np.array_equal(h_s.numpy(), np.asarray(jh_s))
    ref = flatten(jmesh)
    for f in dataclasses.fields(mesh):
        v = getattr(mesh, f.name)
        if isinstance(v, torch.Tensor):
            assert np.array_equal(v.numpy(), ref[f.name]), f.name
        else:
            assert v == ref[f.name], f.name


# ---------------------------------------------------------------------------
# diagnostics, tendencies, the fused stage, RK4
# ---------------------------------------------------------------------------

CFGS = {
    "default": {},
    "del2_diff2": dict(config_h_mom_eddy_visc2=1.0e5,
                       config_h_tracer_eddy_diff2=5.0e4),
    "del4_drag": dict(config_h_mom_eddy_visc4=1.0e15,
                      config_h_mom_eddy_visc2=1.0e5, config_bottom_drag=True),
}


def _cfgs(name):
    kw = dict(config_dt=DT, **CFGS[name])
    return JSWConfig(**kw), SWConfig(**kw)


def test_solve_diagnostics_matches_reference(case):
    jcfg, tcfg = _cfgs("default")
    got = tdyn.solve_diagnostics(case.tmesh, tcfg, case.tstate, DT, case.th_s)
    want = jdyn.solve_diagnostics(case.jmesh, jcfg, case.jstate, DT,
                                  case.jh_s)
    for f in dataclasses.fields(got):
        assert_close(getattr(got, f.name), getattr(want, f.name), f.name)


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_compute_tend_matches_reference(case, cfg_name):
    jcfg, tcfg = _cfgs(cfg_name)
    tdiag = tdyn.solve_diagnostics(case.tmesh, tcfg, case.tstate, DT,
                                   case.th_s)
    jdiag = jdyn.solve_diagnostics(case.jmesh, jcfg, case.jstate, DT,
                                   case.jh_s)
    got = tdyn.compute_tend(case.tmesh, tcfg, case.tstate, tdiag, case.th_s)
    want = jdyn.compute_tend(case.jmesh, jcfg, case.jstate, jdiag, case.jh_s)
    for name, g, w in zip(("tend_u", "tend_h"), got, want):
        assert_close(g, w, name)
    ct = case.tstate.tracers * case.tstate.h[:, None]
    got = tdyn.compute_scalar_tend(case.tmesh, tcfg, case.tstate, tdiag, ct)
    want = jdyn.compute_scalar_tend(case.jmesh, jcfg, case.jstate, jdiag,
                                    jnp.asarray(ct.numpy()))
    assert_close(got, want, "tend_ct")


@pytest.mark.parametrize("cfg_name", ["default", "del2_diff2"])
def test_fused_stage_matches_reference_and_generic(case, cfg_name):
    jcfg, tcfg = _cfgs(cfg_name)
    if cfg_name == "del2_diff2":
        # the fused stage carries no tracer diffusion, like its twin
        jcfg = dataclasses.replace(jcfg, config_h_tracer_eddy_diff2=0.0)
        tcfg = dataclasses.replace(tcfg, config_h_tracer_eddy_diff2=0.0)
    got = tfused.stage_tendencies(case.tmesh, tcfg, case.tstate, DT,
                                  case.th_s)
    want = jfused.stage_tendencies(case.jmesh, jcfg, case.jstate, DT,
                                   case.jh_s)
    diag = tdyn.solve_diagnostics(case.tmesh, tcfg, case.tstate, DT,
                                  case.th_s)
    generic = tdyn.compute_tend(case.tmesh, tcfg, case.tstate, diag,
                                case.th_s) + (tdyn.compute_scalar_tend(
                                    case.tmesh, tcfg, case.tstate, diag,
                                    case.tstate.tracers
                                    * case.tstate.h[:, None]),)
    for name, g, w, gen in zip(("tend_u", "tend_h", "tend_ct"), got, want,
                               generic):
        assert_close(g, w, name)
        assert_close(g, gen.numpy(), name)


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_rk4_steps_match_reference(case, cfg_name):
    jcfg, tcfg = _cfgs(cfg_name)
    want = jti.run_steps(case.jmesh, jcfg, case.jstate, case.jh_s, 3)
    got = tti.run_steps(case.tmesh, tcfg, case.tstate, case.th_s, 3)
    for k in ("u", "h", "tracers"):
        assert_close(getattr(got, k), getattr(want, k), k)


def test_global_diagnostics_match_reference(case):
    got = tglobal.global_diagnostics(case.tmesh, case.tstate, case.th_s, DT)
    want = jglobal.global_diagnostics(case.jmesh, case.jstate, case.jh_s, DT)
    assert set(got) == set(want)
    for k, v in want.items():
        assert isinstance(got[k], float)
        assert abs(got[k] - float(v)) <= REL * abs(float(v)), k


# ---------------------------------------------------------------------------
# the TC5 trajectory of the golden
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trajectory(port_unit_mesh):
    mesh, state, h_s = ttc.SETUPS[5](port_unit_mesh)
    cfg = SWConfig(config_dt=DT, config_test_case=5)
    return mesh, state, h_s, tti.run_steps(mesh, cfg, state, h_s, SW_STEPS)


@pytest.mark.parametrize("field", ["u", "h"])
def test_tc5_trajectory_matches_golden(trajectory, field):
    g = np.load(GOLDEN)[field]
    v = getattr(trajectory[3], field).numpy()
    assert v.shape == g.shape
    err = np.abs(v - g)
    tol = ATOL + RTOL * np.abs(g)
    assert (err <= tol).all(), f"worst err/tol {float((err / tol).max()):.3g}"


def test_tc5_conserves_mass_and_tracer_mass(trajectory):
    mesh, s0, h_s, s1 = trajectory
    d0 = tglobal.global_diagnostics(mesh, s0, h_s, DT)
    d1 = tglobal.global_diagnostics(mesh, s1, h_s, DT)
    assert abs(d1["total_mass"] - d0["total_mass"]) \
        <= 1e-13 * d0["total_mass"]
    area = mesh.areaCell[:, None]
    tm0 = (s0.tracers * s0.h[:, None] * area).sum(0)
    tm1 = (s1.tracers * s1.h[:, None] * area).sum(0)
    assert bool(((tm1 - tm0).abs() <= 1e-12 * tm0.abs()).all())
    assert all(bool(torch.isfinite(getattr(s1, k)).all())
               for k in ("u", "h", "tracers"))
    # energy is not conserved exactly, but TC5 loses well under 0.1% in
    # 12 hours
    assert abs(d1["total_energy"] - d0["total_energy"]) \
        <= 1e-3 * d0["total_energy"]


def test_state_round_trips_through_convert(trajectory):
    s = trajectory[3]
    back = convert.sw_state_from_arrays(convert.to_arrays(s))
    for k in ("u", "h", "tracers"):
        assert torch.equal(getattr(back, k), getattr(s, k)), k


def test_float32_step_after_to(trajectory):
    mesh, state, h_s, _ = trajectory
    cpu, f32 = torch.device("cpu"), torch.float32
    cfg = SWConfig(config_dt=DT)
    out = tti.rk4_step(mesh.to(cpu, f32), cfg, state.to(cpu, f32),
                       h_s.to(f32), DT)
    assert all(getattr(out, k).dtype == f32
               and bool(torch.isfinite(getattr(out, k)).all())
               for k in ("u", "h", "tracers"))
