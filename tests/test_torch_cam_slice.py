"""The mesoscale_reference suite under CAM radiation, end to end on the CPU
in float64, against the JAX package.

- physics_step with config_radiation_scheme="cam" on the 144-cell,
  16-level supercell of tests/test_torch_physics.py (six species), with
  radiation due and not due: every output at 1e-11 x max|ref|.
- 6 coupled steps (physics_step, then srk3_step with WSM6: the loop body
  of the reference's run_steps_with_physics) with the MPAS-A supercell
  namelist's dissipation: 2d_fixed horizontal mixing and the horizontal
  and vertical eddy viscosities of u and theta at 500 m^2/s, no del4; at
  07:00 solar time as the card's supercell_2km_cam. Against the
  reference's loop body driven step by step: 1e-9 x max|ref| per field,
  dry mass to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import time_integration as jti
from mpas_tpu.cores.atmosphere.config import AtmConfig as JaxAtmConfig
from mpas_tpu.cores.atmosphere.init_supercell import \
    init_supercell as jax_init_supercell
from mpas_tpu.cores.atmosphere.physics import manager as jman
from mpas_tpu.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu.mesh.planar import planar_hex_mesh as jax_planar_hex_mesh
from mpas_tpu.ops import reconstruct as jrecon
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere import hooks
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.moisture import masses, seeded_moisture
from mpas_tpu_torch.cores.atmosphere.physics import cam_radiation as tcam
from mpas_tpu_torch.cores.atmosphere.physics import manager as tman
from tests.test_torch_mesoref_slice import (PHYS_FIELDS, REL_MASS,
                                           SLICE_FIELDS, _field)
from tests.test_torch_mesoref_slice import assert_close as assert_slice
from tests.test_torch_physics import (J, T, _jax_physics_step,
                                      _physics_states, assert_close,
                                      flatten, supercell)  # noqa: F401

torch.set_num_threads(1)

MESOREF_CAM = dict(config_physics_suite="mesoscale_reference",
                   **{k: "suite" for k in tman.SCHEME_FIELDS})
MESOREF_CAM["config_radiation_scheme"] = "cam"
# the MPAS-A supercell case's namelist dissipation
DISSIPATION = dict(config_horiz_mixing="2d_fixed",
                   config_h_mom_eddy_visc2=500.0,
                   config_h_theta_eddy_visc2=500.0,
                   config_v_mom_eddy_visc2=500.0,
                   config_v_theta_eddy_visc2=500.0,
                   config_h_mom_eddy_visc4=0.0,
                   config_h_theta_eddy_visc4=0.0)
CFG = dict(config_dt=12.0, config_nvertlevels=16, config_len_disp=2000.0,
           config_xnutr=0.0, config_microp_scheme="mp_wsm6",
           config_monotonic=True, **DISSIPATION)
DT = 12.0
N_STEPS = 6
GMT = 7.0


@pytest.mark.parametrize("case", ["due", "not_due"])
def test_physics_step_cam(supercell, case):  # noqa: F811
    x = supercell
    nc, nz = x["s"]["theta_m"].shape
    jph, tph = _physics_states(nc, nz, dict(lsm_scheme="noah"),
                               None if case == "due" else "not_due")
    coeffs = jrecon.build_reconstruct_coeffs(x["jgrid"].mesh)
    ref = _jax_physics_step(x["jgrid"], jman.PhysicsConfig(**MESOREF_CAM))(
        AtmState(**jax.tree.map(J, x["s"])),
        AtmDiag(**jax.tree.map(J, x["d"])), jph, J(coeffs))
    calls = []
    real = tcam.cam_lw

    def recorded(*a, **k):
        calls.append(1)
        return real(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcam, "cam_lw", recorded)
        got = tman.physics_step(
            x["tgrid"], tman.PhysicsConfig(**MESOREF_CAM), x["tgrid"].mesh,
            T(coeffs), convert.state_from_arrays(x["s"]),
            convert.diag_from_arrays(x["d"]), tph, DT)
    assert calls == [1]          # CAM runs at every call, due or not
    assert_close(got[:3], ref[:3], ["theta_m", "scalars", "u"])
    rp = flatten(ref[3])
    for f in dataclasses.fields(got[3]):
        v = getattr(got[3], f.name)
        assert (v is None) == (rp[f.name] is None), f.name
        if v is not None:
            assert_close([v], [rp[f.name]], [f.name])
    if case == "due":
        assert float(got[3].glw.min()) > 0.0
        assert float(got[3].gsw.max()) > 0.0
    else:
        assert torch.equal(got[3].rad_tend, tph.rad_tend)


@pytest.fixture(scope="module")
def cam_runs():
    """Both packages' 6 coupled steps from the seeded supercell."""
    jcfg = JaxAtmConfig(**CFG)
    jgrid, jstate, jdiag = jax_init_supercell(
        jax_planar_hex_mesh(12, 12, 2000.0), jcfg, case=5)
    sc = seeded_moisture(jgrid.mesh, jstate.scalars, 7).numpy()
    state = dataclasses.replace(
        jstate, scalars=np.concatenate([sc, np.zeros_like(sc)], -1))
    gj = jax.tree.map(jnp.asarray, jgrid)
    jcarry = jti.init_carry(gj, jcfg, jax.tree.map(jnp.asarray, state),
                            jax.tree.map(jnp.asarray, jdiag), DT)
    grid = convert.grid_from_arrays(flatten(jgrid))
    carry = start = convert.carry_from_arrays(flatten(jcarry))
    cfg = AtmConfig(**CFG)
    jp = jman.resolve_suite(jman.PhysicsConfig(**MESOREF_CAM))
    tp = tman.resolve_suite(tman.PhysicsConfig(**MESOREF_CAM))
    assert jp.config_radiation_scheme == tp.config_radiation_scheme == "cam"
    coeffs = jrecon.build_reconstruct_coeffs(gj.mesh)
    nc, nz = carry.state.theta_m.shape
    jstep = jax.jit(lambda s, d, ph: jman.physics_step(
        gj, jp, gj.mesh, jnp.asarray(coeffs), s, d, ph, DT, gmt_hours=GMT))
    jphys = jman.init_physics_state(nc, nz, lsm_scheme="noah")
    phys = tman.init_physics_state(nc, nz, lsm_scheme="noah", device="cpu")
    for _ in range(N_STEPS):
        th, scs, u, jphys = jstep(jcarry.state, jcarry.diag, jphys)
        jcarry = jti.run_steps(gj, jcfg, jcarry.replace(
            state=jcarry.state.replace(theta_m=th, scalars=scs, u=u)), DT, 1)
    carry, phys = hooks.run_steps_with_physics(
        grid, cfg, carry, phys, torch.from_numpy(coeffs), DT, N_STEPS,
        pcfg=tp, gmt_hours=GMT)
    return grid, start, carry, phys, flatten(jcarry), flatten(jphys)


@pytest.mark.parametrize("field", SLICE_FIELDS + PHYS_FIELDS)
def test_cam_slice_matches_reference(cam_runs, field):
    _, _, carry, phys, ref, ref_phys = cam_runs
    if field in PHYS_FIELDS:
        got, want = getattr(phys, field), ref_phys[field]
    else:
        got, want = _field(carry, ref, field)
    assert_slice(got, want, field)


def test_cam_slice_state(cam_runs):
    """The card's gates: dry mass kept, species non-negative, rain at the
    ground, the skin temperature moved, downward longwave after the
    radiation call, everything finite."""
    grid, start, carry, phys, _, _ = cam_runs
    m0 = masses(grid, start)[0]
    assert abs(masses(grid, carry)[0] - m0) <= REL_MASS * m0
    assert float(carry.state.scalars[..., :6].min()) >= 0.0
    assert float(carry.rainnc.max()) > 0.0
    assert float(phys.tsk.std()) > 0.0
    assert float(phys.glw.min()) > 0.0
    for f in dataclasses.fields(phys):
        v = getattr(phys, f.name)
        if v is not None:
            assert bool(torch.isfinite(v).all()), f.name
