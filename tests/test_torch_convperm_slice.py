"""The port's convection_permitting suite coupled to the dycore, against
the JAX package, in float64 on the CPU, on the 144-cell, 16-level
supercell with eight species of tests/test_torch_convperm.py (whose
helpers, fixture and reference physics_step this file shares; that file
holds each scheme and physics_step on their own).

Bound: 1e-9 x max|ref| per field, after 6 coupled steps (physics_step
with the resolved suite, then srk3_step with Thompson, at 07:00 solar
time) and after 3 srk3_step with Thompson alone against the reference's
run_steps.
"""

import dataclasses

import pytest
import torch

from mpas_tpu.cores.atmosphere import time_integration as jti
from mpas_tpu.cores.atmosphere.physics import manager as jman
from mpas_tpu_torch.cores.atmosphere import hooks
from mpas_tpu_torch.cores.atmosphere import time_integration as tti
from mpas_tpu_torch.cores.atmosphere.physics import manager as tman
from tests.test_torch_convperm import (CONVPERM, DT_DYN, GMT, T,
                                       _jax_physics_step, assert_close,
                                       flatten, supercell)

torch.set_num_threads(1)

REL_SLICE = 1e-9
N_STEPS = 6


def _jax_step(x, carry):
    """One reference srk3_step through its jitted run_steps."""
    return jti.run_steps(x["gj"], x["jcfg"], carry, DT_DYN, 1)


@pytest.fixture(scope="module")
def coupled(supercell):
    """6 coupled steps of both packages: the reference's loop body
    (physics_step with the resolved suite, then run_steps one step) and
    the port's run_steps_with_physics, from a Noah + MYNN physics state at
    rest."""
    x = supercell
    jp = jman.resolve_suite(jman.PhysicsConfig(**CONVPERM))
    tp = tman.resolve_suite(tman.PhysicsConfig(**CONVPERM))
    init_kw = dict(lsm_scheme="noah", pbl_scheme="mynn")
    jphys = jman.init_physics_state(144, 16, **init_kw)
    phys = tman.init_physics_state(144, 16, device="cpu", **init_kw)
    jcarry, carry = x["jcarry"], x["carry"]
    jstep = _jax_physics_step(x, jp)
    for _ in range(N_STEPS):
        th, sc, u, jphys = jstep(jcarry.state, jcarry.diag, jphys, GMT)
        jcarry = _jax_step(x, jcarry.replace(state=jcarry.state.replace(
            theta_m=th, scalars=sc, u=u)))
    carry, phys = hooks.run_steps_with_physics(
        x["tgrid"], x["cfg"], carry, phys, T(x["coeffs"]), DT_DYN, N_STEPS,
        pcfg=tp, gmt_hours=GMT)
    return carry, phys, flatten(jcarry), flatten(jphys)


SLICE_FIELDS = ["u", "w", "theta_m", "rho_zz", "scalars", "rainnc",
                "rt_diabatic_tend"]
PHYS_FIELDS = ["tsk", "rainc", "hpbl", "glw", "gsw", "rad_tend", "tslb",
               "smois", "qke", "time_since_rad"]


def _field(carry, ref, field):
    if field in ("rainnc", "rt_diabatic_tend"):
        return getattr(carry, field), ref[field]
    return getattr(carry.state, field), ref["state"][field]


@pytest.mark.parametrize("field", SLICE_FIELDS + PHYS_FIELDS)
def test_convperm_slice_matches_reference(coupled, field):
    carry, phys, ref, ref_phys = coupled
    if field in PHYS_FIELDS:
        got, want = getattr(phys, field), ref_phys[field]
    else:
        got, want = _field(carry, ref, field)
    assert_close([got], [want], [field], rel=REL_SLICE)


def test_convperm_slice_state(coupled):
    """The gates of the card's run: finite fields, species non-negative,
    the numbers within their bounds, qke finite and >= 0, rain."""
    carry, phys, _, _ = coupled
    sc = carry.state.scalars
    assert float(sc[..., :6].min()) >= 0.0
    assert float(sc[..., 6:].min()) >= 1e-2 and float(sc[..., 6:].max()) \
        <= 1e8
    assert float(phys.qke.min()) >= 0.0
    assert float(carry.rainnc.max()) > 0.0
    for f in dataclasses.fields(phys):
        v = getattr(phys, f.name)
        if v is not None:
            assert bool(torch.isfinite(v).all()), f.name


@pytest.fixture(scope="module")
def thompson_runs(supercell):
    x = supercell
    jcarry, carry = x["jcarry"], x["carry"]
    for _ in range(3):
        jcarry = _jax_step(x, jcarry)
    carry = tti.run_steps(x["tgrid"], x["cfg"], carry, DT_DYN, 3)
    return carry, flatten(jcarry)


@pytest.mark.parametrize("field", SLICE_FIELDS)
def test_srk3_step_thompson_matches_reference(thompson_runs, field):
    got, want = _field(*thompson_runs, field)
    assert_close([got], [want], [field], rel=REL_SLICE)
