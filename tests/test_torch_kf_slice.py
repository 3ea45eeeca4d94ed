"""The default physics of the driver hook, PhysicsConfig() (Kain-Fritsch,
YSU, the MM5 surface layer, the slab LSM, broadband radiation), against the
JAX package, in float64 on the CPU, on the 144-cell, 16-level supercell of
tests/test_torch_mesoref_slice.py with six species (seeded cloud and rain,
seed 7) and WSM6. tests/test_torch_kf.py holds Kain-Fritsch on its own.

Bounds:
- physics_step: 1e-11 x max|ref| per field;
- 6 coupled steps (physics_step with PhysicsConfig(), then srk3_step with
  WSM6) against the reference's loop body: 1e-9 x max|ref| per field.
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
from mpas_tpu.mesh.planar import planar_hex_mesh as jax_planar_hex_mesh
from mpas_tpu.ops import reconstruct as jrecon
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere import hooks
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
from mpas_tpu_torch.cores.atmosphere.physics import manager as tman

torch.set_num_threads(1)

REL_FN = 1e-11
REL_SLICE = 1e-9
DT_DYN = 12.0
N_STEPS = 6
CFG = dict(config_dt=DT_DYN, config_nvertlevels=16, config_len_disp=2000.0,
           config_xnutr=0.0, config_microp_scheme="mp_wsm6",
           config_monotonic=True)


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


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(x)


def assert_close(got, ref, names, rel=REL_FN):
    for g, r, name in zip(got, ref, names):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape, name
        scale = max(float(np.abs(r).max()), 1e-300)
        assert np.abs(g - r).max() <= rel * scale, name


@pytest.fixture(scope="module")
def supercell():
    """Both packages' 12x12, 16-level supercell with six species (seeded
    cloud and rain; qi, qs, qg zero) and the reference's initial carry."""
    jcfg = JaxAtmConfig(**CFG)
    jgrid, jstate, jdiag = jax_init_supercell(
        jax_planar_hex_mesh(12, 12, 2000.0), jcfg, case=5)
    sc = seeded_moisture(jgrid.mesh, jstate.scalars, 7).numpy()
    gj = jax.tree.map(jnp.asarray, jgrid)
    jcarry = jti.init_carry(
        gj, jcfg, jax.tree.map(jnp.asarray, jstate.replace(
            scalars=np.concatenate([sc, np.zeros_like(sc)], -1))),
        jax.tree.map(jnp.asarray, jdiag), DT_DYN)
    return dict(gj=gj, jcfg=jcfg, jcarry=jcarry,
                tgrid=convert.grid_from_arrays(flatten(jgrid)),
                carry=convert.carry_from_arrays(flatten(jcarry)),
                cfg=AtmConfig(**CFG),
                coeffs=jrecon.build_reconstruct_coeffs(gj.mesh))


@pytest.fixture(scope="module")
def jax_physics_step(supercell):
    """The reference's physics_step with PhysicsConfig(), jitted once."""
    x = supercell
    return jax.jit(lambda s, d, ph: jman.physics_step(
        x["gj"], jman.PhysicsConfig(), x["gj"].mesh, J(x["coeffs"]), s, d,
        ph, DT_DYN))


def _phys_fields(got, ref):
    rp = flatten(ref)
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        assert (v is None) == (rp[f.name] is None), f.name
        if v is not None:
            assert_close([v], [rp[f.name]], [f.name])


def test_physics_step_defaults(supercell, jax_physics_step):
    """PhysicsConfig() on the supercell at rest: Kain-Fritsch fed by the
    resolved w."""
    x = supercell
    nc, nz = x["carry"].state.theta_m.shape
    ref = jax_physics_step(x["jcarry"].state, x["jcarry"].diag,
                           jman.init_physics_state(nc, nz))
    phys = tman.init_physics_state(nc, nz, device="cpu")
    got = tman.physics_step(x["tgrid"], tman.PhysicsConfig(),
                            x["tgrid"].mesh, T(x["coeffs"]),
                            x["carry"].state, x["carry"].diag, phys, DT_DYN)
    assert_close(got[:3], ref[:3], ["theta_m", "scalars", "u"])
    _phys_fields(got[3], ref[3])


@pytest.fixture(scope="module")
def coupled(supercell, jax_physics_step):
    """6 coupled steps of both packages with PhysicsConfig(): the
    reference's loop body (physics_step, then run_steps one step) and the
    port's run_steps_with_physics(pcfg=None), from a slab physics state at
    rest, at the default noon."""
    x = supercell
    nc, nz = x["carry"].state.theta_m.shape
    jcarry, jphys = x["jcarry"], jman.init_physics_state(nc, nz)
    for _ in range(N_STEPS):
        th, sc, u, jphys = jax_physics_step(jcarry.state, jcarry.diag,
                                            jphys)
        jcarry = jti.run_steps(x["gj"], x["jcfg"], jcarry.replace(
            state=jcarry.state.replace(theta_m=th, scalars=sc, u=u)),
            DT_DYN, 1)
    carry, phys = hooks.run_steps_with_physics(
        x["tgrid"], x["cfg"], x["carry"],
        tman.init_physics_state(nc, nz, device="cpu"), T(x["coeffs"]),
        DT_DYN, N_STEPS)
    return carry, phys, flatten(jcarry), flatten(jphys)


SLICE_FIELDS = ["u", "w", "theta_m", "rho_zz", "scalars", "rainnc",
                "rt_diabatic_tend"]
PHYS_FIELDS = ["tsk", "rainc", "hpbl", "glw", "gsw", "rad_tend",
               "time_since_rad"]


@pytest.mark.parametrize("field", SLICE_FIELDS + PHYS_FIELDS)
def test_kf_slice_matches_reference(coupled, field):
    carry, phys, ref, ref_phys = coupled
    if field in PHYS_FIELDS:
        got, want = getattr(phys, field), ref_phys[field]
    elif field in ("rainnc", "rt_diabatic_tend"):
        got, want = getattr(carry, field), ref[field]
    else:
        got, want = getattr(carry.state, field), ref["state"][field]
    assert_close([got], [want], [field], rel=REL_SLICE)


def test_kf_slice_state(coupled):
    """The gates of the card's run: finite fields, non-negative species,
    grid-scale and convective rain."""
    carry, phys, _, _ = coupled
    assert float(carry.state.scalars.min()) >= 0.0
    assert float(carry.rainnc.max()) > 0.0 and float(phys.rainc.max()) > 0.0
    for f in ("u", "w", "theta_m", "rho_zz", "scalars"):
        assert bool(torch.isfinite(getattr(carry.state, f)).all()), f
