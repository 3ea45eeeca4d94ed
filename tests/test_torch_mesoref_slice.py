"""The port's moist supercell with WSM6 and the mesoscale_reference suite,
end to end on the CPU in float64, against the JAX package.

The 12x12 doubly periodic 2-km hex mesh with 16 levels, the supercell case
with monotonic transport, six species (qv, qc, qr from seeded_moisture,
seed 7; qi, qs, qg zero, as tests/test_atm_physics.py widens the state).
The reference's run_steps is called one step at a time (one compile).
Bounds:
- 6 coupled steps (physics_step, then srk3_step with WSM6: the loop body
  of the reference's run_steps_with_physics, hooks.py:78-85, with the
  resolved mesoscale_reference config) against the reference's loop body
  driven step by step: 1e-9 x max|ref| per field (per-function rounding
  grown over 6 steps, tests/test_torch_supercell.py);
- 6 steps of WSM6 alone against run_steps: 1e-9 x max|ref| per field, and
  total water (six species in the air plus the surface precipitation) and
  dry mass conserved to 1e-10 relative.
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
from mpas_tpu_torch.constants import rvord
from mpas_tpu_torch.cores.atmosphere import hooks
from mpas_tpu_torch.cores.atmosphere import nhyd as tnhyd
from mpas_tpu_torch.cores.atmosphere import advection as tadvection
from mpas_tpu_torch.cores.atmosphere import time_integration as tti
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.moisture import masses, seeded_moisture
from mpas_tpu_torch.cores.atmosphere.physics import manager as tman
from mpas_tpu_torch.ops import stencils as tstencils
from mpas_tpu_torch.tools import mesoref_noon

torch.set_num_threads(1)

CFG = dict(config_dt=12.0, config_nvertlevels=16, config_len_disp=2000.0,
           config_xnutr=0.0, config_microp_scheme="mp_wsm6",
           config_monotonic=True)
DT = 12.0
N_STEPS = 6
REL_SLICE = 1e-9
REL_MASS = 1e-10
MESOREF = dict(config_physics_suite="mesoscale_reference",
               **{k: "suite" for k in tman.SCHEME_FIELDS})
K1_PER_STEP = 12          # 3 dynamics substeps x (1 + 1 + 2) acoustic steps
K2_PER_STEP = 3 + 9 + 3 * 6   # diagnostics + dyn_tend + 3 stages x 6 scalars


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


def assert_close(got, want, name, rel=REL_SLICE):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert scale > 0.0, name
    assert np.abs(got - want).max() <= rel * scale, name


@pytest.fixture(scope="module")
def start():
    """Both packages' grid and initial carry, six species."""
    jcfg = JaxAtmConfig(**CFG)
    jgrid, jstate, jdiag = jax_init_supercell(
        jax_planar_hex_mesh(12, 12, 2000.0), jcfg, case=5)
    sc = seeded_moisture(jgrid.mesh, jstate.scalars, 7).numpy()
    state = dataclasses.replace(
        jstate, scalars=np.concatenate([sc, np.zeros_like(sc)], -1))
    gj = jax.tree.map(jnp.asarray, jgrid)
    carry0 = jti.init_carry(gj, jcfg, jax.tree.map(jnp.asarray, state),
                            jax.tree.map(jnp.asarray, jdiag), DT)
    sounding = np.asarray(jstate.scalars)
    return dict(jcfg=jcfg, gj=gj, jcarry=carry0,
                grid=convert.grid_from_arrays(flatten(jgrid)),
                carry=convert.carry_from_arrays(flatten(carry0)),
                cfg=AtmConfig(**CFG),
                clear=np.concatenate([sounding, np.zeros_like(sounding)],
                                     -1))


def _jax_step(x, carry):
    """One reference srk3_step through its jitted run_steps."""
    return jti.run_steps(x["gj"], x["jcfg"], carry, DT, 1)


@pytest.fixture(scope="module")
def wsm6_runs(start):
    x = start
    c = x["jcarry"]
    for _ in range(N_STEPS):
        c = _jax_step(x, c)
    carry = x["carry"]
    for _ in range(N_STEPS):
        carry = tti.srk3_step(x["grid"], x["cfg"], carry, DT)
    return carry, flatten(c)


@pytest.fixture(scope="module")
def coupled(start):
    """Both packages' coupled loop from a given carry: the reference's
    loop body (physics_step, jitted once with the solar time as an
    argument, then run_steps one step) and the port's
    run_steps_with_physics, with the resolved mesoscale_reference config
    and a Noah physics state at rest. Returns run(jcarry, carry, steps,
    gmt) -> ([reference (carry, phys) after each step], [port's])."""
    x = start
    jp = jman.resolve_suite(jman.PhysicsConfig(**MESOREF))
    tp = tman.resolve_suite(tman.PhysicsConfig(**MESOREF))
    coeffs = jrecon.build_reconstruct_coeffs(x["gj"].mesh)
    nc, nz = x["carry"].state.theta_m.shape
    jstep = jax.jit(lambda s, d, ph, gmt: jman.physics_step(
        x["gj"], jp, x["gj"].mesh, jnp.asarray(coeffs), s, d, ph, DT,
        gmt_hours=gmt))

    def run(jcarry, carry, steps, gmt):
        jphys = jman.init_physics_state(nc, nz, lsm_scheme="noah")
        phys = tman.init_physics_state(nc, nz, lsm_scheme="noah",
                                       device="cpu")
        ref, got = [], []
        for _ in range(steps):
            th, sc, u, jphys = jstep(jcarry.state, jcarry.diag, jphys, gmt)
            jcarry = _jax_step(x, jcarry.replace(state=jcarry.state.replace(
                theta_m=th, scalars=sc, u=u)))
            ref.append((flatten(jcarry), flatten(jphys)))
            carry, phys = hooks.run_steps_with_physics(
                x["grid"], x["cfg"], carry, phys, torch.from_numpy(coeffs),
                DT, 1, pcfg=tp, gmt_hours=gmt)
            got.append((carry, phys))
        return ref, got
    return run


@pytest.fixture(scope="module")
def suite_runs(start, coupled):
    ref, got = coupled(start["jcarry"], start["carry"], N_STEPS, 12.0)
    return got[-1] + ref[-1]


SLICE_FIELDS = ["u", "w", "theta_m", "rho_zz", "scalars", "rainnc",
                "rt_diabatic_tend"]
PHYS_FIELDS = ["tsk", "rainc", "hpbl", "glw", "gsw", "rad_tend", "tslb",
               "smois", "time_since_rad"]


def _field(carry, ref, field):
    if field in ("rainnc", "rt_diabatic_tend"):
        return getattr(carry, field), ref[field]
    return getattr(carry.state, field), ref["state"][field]


@pytest.mark.parametrize("field", SLICE_FIELDS)
def test_wsm6_slice_matches_reference(wsm6_runs, field):
    carry, ref = wsm6_runs
    assert_close(*_field(carry, ref, field), field)


@pytest.mark.parametrize("which", ["dry_mass", "total_water"])
def test_wsm6_slice_conserves_mass(start, wsm6_runs, which):
    carry, _ = wsm6_runs
    i = ("dry_mass", "total_water").index(which)
    m0, m1 = masses(start["grid"], start["carry"])[i], \
        masses(start["grid"], carry)[i]
    assert abs(m1 - m0) <= REL_MASS * m0
    sc = carry.state.scalars
    assert float(carry.rainnc.max()) > 0.0         # rain reached the ground
    assert float(sc[..., 3:6].sum()) > 0.0         # ice-phase species formed


@pytest.mark.parametrize("field", SLICE_FIELDS + PHYS_FIELDS)
def test_suite_slice_matches_reference(suite_runs, field):
    carry, phys, ref, ref_phys = suite_runs
    if field in PHYS_FIELDS:
        got, want = getattr(phys, field), ref_phys[field]
    else:
        got, want = _field(carry, ref, field)
    assert_close(got, want, field)


def test_suite_slice_state(start, suite_runs):
    """The gates of the card's run: dry mass kept (the suite leaves
    rho_zz alone), species non-negative, surface temperature moved,
    downward longwave after the radiation call, everything finite."""
    carry, phys, _, _ = suite_runs
    m0 = masses(start["grid"], start["carry"])[0]
    assert abs(masses(start["grid"], carry)[0] - m0) <= REL_MASS * m0
    assert float(carry.state.scalars[..., :6].min()) >= 0.0
    assert float(phys.tsk.std()) > 0.0
    assert float(phys.glw.min()) > 0.0
    for f in dataclasses.fields(phys):
        v = getattr(phys, f.name)
        if v is not None:
            assert bool(torch.isfinite(v).all()), f.name


def test_noah_surface_diverges_at_noon_over_clear_columns(start, coupled):
    """The reference's Noah skin temperature solves the surface energy
    balance with the surface-layer fluxes of the previous skin temperature
    (explicit coupling). Over clear columns at noon the surface turns
    warmer than the air, the exchange grows, and each step overshoots by
    more than the last: both packages leave any physical range within 4
    steps, step for step alike. At 07:00 (the card's
    supercell_2km_mesoref) the surface stays cooler than the air and the
    same columns settle."""
    x = start
    # the supercell's own sounding, without the seeded cloud and rain:
    # clear columns everywhere
    clear = x["clear"]
    jcarry = x["jcarry"].replace(state=x["jcarry"].state.replace(
        scalars=jnp.asarray(clear)))
    carry = dataclasses.replace(x["carry"], state=dataclasses.replace(
        x["carry"].state, scalars=torch.from_numpy(clear)))
    ref, got = coupled(jcarry, carry, 4, 12.0)
    tsk = [float(p.tsk.min()) for _, p in got]
    for (_, rp), (_, p) in zip(ref, got):
        assert_close(p.tsk, rp["tsk"], "tsk")
    # 310, 208, 331, then below 0 K
    assert tsk[0] > 300.0 and tsk[1] < 250.0 and tsk[2] > 300.0 \
        and tsk[3] < 0.0, tsk
    _, got = coupled(jcarry, carry, 8, 7.0)
    for c, p in got:
        assert 280.0 < float(p.tsk.min()) <= float(p.tsk.max()) < 300.0
        assert bool(torch.isfinite(c.state.u).all())


def test_run_steps_with_physics_defaults_refuse_kain_fritsch(start):
    """pcfg=None is PhysicsConfig() as in the reference, whose literal
    convection default is Kain-Fritsch: it runs, exactly as physics_step
    with PhysicsConfig() then srk3_step (tests/test_torch_kf_slice.py
    holds it to the reference)."""
    x = start
    nc, nz = x["carry"].state.theta_m.shape
    phys = tman.init_physics_state(nc, nz, device="cpu")
    coeffs = torch.from_numpy(jrecon.build_reconstruct_coeffs(x["gj"].mesh))
    carry, phys1 = hooks.run_steps_with_physics(x["grid"], x["cfg"],
                                                x["carry"], phys, coeffs,
                                                DT, 1)
    th, sc, u, want_phys = tman.physics_step(
        x["grid"], tman.PhysicsConfig(), x["grid"].mesh, coeffs,
        x["carry"].state, x["carry"].diag, phys, DT)
    want = tti.srk3_step(x["grid"], x["cfg"], dataclasses.replace(
        x["carry"], state=dataclasses.replace(x["carry"].state, theta_m=th,
                                              scalars=sc, u=u)), DT)
    for f in ("u", "w", "theta_m", "rho_zz", "scalars"):
        assert torch.equal(getattr(carry.state, f),
                           getattr(want.state, f)), f
    for f in ("tsk", "rainc", "hpbl", "glw", "gsw", "rad_tend"):
        assert torch.equal(getattr(phys1, f), getattr(want_phys, f)), f
    assert phys1.tslb is None and phys1.qke is None


def test_physics_state_round_trips_through_convert(suite_runs):
    _, phys, _, ref_phys = suite_runs
    back = convert.physics_state_from_arrays(convert.to_arrays(phys))
    for f in dataclasses.fields(phys):
        v, b = getattr(phys, f.name), getattr(back, f.name)
        assert (v is None) == (b is None), f.name
        if v is not None:
            assert torch.equal(b, v), f.name
    # a reference state with its None fields
    st = convert.physics_state_from_arrays(ref_phys)
    assert st.xice is None and st.isice is None and st.qke is None
    assert st.time_since_rad.dim() == 0


def test_kernel_calls_per_step_with_six_scalars(start, monkeypatch):
    """A coupled step calls K1 12 times and K2 30 times (3 + 9 + 3 x 6:
    one K2 per scalar per transport stage); the suite calls neither."""
    x = start
    calls = {"K1": 0, "K2": 0}

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tnhyd, "acoustic_cell_update",
                        counting("K1", tnhyd.acoustic_cell_update))
    monkeypatch.setattr(tstencils, "tinydot",
                        counting("K2", tstencils.tinydot))
    monkeypatch.setattr(tadvection, "tinydot",
                        counting("K2", tadvection.tinydot))
    nc, nz = x["carry"].state.theta_m.shape
    coeffs = torch.from_numpy(jrecon.build_reconstruct_coeffs(x["gj"].mesh))
    tp = tman.resolve_suite(tman.PhysicsConfig(**MESOREF))
    phys = tman.init_physics_state(nc, nz, lsm_scheme="noah", device="cpu")
    c = x["carry"]
    tman.physics_step(x["grid"], tp, x["grid"].mesh, coeffs, c.state,
                      c.diag, phys, DT)
    assert calls == {"K1": 0, "K2": 0}
    hooks.run_steps_with_physics(x["grid"], x["cfg"], c, phys, coeffs, DT, 1,
                                 pcfg=tp)
    assert calls == {"K1": K1_PER_STEP, "K2": K2_PER_STEP}
    assert K2_PER_STEP == 30


def test_noon_probe_air_start_takes_the_lowest_level_temperature(start):
    """mesoref_noon's second start: tsk, t_deep and the four soil layers at
    the lowest level's air temperature, theta_m / (1 + rvord qv) x exner,
    here from the reference's carry."""
    x = start
    ref = flatten(x["jcarry"])
    th, qv = ref["state"]["theta_m"][:, 0], ref["state"]["scalars"][:, 0, 0]
    want = th / (1.0 + rvord * qv) * ref["diag"]["exner"][:, 0]
    nc, nz = x["carry"].state.theta_m.shape
    phys = mesoref_noon.air_start(x["carry"], tman.init_physics_state(
        nc, nz, lsm_scheme="noah", device="cpu"))
    for got in (phys.tsk, phys.t_deep, *phys.tslb.T):
        assert_close(got, want, "tsk")


def test_noon_probe_reports_both_starts():
    """Two steps of the probe on the 144-cell supercell: one summary per
    start, nothing out of range or non-finite yet."""
    out = mesoref_noon.run(n=12, nz=16, steps=2, device="cpu",
                           dtype=torch.float64)
    assert [r["start"] for r in out] == ["288 K", "lowest level"]
    for r in out:
        assert (r["cells"], r["levels"], r["steps"]) == (144, 16, 2)
        assert r["first_tsk_out_of_range"] is None
        assert r["first_nonfinite"] == dict.fromkeys(mesoref_noon.FIELDS)
