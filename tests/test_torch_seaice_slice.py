"""The two sea-ice paths of the port (mpas_tpu_torch/tools/seaice_box.py)
against the JAX package's run_steps, on the 100-cell box in float64.

seaice_box_10km (MPAS-Seaice's E3SM options: variational EVP,
incremental remapping, mushy thermodynamics with the coupled brine
dynamics, delta-Eddington, level-ice ponds, the linear ITD, ice age) and
seaice_box_10km_default (SeaiceConfig()) start from init_square and the
tracer start of the reference's own tests, as tools/seaice_box.py builds
them, and run 3 steps of 600 s with 5 elastic subcycles through both
packages' run_steps, held at 1e-9 x max. The E3SM path holds each
tracer as its content (the tracer times its parent: a*T, vi*q, vs*q,
vi*S, a*pond...), which is what the column physics conserves: the linear
ITD divides contents by near-empty parents (areas of 1e-9..1e-5), so the
per-unit tracer of such a category carries its content's rounding
difference amplified by 1/parent. One step at the paths' 3,600 s with
20 subcycles (also under the PWL basis) and the revised EVP hold every
field at 1e-9.

Two properties of the reference that the port shares are shown here too:
the EVP subcycle amplifies a rounding difference at every elastic
iteration (why the 3-step runs take 5 subcycles), and neither transport
scheme moves the pond, level-ice, age or salinity tracers (ROADMAP §3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# imported before run_steps' trace (ROADMAP §3: shortwave_dedd.py:28)
import mpas_tpu.cores.seaice.shortwave_dedd  # noqa: F401
from mpas_tpu.cores.seaice import advection as jadv
from mpas_tpu.cores.seaice import remap as jremap
from mpas_tpu.cores.seaice import state as jstate
from mpas_tpu.cores.seaice import thermo_vertical as jtv
from mpas_tpu.cores.seaice.config import SeaiceConfig as JCfg
from mpas_tpu.cores.seaice.core import run_steps as j_run_steps
from mpas_tpu.cores.seaice.init_square import init_square as j_init_square
from mpas_tpu.mesh.planar import box_hex_mesh as j_box_hex_mesh
from mpas_tpu_torch import convert
from mpas_tpu_torch.kernels import acoustic, tinydot
from mpas_tpu_torch.ops import stencils
from mpas_tpu_torch.cores.seaice import advection as tadv
from mpas_tpu_torch.cores.seaice import remap as tremap
from mpas_tpu_torch.cores.seaice.core import run_steps, total_ice_volume
from mpas_tpu_torch.cores.seaice import thermo_vertical as ttv
from mpas_tpu_torch.cores.seaice.state import make_grid
from mpas_tpu_torch.tools import seaice_box as sb
from tests.test_torch_ocean import assert_close, flatten

torch.set_num_threads(1)

STEP_REL = 1e-9
SLICE_DT, SLICE_SUBCYCLES, SLICE_STEPS = 600.0, 5, 3
PATH_DT, PATH_SUBCYCLES = 3600.0, 20
def reference_start(name, jmesh, cfg):
    """The path's start in the JAX package, as seaice_box.setup composes
    it in the port."""
    jgrid, js, jf = j_init_square(jmesh, cfg)
    if cfg.config_stress_divergence_scheme == "variational":
        jgrid = jstate.make_grid(jmesh, variational=True)
    if name == "seaice_box_10km":
        nC, nCat = js.iceAreaCategory.shape
        q_i, q_s = jtv.init_enthalpy(cfg, nC, nCat, sb.N_ICE_LAYERS,
                                     sb.N_SNOW_LAYERS, sb.T_INIT)
        zero = jnp.zeros((nC, nCat))
        js = js.replace(
            iceEnthalpy=q_i, snowEnthalpy=q_s,
            iceSalinity=jnp.broadcast_to(jnp.asarray(
                jtv.bl99_salinity_profile(sb.N_ICE_LAYERS)),
                (nC, nCat, sb.N_ICE_LAYERS)),
            pondArea=zero, pondDepth=zero, pondLid=zero,
            levelIceArea=zero + 1.0, levelIceVolume=zero + 1.0, iceAge=zero)
    return jgrid, js, jf


class Paths:
    """Both paths' starts in both packages on the 100-cell box."""

    def __init__(self):
        self.jmesh = j_box_hex_mesh(12, 12, 10000.0)
        self.tmesh = convert.mesh_from_arrays(flatten(self.jmesh))
        self.start = {}
        for name in sb.PATHS:
            cfg = sb.config(name)
            tg, ts, tf, _ = sb.setup(name, self.tmesh, cfg, torch.float64,
                                     "cpu")
            self.start[name] = (tg, ts, tf)

    def configs(self, name, **kw):
        return (JCfg(**dataclasses.asdict(sb.config(name, **kw))),
                sb.config(name, **kw))

    def run(self, name, steps, grid_basis=None, **kw):
        """(port, reference) states after `steps` of each run_steps."""
        cj, ct = self.configs(name, **kw)
        jg, js, jf = reference_start(name, self.jmesh, cj)
        tg, ts, tf = self.start[name]
        if grid_basis is not None:
            jg = jstate.make_grid(self.jmesh, variational=grid_basis)
            tg = make_grid(self.tmesh, variational=grid_basis)
        return run_steps(tg, ct, ts, tf, steps), j_run_steps(jg, cj, js, jf,
                                                             steps)


@pytest.fixture(scope="module")
def paths():
    return Paths()


def test_setup_matches_the_reference_start(paths):
    for name in sb.PATHS:
        cj, _ = paths.configs(name)
        jg, js, jf = reference_start(name, paths.jmesh, cj)
        tg, ts, tf = paths.start[name]
        assert_close(ts, js, name, rel=0.0)
        assert_close(tf, jf, name, rel=0.0)
        assert_close(dataclasses.replace(tg, mesh=None), jg.replace(
            mesh=None), name, rel=1e-12)
    assert sb.config("seaice_box_10km_default") == sb.SeaiceConfig()


def test_default_path_3_steps(paths):
    got, ref = paths.run("seaice_box_10km_default", SLICE_STEPS,
                         config_dt=SLICE_DT,
                         config_elastic_subcycle_number=SLICE_SUBCYCLES)
    assert float(got.uVelocity.abs().max()) > 1e-3
    assert_contents(got, ref, "default")
    assert_close(got, ref, "default", rel=STEP_REL)


def assert_contents(got, ref, label):
    """The dynamics fields, and each tracer as its content
    (seaice_box.held_fields)."""
    held = sb.held_fields(convert.seaice_state_from_arrays(flatten(ref)))
    worst = max(float((g - held[k]).abs().max() / held[k].abs().max())
                for k, g in sb.held_fields(got).items()
                if float(held[k].abs().max()) > 0.0)
    print(f"{label}: worst departure {worst:.3e} x max")
    for k, g in sb.held_fields(got).items():
        assert_close(g, held[k], f"{label} {k}", rel=STEP_REL)


@pytest.mark.parametrize("basis,steps", [("wachspress", SLICE_STEPS),
                                         ("pwl", 1)])
def test_e3sm_path(paths, basis, steps):
    got, ref = paths.run("seaice_box_10km", steps, grid_basis=basis,
                         config_dt=SLICE_DT,
                         config_elastic_subcycle_number=SLICE_SUBCYCLES)
    assert float(got.uVelocity.abs().max()) > 1e-3
    assert_contents(got, ref, basis)
    assert float(got.iceAge.max()) == pytest.approx(steps * SLICE_DT,
                                                     rel=1e-12)


def test_revised_evp_one_step_at_the_paths_dt(paths):
    got, ref = paths.run("seaice_box_10km_default", 1,
                         config_revised_evp=True,
                         config_elastic_subcycle_number=PATH_SUBCYCLES)
    assert float(got.uVelocity.abs().max()) > 1e-4
    assert_close(got, ref, "revised", rel=STEP_REL)


def test_remap_sliver_enthalpy_is_unbounded(paths):
    """A fault of the reference, shared by the port: the incremental remap
    divides each child's content by its new parent (qs = qsv1 / vs1,
    remap.py:97-100), both from separately limited reconstructions, so a
    cell that receives a sliver of snow can get any enthalpy. One E3SM
    step at the paths' 3,600 s with 20 subcycles (transport only) leaves
    snow colder than -1,000 C in both packages; the velocities agree at
    1e-11, the snow enthalpy content there does not (printed)."""
    got, ref = paths.run("seaice_box_10km", 1, config_use_column_physics=False,
                         config_elastic_subcycle_number=PATH_SUBCYCLES)
    for k in ("uVelocity", "vVelocity", "stress11", "stress22",
              "stress12", "iceAreaCategory", "iceVolumeCategory"):
        assert_close(getattr(got, k), getattr(ref, k), k, rel=STEP_REL)
    cfg = sb.config("seaice_box_10km")
    t_port = float(ttv.temperature_snow(cfg, got.snowEnthalpy).min())
    t_ref = float(jtv.temperature_snow(cfg, ref.snowEnthalpy).min())
    content = [np.asarray(x.snowEnthalpy) * np.asarray(
        x.snowVolumeCategory)[..., None] for x in (got, ref)]
    dep = float(np.abs(content[0] - content[1]).max()
                / np.abs(content[1]).max())
    print(f"coldest snow: port {t_port:.1f} C, reference {t_ref:.1f} C; "
          f"snow enthalpy content departs {dep:.3e} x max")
    assert t_port < -1000.0 and t_ref < -1000.0


@pytest.mark.parametrize("advection", ["upwind", "incremental_remap"])
def test_transport_conserves_volume(paths, advection):
    """One step without column physics conserves the ice volume, under
    both transport schemes (the chip's full-size gate)."""
    tg, ts, tf = paths.start["seaice_box_10km"]
    cfg = sb.config("seaice_box_10km", config_advection_type=advection,
                    config_use_column_physics=False,
                    config_elastic_subcycle_number=PATH_SUBCYCLES)
    out = run_steps(tg, cfg, ts, tf, 1)
    v0, v1 = float(total_ice_volume(tg, ts)), float(total_ice_volume(tg,
                                                                    out))
    print(f"{advection}: volume change {(v1 - v0) / v0:.3e}")
    assert float(out.uVelocity.abs().max()) > 1e-3
    # the remap clamps negative cell volumes to 0 (remap.py:75-77)
    assert abs(v1 - v0) <= (1e-12 if advection == "upwind" else 1e-5) * v0


def test_paths_reach_no_kernel(paths, monkeypatch):
    """A sea-ice step calls neither kernel's wrapper: its stencils are the
    kite remaps, not the TRiSK contraction (the reference's step reaches
    no Pallas kernel)."""
    def refuse(*a, **k):
        raise AssertionError("a sea-ice step called a kernel wrapper")
    monkeypatch.setattr(stencils, "tinydot", refuse)
    for module in (acoustic, tinydot):
        for name in ("acoustic_cell_update", "tinydot"):
            monkeypatch.setattr(module, name, refuse, raising=False)
    for name in sb.PATHS:
        tg, ts, tf = paths.start[name]
        run_steps(tg, sb.config(name, config_elastic_subcycle_number=2),
                  ts, tf, 1)


def test_evp_subcycles_amplify_rounding(paths):
    """The reference's elastic subcycle amplifies a rounding difference at
    every iteration: a 1e-15 relative nudge of the start moves u after 3
    steps of 3,600 s with 20 subcycles by more than 1e-8 x max|u|, and
    after the 3-step runs' 600 s with 5 by less than 1e-11. The port
    computes the reference's arithmetic, so it shares this."""
    tg, ts, tf = paths.start["seaice_box_10km_default"]
    nudged = dataclasses.replace(ts, iceVolumeCategory=ts.iceVolumeCategory
                                 * (1.0 + 1e-15))
    spread = {}
    for dt, nsub in ((PATH_DT, PATH_SUBCYCLES), (SLICE_DT, SLICE_SUBCYCLES)):
        cfg = sb.config("seaice_box_10km_default", config_dt=dt,
                        config_elastic_subcycle_number=nsub)
        a = run_steps(tg, cfg, ts, tf, SLICE_STEPS).uVelocity
        b = run_steps(tg, cfg, nudged, tf, SLICE_STEPS).uVelocity
        spread[nsub] = float((a - b).abs().max() / a.abs().max())
    print(f"u spread after 3 steps: {spread}")
    assert spread[PATH_SUBCYCLES] > 1e-8
    assert spread[SLICE_SUBCYCLES] < 1e-11


def test_transport_leaves_tracers_behind(paths):
    """A fault of the reference, shared by the port: neither advect_upwind
    nor advect_incremental_remap moves the pond, level-ice, age or
    salinity tracers, and upwind leaves the enthalpies in place, so ice
    that moves leaves them at its old cells. Measured as the change of
    each tracer's content (tracer x parent, summed over the box's cells)
    in one transport of the E3SM path's state after 3 steps: a
    transported tracer keeps its content; these do not."""
    name = "seaice_box_10km"
    tg, ts, tf = paths.start[name]
    cfg = sb.config(name, config_elastic_subcycle_number=PATH_SUBCYCLES)
    state = run_steps(tg, cfg, ts, tf, SLICE_STEPS)
    jstate_ = jstate.SeaiceState(**{
        k: None if v is None else jnp.asarray(v)
        for k, v in convert.to_arrays(state).items()})
    jgrid = jstate.make_grid(paths.jmesh, variational=True)
    jcfg, _ = paths.configs(name)
    area = tg.mesh.areaCell.numpy()

    def content(s, k, parent):
        t, p = np.asarray(getattr(s, k)), np.asarray(getattr(s, parent))
        t = t if t.ndim == p.ndim else t.mean(-1)
        return float(((t * p).sum(-1) * area).sum())

    effects = {}
    for scheme, jfn, tfn in (
            ("incremental_remap", jremap.advect_incremental_remap,
             tremap.advect_incremental_remap),
            ("upwind", jadv.advect_upwind, tadv.advect_upwind)):
        got = tfn(tg, cfg, state, PATH_DT)
        ref = jfn(jgrid, jcfg, jstate_, PATH_DT)
        assert_close(got, ref, scheme, rel=STEP_REL)
        for k, parent in sb.TRACER_PARENTS.items():
            c0, c1 = content(state, k, parent), content(got, k, parent)
            if c0 != 0.0:
                effects[(scheme, k)] = abs(c1 - c0) / abs(c0)
            # the reference moves the parent and leaves the tracer
            if k not in ("surfaceTemperature",) and not (
                    scheme == "incremental_remap" and k in (
                        "iceEnthalpy", "snowEnthalpy")):
                assert torch.equal(getattr(got, k), getattr(state, k)), k
    print("content change in one transport:", {
        f"{s}:{k}": f"{v:.3e}" for (s, k), v in sorted(effects.items())})
    assert effects[("incremental_remap", "iceSalinity")] > 1e-6
    assert effects[("incremental_remap", "iceAge")] > 1e-6
    assert effects[("upwind", "iceEnthalpy")] > 1e-6
