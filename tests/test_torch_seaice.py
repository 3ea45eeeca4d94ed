"""The sea-ice core of the PyTorch port, function by function, against the
JAX package.

The 100-cell box (box_hex_mesh(12, 12, 10 km), the mesh of
tests/test_seaice_core.py) carried into the port through convert.py in
float64, with a seeded column state (5 categories, 7 ice and 1 snow
layer, every tracer, empty and near-empty categories), seeded forcing
(melting and freezing columns, frazil, rain and snow) and seeded vertex
velocities. Every ported function, ops/remap.py's included, is held to
its JAX twin at 1e-11 x max|ref|; the vectorised variational build to the
reference's per-cell loop at 1e-12 x max on the box and on the 642-cell
sphere (it is bit for bit on both).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpas_tpu.cores.seaice.orbital as jorb
# imported before any trace: the reference builds its band split at import
# (shortwave_dedd.py:28), and a first import inside run_steps' trace leaks
# it as a tracer (ROADMAP §3)
import mpas_tpu.cores.seaice.shortwave_dedd as jsw
from mpas_tpu.cores.seaice import advection as jadv
from mpas_tpu.cores.seaice import bgc as jbgc
from mpas_tpu.cores.seaice import column as jcol
from mpas_tpu.cores.seaice import core as jcore
from mpas_tpu.cores.seaice import itd as jitd
from mpas_tpu.cores.seaice import mushy as jmu
from mpas_tpu.cores.seaice import ponds as jponds
from mpas_tpu.cores.seaice import remap as jremap
from mpas_tpu.cores.seaice import ridging as jrdg
from mpas_tpu.cores.seaice import snow as jsnow
from mpas_tpu.cores.seaice import state as jstate
from mpas_tpu.cores.seaice import thermo_vertical as jtv
from mpas_tpu.cores.seaice import tracers as jtr
from mpas_tpu.cores.seaice import variational as jvar
from mpas_tpu.cores.seaice import velocity as jvel
from mpas_tpu.cores.seaice import zsalinity as jzs
from mpas_tpu.cores.seaice.config import SeaiceConfig as JCfg
from mpas_tpu.cores.seaice.init_square import init_square as j_init_square
from mpas_tpu.mesh.planar import box_hex_mesh as j_box_hex_mesh
from mpas_tpu.mesh.sphere import icosahedral_mesh as j_icosahedral_mesh
from mpas_tpu.ops import remap as jops_remap
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.seaice import advection as tadv
from mpas_tpu_torch.cores.seaice import bgc as tbgc
from mpas_tpu_torch.cores.seaice import column as tcol
from mpas_tpu_torch.cores.seaice import core as tcore
from mpas_tpu_torch.cores.seaice import itd as titd
from mpas_tpu_torch.cores.seaice import mushy as tmu
from mpas_tpu_torch.cores.seaice import orbital as torb
from mpas_tpu_torch.cores.seaice import ponds as tponds
from mpas_tpu_torch.cores.seaice import remap as tremap
from mpas_tpu_torch.cores.seaice import ridging as trdg
from mpas_tpu_torch.cores.seaice import shortwave_dedd as tsw
from mpas_tpu_torch.cores.seaice import snow as tsnow
from mpas_tpu_torch.cores.seaice import state as tstate
from mpas_tpu_torch.cores.seaice import thermo_vertical as ttv
from mpas_tpu_torch.cores.seaice import tracers as ttr
from mpas_tpu_torch.cores.seaice import variational as tvar
from mpas_tpu_torch.cores.seaice import velocity as tvel
from mpas_tpu_torch.cores.seaice import zsalinity as tzs
from mpas_tpu_torch.cores.seaice.config import SeaiceConfig as TCfg
from mpas_tpu_torch.cores.seaice.init_square import \
    init_square as t_init_square
from mpas_tpu_torch.mesh.planar import box_hex_mesh as t_box_hex_mesh
from mpas_tpu_torch.ops import remap as tops
from tests.test_torch_ocean import assert_close, flatten

torch.set_num_threads(1)

REL = 1e-11
GOLDEN = Path(__file__).resolve().parent / "golden" \
    / "seaice_variational_icos8.npz"
NCAT, NILYR, NSLYR = 5, 7, 1
DT = 3600.0
E3SM = dict(config_stress_divergence_scheme="variational",
            config_advection_type="incremental_remap",
            config_thermo_type="mushy", config_use_zsalinity=True,
            config_shortwave_type="dedd", config_pond_scheme="lvl",
            config_itd_remap_type="linear", config_use_ice_age=True)


def cfgs(**kw):
    """The same configuration in both packages."""
    return JCfg(**kw), TCfg(**kw)


def both(*arrays):
    """numpy arrays -> ([jax arrays], [torch tensors])."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


class Case:
    """The seeded box in both packages: `j*` reference objects, `t*` port
    objects, `a` the numpy arrays behind the state and forcing."""

    def __init__(self):
        self.jmesh = j_box_hex_mesh(12, 12, 10000.0)
        self.tmesh = convert.mesh_from_arrays(flatten(self.jmesh))
        self.jgrid = jstate.make_grid(self.jmesh, variational=True)
        self.tgrid = convert.seaice_grid_from_arrays(flatten(self.jgrid))
        m = self.jmesh
        nC, nV = m.nCells, m.nVertices
        rng = np.random.default_rng(0)
        mid = np.array([0.3, 1.0, 1.9, 3.5, 6.0])
        a = rng.uniform(0.0, 0.25, (nC, NCAT))
        a[rng.uniform(size=a.shape) < 0.1] = 0.0          # empty
        a[rng.uniform(size=a.shape) < 0.05] = 1e-9        # near-empty
        a[:7] *= 5.0                                       # over-full
        h = mid * (1.0 + 0.4 * rng.uniform(-1.0, 1.0, a.shape))
        h[:, 0] = np.minimum(h[:, 0], 0.6)
        h[:3, 0] = 0.005                                   # thin ice
        T_lyr = rng.uniform(-18.0, -1.5, (nC, NCAT, NILYR))
        S = jtv.bl99_salinity_profile(NILYR) \
            + rng.uniform(0.0, 4.0, (nC, NCAT, NILYR))
        cfg = JCfg(config_thermo_type="mushy")
        interior = np.asarray(self.jgrid.interiorVertex)
        self.a = dict(
            iceAreaCategory=a, iceVolumeCategory=a * h,
            snowVolumeCategory=a * rng.uniform(0.0, 0.4, a.shape),
            surfaceTemperature=rng.uniform(-25.0, -0.1, a.shape),
            uVelocity=0.15 * rng.standard_normal(nV) * interior,
            vVelocity=0.15 * rng.standard_normal(nV) * interior,
            stress11=2e3 * rng.standard_normal(nC),
            stress22=2e3 * rng.standard_normal(nC),
            stress12=1e3 * rng.standard_normal(nC),
            iceEnthalpy=np.asarray(jtv.enthalpy_mush(cfg, T_lyr, S)),
            snowEnthalpy=np.asarray(jtv.enthalpy_snow(
                cfg, rng.uniform(-20.0, -0.5, (nC, NCAT, NSLYR)))),
            pondArea=rng.uniform(0.0, 0.4, a.shape),
            pondDepth=rng.uniform(0.0, 0.3, a.shape),
            pondLid=rng.uniform(0.0, 0.05, a.shape),
            levelIceArea=rng.uniform(0.5, 1.0, a.shape),
            levelIceVolume=rng.uniform(0.5, 1.0, a.shape),
            iceAge=rng.uniform(0.0, 3e7, a.shape),
            firstYearArea=rng.uniform(0.0, 1.0, a.shape),
            brineHeight=rng.uniform(0.0, 1.0, a.shape),
            iceSalinity=S,
            algaeIce=rng.uniform(0.0, 0.5, a.shape),
            nitrateIce=rng.uniform(0.0, 8.0, a.shape),
            silicateIce=rng.uniform(0.0, 15.0, a.shape),
            snowGrainRadius=rng.uniform(60e-6, 1000e-6, a.shape),
            snowDensity=rng.uniform(150.0, 390.0, a.shape))
        xs = np.linspace(0.0, 1.0, nC)
        self.f = dict(
            uAirVelocity=8.0 * rng.standard_normal(nC),
            vAirVelocity=8.0 * rng.standard_normal(nC),
            # cold columns and melting ones (air above 0 C, strong sun)
            airTemperature=np.where(xs < 0.6, -20.0 + 10.0 * xs, 3.0),
            shortwaveDown=np.where(xs < 0.6, 20.0, 450.0)
            + 10.0 * rng.uniform(size=nC),
            longwaveDown=220.0 + 100.0 * rng.uniform(size=nC),
            uOceanVelocity=0.1 * rng.standard_normal(nC),
            vOceanVelocity=0.1 * rng.standard_normal(nC),
            seaSurfaceTemperature=np.full(nC, -1.8),
            # negative heat flux in some columns: frazil growth
            oceanHeatFlux=rng.uniform(-30.0, 20.0, nC),
            sshGradientU=1e-6 * rng.standard_normal(nV),
            sshGradientV=1e-6 * rng.standard_normal(nV),
            rainfallRate=rng.uniform(0.0, 1e-4, nC),
            snowfallRate=rng.uniform(0.0, 1e-7, nC))
        self.jstate = jstate.SeaiceState(
            **{k: jnp.asarray(v) for k, v in self.a.items()})
        self.tstate = convert.seaice_state_from_arrays(flatten(self.jstate))
        self.jforcing = jstate.SeaiceForcing(
            **{k: jnp.asarray(v) for k, v in self.f.items()})
        self.tforcing = convert.seaice_forcing_from_arrays(
            flatten(self.jforcing))

    def cols(self, *names):
        """(jax, torch) lists of the named state arrays."""
        return both(*(self.a[n] for n in names))

    def fields(self, shape, seed, scale=1.0, lo=None):
        rng = np.random.default_rng(seed)
        x = scale * (rng.standard_normal(shape) if lo is None
                     else rng.uniform(lo, 1.0, shape))
        return both(x)


@pytest.fixture(scope="module")
def case():
    return Case()


def states(case, **fields):
    """The case's state in both packages with some fields replaced (None
    drops a tracer)."""
    j = case.jstate.replace(**{k: None if v is None else jnp.asarray(v)
                               for k, v in fields.items()})
    return j, convert.seaice_state_from_arrays(flatten(j))


# ---------------------------------------------------------------------------
# containers, grid, initial condition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variational", [False, True, "pwl"])
def test_make_grid(case, variational):
    got = tstate.make_grid(case.tmesh, variational=variational)
    ref = jstate.make_grid(case.jmesh, variational=variational)
    assert_close(dataclasses.replace(got, mesh=None),
                 ref.replace(mesh=None), "grid", rel=0.0)


def test_zero_state_and_converters(case):
    z = tstate.zero_state(case.tmesh, NCAT, device="cpu")
    zr = jstate.zero_state(case.jmesh, NCAT)
    assert_close(z, zr, "zero_state", rel=0.0)
    back = convert.to_arrays(case.tstate)
    for k, v in case.a.items():
        assert np.array_equal(back[k], v), k


def test_init_square_bit_for_bit():
    cfg_j, cfg_t = cfgs()
    jg, js, jf = j_init_square(j_box_hex_mesh(12, 12, 10000.0), cfg_j)
    tg, ts, tf = t_init_square(t_box_hex_mesh(12, 12, 10000.0), cfg_t,
                               device="cpu")
    assert_close(ts, js, "state", rel=0.0)
    assert_close(tf, jf, "forcing", rel=0.0)
    assert_close(dataclasses.replace(tg, mesh=None), jg.replace(mesh=None),
                 "grid", rel=0.0)


# ---------------------------------------------------------------------------
# variational basis: the vectorised build against the per-cell loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere8():
    jm = j_icosahedral_mesh(8, 1)
    return jm, convert.mesh_from_arrays(flatten(jm))


@pytest.mark.parametrize("basis", ["wachspress", "pwl"])
@pytest.mark.parametrize("where", ["box", "sphere"])
def test_build_variational_coeffs(case, sphere8, where, basis):
    jm, tm = (case.jmesh, case.tmesh) if where == "box" else sphere8
    got = tvar.build_variational_coeffs(tm, basis)
    ref = jvar.build_variational_coeffs(jm, basis)
    assert_close(got, ref, f"{where} {basis}", rel=1e-12)
    if (where, basis) == ("sphere", "wachspress"):
        # chip_smoke.py holds the card host's build to this golden
        golden = np.load(GOLDEN)
        for f in dataclasses.fields(ref):
            assert np.array_equal(golden[f.name],
                                  np.asarray(getattr(ref, f.name))), f.name


def test_vertex_integral_columns_layout(case):
    """sx[cell_on_v, :, corner_on_v] mixes advanced indices around a slice:
    numpy puts the broadcast dims first, (nV, vd, mE)."""
    c = case.tgrid.variational
    sx_col, sy_col = tvar.vertex_integral_columns(c)
    cv, lv = c.cell_on_v.numpy(), c.corner_on_v.numpy()
    val = c.valid_on_v.numpy()[..., None]
    for got, full in ((sx_col, c.sx), (sy_col, c.sy)):
        ref = full.numpy()[cv, :, lv]
        assert ref.shape == (case.tmesh.nVertices, case.tmesh.vertexDegree,
                             case.tmesh.maxEdges)
        assert np.array_equal(got.numpy(), ref * val)


def test_strain_and_divergence_variational(case):
    (ju, jv), (tu, tv) = case.cols("uVelocity", "vVelocity")
    got = tvar.strain_tensor_variational(case.tmesh, case.tgrid.variational,
                                         tu, tv)
    ref = jvar.strain_tensor_variational(case.jmesh, case.jgrid.variational,
                                         ju, jv)
    assert_close(got, ref, "strain")
    shape = (case.tmesh.nCells, case.tmesh.maxEdges)
    (j11, j22, j12), (t11, t22, t12) = both(
        *(1e3 * np.random.default_rng(s).standard_normal(shape)
          for s in (1, 2, 3)))
    assert_close(tvar.stress_divergence_variational(
        case.tmesh, case.tgrid.variational, t11, t22, t12),
        jvar.stress_divergence_variational(
            case.jmesh, case.jgrid.variational, j11, j22, j12), "div")


# ---------------------------------------------------------------------------
# ops/remap.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trailing", [(), (NCAT,), (NCAT, NILYR)])
def test_cell_gradient(case, trailing):
    (jp,), (tp,) = case.fields((case.tmesh.nCells,) + trailing, 4)
    m, jm = case.tmesh, case.jmesh
    assert_close(tops.cell_gradient(m, tp, m.xCell, m.yCell),
                 jops_remap.cell_gradient(jm, jp, jm.xCell, jm.yCell),
                 "cell_gradient")


def test_remap_fluxes(case):
    m, jm = case.tmesh, case.jmesh
    (ju, jv), (tu, tv) = case.cols("uVelocity", "vVelocity")
    got = tops.departure_triangles(m, tu, tv, DT)
    ref = jops_remap.departure_triangles(jm, ju, jv, DT)
    assert_close(got, ref, "departure_triangles")
    assert_close(tremap._departure_triangles(case.tgrid, tu, tv, DT),
                 jremap._departure_triangles(case.jgrid, ju, jv, DT),
                 "adapter")
    fa, qx, qy = got
    jfa, jqx, jqy = ref
    nC = m.nCells
    (jp, jc, jq), (tp, tc, tq) = both(
        np.random.default_rng(5).uniform(size=(nC, NCAT)),
        np.random.default_rng(6).uniform(size=(nC, NCAT)),
        np.random.default_rng(7).uniform(size=(nC, NCAT, NILYR)))
    tg = [tops.cell_gradient(m, x, m.xCell, m.yCell) for x in (tp, tc, tq)]
    jg = [jops_remap.cell_gradient(jm, x, jm.xCell, jm.yCell)
          for x in (jp, jc, jq)]
    assert_close(tops.edge_flux(m, fa, qx, qy, [tp, tq], [tg[0][0],
                                                          tg[2][0]],
                                [tg[0][1], tg[2][1]], m.xCell, m.yCell),
                 jops_remap.edge_flux(jm, jfa, jqx, jqy, [jp, jq],
                                      [jg[0][0], jg[2][0]],
                                      [jg[0][1], jg[2][1]], jm.xCell,
                                      jm.yCell), "edge_flux")
    for (tch, tcg, jch, jcg) in ((tc, tg[1], jc, jg[1]),
                                 (tq, tg[2], jq, jg[2])):
        flux = tops.product_flux(m, fa, qx, qy, tp, *tg[0], tch, *tcg,
                                 m.xCell, m.yCell)
        assert_close(flux, jops_remap.product_flux(
            jm, jfa, jqx, jqy, jp, *jg[0], jch, *jcg, jm.xCell, jm.yCell),
            "product_flux")
        assert_close(tops.apply_fluxes(m, flux, tch),
                     jops_remap.apply_fluxes(
                         jm, jops_remap.product_flux(
                             jm, jfa, jqx, jqy, jp, *jg[0], jch, *jcg,
                             jm.xCell, jm.yCell), jch), "apply_fluxes")


# ---------------------------------------------------------------------------
# velocity solver
# ---------------------------------------------------------------------------

def test_aggregate_strength_air_stress(case):
    cj, ct = cfgs()
    agg = tvel.aggregate_state(ct, case.tstate)
    assert_close(agg, jvel.aggregate_state(cj, case.jstate), "aggregate")
    assert_close(tvel.ice_strength(ct, agg[0], agg[1]),
                 jvel.ice_strength(cj, *jvel.aggregate_state(
                     cj, case.jstate)[:2]), "strength")
    (jav,), (tav,) = case.fields((case.tmesh.nVertices,), 8, lo=0.0)
    assert_close(tvel.air_stress(ct, case.tgrid, case.tforcing, tav),
                 jvel.air_stress(cj, case.jgrid, case.jforcing, jav),
                 "air_stress")


def test_weak_operators(case):
    (ju, jv), (tu, tv) = case.cols("uVelocity", "vVelocity")
    nC, nV = case.tmesh.nCells, case.tmesh.nVertices
    (jm, jsv), (tm, tsv) = both(
        (np.random.default_rng(9).uniform(size=nC) > 0.2).astype(float),
        (np.random.default_rng(10).uniform(size=nV) > 0.2).astype(float))
    assert_close(tvel.strain_tensor_weak(case.tgrid, tu, tv, tm),
                 jvel.strain_tensor_weak(case.jgrid, ju, jv, jm), "strain")
    (j11, j22, j12), (t11, t22, t12) = case.cols("stress11", "stress22",
                                                 "stress12")
    assert_close(tvel.stress_divergence_weak(case.tgrid, t11, t22, t12, tsv),
                 jvel.stress_divergence_weak(case.jgrid, j11, j22, j12, jsv),
                 "divergence")


@pytest.mark.parametrize("revised", [False, True])
def test_evp_constitutive(case, revised):
    cj, ct = cfgs()
    shape = (case.tmesh.nCells, case.tmesh.maxEdges)
    rng = np.random.default_rng(11)
    arrs = [1e3 * rng.standard_normal(shape) for _ in range(3)] \
        + [1e-6 * rng.standard_normal(shape) for _ in range(3)] \
        + [5e4 * rng.uniform(size=shape)]
    arrs[3][0] = 0.0                      # zero strain: delta below puny
    j, t = both(*arrs)
    if revised:
        got = tvel.evp_constitutive_revised(ct, *t)
        ref = jvel.evp_constitutive_revised(cj, *j)
    else:
        got = tvel.evp_constitutive(ct, *t, 30.0, 1296.0)
        ref = jvel.evp_constitutive(cj, *j, 30.0, 1296.0)
    assert_close(got, ref, "evp")


def test_principal_stresses(case):
    cj, ct = cfgs()
    nC = case.tmesh.nCells
    p = np.random.default_rng(12).uniform(size=nC) * 1e4
    p[::7] = 0.0                          # no strength: NaN in both
    (j11, j22, j12), (t11, t22, t12) = case.cols("stress11", "stress22",
                                                 "stress12")
    (jp,), (tp,) = both(p)
    got = tvel.principal_stresses(ct, t11, t22, t12, tp)
    ref = jvel.principal_stresses(cj, j11, j22, j12, jp)
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert np.array_equal(np.isnan(g), np.isnan(r))
        ok = ~np.isnan(r)
        assert np.abs(g[ok] - r[ok]).max() <= REL * np.abs(r[ok]).max()


SOLVES = {"weak": {}, "variational": dict(
    config_stress_divergence_scheme="variational"),
    "weak_revised": dict(config_revised_evp=True),
    "variational_revised": dict(config_stress_divergence_scheme="variational",
                                config_revised_evp=True),
    "coriolis_no_tilt": dict(config_use_coriolis=True,
                             config_use_surface_tilt=False,
                             config_use_air_stress=False,
                             config_dynamics_subcycle_number=2),
    "no_ocean_stress": dict(config_use_ocean_stress=False)}


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_velocities(case, name):
    cj, ct = cfgs(config_elastic_subcycle_number=4, **SOLVES[name])
    got = tvel.solve_velocities(case.tgrid, ct, case.tstate, case.tforcing,
                                DT)
    ref = jvel.solve_velocities(case.jgrid, cj, case.jstate, case.jforcing,
                                DT)
    assert_close(got[0], ref[0], name)
    assert_close(tuple(got[1][k] for k in sorted(ref[1])),
                 tuple(ref[1][k] for k in sorted(ref[1])), name)


def test_variational_needs_its_grid(case):
    _, ct = cfgs(config_stress_divergence_scheme="variational")
    with pytest.raises(ValueError, match="variational"):
        tvel.solve_velocities(dataclasses.replace(case.tgrid,
                                                  variational=None),
                              ct, case.tstate, case.tforcing, DT)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

def test_upwind(case):
    cj, ct = cfgs()
    (ju, jv), (tu, tv) = case.cols("uVelocity", "vVelocity")
    un_t = tadv.edge_normal_velocity(case.tgrid, tu, tv)
    un_j = jadv.edge_normal_velocity(case.jgrid, ju, jv)
    assert_close(un_t, un_j, "un")
    for name in ("iceAreaCategory", "stress11"):
        (jp,), (tp,) = case.cols(name)
        assert_close(tadv._upwind_tend(case.tgrid, un_t, tp),
                     jadv._upwind_tend(case.jgrid, un_j, jp), name)
    assert_close(tadv.advect_upwind(case.tgrid, ct, case.tstate, DT),
                 jadv.advect_upwind(case.jgrid, cj, case.jstate, DT),
                 "advect_upwind")


@pytest.mark.parametrize("enthalpy", [True, False])
def test_incremental_remap(case, enthalpy):
    cj, ct = cfgs()
    js, ts = (case.jstate, case.tstate) if enthalpy else states(
        case, iceEnthalpy=None, snowEnthalpy=None)
    assert_close(tremap.advect_incremental_remap(case.tgrid, ct, ts, DT),
                 jremap.advect_incremental_remap(case.jgrid, cj, js, DT),
                 "remap")


# ---------------------------------------------------------------------------
# thermodynamics: relations, the multilayer solve, shortwave
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mushy", [False, True])
def test_thermo_relations(case, mushy):
    cj, ct = cfgs(config_thermo_type="mushy" if mushy else "bl99")
    (jq, jS, js), (tq, tS, ts) = case.cols("iceEnthalpy", "iceSalinity",
                                          "snowEnthalpy")
    tinv = ttv.temperature_mush if mushy else ttv.temperature_ice_bl99
    jinv = jtv.temperature_mush if mushy else jtv.temperature_ice_bl99
    T_t, T_j = tinv(ct, tq, tS), jinv(cj, jq, jS)
    assert_close(T_t, T_j, "T")
    assert_close(ttv.enthalpy_fn(ct, mushy)(T_t, tS),
                 jtv.enthalpy_fn(cj, mushy)(T_j, jS), "q")
    assert_close(ttv.conductivity_ice(ct, T_t, tS, mushy),
                 jtv.conductivity_ice(cj, T_j, jS, mushy), "k")
    assert_close(ttv.heat_capacity_ice(ct, T_t, tS),
                 jtv.heat_capacity_ice(cj, T_j, jS), "c")
    Ts_t = ttv.temperature_snow(ct, ts)
    assert_close(Ts_t, jtv.temperature_snow(cj, js), "T snow")
    assert_close(ttv.enthalpy_snow(ct, Ts_t),
                 jtv.enthalpy_snow(cj, jtv.temperature_snow(cj, js)),
                 "q snow")
    assert np.array_equal(ttv.bl99_salinity_profile(NILYR),
                          jtv.bl99_salinity_profile(NILYR))
    assert_close(ttv.init_enthalpy(ct, 4, NCAT, NILYR, NSLYR, -7.0,
                                   device="cpu"),
                 jtv.init_enthalpy(cj, 4, NCAT, NILYR, NSLYR, -7.0),
                 "init_enthalpy")
    (ja, jvi, jvs), (ta, tvi, tvs) = case.cols(
        "iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory")
    assert_close(ttv.column_energy(ct, ta, tvi, tvs, tq, ts),
                 jtv.column_energy(cj, ja, jvi, jvs, jq, js), "energy")


@pytest.mark.parametrize("thermo,shortwave,salinity", [
    ("bl99", "ccsm3", False), ("mushy", "ccsm3", True),
    ("mushy", "dedd", True), ("bl99", "dedd", False)])
def test_thermodynamics_multilayer(case, thermo, shortwave, salinity):
    kw = dict(config_thermo_type=thermo, config_shortwave_type=shortwave,
              config_use_zsalinity=salinity)
    cj, ct = cfgs(**kw)
    assert_close(tcol.thermodynamics_multilayer(ct, case.tstate,
                                                case.tforcing, DT),
                 jcol.thermodynamics_multilayer(cj, case.jstate,
                                                case.jforcing, DT), thermo)


def test_thermo_multilayer_diagnostics(case):
    cj, ct = cfgs(config_thermo_type="mushy")
    names = ("iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory",
             "surfaceTemperature", "iceEnthalpy", "snowEnthalpy")
    j, t = case.cols(*names)
    f = case.f
    (jsw_, jlw, jta, jfo), (tsw_, tlw, tta, tfo) = both(
        *(f[k][:, None] for k in ("shortwaveDown", "longwaveDown",
                                  "airTemperature", "oceanHeatFlux")))
    got = ttv.thermo_multilayer(ct, *t, tsw_, tlw, tta, tfo, DT)
    ref = jtv.thermo_multilayer(cj, *j, jsw_, jlw, jta, jfo, DT)
    assert_close(got[:6], ref[:6], "thermo_multilayer")
    assert_close(tuple(got[6][k] for k in sorted(ref[6])),
                 tuple(ref[6][k] for k in sorted(ref[6])), "diags")


def test_dedd_shortwave(case):
    cj, ct = cfgs()
    (ja, jvi, jvs), (ta, tvi, tvs) = case.cols(
        "iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory")
    h_t = torch.where(ta > 1e-11, tvi / ta.clamp(min=1e-11), 0.0)
    hs_t = torch.where(ta > 1e-11, tvs / ta.clamp(min=1e-11), 0.0)
    h_j, hs_j = jnp.asarray(h_t.numpy()), jnp.asarray(hs_t.numpy())
    assert_close(tsw.dedd_shortwave(ct, h_t, hs_t, NILYR),
                 jsw.dedd_shortwave(cj, h_j, hs_j, NILYR), "dedd")
    tau = np.random.default_rng(13).uniform(0.0, 50.0, 40)
    (jt_, jw, jg), (tt_, tw, tg) = both(tau, np.full(40, 0.97),
                                        np.full(40, 0.9))
    R_t, T_t = tsw._layer_rt(tt_, tw, tg)
    R_j, T_j = jsw._layer_rt(jt_, jw, jg)
    assert_close((R_t, T_t), (R_j, T_j), "layer_rt")
    assert_close(tsw._add_layers(R_t, T_t, R_t, T_t),
                 jsw._add_layers(R_j, T_j, R_j, T_j), "add_layers")


def test_surface_temperature_solve(case):
    cj, ct = cfgs()
    rng = np.random.default_rng(14)
    shape = (case.tmesh.nCells, NCAT)
    j, t = both(rng.uniform(-30, 0, shape), rng.uniform(0, 4, shape),
                rng.uniform(0, 0.5, shape), rng.uniform(0, 200, shape),
                rng.uniform(150, 320, shape), rng.uniform(-30, 2, shape),
                np.full(shape, -1.8))
    assert_close(tcol.surface_temperature_solve(ct, *t),
                 jcol.surface_temperature_solve(cj, *j), "Ts")


def test_zero_layer_and_rebin(case):
    cj, ct = cfgs()
    assert_close(tcol.thermodynamics(ct, case.tstate, case.tforcing, DT),
                 jcol.thermodynamics(cj, case.jstate, case.jforcing, DT),
                 "thermodynamics")
    assert_close(tcol.itd_remap(ct, case.tstate),
                 jcol.itd_remap(cj, case.jstate), "itd_remap")
    js, ts = states(case, iceEnthalpy=None, snowEnthalpy=None)
    assert_close(tcol.itd_remap(ct, ts), jcol.itd_remap(cj, js), "rebin")


# ---------------------------------------------------------------------------
# mushy brine dynamics and zsalinity
# ---------------------------------------------------------------------------

def mushy_inputs(case):
    """T, S and the column geometry of the case, (jax, torch)."""
    cj, _ = cfgs(config_thermo_type="mushy")
    a = case.a
    has = a["iceAreaCategory"] > 1e-11
    h = np.where(has, a["iceVolumeCategory"]
                 / np.maximum(a["iceAreaCategory"], 1e-11), 0.0)
    hs = np.where(has, a["snowVolumeCategory"]
                  / np.maximum(a["iceAreaCategory"], 1e-11), 0.0)
    T = np.asarray(jtv.temperature_mush(cj, a["iceEnthalpy"],
                                        a["iceSalinity"]))
    sss = np.full((a["iceAreaCategory"].shape[0], 1), 34.0)
    Tbot = np.asarray(jmu.liquidus_temperature(sss))
    return both(T, a["iceSalinity"], a["surfaceTemperature"],
                Tbot * np.ones_like(h), h, hs, a["pondDepth"],
                a["pondArea"], sss, np.asarray(jmu.enthalpy_brine(Tbot)))


def test_mushy_relations(case):
    j, t = mushy_inputs(case)
    jT, jS, tT, tS = j[0], j[1], t[0], t[1]
    for name in ("liquidus_brine_salinity", "enthalpy_brine",
                 "density_brine"):
        arg_t = tS if name == "density_brine" else tT
        arg_j = jS if name == "density_brine" else jT
        assert_close(getattr(tmu, name)(arg_t), getattr(jmu, name)(arg_j),
                     name)
    assert_close(tmu.liquidus_temperature(tS), jmu.liquidus_temperature(jS),
                 "liquidus_temperature")
    phi_t, phi_j = tmu.liquid_fraction(tT, tS), jmu.liquid_fraction(jT, jS)
    assert_close(phi_t, phi_j, "liquid_fraction")
    assert_close(tmu.permeability(phi_t), jmu.permeability(phi_j), "perm")
    q_t, q_j = tmu.enthalpy_mush(tT, tS), jmu.enthalpy_mush(jT, jS)
    assert_close(q_t, q_j, "enthalpy_mush")
    assert_close(tmu.temperature_mush(q_t, tS), jmu.temperature_mush(q_j, jS),
                 "temperature_mush")
    # the melted branch: enthalpy above the liquidus
    assert_close(tmu.temperature_mush(q_t + 4e8, tS),
                 jmu.temperature_mush(q_j + 4e8, jS), "melted")


def test_mushy_drainage(case):
    j, t = mushy_inputs(case)
    out = []
    for m, (T, S, Tsf, Tbot, h, hs, hp, ap, sss, qocn) in (
            (tmu, t), (jmu, j)):
        hilyr = (h.clamp(min=1e-6) if m is tmu
                 else jnp.maximum(h, 1e-6)) / NILYR
        q, dSdt, Sbr, qbr, phi = m.explicit_flow_velocities(
            S, T, Tsf, Tbot, DT, sss, qocn, hilyr, h)
        w = m.flushing_velocity(T, phi, h, hs, hilyr, hp, ap, DT)
        sal = m.solve_salinity(S, Sbr, 0.0, sss, q, dSdt, w, hilyr, DT)
        heat = m.drainage_heat_flux(q, w, qbr, qocn)
        out.append((q, dSdt, Sbr, qbr, phi, w, *sal, heat))
    assert_close(out[0], out[1], "drainage")


@pytest.mark.parametrize("n_picard", [2, 3])
def test_mushy_coupled_step(case, n_picard):
    j, t = mushy_inputs(case)
    assert_close(tmu.mushy_coupled_step(*t, DT, n_picard=n_picard),
                 jmu.mushy_coupled_step(*j, DT, n_picard=n_picard), "mushy")


def test_zsalinity(case):
    cj, ct = cfgs(config_use_zsalinity=True)
    rng = np.random.default_rng(15)
    nC = case.tmesh.nCells
    a = case.a
    h = a["iceVolumeCategory"] / np.maximum(a["iceAreaCategory"], 1e-11)
    h[::9] = 5e-4                             # below the 1 mm cut
    j, t = both(a["iceSalinity"] * 3.0, h,
                rng.uniform(0.0, 2e-6, (nC, NCAT)),
                rng.uniform(0.0, 0.05, (nC, NCAT)),
                rng.uniform(28.0, 35.0, nC))
    assert_close(tzs.zsalinity_step(ct, *t, DT),
                 jzs.zsalinity_step(cj, *j, DT), "zsalinity_step")
    assert_close(tzs.local_rayleigh(t[0], t[1], t[4]),
                 jzs.local_rayleigh(j[0], j[1], j[4]), "rayleigh")
    assert np.array_equal(tzs.stable_profile(NILYR),
                          jzs.stable_profile(NILYR))
    (jT,), (tT,) = case.fields((nC, NCAT, NILYR), 16, scale=5.0)
    assert_close(tzs.mushy_liquid_fraction(t[0], tT),
                 jzs.mushy_liquid_fraction(j[0], jT), "phi")


# ---------------------------------------------------------------------------
# ponds, ridging, the linear ITD, tracers, snow, BGC, orbit
# ---------------------------------------------------------------------------

def pond_inputs(case):
    rng = np.random.default_rng(17)
    a = case.a
    shape = a["iceAreaCategory"].shape
    h = np.where(a["iceAreaCategory"] > 1e-11, a["iceVolumeCategory"]
                 / np.maximum(a["iceAreaCategory"], 1e-11), 0.0)
    hs = np.where(a["iceAreaCategory"] > 1e-11, a["snowVolumeCategory"]
                  / np.maximum(a["iceAreaCategory"], 1e-11), 0.0)
    # cold surfaces (refreeze, lid growth) and warm ones (melt)
    t_sfc = np.where(rng.uniform(size=shape) < 0.5, -8.0, -0.5)
    return dict(a=a["iceAreaCategory"], h=h, hs=hs, t=t_sfc,
                ap=a["pondArea"], hp=a["pondDepth"], ip=a["pondLid"],
                alvl=a["levelIceArea"],
                mi=rng.uniform(0.0, 0.02, shape),
                ms=rng.uniform(0.0, 0.02, shape),
                rain=rng.uniform(0.0, 1e-6, shape))


@pytest.mark.parametrize("scheme", ["cesm", "lvl", "lvl_t_ice", "topo"])
def test_ponds(case, scheme):
    cj, ct = cfgs()
    p = pond_inputs(case)
    fn, names = {
        "cesm": ("ponds_cesm", ("a", "h", "t", "ap", "hp", "mi", "ms",
                                "rain")),
        "topo": ("ponds_topo", ("a", "h", "hs", "t", "ap", "hp", "mi", "ms",
                                "rain"))}.get(
        scheme, ("ponds_lvl", ("a", "h", "t", "ap", "hp", "ip", "alvl", "mi",
                               "ms", "rain")))
    j, t = both(*(p[n] for n in names))
    if scheme == "lvl_t_ice":
        (jT, jS), (tT, tS) = both(
            np.asarray(jtv.temperature_mush(cj, case.a["iceEnthalpy"],
                                            case.a["iceSalinity"])),
            case.a["iceSalinity"])
        got = tponds.ponds_lvl(ct, *t, DT, t_ice=tT, s_ice=tS)
        ref = jponds.ponds_lvl(cj, *j, DT, t_ice=jT, s_ice=jS)
    else:
        got = getattr(tponds, fn)(ct, *t, DT)
        ref = getattr(jponds, fn)(cj, *j, DT)
    assert_close(got, ref, scheme)
    assert_close(tponds.pond_albedo_reduction(t[3], t[4]),
                 jponds.pond_albedo_reduction(j[3], j[4]), "albedo")


@pytest.mark.parametrize("closing", [False, True])
def test_ridge_step(case, closing):
    cj, ct = cfgs()
    names = ("iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory",
             "surfaceTemperature", "iceEnthalpy", "snowEnthalpy")
    j, t = case.cols(*names)
    kw_j, kw_t = {}, {}
    if closing:
        (jc,), (tc,) = case.fields((case.tmesh.nCells,), 18, scale=2e-6)
        kw_j, kw_t = dict(closing_rate=jc), dict(closing_rate=tc)
    got = trdg.ridge_step(ct, *t[:4], DT, q_ice=t[4], q_snow=t[5], **kw_t)
    ref = jrdg.ridge_step(cj, *j[:4], DT, q_ice=j[4], q_snow=j[5], **kw_j)
    assert_close(got, ref, "ridge_step")
    assert_close(tcol.ridge(ct, case.tstate, DT, **kw_t),
                 jcol.ridge(cj, case.jstate, DT, **kw_j), "ridge")


def test_linear_remap(case):
    cj, ct = cfgs(config_itd_remap_type="linear")
    names = ("iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory",
             "surfaceTemperature", "iceEnthalpy", "snowEnthalpy",
             "pondArea", "iceAge", "brineHeight")
    j, t = case.cols(*names)
    # thermodynamic growth/melt moved the means across the bounds
    f = np.random.default_rng(19).uniform(0.5, 1.6, case.a[
        "iceVolumeCategory"].shape)
    (jv2,), (tv2,) = both(case.a["iceVolumeCategory"] * f)
    got = titd.linear_remap(ct, t[0], tv2, *t[2:4], q_ice=t[4],
                            q_snow=t[5], area_tracers=tuple(t[6:8]),
                            vol_tracers=(t[8],))
    ref = jitd.linear_remap(cj, j[0], jv2, *j[2:4], q_ice=j[4],
                            q_snow=j[5], area_tracers=tuple(j[6:8]),
                            vol_tracers=(j[8],))
    assert_close(got, ref, "linear_remap")


def test_tracers(case):
    (ja, jage, jfy, jal, jvl, jv), (ta, tage, tfy, tal, tvl, tv) = \
        case.cols("iceAreaCategory", "iceAge", "firstYearArea",
                  "levelIceArea", "levelIceVolume", "iceVolumeCategory")
    assert_close(ttr.increment_age(tage, ta, DT),
                 jtr.increment_age(jage, ja, DT), "age")
    season = np.random.default_rng(20).uniform(size=ta.shape) < 0.5
    assert_close(ttr.update_first_year_area(tfy, ta,
                                            torch.from_numpy(season)),
                 jtr.update_first_year_area(jfy, ja, jnp.asarray(season)),
                 "first year")
    assert_close(ttr.ridging_level_ice_update(tal, tvl, ta, tv, ta * 0.8,
                                              tv * 0.9),
                 jtr.ridging_level_ice_update(jal, jvl, ja, jv, ja * 0.8,
                                              jv * 0.9), "level ice")


def test_update_aerosol(case):
    rng = np.random.default_rng(21)
    nC, ns = case.tmesh.nCells, 3
    hs = rng.uniform(0.0, 0.3, (nC, NCAT))
    hs[::4] = 0.0
    hi = rng.uniform(0.0, 2.0, (nC, NCAT))
    hi[::11] = 0.0
    j, t = both(*(rng.uniform(0.0, 1e-4, (nC, NCAT, ns)) for _ in range(4)),
                case.a["iceAreaCategory"], hs, hi,
                rng.uniform(0.0, 1e-9, (nC, NCAT, ns)),
                rng.uniform(0.0, 1e-6, (nC, NCAT)),
                rng.uniform(0.0, 1e-6, (nC, NCAT)),
                rng.uniform(0.0, 1e-7, (nC, NCAT)))
    assert_close(ttr.update_aerosol(*t, DT), jtr.update_aerosol(*j, DT),
                 "aerosol")


def test_snow(case):
    cj, _ = cfgs()
    rng = np.random.default_rng(22)
    shape = (case.tmesh.nCells, NCAT)
    hs = rng.uniform(0.0, 0.6, shape)
    hs[::6] = 0.0
    t_sfc = np.where(rng.uniform(size=shape) < 0.3, 0.0, -15.0)
    j, t = both(case.a["snowGrainRadius"], t_sfc, np.full(shape, -1.8), hs,
                rng.uniform(0.0, 1e-6, shape), rng.uniform(0.0, 15.0, shape),
                case.a["snowDensity"])
    assert_close(tsnow.snow_metamorphism(*t, DT),
                 jsnow.snow_metamorphism(*j, DT), "metamorphism")
    hi = rng.uniform(0.1, 2.0, shape)
    j, t = both(hi, 2.0 * hs)
    assert_close(tsnow.snow_ice_formation(*t, cj.rho_ice, cj.rho_snow,
                                          cj.rho_seawater),
                 jsnow.snow_ice_formation(*j, cj.rho_ice, cj.rho_snow,
                                          cj.rho_seawater), "snow ice")


def test_bgc(case):
    cj, _ = cfgs()
    rng = np.random.default_rng(23)
    shape = (case.tmesh.nCells, NCAT)
    h = rng.uniform(0.0, 2.0, shape)
    h[::8] = 0.0
    hb = case.a["brineHeight"].copy()
    hb[::5] = 0.0                              # fresh ice
    j, t = both(hb, h, rng.uniform(0.0, 0.3, shape))
    assert_close(tbgc.brine_height_update(*t, cj.rho_ice, cj.rho_snow,
                                          cj.rho_seawater, DT),
                 jbgc.brine_height_update(*j, cj.rho_ice, cj.rho_snow,
                                          cj.rho_seawater, DT), "brine")
    j, t = both(case.a["algaeIce"], case.a["nitrateIce"],
                case.a["silicateIce"], h, rng.uniform(0.0, 30.0, shape),
                np.full(shape, -1.8))
    (jg, jm), (tg, tm) = both(rng.uniform(0.0, 1e-7, shape),
                              rng.uniform(0.0, 1e-7, shape))
    assert_close(tbgc.algae_step(*t, 5.0, 10.0, tg, tm, DT),
                 jbgc.algae_step(*j, 5.0, 10.0, jg, jm, DT), "algae")
    n = 30
    j, t = both(rng.uniform(0.0, 2.0, (n, 3)), rng.uniform(0.0, 10.0, n),
                rng.uniform(0.0, 2.0, n), rng.uniform(0.0, 20.0, n),
                rng.uniform(0.0, 1.0, n), rng.uniform(0.0, 60.0, n),
                rng.uniform(-3.0, 0.5, n))
    assert_close(tbgc.algal_dyn(*t, DT), jbgc.algal_dyn(*j, DT), "algal_dyn")


def test_orbital():
    (jlat, jlon), (tlat, tlon) = both(np.linspace(-1.4, 1.4, 100),
                                      np.linspace(-3.0, 3.0, 100))
    (jy,), (ty,) = both(np.linspace(1.0, 365.0, 100))
    assert_close(torb.solar_declination(ty), jorb.solar_declination(jy),
                 "declination")
    assert_close(torb.compute_coszen(tlat, tlon, 172.0, 43200.0, 600.0),
                 jorb.compute_coszen(jlat, jlon, 172.0, 43200.0, 600.0),
                 "coszen")
    (jsw0,), (tsw0,) = both(np.full(100, 200.0))
    assert_close(torb.diurnal_shortwave(tsw0, tlat, tlon, 80.0, 3600.0),
                 jorb.diurnal_shortwave(jsw0, jlat, jlon, 80.0, 3600.0),
                 "diurnal")


# ---------------------------------------------------------------------------
# the column driver
# ---------------------------------------------------------------------------

PACKAGES = {
    "lvl_mushy_age": dict(config_pond_scheme="lvl", config_use_ice_age=True,
                          config_use_zsalinity=True,
                          config_thermo_type="mushy"),
    "cesm_zsal_brine": dict(config_pond_scheme="cesm",
                            config_use_zsalinity=True,
                            config_use_brine=True),
    "topo_algae_snow": dict(config_pond_scheme="topo",
                            config_use_algae=True,
                            config_use_snow_metamorphism=True),
}


@pytest.mark.parametrize("name", list(PACKAGES))
def test_tracer_packages_step(case, name):
    cj, ct = cfgs(**PACKAGES[name])
    thermo_j = jcol.thermodynamics_multilayer(cj, case.jstate, case.jforcing,
                                              DT)
    thermo_t = convert.seaice_state_from_arrays(flatten(thermo_j))
    assert_close(tcol._tracer_packages_step(ct, thermo_t, case.tforcing,
                                            case.tstate, DT),
                 jcol._tracer_packages_step(cj, thermo_j, case.jforcing,
                                            case.jstate, DT), name)


@pytest.mark.parametrize("name", ["e3sm", "every_package", "default"])
def test_column_physics_step(case, name):
    kw = {"e3sm": E3SM, "default": {},
          "every_package": dict(config_itd_remap_type="linear",
                                config_pond_scheme="lvl",
                                config_use_ice_age=True,
                                config_use_brine=True,
                                config_use_algae=True,
                                config_use_snow_metamorphism=True)}[name]
    cj, ct = cfgs(**kw)
    js, ts = (case.jstate, case.tstate) if name != "default" else states(
        case, iceEnthalpy=None, snowEnthalpy=None)
    assert_close(tcol.column_physics_step(ct, ts, case.tforcing, DT),
                 jcol.column_physics_step(cj, js, case.jforcing, DT), name)


def test_column_package_state_of_the_reference_suite():
    """column_physics_step with every package on, on the reference suite's
    own state (tests/test_seaice_column_pkgs.py:241-296)."""
    kw = dict(config_itd_remap_type="linear", config_pond_scheme="lvl",
              config_use_ice_age=True, config_use_brine=True,
              config_use_algae=True, config_use_snow_metamorphism=True)
    cj, ct = cfgs(**kw)
    nC = 4
    rng = np.random.default_rng(0)
    a = rng.uniform(0.0, 0.18, (nC, NCAT))
    h = np.array([0.3, 1.0, 2.0, 3.0, 5.0])[None, :] * np.ones((nC, 1))
    full = lambda v: np.full((nC, NCAT), v)    # noqa: E731
    st = jstate.SeaiceState(**{k: jnp.asarray(v) for k, v in dict(
        iceAreaCategory=a, iceVolumeCategory=a * h,
        snowVolumeCategory=0.1 * a, surfaceTemperature=full(-5.0),
        uVelocity=np.zeros(1), vVelocity=np.zeros(1),
        stress11=np.zeros(nC), stress22=np.zeros(nC), stress12=np.zeros(nC),
        pondArea=full(0.1), pondDepth=full(0.08), pondLid=full(0.0),
        levelIceArea=full(0.9), levelIceVolume=full(0.9),
        iceAge=full(1.0e5), brineHeight=full(0.5), algaeIce=full(0.1),
        nitrateIce=full(5.0), silicateIce=full(10.0),
        snowGrainRadius=full(200.0e-6), snowDensity=full(330.0)).items()})
    frc = jstate.SeaiceForcing(**{k: jnp.asarray(v) for k, v in dict(
        uAirVelocity=np.full(nC, 8.0), vAirVelocity=np.zeros(nC),
        airTemperature=np.full(nC, -10.0), shortwaveDown=np.full(nC, 50.0),
        longwaveDown=np.full(nC, 250.0), uOceanVelocity=np.zeros(nC),
        vOceanVelocity=np.zeros(nC), seaSurfaceTemperature=np.full(nC, -1.8),
        oceanHeatFlux=np.full(nC, 2.0), sshGradientU=np.zeros(1),
        sshGradientV=np.zeros(1), rainfallRate=np.full(nC, 1.0e-5),
        snowfallRate=np.full(nC, 1.0e-8)).items()})
    got = tcol.column_physics_step(ct, convert.seaice_state_from_arrays(
        flatten(st)), convert.seaice_forcing_from_arrays(flatten(frc)), DT)
    assert_close(got, jcol.column_physics_step(cj, st, frc, DT), "pkgs")


def test_timestep_and_volume(case):
    cj, ct = cfgs(config_elastic_subcycle_number=3, **E3SM)
    got, gd = tcore.seaice_timestep(case.tgrid, ct, case.tstate,
                                    case.tforcing, DT)
    ref, rd = jcore.seaice_timestep(case.jgrid, cj, case.jstate,
                                    case.jforcing, DT)
    assert_close(got, ref, "timestep")
    assert_close(tcore.total_ice_volume(case.tgrid, got),
                 jcore.total_ice_volume(case.jgrid, ref), "volume")
