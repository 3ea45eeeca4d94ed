"""Each ported dycore function against its JAX twin on identical inputs.

The reference's JW case-2 setup (642 cells, 10 levels, float64) is carried
into the port through convert.py; seeded perturbations make the step saves
and vertical motion non-trivial. The JAX functions run eagerly on the CPU;
each output is held to 1e-11 x max|ref| (float64 with sums taken in
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import nhyd as jnhyd
from mpas_tpu.cores.atmosphere import time_integration as jti
from mpas_tpu.cores.atmosphere import transport as jtransport
from mpas_tpu.cores.atmosphere.config import AtmConfig
from mpas_tpu.cores.atmosphere.init_jw import init_jw
from mpas_tpu_torch import convert
from mpas_tpu_torch.cores.atmosphere import nhyd as tnhyd
from mpas_tpu_torch.cores.atmosphere import time_integration as tti
from mpas_tpu_torch.cores.atmosphere import transport as ttransport
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig as TAtmConfig

torch.set_num_threads(1)

REL = 1e-11
REL_STEPS = 1e-9
CFG = dict(config_nvertlevels=10, config_len_disp=960000.0,
           config_dt=1200.0)
DT = 1200.0
DTS = 200.0


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


def assert_close(got, ref, names=None, rel=REL):
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        name = names[i] if names else i
        assert g.shape == r.shape, name
        scale = max(float(np.abs(r).max()), 1e-300)
        assert np.abs(g - r).max() <= rel * scale, name


class Case:
    """Identical float64 inputs for both packages (numpy in `a`)."""

    def __init__(self, mesh):
        self.jcfg = AtmConfig(**CFG)
        self.tcfg = TAtmConfig(**CFG)
        jgrid, jstate, jdiag = init_jw(mesh, self.jcfg, case=2)
        self.jgrid = jax.tree.map(jnp.asarray, jgrid)
        self.tgrid = convert.grid_from_arrays(flatten(jgrid))
        rng = np.random.default_rng(0)
        s, d = flatten(jstate), flatten(jdiag)
        nz = self.tgrid.vert.nz
        w = s["w"] + 1e-3 * rng.standard_normal(s["w"].shape)
        w[:, 0] = w[:, nz] = 0.0
        self.a = dict(
            u=s["u"], w=w, theta_m=s["theta_m"], rho_zz=s["rho_zz"],
            ru=d["ru"], rw=d["rw"], rho_p=d["rho_p"], rtheta_p=d["rtheta_p"],
            exner=d["exner"], pressure_p=d["pressure_p"],
            ru_save=d["ru"] * (1.0 + 1e-3 * rng.standard_normal(
                d["ru"].shape)),
            rw_save=d["rw"] + 1e-4 * rng.standard_normal(d["rw"].shape),
            theta_save=s["theta_m"] + 0.1 * rng.standard_normal(
                s["theta_m"].shape))

    def j(self, k):
        return J(self.a[k])

    def t(self, k):
        return T(self.a[k])


@pytest.fixture(scope="module")
def case(sphere_mesh_small):
    return Case(sphere_mesh_small)


def _diag_pair(case):
    jsd = jnhyd.solve_diagnostics(case.jgrid, case.jcfg, case.j("u"),
                                  case.j("rho_zz"), DT)
    tsd = tnhyd.AtmSolveDiag(*[T(x) for x in jsd])
    return jsd, tsd


def test_solve_diagnostics(case):
    ref = jnhyd.solve_diagnostics(case.jgrid, case.jcfg, case.j("u"),
                                  case.j("rho_zz"), DT)
    got = tnhyd.solve_diagnostics(case.tgrid, case.tcfg, case.t("u"),
                                  case.t("rho_zz"), DT)
    assert_close(got, ref, ref._fields)


def test_reconstruct_cell_winds(case):
    assert_close(tnhyd.reconstruct_cell_winds(case.tgrid, case.t("u")),
                 jnhyd.reconstruct_cell_winds(case.jgrid, case.j("u")))


@pytest.mark.parametrize("rk", [1, 2])
def test_compute_dyn_tend(case, rk):
    jsd, tsd = _diag_pair(case)
    jur, jvr = jnhyd.reconstruct_cell_winds(case.jgrid, case.j("u"))

    def run(pkg, rk, euler):
        mod, grid, cfg, x, sd = (
            (jnhyd, case.jgrid, case.jcfg, case.j, jsd) if pkg == "jax"
            else (tnhyd, case.tgrid, case.tcfg, case.t, tsd))
        conv = J if pkg == "jax" else T
        return mod.compute_dyn_tend(
            grid, cfg, rk, DT, x("u"), x("w"), x("theta_m"), x("rho_zz"), sd,
            x("ru"), x("rw"), x("ru_save"), x("rw_save"), x("theta_save"),
            x("rho_p"), x("pressure_p"), conv(jur), conv(jvr), euler)

    jeuler = None if rk == 1 else run("jax", 1, None)[5]
    teuler = None if rk == 1 else tnhyd.EulerTends(*[T(e) for e in jeuler])
    ref = run("jax", rk, jeuler)
    got = run("torch", rk, teuler)
    assert_close(got[:5], ref[:5],
                 ["tend_u", "tend_rho", "tend_theta", "tend_w", "h_div"])
    assert_close(got[5], ref[5], ref[5]._fields)


# The dissipation options off by default: the vertical eddy viscosities
# of u, w and theta, Rayleigh damping of u over the top levels, and the
# fixed horizontal viscosities of 2d_fixed (del2 and del4).
OPTIONS = {
    "v_mom_eddy_visc2": dict(config_v_mom_eddy_visc2=500.0),
    "v_theta_eddy_visc2": dict(config_v_theta_eddy_visc2=500.0),
    "rayleigh_damp_u": dict(config_rayleigh_damp_u=True,
                            config_rayleigh_damp_u_timescale_days=0.05),
    "2d_fixed": dict(config_horiz_mixing="2d_fixed",
                     config_h_mom_eddy_visc2=2.0e5,
                     config_h_theta_eddy_visc2=1.0e5,
                     config_h_mom_eddy_visc4=1.0e15,
                     config_h_theta_eddy_visc4=5.0e14),
}
ALL_OPTIONS = {k: v for o in OPTIONS.values() for k, v in o.items()}


@pytest.mark.parametrize("rk", [1, 2])
@pytest.mark.parametrize("option", [*OPTIONS, "all"])
def test_compute_dyn_tend_options(case, option, rk):
    """Each option alone and all together, at the first RK stage (where
    the mixing is computed) and the second (which reuses it; Rayleigh
    damping applies at every stage)."""
    kw = dict(CFG, **(ALL_OPTIONS if option == "all" else OPTIONS[option]))
    jcfg, tcfg = AtmConfig(**kw), TAtmConfig(**kw)
    jsd, tsd = _diag_pair(case)
    jur, jvr = jnhyd.reconstruct_cell_winds(case.jgrid, case.j("u"))

    def run(pkg, rk, euler):
        mod, grid, cfg, x, sd, conv = (
            (jnhyd, case.jgrid, jcfg, case.j, jsd, J) if pkg == "jax"
            else (tnhyd, case.tgrid, tcfg, case.t, tsd, T))
        return mod.compute_dyn_tend(
            grid, cfg, rk, DT, x("u"), x("w"), x("theta_m"), x("rho_zz"), sd,
            x("ru"), x("rw"), x("ru_save"), x("rw_save"), x("theta_save"),
            x("rho_p"), x("pressure_p"), conv(jur), conv(jvr), euler)

    jeuler = None if rk == 1 else run("jax", 1, None)[5]
    teuler = None if rk == 1 else tnhyd.EulerTends(*[T(e) for e in jeuler])
    ref = run("jax", rk, jeuler)
    got = run("torch", rk, teuler)
    base = jnhyd.compute_dyn_tend(
        case.jgrid, case.jcfg, rk, DT, *[case.j(k) for k in (
            "u", "w", "theta_m", "rho_zz")], jsd,
        *[case.j(k) for k in ("ru", "rw", "ru_save", "rw_save", "theta_save",
                              "rho_p", "pressure_p")], jur, jvr, jeuler)
    # the option changes the tendencies it acts on; at the second stage,
    # given the first stage's mixing, only Rayleigh damping acts
    moved = {"v_mom_eddy_visc2": (0, 3), "v_theta_eddy_visc2": (2,),
             "rayleigh_damp_u": (0,), "2d_fixed": (0, 2, 3),
             "all": (0, 2, 3)}[option]
    if rk > 1:
        moved = (0,) if option in ("rayleigh_damp_u", "all") else ()
    for i in range(4):
        same = np.array_equal(np.asarray(ref[i]), np.asarray(base[i]))
        assert same == (i not in moved), i
    assert_close(got[:5], ref[:5],
                 ["tend_u", "tend_rho", "tend_theta", "tend_w", "h_div"])
    assert_close(got[5], ref[5], ref[5]._fields)


N_STEPS = 3
STEP_FIELDS = ["u", "w", "theta_m", "rho_zz", "scalars"]


@pytest.fixture(scope="module")
def option_steps(sphere_mesh_small):
    """3 srk3 steps of the JW wave with every option on, both packages."""
    kw = dict(CFG, **ALL_OPTIONS)
    jcfg = AtmConfig(**kw)
    jgrid, jstate, jdiag = init_jw(sphere_mesh_small, jcfg, case=2)
    gj = jax.tree.map(jnp.asarray, jgrid)
    carry0 = jti.init_carry(gj, jcfg, jax.tree.map(jnp.asarray, jstate),
                            jax.tree.map(jnp.asarray, jdiag), DT)
    ref = flatten(jti.run_steps(gj, jcfg, carry0, DT, N_STEPS))
    grid = convert.grid_from_arrays(flatten(jgrid))
    carry = convert.carry_from_arrays(flatten(carry0))
    tcfg = TAtmConfig(**kw)
    for _ in range(N_STEPS):
        carry = tti.srk3_step(grid, tcfg, carry, DT)
    return carry, ref


@pytest.mark.parametrize("field", STEP_FIELDS)
def test_srk3_steps_with_options(option_steps, field):
    carry, ref = option_steps
    assert_close([getattr(carry.state, field)], [ref["state"][field]],
                 [field], rel=REL_STEPS)


def test_vert_imp_coefs(case):
    ref = jnhyd.vert_imp_coefs(case.jgrid, case.jcfg, DTS, case.j("theta_m"),
                               case.j("exner"), case.j("rtheta_p"))
    got = tnhyd.vert_imp_coefs(case.tgrid, case.tcfg, DTS, case.t("theta_m"),
                               case.t("exner"), case.t("rtheta_p"))
    assert_close(got, ref, ref._fields)


def test_set_smlstep_pert_variables(case):
    rng = np.random.default_rng(3)
    tu = rng.standard_normal(case.a["u"].shape)
    tw = rng.standard_normal(case.a["w"].shape)
    assert_close([tnhyd.set_smlstep_pert_variables(case.tgrid, T(tu),
                                                   T(tw))],
                 [jnhyd.set_smlstep_pert_variables(case.jgrid, J(tu),
                                                   J(tw))])


def _acoustic_inputs(case):
    """Tendencies and coefficients (from the reference) for the acoustic
    chain, as numpy."""
    jsd, _ = _diag_pair(case)
    jur, jvr = jnhyd.reconstruct_cell_winds(case.jgrid, case.j("u"))
    x = case.j
    tend_u, tend_rho, tend_theta, tend_w, _, _ = jnhyd.compute_dyn_tend(
        case.jgrid, case.jcfg, 1, DT, x("u"), x("w"), x("theta_m"),
        x("rho_zz"), jsd, x("ru"), x("rw"), x("ru_save"), x("rw_save"),
        x("theta_save"), x("rho_p"), x("pressure_p"), jur, jvr, None)
    tend_rw = jnhyd.set_smlstep_pert_variables(case.jgrid, tend_u, tend_w)
    coefs = jnhyd.vert_imp_coefs(case.jgrid, case.jcfg, DTS, x("theta_m"),
                                 x("exner"), x("rtheta_p"))
    return ([np.asarray(t) for t in (tend_u, tend_rho, tend_theta,
                                     tend_rw)],
            [np.asarray(c) for c in coefs])


@pytest.fixture(scope="module")
def acoustic_inputs(case):
    return _acoustic_inputs(case)


def _zero_av(mod, case, conv):
    a = case.a
    z = {k: conv(np.zeros_like(a[s])) for k, s in
         (("e", "u"), ("c", "rho_zz"), ("i", "w"))}
    return mod.AcousticVars(ru_p=z["e"], rho_pp=z["c"], rtheta_pp=z["c"],
                            rtheta_pp_old=z["c"], rw_p=z["i"], ruAvg=z["e"],
                            wwAvg=z["i"])


@pytest.mark.parametrize("damp", [False, True])
def test_acoustic_step_two_chained(case, acoustic_inputs, damp):
    tends, coefs = acoustic_inputs

    def run(pkg):
        mod, grid, cfg, x, conv = (
            (jnhyd, case.jgrid, case.jcfg, case.j, J) if pkg == "jax"
            else (tnhyd, case.tgrid, case.tcfg, case.t, T))
        cf = mod.VertImpCoefs(*[conv(c) for c in coefs])
        tu, trho, tth, trw = [conv(t) for t in tends]
        av = _zero_av(mod, case, conv)
        hoist = mod.acoustic_hoist(grid, x("theta_save"), x("exner"))
        for _ in range(2):
            av = mod.acoustic_step(
                grid, cfg, cf, av, DTS, x("theta_save"), x("exner"),
                x("w"), x("rho_zz"), x("rw"), x("rw_save"), x("ru"),
                x("ru_save"), tu, trho, tth, trw, hoist=hoist, damp=damp)
        return av

    ref = run("jax")
    assert_close(run("torch"), ref, ref._fields)


def test_divergence_damping_3d(case):
    rng = np.random.default_rng(4)
    fields = [rng.standard_normal(case.a[s].shape) for s in
              ("u", "rho_zz", "rho_zz", "rho_zz", "w", "u", "w")]

    def run(mod, grid, cfg, conv, theta):
        av = mod.AcousticVars(*[conv(f) for f in fields])
        return mod.divergence_damping_3d(grid, cfg, av, DTS, theta)

    ref = run(jnhyd, case.jgrid, case.jcfg, J, case.j("theta_m"))
    got = run(tnhyd, case.tgrid, case.tcfg, T, case.t("theta_m"))
    assert_close(got, ref, ref._fields)


@pytest.mark.parametrize("rk", [1, 3])
def test_recover_large_step_variables(case, rk):
    rng = np.random.default_rng(5)
    a = case.a
    av = [1e-3 * rng.standard_normal(a[s].shape) * np.abs(a[r]).mean()
          for s, r in (("u", "ru"), ("rho_zz", "rho_zz"),
                       ("rho_zz", "rtheta_p"), ("rho_zz", "rtheta_p"),
                       ("w", "rw"), ("u", "ru"), ("w", "rw"))]
    nz = case.tgrid.vert.nz
    av[4][:, 0] = av[4][:, nz] = 0.0

    def run(mod, grid, cfg, x, conv):
        return mod.recover_large_step_variables(
            grid, cfg, mod.AcousticVars(*[conv(v) for v in av]), rk,
            DTS, 2, x("rho_p"), x("rtheta_p"), x("ru_save"), x("rw_save"),
            x("theta_m"))

    ref = run(jnhyd, case.jgrid, case.jcfg, case.j, J)
    got = run(tnhyd, case.tgrid, case.tcfg, case.t, T)
    names = ["u", "w", "theta_m", "rho_zz", "ru", "rw", "rho_p",
             "rtheta_p", "exner", "pressure_p", "ruAvg", "wwAvg"]
    keep = [i for i, r in enumerate(ref) if r is not None]
    assert [g is None for g in got] == [r is None for r in ref]
    assert_close([got[i] for i in keep], [ref[i] for i in keep],
                 [names[i] for i in keep])


def _scalar_case(case):
    """A cone of tracer, mass fluxes from the reference's state."""
    g = case.jgrid
    lat = np.asarray(g.mesh.latCell)
    lon = np.asarray(g.mesh.lonCell)
    r = np.sqrt((lat - np.pi / 4) ** 2 + (lon - np.pi / 2) ** 2)
    q = np.where(r < 0.8, 1.0 - r / 0.8, 0.0)
    nz = case.tgrid.vert.nz
    sc = np.zeros((lat.size, nz, 2))
    sc[:, 2:8, 0] = q[:, None]
    sc[:, :, 1] = 0.5 * q[:, None]
    rng = np.random.default_rng(6)
    sc_new = sc + 1e-3 * rng.standard_normal(sc.shape)
    rho_new = case.a["rho_zz"] * (1.0 + 1e-4 * rng.standard_normal(
        case.a["rho_zz"].shape))
    return sc, sc_new, rho_new


@pytest.mark.parametrize("rk", [1, 2])
def test_advance_scalars(case, rk):
    sc, sc_new, rho_new = _scalar_case(case)
    args = (sc, sc_new, case.a["rho_zz"], rho_new, case.a["ru"],
            case.a["rw"])
    ref = jtransport.advance_scalars(case.jgrid, case.jcfg,
                                     *[J(x) for x in args], 400.0, rk, True)
    got = ttransport.advance_scalars(case.tgrid, case.tcfg,
                                     *[T(x) for x in args], 400.0, rk, True)
    assert_close([got], [ref])


def test_advance_scalars_mono(case):
    sc, sc_new, rho_new = _scalar_case(case)
    args = (sc, sc_new, case.a["rho_zz"], rho_new, case.a["ru"],
            case.a["rw"])
    ref = jtransport.advance_scalars_mono(case.jgrid, case.jcfg,
                                          *[J(x) for x in args], 1200.0,
                                          True)
    got = ttransport.advance_scalars_mono(case.tgrid, case.tcfg,
                                          *[T(x) for x in args], 1200.0,
                                          True)
    assert_close([got], [ref])
