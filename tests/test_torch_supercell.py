"""The port's moist supercell path against the JAX package (float64).

A 12x12 doubly periodic 2-km hex mesh with 16 levels, the supercell case
(init case 5) and Kessler microphysics. Inputs are made once with numpy
from seeds and handed to both packages. Bounds:
- init_supercell: 1e-13 relative (same algorithm and operation order; the
  bound of tests/test_torch_setup.py);
- each moist dycore function and the Kessler path: 1e-11 x max|ref|
  (float64 with sums taken in another order; tests/test_torch_nhyd.py);
- 6 srk3 steps against the reference's run_steps: 1e-9 x max|ref| per
  field, the per-function rounding grown over 6 steps;
- total water (vapour, cloud and rain in the air plus accumulated surface
  rain) and dry mass over those steps: 1e-10 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import nhyd as jnhyd
from mpas_tpu.cores.atmosphere import time_integration as jti
from mpas_tpu.cores.atmosphere.config import AtmConfig as JaxAtmConfig
from mpas_tpu.cores.atmosphere.init_supercell import \
    init_supercell as jax_init_supercell
from mpas_tpu.cores.atmosphere.physics import driver as jdriver
from mpas_tpu.cores.atmosphere.physics import kessler as jkessler
from mpas_tpu.mesh.planar import planar_hex_mesh as jax_planar_hex_mesh
from mpas_tpu_torch import convert
from mpas_tpu_torch.constants import rvord
from mpas_tpu_torch.cores.atmosphere import nhyd as tnhyd
from mpas_tpu_torch.cores.atmosphere import time_integration as tti
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
from mpas_tpu_torch.cores.atmosphere.moisture import masses, seeded_moisture
from mpas_tpu_torch.cores.atmosphere.physics import driver as tdriver
from mpas_tpu_torch.cores.atmosphere.physics import kessler as tkessler
from mpas_tpu_torch.mesh.planar import planar_hex_mesh

torch.set_num_threads(1)

CFG = dict(config_dt=12.0, config_nvertlevels=16, config_len_disp=2000.0,
           config_xnutr=0.0, config_microp_scheme="mp_kessler",
           config_monotonic=True)
DT = 12.0
DTS = 2.0
DT_MP = 200.0     # a long physics step: several sedimentation sub-steps
REL_INIT = 1e-13
REL_FN = 1e-11
REL_SLICE = 1e-9
REL_MASS = 1e-10
N_STEPS = 6


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


def assert_close(got, ref, names=None, rel=REL_FN):
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        name = names[i] if names else i
        assert g.shape == r.shape, name
        scale = max(float(np.abs(r).max()), 1e-300)
        assert np.abs(g - r).max() <= rel * scale, name


def assert_matches(port, ref, path=""):
    """Every field of the port container equals the reference's field."""
    for f in dataclasses.fields(port):
        v, r = getattr(port, f.name), ref[f.name]
        name = path + f.name
        if dataclasses.is_dataclass(v):
            assert_matches(v, r, name + ".")
        elif isinstance(v, torch.Tensor):
            a = v.numpy()
            assert a.shape == r.shape, name
            scale = max(float(np.abs(r).max()) if r.size else 0.0, 1e-300)
            assert np.abs(a - r).max(initial=0.0) <= REL_INIT * scale, name
        else:
            assert v == r, (name, v, r)


@pytest.fixture(scope="module")
def reference():
    cfg = JaxAtmConfig(**CFG)
    return cfg, jax_init_supercell(jax_planar_hex_mesh(12, 12, 2000.0), cfg,
                                   case=5)


@pytest.mark.parametrize("part", ["grid", "state", "diag"])
def test_init_supercell_matches_reference(reference, part):
    _, ref = reference
    port = init_supercell(planar_hex_mesh(12, 12, 2000.0), AtmConfig(**CFG),
                          case=5)
    i = ("grid", "state", "diag").index(part)
    assert_matches(port[i], flatten(ref[i]))


def test_init_supercell_refuses_the_sphere():
    from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
    with pytest.raises(ValueError):
        init_supercell(icosahedral_mesh(2, lloyd_iters=0), AtmConfig(**CFG))


class Case:
    """Identical float64 moist inputs for both packages (numpy in `a`)."""

    def __init__(self, reference):
        self.jcfg, (jgrid, jstate, jdiag) = reference
        self.tcfg = AtmConfig(**CFG)
        self.jgrid = jax.tree.map(jnp.asarray, jgrid)
        self.tgrid = convert.grid_from_arrays(flatten(jgrid))
        rng = np.random.default_rng(0)
        s, d = flatten(jstate), flatten(jdiag)
        nz = self.tgrid.vert.nz
        u = s["u"] + rng.standard_normal(s["u"].shape)
        w = 0.5 * rng.standard_normal(s["w"].shape)
        w[:, 0] = w[:, nz] = 0.0
        rw_save = d["rw"] + 0.1 * rng.standard_normal(d["rw"].shape)
        rw_save[:, 0] = rw_save[:, nz] = 0.0
        self.a = dict(
            u=u, w=w, theta_m=s["theta_m"], rho_zz=s["rho_zz"],
            ru=d["ru"], rw=d["rw"], rho_p=d["rho_p"], rtheta_p=d["rtheta_p"],
            exner=d["exner"], pressure_p=d["pressure_p"],
            ru_save=d["ru"] * (1.0 + 1e-3 * rng.standard_normal(
                d["ru"].shape)),
            rw_save=rw_save,
            theta_save=s["theta_m"] + 0.1 * rng.standard_normal(
                s["theta_m"].shape),
            scalars=seeded_moisture(jgrid.mesh, s["scalars"], 1).numpy(),
            rt_diab=1e-3 * rng.standard_normal(s["theta_m"].shape))
        qtot, cqw, cqu = jnhyd.compute_moist_coefficients(
            self.jgrid, J(self.a["scalars"]))
        self.a.update(qtot=np.asarray(qtot), cqw=np.asarray(cqw),
                      cqu=np.asarray(cqu))

    def j(self, k):
        return J(self.a[k])

    def t(self, k):
        return T(self.a[k])


@pytest.fixture(scope="module")
def case(reference):
    return Case(reference)


def _pkg(case, pkg):
    if pkg == "jax":
        return jnhyd, case.jgrid, case.jcfg, case.j, J
    return tnhyd, case.tgrid, case.tcfg, case.t, T


def test_compute_moist_coefficients(case):
    got = tnhyd.compute_moist_coefficients(case.tgrid, case.t("scalars"))
    assert_close(got, [case.a[k] for k in ("qtot", "cqw", "cqu")],
                 ["qtot", "cqw", "cqu"])
    # the seeded cloud and rain count
    assert bool((got[0] > case.t("scalars")[..., 0]).any())


@pytest.mark.parametrize("rk", [1, 2])
def test_compute_dyn_tend_moist(case, rk):
    jsd = jnhyd.solve_diagnostics(case.jgrid, case.jcfg, case.j("u"),
                                  case.j("rho_zz"), DT)
    jur, jvr = jnhyd.reconstruct_cell_winds(case.jgrid, case.j("u"))

    def run(pkg, rk, euler):
        mod, grid, cfg, x, conv = _pkg(case, pkg)
        sd = jsd if pkg == "jax" else tnhyd.AtmSolveDiag(*[T(v) for v in jsd])
        return mod.compute_dyn_tend(
            grid, cfg, rk, DT, x("u"), x("w"), x("theta_m"), x("rho_zz"), sd,
            x("ru"), x("rw"), x("ru_save"), x("rw_save"), x("theta_save"),
            x("rho_p"), x("pressure_p"), conv(jur), conv(jvr), euler,
            cqu=x("cqu"), cqw=x("cqw"), qtot=x("qtot"),
            rt_diabatic_tend=x("rt_diab"))

    jeuler = None if rk == 1 else run("jax", 1, None)[5]
    teuler = None if rk == 1 else tnhyd.EulerTends(*[T(e) for e in jeuler])
    ref = run("jax", rk, jeuler)
    got = run("torch", rk, teuler)
    assert_close(got[:5], ref[:5],
                 ["tend_u", "tend_rho", "tend_theta", "tend_w", "h_div"])
    assert_close(got[5], ref[5], ref[5]._fields)


def test_vert_imp_coefs_moist(case):
    def run(pkg):
        mod, grid, cfg, x, _ = _pkg(case, pkg)
        return mod.vert_imp_coefs(grid, cfg, DTS, x("theta_m"), x("exner"),
                                  x("rtheta_p"), qtot=x("qtot"),
                                  cqw=x("cqw"))

    ref = run("jax")
    assert_close(run("torch"), ref, ref._fields)


def test_acoustic_hoist_moist(case):
    def run(pkg):
        mod, grid, _, x, _ = _pkg(case, pkg)
        return mod.acoustic_hoist(grid, x("theta_save"), x("exner"),
                                  x("cqu"))

    ref = run("jax")
    assert_close(run("torch"), ref, ref._fields)


def test_acoustic_step_moist_two_chained(case):
    """cqu reaches the pressure gradient through the hoist that
    acoustic_step builds itself when none is given."""
    x = case.j
    jsd = jnhyd.solve_diagnostics(case.jgrid, case.jcfg, x("u"),
                                  x("rho_zz"), DT)
    jur, jvr = jnhyd.reconstruct_cell_winds(case.jgrid, x("u"))
    moist = dict(cqu=x("cqu"), cqw=x("cqw"), qtot=x("qtot"),
                 rt_diabatic_tend=x("rt_diab"))
    tend_u, tend_rho, tend_theta, tend_w, _, _ = jnhyd.compute_dyn_tend(
        case.jgrid, case.jcfg, 1, DT, x("u"), x("w"), x("theta_m"),
        x("rho_zz"), jsd, x("ru"), x("rw"), x("ru_save"), x("rw_save"),
        x("theta_save"), x("rho_p"), x("pressure_p"), jur, jvr, None,
        **moist)
    tend_rw = jnhyd.set_smlstep_pert_variables(case.jgrid, tend_u, tend_w)
    coefs = jnhyd.vert_imp_coefs(case.jgrid, case.jcfg, DTS, x("theta_m"),
                                 x("exner"), x("rtheta_p"), qtot=x("qtot"),
                                 cqw=x("cqw"))
    tends = [np.asarray(t) for t in (tend_u, tend_rho, tend_theta, tend_rw)]
    coefs = [np.asarray(c) for c in coefs]

    def run(pkg):
        mod, grid, cfg, x, conv = _pkg(case, pkg)
        cf = mod.VertImpCoefs(*[conv(c) for c in coefs])
        tu, trho, tth, trw = [conv(t) for t in tends]
        z = {k: conv(np.zeros_like(case.a[s])) for k, s in
             (("e", "u"), ("c", "rho_zz"), ("i", "w"))}
        av = mod.AcousticVars(ru_p=z["e"], rho_pp=z["c"], rtheta_pp=z["c"],
                              rtheta_pp_old=z["c"], rw_p=z["i"],
                              ruAvg=z["e"], wwAvg=z["i"])
        for _ in range(2):
            av = mod.acoustic_step(
                grid, cfg, cf, av, DTS, x("theta_save"), x("exner"), x("w"),
                x("rho_zz"), x("rw"), x("rw_save"), x("ru"), x("ru_save"),
                tu, trho, tth, trw, cqu=x("cqu"), damp=True)
        return av

    ref = run("jax")
    assert_close(run("torch"), ref, ref._fields)


@pytest.mark.parametrize("rk", [1, 3])
def test_recover_large_step_variables_moist(case, rk):
    rng = np.random.default_rng(5)
    a = case.a
    av = [1e-3 * rng.standard_normal(a[s].shape) * np.abs(a[r]).mean()
          for s, r in (("u", "ru"), ("rho_zz", "rho_zz"),
                       ("rho_zz", "rtheta_p"), ("rho_zz", "rtheta_p"),
                       ("w", "rw"), ("u", "ru"), ("w", "rw"))]
    nz = case.tgrid.vert.nz
    av[4][:, 0] = av[4][:, nz] = 0.0

    def run(pkg):
        mod, grid, cfg, x, conv = _pkg(case, pkg)
        return mod.recover_large_step_variables(
            grid, cfg, mod.AcousticVars(*[conv(v) for v in av]), rk, DT, 2,
            x("rho_p"), x("rtheta_p"), x("ru_save"), x("rw_save"),
            x("theta_m"), rt_diabatic_tend=x("rt_diab"))

    ref = run("jax")
    got = run("torch")
    names = ["u", "w", "theta_m", "rho_zz", "ru", "rw", "rho_p",
             "rtheta_p", "exner", "pressure_p", "ruAvg", "wwAvg"]
    keep = [i for i, r in enumerate(ref) if r is not None]
    assert [g is None for g in got] == [r is None for r in ref]
    assert_close([got[i] for i in keep], [ref[i] for i in keep],
                 [names[i] for i in keep])


# ---------------------------------------------------------------------------
# Kessler microphysics
# ---------------------------------------------------------------------------

def _qvs(theta, pii):
    """The scheme's saturation mixing ratio (kessler.py, :211-236)."""
    temp = pii * theta
    pressure = 1.0e5 * pii ** (1004.0 / 287.0)
    es = 1000.0 * 0.6112 * np.exp(17.67 * (temp - 273.15) / (temp - 29.65))
    return (287.0 / 461.6) * es / (pressure - es)


def _courant(qr, rho, dz, dt):
    """Per-column sedimentation Courant number of the first sub-step."""
    t = [torch.from_numpy(v) for v in (qr, rho)]
    vt = tkessler._terminal_velocity(t[0], t[1],
                                     torch.sqrt(t[1][:, :1] / t[1])).numpy()
    return (vt / dz).max(-1) * dt


@pytest.fixture(scope="module")
def column_inputs(case):
    """Kessler inputs from the supercell state with the seeded moisture:
    dry theta, qv/qc/qr, dry density, Exner and layer thickness."""
    a, g = case.a, case.tgrid
    sc = np.clip(a["scalars"], 0.0, None)
    qv, qc, qr = sc[..., 0], sc[..., 1], sc[..., 2]
    rho = g.zz.numpy() * a["rho_zz"]
    dz = np.diff(g.zgrid.numpy(), axis=1)
    theta = a["theta_m"] / (1.0 + rvord * qv)
    qvs = _qvs(theta, a["exner"])
    cr = _courant(qr, rho, dz, DT_MP)
    assert (qv > qvs).any() and (qv < qvs).any()
    assert (qc > jkessler.C2).any()
    assert (cr > jkessler.MAX_CR_SED).any() and (cr < jkessler.MAX_CR_SED).any()
    return dict(theta=theta, qv=qv, qc=qc, qr=qr, rho=rho, pii=a["exner"],
                dz=dz)


def test_sediment_rain(column_inputs):
    c = column_inputs
    # thin the layers of every third column: many sub-steps there
    dz = c["dz"].copy()
    dz[::3] *= 0.05
    tkessler.reset_stats()
    got = tkessler.sediment_rain(T(c["qr"]), T(c["rho"]), T(dz), DT_MP)
    ref = jkessler.sediment_rain(J(c["qr"]), J(c["rho"]), J(dz), DT_MP)
    assert_close(got, ref, ["qr", "rain"])
    assert tkessler.stats["sediment_calls"] == 1
    assert tkessler.stats["sediment_iterations"] > 1
    # column mass of rain plus fallout is conserved
    m0 = (c["qr"] * c["rho"] * dz).sum(1)
    m1 = (got[0].numpy() * c["rho"] * dz).sum(1) + got[1].numpy() * 1000.0
    assert np.abs(m1 - m0).max() <= 1e-13 * m0.max()


def test_kessler(column_inputs):
    c = column_inputs
    names = ["theta", "qv", "qc", "qr", "pii", "dz"]
    args = [c["theta"], c["qv"], c["qc"], c["qr"], c["rho"], c["pii"],
            c["dz"]]
    got = tkessler.kessler(*[T(x) for x in args], DT_MP)
    ref = jkessler.kessler(*[J(x) for x in args], DT_MP)
    assert_close(got, ref, names[:4] + ["rain"])


def test_microphysics_step(case):
    x = case.a
    keys = ("theta_m", "rho_zz", "scalars", "exner")
    got = tdriver.microphysics_step(case.tgrid, *[case.t(k) for k in keys],
                                    DT_MP)
    ref = jdriver.microphysics_step(case.jgrid, *[case.j(k) for k in keys],
                                    DT_MP)
    assert_close(got, ref, ["theta_m", "scalars", "rtheta_p", "exner",
                            "pressure_p", "rt_diabatic_tend", "rain"])
    # the inputs stay as they were: the driver builds new tensors
    assert np.array_equal(case.t("scalars").numpy(), x["scalars"])


# ---------------------------------------------------------------------------
# the slice end to end: 6 srk3 steps against the reference's run_steps
# ---------------------------------------------------------------------------

SLICE_FIELDS = ["u", "w", "theta_m", "rho_zz", "scalars", "rainnc",
                "rt_diabatic_tend"]


@pytest.fixture(scope="module")
def slice_runs(reference):
    jcfg, (jgrid, jstate, jdiag) = reference
    state = dataclasses.replace(
        jstate,
        scalars=seeded_moisture(jgrid.mesh, jstate.scalars, 7).numpy())
    gj = jax.tree.map(jnp.asarray, jgrid)
    carry0 = jti.init_carry(gj, jcfg, jax.tree.map(jnp.asarray, state),
                            jax.tree.map(jnp.asarray, jdiag), DT)
    ref = flatten(jti.run_steps(gj, jcfg, carry0, DT, N_STEPS))
    grid = convert.grid_from_arrays(flatten(jgrid))
    start = convert.carry_from_arrays(flatten(carry0))
    cfg = AtmConfig(**CFG)
    tkessler.reset_stats()
    carry = start
    for _ in range(N_STEPS):
        carry = tti.srk3_step(grid, cfg, carry, DT)
    return grid, start, carry, ref, dict(tkessler.stats)


@pytest.mark.parametrize("field", SLICE_FIELDS)
def test_slice_matches_reference(slice_runs, field):
    _, _, carry, ref, _ = slice_runs
    if field in ("rainnc", "rt_diabatic_tend"):
        got, want = getattr(carry, field), ref[field]
    else:
        got, want = getattr(carry.state, field), ref["state"][field]
    assert float(np.abs(want).max()) > 0.0
    assert_close([got], [want], [field], rel=REL_SLICE)


@pytest.mark.parametrize("which", ["dry_mass", "total_water"])
def test_slice_conserves_mass(slice_runs, which):
    grid, start, carry, _, stats = slice_runs
    i = ("dry_mass", "total_water").index(which)
    m0, m1 = masses(grid, start)[i], masses(grid, carry)[i]
    assert abs(m1 - m0) <= REL_MASS * m0
    assert float(carry.rainnc.max()) > 0.0         # rain reached the ground
    assert stats["sediment_calls"] == N_STEPS


def test_carry_round_trips_through_convert(slice_runs):
    _, start, _, _, _ = slice_runs
    back = convert.carry_from_arrays(convert.to_arrays(start))
    for f in dataclasses.fields(start):
        v = getattr(start, f.name)
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(back, f.name), v), f.name
    assert torch.equal(back.state.scalars, start.state.scalars)
    assert torch.equal(back.diag.wwAvg, start.diag.wwAvg)
