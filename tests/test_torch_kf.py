"""The port's Kain-Fritsch convection (kfeta.py, convection.py) against the
JAX package, in float64 on the CPU.

Inputs are made with numpy from seeds and handed to both packages: the
deep unstable column and the stable column of
tests/test_atm_physics_suite.py:165-209, 24 columns of each, each column's
temperature and moisture perturbed from a seed. The deep column has 40
levels and a 25-km top: the scheme rejects clouds that would leave the
lid (ref module_cu_kfeta.F:658); the stable one's profile is carried to
the same 40 levels, so that one compile of the reference serves both.
kf_eta's defaults (w0avg 0.1, no wind, dx 25 km) are given to the
reference's kf_convection_full explicitly, and random resolved w, winds
and per-cell dx to kf_convection on the same columns.
tests/test_torch_kf_slice.py holds physics_step with PhysicsConfig() and
the coupled loop.

Bound: 1e-11 x max|ref| per output; integer and boolean outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere.physics import convection as jconv
from mpas_tpu.cores.atmosphere.physics import kfeta as jkf
from mpas_tpu_torch.constants import cp
from mpas_tpu_torch.cores.atmosphere.physics import convection as tconv
from mpas_tpu_torch.cores.atmosphere.physics import kfeta as tkf

torch.set_num_threads(1)

REL_FN = 1e-11
NC = 24
DT = 300.0
KF_OUT = ("th", "qv", "qc_detr", "qi_detr", "raincv_m", "cape", "timec",
          "ainc", "ishall", "peff", "ltop", "klcl")


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(x)


def assert_close(got, ref, names=None, rel=REL_FN):
    """Floating outputs to rel x max|ref|, integer and boolean ones
    exactly."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        r = np.asarray(r)
        name = names[i] if names else i
        assert g.shape == r.shape, name
        if not np.issubdtype(r.dtype, np.floating):
            assert np.array_equal(g, r), name
            continue
        scale = max(float(np.abs(r).max()), 1e-300)
        assert np.abs(g - r).max() <= rel * scale, name


def both(jfn, tfn, args, **static):
    """(port result, reference result) of the same numpy args; the JAX
    function is jitted with `static` closed over."""
    ref = jax.jit(lambda *a: jfn(*a, **static))(*[J(a) for a in args])
    got = tfn(*[T(a) for a in args], **static)
    return got, ref


# ---------------------------------------------------------------------------
# columns
# ---------------------------------------------------------------------------

def _columns(z, t, qv0, scale_height, rng):
    """(nc, nz) column inputs from one profile t(z), the surface moisture
    qv0 decaying over scale_height; each column's temperature shifted by
    up to +-0.3 K and its moisture scaled by 0.97-1.03 from rng."""
    nz = z.size
    zc = np.broadcast_to(z, (NC, nz))
    t = t[None, :] + rng.uniform(-0.3, 0.3, (NC, 1))
    p = 1.013e5 * np.exp(-zc / 7600.0)
    exner = (p / 1.0e5) ** (287.0 / cp)
    return dict(z=np.array(zc), dz=np.broadcast_to(np.gradient(z),
                                                   (NC, nz)).copy(),
                t=t, p=p, exner=exner, th=t / exner, rho=p / (287.0 * t),
                qv=qv0 * rng.uniform(0.97, 1.03, (NC, 1))
                * np.exp(-zc / scale_height))


def deep_unstable_columns(rng):
    """The deep unstable column: a 40-level, 25-km sounding with a dry
    adiabat below 800 m, 6.2 K/km above it and an isothermal-to-warming
    stratosphere above 16 km, 17 g/kg at the ground."""
    zc = np.linspace(100.0, 25000.0, 40)
    zm = 800.0
    t = np.where(zc < zm, 301.5 - 9.8e-3 * zc,
                 np.where(zc < 16000.0,
                          301.5 - 9.8e-3 * zm - 6.2e-3 * (zc - zm),
                          301.5 - 9.8e-3 * zm - 6.2e-3 * (16000.0 - zm)
                          + 2.0e-3 * (zc - 16000.0)))
    return _columns(zc, t, 0.017, 2500.0, rng)


def stable_columns(rng):
    """The stable column: 4 K/km from 288 K, 4 g/kg, on the deep column's
    40 levels."""
    zc = np.linspace(100.0, 25000.0, 40)
    return _columns(zc, 288.0 - 0.004 * zc, 0.004, 2500.0, rng)


COLUMNS = {"deep": deep_unstable_columns, "stable": stable_columns}
KF_ARGS = ("th", "qv", "p", "rho", "z", "dz", "exner")
KF_INPUTS = ("w0avg", "u", "v", "dx")


@pytest.fixture(scope="module")
def columns():
    """The deep columns, then the stable ones, (2 NC, 40)."""
    rng = np.random.default_rng(41)
    parts = [COLUMNS[k](rng) for k in ("deep", "stable")]
    return {k: np.concatenate([c[k] for c in parts]) for k in parts[0]}


@pytest.fixture(scope="module")
def jax_kf(columns):
    """The reference's kf_convection_full on the columns, jitted once;
    a function of (w0avg, u, v, dx)."""
    jit = jax.jit(lambda *a: jconv.kf_convection_full(
        *a[:7], DT, w0avg=a[7], u=a[8], v=a[9], dx=a[10]))
    return lambda *x: jit(*[J(columns[k]) for k in KF_ARGS],
                          *[J(v) for v in x])


@pytest.fixture(scope="module")
def kf_runs(columns, jax_kf):
    """{kind: (its columns, port's kf_eta, reference's)}: kf_eta with its
    default inputs, given to the reference explicitly."""
    shape = columns["z"].shape
    ref = jax_kf(np.full(shape, 0.1), np.zeros(shape), np.zeros(shape),
                 np.full(shape[0], 25.0e3))
    got = tkf.kf_eta(*[T(columns[k]) for k in KF_ARGS], DT)
    half = {"deep": slice(0, NC), "stable": slice(NC, 2 * NC)}
    return {kind: ({k: v[s] for k, v in columns.items()},
                   {k: v[s] for k, v in got.items()},
                   {k: np.asarray(v)[s] for k, v in ref.items()})
            for kind, s in half.items()}


@pytest.mark.parametrize("kind", sorted(COLUMNS))
def test_kf_eta(kf_runs, kind):
    _, got, ref = kf_runs[kind]
    assert sorted(got) == sorted(ref) == sorted(KF_OUT)
    assert_close([got[k] for k in KF_OUT], [ref[k] for k in KF_OUT], KF_OUT)
    if kind == "deep":
        # it fires in every column, in both packages
        for out in (got, ref):
            assert (np.asarray(out["ainc"]) > 0.0).all()
            assert (np.asarray(out["raincv_m"]) > 0.0).all()
    else:
        assert (got["raincv_m"].numpy() == 0.0).all()
        assert (got["ainc"].numpy() == 0.0).all()


def test_kf_eta_dries_and_heats_the_deep_column(kf_runs):
    """The reference test's budget on the port's output: the column's
    vapour falls, and the moist static energy change balances the latent
    heat of what fell and was detrained to within 25%."""
    c, got, _ = kf_runs["deep"]
    rho, dz, exner = c["rho"], c["dz"], c["exner"]
    th1, qv1 = got["th"].numpy(), got["qv"].numpy()
    assert ((qv1 * rho * dz).sum(1) < (c["qv"] * rho * dz).sum(1)).all()
    dh = ((th1 - c["th"]) * exner * cp * rho * dz).sum(1)
    dq = ((qv1 - c["qv"] + got["qc_detr"].numpy() + got["qi_detr"].numpy())
          * rho * dz).sum(1)
    resid = np.abs(dh + 2.5e6 * dq) / np.maximum(np.abs(dh), 1.0)
    assert (resid < 0.25).all(), resid.max()


@pytest.mark.parametrize("name", ["wetbulb", "tpmix", "prof5", "dtfrz"])
def test_kfeta_parcel_functions(name):
    """The saturation-point Newton inversion (stacked in the port), the
    saturation adjustment, the buoyancy-sorting integrals and the freezing
    adjustment on random parcels."""
    rng = np.random.default_rng(42)
    n = 500
    p = rng.uniform(1.0e4, 1.05e5, n)
    t = rng.uniform(200.0, 310.0, n)
    q = rng.uniform(0.0, 0.02, n)
    thes = np.asarray(jkf._thes_sat(J(t), J(p))) + rng.uniform(-5, 5, n)
    if name == "wetbulb":
        got, ref = both(jkf.wetbulb, tkf.wetbulb, [p, thes])
        assert_close(got, ref, ["t", "qs"])
        guess = t + rng.uniform(-20.0, 20.0, n)
        got, ref = both(jkf.wetbulb, tkf.wetbulb, [p, thes, guess])
        assert_close(got, ref, ["t", "qs"])
    elif name == "tpmix":
        ql = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0, 3e-3, n), 0)
        qi = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0, 3e-3, n), 0)
        got, ref = both(jkf.tpmix, tkf.tpmix, [p, thes, q, ql, qi, t])
        assert_close(got, ref, ["t", "qu", "qliq", "qice", "qnewlq"])
    elif name == "prof5":
        got, ref = both(jkf.prof5, tkf.prof5,
                        [rng.uniform(1e-3, 1.0 - 1e-3, n)])
        assert_close(got, ref, ["ee", "ud"])
    else:
        got, ref = both(jkf.dtfrz, tkf.dtfrz,
                        [t, p, q, rng.uniform(0.0, 2e-3, n)])
        assert_close(got, ref, ["tu", "qu", "thteu"])


def test_kf_convection(columns, jax_kf):
    """The manager's entry with random resolved w, cell winds and per-cell
    dx on the same columns."""
    rng = np.random.default_rng(43)
    shape = columns["z"].shape
    x = [rng.uniform(-0.5, 2.0, shape),
         5.0 + 3.0 * rng.standard_normal(shape),
         2.0 * rng.standard_normal(shape),
         rng.uniform(2000.0, 30000.0, shape[0])]
    full = jax_kf(*x)
    ref = [full[k] for k in ("th", "qv", "raincv_m", "cape")]
    got = tconv.kf_convection(*[T(columns[k]) for k in KF_ARGS], DT,
                              **{k: T(v) for k, v in zip(KF_INPUTS, x)})
    assert_close(got, ref, ["th", "qv", "rain", "cape"])
    rain = got[2].numpy()
    assert (rain[:NC] > 0.0).sum() >= NC // 2 and (rain[NC:] == 0.0).all()


def test_kf_eta_defaults_are_its_explicit_inputs(columns):
    """w0avg, u, v left out are 0.1 m/s, calm and dx 25 km."""
    args = [T(columns[k]) for k in KF_ARGS]
    z = args[4]
    got = tkf.kf_eta(*args, DT)
    explicit = tkf.kf_eta(*args, DT, w0avg=torch.full_like(z, 0.1),
                          u=torch.zeros_like(z), v=torch.zeros_like(z),
                          dx=torch.full_like(z[:, 0], 25.0e3))
    for k in KF_OUT:
        assert torch.equal(got[k], explicit[k]), k
