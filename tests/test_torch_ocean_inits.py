"""The ocean's init-mode configurations and the global-ocean
initialisation of the PyTorch port against the JAX package.

Each init runs in both packages on the same small mesh (the 192-cell
channel, the 192-cell doubly periodic plane, a box, the 642-cell sphere;
6-10 levels) and is held field by field: grid, mesh Coriolis, masks,
state, forcing and extras are host numpy in both, so bit for bit.
init_global_ocean runs on synthetic_woa_dataset() and on a dataset read
by load_dataset_netcdf from netCDF4 and classic files the test writes.
Every init, and init_global_ocean, then takes 2 steps of the integrator
its reference test uses through run_steps in both packages, held at 1e-9
x max|ref|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpas_tpu.cores.ocean import core as jcore
from mpas_tpu.cores.ocean import init_configs as jinit
from mpas_tpu.cores.ocean import init_global_ocean as jglobal
from mpas_tpu.mesh import planar as jplanar
from mpas_tpu.mesh import sphere as jsphere
from mpas_tpu_torch.cores.ocean import core as tcore
from mpas_tpu_torch.cores.ocean import init_configs as tinit
from mpas_tpu_torch.cores.ocean import init_global_ocean as tglobal
from mpas_tpu_torch.io.hdf5_write import write_hdf5
from mpas_tpu_torch.io.netcdf import write_netcdf
from mpas_tpu_torch.mesh import planar as tplanar
from mpas_tpu_torch.mesh import sphere as tsphere

torch.set_num_threads(1)

STEP_REL = 1e-9
NZ = 6

# (mesh builder, args) per mesh kind; the same call in both packages
MESHES = {"channel": ("channel_hex_mesh", (8, 26, 5000.0)),
          "plane": ("planar_hex_mesh", (12, 16, 10000.0)),
          "box": ("box_hex_mesh", (8, 24, 2000.0)),
          "sphere": ("icosahedral_mesh", (8,))}
INITS = {"overflow": "channel", "internal_waves": "channel",
         "lock_exchange": "channel", "sea_mount": "channel",
         "ziso": "channel", "isomip": "channel",
         "sub_ice_shelf_2d": "channel", "cvmix_wswsbf": "channel",
         "cosine_bell": "sphere", "soma": "sphere",
         "global_ocean_idealized": "sphere", "iso": "sphere",
         "isomip_plus": "box", "ecosys_column": "box",
         "periodic_planar": "plane"}
_MESH_CACHE = {}


def meshes(kind):
    """(reference mesh, port mesh) of one kind, built once per module."""
    if kind not in _MESH_CACHE:
        name, args = MESHES[kind]
        kw = {"lloyd_iters": 2} if kind == "sphere" else {}
        jmod, tmod = (jsphere, tsphere) if kind == "sphere" \
            else (jplanar, tplanar)
        _MESH_CACHE[kind] = (getattr(jmod, name)(*args, **kw),
                             getattr(tmod, name)(*args, **kw))
    return _MESH_CACHE[kind]


def leaves(obj, prefix=""):
    """{path: value} of nested dataclasses, dicts and tuples."""
    if dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    elif isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, tuple):
        items = ((str(i), v) for i, v in enumerate(obj))
    else:
        return {prefix: obj}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}"))
    return out


def assert_same(got, ref):
    """Every leaf of the port's result equal to the reference's: statics
    equal, arrays of the same shape and values."""
    g, r = leaves(got), leaves(ref)
    assert set(g) == set(r), set(g) ^ set(r)
    for k in r:
        if r[k] is None or isinstance(r[k], (bool, int, float, str)):
            assert g[k] == r[k], k
            continue
        a = g[k].numpy() if isinstance(g[k], torch.Tensor) \
            else np.asarray(g[k])
        b = np.asarray(r[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", sorted(INITS))
def test_init_bit_for_bit(name):
    jm, tm = meshes(INITS[name])
    assert_same(getattr(tinit, f"init_{name}")(tm, nz=NZ),
                getattr(jinit, f"init_{name}")(jm, nz=NZ))


def test_isomip_plus_cold_and_ssh_inverse():
    jm, tm = meshes("box")
    assert_same(tinit.init_isomip_plus(tm, nz=NZ, warm=False),
                jinit.init_isomip_plus(jm, nz=NZ, warm=False))
    tg, ts, tx = tinit.init_isomip_plus(tm, nz=NZ)
    jg, js, jx = jinit.init_isomip_plus(jm, nz=NZ)
    assert_same(tinit.ssh_and_land_ice_pressure_balance(
        tg, ts, land_ice_pressure=tx["landIcePressure"], variable="ssh"),
        jinit.ssh_and_land_ice_pressure_balance(
            jg, js, land_ice_pressure=jx["landIcePressure"],
            variable="ssh"))


def test_iso_without_features():
    jm, tm = meshes("sphere")
    off = dict(ridge=False, plateau=False, shelf=False, cont_slope=False,
               embayment=False, depression=False)
    assert_same(tinit.init_iso(tm, nz=NZ, **off),
                jinit.init_iso(jm, nz=NZ, **off))


def test_periodic_planar_strength():
    jm, tm = meshes("plane")
    assert_same(tinit.init_periodic_planar(tm, nz=4, velocity_strength=0.5,
                                           bottom_depth=200.0),
                jinit.init_periodic_planar(jm, nz=4, velocity_strength=0.5,
                                           bottom_depth=200.0))


def test_sphere_inits_refuse_a_plane():
    _, tm = meshes("channel")
    for fn in (tinit.init_cosine_bell, tinit.init_soma, tinit.init_iso,
               tinit.init_global_ocean_idealized):
        with pytest.raises(ValueError):
            fn(tm, nz=NZ)


# ---------------------------------------------------------------------------
# init_global_ocean
# ---------------------------------------------------------------------------

def test_synthetic_woa_dataset():
    assert_same(tglobal.synthetic_woa_dataset(nlat=18, nlon=36, ndep=12),
                jglobal.synthetic_woa_dataset(nlat=18, nlon=36, ndep=12))


def test_bilinear():
    ds = jglobal.synthetic_woa_dataset()
    rng = np.random.default_rng(5)
    lat = rng.uniform(-1.6, 1.6, 500)
    lon = rng.uniform(0.0, 2.0 * np.pi, 500)
    for key in ("topography", "temperature"):
        np.testing.assert_array_equal(
            tglobal._bilinear(ds["lat"], ds["lon"], ds[key], lat, lon),
            jglobal._bilinear(ds["lat"], ds["lon"], ds[key], lat, lon))


@pytest.mark.parametrize("kw", [dict(), dict(smoothing_passes=0,
                                             max_depth=4000.0,
                                             min_ocean_depth=100.0)])
def test_init_global_ocean(kw):
    jm, tm = meshes("sphere")
    ds = jglobal.synthetic_woa_dataset()
    got = tglobal.init_global_ocean(tm, ds, nz=10, **kw)
    assert_same(got, jglobal.init_global_ocean(jm, ds, nz=10, **kw))
    grid = got[0]
    mlc = grid.maxLevelCell.numpy()
    assert mlc.min() == 2 and mlc.max() == 10        # land and deep ocean


def woa_file_variables(ds):
    """The dataset under its WOA/ETOPO file names, lat/lon in degrees."""
    return {"lat": (("lat",), np.rad2deg(ds["lat"])),
            "lon": (("lon",), np.rad2deg(ds["lon"])),
            "depth": (("depth",), ds["depth"]),
            "t_an": (("depth", "lat", "lon"), ds["temperature"]),
            "s_an": (("depth", "lat", "lon"), ds["salinity"]),
            "z": (("lat", "lon"), ds["topography"]),
            "taux": (("lat", "lon"), ds["windstress_zonal"])}


@pytest.mark.parametrize("fmt", ["netcdf4", "classic"])
def test_load_dataset_netcdf(tmp_path, fmt):
    ds = jglobal.synthetic_woa_dataset(nlat=18, nlon=36, ndep=12)
    dims = {"lat": 18, "lon": 36, "depth": 12}
    path = str(tmp_path / f"woa.{fmt}.nc")
    (write_hdf5 if fmt == "netcdf4" else write_netcdf)(
        path, dims, woa_file_variables(ds))
    got = tglobal.load_dataset_netcdf(path)
    assert_same(got, jglobal.load_dataset_netcdf(path))
    assert sorted(got) == sorted(k for k in ds if k != "tidal_energy_flux")
    np.testing.assert_allclose(got["lat"], ds["lat"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["temperature"], ds["temperature"])
    jm, tm = meshes("sphere")
    assert_same(tglobal.init_global_ocean(tm, got, nz=8),
                jglobal.init_global_ocean(jm, got, nz=8))


# ---------------------------------------------------------------------------
# two steps from each init
# ---------------------------------------------------------------------------

# the integrator of each init's reference test
# (tests/test_ocean_init_configs.py, test_ocean_ecosys_inits.py,
# test_ocean_land_ice_flux.py)
STEPPED = {
    "overflow": dict(config_dt=20.0, config_vert_mix_scheme="cvmix"),
    "internal_waves": dict(config_dt=30.0),
    "cosine_bell": dict(config_dt=600.0, config_time_integrator="RK4",
                        config_mom_del2=0.0, config_tracer_del2=0.0,
                        config_bottom_drag_coeff=0.0),
    "lock_exchange": dict(config_dt=5.0),
    "sea_mount": dict(config_dt=20.0),
    "ziso": dict(config_dt=60.0),
    "soma": dict(config_dt=120.0),
    "isomip": dict(config_dt=60.0),
    "sub_ice_shelf_2d": dict(config_dt=30.0),
    "cvmix_wswsbf": dict(config_dt=300.0, config_vert_mix_scheme="cvmix"),
    "global_ocean_idealized": dict(config_dt=120.0),
    "iso": dict(config_dt=120.0),
    "isomip_plus": dict(config_dt=30.0, config_time_integrator="RK4",
                        config_eos_type="jm"),
    "periodic_planar": dict(config_dt=60.0, config_time_integrator="RK4"),
    "ecosys_column": dict(config_dt=60.0, config_time_integrator="RK4"),
}


@pytest.mark.parametrize("name", sorted(STEPPED))
def test_two_steps_from_init(name):
    jm, tm = meshes(INITS[name])
    if name == "cosine_bell":       # the init keeps the mesh's radius
        jm, tm = jm.scaled(6371000.0), tm.scaled(6371000.0)
    jout = getattr(jinit, f"init_{name}")(jm, nz=NZ)
    tout = getattr(tinit, f"init_{name}")(tm, nz=NZ)
    check_two_steps(jout, tout, STEPPED[name])


def test_two_steps_from_global_ocean():
    """tests/test_ocean_fidelity.py:150-154's RK4 configuration."""
    jm, tm = meshes("sphere")
    ds = jglobal.synthetic_woa_dataset()
    check_two_steps(jglobal.init_global_ocean(jm, ds, nz=10),
                    tglobal.init_global_ocean(tm, ds, nz=10),
                    dict(config_dt=300.0, config_time_integrator="RK4",
                         config_mom_del2=1.0e4, config_tracer_del2=1.0e3))


def check_two_steps(jout, tout, cfg_kw):
    """2 run_steps in both packages from an init's output (the forcing,
    where it returns one, applied) at STEP_REL x max|ref|."""
    jforcing = tforcing = None
    if len(jout) == 3 and not isinstance(jout[2], dict):
        jforcing = jax.tree.map(jnp.asarray, jout[2])
        tforcing = tout[2].to("cpu", torch.float64)
    f64 = torch.float64
    jgrid = jax.tree.map(jnp.asarray, jout[0])
    ref = jcore.run_steps(jgrid, jcore.OcnConfig(**cfg_kw),
                          jax.tree.map(jnp.asarray, jout[1]), 2, jforcing)
    got = tcore.run_steps(tout[0].to("cpu", f64), tcore.OcnConfig(**cfg_kw),
                          tout[1].to("cpu", f64), 2, tforcing)
    for k in ("u", "layerThickness", "tracers", "ubtr"):
        r = np.asarray(getattr(ref, k))
        g = getattr(got, k).numpy()
        assert np.isfinite(g).all(), k
        scale = max(float(np.abs(r).max()), 1e-300)
        err = float(np.abs(g - r).max())
        assert err <= STEP_REL * scale, f"{k}: {err:.3e} x {scale:.3e}"
