"""The port's netCDF4/HDF5 reader and writer, MPAS grid files and the
`file:` mesh spec, against the reference package (float64, CPU).

Files written by either package are read by the other: arrays, dims and
attributes must come back equal, and the two writers must emit the same
bytes. A grid file read by the port must give, array by array and bit
for bit, what the reference's mesh_from_netcdf gives, and the mesh it
was written from (edgesOnEdge/weightsOnEdge in the file's packed layout).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.io import hdf5 as jhdf5
from mpas_tpu.io import hdf5_write as jhdf5w
from mpas_tpu.io import netcdf as jnc
from mpas_tpu.mesh import gridfile as jgf
from mpas_tpu.mesh.planar import channel_hex_mesh as jchannel
from mpas_tpu.mesh.planar import planar_hex_mesh as jhex
from mpas_tpu.mesh.sphere import icosahedral_mesh as jico
from mpas_tpu_torch.io import hdf5 as thdf5
from mpas_tpu_torch.io import hdf5_write as thdf5w
from mpas_tpu_torch.io import netcdf as tnc
from mpas_tpu_torch.mesh import gridfile as tgf
from mpas_tpu_torch.mesh.planar import channel_hex_mesh as tchannel
from mpas_tpu_torch.mesh.planar import planar_hex_mesh as thex
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh as tico
from tests.test_hdf5_foreign import build_fixture

torch.set_num_threads(1)


def _all_dtypes():
    rng = np.random.default_rng(0)
    dims = {"n": 50, "m": 7}
    variables = {
        "a_f8": (("n",), rng.standard_normal(50)),
        "a_f4": (("n", "m"), rng.standard_normal((50, 7)).astype(np.float32)),
        "a_i4": (("n",), rng.integers(-9, 9, 50).astype(np.int32)),
        "a_i8": (("n",), rng.integers(0, 2 ** 40, 50).astype(np.int64)),
        "a_i2": (("n",), rng.integers(-9, 9, 50).astype(np.int16)),
        "a_u1": (("n",), rng.integers(0, 255, 50).astype(np.uint8)),
    }
    return dims, variables, {"title": "x", "ver": np.int32(3)}, {}


def _chunked():
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((1000, 26)).astype(np.float32)
    big = rng.integers(1, 10 ** 6, (3000, 2)).astype(np.int32)
    wide = rng.standard_normal((700, 3))
    return ({"n": 1000, "k": 26, "e": 3000, "TWO": 2, "w": 700, "THREE": 3},
            {"x": (("n", "k"), arr), "conn": (("e", "TWO"), big),
             "wide": (("w", "THREE"), wide)},
            {"title": "chunked"}, {"compress": True, "chunk_rows": 128})


CASES = {"all_dtypes": _all_dtypes, "chunked_deflate_shuffle": _chunked}


def _check(read, dims, variables, attrs):
    v, d, a = read
    assert d == dims
    for k, (dn, arr) in variables.items():
        assert v[k].dtype == arr.dtype, k
        assert np.array_equal(v[k], arr), k
        assert a["__vardims__"][k] == dn, k
    for k, val in attrs.items():
        assert a[k] == val, k


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hdf5_round_trip_across_packages(case, writer, tmp_path):
    dims, variables, attrs, kw = CASES[case]()
    p = str(tmp_path / "t.nc")
    (jhdf5w if writer == "jax" else thdf5w).write_hdf5(p, dims, variables,
                                                       attrs, **kw)
    for reader in (thdf5, jhdf5):
        _check(reader.read_hdf5(p), dims, variables, attrs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hdf5_writers_emit_the_same_bytes(case, tmp_path):
    dims, variables, attrs, kw = CASES[case]()
    pj, pt = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jhdf5w.write_hdf5(pj, dims, variables, attrs, **kw)
    thdf5w.write_hdf5(pt, dims, variables, attrs, **kw)
    assert open(pj, "rb").read() == open(pt, "rb").read()


@pytest.fixture(scope="module")
def foreign(tmp_path_factory):
    data, arrays = build_fixture()
    p = tmp_path_factory.mktemp("foreign") / "foreign.nc"
    p.write_bytes(data)
    return str(p), data, arrays


def test_foreign_fixture_decodes(foreign):
    path, _, arrays = foreign
    out, dims, attrs = thdf5.read_hdf5(path)
    assert dims == {"x": 4, "y": 3}
    for k in ("T", "x", "cellID"):
        np.testing.assert_array_equal(out[k], arrays[k])
    assert "y" not in out
    assert attrs["__vardims__"]["T"] == ("x", "y")
    assert attrs["title"] == "hand-authored fixture"
    f = thdf5.HDF5File(path)
    assert f.datasets["T"]["attrs"]["units"] == "K"
    out, _, _ = thdf5.read_hdf5(path, variables=["T", "y"])
    np.testing.assert_array_equal(out["T"][:, 2], arrays["T"][:, 2])
    np.testing.assert_array_equal(out["y"], np.zeros(3, np.float32))


def _read_outcome(mod, path):
    try:
        out, dims, _ = mod.read_hdf5(path, max_elements=1 << 20)
    except mod.HDF5Error as e:
        return ("error", type(e).__name__)
    return ("ok", dims, {k: v for k, v in out.items()})


def _corruptions(data, kind):
    rng = np.random.default_rng({"truncate": 7, "byteflip": 11,
                                 "fields": 13}[kind])
    if kind == "truncate":
        cuts = sorted(set(int(c) for c in rng.integers(0, len(data), 60)))
        return [data[:c] for c in cuts + [8, 16, 48, 95, 96, 200]]
    out = []
    for _ in range(120 if kind == "byteflip" else 80):
        buf = bytearray(data)
        if kind == "byteflip":
            for _ in range(int(rng.integers(1, 4))):
                buf[int(rng.integers(0, len(buf)))] = int(
                    rng.integers(0, 256))
        else:
            pos = int(rng.integers(8, 256))
            width = int(rng.choice([2, 4, 8]))
            val = int(rng.choice([0, 1, 0xFF, 0xFFFF, len(data) - 1,
                                  len(data), 2 ** 31, 0xFFFFFFFF]))
            val &= (1 << (8 * width)) - 1
            buf[pos:pos + width] = val.to_bytes(width, "little")
        out.append(bytes(buf))
    return out


@pytest.mark.parametrize("kind", ["truncate", "byteflip", "fields"])
def test_corrupt_files_fail_or_read_as_the_reference_does(kind, foreign,
                                                          tmp_path):
    """Every corruption of the fixture ends in the same controlled
    HDF5Error or the same arrays in both packages."""
    _, data, _ = foreign
    for i, buf in enumerate(_corruptions(data, kind)):
        p = tmp_path / f"c{i}.nc"
        p.write_bytes(buf)
        got, want = _read_outcome(thdf5, str(p)), _read_outcome(jhdf5,
                                                                str(p))
        assert got[0] == want[0], i
        if got[0] == "ok":
            assert got[1] == want[1], i
            assert sorted(got[2]) == sorted(want[2]), i
            for k in want[2]:
                np.testing.assert_array_equal(got[2][k], want[2][k])
        else:
            assert got[1] == want[1], i


@pytest.mark.parametrize("fmt", ["classic", "netcdf4"])
def test_read_netcdf_dispatches_on_the_magic(fmt, tmp_path):
    p = str(tmp_path / "h.nc")
    if fmt == "netcdf4":
        thdf5w.write_hdf5(p, {"n": 4}, {"y": (("n",), np.arange(4.0))})
    else:
        tnc.write_netcdf(p, {"n": 4}, {"y": (("n",), np.arange(4.0))})
    with open(p, "rb") as f:
        assert f.read(4)[1:4] == (b"HDF" if fmt == "netcdf4" else b"DF\x02")
    for mod in (tnc, jnc):
        v, d, _ = mod.read_netcdf(p)
        assert np.array_equal(v["y"], np.arange(4.0)) and d["n"] == 4


def test_append_record_matches_the_reference():
    got, want = {}, {}
    for rec in ({"a": np.arange(3.0)}, {"a": np.ones(3), "b": 2.0}):
        tnc.append_record(got, rec)
        jnc.append_record(want, rec)
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k])
        for x, y in zip(got[k], want[k]):
            np.testing.assert_array_equal(x, y)


MESHES = {
    "sphere": (lambda: jico(8, lloyd_iters=1),
               lambda: tico(8, lloyd_iters=1)),
    "planar": (lambda: jhex(6, 6, 1000.0), lambda: thex(6, 6, 1000.0)),
    "channel": (lambda: jchannel(4, 8, 1000.0),
                lambda: tchannel(4, 8, 1000.0)),
}


@pytest.fixture(scope="module")
def meshes():
    return {k: (j(), t()) for k, (j, t) in MESHES.items()}


def _fields(m):
    return [f.name for f in dataclasses.fields(m)]


@pytest.mark.parametrize("fmt", ["classic", "netcdf4"])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_mesh_from_netcdf_equals_the_reference_and_the_built_mesh(
        kind, fmt, meshes, tmp_path):
    jm, tm = meshes[kind]
    p = str(tmp_path / "grid.nc")
    jgf.mesh_to_netcdf(jm, p, fmt=fmt)
    want = jgf.mesh_from_netcdf(p)
    got = tgf.mesh_from_netcdf(p)
    eoe, woe, _ = tgf.packed_edges_on_edge(tm)
    packed = {"edgesOnEdge": eoe, "weightsOnEdge": woe}
    assert _fields(got) == _fields(want)
    for name in _fields(got):
        g, w = getattr(got, name), getattr(want, name)
        b = getattr(tm, name)
        if not isinstance(g, torch.Tensor):
            assert g == w, name
            continue
        assert g.dtype in (torch.float64, torch.int64), name
        assert np.array_equal(g.numpy(), np.asarray(w)), name
        built = packed[name] if name in packed else b.numpy()
        assert np.array_equal(g.numpy(), built), name
    # the statics of the generated mesh (classic NetCDF keeps float
    # attributes in float32, in both packages)
    for name in ("nCells", "nEdges", "nVertices", "maxEdges", "on_sphere",
                 "sphere_radius", "x_period"):
        assert getattr(got, name) == getattr(tm, name), name


@pytest.mark.parametrize("fmt", ["classic", "netcdf4"])
@pytest.mark.parametrize("kind", sorted(MESHES))
def test_mesh_to_netcdf_writes_the_reference_bytes(kind, fmt, meshes,
                                                   tmp_path):
    jm, tm = meshes[kind]
    pj, pt = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    jgf.mesh_to_netcdf(jm, pj, fmt=fmt)
    tgf.mesh_to_netcdf(tm, pt, fmt=fmt)
    assert open(pj, "rb").read() == open(pt, "rb").read()


def test_mesh_validate(meshes):
    _, tm = meshes["sphere"]
    tm.validate()
    bad = dataclasses.replace(tm, weightsOnEdge=tm.weightsOnEdge[:, :-1])
    with pytest.raises(AssertionError):
        bad.validate()
    bad = dataclasses.replace(tm, nEdgesOnCell=tm.nEdgesOnCell + 7)
    with pytest.raises(AssertionError):
        bad.validate()


def _hooks(core):
    if core == "sw":
        from mpas_tpu_torch.cores.sw import config, hooks
        return hooks, config.SWConfig(config_dt=600.0, config_test_case=5)
    if core == "atmosphere":
        from mpas_tpu_torch.cores.atmosphere import config, hooks
        return hooks, config.AtmConfig(config_nvertlevels=6,
                                       config_dt=1800.0,
                                       config_len_disp=1.9e6)
    from mpas_tpu_torch.cores.ocean import config, hooks
    return hooks, config.OcnConfig()


@pytest.mark.parametrize("form", ["file:", ".nc"])
@pytest.mark.parametrize("core", ["sw", "atmosphere", "ocean"])
def test_each_core_runs_from_a_grid_file(core, form, tmp_path, monkeypatch):
    """parse_mesh_spec('file:PATH') and ('PATH.nc'): one step of each
    core from the netCDF4 grid file equals one from the built mesh."""
    monkeypatch.setenv("MPAS_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    hooks, cfg = _hooks(core)
    spec = "channel:4,12,10000" if core == "ocean" else "icos:4"
    from mpas_tpu_torch.cores.sw.hooks import parse_mesh_spec
    p = str(tmp_path / "grid.nc")
    tgf.mesh_to_netcdf(parse_mesh_spec(spec), p, fmt="netcdf4")
    file_spec = "file:" + p if form == "file:" else p
    assert parse_mesh_spec(file_spec).nCells \
        == parse_mesh_spec(spec).nCells
    outs = []
    for s in (spec, file_spec):
        run = hooks.HOOKS.setup(cfg, s, "cpu", torch.float64)
        run = hooks.HOOKS.step_chunk(run, 1)
        outs.append(hooks.HOOKS.output_fields(run)[0])
    assert sorted(outs[0]) == sorted(outs[1])
    for k, (_, a) in outs[0].items():
        b = outs[1][k][1]
        scale = max(float(np.abs(a).max()), 1e-300)
        assert float(np.abs(a - b).max()) <= 1e-12 * scale, k
