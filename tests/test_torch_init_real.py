"""The port's real-data init_atmosphere against the reference package
(float64, CPU): WPS intermediate files, map projections, horizontal and
vertical interpolation, geogrid tiles and the static aggregation, the GWD
statics, init_real (every array the port carries, and the surface
extras) and the surface-update and LBC cases.

Host numpy on both sides: the same inputs must give the same numbers,
bit for bit where the arithmetic is the same, else at 1e-12 of the
field's largest value.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpas_tpu.cores.atmosphere import boundaries as jbdy
from mpas_tpu.cores.atmosphere import setup as jsetup
from mpas_tpu.cores.atmosphere.config import AtmConfig as JConfig
from mpas_tpu.cores.init_atmosphere import gwd as jgwd
from mpas_tpu.cores.init_atmosphere import hinterp as jhi
from mpas_tpu.cores.init_atmosphere import llxy as jll
from mpas_tpu.cores.init_atmosphere import met_reader as jmr
from mpas_tpu.cores.init_atmosphere import real_case as jreal
from mpas_tpu.cores.init_atmosphere import static as jst
from mpas_tpu.cores.init_atmosphere import surface_lbc as jsl
from mpas_tpu.cores.init_atmosphere import vinterp as jvi
from mpas_tpu.mesh.planar import box_hex_mesh as jbox
from mpas_tpu.mesh.sphere import icosahedral_mesh as jico
from mpas_tpu_torch.cores.atmosphere import boundaries as tbdy
from mpas_tpu_torch.cores.atmosphere import setup as tsetup
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig as TConfig
from mpas_tpu_torch.cores.init_atmosphere import gwd as tgwd
from mpas_tpu_torch.cores.init_atmosphere import hinterp as thi
from mpas_tpu_torch.cores.init_atmosphere import llxy as tll
from mpas_tpu_torch.cores.init_atmosphere import met_reader as tmr
from mpas_tpu_torch.cores.init_atmosphere import real_case as treal
from mpas_tpu_torch.cores.init_atmosphere import static as tst
from mpas_tpu_torch.cores.init_atmosphere import surface_lbc as tsl
from mpas_tpu_torch.cores.init_atmosphere import vinterp as tvi
from mpas_tpu_torch.mesh.planar import box_hex_mesh as tbox
from mpas_tpu_torch.mesh.sphere import icosahedral_mesh as tico
from tests.test_init_real import _synthetic_gfs, _synthetic_gfs_full
from tests.test_init_surface_lbc import _sfc_file

torch.set_num_threads(1)

TOL = 1e-12


def _close(got, want, name, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{name}: {err:.3g} of {scale:.3g}"


# --------------------------------------------------------------------------
# WPS intermediate files
# --------------------------------------------------------------------------

def _same_fields(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if f.name == "slab":
                assert u.dtype == v.dtype and np.array_equal(u, v)
            else:
                assert u == v, f.name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_met_files_round_trip_between_packages(writer, tmp_path):
    path = _synthetic_gfs_full(tmp_path)
    fields = jmr.read_met_file(path)
    p = str(tmp_path / "again")
    (jmr if writer == "jax" else tmr).write_met_file(p, fields)
    got, want = tmr.read_met_file(p), jmr.read_met_file(p)
    _same_fields(got, want)
    _same_fields(got, fields)
    for name in ("TT", "GHT", "RH"):
        lg, sg = tmr.fields_by_level(got, name)
        lw, sw = jmr.fields_by_level(want, name)
        assert np.array_equal(lg, lw) and np.array_equal(sg, sw)
    for name in ("PSFC", "SST", "NOPE"):
        sg, sw = tmr.surface_field(got, name), jmr.surface_field(want, name)
        assert (sg is None and sw is None) or np.array_equal(sg, sw)


def test_met_writers_emit_the_same_bytes(tmp_path):
    fields = jmr.read_met_file(_synthetic_gfs_full(tmp_path))
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jmr.write_met_file(pj, fields)
    tmr.write_met_file(pt, fields)
    assert open(pj, "rb").read() == open(pt, "rb").read()


# --------------------------------------------------------------------------
# projections and interpolation
# --------------------------------------------------------------------------

PROJS = {
    "latlon": dict(code="latlon", lat1=-30.0, lon1=10.0, dx=0.5, dy=0.5),
    "merc": dict(code="merc", lat1=-20.0, lon1=-40.0, dx=20000.0,
                 dy=20000.0, truelat1=10.0),
    "ps": dict(code="ps", lat1=50.0, lon1=-120.0, dx=25000.0, dy=25000.0,
               stdlon=-100.0, truelat1=60.0),
    "lc": dict(code="lc", lat1=25.0, lon1=-110.0, dx=12000.0, dy=12000.0,
               stdlon=-95.0, truelat1=30.0, truelat2=60.0),
    "lc_south": dict(code="lc", lat1=-35.0, lon1=140.0, dx=12000.0,
                     dy=12000.0, stdlon=135.0, truelat1=-30.0,
                     truelat2=-50.0),
}


@pytest.mark.parametrize("proj", sorted(PROJS))
def test_llxy_matches_the_reference(proj):
    rng = np.random.default_rng(4)
    lat = rng.uniform(10.0, 60.0, 200) * (-1 if "south" in proj else 1)
    lon = rng.uniform(-150.0, 160.0, 200)
    pj, pt = jll.ProjInfo(**PROJS[proj]), tll.ProjInfo(**PROJS[proj])
    ig, jg = tll.llij(pt, lat, lon)
    iw, jw = jll.llij(pj, lat, lon)
    _close(ig, iw, "i")
    _close(jg, jw, "j")
    lag, log_ = tll.ijll(pt, ig, jg)
    law, low = jll.ijll(pj, iw, jw)
    _close(lag, law, "lat")
    _close(log_, low, "lon")


@pytest.mark.parametrize("missing", [None, -999.0])
@pytest.mark.parametrize("method", ["nearest", "bilinear", "sixteen_pt",
                                    "sequence"])
def test_hinterp_matches_the_reference(method, missing):
    rng = np.random.default_rng(5)
    src = rng.standard_normal((23, 31))
    if missing is not None:
        src[rng.random(src.shape) < 0.1] = missing
    else:
        src[rng.random(src.shape) < 0.05] = np.nan
    i = rng.uniform(-1.0, 31.5, 300)
    j = rng.uniform(-1.0, 23.5, 300)
    if method == "sequence":
        got = thi.interp_sequence(src, i, j, missing=missing)
        want = jhi.interp_sequence(src, i, j, missing=missing)
    else:
        got = thi.METHODS[method](src, i, j, missing=missing)
        want = jhi.METHODS[method](src, i, j, missing=missing)
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("extrap", ["const", "linear"])
def test_vertical_interp_is_the_reference_bit_for_bit(extrap):
    rng = np.random.default_rng(6)
    src = np.sort(rng.uniform(0.0, 20000.0, (40, 9)), axis=1)
    val = rng.standard_normal((40, 9))
    tgt = np.sort(rng.uniform(-500.0, 22000.0, (40, 12)), axis=1)
    got = tvi.vertical_interp(tgt, src, val, extrap=extrap)
    want = jvi.vertical_interp(tgt, src, val, extrap=extrap)
    assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# geogrid tiles and the static aggregation
# --------------------------------------------------------------------------

def _tile_values(wordsize, isigned, scalefactor, rng):
    bits = 8 * wordsize
    lo, hi = (-(2 ** (bits - 1)), 2 ** (bits - 1)) if isigned \
        else (0, 2 ** bits)
    if wordsize == 4:           # beyond float32's exact integers
        lo, hi = (-(2 ** 23), 2 ** 23) if isigned else (0, 2 ** 24)
    ints = rng.integers(lo, hi, (2, 5, 7))
    return (ints * scalefactor).astype(np.float32)


@pytest.mark.parametrize("scalefactor", [1.0, 0.25, 10.0])
@pytest.mark.parametrize("endian", [0, 1])
@pytest.mark.parametrize("isigned", [0, 1])
@pytest.mark.parametrize("wordsize", [1, 2, 3, 4])
def test_geogrid_tiles_interchange_with_the_ctypes_reader(
        wordsize, isigned, endian, scalefactor, tmp_path):
    rng = np.random.default_rng(wordsize * 100 + isigned * 10 + endian)
    arr = _tile_values(wordsize, isigned, scalefactor, rng)
    pj, pt = tmp_path / "j.bin", tmp_path / "t.bin"
    kw = dict(isigned=isigned, endian=endian, scalefactor=scalefactor,
              wordsize=wordsize)
    jst.write_geogrid_tile(pj, arr, **kw)
    tst.write_geogrid_tile(pt, arr, **kw)
    assert pj.read_bytes() == pt.read_bytes()
    assert pt.stat().st_size == arr.size * wordsize
    for p in (pj, pt):
        got = tst.read_geogrid_tile(p, 7, 5, 2, **kw)
        want = jst.read_geogrid_tile(p, 7, 5, 2, **kw)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        if scalefactor != 10.0:   # a power of two: the round trip is exact
            assert np.array_equal(got, arr)
    # bytes that do not come from a writer: every bit pattern of the word
    raw = rng.integers(0, 256, 70 * wordsize).astype(np.uint8)
    pr = tmp_path / "raw.bin"
    pr.write_bytes(raw.tobytes())
    assert np.array_equal(tst.read_geogrid_tile(pr, 7, 5, 2, **kw),
                          jst.read_geogrid_tile(pr, 7, 5, 2, **kw))


def test_geogrid_reader_raises_on_a_tile_it_cannot_read(tmp_path):
    p = tmp_path / "short.bin"
    p.write_bytes(b"\x00" * 10)
    with pytest.raises(IOError):
        tst.read_geogrid_tile(p, 3, 2, 1, wordsize=2)
    with pytest.raises(FileNotFoundError):
        tst.read_geogrid_tile(tmp_path / "missing", 3, 2, 1)
    with pytest.raises(ValueError):
        tst.read_geogrid_tile(p, 1, 1, 1, wordsize=5)


@pytest.fixture(scope="module")
def pixels():
    rng = np.random.default_rng(8)
    lat_c = np.deg2rad(rng.uniform(-10.0, 20.0, 40))
    lon_c = np.deg2rad(rng.uniform(-10.0, 20.0, 40))
    lat_p = np.deg2rad(rng.uniform(-12.0, 22.0, 5000))
    lon_p = np.deg2rad(rng.uniform(-12.0, 22.0, 5000))
    return lat_c, lon_c, lat_p, lon_p, rng


def test_pixel_push_matches_the_reference(pixels):
    lat_c, lon_c, lat_p, lon_p, rng = pixels
    assert np.array_equal(tst.nearest_cells(lat_p, lon_p, lat_c, lon_c),
                          jst.nearest_cells(lat_p, lon_p, lat_c, lon_c))
    vals = rng.uniform(-100.0, 3000.0, lat_p.size)
    for a, b in zip(tst.pixel_push_mean(lat_p, lon_p, vals, lat_c, lon_c),
                    jst.pixel_push_mean(lat_p, lon_p, vals, lat_c, lon_c)):
        assert np.array_equal(a, b)
    cats = rng.integers(0, 25, lat_p.size)
    for skip in (True, False):
        for a, b in zip(
                tst.pixel_push_dominant(lat_p, lon_p, cats, lat_c, lon_c,
                                        24, skip_zero=skip),
                jst.pixel_push_dominant(lat_p, lon_p, cats, lat_c, lon_c,
                                        24, skip_zero=skip)):
            assert np.array_equal(a, b)


def test_consistency_lapse_and_climatology_match_the_reference(pixels):
    lat_c, lon_c, _, _, rng = pixels
    lu = rng.choice([16, 24, 3, 5, 7], 40)
    sc = rng.choice([14, 16, 4, 8], 40)
    for a, b in zip(tst.landuse_consistency(lu, sc),
                    jst.landuse_consistency(lu, sc)):
        assert np.array_equal(a, b)
    _, _, lm = tst.landuse_consistency(lu, sc)
    t, ter = rng.uniform(270.0, 300.0, 40), rng.uniform(0.0, 3000.0, 40)
    assert np.array_equal(tst.soiltemp_adjust(t, ter, lm),
                          jst.soiltemp_adjust(t, ter, lm))
    kw = dict(code="latlon", lat1=-15.0, lon1=-15.0, dx=0.5, dy=0.5)
    tile = rng.uniform(0.0, 1.0, (12, 80, 80)).astype(np.float32)
    tile[:, 30:35, 30:35] = -1.0
    lat_d, lon_d = np.degrees(lat_c), np.degrees(lon_c)
    for missing in (None, -1.0):
        assert np.array_equal(
            tst.monthly_climatology_to_cells(tile, tll.ProjInfo(**kw),
                                             lat_d, lon_d, missing),
            jst.monthly_climatology_to_cells(tile, jll.ProjInfo(**kw),
                                             lat_d, lon_d, missing))
    for method in ("nearest", "bilinear", "sixteen_pt"):
        assert np.array_equal(
            tst.interp_static_to_cells(tile[0], tll.ProjInfo(**kw), lat_d,
                                       lon_d, method),
            jst.interp_static_to_cells(tile[0], jll.ProjInfo(**kw), lat_d,
                                       lon_d, method))
    clim = tst.monthly_climatology_to_cells(tile, tll.ProjInfo(**kw), lat_d,
                                            lon_d)
    for a, b in zip(tst.shd_min_max(clim), jst.shd_min_max(clim)):
        assert np.array_equal(a, b)


# --------------------------------------------------------------------------
# GWD statics
# --------------------------------------------------------------------------

def test_gwd_statics_match_the_reference():
    rng = np.random.default_rng(9)
    topo = 300.0 * rng.standard_normal((64, 64))
    lu = rng.choice([1, 5, jgwd.WATER], (64, 64))
    i_c, j_c = rng.uniform(0, 63, 20), rng.uniform(0, 63, 20)
    for landuse in (None, lu):
        for half in (4, 8, 16):
            got = tgwd.gwd_statics(topo, i_c, j_c, half, landuse)
            want = jgwd.gwd_statics(topo, i_c, j_c, half, landuse)
            assert sorted(got) == sorted(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), k


def test_compute_gwd_fields_match_the_reference():
    rng = np.random.default_rng(10)
    topo = 300.0 * rng.standard_normal((90, 180)) + 500.0
    lu = rng.choice([1, 5, jgwd.WATER], (90, 180))
    tm, jm = tico(4, lloyd_iters=1), jico(4, lloyd_iters=1)
    dc = tgwd.mean_cell_diameter(tm.scaled(6371229.0))
    assert np.array_equal(dc, jgwd.mean_cell_diameter(
        jm.scaled(6371229.0)))
    lat = np.degrees(tm.latCell.numpy())
    lon = np.degrees(tm.lonCell.numpy())
    lon = np.where(lon > 180.0, lon - 360.0, lon)
    for landuse in (None, lu):
        got = tgwd.compute_gwd_fields(topo, landuse, lat, lon, dc)
        want = jgwd.compute_gwd_fields(topo, landuse, lat, lon, dc)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        assert np.all(np.isfinite(got["var2d"]))


# --------------------------------------------------------------------------
# init_real
# --------------------------------------------------------------------------

GFS = {"gfs": _synthetic_gfs, "gfs_full": _synthetic_gfs_full}


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    """init_real of both packages on icosahedral_mesh(4) and (8) with
    both synthetic first guesses."""
    out = {}
    for n in (4, 8):
        jm, tm = jico(n, lloyd_iters=1), tico(n, lloyd_iters=1)
        for name, make in GFS.items():
            path = make(tmp_path_factory.mktemp(f"{name}{n}"))
            kw = dict(config_nvertlevels=10, config_dt=600.0,
                      config_len_disp=1.9e6)
            want = jreal.init_real(jm, JConfig(**kw),
                                   jmr.read_met_file(path))
            timings = {}
            got = treal.init_real(tm, TConfig(**kw), tmr.read_met_file(path),
                                  timings=timings)
            out[(n, name)] = (got, want, timings, path)
    return out


CASES = [(n, name) for n in (4, 8) for name in sorted(GFS)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"icos{c[0]}_{c[1]}")
def test_init_real_matches_the_reference(case, real):
    (g, s, d, x), (jg, js, jd, jx), timings, _ = real[case]
    for obj, jobj in ((g.vert, jg.vert), (g.mesh, jg.mesh), (g, jg),
                      (s, js), (d, jd)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor) and f.name not in (
                    "d2_bmat", "d2w", "d2w_own", "d2w_opp", "adv_sside",
                    "dv_cell"):
                assert v.dtype in (torch.float64, torch.int64), f.name
                _close(v, getattr(jobj, f.name), f.name)
            elif not isinstance(v, torch.Tensor) and f.name not in (
                    "mesh", "vert", "adv_beta"):
                assert v == getattr(jobj, f.name), f.name
    assert g.adv_beta == TConfig().config_coef_3rd_order
    assert sorted(x) == sorted(jx)
    for k in jx:
        _close(x[k], jx[k], k)
    assert timings["vertical_interp_s"] >= 0.0


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"icos{c[0]}_{c[1]}")
def test_init_real_factored_tensors_match_the_reference_builders(case,
                                                                 real):
    """The port's init_real carries the factored advection tensors, which
    the reference's builders give for the same (Earth-radius) mesh."""
    (g, _, _, _), (jg, _, _, _), _, _ = real[case]
    bmats = jsetup.build_cell_fit_matrices(jg.mesh)
    d2_bmat, d2w = jsetup.build_adv_factored(jg.mesh, bmats)
    own, opp, sside, dv = jsetup.build_adv_cell_tensors(jg.mesh)
    for name, want in (("d2_bmat", d2_bmat), ("d2w", d2w), ("d2w_own", own),
                       ("d2w_opp", opp), ("adv_sside", sside),
                       ("dv_cell", dv)):
        _close(getattr(g, name), want, name)


@pytest.mark.parametrize("n", [4, 8])
def test_build_adv_coefs_matches_the_reference(n, real):
    (g, _, _, _), (jg, _, _, _), _, _ = real[(n, "gfs")]
    got = tsetup.build_adv_coefs(
        g.mesh, tsetup.build_deriv_two(
            g.mesh, tsetup.build_cell_fit_matrices(g.mesh)), 0.25)
    want = (np.asarray(jg.advCellsForEdge), np.asarray(jg.adv_coefs),
            np.asarray(jg.adv_coefs_3rd))
    assert np.array_equal(got[0], want[0])
    _close(got[1], want[1], "adv_coefs")
    _close(got[2], want[2], "adv_coefs_3rd")


def test_init_real_raises_without_a_required_field(real):
    fields = [f for f in tmr.read_met_file(real[(4, "gfs")][3])
              if f.field != "GHT"]
    with pytest.raises(ValueError, match="GHT"):
        treal.init_real(tico(4, lloyd_iters=1), TConfig(config_nvertlevels=4),
                        fields)


# --------------------------------------------------------------------------
# cases 8 and 9
# --------------------------------------------------------------------------

def test_sfc_update_and_surface_updates_match_the_reference(real, tmp_path):
    jm, tm = jico(8, lloyd_iters=1), tico(8, lloyd_iters=1)
    fields = tmr.read_met_file(real[(8, "gfs_full")][3])
    got, want = treal.build_sfc_update(tm, fields), jreal.build_sfc_update(
        jm, jmr.read_met_file(real[(8, "gfs_full")][3]))
    assert got[0] == want[0]
    for k in want[1]:
        assert got[1][k][0] == want[1][k][0]
        assert np.array_equal(got[1][k][1], want[1][k][1]), k
    paths = [(t, _sfc_file(tmp_path, t, sst0))
             for t, sst0 in [("2020-01-01_00:00:00", 288.0),
                             ("2020-01-01_06:00:00", 290.0)]]
    got = tsl.build_surface_updates(tm, paths)
    want = jsl.build_surface_updates(jm, paths)
    assert [r.time for r in got] == [r.time for r in want]
    for a, b in zip(got, want):
        for k in ("sst", "xice", "skintemp"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    # SKINTEMP absent: sst stands in for it, as in the reference
    only_sst = [f for f in tmr.read_met_file(paths[0][1])
                if f.field != "SKINTEMP"]
    a = tsl.interp_sfc_to_mpas(tm, only_sst, "t")
    assert np.array_equal(a.skintemp, a.sst)


def test_lbc_records_match_the_reference(real):
    jm, tm = jbox(20, 20, 120000.0), tbox(20, 20, 120000.0)
    path = real[(4, "gfs")][3]
    kw = dict(config_nvertlevels=10, config_dt=60.0)
    snaps = [("2020-01-01_00:00:00", None), ("2020-01-01_06:00:00", None)]
    got = tsl.build_lbc_records(
        tm, TConfig(**kw), [(t, tmr.read_met_file(path)) for t, _ in snaps],
        tbdy.build_bdy_masks(tm))
    want = jsl.build_lbc_records(
        jm, JConfig(**kw), [(t, jmr.read_met_file(path)) for t, _ in snaps],
        jbdy.build_bdy_masks(jm))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.time == b.time
        for k in ("lbc_u", "lbc_theta", "lbc_rho", "lbc_w", "lbc_scalars"):
            _close(getattr(a, k), getattr(b, k), k)
    cmask = tbdy.build_bdy_masks(tm).bdyMaskCell.numpy() > 0
    assert cmask.any() and (~cmask).any()
    assert np.abs(got[0].lbc_theta[~cmask]).max() == 0.0
    assert (got[0].lbc_theta[cmask] > 100.0).all()
