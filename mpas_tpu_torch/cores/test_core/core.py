"""Test core: the framework self-test suite as a runnable core (port of
mpas_tpu/cores/test_core/core.py).

ref: src/core_test/mpas_test_core.F:86-171 — a full core whose core_run IS
the test suite: sorting, geometry/vector operator unit tests, halo-exchange
correctness, field copy/compare, stream I/O round-trips, timekeeping
interval arithmetic. Results log SUCCESS/FAILURE per test.

Run through `run_all(device, dtype)` (returns {name: (ok, detail)}) or the
command line (`python -m mpas_tpu_torch test`). The halo exchange runs 4
shards in one process on the one device (the loopback transport of
parallel/runner.py), so it needs no more devices and never skips.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch


def _rtol(dtype):
    return 1e-9 if dtype == torch.float64 else 1e-5


def test_sorting(device, dtype):
    """ref: mpas_test_core_sorting.F:33 — sort + index-sort correctness
    on random and adversarial inputs (validates the contract the reference
    validates for its quicksort)."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 1000, 4096):
        a = torch.from_numpy(rng.integers(-1000, 1000, n)).to(device)
        s, idx = torch.sort(a, stable=True)
        if not bool((s[1:] >= s[:-1]).all()):
            return False, f"sort order violated at n={n}"
        if not torch.equal(a[idx], s):
            return False, f"index sort mismatch at n={n}"
    return True, "sort + index sort ok"


def test_geometry(device, dtype):
    """ref: in-operator unit tests (mpas_geometry_utils.F:834-1596):
    spherical arcs/angles/areas, Wachspress coordinates."""
    from mpas_tpu_torch.ops.geometry import (arc_length, sphere_angle,
                                             triangle_signed_area_sphere,
                                             wachspress_coordinates)
    rtol = _rtol(dtype)
    a, b, c = torch.eye(3, dtype=dtype, device=device)
    # quarter-circle arc on the unit sphere
    if not np.isclose(float(arc_length(a, b)), 0.5 * np.pi, rtol=rtol):
        return False, "arc length of quarter circle wrong"
    # octant triangle: spherical excess = pi/2, all angles 90 deg
    area = float(triangle_signed_area_sphere(a, b, c))
    if not np.isclose(area, 0.5 * np.pi, rtol=rtol):
        return False, f"octant excess {area}"
    ang = float(sphere_angle(a, b, c))
    if not np.isclose(ang, 0.5 * np.pi, rtol=rtol):
        return False, f"octant angle {ang}"
    # Wachspress coordinates: polygon centroid of a square
    sq = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]],
                      dtype=dtype, device=device)
    lam = wachspress_coordinates(sq, torch.tensor([0.5, 0.5], dtype=dtype,
                                                  device=device))
    if not np.allclose(lam.cpu().numpy(), 0.25, rtol=rtol):
        return False, "wachspress centroid"
    return True, "geometry ok"


def test_vector_ops(device, dtype):
    """ref: mpas_vector_operations.F:901 unit tests — tangential
    reconstruction exactness for a uniform flow on a uniform hex mesh."""
    from mpas_tpu_torch.mesh.planar import planar_hex_mesh
    from mpas_tpu_torch.ops.stencils import tangential_velocity
    mesh = planar_hex_mesh(8, 8, 1000.0).to(device, dtype)
    atol = 1e-10 if dtype == torch.float64 else 1e-5
    # uniform eastward flow: u_n = cos(angle), tangential = -sin(angle)
    ang = mesh.angleEdge
    ut = tangential_velocity(mesh, torch.cos(ang))
    err = float((ut + torch.sin(ang)).abs().max())
    if err > atol:
        return False, f"tangential reconstruct err {err}"
    return True, "vector ops ok"


def test_halo_exchange(device, dtype):
    """ref: mpas_test_core_halo_exch.F — a 4-shard halo exchange recovers
    the serial field exactly."""
    from mpas_tpu_torch.mesh.planar import planar_hex_mesh
    from mpas_tpu_torch.parallel.layout import build_sharded_mesh
    from mpas_tpu_torch.parallel.partition import sfc_partition
    from mpas_tpu_torch.parallel.runner import (device_mesh, halo_exchange,
                                                scatter_field)
    n_parts = 4
    mesh = planar_hex_mesh(8, 8, 1000.0)
    sm = build_sharded_mesh(mesh, sfc_partition(mesh, n_parts),
                            halo_depth=2)
    group = device_mesh(n_parts, device)
    glob = np.arange(mesh.nCells, dtype=np.float64)
    stacked = scatter_field(sm, glob, "cell")
    corrupted = np.where(np.asarray(sm.owned_cell_mask) > 0, stacked, -1.0)
    out = group.stack(halo_exchange(sm.cell_xch,
                                    group.local(corrupted, dtype), group))
    gidx = np.asarray(sm.cell_global)
    valid = gidx >= 0
    if not np.array_equal(out[valid], glob[gidx[valid]]):
        bad = int(np.sum(out[valid] != glob[gidx[valid]]))
        return False, f"halo exchange mismatch at {bad} slots"
    return True, f"halo exchange ok ({n_parts} shards, loopback)"


def test_field_ops(device, dtype):
    """ref: mpas_test_core_field_tests.F — field copy/compare/shift time
    levels on the state containers."""
    from mpas_tpu_torch.cores.sw.state import SWState
    st = SWState(u=torch.arange(12.0, dtype=dtype, device=device),
                 h=torch.ones(5, dtype=dtype, device=device),
                 tracers=torch.zeros((5, 2), dtype=dtype, device=device))
    copy = dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)})
    same = all(torch.equal(getattr(st, f.name), getattr(copy, f.name))
               and getattr(st, f.name).data_ptr()
               != getattr(copy, f.name).data_ptr()
               for f in dataclasses.fields(st))
    if not same:
        return False, "field copy mismatch"
    # time-level shift semantics: new[t-1] <- old[t]
    levs = [st, copy]
    shifted = levs[1], levs[0]
    if shifted[0] is not copy:
        return False, "shift_time_levels order"
    return True, "field ops ok"


def test_streams_roundtrip(device, dtype):
    """ref: mpas_test_core_streams.F:38 — write a stream, read it back,
    bit-compare."""
    from mpas_tpu_torch.io.netcdf import read_netcdf, write_netcdf
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.uniform(0, 1, (10, 4))).to(device, dtype)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stream_test.nc")
        dims = {"nCells": 10, "nVertLevels": 4}
        variables = {
            "h": (("nCells", "nVertLevels"), h.cpu().numpy()),
            "idx": (("nCells",), np.arange(10, dtype=np.int32)),
        }
        write_netcdf(path, dims, variables, attrs={"model": "mpas_tpu_torch"})
        data, rdims, attrs = read_netcdf(path)
    if rdims["nCells"] != 10 or rdims["nVertLevels"] != 4:
        return False, "dims mismatch"
    if not torch.equal(torch.from_numpy(data["h"]).to(device), h):
        return False, "h not bitwise equal"
    if not np.array_equal(data["idx"], variables["idx"][1]):
        return False, "idx not equal"
    model = attrs.get("model")
    if isinstance(model, bytes):
        model = model.decode()
    if model != "mpas_tpu_torch":
        return False, "attrs lost"
    return True, "stream round-trip ok"


def test_timekeeping(device, dtype):
    """ref: mpas_test_core_timekeeping_tests.F — interval arithmetic
    across calendars, alarm ringing."""
    from mpas_tpu_torch.framework.timekeeping import (Alarm, Clock, Time,
                                                      TimeInterval)
    day = TimeInterval.from_string("1_00:00:00")
    t2 = Time.from_string("2000-02-28_00:00:00", calendar="gregorian") + day
    if t2.to_string() != "2000-02-29_00:00:00":
        return False, f"gregorian leap day: {t2.to_string()}"
    t3 = Time.from_string("2001-02-28_00:00:00", calendar="gregorian") + day
    if t3.to_string() != "2001-03-01_00:00:00":
        return False, f"gregorian non-leap: {t3.to_string()}"
    tn = Time.from_string("2000-02-28_00:00:00",
                          calendar="gregorian_noleap") + day
    if tn.to_string() != "2000-03-01_00:00:00":
        return False, f"noleap: {tn.to_string()}"
    # interval arithmetic
    iv = TimeInterval.from_string("0_01:30:00")
    if (iv * 4).total_seconds() != 6.0 * 3600.0:
        return False, "interval multiply"
    # alarms
    clock = Clock(Time.from_string("2000-01-01_00:00:00"),
                  TimeInterval.from_seconds(1800.0))
    al = Alarm("hourly", interval=TimeInterval.from_seconds(3600.0),
               reference=Time.from_string("2000-01-01_00:00:00"))
    clock.add_alarm(al)
    rings = 0
    for _ in range(5):
        if al.is_ringing(clock.now):
            rings += 1
            al.reset(clock.now)
        clock.advance()
    if rings != 3:     # t=0h, 1h, 2h within 5 half-hour steps
        return False, f"alarm rang {rings} times, expected 3"
    return True, "timekeeping ok"


ALL_TESTS = {
    "sorting": test_sorting,
    "geometry": test_geometry,
    "vector_ops": test_vector_ops,
    "halo_exchange": test_halo_exchange,
    "field_ops": test_field_ops,
    "streams": test_streams_roundtrip,
    "timekeeping": test_timekeeping,
}


def run_all(device, dtype=torch.float32, log=print):
    """ref: test_core_run logs SUCCESS/FAILURE per test and goes on to the
    next (mpas_test_core.F:86-171); a test that raises is a FAILURE with
    its exception."""
    results = {}
    for name, fn in ALL_TESTS.items():
        try:
            ok, detail = fn(device, dtype)
        except Exception as e:  # noqa: BLE001 — the suite must not abort
            ok, detail = False, f"exception: {e!r}"
        results[name] = (ok, detail)
        log(f" * {name}: {'SUCCESS' if ok else 'FAILURE'} - {detail}")
    return results
