"""The check of jw_15km on patches (benchmark/reference/mesh/patch.py,
benchmark/configs/jw_15km.py) on the CPU in float64. The reference on a
patch equals the reference on the whole globe at the compared cells over
start_at steps, and a halo one layer thinner than patch_halo gives NaN
there; every rank has compared cells under the jet; run through the
harness's path for several cards (4 gloo ranks, rank_jw15.py), a clean
run is correct, and a rank that drops one halo exchange of the sampled
step, or whose u moves by 1%, is not, under the test's limits and the
cell's own; in loopback a step left unchanged or with half its cells
kept is not correct under the cell's limits; the program's readings on
the patches (readings(), what the limits are set from) read what its
shards read."""

import importlib
import math
import time

import numpy as np
import pytest
import torch

from benchmark.harness import common, ranks
from benchmark.harness.meshfile import load_reference, mesh_path
from benchmark.reference.mesh import patch as patches

from . import test_bench_faults as faults
from .conftest import ROOT

JW15 = common.config_module("jw_15km")
CPU = torch.device("cpu")
CELL = "jw_15km.4chip"
CASE = str(ROOT / "benchmark" / "tests" / "rank_jw15.py")


def params_at(n):
    """jw_15km's numbers on the 10 n^2 + 2 cell mesh, in float64."""
    spec = common.load_spec()
    p = common.config_params(common.find(spec["configs"], "jw_15km", "c"))
    return dict(p, mesh={"n": n, "lloyd_iters": 1}, dtype="float64",
                counts={"cells": 10 * n * n + 2, "edges": 30 * n * n,
                        "vertices": 20 * n * n, "max_edges": 6},
                dt_s=9600.0 / n, len_disp_m=7.68e6 / n)


def traffic(**kw):
    t = common.traffic_params("jw_15km", "4chip")
    return dict(t, levels=6, **kw)


@pytest.fixture(scope="module")
def globe():
    """The reference on the whole 40,962-cell mesh from its init, its
    state after start_at steps, the seed's inputs and patch centres."""
    params, t = params_at(64), traffic()
    mesh = load_reference(mesh_path(params))
    part, _ = JW15.layout_of(params)
    inputs = JW15.make_inputs(params, 11, mesh)
    impl = JW15.reference_impl()
    whole = JW15.JW.JwCase(impl, params, t, inputs, CPU, torch.float64,
                           host=JW15.host_init(impl, params, t, mesh=mesh))
    for _ in range(JW15.start_at(t)):
        whole.step()
    centres = JW15.centres_of(params, mesh, part, 11)
    return params, t, mesh, dict(inputs, mesh=mesh), centres, whole


def patch_gap(globe, halo):
    """max over the state's fields of the reference on the first centre's
    patch (at this size more centres hold the whole globe) against the
    globe's, at the compared cells (u: the edges between them), after
    start_at steps."""
    params, t, mesh, inputs, centres, whole = globe
    patch = patches.build_patch(mesh, centres[:1],
                                params["patch"]["compared_layers"], halo)
    ref = JW15.on_patch(JW15.reference_impl(), params, t, inputs, patch,
                        CPU, torch.float64)
    for _ in range(JW15.start_at(t)):
        ref.step()
    gaps = []
    for k in JW15.FIELDS:
        on_edges = k == "u"
        rows = patch.compared_edges if on_edges else patch.compared_cells
        ids = (patch.edges if on_edges else patch.cells)[rows]
        got = getattr(ref.carry.state, k)[torch.from_numpy(rows)]
        want = getattr(whole.carry.state, k)[torch.from_numpy(ids)]
        gaps.append(float((got - want).abs().max() / want.abs().max()))
    return float(np.max(gaps))            # NaN where any gap is NaN


def test_the_patch_is_the_globe_at_the_compared_cells(globe):
    params, t = globe[0], globe[1]
    halo = JW15.patch_halo(params, JW15.start_at(t))
    assert patch_gap(globe, halo) <= 1e-12


def test_a_halo_one_layer_thinner_reads_a_ghost(globe):
    params, t = globe[0], globe[1]
    halo = JW15.patch_halo(params, JW15.start_at(t))
    assert math.isnan(patch_gap(globe, halo - 1))


def test_the_patch_centres_cross_every_rank(globe):
    params, mesh, centres = globe[0], globe[2], globe[4]
    part, _ = JW15.layout_of(params)
    compared = np.concatenate(patches.cell_layers(
        mesh, centres, params["patch"]["compared_layers"]))
    assert set(part[compared]) == set(range(params["partition"]["parts"]))
    # three shards meet at a compared cell
    assert any(len(set(part[np.concatenate(patches.cell_layers(
        mesh, [c], 1))])) >= 3 for c in compared)


def test_every_rank_has_compared_cells_under_the_jet(globe):
    params, mesh, centres = globe[0], globe[2], globe[4]
    part, _ = JW15.layout_of(params)
    compared = np.concatenate(patches.cell_layers(
        mesh, centres, params["patch"]["compared_layers"]))
    lat = np.degrees(np.abs(mesh.latCell.numpy()[compared]))
    lo, hi = params["patch"]["band_lat_deg"]
    jet = compared[(lat >= lo) & (lat <= hi)]
    assert set(part[jet]) == set(range(params["partition"]["parts"]))


def run(seed=2 ** 31 + 9, params=None, **kw):
    spec = common.load_spec()
    return ranks.run_ranks(spec, CELL, seed, 0.5, 0, time.perf_counter(),
                           backend="gloo", params=params or params_at(8),
                           traffic=traffic(**kw), config_file=CASE,
                           group_timeout_s=120.0)[0]


LIMITS = {"start_u": 1e-11, "start_rho_zz": 1e-11, "start_scalars": 1e-11,
          "step_u": 1e-11, "step_scalars": 1e-11, "step_k2": 1e-11}
# the cell's own limits
CELL_LIMITS = common.traffic_params("jw_15km", "4chip")["limits"]


@pytest.mark.parametrize("limits", [LIMITS, CELL_LIMITS],
                         ids=["1e-11", "cell"])
def test_a_clean_run_is_correct(limits):
    result = run(limits=limits)
    assert result["correct"], result["checks"]


# the sampled step's 40th exchange: ru_p before the third RK stage's
# recovery in the first dynamics substep (11 at the step's start; 11 in
# the first stage, 11 in the second; the third's tend_u, 2 a substep in
# its 2 acoustic substeps, rw_p, ru_p). Most single exchanges left out
# move the step by less than 1e-6 of a field's largest value, under the
# cell's float32 limits; this one by ~1e-5 (float64, the 642-cell mesh)
@pytest.mark.parametrize("fault", [{"at": "exchange", "which": 40},
                                   {"at": "u"}])
@pytest.mark.parametrize("limits", [LIMITS, CELL_LIMITS],
                         ids=["1e-11", "cell"])
def test_a_fault_on_one_rank_is_seen(fault, limits):
    result = run(limits=limits, fault=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_a_broken_step_is_not_correct_at_the_cells_limits(kind,
                                                          monkeypatch):
    """test_bench_faults.py's faults of the dycore's step (its one value
    moved by 1% lies outside this size's patches), in loopback at the
    test size under the cell's own limits."""
    mod = importlib.import_module(faults.JW)
    monkeypatch.setattr(mod, "srk3_step",
                        faults.jw_fault(kind, mod.srk3_step))
    result = faults.run_small(CELL)
    assert not result["correct"], result["checks"]


def test_the_program_on_the_patches_reads_as_its_shards():
    """readings(program=True), the port's one-card path on the seed's
    patches, reads the start numbers of the cell's own run over 4 ranks
    (float32, the same seed)."""
    params = dict(params_at(8), dtype="float32")
    t = traffic(limits=LIMITS)
    got = JW15.readings(params, t, 2 ** 31 + 9, CPU, program=True)
    want = run(params=params, limits=LIMITS)["checks"]
    for k in ("start_u", "start_rho_zz", "start_scalars"):
        assert got[k] == pytest.approx(want[k]["value"], rel=0.05), k
