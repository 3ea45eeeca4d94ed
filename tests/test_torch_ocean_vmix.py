"""The ocean's implicit vertical mix on the CPU after its solves moved to
kernels/vmix.py (K3 on the card, tests/test_torch_cuda.py).

On the CPU implicit_vertical_mix runs vmix_solve_plain, the Thomas loop of
ops/matrix.py. These tests hold it bit for bit to the solve the core ran
before (kept below verbatim as _core_solve), on the baroclinic channel
(channel_hex_mesh(8, 26, 10 km), 10 levels, perturbed from a numpy seed)
with and without level masks and bottom drag; check that the CPU path
never loads the kernel library; that the solves sit in one ocn.vmix_solve
span; that the benchmark's K3 label wraps the solve the core calls; and
that its frozen K3 byte count equals the kernel module's at the cells'
shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import common
from mpas_tpu_torch import kernels
from mpas_tpu_torch.cores.ocean import core, gm
from mpas_tpu_torch.cores.ocean.config import OcnConfig
from mpas_tpu_torch.cores.ocean.init_channel import init_baroclinic_channel
from mpas_tpu_torch.cores.ocean.vmix import build_coefs
from mpas_tpu_torch.kernels import build, vmix
from mpas_tpu_torch.mesh.planar import channel_hex_mesh
from mpas_tpu_torch.ops import stencils as st
from mpas_tpu_torch.ops.matrix import tridiagonal_solve

torch.set_num_threads(1)

NZ = 10
DRAGS = [0.0, 1.0e-3]
# (n, nz, ntr) of the cells' two solves, the channel's tracers, and f64
CELL_SHAPES = [(40962, 60, 12, 4), (122880, 60, 1, 4), (40962, 60, 12, 8),
               (122880, 60, 1, 8)]


def _core_solve(field, h_field, kappa, dt, bottom_drag=0.0, mask=None):
    """implicit_vertical_mix's solve as the core ran it before K3."""
    hi = torch.clamp(0.5 * (h_field[..., 1:] + h_field[..., :-1]),
                     min=1e-12)
    if mask is not None:
        kappa = kappa * mask[..., 1:]
    g = dt * kappa / hi
    gu = F.pad(g, (1, 0))
    gl = F.pad(g, (0, 1))
    h_safe = torch.clamp(h_field, min=1e-12)
    a = -gu / h_safe
    c = -gl / h_safe
    b = 1.0 - a - c
    if bottom_drag > 0.0:
        if mask is None:
            spd = field[..., -1].abs()
            b[..., -1] += dt * bottom_drag * spd / h_safe[..., -1]
        else:
            below = F.pad(mask[..., 1:], (0, 1))
            bottom = mask * (1.0 - below)
            spd_b = (field.abs() * bottom).sum(-1, keepdim=True)
            b = b + bottom * dt * bottom_drag * spd_b / h_safe
    return tridiagonal_solve(a, b, c, field)


def _core_mix(grid, cfg, state, dt):
    """The core's vertical mix before K3 (no forcing: no KPP flux)."""
    mesh = grid.mesh
    rho = core.equation_of_state(cfg, state.tracers[..., 0],
                                 state.tracers[..., 1])
    vert_visc, vert_diff, _ = build_coefs(
        grid, cfg, state.u, state.layerThickness, rho,
        tracers=state.tracers)
    if cfg.config_use_redi:
        vert_diff = vert_diff + gm.redi_vertical_enhancement(
            grid, cfg, rho, state.layerThickness)
    h_edge = st.cell_to_edge_mean(mesh, state.layerThickness)
    u_new = _core_solve(state.u, h_edge, vert_visc, dt,
                        cfg.config_bottom_drag_coeff, mask=grid.edgeMask)
    tr_new = torch.stack(
        [_core_solve(state.tracers[..., i], state.layerThickness, vert_diff,
                     dt, mask=grid.cellMask)
         for i in range(state.tracers.shape[-1])], dim=-1)
    return u_new * (1.0 - mesh.boundaryEdge)[:, None], tr_new


@pytest.fixture(scope="module")
def channel():
    """{"full", "masked"}: the perturbed channel's grid, and its state."""
    mesh = channel_hex_mesh(8, 26, 10000.0)
    grid, state = init_baroclinic_channel(mesh, nz=NZ)
    rng = np.random.default_rng(0)
    not_bnd = 1.0 - mesh.boundaryEdge.numpy()
    u = 0.1 * rng.standard_normal(tuple(state.u.shape)) * not_bnd[:, None]
    h = state.layerThickness.numpy() * (
        1.0 + 0.02 * rng.standard_normal(tuple(state.layerThickness.shape)))
    tr = state.tracers.numpy().copy()
    tr[..., 0] += 0.3 * rng.standard_normal(tr.shape[:2])
    tr[..., 1] += 0.05 * rng.standard_normal(tr.shape[:2])
    state = dataclasses.replace(state, u=torch.from_numpy(u),
                                layerThickness=torch.from_numpy(h),
                                tracers=torch.from_numpy(tr))
    mlc = rng.integers(NZ // 2, NZ + 1, mesh.nCells)
    cell_mask, edge_mask = core.build_level_masks(mesh, mlc, NZ)
    masked = dataclasses.replace(grid, cellMask=cell_mask,
                                 edgeMask=edge_mask)
    return {"full": grid, "masked": masked}, state


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("drag", DRAGS)
@pytest.mark.parametrize("ntr", [0, 3])
def test_vmix_solve_plain_is_the_core_solve(masked, drag, ntr):
    """vmix_solve_plain on seeded columns (dead columns, one-level
    columns, a boundary row) gives the core's former solve bit for bit."""
    a = {k: torch.from_numpy(v)
         for k, v in vmix.example_args(300, 12, ntr, seed=3).items()}
    mask = a["mask"] if masked else None
    got = vmix.vmix_solve_plain(a["field"], a["h"], a["kappa"], 600.0,
                                mask=mask, bottom_drag=drag,
                                boundary=None if ntr else a["boundary"])
    if ntr:
        want = torch.stack(
            [_core_solve(a["field"][..., i], a["h"], a["kappa"], 600.0,
                         drag, mask) for i in range(ntr)], dim=-1)
    else:
        want = _core_solve(a["field"], a["h"], a["kappa"], 600.0, drag,
                           mask) * (1.0 - a["boundary"])[:, None]
    assert torch.equal(got, want)


@pytest.mark.parametrize("grid", ["full", "masked"])
@pytest.mark.parametrize("drag", DRAGS)
@pytest.mark.parametrize("scheme", [dict(), dict(
    config_vert_mix_scheme="rich"), dict(config_use_redi=True)])
def test_implicit_vertical_mix_cpu_path_is_the_core_path(channel, grid, drag,
                                                         scheme):
    grids, state = channel
    cfg = OcnConfig(config_bottom_drag_coeff=drag, **scheme)
    got = core.implicit_vertical_mix(grids[grid], cfg, state, 300.0)
    u_want, tr_want = _core_mix(grids[grid], cfg, state, 300.0)
    assert torch.equal(got.u, u_want)
    assert torch.equal(got.tracers, tr_want)
    assert torch.equal(got.layerThickness, state.layerThickness)


def test_implicit_vertical_mix_on_the_cpu_never_loads_the_kernels(
        channel, monkeypatch):
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")
    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(vmix, "load_library", refuse)
    grids, state = channel
    kernels.reset_launch_counts()
    out = core.implicit_vertical_mix(grids["masked"], OcnConfig(), state,
                                     300.0)
    assert bool(torch.isfinite(out.tracers).all())
    assert all(v == 0 for v in kernels.launch_counts.values())


def test_both_solves_sit_in_one_vmix_solve_span(channel):
    grids, state = channel
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        core.implicit_vertical_mix(grids["masked"], OcnConfig(), state,
                                   300.0)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("ocn.vmix_solve") == 1
    assert core.VMIX_SOLVE_LAUNCHES_PER_STEP == 2


def test_k3_label_wraps_the_solve_the_core_calls():
    spans = common.metric_module("k3_roofline_pct").SPANS
    assert [s[:2] for s in spans] == [("mpas_tpu_torch.cores.ocean.core",
                                       "vmix_solve")]
    label = spans[0][2]
    assert label(torch.zeros(7, 5, 3)) == "k3:7x5x3:4"
    assert label(torch.zeros(7, 5, dtype=torch.float64)) == "k3:7x5x1:8"


@pytest.mark.parametrize("n,nz,ntr,itemsize", CELL_SHAPES)
def test_k3_roofline_bytes_are_the_kernels(n, nz, ntr, itemsize):
    frozen = common.metric_module("k3_roofline_pct").k3_bytes
    assert frozen(n, nz, ntr, itemsize) == vmix.bytes_moved(n, nz, ntr,
                                                            itemsize)


@pytest.mark.parametrize("nz,ntr", [(60, 12), (60, 1), (20, 2), (2, 1),
                                    (100, 12), (1, 1)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_vmix_plan_fits_a_block(nz, ntr, itemsize):
    cols, threads, smem = vmix.plan(nz, ntr, itemsize)
    assert smem == vmix.smem_bytes(cols, nz, ntr, itemsize)
    assert smem <= kernels.SMEM_LIMIT and threads % 32 == 0
    assert 32 <= threads <= kernels.MAX_THREADS
    assert cols >= 1 and (cols == 1 or cols * ntr <= vmix.SWEEP_THREADS)
    s = vmix.coef_stride(nz, itemsize)
    assert s >= nz and s * itemsize % 32 == 16
    sf = vmix.field_stride(nz, ntr, itemsize)
    assert sf == s if ntr == 1 else (
        sf >= nz * ntr and (sf - ntr) % (128 // itemsize) == 0)


def test_vmix_solve_raises_off_cpu_and_cuda():
    a = {k: torch.empty(v.shape, device="meta")
         for k, v in vmix.example_args(4, 6, 2).items()}
    with pytest.raises(ValueError):
        vmix.vmix_solve(a["field"], a["h"], a["kappa"], 60.0, a["mask"])
