"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. The card's machine has
no JAX, so this file imports none and runs without the suite's conftest:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py

Shapes are those of the paths (jw_120km: 40,962 cells x 26 levels;
real_120km: 40,962 cells x 55 levels;
supercell_2km: 9,216 cells x 40 levels; jw_var60_15: 23,000 cells x 26
levels at maxEdges 8; sw_tc5_120km: 40,962 cells at K = 1 and 2;
ocean_channel_10km: 6,336 cells at K = 1, 20 and 40; the flat loopback
layouts of jw_120km and ocean_channel_10km sharded 4 ways: 48,420 and
9,940 cells, no multiple of a tile).
Beyond those, the tiled kernels' edge cases: column and cell counts that
no tile size divides, level counts from 2 to 500 (where K1's tile
shrinks), and operands that start one element into their storage.
K3 (the ocean's vertical-mix solve) at ocean_global_120km's tracer
(40,962 x 60 x 12) and velocity (122,880 x 60, bottom drag and boundary
row) solves and the channel's (6,336 cells, 10-40 levels; unmasked as it
runs, and at its flat layout sharded 4 ways), with dead and one-level
columns, no mask, level counts from 2 to 100 and column counts that no
tile divides.
Tolerances: float64 1e-12 x max|plain| (summation order only); float32
1e-5 for K1 and K3, whose Thomas recurrences amplify differently rounded
products, 1e-6 for K2.
"""

import ctypes

import numpy as np
import pytest
import torch

from mpas_tpu_torch import kernels
from mpas_tpu_torch.kernels import acoustic, tinydot as k2
from mpas_tpu_torch.kernels.acoustic import (acoustic_cell_update,
                                             acoustic_cell_update_plain,
                                             example_args)
from mpas_tpu_torch.kernels.build import load_library
from mpas_tpu_torch.kernels.tinydot import tinydot, tinydot_plain
from mpas_tpu_torch.kernels import vmix
from mpas_tpu_torch.kernels.vmix import vmix_solve, vmix_solve_plain

# (nC, nz) per path, K1 at real_120km's 55 levels, and at the flat
# loopback layout of jw_120km sharded 4 ways (4 x 12,105 padded cells)
PATHS = [(40962, 26), (9216, 40), (23000, 26), (40962, 55), (48420, 26)]
# (nC, P, I, K) of the TRiSK and second-derivative contractions of the
# atmosphere paths (I = maxEdges), and the shallow-water TRiSK pair
K2_SHAPES = [(nc, P, mE, K) for nc, nz, mE in ((40962, 26, 6),
                                               (9216, 40, 6),
                                               (23000, 26, 8),
                                               (40962, 55, 6))
             for P, K in ((mE, nz), (mE, 2 * nz), (3, nz))] \
    + [(40962, 6, 6, 1), (40962, 6, 6, 2)] \
    + [(6336, 6, 6, K) for K in (1, 20, 40)] \
    + [(48420, P, 6, K) for P, K in ((6, 26), (6, 52), (3, 26))] \
    + [(9940, 6, 6, K) for K in (1, 20, 40)]

# (n, nz, ntr, masked, bottom drag) of K3: ocean_global_120km's tracer and
# velocity solves (ntr 0: a 2-D field with a boundary row), the channel's
# tracers at 10, 20 and 40 levels and its unmasked edges with drag; then
# the channel as it runs (no mask: 6,336 cells, 19,072 edges, 20 levels)
# and its flat loopback layout sharded 4 ways (9,940 cells, 31,800 edges)
K3_CASES = [(40962, 60, 12, True, 0.0), (122880, 60, 0, True, 1e-3),
            (122880, 60, 0, True, 0.0), (6336, 10, 2, False, 0.0),
            (6336, 20, 2, True, 0.0), (6336, 40, 2, True, 0.0),
            (19008, 20, 0, False, 1e-3), (6336, 20, 2, False, 0.0),
            (19072, 20, 0, False, 1e-3), (9940, 20, 2, False, 0.0),
            (31800, 20, 0, False, 1e-3)]
F64_F32_K3 = [(torch.float64, 1e-12), (torch.float32, 1e-5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def assert_close(got, ref, rel):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.device == r.device
        assert float((g - r).abs().max()) <= rel * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("nc,nz", PATHS)
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_acoustic_kernel_matches_plain(cuda_device, nc, nz, dtype, rel):
    a = {k: torch.from_numpy(v).to(cuda_device, dtype)
         for k, v in example_args(nc, nz).items()}
    kernels.reset_launch_counts()
    got = acoustic_cell_update(nz, 0.1, 120.0, **a)
    assert kernels.launch_counts["acoustic_cell_update"] == 1
    assert_close(got, acoustic_cell_update_plain(nz, 0.1, 120.0, **a), rel)


@pytest.mark.cuda
@pytest.mark.parametrize("nc,P,I,K", K2_SHAPES)
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_tinydot_kernel_matches_plain(cuda_device, nc, P, I, K, dtype, rel):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((nc, P, I))
    # zero-weight padded slots, as in the cells of a maxEdges-8 mesh that
    # have fewer than 8 edges
    pad = rng.uniform(size=(nc, 1, I)) < 0.3
    w = torch.from_numpy(np.where(pad, 0.0, w)).to(cuda_device, dtype)
    x = torch.from_numpy(rng.standard_normal((nc, I, K))).to(
        cuda_device, dtype)
    kernels.reset_launch_counts()
    got = tinydot(w, x)
    assert kernels.launch_counts["tinydot"] == 1
    assert_close([got], [tinydot_plain(w, x)], rel)


def offset_view(t):
    """A contiguous copy of t that starts one element into its storage, so
    that its data pointer is not 16-byte aligned."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.storage_offset() == 1
    return view


def acoustic_case(cuda_device, nc, nz, dtype, rel, offset=False):
    a = {k: torch.from_numpy(v).to(cuda_device, dtype)
         for k, v in example_args(nc, nz, seed=nc + nz).items()}
    if offset:
        a = {k: offset_view(v) for k, v in a.items()}
    kernels.reset_launch_counts()
    got = acoustic_cell_update(nz, 0.1, 120.0, **a)
    assert kernels.launch_counts["acoustic_cell_update"] == 1
    assert_close(got, acoustic_cell_update_plain(nz, 0.1, 120.0, **a), rel)


F64_F32 = [(torch.float64, 1e-12), (torch.float32, 1e-5)]


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 33, 9217, 40961])
@pytest.mark.parametrize("dtype,rel", F64_F32)
def test_acoustic_kernel_ragged_last_tile(cuda_device, nc, dtype, rel):
    """Column counts that no tile size divides."""
    acoustic_case(cuda_device, nc, 26, dtype, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [2, 37, 128, 500])
def test_acoustic_kernel_level_counts_f64(cuda_device, nz):
    """nz = 2, an odd nz, and 128 and 500 levels in float64, where the tile
    shrinks to one column (at 500 levels of over 48 KB of shared
    memory)."""
    acoustic_case(cuda_device, 1001, nz, torch.float64, 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", F64_F32)
def test_acoustic_kernel_storage_offset(cuda_device, dtype, rel):
    """Inputs whose storage starts one element in: tiles start unaligned."""
    acoustic_case(cuda_device, 4097, 26, dtype, rel, offset=True)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 80])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_tinydot_kernel_ragged_and_offset(cuda_device, K, offset, dtype,
                                          rel):
    """K = 1, 2 and 80 on 40,961 cells, which no tile size divides, with
    operands aligned or starting one element into their storage (the
    kernel then stages them with scalar loads)."""
    rng = np.random.default_rng(K)
    w = torch.from_numpy(rng.standard_normal((40961, 6, 6))).to(
        cuda_device, dtype)
    x = torch.from_numpy(rng.standard_normal((40961, 6, K))).to(
        cuda_device, dtype)
    if offset:
        w, x = offset_view(w), offset_view(x)
    kernels.reset_launch_counts()
    got = tinydot(w, x)
    assert kernels.launch_counts["tinydot"] == 1
    assert_close([got], [tinydot_plain(w, x)], rel)


def k3_args(device, dtype, n, nz, ntr, masked, seed=0, max_level=None):
    """K3's seeded arguments on the card: field, h, kappa, mask (or None)
    and, for a 2-D field, the boundary row."""
    a = vmix.example_args(n, nz, ntr, seed)
    if max_level is not None:
        a["mask"] = (np.arange(nz)[None, :]
                     < max_level[:, None]).astype(np.float64)
    a = {k: torch.from_numpy(v).to(device, dtype) for k, v in a.items()}
    if not masked:
        a["mask"] = None
    if ntr:
        a["boundary"] = None
    return a


def run_k3(a, drag):
    kernels.reset_launch_counts()
    got = vmix_solve(a["field"], a["h"], a["kappa"], 900.0, a["mask"], drag,
                     a["boundary"])
    assert kernels.launch_counts["vmix_solve"] == 1
    want = vmix_solve_plain(a["field"], a["h"], a["kappa"], 900.0, a["mask"],
                            drag, a["boundary"])
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("n,nz,ntr,masked,drag", K3_CASES)
@pytest.mark.parametrize("dtype,rel", F64_F32_K3)
def test_vmix_kernel_matches_plain(cuda_device, n, nz, ntr, masked, drag,
                                   dtype, rel):
    got, want = run_k3(k3_args(cuda_device, dtype, n, nz, ntr, masked), drag)
    assert_close([got], [want], rel)


@pytest.mark.cuda
@pytest.mark.parametrize("nz", [2, 3, 37, 100])
@pytest.mark.parametrize("n", [1, 33, 1001])
@pytest.mark.parametrize("ntr,drag", [(0, 1e-3), (12, 0.0)])
@pytest.mark.parametrize("dtype,rel", F64_F32_K3)
def test_vmix_kernel_edge_columns(cuda_device, nz, n, ntr, drag, dtype, rel):
    """Every maxLevel from 0 (a dead column: x = d) and 1 (one live
    level) to nz, column counts that no tile divides, 2 to 100 levels;
    dead levels return their right-hand side exactly."""
    max_level = np.arange(n) % (nz + 1)
    a = k3_args(cuda_device, dtype, n, nz, ntr, True, seed=nz,
                max_level=max_level)
    got, want = run_k3(a, drag)
    assert_close([got], [want], rel)
    rhs = a["field"] if ntr else a["field"] * (1.0 - a["boundary"])[:, None]
    dead = a["mask"] == 0
    if ntr:
        dead = dead[..., None].expand_as(rhs)
    assert torch.equal(got[dead], rhs[dead])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["acoustic_cell_update", "tinydot",
                                  "vmix_solve"])
@pytest.mark.parametrize("fault", ["smem", "threads"])
def test_launchers_refuse_a_plan_that_is_not_their_layout(cuda_device, name,
                                                          fault):
    """The C entry points hold the host's plan to the kernel's own tile
    layout: shared memory other than the kernel's bytes for that tile, or
    more threads than its launch bounds, return cudaErrorInvalidValue (1)
    and launch nothing."""
    lib = load_library().lib
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    if name == "acoustic_cell_update":
        cols, threads, smem = acoustic.plan(26, 4)
        a = {k: torch.from_numpy(v).to(cuda_device, torch.float32)
             for k, v in example_args(33, 26).items()}
        outs = [torch.zeros_like(a["rw_p0"]), torch.zeros_like(a["rs_pre"]),
                torch.zeros_like(a["rs_pre"]), torch.zeros_like(a["rw_p0"])]
        ins = (ctypes.c_void_p * 20)(*[a[n].data_ptr()
                                       for n in acoustic._ORDER])
        ptr_out = (ctypes.c_void_p * 4)(*[o.data_ptr() for o in outs])

        def call(threads, smem):
            return lib.mpas_acoustic_cell_update_f32(
                cuda_device.index, 33, 26, cols, threads, smem, 0.1,
                120.0, ins, ptr_out, stream)
    elif name == "tinydot":
        cols, threads, smem = k2.plan(6, 6, 52, 4)
        w = torch.ones(33, 6, 6, device=cuda_device)
        x = torch.ones(33, 6, 52, device=cuda_device)
        outs = [torch.zeros(33, 6, 52, device=cuda_device)]

        def call(threads, smem):
            return lib.mpas_tinydot_f32(
                cuda_device.index, 33, 6, 6, 52, cols, threads, smem,
                w.data_ptr(), x.data_ptr(), outs[0].data_ptr(), stream)
    else:
        cols, threads, smem = vmix.plan(60, 12, 4)
        a = k3_args(cuda_device, torch.float32, 33, 60, 12, True)
        outs = [torch.zeros_like(a["field"])]

        def call(threads, smem):
            return lib.mpas_vmix_solve_f32(
                cuda_device.index, 33, 60, 12, cols, threads, smem, 900.0,
                0.0, a["field"].data_ptr(), a["h"].data_ptr(),
                a["kappa"].data_ptr(), a["mask"].data_ptr(), None,
                outs[0].data_ptr(), stream)
    bad = call(512, smem) if fault == "threads" else call(threads, smem + 16)
    torch.cuda.synchronize()
    assert bad == 1
    assert all(float(o.abs().max()) == 0.0 for o in outs)
    assert call(threads, smem) == 0
    torch.cuda.synchronize()
    assert float(outs[0].abs().max()) > 0.0


@pytest.mark.cuda
def test_wrappers_refuse_bad_cuda_input(cuda_device):
    w = torch.zeros(8, 6, 6, device=cuda_device)
    x = torch.zeros(8, 6, 26, device=cuda_device)
    with pytest.raises(ValueError):
        tinydot(w, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        tinydot(w, x.double())
    with pytest.raises(TypeError):
        tinydot(w.half(), x.half())
    with pytest.raises(ValueError):     # I above the kernel's register row
        tinydot(torch.zeros(8, 6, 17, device=cuda_device),
                torch.zeros(8, 17, 26, device=cuda_device))
    a = {k: torch.from_numpy(v).to(cuda_device)
         for k, v in example_args(8, 1).items()}
    with pytest.raises(ValueError):     # nz < 2
        acoustic_cell_update(1, 0.1, 120.0, **a)
    a = k3_args(cuda_device, torch.float32, 8, 20, 3, True)
    f, h, kappa, mask = a["field"], a["h"], a["kappa"], a["mask"]
    with pytest.raises(ValueError):     # a CPU operand beside CUDA ones
        vmix_solve(f, h.cpu(), kappa, 900.0, mask)
    with pytest.raises(ValueError):     # a strided view
        vmix_solve(f, h, kappa.t().contiguous().t(), 900.0, mask)
    with pytest.raises(ValueError):
        vmix_solve(f.transpose(1, 2).contiguous().transpose(1, 2), h, kappa,
                   900.0, mask)
    with pytest.raises(ValueError):     # another dtype
        vmix_solve(f, h.double(), kappa, 900.0, mask)
    with pytest.raises(TypeError):
        vmix_solve(f.half(), h.half(), kappa.half(), 900.0, mask.half())
    with pytest.raises(ValueError):     # drag on more than one rhs
        vmix_solve(f, h, kappa, 900.0, mask, bottom_drag=1e-3)
    with pytest.raises(ValueError):     # kappa not at the inner interfaces
        vmix_solve(f, h, h, 900.0, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["tangential_cell_assembled",
                                "trisk_q_cell_assembled"])
def test_one_dimensional_trisk_goes_through_k2(cuda_device, op):
    """The shallow-water TRiSK operators of a 1-D edge field launch K2
    once (at K = 1 and K = 2) and agree with the CPU's plain path."""
    from mpas_tpu_torch.mesh.sphere import icosahedral_mesh
    from mpas_tpu_torch.ops import stencils

    mesh = icosahedral_mesh(8, lloyd_iters=1)
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(rng.standard_normal(mesh.nEdges))
            for _ in range(1 if op == "tangential_cell_assembled" else 2)]
    fn = getattr(stencils, op)
    want = fn(mesh, *args)
    kernels.reset_launch_counts()
    got = fn(mesh.to(cuda_device, torch.float64),
             *[x.to(cuda_device) for x in args])
    assert kernels.launch_counts["tinydot"] == 1
    assert got.shape == want.shape == (mesh.nEdges,)
    assert_close([got.cpu()], [want], 1e-12)


@pytest.mark.cuda
def test_ocean_split_step_launches_k2_as_the_config_implies(cuda_device):
    """One split_step of the small baroclinic channel on the card launches
    K2 exactly as often as its config implies (245 times: 240 in the
    barotropic subcycles), K3 twice (the vertical mix's velocity and
    tracer solves), no K1, and agrees with the CPU's plain path at
    1e-9 x max|CPU| (chip_smoke.py's bound for the card-vs-CPU runs)."""
    from mpas_tpu_torch.cores.ocean.core import (
        VMIX_SOLVE_LAUNCHES_PER_STEP, OcnConfig, split_step,
        tinydot_launches_per_split_step)
    from mpas_tpu_torch.cores.ocean.init_channel import (
        init_baroclinic_channel)
    from mpas_tpu_torch.mesh.planar import channel_hex_mesh

    grid, state = init_baroclinic_channel(channel_hex_mesh(8, 26, 10000.0),
                                          nz=10)
    cfg = OcnConfig(config_dt=300.0)
    want = split_step(grid, cfg, state, cfg.config_dt)
    kernels.reset_launch_counts()
    got = split_step(grid.to(cuda_device, torch.float64), cfg,
                     state.to(cuda_device, torch.float64), cfg.config_dt)
    assert kernels.launch_counts == {
        "acoustic_cell_update": 0,
        "tinydot": tinydot_launches_per_split_step(cfg),
        "vmix_solve": VMIX_SOLVE_LAUNCHES_PER_STEP}
    assert tinydot_launches_per_split_step(cfg) == 245
    assert VMIX_SOLVE_LAUNCHES_PER_STEP == 2
    for k in ("u", "layerThickness", "tracers", "ubtr"):
        assert_close([getattr(got, k).cpu()], [getattr(want, k)], 1e-9)


@pytest.mark.cuda
def test_mesoref_step_on_the_card_matches_the_cpu(cuda_device):
    """One coupled step of the 144-cell, 16-level supercell with WSM6 and
    the mesoscale_reference suite (physics_step, then srk3_step) on the
    card: 12 K1 and 30 K2 launches (none from the suite), and the state
    and physics state agree with the CPU's plain path at 1e-11 x max|CPU|
    (chip_smoke.py's bound for the suite's card-vs-CPU runs)."""
    import dataclasses

    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.hooks import run_steps_with_physics
    from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
    from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
    from mpas_tpu_torch.cores.atmosphere.physics.manager import (
        SCHEME_FIELDS, PhysicsConfig, init_physics_state, resolve_suite)
    from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
    from mpas_tpu_torch.mesh.planar import planar_hex_mesh
    from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs

    cfg = AtmConfig(config_dt=12.0, config_nvertlevels=16,
                    config_len_disp=2000.0, config_xnutr=0.0,
                    config_microp_scheme="mp_wsm6", config_monotonic=True)
    grid, state, diag = init_supercell(planar_hex_mesh(12, 12, 2000.0), cfg,
                                       case=5)
    sc = seeded_moisture(grid.mesh, state.scalars, 7)
    state = dataclasses.replace(state, scalars=torch.cat(
        [sc, torch.zeros_like(sc)], -1))
    pcfg = resolve_suite(PhysicsConfig(**{k: "suite"
                                          for k in SCHEME_FIELDS}))
    coeffs = torch.from_numpy(build_reconstruct_coeffs(grid.mesh))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        g = grid.to(dev, torch.float64)
        carry = init_carry(g, cfg, state.to(dev, torch.float64),
                           diag.to(dev, torch.float64), 12.0)
        phys = init_physics_state(144, 16, lsm_scheme="noah", device=dev)
        kernels.reset_launch_counts()      # after init_carry's one K2
        out[dev.type] = run_steps_with_physics(g, cfg, carry, phys,
                                               coeffs.to(dev), 12.0, 1,
                                               pcfg=pcfg)
    assert kernels.launch_counts == {"acoustic_cell_update": 12,
                                     "tinydot": 30, "vmix_solve": 0}
    (c_cpu, p_cpu), (c_gpu, p_gpu) = out["cpu"], out["cuda"]
    for k in ("u", "w", "theta_m", "rho_zz", "scalars"):
        assert_close([getattr(c_gpu.state, k).cpu()],
                     [getattr(c_cpu.state, k)], 1e-11)
    for k in ("tsk", "glw", "gsw", "rad_tend", "hpbl", "tslb", "smois"):
        assert_close([getattr(p_gpu, k).cpu()], [getattr(p_cpu, k)], 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("physics", ["convection_permitting", "kain_fritsch"])
def test_convperm_and_kf_steps_on_the_card_match_the_cpu(cuda_device,
                                                         physics):
    """One coupled step of the 144-cell, 16-level supercell on the card:
    Thompson with eight scalars under the convection_permitting suite
    (12 K1 + 36 K2 launches), or WSM6 under PhysicsConfig(), i.e.
    Kain-Fritsch (12 K1 + 30 K2); none from the physics. The state and the
    physics state agree with the CPU's plain path at 1e-11 x max|CPU|."""
    import dataclasses

    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.hooks import run_steps_with_physics
    from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
    from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
    from mpas_tpu_torch.cores.atmosphere.physics.manager import (
        SCHEME_FIELDS, PhysicsConfig, init_physics_state, resolve_suite)
    from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
    from mpas_tpu_torch.mesh.planar import planar_hex_mesh
    from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs

    convperm = physics == "convection_permitting"
    cfg = AtmConfig(config_dt=12.0, config_nvertlevels=16,
                    config_len_disp=2000.0, config_xnutr=0.0,
                    config_microp_scheme="mp_thompson" if convperm
                    else "mp_wsm6", config_monotonic=True)
    grid, state, diag = init_supercell(planar_hex_mesh(12, 12, 2000.0), cfg,
                                       case=5)
    sc = seeded_moisture(grid.mesh, state.scalars, 7)
    parts = [sc, torch.zeros_like(sc)]
    if convperm:
        parts.append(torch.full_like(sc[..., :2], 1e-2))
    state = dataclasses.replace(state, scalars=torch.cat(parts, -1))
    pcfg, init_kw = None, {}
    if convperm:
        pcfg = resolve_suite(PhysicsConfig(
            config_physics_suite=physics, **{k: "suite"
                                             for k in SCHEME_FIELDS}))
        init_kw = dict(lsm_scheme="noah", pbl_scheme="mynn")
    coeffs = torch.from_numpy(build_reconstruct_coeffs(grid.mesh))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        g = grid.to(dev, torch.float64)
        carry = init_carry(g, cfg, state.to(dev, torch.float64),
                           diag.to(dev, torch.float64), 12.0)
        phys = init_physics_state(144, 16, device=dev, **init_kw)
        kernels.reset_launch_counts()      # after init_carry's one K2
        out[dev.type] = run_steps_with_physics(g, cfg, carry, phys,
                                               coeffs.to(dev), 12.0, 1,
                                               pcfg=pcfg, gmt_hours=7.0)
    assert kernels.launch_counts == {"acoustic_cell_update": 12,
                                     "tinydot": 36 if convperm else 30,
                                     "vmix_solve": 0}
    (c_cpu, p_cpu), (c_gpu, p_gpu) = out["cpu"], out["cuda"]
    for k in ("u", "w", "theta_m", "rho_zz"):
        assert_close([getattr(c_gpu.state, k).cpu()],
                     [getattr(c_cpu.state, k)], 1e-11)
    sc_gpu, sc_cpu = c_gpu.state.scalars.cpu(), c_cpu.state.scalars
    assert_close([sc_gpu[..., :6]], [sc_cpu[..., :6]], 1e-11)
    if convperm:
        assert_close([sc_gpu[..., 6:]], [sc_cpu[..., 6:]], 1e-11)
    for f in dataclasses.fields(p_cpu):
        v = getattr(p_cpu, f.name)
        if v is not None and v.dim() > 0:
            assert_close([getattr(p_gpu, f.name).cpu()], [v], 1e-11)


@pytest.mark.cuda
def test_cam_step_on_the_card_matches_the_cpu(cuda_device):
    """One coupled step of the 144-cell, 16-level supercell with WSM6, the
    mesoscale_reference suite under CAM radiation and the supercell
    namelist's dissipation (2d_fixed, vertical eddy viscosities) on the
    card: 12 K1 + 30 K2 launches, none from the physics; the state and the
    physics state agree with the CPU's plain path at 1e-11 x max|CPU|."""
    import dataclasses

    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.hooks import run_steps_with_physics
    from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
    from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
    from mpas_tpu_torch.cores.atmosphere.physics.manager import (
        SCHEME_FIELDS, PhysicsConfig, init_physics_state, resolve_suite)
    from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
    from mpas_tpu_torch.mesh.planar import planar_hex_mesh
    from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs

    cfg = AtmConfig(config_dt=12.0, config_nvertlevels=16,
                    config_len_disp=2000.0, config_xnutr=0.0,
                    config_microp_scheme="mp_wsm6", config_monotonic=True,
                    config_horiz_mixing="2d_fixed",
                    config_h_mom_eddy_visc2=500.0,
                    config_h_theta_eddy_visc2=500.0,
                    config_v_mom_eddy_visc2=500.0,
                    config_v_theta_eddy_visc2=500.0,
                    config_h_mom_eddy_visc4=0.0,
                    config_h_theta_eddy_visc4=0.0)
    grid, state, diag = init_supercell(planar_hex_mesh(12, 12, 2000.0), cfg,
                                       case=5)
    sc = seeded_moisture(grid.mesh, state.scalars, 7)
    state = dataclasses.replace(state, scalars=torch.cat(
        [sc, torch.zeros_like(sc)], -1))
    pcfg = dataclasses.replace(
        resolve_suite(PhysicsConfig(**{k: "suite" for k in SCHEME_FIELDS})),
        config_radiation_scheme="cam")
    coeffs = torch.from_numpy(build_reconstruct_coeffs(grid.mesh))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        g = grid.to(dev, torch.float64)
        carry = init_carry(g, cfg, state.to(dev, torch.float64),
                           diag.to(dev, torch.float64), 12.0)
        phys = init_physics_state(144, 16, lsm_scheme="noah", device=dev)
        kernels.reset_launch_counts()      # after init_carry's one K2
        out[dev.type] = run_steps_with_physics(g, cfg, carry, phys,
                                               coeffs.to(dev), 12.0, 1,
                                               pcfg=pcfg, gmt_hours=7.0)
    assert kernels.launch_counts == {"acoustic_cell_update": 12,
                                     "tinydot": 30, "vmix_solve": 0}
    (c_cpu, p_cpu), (c_gpu, p_gpu) = out["cpu"], out["cuda"]
    for k in ("u", "w", "theta_m", "rho_zz", "scalars"):
        assert_close([getattr(c_gpu.state, k).cpu()],
                     [getattr(c_cpu.state, k)], 1e-11)
    for k in ("tsk", "glw", "gsw", "rad_tend", "hpbl", "tslb", "smois"):
        assert_close([getattr(p_gpu, k).cpu()], [getattr(p_cpu, k)], 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("core,argv", [
    ("sw", ["--dt", "600", "--duration", "1:00:00"]),
    ("atmosphere", ["--duration", "1:00:00"])])
def test_command_line_on_the_card_matches_the_cpu(cuda_device, tmp_path,
                                                  monkeypatch, core, argv):
    """python -m mpas_tpu_torch <core> --mesh icos:8 --x64 on the card
    (its default device) and with --cpu: the final outputs agree at
    1e-11 x max|CPU| per field, and only the card's run launches K1/K2."""
    from mpas_tpu_torch.__main__ import main
    from mpas_tpu_torch.io.netcdf import read_netcdf
    monkeypatch.setenv("MPAS_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    final = f"output.{core}.0000-01-01_01.00.00.nc"
    out, counts = {}, {}
    for where, extra in (("cuda", []), ("cpu", ["--cpu"])):
        kernels.reset_launch_counts()
        assert main([core, "--mesh", "icos:8", "--x64", "--run-dir",
                     str(tmp_path / where)] + argv + extra) == 0
        counts[where] = sum(kernels.launch_counts.values())
        out[where] = read_netcdf(str(tmp_path / where / final))[0]
    assert counts["cuda"] > 0 and counts["cpu"] == 0
    assert sorted(out["cuda"]) == sorted(out["cpu"])
    for k, ref in out["cpu"].items():
        if k != "xtime":
            scale = max(np.abs(ref).max(), 1e-300)
            assert np.abs(out["cuda"][k] - ref).max() <= 1e-11 * scale, k


def _first_guess(path, dlat=10.0):
    """A small global first guess (the analytic profiles of the reference
    package's real-data tests on 7 levels, 200 m cos(lat) terrain),
    written with the port's write_met_file."""
    from mpas_tpu_torch.cores.init_atmosphere import met_reader as mr
    ny, nx = int(180 / dlat) + 1, int(360 / dlat)
    la = np.radians(-90.0 + dlat * np.arange(ny))[:, None] * np.ones(nx)
    meta = dict(hdate="2020-01-01_00:00:00", xfcst=0.0, nx=nx, ny=ny,
                iproj=0, startlat=-90.0, startlon=0.0, deltalat=dlat,
                deltalon=dlat, earth_radius=6371.229,
                is_wind_grid_rel=False)
    fields = []
    for p in (100000.0, 85000.0, 70000.0, 50000.0, 30000.0, 20000.0,
              10000.0):
        lp = np.log(101325.0 / p)
        for name, slab in (
                ("TT", 288.0 - 55.0 * lp / np.log(10.1325)
                 + 10.0 * np.cos(la)),
                ("GHT", 287.0 * 250.0 / 9.81 * lp
                 * (1.0 + 0.01 * np.cos(la))),
                ("UU", 20.0 * np.sin(2.0 * la) ** 2 * p / 1e5),
                ("VV", np.zeros_like(la)), ("RH", 50.0 * p / 1e5
                                            + np.zeros_like(la))):
            fields.append(mr.MetField(field=name, units="-", desc=name,
                                      xlvl=p, slab=slab, **meta))
    for name, slab in (("PSFC", 101325.0 - 500.0 * np.cos(la)),
                       ("SKINTEMP", 288.0 + 12.0 * np.cos(la)),
                       ("SOILHGT", 200.0 * np.maximum(np.cos(la), 0.0))):
        fields.append(mr.MetField(field=name, units="-", desc=name,
                                  xlvl=200100.0, slab=slab, **meta))
    mr.write_met_file(str(path), fields)
    return mr.read_met_file(str(path))


@pytest.mark.cuda
def test_real_data_steps_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """init_real on the 642-cell sphere (10 levels): its tensors move to
    the card unchanged, and 3 steps there launch 12 K1 and 15 K2 a step
    and agree with the CPU's plain path at 1e-11 x max|CPU|; qv stays
    >= 0 on both."""
    import dataclasses

    from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
    from mpas_tpu_torch.cores.atmosphere.time_integration import (
        init_carry, run_steps)
    from mpas_tpu_torch.cores.init_atmosphere.real_case import init_real
    from mpas_tpu_torch.mesh.sphere import icosahedral_mesh

    cfg = AtmConfig(config_nvertlevels=10, config_dt=1200.0,
                    config_len_disp=960000.0)
    grid, state, diag, _ = init_real(icosahedral_mesh(8, lloyd_iters=2),
                                     cfg, _first_guess(tmp_path / "FILE"))
    g_card = grid.to(cuda_device, torch.float64)
    for obj, moved in ((grid, g_card), (grid.mesh, g_card.mesh),
                       (state, state.to(cuda_device, torch.float64))):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                w = getattr(moved, f.name)
                assert w.device.type == "cuda"
                assert torch.equal(w.cpu(), v.to(w.dtype)), f.name
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        g = grid.to(dev, torch.float64)
        carry = init_carry(g, cfg, state.to(dev, torch.float64),
                           diag.to(dev, torch.float64), cfg.config_dt)
        kernels.reset_launch_counts()      # after init_carry's one K2
        out[dev.type] = run_steps(g, cfg, carry, cfg.config_dt, 3)
        if dev.type == "cuda":
            assert kernels.launch_counts == {"acoustic_cell_update": 36,
                                             "tinydot": 45, "vmix_solve": 0}
    for k in ("u", "w", "theta_m", "rho_zz", "scalars"):
        assert_close([getattr(out["cuda"].state, k).cpu()],
                     [getattr(out["cpu"].state, k)], 1e-11)
    assert float(out["cuda"].state.scalars[..., 0].min()) >= 0.0


@pytest.mark.cuda
def test_regional_zones_and_iau_on_the_card_match_the_cpu(cuda_device):
    """The zone nudging and reset on cells and edges, the LBC time
    interpolation and the IAU tendencies on the card against the CPU at
    1e-11 x max|CPU|."""
    from mpas_tpu_torch.cores.atmosphere import boundaries as bdy
    from mpas_tpu_torch.cores.atmosphere import iau
    from mpas_tpu_torch.mesh.planar import box_hex_mesh

    mesh = box_hex_mesh(20, 20, 10000.0)
    masks = bdy.build_bdy_masks(mesh)
    rng = np.random.default_rng(0)
    nc, ne, nz = mesh.nCells, mesh.nEdges, 12
    x = {k: torch.from_numpy(rng.standard_normal(shape)) for k, shape in (
        ("cell", (nc, nz)), ("edge", (ne, nz)), ("drive_c", (nc, nz)),
        ("drive_e", (ne, nz)), ("rho", (nc, nz)), ("inc_c", (nc, nz)),
        ("inc_e", (ne, nz)))}
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        m = masks.to(dev, torch.float64)
        y = {k: v.to(dev) for k, v in x.items()}
        inc = iau.IAUIncrements(theta_incr=y["inc_c"], rho_incr=y["inc_c"],
                                u_incr=y["inc_e"], qv_incr=None)
        res = [bdy.relaxzone_tend(m, 60.0, y["cell"], y["drive_c"]),
               bdy.relaxzone_tend(m, 60.0, y["edge"], y["drive_e"], True),
               bdy.speczone_reset(m, y["cell"], y["drive_c"]),
               bdy.speczone_reset(m, y["edge"], y["drive_e"], True),
               bdy.lbc_interp({"a": y["cell"]}, {"a": y["drive_c"]}, 0.0,
                              3600.0, 900.0)["a"]]
        for el in (600.0, 30000.0):
            res += [t for t in iau.iau_tendencies(
                iau.IAUConfig("on"), inc, y["rho"].abs() + 0.5, el)
                if t is not None]
        out[dev.type] = res
    for g, r in zip(out["cuda"], out["cpu"]):
        assert g.device.type == "cuda"
        if float(r.abs().max()) == 0.0:
            assert float(g.abs().max()) == 0.0
        else:
            assert_close([g.cpu()], [r], 1e-11)


@pytest.mark.cuda
def test_command_line_from_a_grid_file_on_the_card(cuda_device, tmp_path,
                                                   monkeypatch):
    """python -m mpas_tpu_torch atmosphere --mesh file:<netCDF4 grid of
    icos:8> --x64 on the card and with --cpu agree at 1e-11 x max|CPU|."""
    from mpas_tpu_torch.__main__ import main
    from mpas_tpu_torch.cores.sw.hooks import parse_mesh_spec
    from mpas_tpu_torch.io.netcdf import read_netcdf
    from mpas_tpu_torch.mesh.gridfile import mesh_to_netcdf
    monkeypatch.setenv("MPAS_TPU_TORCH_CACHE", str(tmp_path / "cache"))
    grid_file = tmp_path / "x1.642.grid.nc"
    mesh_to_netcdf(parse_mesh_spec("icos:8"), str(grid_file), fmt="netcdf4")
    final = "output.atmosphere.0000-01-01_01.00.00.nc"
    out = {}
    for where, extra in (("cuda", []), ("cpu", ["--cpu"])):
        assert main(["atmosphere", "--mesh", f"file:{grid_file}", "--x64",
                     "--duration", "1:00:00", "--run-dir",
                     str(tmp_path / where)] + extra) == 0
        out[where] = read_netcdf(str(tmp_path / where / final))[0]
    for k, ref in out["cpu"].items():
        if k != "xtime":
            scale = max(np.abs(ref).max(), 1e-300)
            assert np.abs(out["cuda"][k] - ref).max() <= 1e-11 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("name,basis,steps,kw", [
    ("seaice_box_10km", None, 3, {}),
    ("seaice_box_10km_default", None, 3, {}),
    ("seaice_box_10km", "pwl", 1, {}),
    ("seaice_box_10km_default", None, 1,
     dict(config_revised_evp=True, config_dt=3600.0,
          config_elastic_subcycle_number=20))])
def test_seaice_steps_on_the_card_match_the_cpu(cuda_device, name, basis,
                                                steps, kw):
    """Both sea-ice paths on the 100-cell box in float64, 600-s steps with
    5 elastic subcycles (the PWL basis; the revised EVP at 3,600 s with
    20): the dynamics fields and each tracer's content (tracer x parent)
    on the card agree with the CPU at 1e-11 x max|CPU|."""
    from mpas_tpu_torch.cores.seaice.core import run_steps
    from mpas_tpu_torch.cores.seaice.state import make_grid
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    from mpas_tpu_torch.tools import seaice_box as sb
    mesh = box_hex_mesh(12, 12, 10000.0)
    cfg = sb.config(name, **{**dict(config_dt=600.0,
                                    config_elastic_subcycle_number=5), **kw})
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        grid, state, forcing, _ = sb.setup(name, mesh, cfg, torch.float64,
                                           dev)
        if basis is not None:
            grid = make_grid(mesh, variational=basis).to(dev, torch.float64)
        out[dev.type] = sb.held_fields(run_steps(grid, cfg, state,
                                                 forcing, steps))
    assert float(out["cpu"]["uVelocity"].abs().max()) > 1e-4
    for k, r in out["cpu"].items():
        assert out["cuda"][k].device.type == "cuda"
        assert_close([out["cuda"][k].cpu()], [r], 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("name,steps,kw", [
    ("landice_dome_4km", 3, {}),
    ("landice_dome_4km_fo", 2, dict(config_fo_picard_iters=3,
                                    config_fo_cg_iters=10))])
def test_landice_steps_on_the_card_match_the_cpu(cuda_device, name, steps,
                                                 kw):
    """Both land-ice paths (tools/landice_dome.py) on the small dome
    (box_hex_mesh(20, 20, 3 km), h0 500 m, r0 25 km) in float64: the
    state and global_stats after `steps` fe_steps on the card agree with
    the CPU at 1e-11 x max|CPU| (the FO solve at 3 Picard x 10 CG, where
    its CG does not amplify rounding past that: tests/test_torch_landice.py);
    on the FO path one hydrology step on each device from the CPU's ice
    state too (the hydrology amplifies its inputs' rounding: ROADMAP §3)."""
    from mpas_tpu_torch.cores.landice.core import fe_step
    from mpas_tpu_torch.cores.landice.hydro import sgh_step_full
    from mpas_tpu_torch.cores.landice.statistics import global_stats
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    from mpas_tpu_torch.tools import landice_dome as ld
    mesh = box_hex_mesh(20, 20, 3000.0)
    cfg = ld.config(name, **kw)
    dt = float(cfg.config_dt)
    runs, out = {}, {}
    for dev in (torch.device("cpu"), cuda_device):
        grid, state, hydro, _ = ld.setup(name, mesh, cfg, (500.0, 25000.0),
                                         torch.float64, dev)
        for _ in range(steps):
            state = fe_step(grid, cfg, state, dt)
        runs[dev.type] = (grid, hydro)
        out[dev.type] = {f: getattr(state, f) for f in (
            "thickness", "temperature", "normalVelocity", "calvingFlux")}
        out[dev.type].update({f"stats.{k}": v for k, v in global_stats(
            grid, cfg, state).items()})
        if dev.type == "cpu":
            ice = state
    if runs["cpu"][1] is not None:
        for where, (grid, hydro) in runs.items():
            dev = grid.bedTopography.device
            h = ice.thickness.to(dev)
            hydro = sgh_step_full(grid, cfg, hydro, h,
                                  ice.basalMeltRate.to(dev),
                                  ld.sliding_speed(h), dt,
                                  n_sub=ld.HYDRO_SUBSTEPS)
            out[where].update(waterPressure=hydro.waterPressure,
                              waterThickness=hydro.waterThickness,
                              channelArea=hydro.channelArea)
    for k, r in out["cpu"].items():
        assert out["cuda"][k].device.type == "cuda", k
        assert_close([out["cuda"][k].cpu()], [r], 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["seaice_box_10km",
                                  "seaice_box_10km_default"])
def test_sharded_seaice_on_the_card_matches_unsharded(cuda_device, name):
    """make_run_steps_seaice on 4 loopback shards of the 100-cell box on
    the card, float64, 3 steps of 600 s with 5 elastic subcycles: the
    gathered velocities and ice area and volume equal the unsharded run
    on the card at 1e-11 x max (not bit for bit on the variational path:
    its cuBLAS einsums round a row differently at another batch count)."""
    from mpas_tpu_torch.cores.seaice import distributed as sdist
    from mpas_tpu_torch.cores.seaice.core import run_steps
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    from mpas_tpu_torch.parallel.partition import sfc_partition
    from mpas_tpu_torch.parallel.runner import (device_mesh, gather_field,
                                                place)
    from mpas_tpu_torch.tools import seaice_box as sb
    f64 = torch.float64
    mesh = box_hex_mesh(12, 12, 10000.0)
    cfg = sb.config(name, config_dt=600.0, config_elastic_subcycle_number=5)
    host, state, forcing, _ = sb.setup(name, mesh, cfg, f64, "cpu")
    ref = run_steps(host.to(cuda_device, f64), cfg,
                    state.to(cuda_device, f64),
                    forcing.to(cuda_device, f64), 3)
    ssi = sdist.shard_seaice_grid(host, sfc_partition(mesh, 4))
    group = device_mesh(4, cuda_device)
    out = sdist.make_run_steps_seaice(ssi, cfg, group)(
        ssi.local(group, f64),
        place(sdist.shard_seaice_state(ssi, state), group, f64),
        place(sdist.shard_seaice_forcing(ssi, forcing), group, f64), 3)
    for f in ("uVelocity", "vVelocity", "iceAreaCategory",
              "iceVolumeCategory"):
        kind = "vertex" if f in ("uVelocity", "vVelocity") else "cell"
        got = gather_field(ssi.smesh, group.stack(getattr(out, f)), kind,
                           mesh.nVertices if kind == "vertex"
                           else mesh.nCells)
        assert_close([torch.from_numpy(got)], [getattr(ref, f).cpu()],
                     1e-11)


@pytest.mark.cuda
def test_timer_manager_on_the_card_waits_only_in_its_table(cuda_device,
                                                           monkeypatch):
    """framework/timers.py's TimerManager on the card: a timer around 20
    products of 2,048 x 2,048 matrices returns before the card finishes
    (nothing synchronises inside a timer), and the table, which
    synchronises once, gives that row device seconds of the work itself
    (over 20 x 17 GFLOP at at most the float32 peak, 67 TFLOP/s)."""
    from mpas_tpu_torch.framework.timers import TimerManager
    syncs = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (syncs.append(device),
                                             sync(device)))
    a = torch.randn(2048, 2048, device=cuda_device)
    sync(cuda_device)
    tm = TimerManager(cuda_device)
    with tm.timer("products"):
        for _ in range(20):
            b = a @ a
    del b
    assert not syncs
    row = tm.table().splitlines()[1].split()
    assert len(syncs) == 1
    assert row[:2] == ["products", "1"]
    assert float(row[-1]) >= 20 * 2 * 2048 ** 3 / 67e12
