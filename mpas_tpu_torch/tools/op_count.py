"""Count the torch operations of the physics on the supercell, of a
sea-ice step and of a land-ice step.

    python -m mpas_tpu_torch.tools.op_count [--n 12] [--nz 40] [--device cpu]

For kf_eta, for one physics_step under each suite (PhysicsConfig(),
mesoscale_reference, convection_permitting, and mesoscale_reference with
CAM radiation), and for cam_lw and cam_sw alone on the inputs that
physics_step gives them, on the n x n, nz-level supercell in float64
(six species, the seeded cloud): the number of aten calls that
torch.profiler
records, less the view and shape calls (which launch nothing). Each
counted call launches about one kernel on a card, so a count taken on the
CPU predicts a card's kernels a step before a card run; it is a count,
not a device number. It does not depend on n. For cam_lw and cam_sw it
also reckons the bytes a call moves per cell (count_bytes), which scales
with the cells. For the two sea-ice paths of tools/seaice_box.py on the
100-cell box (float64): one seaice_timestep, its velocity solve (and the
calls one elastic subcycle adds), its transport and its column physics.
For the two land-ice paths of tools/landice_dome.py on a small dome
(box_hex_mesh(20, 20, 3 km), h0 500 m, r0 25 km, float64): one step of
each and its parts, and on the FO path the calls one CG iteration and
one Picard pass add. The device defaults to cuda:0.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from mpas_tpu_torch.constants import cp, p0, rgas, rvord
from mpas_tpu_torch.containers import resolve_device
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
from mpas_tpu_torch.cores.atmosphere.physics import (cam_radiation, kfeta,
                                                     manager)
from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
from mpas_tpu_torch.mesh.planar import planar_hex_mesh
from mpas_tpu_torch.ops import reconstruct as recon

# aten calls that only view, reshape or query: no kernel
NO_KERNEL = frozenset(
    "aten::" + k for k in (
        "view", "reshape", "expand", "select", "slice", "unsqueeze",
        "squeeze", "as_strided", "t", "transpose", "permute", "detach",
        "alias", "_unsafe_view", "expand_as", "empty", "empty_like",
        "resize_", "lift_fresh", "empty_strided", "result_type", "item",
        "_local_scalar_dense", "is_nonzero", "contiguous", "unbind",
        "split", "narrow", "diff"))


def count_ops(fn) -> int:
    """aten calls of one call of fn that launch a kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::") and e.key not in NO_KERNEL)


def count_bytes(fn) -> float:
    """Bytes that one call of fn reads and writes, in float32 terms: over
    the outermost aten calls that launch a kernel, the elements of every
    tensor input, plus the output's: the inputs' broadcast shape, or the
    largest input where they do not broadcast (a reduction, a cat), at 4
    bytes each. A reckoning from shapes, not a device number: it ignores
    caches and counts a broadcast input at its own size."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
    total = 0
    for e in prof.events():
        parent = e.cpu_parent
        if (not e.name.startswith("aten::") or e.name in NO_KERNEL
                or (parent is not None and parent.name.startswith("aten::"))):
            continue
        shapes = [tuple(shape) for shape in e.input_shapes
                  if isinstance(shape, (list, tuple)) and shape
                  and all(isinstance(d, int) for d in shape)]
        if not shapes:
            continue
        try:
            out = math.prod(torch.broadcast_shapes(*shapes))
        except RuntimeError:
            out = max(math.prod(shape) for shape in shapes)
        total += sum(math.prod(shape) for shape in shapes) + out
    return 4.0 * total


def kf_eta_inputs(grid, state, diag, coeffs):
    """(args, kwargs) of kf_eta as physics_step derives them from the
    dycore state: th, qv, p, rho, z_mid, dz, exner, then w0avg (w at the
    layer midpoints), the cell winds and the cell's equivalent diameter.
    physics_step hands kf_eta th, qv and winds after radiation and the
    PBL; here they are the state's own."""
    m = grid.mesh
    qv = torch.clamp(state.scalars[..., 0], min=0.0)
    exner = diag.exner
    zg = grid.zgrid
    _vx, _vy, _vz, u_c, v_c = recon.reconstruct(m, coeffs, state.u)
    args = (state.theta_m / (1.0 + rvord * qv), qv,
            p0 * exner ** (cp / rgas), grid.zz * state.rho_zz,
            0.5 * (zg[:, 1:] + zg[:, :-1]) - zg[:, :1], zg[:, 1:] - zg[:, :-1],
            exner)
    kwargs = dict(w0avg=0.5 * (state.w[:, 1:] + state.w[:, :-1]),
                  u=u_c, v=v_c, dx=2.0 * torch.sqrt(m.areaCell / math.pi))
    return args, kwargs


def suites():
    """(name, PhysicsConfig, init_physics_state kwargs) of each suite."""
    def resolved(suite):
        return manager.resolve_suite(manager.PhysicsConfig(
            config_physics_suite=suite,
            **{k: "suite" for k in manager.SCHEME_FIELDS}))
    mesoref = resolved("mesoscale_reference")
    return (("PhysicsConfig() (Kain-Fritsch)", manager.PhysicsConfig(), {}),
            ("mesoscale_reference", mesoref, dict(lsm_scheme="noah")),
            ("convection_permitting", resolved("convection_permitting"),
             dict(lsm_scheme="noah", pbl_scheme="mynn")),
            ("mesoscale_reference + CAM",
             dataclasses.replace(mesoref, config_radiation_scheme="cam"),
             dict(lsm_scheme="noah")))


def recorded_calls(module, names, fn):
    """Run fn() with the functions `names` of `module` recording their
    (args, kwargs); returns {name: (args, kwargs)} of their last call."""
    calls, saved = {}, {n: getattr(module, n) for n in names}

    def recorder(name, f):
        def call(*a, **k):
            calls[name] = (a, k)
            return f(*a, **k)
        return call
    try:
        for n, f in saved.items():
            setattr(module, n, recorder(n, f))
        fn()
    finally:
        for n, f in saved.items():
            setattr(module, n, f)
    return calls


def run(n=12, nz=40, device=None):
    """{label: op count} on the n x n, nz-level supercell (six species)."""
    device, dtype = resolve_device(device), torch.float64
    cfg = AtmConfig(config_dt=12.0, config_nvertlevels=nz,
                    config_len_disp=2000.0, config_xnutr=0.0,
                    config_microp_scheme="mp_wsm6", config_monotonic=True)
    grid, state, diag = init_supercell(planar_hex_mesh(n, n, 2000.0), cfg,
                                       case=5)
    sc = seeded_moisture(grid.mesh, state.scalars, seed=7)
    state = dataclasses.replace(state, scalars=torch.cat(
        [sc, torch.zeros_like(sc)], dim=-1))
    coeffs = torch.from_numpy(recon.build_reconstruct_coeffs(grid.mesh)).to(
        device, dtype)
    grid, state, diag = (grid.to(device, dtype), state.to(device, dtype),
                         diag.to(device, dtype))
    carry = init_carry(grid, cfg, state, diag, cfg.config_dt)
    args, kwargs = kf_eta_inputs(grid, carry.state, carry.diag, coeffs)
    out = {"kf_eta": count_ops(
        lambda: kfeta.kf_eta(*args, cfg.config_dt, **kwargs))}
    nc = grid.mesh.nCells
    for label, pcfg, init_kw in suites():
        phys = manager.init_physics_state(nc, nz, dtype=dtype, device=device,
                                          **init_kw)

        def step():
            manager.physics_step(grid, pcfg, grid.mesh, coeffs, carry.state,
                                 carry.diag, phys, cfg.config_dt)
        out[f"physics_step {label}"] = count_ops(step)
        if pcfg.config_radiation_scheme == "cam":
            cam_calls = recorded_calls(cam_radiation, ("cam_lw", "cam_sw"),
                                       step)
    for name, (a, k) in cam_calls.items():
        out[name] = count_ops(
            lambda: getattr(cam_radiation, name)(*a, **k))
        out[f"{name} MB per cell in float32"] = count_bytes(
            lambda: getattr(cam_radiation, name)(*a, **k)) / nc / 1e6
    return out


def seaice_run(device=None):
    """{label: op count} of a step of each sea-ice path and its parts, on
    box_hex_mesh(12, 12, 10 km)."""
    from mpas_tpu_torch.cores.seaice import core
    from mpas_tpu_torch.cores.seaice.column import column_physics_step
    from mpas_tpu_torch.cores.seaice.velocity import solve_velocities
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    from mpas_tpu_torch.tools import seaice_box
    device = resolve_device(device)
    mesh = box_hex_mesh(12, 12, 10000.0)
    out = {}
    for name in seaice_box.PATHS:
        cfg = seaice_box.config(name)
        grid, state, forcing, _ = seaice_box.setup(name, mesh, cfg,
                                                   torch.float64, device)
        dt = float(cfg.config_dt)
        advect = core.advect_upwind if cfg.config_advection_type == "upwind" \
            else core.advect_incremental_remap
        out[f"{name} seaice_timestep"] = count_ops(
            lambda: core.seaice_timestep(grid, cfg, state, forcing, dt))
        out[f"{name} solve_velocities"] = count_ops(
            lambda: solve_velocities(grid, cfg, state, forcing, dt))
        one, two = (count_ops(lambda: solve_velocities(
            grid, dataclasses.replace(cfg, config_elastic_subcycle_number=k),
            state, forcing, dt)) for k in (1, 2))
        out[f"{name} one elastic subcycle"] = two - one
        out[f"{name} transport"] = count_ops(
            lambda: advect(grid, cfg, state, dt))
        out[f"{name} column_physics_step"] = count_ops(
            lambda: column_physics_step(cfg, state, forcing, dt))
    return out


def landice_run(device=None):
    """{label: op count} of a step of each land-ice path and its parts
    (the spans of landice_dome.PARTS), on box_hex_mesh(20, 20, 3 km)
    with a dome of h0 500 m, r0 25 km."""
    from mpas_tpu_torch.cores.landice.core import fo_velocity
    from mpas_tpu_torch.mesh.planar import box_hex_mesh
    from mpas_tpu_torch.tools import landice_dome
    device = resolve_device(device)
    mesh = box_hex_mesh(20, 20, 3000.0)
    out = {}
    for name in landice_dome.PATHS:
        cfg = landice_dome.config(name)
        grid, state, hydro, _ = landice_dome.setup(
            name, mesh, cfg, (500.0, 25000.0), torch.float64, device)
        out[f"{name} step"] = count_ops(
            lambda: landice_dome.step(grid, cfg, state, hydro))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            landice_dome.step(grid, cfg, state, hydro)
        for e in prof.events():
            part = e.cpu_parent
            while part is not None and part.name not in landice_dome.PARTS:
                part = part.cpu_parent
            if (part is not None and e.name.startswith("aten::")
                    and e.name not in NO_KERNEL):
                key = f"{name} {part.name}"
                out[key] = out.get(key, 0) + 1
        if cfg.config_velocity_solver == "FO":
            def velocity(picard, cg):
                c = dataclasses.replace(cfg, config_fo_picard_iters=picard,
                                        config_fo_cg_iters=cg)
                return count_ops(lambda: fo_velocity(
                    grid, c, state.thickness, state.temperature))
            v11, v12, v21 = velocity(1, 1), velocity(1, 2), velocity(2, 1)
            out[f"{name} one CG iteration"] = v12 - v11
            out[f"{name} one Picard pass with 1 CG iteration"] = v21 - v11
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=12)
    parser.add_argument("--nz", type=int, default=40)
    parser.add_argument("--device", default=None, help="default cuda:0")
    args = parser.parse_args()
    device = resolve_device(args.device)
    for label, k in run(args.n, args.nz, device).items():
        what = f"{k:.4f}" if "MB" in label else f"{k} aten calls"
        print(f"{label}: {what} ({args.n}x{args.n} cells, {args.nz} "
              f"levels, {device})")
    for label, k in seaice_run(device).items():
        print(f"{label}: {k} aten calls (100-cell box, {device})")
    for label, k in landice_run(device).items():
        print(f"{label}: {k} aten calls (324-cell dome, {device})")


if __name__ == "__main__":
    main()
