"""Where supercell_2km_mesoref's Noah skin temperature leaves a physical
range at noon, and whether starting it from the air changes that.

    python -m mpas_tpu_torch.tools.mesoref_noon              # full size
    python -m mpas_tpu_torch.tools.mesoref_noon --device cpu --n 12 --nz 16 \\
        --dtype float64 --steps 6                          # small, CPU

Builds chip_smoke.py's supercell_2km_mesoref (planar_hex_mesh(n, n, 2 km),
nz levels, dt 12 s, WSM6 with six species from seeded_moisture seed 7, the
resolved mesoscale_reference suite, a Noah physics state) and runs it
through run_steps_with_physics at its default solar time, noon, twice: from
init_physics_state's uniform 288 K surface, and with tsk, t_deep and the
four soil layers set to each cell's lowest-level air temperature. After
every step it prints the range of tsk and max |u|; after each run, one JSON
line with the first step (1-based) at which tsk leaves [200, 350] K and at
which each of tsk, u, w, theta_m and the scalars holds a non-finite value
(null: never in the run).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from mpas_tpu_torch.constants import rvord
from mpas_tpu_torch.containers import resolve_device
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.hooks import run_steps_with_physics
from mpas_tpu_torch.cores.atmosphere.init_supercell import init_supercell
from mpas_tpu_torch.cores.atmosphere.moisture import seeded_moisture
from mpas_tpu_torch.cores.atmosphere.physics.manager import (
    SCHEME_FIELDS, PhysicsConfig, init_physics_state, resolve_suite)
from mpas_tpu_torch.cores.atmosphere.time_integration import init_carry
from mpas_tpu_torch.mesh.planar import planar_hex_mesh
from mpas_tpu_torch.ops.reconstruct import build_reconstruct_coeffs

FIELDS = ("tsk", "u", "w", "theta_m", "scalars")
TSK_RANGE = (200.0, 350.0)


def air_start(carry, phys):
    """phys with tsk, t_deep and the soil layers at each cell's
    lowest-level air temperature."""
    st = carry.state
    t1 = (st.theta_m[:, 0] / (1.0 + rvord * st.scalars[:, 0, 0])
          * carry.diag.exner[:, 0])
    return dataclasses.replace(phys, tsk=t1, t_deep=t1.clone(),
                               tslb=t1[:, None].repeat(1, 4))


def run(n=96, nz=40, steps=30, device=None, dtype=torch.float32):
    """Both starts at noon; returns one summary dict per start."""
    device = resolve_device(device)
    cfg = AtmConfig(config_dt=12.0, config_nvertlevels=nz,
                    config_len_disp=2000.0, config_xnutr=0.0,
                    config_microp_scheme="mp_wsm6", config_monotonic=True)
    grid, state, diag = init_supercell(planar_hex_mesh(n, n, 2000.0), cfg,
                                       case=5)
    sc = seeded_moisture(grid.mesh, state.scalars, seed=7)
    state = dataclasses.replace(state, scalars=torch.cat(
        [sc, torch.zeros_like(sc)], dim=-1))
    coeffs = torch.from_numpy(build_reconstruct_coeffs(grid.mesh)).to(
        device, dtype)
    pcfg = resolve_suite(PhysicsConfig(
        config_physics_suite="mesoscale_reference",
        **{k: "suite" for k in SCHEME_FIELDS}))
    grid, state, diag = (grid.to(device, dtype), state.to(device, dtype),
                         diag.to(device, dtype))
    dt, nc = cfg.config_dt, grid.mesh.nCells
    out = []
    for start in ("288 K", "lowest level"):
        carry = init_carry(grid, cfg, state, diag, dt)
        phys = init_physics_state(nc, nz, dtype=dtype, lsm_scheme="noah",
                                  device=device)
        if start == "lowest level":
            phys = air_start(carry, phys)
        print(f"start {start}: tsk {float(phys.tsk.min()):.3f} "
              f"to {float(phys.tsk.max()):.3f} K")
        first = dict.fromkeys(FIELDS)
        first_out = None
        for k in range(1, steps + 1):
            carry, phys = run_steps_with_physics(grid, cfg, carry, phys,
                                                 coeffs, dt, 1, pcfg=pcfg)
            vals = dict(tsk=phys.tsk, **{f: getattr(carry.state, f)
                                         for f in FIELDS[1:]})
            for f, v in vals.items():
                if first[f] is None and not bool(torch.isfinite(v).all()):
                    first[f] = k
            lo, hi = float(phys.tsk.min()), float(phys.tsk.max())
            if first_out is None and not (TSK_RANGE[0] <= lo
                                          and hi <= TSK_RANGE[1]):
                first_out = k
            print(f"  step {k}: tsk {lo:.3f} to {hi:.3f} K, max |u| "
                  f"{float(carry.state.u.abs().max()):.4f} m/s")
        res = dict(start=start, cells=nc, levels=nz,
                   steps=steps, dtype=str(dtype).removeprefix("torch."),
                   first_tsk_out_of_range=first_out, first_nonfinite=first)
        print(json.dumps(res))
        out.append(res)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=96, help="cells per side")
    ap.add_argument("--nz", type=int, default=40)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None, help="default cuda:0")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    a = ap.parse_args()
    run(a.n, a.nz, a.steps, a.device, getattr(torch, a.dtype))


if __name__ == "__main__":
    main()
