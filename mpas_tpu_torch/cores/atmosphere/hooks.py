"""Atmosphere core hooks for the run driver, and the coupled
physics-dynamics loop (port of mpas_tpu/cores/atmosphere/hooks.py; ref:
atm_setup_core, mpas_atm_core_interface.F, and atm_do_timestep,
mpas_atm_core.F:830-873: the physics suite runs before the dynamics at
every step).

config_init_case picks the start: 1-3 the JW baroclinic wave, 4 the
squall line, 5 the supercell, 6 the mountain wave. With
config_physics_suite other than "none" every step runs PhysicsConfig()
(Kain-Fritsch, YSU, the MM5 surface layer, the slab LSM and broadband
radiation) before the dynamics, as the reference's hook does.
"""

from __future__ import annotations

import dataclasses

import torch

from mpas_tpu_torch.containers import to_host
from mpas_tpu_torch.cores.atmosphere import time_integration
from mpas_tpu_torch.cores.atmosphere.config import AtmConfig
from mpas_tpu_torch.cores.atmosphere.physics import manager
from mpas_tpu_torch.cores.atmosphere.state import AtmDiag, AtmState
from mpas_tpu_torch.cores.sw.hooks import parse_mesh_spec
from mpas_tpu_torch.framework.driver import CoreHooks
from mpas_tpu_torch.ops.reconstruct import (build_reconstruct_coeffs,
                                             reconstruct)


def run_steps_with_physics(grid, cfg, carry, phys, recon, dt, n, pcfg=None,
                           gmt_hours=12.0):
    """Advance `n` timesteps, each physics_step then srk3_step. pcfg: the
    PhysicsConfig; None runs PhysicsConfig() as the reference's hook does
    (Kain-Fritsch, YSU, the MM5 surface layer, the slab LSM and broadband
    radiation; pass resolve_suite(...) of a suite to run that suite, and
    give phys the Noah soil or the MYNN qke the suite needs); recon: the
    reconstruction coefficients as a tensor on the carry's device;
    gmt_hours: the hour of the solar geometry physics_step sees (the
    reference's default is noon; the day is physics_step's default).
    Returns (carry, phys)."""
    pcfg = manager.PhysicsConfig() if pcfg is None else pcfg
    for _ in range(n):
        th, sc, u, phys = manager.physics_step(
            grid, pcfg, grid.mesh, recon, carry.state, carry.diag, phys, dt,
            gmt_hours=gmt_hours)
        carry = dataclasses.replace(carry, state=dataclasses.replace(
            carry.state, theta_m=th, scalars=sc, u=u))
        carry = time_integration.srk3_step(grid, cfg, carry, dt)
    return carry, phys


@dataclasses.dataclass
class _AtmRun:
    grid: object
    cfg: AtmConfig
    carry: time_integration.AtmCarry
    recon: object
    phys: object = None        # PhysicsState when the suite is active


def _setup(cfg: AtmConfig, mesh_spec: str, device, dtype):
    mesh0 = parse_mesh_spec(mesh_spec)
    if cfg.config_init_case in (4, 5):
        from mpas_tpu_torch.cores.atmosphere.init_supercell import (
            init_supercell)
        grid, state, diag = init_supercell(mesh0, cfg,
                                           case=cfg.config_init_case)
    elif cfg.config_init_case == 6:
        from mpas_tpu_torch.cores.atmosphere.init_mtn_wave import (
            init_mtn_wave)
        grid, state, diag = init_mtn_wave(mesh0, cfg)
    else:
        from mpas_tpu_torch.cores.atmosphere.init_jw import init_jw
        grid, state, diag = init_jw(mesh0, cfg, case=cfg.config_init_case)
    recon = torch.from_numpy(build_reconstruct_coeffs(grid.mesh))
    grid = grid.to(device, dtype)
    carry = time_integration.init_carry(grid, cfg, state.to(device, dtype),
                                        diag.to(device, dtype),
                                        cfg.config_dt)
    phys = None
    if cfg.config_physics_suite != "none":
        phys = manager.init_physics_state(grid.mesh.nCells,
                                          cfg.config_nvertlevels,
                                          dtype=dtype, device=device)
    return _AtmRun(grid=grid, cfg=cfg, carry=carry,
                   recon=recon.to(device, dtype), phys=phys)


def _step_chunk(run: _AtmRun, n: int):
    dt = run.cfg.config_dt
    if run.phys is None:
        run.carry = time_integration.run_steps(run.grid, run.cfg, run.carry,
                                               dt, n)
    else:
        run.carry, run.phys = run_steps_with_physics(
            run.grid, run.cfg, run.carry, run.phys, run.recon, dt, n)
    return run


def _fields(run: _AtmRun, restart: bool):
    g = run.grid
    s = run.carry.state
    d = run.carry.diag
    cn, cnp1 = ("nCells", "nVertLevels"), ("nCells", "nVertLevelsP1")
    out = {
        "u": (("nEdges", "nVertLevels"), to_host(s.u)),
        "w": (cnp1, to_host(s.w)),
        "theta_m": (cn, to_host(s.theta_m)),
        "rho_zz": (cn, to_host(s.rho_zz)),
        "scalars": (("nCells", "nVertLevels", "nScalars"), to_host(s.scalars)),
    }
    if restart:
        out.update({
            "ru": (("nEdges", "nVertLevels"), to_host(d.ru)),
            "rw": (cnp1, to_host(d.rw)),
            "rho_p": (cn, to_host(d.rho_p)),
            "rtheta_p": (cn, to_host(d.rtheta_p)),
            "exner": (cn, to_host(d.exner)),
            "pressure_p": (cn, to_host(d.pressure_p)),
        })
    else:
        _, _, _, zon, mer = reconstruct(g.mesh, run.recon, s.u)
        out["uReconstructZonal"] = (cn, to_host(zon))
        out["uReconstructMeridional"] = (cn, to_host(mer))
        out["surface_pressure"] = (("nCells",), to_host(
            d.pressure_p[:, 0] + g.pressure_base[:, 0]))
        out["rainnc"] = (("nCells",), to_host(run.carry.rainnc))
    nz = run.cfg.config_nvertlevels
    dims = {"nCells": g.mesh.nCells, "nEdges": g.mesh.nEdges,
            "nVertLevels": nz, "nVertLevelsP1": nz + 1,
            "nScalars": s.scalars.shape[-1]}
    return out, dims


def _resume(run: _AtmRun, data: dict):
    like = run.carry.state.u

    def t(name):
        return torch.as_tensor(data[name]).to(like.device, like.dtype)

    st = AtmState(**{k: t(k) for k in ("u", "w", "theta_m", "rho_zz",
                                       "scalars")})
    dg = AtmDiag(**{k: t(k) for k in ("ru", "rw", "rho_p", "rtheta_p",
                                      "exner", "pressure_p")},
                 ruAvg=torch.zeros_like(t("ru")),
                 wwAvg=torch.zeros_like(t("rw")))
    run.carry = time_integration.init_carry(run.grid, run.cfg, st, dg,
                                            run.cfg.config_dt)
    return run


def _summarize(run: _AtmRun) -> str:
    """ref: summarize_timestep (mpas_atm_time_integration.F:6675) — global
    w extremes + accumulated precip extremes, logged per chunk; one host
    read."""
    w = run.carry.state.w
    wmin, wmax, rain = torch.stack(
        [w.min(), w.max(), run.carry.rainnc.max().to(w.dtype)]).tolist()
    return (f"w[min,max]=[{wmin:+.3f},{wmax:+.3f}] m/s "
            f"rainnc_max={rain * 1000.0:.2f} mm")


HOOKS = CoreHooks(name="atmosphere", config_cls=AtmConfig, setup=_setup,
                  step_chunk=_step_chunk,
                  output_fields=lambda r: _fields(r, False),
                  restart_fields=lambda r: _fields(r, True),
                  resume=_resume, summarize=_summarize)


def default_mesh(cfg: AtmConfig) -> str:
    if cfg.config_init_case in (4, 5):
        return "hex:40,40,2000"
    return "icos:16"
