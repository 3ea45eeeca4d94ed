"""Diagnostics manager: init/update/compute/reset lifecycle (port of
mpas_tpu/cores/atmosphere/diagnostics/manager.py).

ref: src/core_atmosphere/diagnostics/mpas_atm_diagnostics_manager.F -
each diagnostic registers hooks; compute runs when its fields are needed
by an output stream (here: on an interval, like the ocean analysis
driver). Includes the soundings writer
(ref: diagnostics/soundings.F - nearest-cell column extraction).

The diagnostics compute on the state's device; the history holds numpy
arrays on the host, one device-to-host copy per field, as the reference
keeps numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from mpas_tpu_torch.constants import cp, p0, rgas
from mpas_tpu_torch.containers import to_host
from mpas_tpu_torch.cores.atmosphere.diagnostics.convective import (
    compute_convective)
from mpas_tpu_torch.cores.atmosphere.diagnostics.isobaric import (
    compute_isobaric)
from mpas_tpu_torch.cores.atmosphere.diagnostics.pv import (
    ertel_pv, theta_on_pv_surface)
from mpas_tpu_torch.cores.atmosphere.physics.radar import (
    composite_reflectivity, refl_10cm)

NAMES = ("isobaric", "convective", "pv", "reflectivity")


@dataclasses.dataclass
class DiagnosticsManager:
    """members: {name: interval_seconds}; names from
    {isobaric, convective, pv, reflectivity}."""
    members: Dict[str, float]
    history: Dict[str, list] = dataclasses.field(default_factory=dict)
    _next_due: Dict[str, float] = dataclasses.field(default_factory=dict)

    def init(self):
        for name in self.members:
            if name not in NAMES:
                raise ValueError(f"unknown diagnostic '{name}'")
            self.history[name] = []
            self._next_due[name] = 0.0

    def _compute(self, name, grid, mesh, state, diag):
        if name == "isobaric":
            out = compute_isobaric(grid, state, diag)
        elif name == "convective":
            out = compute_convective(grid, state, diag)
        elif name == "reflectivity":
            # ref: module_mp_radar.F refl10cm fed by the WSM6/Thompson
            # hydrometeors (qr, qs, qg at scalar slots 2, 4, 5)
            ns = state.scalars.shape[-1]
            rho = grid.zz * state.rho_zz
            qr = torch.clamp(state.scalars[..., 2], min=0.0) if ns > 2 \
                else torch.zeros_like(rho)
            qs = torch.clamp(state.scalars[..., 4], min=0.0) if ns > 4 \
                else None
            qg = torch.clamp(state.scalars[..., 5], min=0.0) if ns > 5 \
                else None
            qv = torch.clamp(state.scalars[..., 0], min=0.0)
            t = state.theta_m / (1.0 + 1.608 * qv) * diag.exner
            dbz = refl_10cm(rho, qr, qs=qs, qg=qg, t=t)
            out = {"refl_10cm": dbz,
                   "refl_10cm_max": composite_reflectivity(dbz)}
        else:
            pv = ertel_pv(grid, mesh, state, diag)
            if state.scalars.shape[-1] > 0:
                qv = torch.clamp(state.scalars[..., 0], min=0.0)
                th = state.theta_m / (1.0 + 1.608 * qv)
            else:
                th = state.theta_m
            out = {"ertel_pv": pv, "theta_pv": theta_on_pv_surface(pv, th)}
        return {k: to_host(v) for k, v in out.items()}

    def compute_due(self, grid, mesh, state, diag, t_seconds: float):
        for name, interval in self.members.items():
            if t_seconds + 1e-9 >= self._next_due[name]:
                self.history[name].append(
                    (t_seconds, self._compute(name, grid, mesh, state,
                                              diag)))
                while self._next_due[name] <= t_seconds + 1e-9:
                    self._next_due[name] += interval

    def compute_all(self, grid, mesh, state, diag, t_seconds: float = 0.0):
        for name in self.members:
            self.history[name].append(
                (t_seconds, self._compute(name, grid, mesh, state, diag)))


def sounding(grid, mesh, state, diag, lat_lon_or_xy, on_sphere=None):
    """Extract the nearest-cell column as a sounding dict
    (ref: diagnostics/soundings.F)."""
    on_sphere = mesh.on_sphere if on_sphere is None else on_sphere
    if on_sphere:
        la, lo = lat_lon_or_xy
        d = (to_host(mesh.latCell) - la) ** 2 \
            + (to_host(mesh.lonCell) - lo) ** 2
    else:
        x, y = lat_lon_or_xy
        d = (to_host(mesh.xCell) - x) ** 2 + (to_host(mesh.yCell) - y) ** 2
    i = int(np.argmin(d))
    qv = np.maximum(to_host(state.scalars[i, :, 0]), 0.0) \
        if state.scalars.shape[-1] > 0 else np.zeros(state.theta_m.shape[1])
    th = to_host(state.theta_m[i]) / (1.0 + 1.608 * qv)
    ex = to_host(diag.exner[i])
    zg = to_host(grid.zgrid[i])
    return {
        "cell": i,
        "pressure_hpa": float(p0) / 100.0 * ex ** (cp / rgas),
        "temperature_c": th * ex - 273.15,
        "qv": qv,
        "height_m": 0.5 * (zg[1:] + zg[:-1]),
    }
