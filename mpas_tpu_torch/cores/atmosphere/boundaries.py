"""Regional (limited-area) boundary machinery: specified + relaxation
zones (port of mpas_tpu/cores/atmosphere/boundaries.py).

ref: src/core_atmosphere/dynamics/mpas_atm_boundaries.F (zone constants
nSpecZone=2, nRelaxZone=5, nBdyZone=7; mask setup :421-520; LBC time
interpolation mpas_atm_get_bdy_state/:239 tend) and the zone tendency
adjustments in mpas_atm_time_integration.F
(atm_bdy_adjust_dynamics_relaxzone_tend :6200-6391 — Rayleigh nudging with
coef (zone-1)/nRelaxZone/(50 dt); atm_bdy_reset_speczone_values :6394 —
hard reset in the specified zone).

The masks are built once on the host in numpy, by hop distance from the
limited-area boundary, into a BdyMasks of CPU tensors (.to(device,
dtype) moves it); the zone adjustments are masked elementwise torch ops
on the caller's device. Like the reference, the time integration calls
none of these: each is an entry point of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mpas_tpu_torch.containers import to_device
from mpas_tpu_torch.mesh.mesh import Mesh

# ref: mpas_atm_boundaries.F zone constants
N_SPEC_ZONE = 2
N_RELAX_ZONE = 5
N_BDY_ZONE = N_SPEC_ZONE + N_RELAX_ZONE


@dataclasses.dataclass(frozen=True)
class BdyMasks:
    bdyMaskCell: Any    # (nCells,) int: 0 interior; 1..5 relax; 6..7 spec
    bdyMaskEdge: Any    # (nEdges,)
    specCell: Any       # (nCells,) 1.0 where zone > nRelaxZone
    specEdge: Any       # (nEdges,)
    relaxCoefCell: Any  # (nCells,) (zone-1)/nRelaxZone in relax zone else 0
    relaxCoefEdge: Any  # (nEdges,)

    def to(self, device, dtype) -> "BdyMasks":
        return to_device(self, device, dtype)


def build_bdy_masks(mesh: Mesh) -> BdyMasks:
    """Zone index by hop distance from the open (boundary) edge of the
    limited-area mesh: hop 1 -> zone N_BDY_ZONE (outermost, specified),
    hop N_BDY_ZONE -> zone 1 (innermost relax ring), deeper -> 0.
    ref: mask setup, mpas_atm_boundaries.F:421-520."""
    nC = mesh.nCells
    coc = np.asarray(mesh.cellsOnCell)
    sgn = np.asarray(mesh.edgeSignOnCell)
    be = np.asarray(mesh.boundaryEdge) > 0
    coe = np.asarray(mesh.cellsOnEdge)

    hop = np.full(nC, 10 ** 6, dtype=np.int64)
    frontier = np.unique(coe[be].ravel())
    hop[frontier] = 1
    for h in range(2, N_BDY_ZONE + 1):
        prev = hop == h - 1
        neigh = coc[prev][sgn[prev] != 0]
        mask = hop[neigh] > h
        hop[neigh[mask]] = h
    zone = np.where(hop <= N_BDY_ZONE, N_BDY_ZONE - hop + 1, 0)

    zone_edge = np.maximum(zone[coe[:, 0]], zone[coe[:, 1]])
    zone_edge = np.where(be, N_BDY_ZONE, zone_edge)

    def coefs(z):
        relax = ((z >= 1) & (z <= N_RELAX_ZONE)).astype(np.float64)
        return relax * np.maximum(z - 1, 0) / N_RELAX_ZONE

    t = torch.from_numpy
    return BdyMasks(
        bdyMaskCell=t(zone.astype(np.int64)),
        bdyMaskEdge=t(zone_edge.astype(np.int64)),
        specCell=t((zone > N_RELAX_ZONE).astype(np.float64)),
        specEdge=t((zone_edge > N_RELAX_ZONE).astype(np.float64)),
        relaxCoefCell=t(coefs(zone)),
        relaxCoefEdge=t(coefs(zone_edge)))


def lbc_interp(lbc_t1, lbc_t2, t1_s: float, t2_s: float, now_s):
    """Linear time interpolation between two LBC states: tensors, or
    dataclasses / dicts / lists / tuples of tensors of the same layout
    (None and non-tensor leaves are taken from lbc_t1).
    ref: mpas_atm_get_bdy_state (mpas_atm_boundaries.F:308)."""
    w = min(max((float(now_s) - t1_s) / max(t2_s - t1_s, 1e-9), 0.0), 1.0)

    def mix(a, b):
        if isinstance(a, torch.Tensor):
            return (1.0 - w) * a + w * b
        if dataclasses.is_dataclass(a):
            return dataclasses.replace(a, **{
                f.name: mix(getattr(a, f.name), getattr(b, f.name))
                for f in dataclasses.fields(a)})
        if isinstance(a, dict):
            return {k: mix(a[k], b[k]) for k in a}
        if isinstance(a, (list, tuple)):
            return type(a)(mix(x, y) for x, y in zip(a, b))
        return a

    return mix(lbc_t1, lbc_t2)


def relaxzone_tend(masks: BdyMasks, dt, field, driving, on_edges=False):
    """Rayleigh nudging tendency toward the LBC driving value.
    ref: atm_bdy_adjust_dynamics_relaxzone_tend
    (mpas_atm_time_integration.F:6275-6283):
      tend -= (zone-1)/nRelaxZone/(50 dt) * (field - driving)."""
    coef = masks.relaxCoefEdge if on_edges else masks.relaxCoefCell
    shape = (-1,) + (1,) * (field.ndim - 1)
    return -coef.reshape(shape) / (50.0 * dt) * (field - driving)


def speczone_reset(masks: BdyMasks, field, driving, on_edges=False):
    """Hard reset in the specified zone (ref: atm_bdy_reset_speczone_values
    :6394; also the speczone tend handling :714)."""
    spec = masks.specEdge if on_edges else masks.specCell
    shape = (-1,) + (1,) * (field.ndim - 1)
    s = spec.reshape(shape)
    return field * (1.0 - s) + driving * s
