"""Shallow-water prognostic state and diagnostic bundle (port of
mpas_tpu/cores/sw/state.py).

Prognostics mirror the reference `state` var_struct (ref: src/core_sw/
Registry.xml:245-269): u (nEdges,), h (nCells,) and tracers (nCells,
nTracers), one vertical level, tracer axis minor. Time levels are implicit
in the functional step (old state in, new state out).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from mpas_tpu_torch.containers import to_device


@dataclasses.dataclass(frozen=True)
class SWState:
    u: Any          # normal velocity at edges
    h: Any          # fluid thickness at cells
    tracers: Any    # (nCells, nTracers), h-decoupled (mixing ratios)

    def to(self, device, dtype) -> "SWState":
        return to_device(self, device, dtype)


@dataclasses.dataclass(frozen=True)
class SWDiagnostics:
    """Fields of solve_diagnostics (ref: the diagnostic members of the
    `state` struct, Registry.xml)."""
    v: Any
    h_edge: Any
    h_vertex: Any
    circulation: Any
    vorticity: Any
    divergence: Any
    ke: Any
    pv_vertex: Any
    pv_edge: Any
    pv_cell: Any
    vorticity_cell: Any
    gradPVn: Any
    gradPVt: Any

    def to(self, device, dtype) -> "SWDiagnostics":
        return to_device(self, device, dtype)
