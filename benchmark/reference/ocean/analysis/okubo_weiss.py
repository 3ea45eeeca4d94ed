# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/okubo_weiss.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Okubo-Weiss analysis member (port of
mpas_tpu/cores/ocean/analysis/okubo_weiss.py).

ref: src/core_ocean/analysis_members/mpas_ocn_okubo_weiss.F (+ the C
eigenvalue kernel mpas_ocn_okubo_weiss_eigenvalues.c:233): the OW
parameter W = S_n^2 + S_s^2 - omega^2 at cell centres, for eddy
detection, and the closed-form eigenvalues of the velocity-gradient
tensor. The shear comes from the TRiSK tangential field, whose
contraction goes through kernel K2.
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.stencils import (tangential_cell_assembled,
                                         vertex_to_cell_kite)


class OkuboWeiss:
    def init(self, grid, cfg):
        pass

    def compute(self, grid, cfg, state):
        m = grid.mesh
        u = state.u
        div = (m.divW[..., None] * u[m.edgesOnCell]).sum(1) \
            * m.invAreaCell[:, None]
        vort_v = (m.curlW[..., None] * u[m.edgesOnVertex]).sum(1) \
            * m.invAreaTriangle[:, None]
        vort = vertex_to_cell_kite(m, vort_v)
        tang = tangential_cell_assembled(m, u)
        shear_v = (m.curlW[..., None] * tang[m.edgesOnVertex]).sum(1) \
            * m.invAreaTriangle[:, None]
        shear = vertex_to_cell_kite(m, shear_v)
        ow = div * div + shear * shear - vort * vort
        disc = torch.where(ow >= 0, ow.abs().sqrt(), 0.0)
        return {"okuboWeiss": ow, "eigenvalue1": 0.5 * (div + disc),
                "eigenvalue2": 0.5 * (div - disc), "vorticity": vort}
