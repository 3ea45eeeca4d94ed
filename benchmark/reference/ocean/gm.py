# Frozen copy of mpas_tpu_torch/cores/ocean/gm.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Gent-McWilliams eddy transport + Redi isoneutral mixing (port of
mpas_tpu/cores/ocean/gm.py).

ref: src/core_ocean/shared/mpas_ocn_gm.F (ocn_gm_compute_Bolus_velocity)
and the Redi terms of mpas_ocn_tracer_hmix_Redi.F (small-slope
approximation):
  * slope S at edge interfaces = -grad_n(rho) / drho/dz, clipped to
    config_max_relative_slope;
  * 'constant' closure: streamfunction Psi = kappa_GM * S at interior
    interfaces, zero at the top and bottom;
  * bolus normal velocity per layer: u* = -(Psi_top - Psi_bot) / h_edge;
  * Redi: the vertical enhancement kappa_Redi * S^2 is added to the
    implicit vertical tracer diffusivity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.ocean.vmix import edge_mean_on_cell


def isoneutral_slope(grid, cfg, rho, h):
    """Slope at edge interior interfaces (nEdges, nz-1), clipped."""
    m = grid.mesh
    c1, c2 = m.cellsOnEdge[:, 0], m.cellsOnEdge[:, 1]
    not_bnd = (1.0 - m.boundaryEdge)[:, None]

    # horizontal density gradient at edge layer midpoints
    drho_n = (rho[c2] - rho[c1]) * m.invDcEdge[:, None] * not_bnd
    drho_n_int = 0.5 * (drho_n[:, :-1] + drho_n[:, 1:])   # (nE, nz-1)

    # vertical density gradient at cell interfaces -> edge interfaces;
    # stable stratification has rho[k] - rho[k+1] < 0, tiny values guarded
    h_mid = 0.5 * (h[:, :-1] + h[:, 1:])
    drho_dz_c = (rho[:, :-1] - rho[:, 1:]) / torch.clamp(h_mid, min=1e-3)
    drho_dz_e = 0.5 * (drho_dz_c[c1] + drho_dz_c[c2])
    dmin = 1e-8
    drho_dz_e = torch.where(drho_dz_e.abs() < dmin, -dmin,
                            torch.clamp(drho_dz_e, max=-dmin))

    s = -drho_n_int / drho_dz_e
    smax = cfg.config_max_relative_slope
    return torch.clamp(s, -smax, smax) * not_bnd


def bolus_velocity(grid, cfg, rho, h):
    """GM bolus normal velocity (nEdges, nz) from the constant closure.
    ref: ocn_gm_compute_Bolus_velocity (mpas_ocn_gm.F)."""
    m = grid.mesh
    s = isoneutral_slope(grid, cfg, rho, h)            # (nE, nz-1)
    psi = cfg.config_gm_constant_kappa * s             # interior interfaces
    psi_full = F.pad(psi, (1, 1))                      # (nE, nz+1)
    c1, c2 = m.cellsOnEdge[:, 0], m.cellsOnEdge[:, 1]
    h_edge = torch.clamp(0.5 * (h[c1] + h[c2]), min=1e-3)
    u_bolus = -(psi_full[:, :-1] - psi_full[:, 1:]) / h_edge
    return u_bolus * (1.0 - m.boundaryEdge)[:, None]


def redi_vertical_enhancement(grid, cfg, rho, h):
    """kappa_Redi * S^2 at cell interior interfaces (nCells, nz-1), added
    to the implicit vertical tracer diffusivity (ref: the 3,3 component of
    the small-slope Redi tensor)."""
    s = isoneutral_slope(grid, cfg, rho, h)            # (nE, nz-1)
    return cfg.config_redi_kappa * edge_mean_on_cell(grid.mesh, s * s)
