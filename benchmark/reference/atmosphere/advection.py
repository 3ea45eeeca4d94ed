# Frozen copy of mpas_tpu_torch/cores/atmosphere/advection.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Cell-assembled high-order advective edge values (port of
mpas_tpu/cores/atmosphere/advection.py).

The Skamarock-Gassmann (2011) 3rd/4th-order edge value (ref:
mpas_atm_time_integration.F:5020-5035, :3300-3330) is evaluated in its
exact factored form (setup.build_adv_factored):

  F_m[c]  = d2_bmat[c, m, 0]*psi[c] + sum_i d2_bmat[c, m, 1+i]*psi[coc[c,i]]
  D2_s[e] = sum_m d2w[e, s, m] * F_m[cellsOnEdge[e, s]]
  value   = 0.5*dvEdge*(psi[c1]+psi[c2]) + D2_1 + D2_2
            + sign(uh) * beta * (D2_1 - D2_2)
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.plain import tinydot


def cell_second_derivatives(grid, psi):
    """Quadratic-fit (fxx, fxy, fyy) at cells of a (nC, K) field -> (nC, 3, K).
    Padded cellsOnCell slots carry zero weight in d2_bmat."""
    g = psi[grid.mesh.cellsOnCell]                         # (nC, mE, K)
    F = tinydot(grid.d2_bmat[:, :, 1:].contiguous(), g)
    return F + grid.d2_bmat[:, :, 0, None] * psi[:, None, :]


def edge_value_parts(grid, psi):
    """(base, third) of the high-order edge value of a cell field psi
    (nC, ...); combine as base + sign(uh)*third. Both include dvEdge."""
    mesh = grid.mesh
    trailing = psi.shape[1:]
    p = psi.reshape(psi.shape[0], -1)                      # (nC, K)
    F = cell_second_derivatives(grid, p)                   # (nC, 3, K)
    cat = torch.cat([p[:, None, :], F], dim=1)             # (nC, 4, K)
    g1 = cat[mesh.cellsOnEdge[:, 0]]                       # (nE, 4, K)
    g2 = cat[mesh.cellsOnEdge[:, 1]]
    d21 = torch.einsum("em,emk->ek", grid.d2w[:, 0], g1[:, 1:])
    d22 = torch.einsum("em,emk->ek", grid.d2w[:, 1], g2[:, 1:])
    base = 0.5 * mesh.dvEdge[:, None] * (g1[:, 0] + g2[:, 0]) + d21 + d22
    third = grid.adv_beta * (d21 - d22)
    nE = base.shape[0]
    return base.reshape((nE,) + trailing), third.reshape((nE,) + trailing)


def advective_tendencies_cell(grid, fields):
    """Cell-assembled horizontal advective tendencies of fields consumed
    only as flux divergences (theta and w in dyn_tend; ref loops
    :5020-5035, :5199-5214, sums :5185, :5321). Seen from cell c, edge
    slot p's two sides are c and cellsOnCell[c, p], so no edge flux is
    materialized.

    fields: list of (psi (nC, Ki), ru (nE, Ki)). Returns, per field,
    -sum_p edgeSign*dv*ru*value of shape (nC, Ki); the caller divides by
    areaCell."""
    mesh = grid.mesh
    ks = [p.shape[1] for p, _ in fields]
    psi = torch.cat([p for p, _ in fields], dim=1)          # (nC, SK)
    ru = torch.cat([r for _, r in fields], dim=1)           # (nE, SK)
    cocT = mesh.cellsOnCell.T                               # (mE, nC)
    g = psi[cocT]                                           # (mE, nC, SK)
    B = grid.d2_bmat                                        # (nC, 3, mE+1)
    F = torch.einsum("cmi,ick->mck", B[:, :, 1:], g) \
        + B[:, :, 0].T[:, :, None] * psi                    # (3, nC, SK)
    d2own = torch.einsum("csm,mck->sck", grid.d2w_own, F)   # (mE, nC, SK)
    d2opp = torch.einsum("csm,msck->sck", grid.d2w_opp, F[:, cocT])
    ru_s = ru[mesh.edgesOnCell.T]                           # (mE, nC, SK)
    upw = (grid.adv_beta * grid.adv_sside).T[:, :, None]
    val = 0.5 * (psi + g) + d2own + d2opp \
        + torch.sign(ru_s) * upw * (d2own - d2opp)
    wdiv = (mesh.edgeSignOnCell * grid.dv_cell).T[:, :, None]
    tend = -(wdiv * ru_s * val).sum(0)                      # (nC, SK)
    return list(torch.split(tend, ks, dim=1))
