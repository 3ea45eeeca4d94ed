# Frozen copy of mpas_tpu_torch/cores/ocean/ztilde.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""z-tilde ALE vertical coordinate: frequency-filtered thickness (port of
mpas_tpu/cores/ocean/ztilde.py).

ref: mpas_ocn_thick_ale.F (ocn_ALE_thickness: the z-star part, the
highFreqThickness contribution and the min/max thickness filter) and
mpas_ocn_tendency.F ocn_tend_freq_filtered_thickness (the Leclair & Madec
2011 z-tilde prognostics):

  d(lfd)/dt = -2*pi/tau_filter * (lfd - div_hu + div_hu_btr*h/H)
  d(hhf)/dt = -div_hu + div_hu_btr*h/H + lfd - 2*pi/tau_restore * hhf
              + del2 smoothing

lfd = lowFreqDivergence, hhf = highFreqThickness.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_2PI = 6.283185307179586


def hhf_del2(mesh, hhf, coeff):
    """Laplacian smoothing of highFreqThickness (ref:
    ocn_high_freq_thickness_hmix_del2_tend)."""
    c1, c2 = mesh.cellsOnEdge[:, 0], mesh.cellsOnEdge[:, 1]
    grad = (hhf[c2] - hhf[c1]) / mesh.dcEdge[:, None] \
        * (1.0 - mesh.boundaryEdge)[:, None]
    flux = mesh.dvEdge[:, None] * grad
    return coeff * (-mesh.edgeSignOnCell[..., None]
                    * flux[mesh.edgesOnCell]).sum(1) \
        * mesh.invAreaCell[:, None]


def freq_filtered_tends(grid, cfg, div_hu, h, lfd, hhf):
    """(tend_lfd, tend_hhf) per ocn_tend_freq_filtered_thickness
    (mpas_ocn_tendency.F:908+). div_hu: (nCells, nz) layer thickness-flux
    divergence (positive = divergent); h: layer thickness."""
    tau_f = cfg.config_thickness_filter_timescale * 86400.0
    tau_r = cfg.config_highFreqThick_restore_time * 86400.0
    mask = grid.cellMask if grid.cellMask is not None else torch.ones_like(h)
    h_live = h * mask
    total_h = h_live.sum(-1, keepdim=True)
    div_btr = (div_hu * mask).sum(-1, keepdim=True)
    # barotropic part of the divergence, distributed by thickness
    div_btr_k = div_btr * h_live / torch.clamp(total_h, min=1e-14)
    tend_lfd = -_2PI / tau_f * (lfd - div_hu + div_btr_k)
    tend_hhf = -div_hu + div_btr_k + lfd
    if cfg.config_use_highFreqThick_restore:
        tend_hhf = tend_hhf - _2PI / tau_r * hhf
    if cfg.config_highFreqThick_del2 > 0.0:
        tend_hhf = tend_hhf + hhf_del2(grid.mesh, hhf,
                                       cfg.config_highFreqThick_del2)
    return tend_lfd * mask, tend_hhf * mask


def ale_tends_ztilde(grid, div_hu, tend_hhf):
    """z-star + z-tilde thickness tendency and the consistent vertical
    transport (ref: ocn_ALE_thickness with newHighFreqThickness +
    ocn_vert_transport_velocity_top): dh/dt = -(resting-weighted) total
    divergence + d(hhf)/dt; continuity then gives w_top."""
    total_div = div_hu.sum(-1, keepdim=True)
    resting = grid.restingThickness
    if grid.cellMask is not None:
        resting = resting * grid.cellMask
    wgt = resting / resting.sum(-1, keepdim=True)
    tend_h = -wgt * total_div + tend_hhf
    resid = -div_hu - tend_h
    w_rev = torch.flip(torch.cumsum(torch.flip(resid, [-1]), -1), [-1])
    return tend_h, F.pad(w_rev, (0, 1))


def min_max_thickness_filter(grid, cfg, h):
    """The reference's two-sweep min/max thickness enforcement
    (mpas_ocn_thick_ale.F:186-214): go down the column clamping each layer
    into [min_thickness, max_factor*resting] and pushing the correction
    remainder to the next layer; then go back up with the leftover; any
    final remainder lands in the top layer. Column volume is conserved.
    One Python step per level, vectorized over columns."""
    resting = grid.restingThickness
    hmax = cfg.config_max_thickness_factor * resting
    hmin = cfg.config_min_thickness
    mask = grid.cellMask if grid.cellMask is not None else torch.ones_like(h)
    nz = h.shape[-1]

    def clamp_level(rem, k, h_in):
        """Clamp level k of h_in with the carried remainder; dead levels
        are untouched. Returns (new remainder, new level)."""
        hk = h_in[:, k]
        new = torch.minimum(torch.clamp(hk + rem, min=hmin),
                            torch.clamp(hmax[:, k], min=hmin))
        new = torch.where(mask[:, k] > 0, new, hk)
        return rem - (new - hk), new

    rem = torch.zeros_like(h[:, 0])
    down = [None] * nz
    for k in range(nz):                              # surface -> bottom
        rem, down[k] = clamp_level(rem, k, h)
    h_dn = torch.stack(down, dim=-1)
    up = [None] * nz
    for k in reversed(range(nz)):                    # bottom -> surface,
        rem, up[k] = clamp_level(rem, k, h_dn)       # carrying the leftover
    # any final remainder goes to the top live layer (ref :214)
    up[0] = up[0] + torch.where(mask[:, 0] > 0, rem, 0.0)
    return torch.stack(up, dim=-1)
