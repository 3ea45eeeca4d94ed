"""YSU nonlocal boundary-layer scheme (port of
mpas_tpu/cores/atmosphere/physics/ysu.py).

ref: src/core_atmosphere/physics/mpas_atmphys_driver_pbl.F +
physics_wrf/module_bl_ysu.F (Hong, Noh & Dudhia 2006): bulk-Richardson PBL
height, K-profile eddy diffusivity K = k ws z (1 - z/h)^2, countergradient
heat transport, implicit vertical diffusion. u, v, theta and qv share the
diffusion matrix, so they go through one batched Thomas solve.
"""

from __future__ import annotations

import torch

from mpas_tpu_torch.constants import cp, gravity
from mpas_tpu_torch.ops.matrix import tridiagonal_solve

_KARMAN = 0.4
_RICR = 0.25        # critical bulk Richardson (ref ysu: 0.25 over land)
_PFAC = 2.0
_BFAC = 6.8         # countergradient coefficient b (ref: module_bl_ysu)


def pbl_height(z, thv, spd2, hfx_v, ust, thv_sfc):
    """Bulk-Richardson PBL height (first level where Rib >= Ricr),
    linearly interpolated. z, thv, spd2: (nCells, nz); surface values
    (nCells,). ref: module_bl_ysu.F hpbl diagnosis."""
    rib = gravity * z * (thv - thv_sfc[:, None]) \
        / (thv_sfc[:, None] * torch.clamp(spd2, min=0.01))
    above = rib >= _RICR
    nz = z.shape[1]
    # CUDA's argmax takes no bool; both libraries give the first maximum
    k_top = torch.argmax(above.long(), dim=1)
    k_top = torch.where(torch.any(above, dim=1) & (k_top > 0), k_top,
                        nz - 1)
    kb = torch.clamp(k_top - 1, min=0)[:, None]
    k_top = k_top[:, None]
    r1, r2 = torch.gather(rib, 1, kb), torch.gather(rib, 1, k_top)
    z1, z2 = torch.gather(z, 1, kb), torch.gather(z, 1, k_top)
    frac = torch.clamp((_RICR - r1) / torch.where(torch.abs(r2 - r1) > 1e-9,
                                                  r2 - r1, 1e-9), 0.0, 1.0)
    h = (z1 + frac * (z2 - z1))[:, 0]
    return torch.maximum(h, z[:, 0] * 1.5)


def ysu(u, v, th, qv, rho, z_mid, dz, sfc, dt):
    """One PBL step. All (nCells, nz) with level 0 the lowest; `sfc` is
    the sfclay output dict. Returns the updated (u, v, th, qv) and hpbl."""
    thv = th * (1.0 + 0.61 * qv)
    spd2 = u * u + v * v
    thv_sfc = thv[:, 0] + 2.0 * torch.clamp(
        sfc["hfx"], min=0.0) / (rho[:, 0] * cp) / torch.clamp(sfc["ust"],
                                                              min=0.05)
    h = pbl_height(z_mid, thv, spd2, sfc["hfx"], sfc["ust"], thv_sfc)

    # convective velocity scale and mixed-layer velocity ws
    wstar3 = torch.clamp(gravity / thv[:, 0] * sfc["hfx"]
                         / (rho[:, 0] * cp) * h, min=0.0)
    ws = (sfc["ust"] ** 3 + 0.6 * wstar3) ** (1.0 / 3.0)

    # K profile at the interfaces between layers (nCells, nz-1)
    z_int = 0.5 * (z_mid[:, :-1] + z_mid[:, 1:])
    zh = torch.clamp(z_int / h[:, None], 0.0, 1.0)
    k_prof = _KARMAN * ws[:, None] * z_int * (1.0 - zh) ** _PFAC
    # free-atmosphere background above the PBL
    kz = torch.where(zh < 1.0, torch.clamp(k_prof, min=0.1), 1.0)

    # countergradient term for theta (ref: gamah = b * hfx/(rho cp ws h))
    gamma_h = _BFAC * sfc["hfx"] / (rho[:, 0] * cp) \
        / torch.clamp(ws * h, min=1e-3)
    gamma_h = torch.where(sfc["hfx"] > 0.0, gamma_h, 0.0)

    # implicit vertical diffusion with a surface-flux bottom condition:
    # one matrix for the four fields
    dz_int = 0.5 * (dz[:, :-1] + dz[:, 1:])
    g = dt * kz / dz_int
    zero = torch.zeros_like(th[:, :1])
    a = -torch.cat([zero, g], dim=1) / dz
    c = -torch.cat([g, zero], dim=1) / dz
    b = 1.0 - a - c

    def rhs(f, sflux):
        return torch.cat([f[:, :1] + (dt * sflux / dz[:, 0])[:, None],
                          f[:, 1:]], dim=1)

    # explicit countergradient flux divergence of theta
    fcg = kz * gamma_h[:, None] * (zh < 1.0)
    div = torch.cat([fcg, zero], dim=1) - torch.cat([zero, fcg], dim=1)
    # momentum: surface stress = -cd |U| u
    spd1 = torch.sqrt(torch.clamp(spd2[:, 0], min=1e-4))
    d = torch.stack([
        rhs(th, sfc["hfx"] / (rho[:, 0] * cp)) - dt * div / dz,
        rhs(qv, sfc["qfx"] / rho[:, 0]),
        rhs(u, -sfc["cd"] * spd1 * u[:, 0]),
        rhs(v, -sfc["cd"] * spd1 * v[:, 0])])
    th_new, qv_new, u_new, v_new = tridiagonal_solve(a, b, c, d)
    return u_new, v_new, th_new, torch.clamp(qv_new, min=0.0), h
