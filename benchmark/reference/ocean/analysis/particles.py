# Frozen copy of mpas_tpu_torch/cores/ocean/analysis/particles.py for the benchmark's reference:
# imports point into benchmark/reference, the kernels are plain (ops/plain.py).
"""Lagrangian particle tracking, LIGHT-style (port of
mpas_tpu/cores/ocean/analysis/particles.py).

ref: src/core_ocean/analysis_members/
mpas_ocn_lagrangian_particle_tracking.F:1-2808 (+ _interpolations.F,
_reset.F): LIGHT (Wolfram et al. 2015), particles carried by the resolved
flow, relocated by a local walk, stepped by RK2, with one vertical
treatment per tracker and sampling of fields along the trajectories.

Vectorised over particles, with no per-particle control flow and no host
read:
- position: planar (x, y) with the periodic wrap, or 3-D Cartesian on the
  sphere with tangent-plane steps;
- relocation: a fixed-iteration nearest-centre walk over cellsOnCell (on
  a centroidal Voronoi mesh the nearest centre is the containing polygon,
  ref :1580-1700); padded neighbour slots (edgeSignOnCell == 0) are
  masked before the argmin, the only use of their distances;
- velocity at the particle: inverse-distance weighting of the
  reconstructed cell-centre velocities over the cell and its neighbours;
- vertical treatments (ref :900-1100): indexLevel (a fixed layer),
  fixedZLevel (a fixed depth), passiveFloat (depth advected by the
  vertical velocity) and isopycnal (the layer nearest a target density).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from benchmark.reference.ops.reconstruct import (build_reconstruct_coeffs,
                                            reconstruct)


@dataclasses.dataclass(frozen=True)
class ParticleState:
    x: Any           # (nP,) planar x or 3-D Cartesian X on the sphere
    y: Any           # (nP,)
    z3: Any          # (nP,) sphere: 3rd Cartesian component (0 planar)
    cell: Any        # (nP,) int64 containing (nearest-centre) cell
    layer: Any       # (nP,) int64 vertical layer sampled
    depth: Any       # (nP,) metres below the surface (fixedZ / passive)
    target_rho: Any  # (nP,) isopycnal target density (0 if unused)


def _wrap(x, period):
    return x % period if period > 0.0 else x


def _deltas(mesh, cand, x, y, z3):
    """Displacements from each particle to its candidate cells' centres
    (periodic on a plane)."""
    dx = mesh.xCell[cand] - x[:, None]
    dy = mesh.yCell[cand] - y[:, None]
    if mesh.on_sphere:
        return dx, dy, mesh.zCell[cand] - z3[:, None]
    if mesh.x_period > 0:
        dx = (dx + 0.5 * mesh.x_period) % mesh.x_period \
            - 0.5 * mesh.x_period
    if mesh.y_period > 0:
        dy = (dy + 0.5 * mesh.y_period) % mesh.y_period \
            - 0.5 * mesh.y_period
    return dx, dy, torch.zeros_like(dx)


def _candidates(mesh, cell):
    """(cand, valid): the cell and its neighbours (nP, 1 + maxEdges), and
    which of them are real neighbours."""
    cand = torch.cat([cell[:, None], mesh.cellsOnCell[cell]], 1)
    valid = torch.cat([torch.ones_like(cell[:, None], dtype=torch.bool),
                       mesh.edgeSignOnCell[cell] != 0], 1)
    return cand, valid


def _walk(mesh, x, y, z3, cell, n_iter=2):
    """Fixed-iteration nearest-centre (Voronoi polygon) walk."""
    for _ in range(n_iter):
        cand, valid = _candidates(mesh, cell)
        dx, dy, dz = _deltas(mesh, cand, x, y, z3)
        d2 = torch.where(valid, dx * dx + dy * dy + dz * dz, torch.inf)
        cell = cand.gather(1, d2.argmin(1)[:, None])[:, 0]
    return cell


def _layer_from_depth(h_col, depth):
    """The layer of a thickness column (nP, nz) that contains `depth`."""
    zbot = torch.cumsum(h_col, 1)
    k = (depth[:, None] > zbot).sum(1)
    return torch.clamp(k, 0, h_col.shape[1] - 1)


class ParticleTracker:
    """ref lifecycle: particle init / integrate (RK2) / sample.

    vertical_mode: 'indexLevel' | 'fixedZLevel' | 'passiveFloat' |
    'isopycnal' (ref config_AM_lagrPartTrack_vertical_treatment). The
    particles live on the mesh's device and dtype. coeffs: the mesh's
    reconstruction weights (ops/reconstruct) where the caller has them,
    else built here. cell0: each particle's starting cell for the
    initial 60-iteration walk; cell 0 where None, as in the reference,
    which reaches only particles within 60 cells of it (ROADMAP §3)."""

    def __init__(self, mesh, x0, y0, layer=0, z0=None, depth=None,
                 vertical_mode="indexLevel", target_rho=None, coeffs=None,
                 cell0=None):
        self.mesh = mesh
        self.vertical_mode = vertical_mode
        dev, dtype = mesh.xCell.device, mesh.xCell.dtype

        def t(v):
            return torch.as_tensor(v).to(dev, dtype)

        self._coeffs = t(build_reconstruct_coeffs(mesh) if coeffs is None
                         else coeffs)
        nP = len(x0)
        if mesh.on_sphere and z0 is None:
            raise ValueError("sphere particles need z0 (3-D cartesian)")
        zeros = torch.zeros(nP, dtype=dtype, device=dev)
        x0, y0 = t(x0), t(y0)
        z3 = zeros if z0 is None else t(z0)
        start = torch.zeros(nP, dtype=torch.int64, device=dev) \
            if cell0 is None else torch.as_tensor(cell0).to(dev, torch.int64)
        self.state = ParticleState(
            x=x0, y=y0, z3=z3, cell=_walk(mesh, x0, y0, z3, start, 60),
            layer=torch.full((nP,), layer, dtype=torch.int64, device=dev),
            depth=zeros if depth is None else t(depth),
            target_rho=zeros if target_rho is None else t(target_rho))

    # -- interpolation -----------------------------------------------------
    def _idw(self, ps: ParticleState):
        cand, valid = _candidates(self.mesh, ps.cell)
        dx, dy, dz = _deltas(self.mesh, cand, ps.x, ps.y, ps.z3)
        w = torch.where(valid, 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz
                                                + 1.0), 0.0)
        return cand, w / w.sum(1, keepdim=True)

    def cell_velocity(self, u_edge):
        """The cell-centre (zonal, meridional) velocity of u_edge, each
        (nCells, nz): what step() samples at both RK2 stages."""
        _, _, _, uz, um = reconstruct(self.mesh, self._coeffs, u_edge)
        return uz, um

    def _velocity_at(self, uz, um, ps: ParticleState):
        """IDW of the cell-centre velocity at the particle's layer."""
        cand, w = self._idw(ps)
        layer = ps.layer[:, None]
        return (w * uz[cand, layer]).sum(1), (w * um[cand, layer]).sum(1)

    def _advance(self, ps: ParticleState, u, v, dt):
        m = self.mesh
        if not m.on_sphere:
            return dataclasses.replace(ps, x=_wrap(ps.x + dt * u,
                                                   m.x_period),
                                       y=_wrap(ps.y + dt * v, m.y_period))
        # tangent-plane step along the local east and north unit vectors
        r = torch.sqrt(ps.x ** 2 + ps.y ** 2 + ps.z3 ** 2)
        px, py, pz = ps.x / r, ps.y / r, ps.z3 / r
        en = torch.sqrt(px * px + py * py) + 1e-30
        ex, ey = -py / en, px / en
        nx = -pz * ey
        ny = pz * ex
        nz_ = px * ey - py * ex
        X = ps.x + dt * (u * ex + v * nx)
        Y = ps.y + dt * (u * ey + v * ny)
        Z = ps.z3 + dt * (v * nz_)
        s = r / torch.sqrt(X * X + Y * Y + Z * Z)
        return dataclasses.replace(ps, x=X * s, y=Y * s, z3=Z * s)

    # -- vertical treatments ----------------------------------------------
    def _update_layer(self, ps: ParticleState, layer_thickness=None,
                      w_vert=None, density=None, dt=0.0):
        mode = self.vertical_mode
        if mode == "indexLevel" or layer_thickness is None:
            return ps
        h_col = layer_thickness[ps.cell]                 # (nP, nz)
        if mode == "fixedZLevel":
            return dataclasses.replace(
                ps, layer=_layer_from_depth(h_col, ps.depth))
        if mode == "passiveFloat":
            depth = ps.depth
            if w_vert is not None:
                wk = w_vert[ps.cell].gather(1, ps.layer[:, None])[:, 0]
                depth = torch.minimum(torch.clamp(depth - dt * wk, min=0.0),
                                      h_col.sum(1))
            return dataclasses.replace(
                ps, depth=depth, layer=_layer_from_depth(h_col, depth))
        if mode == "isopycnal":
            rho_col = density[ps.cell]                   # (nP, nz)
            k = (rho_col - ps.target_rho[:, None]).abs().argmin(1)
            zbot = torch.cumsum(h_col, 1)
            zmid = 0.5 * ((zbot - h_col) + zbot)
            return dataclasses.replace(
                ps, layer=k, depth=zmid.gather(1, k[:, None])[:, 0])
        raise ValueError(f"unknown vertical mode {mode!r}")

    # -- integration -------------------------------------------------------
    def step(self, u_edge, dt, layer_thickness=None, w_vert=None,
             density=None, cell_velocity=None) -> ParticleState:
        """RK2 (midpoint) advection; returns and stores the new state.
        cell_velocity: cell_velocity(u_edge) where the caller has it
        (trackers on one flow share it), else computed here."""
        m = self.mesh
        ps = self.state
        uz, um = (self.cell_velocity(u_edge) if cell_velocity is None
                  else cell_velocity)
        u1, v1 = self._velocity_at(uz, um, ps)
        mid = self._advance(ps, u1, v1, 0.5 * dt)
        mid = dataclasses.replace(mid, cell=_walk(m, mid.x, mid.y, mid.z3,
                                                  mid.cell))
        u2, v2 = self._velocity_at(uz, um, mid)
        new = self._advance(ps, u2, v2, dt)
        new = dataclasses.replace(new, cell=_walk(m, new.x, new.y, new.z3,
                                                  new.cell))
        new = self._update_layer(new, layer_thickness=layer_thickness,
                                 w_vert=w_vert, density=density, dt=dt)
        self.state = new
        return new

    # -- sampling ----------------------------------------------------------
    def sample(self, field_cell):
        """A per-cell field at the particles: the containing cell's value
        of a (nCells,) field, the particle layer's of a (nCells, nz) one
        (ref: LIGHT sampling along trajectories)."""
        f = field_cell[self.state.cell]
        if f.dim() == 1:
            return f
        return f.gather(1, self.state.layer[:, None])[:, 0]

    def sample_interp(self, field_cell):
        """The IDW-interpolated sample."""
        cand, w = self._idw(self.state)
        f = field_cell[cand]
        if f.dim() > 2:
            layer = self.state.layer[:, None, None].expand(-1, f.shape[1], 1)
            f = f.gather(2, layer)[..., 0]
        return (w * f).sum(1)
